"""``device_idle_pct.replay``: the share of the traced window in which no
device operation (kernel, copy, set) ran, in the replay cells."""


def read(run):
    if run.trace is None or run.cell.entry != "replay" \
            or run.trace.window_s <= 0 or run.trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
