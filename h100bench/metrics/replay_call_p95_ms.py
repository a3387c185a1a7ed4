"""``replay_call_p95_ms``: the 95th percentile over every call of the
window, each call timed by CUDA events on its stream from before the call
to after its last kernel (device timestamps: a host clock cannot resolve a
call of a millisecond)."""

import statistics


def read(run):
    if run.cell.entry != "replay" or len(run.units) < 20:
        return None
    return statistics.quantiles(run.units, n=20)[18]
