"""``replay_roofline``: a replay call's bound over its traced device time,
in %.

The bound is the bytes of one call read or written once each at the card's
peak rate (``work.replay_bytes``: modes, mean, output and Fourier tables,
float64); the time is every device operation of the window over the calls
in it (the cos/sin table, the product and the mean pass)."""

from h100bench import work


def read(run):
    if run.trace is None or run.cell.entry != "replay" or not run.units:
        return None
    sec = sum(v[0] for v in run.trace.kernels.values())
    if sec <= 0:
        return None
    s, a = run.cell.config["sizes"], run.cell.config["assumed"]
    steps = run.info["points x steps per call"] // (int(s["jma"])
                                                    * int(s["kma"]))
    nbytes = work.replay_bytes(int(s["jma"]) * int(s["kma"]), 3,
                               len(a["fourier_counts"]),
                               max(a["fourier_counts"]), steps)
    bound_ms, _ = work.bound(nbytes)
    return 100.0 * bound_ms / (sec * 1e3 / len(run.units))
