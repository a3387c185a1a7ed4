"""``k1_roofline``: K1's bound over its traced time per launch, in %.

K1 is the fused noise + spatial filter kernel (``walk_kernel`` in the
program's ``csrc/fused_filter.cu``).  Its launches come from the program's
counter ``ops.fused_filter.LAUNCHES``; each launch draws ``S + 2 nfx`` slabs
for ``S`` snapshots (the streaming block, or every snapshot in memory), and
its bound (``work.k1_bound_ms``) is its output bytes at the card's peak
rate."""

import math

from h100bench import work


def read(run):
    if run.trace is None or run.cell.entry != "pipeline":
        return None
    sec, n = run.trace.kernel_seconds(lambda name: "walk_kernel" in name)
    launches = sum(u.get("launches", 0) for u in run.units)
    if sec <= 0 or launches == 0 or n != launches:
        return None
    s = run.cell.config["sizes"]
    nf = int(math.ceil(float(s["fwidth"]) * float(s["lengthscale"])))
    steps = int(s.get("streaming_block") or s["nsteps"])
    bound_ms, _ = work.k1_bound_ms(steps + 2 * nf, int(s["jma"]),
                                   int(s["kma"]), nf)
    return 100.0 * bound_ms / (sec * 1e3 / n)
