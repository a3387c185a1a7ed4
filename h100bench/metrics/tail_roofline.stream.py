"""``tail_roofline.stream``: K5's bound over its traced time per launch, in
%, in the flagship's streaming cell.

K5 is the generation tail after K1 (``tail_kernel`` in the program's
``csrc/fused_tail.cu``): the temporal FIR, Lund, the pack, the rotation and
the centring of a block in one pass.  A launch must read K1's ``(3, block +
2 nf, jma, kma)`` f32 slabs once and write the packed ``(3 jma kma, block)``
f32 block once: ``4 * 3 * jma * kma * ((block + 2 nf) + block)`` bytes,
counted from the configuration's shapes, at the card's peak rate.  The
launches are the program's counter ``fused_tail.launches``; the share reads
None where the traced ``tail_kernel`` count differs from it, and in a
program that has neither."""

import math
import os

from h100bench import work
from h100bench.harness import load_module

_counts = load_module(os.path.join(os.path.dirname(__file__), "_counts.py"))


def read(run):
    if run.trace is None or run.cell.entry != "pipeline":
        return None
    s = run.cell.config["sizes"]
    block = int(s.get("streaming_block") or 0)
    launches = _counts.total("fused_tail.launches")
    if not block or launches is None:
        return None
    sec, n = run.trace.kernel_seconds(lambda name: "tail_kernel" in name)
    if sec <= 0 or n != launches:
        return None
    nf = int(math.ceil(float(s["fwidth"]) * float(s["lengthscale"])))
    nbytes = 4 * 3 * int(s["jma"]) * int(s["kma"]) * ((block + 2 * nf) + block)
    bound_ms = nbytes / work.PEAK["bytes"] * 1e3
    return 100.0 * bound_ms / (sec * 1e3 / n)
