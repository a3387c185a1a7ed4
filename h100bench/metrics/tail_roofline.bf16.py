"""``tail_roofline.bf16``: K5's bound over its traced time per launch, in
%, where the configuration states bfloat16.

K5 is the generation tail after K1 (``tail_kernel`` in the program's
``csrc/fused_tail.cu``); in bf16 it reads K1's ``(3, S + 2 nf, jma, kma)``
f32 slabs once and writes the packed ``(3 jma kma, S)`` bf16 block once,
``S`` the snapshots of a launch (the streaming block, or every snapshot in
memory): ``3 * jma * kma * (4 * (S + 2 nf) + 2 * S)`` bytes, counted from
the configuration's shapes, at the card's peak rate.  The launches are the
program's counter ``fused_tail.bf16_launches``; the share reads None where
the traced ``tail_kernel`` count differs from it, where the configuration
states another type, and in a program that has no such counter."""

import math
import os

from h100bench import work
from h100bench.harness import load_module

_counts = load_module(os.path.join(os.path.dirname(__file__), "_counts.py"))


def tail_bytes(steps, jma, kma, nf):
    """What one bf16 K5 launch must move: the f32 slabs read once, the bf16
    block written once."""
    return 3 * jma * kma * (4 * (steps + 2 * nf) + 2 * steps)


def read(run):
    if run.trace is None or run.cell.entry != "pipeline":
        return None
    s = run.cell.config["sizes"]
    if s.get("dtype") != "bfloat16":
        return None
    launches = _counts.total("fused_tail.bf16_launches")
    if launches is None:
        return None
    sec, n = run.trace.kernel_seconds(lambda name: "tail_kernel" in name)
    if sec <= 0 or n != launches:
        return None
    nf = int(math.ceil(float(s["fwidth"]) * float(s["lengthscale"])))
    steps = int(s.get("streaming_block") or s["nsteps"])
    nbytes = tail_bytes(steps, int(s["jma"]), int(s["kma"]), nf)
    bound_ms = nbytes / work.PEAK["bytes"] * 1e3
    return 100.0 * bound_ms / (sec * 1e3 / n)
