"""``gemm_roofline``: the streaming POD's useful f32 FLOPs over the traced
time of every GEMM kernel, against the f32 peak, in %.

The FLOPs are those the algorithm needs, counted from shapes
(``work.py``): the Gram tiles on and below the diagonal, the projection onto
the kept modes, and for every block generation the temporal FIR's taps and
the 3 x 3 rotation.  The time is every kernel whose name holds ``gemm``
(cuBLAS names its GEMMs so) and that runs in the streaming mean, Gram and
projection passes, where all of those products run: whatever product it
serves there, so tiles computed and thrown away, and the FIR's zeros, count
against the share.  The eigen half's Lanczos products (cuBLAS's
``gemmSN``, between the Gram and the projection passes and in the deferred
spectrum's thread) are not this layer's and are left out."""

import math

from h100bench import work

#: the program's stages in which the counted products run
PASSES = ("streaming_mean", "streaming_gram", "streaming_projection")


def read(run):
    if run.trace is None or run.cell.entry != "pipeline":
        return None
    s = run.cell.config["sizes"]
    block = int(s.get("streaming_block") or 0)
    if not block:
        return None
    sec, _ = run.trace.kernel_seconds(
        lambda name: "gemm" in name.lower() and "gemv" not in name.lower(),
        stages=PASSES)
    if sec <= 0:
        return None
    np3 = 3 * int(s["jma"]) * int(s["kma"])
    ns = int(s["nsteps"])
    nf = int(math.ceil(float(s["fwidth"]) * float(s["lengthscale"])))
    per_model = (work.gram_flops(np3, ns, block)
                 + work.projection_flops(np3, ns, int(s["num_modes"])))
    flops = 0.0
    for u in run.units:
        gens = u.get("launches", 0)
        flops += per_model + gens * (work.fir_flops(np3, block, nf)
                                     + 6.0 * np3 * block)
    return 100.0 * flops / sec / work.PEAK["f32"]
