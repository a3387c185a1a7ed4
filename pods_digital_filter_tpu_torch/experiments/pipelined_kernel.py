"""Port of ``benchmarks/exp_pipelined_kernel.py``: does drawing the next
slab's noise while this slab is filtered help the fused kernel?

The TPU variant kept a 2-deep VMEM ring of unpacked noise so that Mosaic
might overlap the PRNG (VPU) with the GEMMs (MXU).  The port's variant is
K1's slab-pipelined mode: a persistent block per tile draws slab i+1's
noise tile into a second shared-memory buffer before it filters slab i, so
that the warps of one barrier interval interleave Philox and FMA work.  The
stream and the summation order are K1's, so the output must equal K1's bit
for bit (the original's own contract, a max relative difference of 0).

For f32 and bf16 taps: the difference line, both times, the speedup.  The
plane is the first of ``EXP_SIZES`` (default 512, the original's fixed
size) and NF is ``EXP_NF`` (default 8, the original's).
"""

from __future__ import annotations

import sys

import torch

from pods_digital_filter_tpu_torch.experiments._timing import (
    LN, NSTEPS, device, env_int, env_list, timed)
from pods_digital_filter_tpu_torch.ops import filters, fused_filter


def fused_pipelined(seed, by, bz, num_slabs, jma, kma, num_components,
                    matmul_dtype):
    return fused_filter.fused_spatial_pipelined(seed, 0, num_slabs, jma, kma,
                                                by, bz, num_components,
                                                matmul_dtype)


def fused_base(seed, by, bz, num_slabs, jma, kma, num_components,
               matmul_dtype):
    return fused_filter.fused_spatial(seed, 0, num_slabs, jma, kma, by, bz,
                                      num_components, matmul_dtype=matmul_dtype)


def main():
    nf = env_int("EXP_NF", "8")
    jma = kma = int(env_list("EXP_SIZES", "512")[0])
    num_slabs = NSTEPS + 2 * nf
    dev = device()
    bz = filters.gaussian_fir_coeffs(nf, LN, torch.float32, dev)
    for md in (torch.float32, torch.bfloat16):
        loop = lambda fn: lambda seed: fn(seed, bz, bz, num_slabs, jma, kma,
                                          3, md)
        base = loop(fused_base)(1)
        pipe = loop(fused_pipelined)(1)
        # same stream ids -> identical noise -> identical output expected
        err = float((base - pipe).abs().max()
                    / base.abs().max().clamp_min(1e-30))
        name = "bf16" if md == torch.bfloat16 else "f32"
        print(f"--- matmul_dtype={name}  max rel diff vs base: {err:.2e}",
              flush=True)
        del base, pipe
        t0 = timed(loop(fused_base), dev, label=f"baseline ({name})")
        t1 = timed(loop(fused_pipelined), dev, label=f"pipelined ({name})")
        print(f"speedup: {t0 / t1:.3f}x", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
