"""Fused noise + spatial filter + temporal FIR — port of the experiment's
``fused_temporal`` (``benchmarks/exp_two_kernel_pipeline.py:570-646``),
whose Pallas body keeps a ring of filtered slabs in VMEM and writes the
temporally filtered window directly.

K4 (``csrc/fused_temporal.cu``; its source note says what bounds it) runs
K1's tile code, keeps the last ``2nfx+1`` filtered tiles in an f32 ring in
shared memory and writes ``y[c, n] = sum_i bx[i] z[c, n+i]``.  Its plain
version is K1's plain version followed by :func:`filters.filter_temporal`,
which is :func:`fused_filter.generate_correlated_noise_fused`'s arithmetic;
K4 equals it up to the FIR's f32 summation order.

Two deviations from the TPU body, on purpose: the ring is f32, not bf16 (the
bf16 ring saved VMEM and was not part of the meaning), and the noise scale
is not folded into ``ByM``.  The wrapper takes the plain version only for
CPU tensors; for CUDA tensors it launches K4 or raises.  ``LAUNCHES`` counts
kernel launches.
"""

from __future__ import annotations

import torch

from pods_digital_filter_tpu_torch.ops import filters, fused_filter, philox

#: K4 launches since import (or since a caller reset it to 0)
LAUNCHES = 0


def _chunk(nsteps: int, nfx: int, blocks_per_chunk: int, dev) -> int:
    """Output steps per block: enough chunks that the blocks fill every SM
    twice, but no chunk under 8 nfx steps (each recomputes 2 nfx warm-up
    slabs)."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    chunks = max(1, -(-2 * sms // blocks_per_chunk))
    return max(-(-nsteps // chunks), 8 * nfx, 1)


def fused_temporal(seed: int, t0: int, nsteps: int, jma: int, kma: int,
                   bx: torch.Tensor, by: torch.Tensor, bz: torch.Tensor,
                   num_components: int = 3, noise: torch.Tensor | None = None,
                   matmul_dtype=torch.float32) -> torch.Tensor:
    """Temporally and spatially filtered noise ``(num_components, nsteps,
    jma, kma)`` float32 of the slabs ``t0 .. t0 + nsteps + 2nfx - 1``, with
    K1's Philox stream, or of ``noise`` ``(C, nsteps + 2nfx, jn, kn)``
    float32 when given; ``matmul_dtype`` is K1's tap dtype."""
    global LAUNCHES
    dev = fused_filter._device_of(bx, by, bz, noise)
    bf16 = fused_filter._check_matmul_dtype(matmul_dtype)
    nfx, nfy, nfz = (fused_filter._half_width(b) for b in (bx, by, bz))
    num_slabs = nsteps + 2 * nfx
    jn, kn = jma + 2 * nfy, kma + 2 * nfz
    if noise is not None and tuple(noise.shape) != (num_components, num_slabs,
                                                    jn, kn):
        raise ValueError(f"noise shape {tuple(noise.shape)} != "
                         f"{(num_components, num_slabs, jn, kn)}")
    if dev.type == "cpu":
        return fused_temporal_plain(seed, t0, nsteps, jma, kma, bx, by, bz,
                                    num_components, noise, matmul_dtype)
    if noise is not None and (noise.dtype != torch.float32
                              or not noise.is_contiguous()):
        raise ValueError("fused temporal: noise must be contiguous float32")
    from pods_digital_filter_tpu_torch.ops import _build

    lib, _ = _build.load()
    need = lib.fused_temporal_smem_bytes(nfx, nfy, nfz)
    limit = lib.fused_filter_smem_limit(dev.index)
    if need > limit:
        raise ValueError(
            f"fused temporal: nfx={nfx}, nfy={nfy}, nfz={nfz} need {need} "
            f"bytes of shared memory; the card allows {limit} per block")
    tiles = -(-jma // 32) * -(-kma // 64)
    chunk = _chunk(nsteps, nfx, tiles * num_components, dev)
    if num_components * -(-nsteps // chunk) > 65535:
        raise ValueError("fused temporal: too many (component, chunk) blocks")
    out = torch.empty((num_components, nsteps, jma, kma), dtype=torch.float32,
                      device=dev)
    taps = [fused_filter._tap_values(b, matmul_dtype) for b in (by, bz)]
    bx = bx.to(torch.float32).contiguous()
    with torch.cuda.device(dev):
        err = lib.fused_temporal_launch(
            int(bf16), None if noise is None else noise.data_ptr(),
            out.data_ptr(), bx.data_ptr(), taps[0].data_ptr(),
            taps[1].data_ptr(), nfx, nfy, nfz, jma, kma, num_components,
            nsteps, chunk, t0 & philox.MASK32, seed & philox.MASK32,
            (seed >> 32) & philox.MASK32, philox.SCALE,
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check_launch(err, "fused temporal kernel")
    LAUNCHES += 1
    return out


def fused_temporal_plain(seed, t0, nsteps, jma, kma, bx, by, bz,
                         num_components=3, noise=None,
                         matmul_dtype=torch.float32) -> torch.Tensor:
    """Plain version: :func:`fused_filter.fused_spatial_plain`, then
    :func:`filters.filter_temporal` in float32."""
    nfx = fused_filter._half_width(bx)
    z = fused_filter.fused_spatial_plain(seed, t0, nsteps + 2 * nfx, jma, kma,
                                         by, bz, num_components, noise,
                                         matmul_dtype)
    return filters.filter_temporal(z, bx.to(torch.float32), axis=-3)
