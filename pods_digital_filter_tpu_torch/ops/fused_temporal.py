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


#: output tile (width, rows) of a K4 block (csrc/fused_temporal.cu), in
#: order of preference: the first whose ring and passes fit the card's
#: shared memory per block is taken
TEMPORAL_TILES = ((32, 32), (32, 16), (32, 8))


def temporal_tile(nfx: int, nfy: int, nfz: int, smem_bytes, limit: int):
    """``(tile width, tile rows, bytes)`` of a K4 block: the first of
    :data:`TEMPORAL_TILES` whose shared memory (``smem_bytes(nfx, nfy, nfz,
    ks, ch)``, the kernel's own count) is within ``limit``; raises
    ``ValueError`` with the byte count when none is."""
    for ks, ch in TEMPORAL_TILES:
        need = smem_bytes(nfx, nfy, nfz, ks, ch)
        if need <= limit:
            return ks, ch, need
    raise ValueError(
        f"fused temporal: nfx={nfx}, nfy={nfy}, nfz={nfz} need {need} bytes "
        f"of shared memory even for a {ch} x {ks} tile; the card allows "
        f"{limit} per block")


def _chunk(nsteps: int, nfx: int, blocks_per_chunk: int, slots: int,
           max_chunks: int = 65535, unit: int = 1) -> int:
    """Output steps per block, a multiple of ``unit``.  With ``c`` chunks
    the ``blocks_per_chunk * c`` blocks run in ``ceil(blocks_per_chunk * c /
    slots)`` waves over the card's ``slots`` (SMs x blocks an SM holds, as
    the card reports), and each walks ``ceil(nsteps / c) + 2 nfx`` slabs
    (its chunk and the ring's warm-up): the chunk of the ``c <=
    max_chunks`` that minimises their product, the fewest chunks on a
    tie."""
    best = None
    units = -(-nsteps // unit)
    for c in range(1, min(units, max_chunks) + 1):
        chunk = -(-units // c) * unit
        if -(-nsteps // chunk) != c:        # the same chunk as a smaller c
            continue
        cost = -(-blocks_per_chunk * c // slots) * (chunk + 2 * nfx)
        if best is None or cost < best[0]:
            best = (cost, chunk)
    return best[1]


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
    ks, ch, _ = temporal_tile(nfx, nfy, nfz, lib.fused_temporal_smem_bytes,
                              lib.fused_filter_smem_limit(dev.index))
    with torch.cuda.device(dev):
        slots = lib.fused_temporal_slots(nfx, nfy, nfz, ks, ch,
                                         int(noise is not None), int(bf16),
                                         dev.index)
    _build.check_launch(max(0, -slots), "fused temporal kernel (occupancy)")
    tiles = -(-jma // ch) * -(-kma // ks)
    chunk = _chunk(nsteps, nfx, tiles * num_components, slots,
                   65535 // num_components)
    out = torch.empty((num_components, nsteps, jma, kma), dtype=torch.float32,
                      device=dev)
    taps = [fused_filter._tap_values(b, matmul_dtype) for b in (by, bz)]
    bx = bx.to(torch.float32).contiguous()
    with torch.cuda.device(dev):
        err = lib.fused_temporal_launch(
            int(bf16), None if noise is None else noise.data_ptr(),
            out.data_ptr(), bx.data_ptr(), taps[0].data_ptr(),
            taps[1].data_ptr(), nfx, nfy, nfz, jma, kma, num_components,
            nsteps, chunk, ks, ch, t0 & philox.MASK32, seed & philox.MASK32,
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
