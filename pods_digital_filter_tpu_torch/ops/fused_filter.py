"""Fused noise generation + spatial filtering — port of
``pods_digital_filter_tpu/ops/pallas_filter.py``.

The named module is a Pallas TPU kernel; here the same step is the CUDA
kernel K1 of ``csrc/fused_filter.cu`` (its source note says which Pallas
kernels it replaces and what bounds it).  K1 draws Philox4x32-10 noise
(:mod:`.philox`) into shared memory and applies both separable Gaussian
passes there, so the raw noise field never reaches device memory; only
the filtered ``(jma, kma)`` slabs are written.

Every entry point has its plain PyTorch version beside it.  The wrapper
takes the plain version only for CPU tensors; for CUDA tensors it launches
K1 or raises — there is no fallback.  ``LAUNCHES`` counts kernel launches.

The Philox stream is the same on both devices (bit for bit), but it is not
the JAX package's stream: neither Threefry nor the TPU's on-core PRNG can
be reproduced.  :func:`generation_stream_tag` names it ``cuda-philox-v1``
so a JAX checkpoint never passes for port noise.
"""

from __future__ import annotations

import torch

from pods_digital_filter_tpu_torch.ops import filters, philox

#: K1 launches since import (or since a caller reset it to 0)
LAUNCHES = 0

_PHILOX_FILTERED, _NOISE_IN_FILTERED, _PHILOX_RAW = 0, 1, 2
_MAX_GROUPS_PER_CHUNK = 1 << 22    # plain-version working set per step


def _half_width(taps: torch.Tensor) -> int:
    return (taps.shape[0] - 1) // 2


def _launch(mode, out, noise, by, bz, nfy, nfz, jma, kma, num_components,
            num_slabs, seed, t0):
    global LAUNCHES
    from pods_digital_filter_tpu_torch.ops import _build

    lib, _ = _build.load()
    dev = out.device.index
    if mode != _PHILOX_RAW:
        need = lib.fused_filter_smem_bytes(nfy, nfz)
        limit = lib.fused_filter_smem_limit(dev)
        if need > limit:
            raise ValueError(
                f"fused filter: a tile with nfy={nfy}, nfz={nfz} needs {need} "
                f"bytes of shared memory; the card allows {limit} per block")
    if num_components * num_slabs >= 2 ** 31:
        raise ValueError("fused filter: components x slabs must be < 2^31")
    with torch.cuda.device(out.device):
        err = lib.fused_filter_launch(
            mode, None if noise is None else noise.data_ptr(), out.data_ptr(),
            None if by is None else by.data_ptr(),
            None if bz is None else bz.data_ptr(),
            nfy, nfz, jma, kma, num_components, num_slabs,
            t0 & philox.MASK32, seed & philox.MASK32,
            (seed >> 32) & philox.MASK32, philox.SCALE,
            torch.cuda.current_stream(out.device).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"fused filter kernel (mode {mode}) failed to launch: "
            f"{lib.fused_filter_error_string(err).decode()} (cudaError {err})")
    LAUNCHES += 1


def _device_of(*tensors) -> torch.device:
    devs = {t.device for t in tensors if t is not None}
    if len(devs) != 1:
        raise ValueError(f"fused filter: tensors on several devices {devs}")
    dev = devs.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"fused filter: unsupported device {dev}")
    return dev


def fused_spatial(seed: int, t0: int, num_slabs: int, jma: int, kma: int,
                  by: torch.Tensor, bz: torch.Tensor, num_components: int = 3,
                  noise: torch.Tensor | None = None) -> torch.Tensor:
    """Spatially filtered noise ``(num_components, num_slabs, jma, kma)``,
    float32, for global slabs ``t0 .. t0+num_slabs-1`` — K1's own entry
    point (the original's ``_fused_spatial`` / ``_fused_spatial_tiled``).

    ``by``/``bz`` are the y and z taps; their device picks the path.  With
    ``noise`` (``(C, S, jma+2nfy, kma+2nfz)`` float32) K1 filters that field
    instead of drawing Philox noise (the interpret-mode ``noise_in``
    bodies)."""
    dev = _device_of(by, bz, noise)
    nfy, nfz = _half_width(by), _half_width(bz)
    jn, kn = jma + 2 * nfy, kma + 2 * nfz
    if noise is not None and tuple(noise.shape) != (num_components, num_slabs,
                                                    jn, kn):
        raise ValueError(
            f"noise shape {tuple(noise.shape)} != "
            f"{(num_components, num_slabs, jn, kn)}")
    if dev.type == "cpu":
        return fused_spatial_plain(seed, t0, num_slabs, jma, kma, by, bz,
                                   num_components, noise)
    by = by.to(torch.float32).contiguous()
    bz = bz.to(torch.float32).contiguous()
    if noise is not None:
        if noise.dtype != torch.float32 or not noise.is_contiguous():
            raise ValueError("fused filter: noise must be contiguous float32")
    out = torch.empty((num_components, num_slabs, jma, kma),
                      dtype=torch.float32, device=dev)
    mode = _PHILOX_FILTERED if noise is None else _NOISE_IN_FILTERED
    _launch(mode, out, noise, by, bz, nfy, nfz, jma, kma, num_components,
            num_slabs, seed, t0)
    return out


def fused_spatial_plain(seed, t0, num_slabs, jma, kma, by, bz,
                        num_components=3, noise=None) -> torch.Tensor:
    """Plain version of :func:`fused_spatial`: the Philox field from
    :func:`philox.raw_noise`, then :func:`filters.filter_spatial` in float32,
    a few slabs at a time to bound the working set."""
    by = by.to(torch.float32)
    bz = bz.to(torch.float32)
    if noise is not None:
        return filters.filter_spatial(noise.to(torch.float32), by, bz, jma, kma)
    nfy, nfz = _half_width(by), _half_width(bz)
    jn, kn = jma + 2 * nfy, kma + 2 * nfz
    out = torch.empty((num_components, num_slabs, jma, kma),
                      dtype=torch.float32, device=by.device)
    chunk = max(1, _MAX_GROUPS_PER_CHUNK // (jn * (-(-kn // 4))))
    for c in range(num_components):
        for s0 in range(0, num_slabs, chunk):
            n = min(chunk, num_slabs - s0)
            raw = philox.raw_noise(seed, t0 + s0, n, jn, kn, 1, by.device,
                                   comp0=c)[0]
            out[c, s0:s0 + n] = filters.filter_spatial(raw, by, bz, jma, kma)
    return out


def raw_noise(seed: int, t0: int, num_slabs: int, jn: int, kn: int,
              num_components: int = 1, device="cpu") -> torch.Tensor:
    """K1's raw Philox field ``(num_components, num_slabs, jn, kn)``,
    float32 (the original's ``raw_noise_slabs``): the stream statistics and
    bit-exactness checks read it.  A CPU ``device`` gives the plain
    version, :func:`philox.raw_noise`."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return philox.raw_noise(seed, t0, num_slabs, jn, kn, num_components,
                                dev)
    if dev.type != "cuda":
        raise ValueError(f"fused filter: unsupported device {dev}")
    out = torch.empty((num_components, num_slabs, jn, kn),
                      dtype=torch.float32, device=dev)
    _launch(_PHILOX_RAW, out, None, None, None, 0, 0, jn, kn,
            num_components, num_slabs, seed, t0)
    return out


def generate_correlated_noise_fused(
    seed: int, t0: int, nsteps: int, jma: int, kma: int,
    nfx: int, nfy: int, nfz: int, lnx: float, lny: float, lnz: float,
    num_components: int = 3, dtype=torch.float32, device="cpu",
    noise: torch.Tensor | None = None,
) -> torch.Tensor:
    """Counterpart of :func:`filters.generate_correlated_noise` with the
    noise draw and spatial filter fused into K1 (different,
    statistically equivalent stream); the temporal FIR follows as a
    product.  ``(num_components, nsteps, jma, kma)`` in ``dtype``.

    The taps are float32 whatever ``dtype`` is (as the original's default
    ``matmul_dtype``); the bf16-tap variant is not ported yet."""
    dev = torch.device(device) if noise is None else noise.device
    bx = filters.gaussian_fir_coeffs(nfx, lnx, torch.float32, dev)
    by = filters.gaussian_fir_coeffs(nfy, lny, torch.float32, dev)
    bz = filters.gaussian_fir_coeffs(nfz, lnz, torch.float32, dev)
    z = fused_spatial(seed, t0, nsteps + 2 * nfx, jma, kma, by, bz,
                      num_components, noise)
    return filters.filter_temporal(z, bx, axis=-3).to(dtype)


def generation_stream_tag(use_fused: bool, device) -> str:
    """Which noise stream a configuration generates — the input a
    checkpoint fingerprint needs.  K1's Philox stream is one stream on CPU
    and card; the ``torch.Generator`` stream of :mod:`.filters` differs
    between device types.  No tag equals a JAX package tag."""
    if use_fused:
        return "cuda-philox-v1"
    return f"torch-generator-{torch.device(device).type}-v1"
