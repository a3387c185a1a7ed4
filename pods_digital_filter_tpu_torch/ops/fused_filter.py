"""Fused noise generation + spatial filtering — port of
``pods_digital_filter_tpu/ops/pallas_filter.py``.

The named module is a Pallas TPU kernel; here the same step is the CUDA
kernel K1 of ``csrc/fused_filter.cu`` (its source note says which Pallas
kernels it replaces and what bounds it).  K1 draws Philox4x32-10 noise
(:mod:`.philox`) into shared memory and applies both separable Gaussian
passes there, so the raw noise field never reaches device memory; only
the filtered ``(jma, kma)`` slabs are written.  K1's other modes stand for
the fused bodies of the TPU experiments (``benchmarks/exp_*.py``): an iota
source in place of the draw, a cycling dummy input, and a slab-pipelined
loop.

Every entry point has its plain PyTorch version beside it.  The wrapper
takes the plain version only for CPU tensors; for CUDA tensors it launches
K1 or raises — there is no fallback.  ``LAUNCHES`` counts kernel launches.

The Philox stream is the same on both devices (bit for bit), but it is not
the JAX package's stream: neither Threefry nor the TPU's on-core PRNG can
be reproduced.  :func:`generation_stream_tag` names it ``cuda-philox-v1``
so a JAX checkpoint never passes for port noise.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from pods_digital_filter_tpu_torch.ops import filters, philox

#: K1 launches since import (or since a caller reset it to 0)
LAUNCHES = 0

_PHILOX_FILTERED, _NOISE_IN_FILTERED, _PHILOX_RAW, _IOTA_FILTERED, _PIPELINED = \
    range(5)
_MAX_GROUPS_PER_CHUNK = 1 << 22    # plain-version working set per step
_MATMUL_DTYPES = (torch.float32, torch.bfloat16)

#: float32(2*sqrt(3)/65536): the iota source's scale
#: (benchmarks/exp_two_kernel_pipeline.py:213)
IOTA_SCALE = float(np.float32(2.0 * np.sqrt(3.0) / 65536.0))


def _half_width(taps: torch.Tensor) -> int:
    return (taps.shape[0] - 1) // 2


def _check_matmul_dtype(matmul_dtype) -> bool:
    """True for bfloat16 taps, False for float32; raises otherwise."""
    if matmul_dtype not in _MATMUL_DTYPES:
        raise ValueError(f"fused filter: matmul_dtype must be float32 or "
                         f"bfloat16, not {matmul_dtype}")
    return matmul_dtype == torch.bfloat16


def _launch(mode, out, noise, by, bz, nfy, nfz, jma, kma, num_components,
            num_slabs, seed, t0, bf16_taps=False, dummy=None):
    global LAUNCHES
    from pods_digital_filter_tpu_torch.ops import _build

    lib, _ = _build.load()
    dev = out.device.index
    if mode != _PHILOX_RAW:
        need = lib.fused_filter_smem_bytes(nfy, nfz, int(mode == _PIPELINED))
        limit = lib.fused_filter_smem_limit(dev)
        if need > limit:
            raise ValueError(
                f"fused filter: a tile with nfy={nfy}, nfz={nfz} needs {need} "
                f"bytes of shared memory; the card allows {limit} per block")
    if num_components * num_slabs >= 2 ** 31:
        raise ValueError("fused filter: components x slabs must be < 2^31")
    ptr = lambda x: None if x is None else x.data_ptr()
    with torch.cuda.device(out.device):
        err = lib.fused_filter_launch(
            mode, int(bf16_taps), int(out.dtype == torch.bfloat16), ptr(noise),
            out.data_ptr(), ptr(dummy), ptr(by), ptr(bz),
            nfy, nfz, jma, kma, num_components, num_slabs,
            t0 & philox.MASK32, seed & philox.MASK32,
            (seed >> 32) & philox.MASK32, philox.SCALE, IOTA_SCALE,
            torch.cuda.current_stream(out.device).cuda_stream)
    _build.check_launch(err, f"fused filter kernel (mode {mode})")
    LAUNCHES += 1


def _device_of(*tensors) -> torch.device:
    devs = {t.device for t in tensors if t is not None}
    if len(devs) != 1:
        raise ValueError(f"fused filter: tensors on several devices {devs}")
    dev = devs.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"fused filter: unsupported device {dev}")
    return dev


def _tap_values(taps: torch.Tensor, matmul_dtype) -> torch.Tensor:
    """float32 taps holding the values of ``matmul_dtype`` (bfloat16 taps
    are rounded to nearest even, as ``astype`` is)."""
    return taps.to(matmul_dtype).to(torch.float32).contiguous()


def _filtered(mode, seed, t0, num_slabs, jma, kma, by, bz, num_components,
              matmul_dtype, noise=None, dummy=None) -> torch.Tensor:
    """Checks and launches one of K1's filtering modes (CUDA tensors)."""
    bf16 = _check_matmul_dtype(matmul_dtype)
    nfy, nfz = _half_width(by), _half_width(bz)
    out = torch.empty((num_components, num_slabs, jma, kma),
                      dtype=torch.float32, device=by.device)
    _launch(mode, out, noise, _tap_values(by, matmul_dtype),
            _tap_values(bz, matmul_dtype), nfy, nfz, jma, kma,
            num_components, num_slabs, seed, t0, bf16, dummy)
    return out


def fused_spatial(seed: int, t0: int, num_slabs: int, jma: int, kma: int,
                  by: torch.Tensor, bz: torch.Tensor, num_components: int = 3,
                  noise: torch.Tensor | None = None,
                  matmul_dtype=torch.float32) -> torch.Tensor:
    """Spatially filtered noise ``(num_components, num_slabs, jma, kma)``,
    float32, for global slabs ``t0 .. t0+num_slabs-1`` — K1's own entry
    point (the original's ``_fused_spatial`` / ``_fused_spatial_tiled``).

    ``by``/``bz`` are the y and z taps; their device picks the path.  With
    ``noise`` (``(C, S, jma+2nfy, kma+2nfz)`` float32) K1 filters that field
    instead of drawing Philox noise (the interpret-mode ``noise_in``
    bodies).  ``matmul_dtype=torch.bfloat16`` computes what the original
    computes with bfloat16 tap matrices: noise and taps rounded to bf16,
    products summed in f32, the z-pass result rounded to bf16 before the
    y-pass (``pallas_filter.py:87-90``)."""
    dev = _device_of(by, bz, noise)
    _check_matmul_dtype(matmul_dtype)
    nfy, nfz = _half_width(by), _half_width(bz)
    jn, kn = jma + 2 * nfy, kma + 2 * nfz
    if noise is not None and tuple(noise.shape) != (num_components, num_slabs,
                                                    jn, kn):
        raise ValueError(
            f"noise shape {tuple(noise.shape)} != "
            f"{(num_components, num_slabs, jn, kn)}")
    if dev.type == "cpu":
        return fused_spatial_plain(seed, t0, num_slabs, jma, kma, by, bz,
                                   num_components, noise, matmul_dtype)
    if noise is not None:
        if noise.dtype != torch.float32 or not noise.is_contiguous():
            raise ValueError("fused filter: noise must be contiguous float32")
    mode = _PHILOX_FILTERED if noise is None else _NOISE_IN_FILTERED
    return _filtered(mode, seed, t0, num_slabs, jma, kma, by, bz,
                     num_components, matmul_dtype, noise=noise)


def filter_taps(noise: torch.Tensor, by: torch.Tensor, bz: torch.Tensor,
                jma: int, kma: int, matmul_dtype=torch.float32) -> torch.Tensor:
    """Plain separable filter of float32 ``noise`` with K1's arithmetic:
    :func:`filters.filter_spatial` in float32, or with bfloat16 taps the
    two products on bf16-rounded noise and taps with the intermediate
    rounded to bf16 (``.to(bfloat16)`` rounds to nearest even, as the
    kernel and ``astype`` do)."""
    if not _check_matmul_dtype(matmul_dtype):
        return filters.filter_spatial(noise, by.to(torch.float32),
                                      bz.to(torch.float32), jma, kma)
    r = lambda x: x.to(torch.bfloat16).to(torch.float32)
    By = filters.toeplitz_band(r(by), jma)
    Bz = filters.toeplitz_band(r(bz), kma)
    t = r(torch.matmul(r(noise), Bz.T))
    return torch.matmul(By, t)


def bf16_tap_bound(by: torch.Tensor, bz: torch.Tensor,
                   xmax: float = float(np.sqrt(3.0))) -> float:
    """How far two correct bfloat16-tap filters of the same noise (|x| <=
    ``xmax``) may differ when they sum in different orders: the f32 sums
    of t differ in their last bits, so an element of t may round to the
    neighbouring bf16 value, one bf16 ulp at the largest |t| =
    ``xmax * sum|bz|``; the y-pass spreads that over ``sum|by|``.  Plus
    1e-5 for the f32 sums of the y-pass."""
    r = lambda b: float(b.to(torch.bfloat16).to(torch.float32).abs().sum())
    tmax = float(torch.tensor(xmax).to(torch.bfloat16).float()) * r(bz)
    ulp = 2.0 ** (math.floor(math.log2(tmax)) - 7)    # 8 significant bits
    return ulp * r(by) + 1e-5


def fused_spatial_plain(seed, t0, num_slabs, jma, kma, by, bz,
                        num_components=3, noise=None,
                        matmul_dtype=torch.float32) -> torch.Tensor:
    """Plain version of :func:`fused_spatial`: the Philox field from
    :func:`philox.raw_noise`, then :func:`filter_taps`, a few slabs at a
    time to bound the working set."""
    if noise is not None:
        return filter_taps(noise.to(torch.float32), by, bz, jma, kma,
                           matmul_dtype)
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
            out[c, s0:s0 + n] = filter_taps(raw, by, bz, jma, kma,
                                            matmul_dtype)
    return out


def fused_spatial_pipelined(seed: int, t0: int, num_slabs: int, jma: int,
                            kma: int, by: torch.Tensor, bz: torch.Tensor,
                            num_components: int = 3,
                            matmul_dtype=torch.float32) -> torch.Tensor:
    """K1's slab-pipelined mode (``exp_pipelined_kernel.fused_pipelined``):
    a persistent block per tile draws the next slab's noise before it
    filters this one.  Same stream and summation order as
    :func:`fused_spatial`, so the result is the same bit for bit; the plain
    version is :func:`fused_spatial_plain`."""
    dev = _device_of(by, bz)
    if dev.type == "cpu":
        return fused_spatial_plain(seed, t0, num_slabs, jma, kma, by, bz,
                                   num_components, None, matmul_dtype)
    return _filtered(_PIPELINED, seed, t0, num_slabs, jma, kma, by, bz,
                     num_components, matmul_dtype)


def iota_field(num_slabs: int, jn: int, kn: int, num_components: int = 3,
               device="cpu") -> torch.Tensor:
    """The iota source of ``_fused_body_noprng``
    (``exp_two_kernel_pipeline.py:212-213``): ``x[cs, j, k] =
    float32(int32(k * (cs + 1))) * float32(2*sqrt(3)/65536)``, with ``cs``
    the launch index ``comp * num_slabs + slab``; float32 ``(C, S, jn, kn)``."""
    total = num_components * num_slabs
    v = (torch.arange(kn, dtype=torch.int64, device=device)[None, :]
         * torch.arange(1, total + 1, dtype=torch.int64, device=device)[:, None])
    v = ((v + 2 ** 31) & philox.MASK32) - 2 ** 31          # int32 wrap
    x = v.to(torch.float32) * IOTA_SCALE
    return x[:, None, :].expand(total, jn, kn).reshape(
        num_components, num_slabs, jn, kn)


def fused_spatial_iota(num_slabs: int, jma: int, kma: int, by: torch.Tensor,
                       bz: torch.Tensor, num_components: int = 3,
                       matmul_dtype=torch.float32) -> torch.Tensor:
    """K1 with the Philox draw replaced by :func:`iota_field` (the
    experiment's ``fused_noprng``): what the draw costs inside K1."""
    dev = _device_of(by, bz)
    if dev.type == "cpu":
        return fused_spatial_iota_plain(num_slabs, jma, kma, by, bz,
                                        num_components, matmul_dtype)
    return _filtered(_IOTA_FILTERED, 0, 0, num_slabs, jma, kma, by, bz,
                     num_components, matmul_dtype)


def fused_spatial_iota_plain(num_slabs, jma, kma, by, bz, num_components=3,
                             matmul_dtype=torch.float32) -> torch.Tensor:
    nfy, nfz = _half_width(by), _half_width(bz)
    x = iota_field(num_slabs, jma + 2 * nfy, kma + 2 * nfz, num_components,
                   by.device)
    return filter_taps(x, by, bz, jma, kma, matmul_dtype)


def fused_spatial_dummy_in(seed: int, t0: int, num_slabs: int, jma: int,
                           kma: int, by: torch.Tensor, bz: torch.Tensor,
                           dummy: torch.Tensor, num_components: int = 3,
                           matmul_dtype=torch.float32) -> torch.Tensor:
    """:func:`fused_spatial` plus ``dummy[cs]`` (``(C*S, 8, 128)`` float32)
    added to ``out[cs, :8, :128]`` after the filter (the experiment's
    ``fused_dummy_in``)."""
    dev = _device_of(by, bz, dummy)
    total = num_components * num_slabs
    if tuple(dummy.shape) != (total, 8, 128):
        raise ValueError(f"dummy shape {tuple(dummy.shape)} != {(total, 8, 128)}")
    if jma < 8 or kma < 128:
        raise ValueError(f"fused filter: dummy-in needs jma >= 8 and kma >= "
                         f"128, not {jma} x {kma}")
    if dev.type == "cpu":
        return fused_spatial_dummy_in_plain(seed, t0, num_slabs, jma, kma, by,
                                            bz, dummy, num_components,
                                            matmul_dtype)
    if dummy.dtype != torch.float32 or not dummy.is_contiguous():
        raise ValueError("fused filter: dummy must be contiguous float32")
    return _filtered(_PHILOX_FILTERED, seed, t0, num_slabs, jma, kma, by, bz,
                     num_components, matmul_dtype, dummy=dummy)


def fused_spatial_dummy_in_plain(seed, t0, num_slabs, jma, kma, by, bz, dummy,
                                 num_components=3, matmul_dtype=torch.float32):
    out = fused_spatial_plain(seed, t0, num_slabs, jma, kma, by, bz,
                              num_components, None, matmul_dtype)
    out[:, :, :8, :128] += dummy.reshape(num_components, num_slabs, 8, 128)
    return out


def raw_noise(seed: int, t0: int, num_slabs: int, jn: int, kn: int,
              num_components: int = 1, device="cpu",
              dtype=torch.float32) -> torch.Tensor:
    """K1's raw Philox field ``(num_components, num_slabs, jn, kn)`` in
    ``dtype`` (float32, or bfloat16 rounded to nearest even; the original's
    ``raw_noise_slabs`` and kernel A of ``split_pipeline``): the stream
    statistics and bit-exactness checks read it.  A CPU ``device`` gives the
    plain version, :func:`philox.raw_noise`."""
    dev = torch.device(device)
    if dtype not in _MATMUL_DTYPES:
        raise ValueError(f"fused filter: raw noise dtype must be float32 or "
                         f"bfloat16, not {dtype}")
    if dev.type == "cpu":
        return philox.raw_noise(seed, t0, num_slabs, jn, kn, num_components,
                                dev).to(dtype)
    if dev.type != "cuda":
        raise ValueError(f"fused filter: unsupported device {dev}")
    out = torch.empty((num_components, num_slabs, jn, kn), dtype=dtype,
                      device=dev)
    _launch(_PHILOX_RAW, out, None, None, None, 0, 0, jn, kn,
            num_components, num_slabs, seed, t0)
    return out


def generate_correlated_noise_fused(
    seed: int, t0: int, nsteps: int, jma: int, kma: int,
    nfx: int, nfy: int, nfz: int, lnx: float, lny: float, lnz: float,
    num_components: int = 3, dtype=torch.float32, device="cpu",
    noise: torch.Tensor | None = None, matmul_dtype=torch.float32,
) -> torch.Tensor:
    """Counterpart of :func:`filters.generate_correlated_noise` with the
    noise draw and spatial filter fused into K1 (different,
    statistically equivalent stream); the temporal FIR follows as a
    product.  ``(num_components, nsteps, jma, kma)`` in ``dtype``.

    ``matmul_dtype`` selects K1's taps as the original's does (float32 by
    default; bfloat16 rounds noise, taps and the intermediate); the
    temporal FIR runs in float32 either way."""
    dev = torch.device(device) if noise is None else noise.device
    bx = filters.gaussian_fir_coeffs(nfx, lnx, torch.float32, dev)
    by = filters.gaussian_fir_coeffs(nfy, lny, torch.float32, dev)
    bz = filters.gaussian_fir_coeffs(nfz, lnz, torch.float32, dev)
    z = fused_spatial(seed, t0, nsteps + 2 * nfx, jma, kma, by, bz,
                      num_components, noise, matmul_dtype)
    return filters.filter_temporal(z, bx, axis=-3).to(dtype)


def generation_stream_tag(use_fused: bool, device) -> str:
    """Which noise stream a configuration generates — the input a
    checkpoint fingerprint needs.  K1's Philox stream is one stream on CPU
    and card; the ``torch.Generator`` stream of :mod:`.filters` differs
    between device types.  No tag equals a JAX package tag."""
    if use_fused:
        return "cuda-philox-v1"
    return f"torch-generator-{torch.device(device).type}-v1"
