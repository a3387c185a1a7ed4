"""Klein (2003) digital-filter core — port of
``pods_digital_filter_tpu/ops/filters.py``.

Same factorisation as the original: counter-indexed noise per time slab,
the separable (y, z) 'valid' filter as two products with banded Toeplitz
matrices, and the rolling-buffer time recursion as one causal FIR along
the slab axis.  The products are plain ``torch.matmul`` (the JAX package
leaves them to XLA as well); the fused kernel that draws the noise and
filters it without writing it out is :mod:`.fused_filter`.

The noise here is a ``torch.Generator`` stream keyed per slab — the
counterpart of the original's ``fold_in(key, t0 + s)`` Threefry stream,
with the same property (any time window is reproducible on its own) but
other numbers.  Tests that compare with JAX inject the same noise.
"""

from __future__ import annotations

import numpy as np
import torch

from pods_digital_filter_tpu_torch.device import resolve_device

# Uniform noise in (-sqrt(3), sqrt(3)) has unit variance
# (digitalfilters.py:1344 "pdfr = np.sqrt(3.0)").
PDFR = float(np.sqrt(3.0))

_MASK64 = (1 << 64) - 1


def gaussian_fir_coeffs(n: int, ln: float, dtype=torch.float32,
                        device=None) -> torch.Tensor:
    """Klein filter taps, length ``2n+1`` (reference ``calccoeff``).

    ``b[i] = exp(-pi*(i-n)^2/(2*ln^2))`` normalized so ``sum(b^2) == 1``
    (computed in float64 on the host, then cast — as the original)."""
    k = np.arange(2 * n + 1, dtype=np.float64) - n
    a = np.exp(-np.pi * k * k / (2.0 * ln * ln))
    b = a / np.sqrt(np.sum(a * a))
    return torch.as_tensor(b, dtype=dtype, device=device)


def filter_kernel_3d(nfx: int, nfy: int, nfz: int, lnx: float, lny: float,
                     lnz: float, dtype=torch.float32) -> torch.Tensor:
    """Tensor-product 3-D kernel ``a[i,j,k] = bx[i]*by[j]*bz[k]``
    (reference ``coeff3D``).  Only used by the direct-filter test oracle."""
    bx = gaussian_fir_coeffs(nfx, lnx, dtype)
    by = gaussian_fir_coeffs(nfy, lny, dtype)
    bz = gaussian_fir_coeffs(nfz, lnz, dtype)
    return torch.einsum("i,j,k->ijk", bx, by, bz)


def slab_seed(seed: int, slab: int) -> int:
    """Seed of the generator that draws global slab ``slab`` — a splitmix64
    mix of ``(seed, slab)``.  The CPU generator (mt19937) keeps only the
    low 32 bits of its seed, so the mix must spread both inputs there."""
    z = ((seed & _MASK64) * 0x9E3779B97F4A7C15 + (slab & _MASK64)) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (z ^ (z >> 31)) & ((1 << 63) - 1)


def noise_slabs(seed: int, t0: int, num_slabs: int, jn: int, kn: int,
                num_components: int = 3, dtype=torch.float32,
                device="cuda") -> torch.Tensor:
    """Uniform(-sqrt3, sqrt3) noise ``(num_components, num_slabs, jn, kn)``.

    Slab ``s`` (global index ``t0 + s``) comes from its own generator seeded
    with :func:`slab_seed`, so any window of the stream is reproducible
    independently of what was generated before (the original's
    ``fold_in(key, t0+s)``, ops/filters.py:80-108).  The stream depends on
    the device type: CPU and CUDA generators give different numbers."""
    device = torch.device(device)
    draw_dtype = torch.float32 if dtype == torch.bfloat16 else dtype
    out = torch.empty((num_components, num_slabs, jn, kn), dtype=dtype,
                      device=device)
    g = torch.Generator(device=device)
    for s in range(num_slabs):
        g.manual_seed(slab_seed(seed, t0 + s))
        u = torch.rand((num_components, jn, kn), generator=g,
                       dtype=draw_dtype, device=device)
        out[:, s] = u.mul_(2.0 * PDFR).sub_(PDFR)
    return out


def toeplitz_band(coeffs: torch.Tensor, out_len: int) -> torch.Tensor:
    """Banded matrix ``B`` of shape ``(out_len, out_len + len(coeffs) - 1)``
    with ``B[j, j+d] = coeffs[d]`` — so ``B @ x`` is the 'valid' correlation
    of ``x`` with ``coeffs`` (== convolution for symmetric taps)."""
    c = torch.as_tensor(coeffs)
    width = c.shape[0]
    in_len = out_len + width - 1
    j = torch.arange(out_len, device=c.device)[:, None]
    m = torch.arange(in_len, device=c.device)[None, :]
    d = m - j
    valid = (d >= 0) & (d < width)
    return torch.where(valid, c[d.clamp(0, width - 1)],
                       torch.zeros((), dtype=c.dtype, device=c.device))


def filter_spatial(slabs: torch.Tensor, by: torch.Tensor, bz: torch.Tensor,
                   jma: int, kma: int) -> torch.Tensor:
    """Separable valid filter over the trailing (y, z) axes of
    ``(..., jma + 2*nfy, kma + 2*nfz)`` slabs: ``By @ X @ Bz^T``, two banded
    Toeplitz products in the slabs' dtype."""
    dtype = slabs.dtype
    By = toeplitz_band(by.to(dtype), jma)   # (jma, jma+2nfy)
    Bz = toeplitz_band(bz.to(dtype), kma)   # (kma, kma+2nfz)
    t = torch.matmul(slabs, Bz.T)           # (..., Jn, kma)
    return torch.matmul(By, t)              # (..., jma, kma)


def filter_temporal(filtered_slabs: torch.Tensor, bx: torch.Tensor,
                    axis: int = -3) -> torch.Tensor:
    """Causal valid FIR along the time-slab axis: output step ``t`` is
    ``sum_i bx[i] * slab[t + i]`` — the reference's rolling-buffer
    x-convolution (digitalfilters.py:124, 1454-1467) as one contraction."""
    nfx2 = bx.shape[0] - 1
    x = filtered_slabs.movedim(axis, -1)              # (..., jma, kma, T+2nfx)
    t_out = x.shape[-1] - nfx2
    Bt = toeplitz_band(bx.to(x.dtype), t_out)         # (T, T+2nfx)
    y = torch.matmul(x, Bt.T)                         # (..., jma, kma, T)
    return y.movedim(-1, axis)


def generate_correlated_noise(
    seed: int, t0: int, nsteps: int, jma: int, kma: int,
    nfx: int, nfy: int, nfz: int, lnx: float, lny: float, lnz: float,
    num_components: int = 3, dtype=torch.float32, device="cuda",
    noise: torch.Tensor | None = None,
) -> torch.Tensor:
    """Correlated, unit-variance noise ``(num_components, nsteps, jma, kma)``
    for the global time window ``[t0, t0 + nsteps)``.

    ``noise`` (optional) is the raw ``(C, nsteps + 2nfx, jma + 2nfy,
    kma + 2nfz)`` field to filter instead of drawing one — how the tests
    feed the port and the JAX package the same numbers."""
    device = torch.device(device) if noise is None else noise.device
    bx = gaussian_fir_coeffs(nfx, lnx, dtype, device)
    by = gaussian_fir_coeffs(nfy, lny, dtype, device)
    bz = gaussian_fir_coeffs(nfz, lnz, dtype, device)
    if noise is None:
        noise = noise_slabs(seed, t0, nsteps + 2 * nfx, jma + 2 * nfy,
                            kma + 2 * nfz, num_components, dtype, device)
    z = filter_spatial(noise.to(dtype), by, bz, jma, kma)
    return filter_temporal(z, bx, axis=-3)


def generate_correlated_noise_scan(
    seed: int, nsteps: int, block: int, jma: int, kma: int,
    nfx: int, nfy: int, nfz: int, lnx: float, lny: float, lnz: float,
    num_components: int = 3, dtype=torch.float32, device="cuda",
    noise: torch.Tensor | None = None,
) -> torch.Tensor:
    """Streaming variant of :func:`generate_correlated_noise` for the window
    ``[0, nsteps)``: overlap-save over time blocks of ``block`` steps, the
    original's ``lax.scan`` as a host loop.

    The carry is the trailing ``2*nfx`` *spatially filtered* slabs — the
    analog of the reference's ring buffer, carrying the (jma, kma) filtered
    slabs instead of the raw noise, so the spatial filter runs once per
    slab.  Each block draws its slabs from the per-slab stream (or slices
    ``noise``, the raw ``(C, nsteps + 2nfx, jma + 2nfy, kma + 2nfz)``
    field, as :func:`generate_correlated_noise` takes it).  ``nsteps``
    must be a multiple of ``block``."""
    if block <= 0 or nsteps % block:
        raise ValueError(f"nsteps {nsteps} must be a multiple of block {block}")
    device = resolve_device(device) if noise is None else noise.device
    bx = gaussian_fir_coeffs(nfx, lnx, dtype, device)
    by = gaussian_fir_coeffs(nfy, lny, dtype, device)
    bz = gaussian_fir_coeffs(nfz, lnz, dtype, device)
    nfx2 = 2 * nfx
    jn, kn = jma + 2 * nfy, kma + 2 * nfz

    def filt_block(t0, num):
        raw = (noise_slabs(seed, t0, num, jn, kn, num_components, dtype, device)
               if noise is None else noise[:, t0:t0 + num])
        return filter_spatial(raw.to(dtype), by, bz, jma, kma)

    out = torch.empty((num_components, nsteps, jma, kma), dtype=dtype,
                      device=device)
    carry = filt_block(0, nfx2)      # warm-up: the first 2*nfx filtered slabs
    for t in range(0, nsteps, block):
        window = torch.cat([carry, filt_block(nfx2 + t, block)], dim=1)
        out[:, t:t + block] = filter_temporal(window, bx, axis=-3)
        carry = window[:, block:]
    return out


def filter_direct_3d(noise: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Direct filter of one noise buffer ``(2nfx+1, jn, kn)`` with the full
    3-D kernel — mirror of the reference's own A/B oracle ``filter3D``
    (digitalfilters.py:91-98).  Test use only."""
    kx, ky, kz = kernel.shape
    jma = noise.shape[1] - ky + 1
    kma = noise.shape[2] - kz + 1
    out = torch.zeros((jma, kma), dtype=noise.dtype, device=noise.device)
    for i in range(kx):
        for dj in range(ky):
            for dk in range(kz):
                out += kernel[i, dj, dk] * noise[i, dj:dj + jma, dk:dk + kma]
    return out
