"""Signal-processing numerics — port of ``pods_digital_filter_tpu/ops/signal.py``.

Reference: ``nsigproclib_no_mpi.py`` — Welch PSD (``fct_welch``, lines 10-68),
cross-spectral density (``fct_iwelch``, 71-132), windowed cross-correlation
(``cross_correlation``, 134-198), transfer function (201-208), coherence
(210-218), azimuthal Fourier series (253-311).

Batched torch ops on ``device`` (default the card): the per-block Python
loop is a strided gather plus one batched ``torch.fft.fft``.  Conventions
kept exactly: window selector ``iwindow`` 1=rectangular / 2=Hanning /
3=Blackman, corrective factor ``Cw = N / sum(w^2)``, 50%% overlap with
``M = 1 + floor((size-N)/(N//2))`` blocks, ``fftshift``-ed two-sided spectra,
frequency vector ``linspace(-N/2, N/2-1, N)/N*fs`` (and the
cross-correlation lag vector's ``/fs``-only scaling quirk, line 178).

Dtypes follow the original under ``jax_enable_x64``: an input keeps its
floating dtype (an integer one becomes float64); ``welch_csd``,
``cross_correlation`` and the functions built on them take a float64
window whatever the input's dtype, so a float32 signal's spectra come out
in float64 (complex128) there, as torch promotes float32 x float64 tensors.
Spectra are returned as tensors on the device; frequency and lag vectors
as host numpy, as the original returns them.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from pods_digital_filter_tpu_torch.device import resolve_device


def _as_signal(x, dev) -> torch.Tensor:
    x = torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor) else x,
                        device=dev)
    return x if x.is_floating_point() or x.is_complex() else x.to(torch.float64)


def _window(N: int, iwindow: int, dtype=torch.float64, device="cpu"):
    n = torch.arange(N, dtype=dtype, device=device)
    if iwindow == 2:
        w = 0.5 - 0.5 * torch.cos(2.0 * math.pi * n / (N - 1))
    elif iwindow == 3:
        w = (0.42 - 0.5 * torch.cos(2.0 * math.pi * n / (N - 1))
             + 0.08 * torch.cos(4.0 * math.pi * n / (N - 1)))
    else:  # 1 or anything else: rectangular
        w = torch.ones(N, dtype=dtype, device=device)
    return w


def _num_blocks(size: int, N: int) -> int:
    noverlap = N // 2
    if size < N:
        raise ValueError("Block size N should not be larger than the signal size.")
    return 1 + (size - N) // noverlap


def _blocks(x: torch.Tensor, N: int, M: int) -> torch.Tensor:
    """(M, N) gather of the 50%-overlapping blocks."""
    noverlap = N // 2
    starts = torch.arange(M, device=x.device) * noverlap
    idx = starts[:, None] + torch.arange(N, device=x.device)[None, :]
    return x.reshape(-1)[idx]


def _spectrum(x, w, N, M):
    return torch.fft.fft(_blocks(x, N, M) * w[None, :], dim=1)


def freq_vector(N: int, fs: float) -> np.ndarray:
    return np.linspace(-N / 2, N / 2 - 1, N) / N * fs


def welch_psd(x, fs: float, N: int, iwindow: int = 1, device="cuda"):
    """Two-sided Welch PSD.  Returns ``(f, Sxx, M)`` like the reference."""
    x = _as_signal(x, resolve_device(device))
    M = _num_blocks(x.numel(), N)
    w = _window(N, iwindow, x.dtype if x.is_floating_point() else torch.float64,
                x.device)
    Cw = N / torch.sum(w ** 2)
    X = torch.fft.fftshift(_spectrum(x, w, N, M), dim=1)
    Sxx = torch.mean(Cw / N / fs * (X * torch.conj(X)).real, dim=0)
    return freq_vector(N, fs), Sxx, M


def welch_csd(x, y, fs: float, N: int, iwindow: int = 1, device="cuda"):
    """Two-sided cross-spectral density Sxy (reference ``fct_iwelch``)."""
    dev = resolve_device(device)
    x, y = _as_signal(x, dev), _as_signal(y, dev)
    M = _num_blocks(x.numel(), N)
    w = _window(N, iwindow, device=dev)
    Cw = N / torch.sum(w ** 2)
    X = torch.fft.fftshift(_spectrum(x, w, N, M), dim=1)
    Y = torch.fft.fftshift(_spectrum(y, w, N, M), dim=1)
    Sxy = torch.mean(Cw / N / fs * X * torch.conj(Y), dim=0)
    return freq_vector(N, fs), Sxy, M


def cross_correlation(x, y, fs: float, N: int, iwindow: int = 1,
                      device="cuda"):
    """Windowed cross-correlation via ``ifft(X * conj(Y))``; lag vector keeps
    the reference's ``linspace(-N/2, N/2-1, N)/fs`` scaling (line 178)."""
    dev = resolve_device(device)
    x, y = _as_signal(x, dev), _as_signal(y, dev)
    M = _num_blocks(x.numel(), N)
    w = _window(N, iwindow, device=dev)
    Cw = N / torch.sum(w ** 2)
    X = _spectrum(x, w, N, M)
    Y = _spectrum(y, w, N, M)
    R = torch.mean(
        Cw / N / fs * torch.fft.fftshift(torch.fft.ifft(X * torch.conj(Y), dim=1),
                                         dim=1),
        dim=0,
    )
    lags = np.linspace(-N / 2, N / 2 - 1, N) / fs
    return lags, R, M


def transfer_function(x, y, fs: float, N: int, iwindow: int = 1,
                      device="cuda"):
    f, Sxy, M = welch_csd(x, y, fs, N, iwindow, device)
    _, Sxx, _ = welch_psd(x, fs, N, iwindow, device)
    return f, Sxy / Sxx, M


def coherence(x, y, fs: float, N: int, iwindow: int = 1, device="cuda"):
    f, Sxy, M = welch_csd(x, y, fs, N, iwindow, device)
    _, Sxx, _ = welch_psd(x, fs, N, iwindow, device)
    _, Syy, _ = welch_psd(y, fs, N, iwindow, device)
    return f, torch.abs(Sxy) ** 2 / Sxx / Syy, M, Sxy


def mean(mat, dim: int = 0, device="cuda"):
    """Reference ``mean`` (nsigproclib:221-250): axis mean with its dim
    convention — for 2-D input, ``dim=1`` averages over columns (axis 1),
    anything else averages over rows (axis 0); 1-D input -> scalar."""
    mat = _as_signal(mat, resolve_device(device))
    if mat.ndim == 2:
        return torch.mean(mat, dim=1 if dim == 1 else 0)
    return torch.mean(mat)


def _ring_index(axiseg: int, rseg: int, aziseg: int) -> np.ndarray:
    """Point indices of every (axial, radial) ring in the reference's
    structured polar ordering (nsigproclib:253-311): point 0 of each axial
    block is the axis point, then rseg rings of aziseg consecutive points —
    ``idx[jj, k, m] = 1 + jj*(rseg*aziseg + 1) + k*aziseg + m``."""
    jj = np.arange(axiseg)[:, None, None]
    k = np.arange(rseg)[None, :, None]
    m = np.arange(aziseg)[None, None, :]
    return 1 + jj * (rseg * aziseg + 1) + k * aziseg + m


def _azimuthal_weight_phases(theta: np.ndarray):
    """Trapezoid quadrature weights folded into cos/sin phase tables —
    computed on the host in float64, as in the original: the phase
    ``n*theta`` grows to ``O(aziseg * 2pi)``, so forming it in float32 costs
    ~1e-4 rad of phase error at high mode numbers.  Only the contraction
    runs on the device.  Weights: c_0 = (t1-t0)/2, c_last = (t_end -
    t_{end-1})/2, else (t_{m+1} - t_{m-1})/2."""
    theta = np.asarray(theta, dtype=np.float64)
    dt = theta[..., 1:] - theta[..., :-1]
    c = np.concatenate([
        dt[..., :1] * 0.5,
        (theta[..., 2:] - theta[..., :-2]) * 0.5,
        dt[..., -1:] * 0.5,
    ], axis=-1)                                       # (jj, k, m)
    n = np.arange(theta.shape[-1], dtype=np.float64)
    ph = n[:, None] * theta[..., None, :]             # (jj, k, n, m)
    return c[..., None, :] * np.cos(ph), c[..., None, :] * np.sin(ph)


def _azimuthal_energies(u, cu, su):
    """Batched trapezoid-DFT contraction: ``u (P, jj, k, m)`` ring samples
    against the precomputed weighted cos/sin phases ``cu/su (jj, k, n, m)``
    -> ``|trapz(u * exp(-1j n theta), theta)|^2`` of shape (P, jj, k, n) for
    all n < aziseg: two real ``einsum`` contractions."""
    re = torch.einsum("pjkm,jknm->pjkn", u, cu)
    im = -torch.einsum("pjkm,jknm->pjkn", u, su)
    return re * re + im * im


def azimuthal_fourier_series(u, r, theta, x, nc: int, axiseg: int, rseg: int,
                             aziseg: int, device="cuda"):
    """Azimuthal mode energies on a structured polar mesh
    (reference nsigproclib:253-311, minus the VTK plumbing: fields are passed
    as flat arrays in the reference's point ordering).

    ``u``: (num_points, nc) components (the magnitude column is added here);
    returns host float64 ``(m_array, x_array, r_array)`` with
    ``m_array[i, jj, k, n] = |trapz(u_i * exp(-1j*n*theta), theta)|^2``.

    The reference's four nested host loops (components x axial x radial x
    mode, each calling np.trapz) are one gather and one batched contraction
    in float64 on ``device`` (:func:`_azimuthal_energies`); the loop
    version is kept as the parity oracle
    (:func:`azimuthal_fourier_series_loop`).
    """
    dev = resolve_device(device)
    u = np.asarray(u, dtype=np.float64).reshape(-1, nc)
    if nc > 1:
        mag = np.sqrt(np.sum(u ** 2, axis=1, keepdims=True))
        u = np.concatenate([u, mag], axis=1)

    idx = _ring_index(axiseg, rseg, aziseg)
    cu, su = _azimuthal_weight_phases(np.asarray(theta, dtype=np.float64)[idx])
    as_t = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=dev)
    u_r = as_t(u.T[:, idx])                           # (ncomp, jj, k, m)
    m_array = np.zeros((nc + 1, axiseg, rseg, aziseg), dtype=np.float64)
    m_array[:u_r.shape[0]] = _azimuthal_energies(u_r, as_t(cu), as_t(su)).cpu().numpy()
    x_array = np.asarray(x, dtype=np.float64)[idx[..., -1]]
    r_array = np.asarray(r, dtype=np.float64)[idx[..., -1]]
    return m_array, x_array, r_array


def azimuthal_fourier_series_loop(u, r, theta, x, nc: int, axiseg: int,
                                  rseg: int, aziseg: int):
    """Reference-faithful host-loop implementation (nsigproclib:253-311) —
    the parity oracle for :func:`azimuthal_fourier_series` (numpy, a copy
    of the original's)."""
    u = np.asarray(u, dtype=np.float64).reshape(-1, nc)
    if nc > 1:
        mag = np.sqrt(np.sum(u ** 2, axis=1, keepdims=True))
        u = np.concatenate([u, mag], axis=1)
        ncomp = nc + 1
    else:
        ncomp = nc

    m_array = np.zeros((nc + 1, axiseg, rseg, aziseg), dtype=np.float64)
    x_array = np.zeros((axiseg, rseg), dtype=np.float64)
    r_array = np.zeros((axiseg, rseg), dtype=np.float64)

    for jj in range(axiseg):
        for k in range(rseg):
            base = 1 + jj * (rseg * aziseg + 1) + k * aziseg
            sl = slice(base, base + aziseg)
            tt = np.asarray(theta)[sl]
            x_array[jj, k] = np.asarray(x)[sl][-1]
            r_array[jj, k] = np.asarray(r)[sl][-1]
            for i in range(ncomp):
                uu = u[sl, i]
                for n in range(aziseg):
                    val = np.trapezoid(uu * np.exp(-1j * n * tt), tt)
                    m_array[i, jj, k, n] = (val * np.conj(val)).real
    return m_array, x_array, r_array
