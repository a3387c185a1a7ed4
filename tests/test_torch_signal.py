"""The port's signal numerics (pods_digital_filter_tpu_torch/ops/signal.py),
held to the JAX package's on the same numpy inputs.

Mirrors tests/test_signal.py (9).  Parity: float64 inputs on both sides
(conftest turns on jax x64), results within rtol 1e-12 (FFT round-off);
dtypes are compared too — a float32 signal keeps float32 in
``welch_psd`` and becomes complex128 in ``welch_csd`` and
``cross_correlation`` (their float64 window), on both sides.
"""

import numpy as np
import pytest
import torch

from torch_parity import np_of  # noqa: I001

from pods_digital_filter_tpu.ops import signal as jsignal
from pods_digital_filter_tpu_torch.ops import signal

CPU = dict(device="cpu")


def test_welch_pure_tone():
    fs, N = 100.0, 256
    t = np.arange(4 * N) / fs
    f0 = 12.5
    x = np.sqrt(2.0) * np.cos(2 * np.pi * f0 * t)
    f, Sxx, M = signal.welch_psd(x, fs, N, iwindow=1, **CPU)
    Sxx = np_of(Sxx)
    assert M == 1 + (x.size - N) // (N // 2)
    df = fs / N
    np.testing.assert_allclose(np.sum(Sxx) * df, np.var(x), rtol=0.05)
    peaks = np.asarray(f)[np.argsort(Sxx)[-2:]]
    np.testing.assert_allclose(sorted(np.abs(peaks)), [f0, f0], atol=df)


def test_welch_windows():
    fs, N = 10.0, 64
    x = np.random.default_rng(0).standard_normal(256)
    for iwindow in (1, 2, 3):
        f, Sxx, _ = signal.welch_psd(x, fs, N, iwindow, **CPU)
        np.testing.assert_allclose(np.sum(np_of(Sxx)) * fs / N, np.var(x),
                                   rtol=0.35)


def test_block_size_check():
    with pytest.raises(ValueError):
        signal.welch_psd(np.zeros(10), 1.0, 16, **CPU)


def test_coherence_of_identical_signals():
    x = np.random.default_rng(1).standard_normal(512)
    f, coh, M, _ = signal.coherence(x, x, 1.0, 64, **CPU)
    np.testing.assert_allclose(np_of(coh).real, 1.0, atol=1e-8)


def test_transfer_function_of_scaled_signal():
    x = np.random.default_rng(2).standard_normal(512)
    f, H, M = signal.transfer_function(x, 3.0 * x, 1.0, 64, **CPU)
    np.testing.assert_allclose(np_of(H).real, 3.0, atol=1e-6)


def test_cross_correlation_peak_at_lag():
    rng = np.random.default_rng(3)
    x = rng.standard_normal(1024)
    lag = 5
    y = np.roll(x, lag)
    lags, R, M = signal.cross_correlation(y, x, 1.0, 128, **CPU)
    assert lags[np.argmax(np_of(R).real)] == pytest.approx(lag)


def test_mean_dim_convention(rng):
    m = rng.standard_normal((4, 6))
    np.testing.assert_allclose(np_of(signal.mean(m, 1, **CPU)), m.mean(axis=1))
    np.testing.assert_allclose(np_of(signal.mean(m, 0, **CPU)), m.mean(axis=0))
    np.testing.assert_allclose(float(signal.mean(m[0], **CPU)), m[0].mean())


def test_azimuthal_fourier_series_single_mode():
    """A field u(theta) = cos(m0*theta) on one ring puts its energy in
    azimuthal mode m0 (and its alias aziseg - m0)."""
    aziseg = 32
    theta = np.linspace(0.0, 2 * np.pi, aziseg, endpoint=False)
    m0 = 3
    npts = 1 + aziseg
    u = np.zeros((npts, 1))
    u[1:, 0] = np.cos(m0 * theta)
    r = np.concatenate([[0.0], np.ones(aziseg)])
    th = np.concatenate([[0.0], theta])
    m_array, _, _ = signal.azimuthal_fourier_series(
        u, r, th, np.zeros(npts), nc=1, axiseg=1, rseg=1, aziseg=aziseg, **CPU)
    top2 = set(np.argsort(m_array[0, 0, 0, :])[-2:].tolist())
    assert top2 == {m0, aziseg - m0}


def _polar_field(rng, axiseg, rseg, aziseg, nc):
    npts = axiseg * (rseg * aziseg + 1) + 1
    u = rng.standard_normal((npts, nc))
    theta = rng.uniform(0.0, 2 * np.pi, npts)
    idx = signal._ring_index(axiseg, rseg, aziseg)
    theta[idx] = np.sort(theta[idx], axis=-1)
    return u, rng.uniform(0.1, 1.0, npts), theta, rng.standard_normal(npts)


def test_azimuthal_fourier_series_matches_loop_oracle(rng):
    """The batched-einsum azimuthal DFT agrees with the reference-faithful
    host loop on a multi-ring, multi-component field with nonuniform
    azimuthal sampling — and with the JAX package's (float64, 1e-12)."""
    axiseg, rseg, aziseg, nc = 3, 4, 17, 3
    u, r, theta, x = _polar_field(rng, axiseg, rseg, aziseg, nc)
    args = (u, r, theta, x)
    kw = dict(nc=nc, axiseg=axiseg, rseg=rseg, aziseg=aziseg)
    m_v, x_v, r_v = signal.azimuthal_fourier_series(*args, **kw, **CPU)
    m_l, x_l, r_l = signal.azimuthal_fourier_series_loop(*args, **kw)
    np.testing.assert_allclose(m_v, m_l, rtol=1e-9, atol=1e-12)
    np.testing.assert_array_equal(x_v, x_l)
    np.testing.assert_array_equal(r_v, r_l)
    m_j, _, _ = jsignal.azimuthal_fourier_series(*args, **kw)
    np.testing.assert_allclose(m_v, m_j, rtol=1e-12, atol=1e-14)
    np.testing.assert_array_equal(
        m_l, jsignal.azimuthal_fourier_series_loop(*args, **kw)[0])


@pytest.mark.parametrize("iwindow", [1, 2, 3])
def test_spectra_match_jax(iwindow):
    """welch_psd, welch_csd, cross_correlation, transfer_function and
    coherence against the JAX functions (float64 in, rtol 1e-12)."""
    rng = np.random.default_rng(10 + iwindow)
    x = rng.standard_normal(1000)
    y = 0.5 * x + rng.standard_normal(1000)
    fs, N = 20.0, 128
    pairs = {
        "welch_psd": (signal.welch_psd(x, fs, N, iwindow, **CPU),
                      jsignal.welch_psd(x, fs, N, iwindow)),
        "welch_csd": (signal.welch_csd(x, y, fs, N, iwindow, **CPU),
                      jsignal.welch_csd(x, y, fs, N, iwindow)),
        "cross_correlation": (signal.cross_correlation(x, y, fs, N, iwindow, **CPU),
                              jsignal.cross_correlation(x, y, fs, N, iwindow)),
        "transfer_function": (signal.transfer_function(x, y, fs, N, iwindow, **CPU),
                              jsignal.transfer_function(x, y, fs, N, iwindow)),
        "coherence": (signal.coherence(x, y, fs, N, iwindow, **CPU),
                      jsignal.coherence(x, y, fs, N, iwindow)),
    }
    for name, (got, want) in pairs.items():
        np.testing.assert_array_equal(got[0], want[0], err_msg=name)
        assert got[2] == want[2], name
        for g, w in zip(got[1:], want[1:]):
            if isinstance(g, int):
                continue
            g, w = np_of(g), np.asarray(w)
            assert g.dtype == w.dtype, name
            np.testing.assert_allclose(g, w, rtol=1e-12,
                                       atol=1e-12 * np.abs(w).max(), err_msg=name)


def test_float32_dtypes_follow_jax():
    """A float32 signal: welch_psd stays float32, welch_csd and
    cross_correlation promote to complex128 through their float64 window —
    as the JAX package under x64 (values within f32 round-off)."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal(512).astype(np.float32)
    y = rng.standard_normal(512).astype(np.float32)
    got = {"psd": signal.welch_psd(x, 1.0, 64, **CPU)[1],
           "csd": signal.welch_csd(x, y, 1.0, 64, **CPU)[1],
           "xc": signal.cross_correlation(x, y, 1.0, 64, **CPU)[1]}
    want = {"psd": jsignal.welch_psd(x, 1.0, 64)[1],
            "csd": jsignal.welch_csd(x, y, 1.0, 64)[1],
            "xc": jsignal.cross_correlation(x, y, 1.0, 64)[1]}
    assert got["psd"].dtype == torch.float32
    assert got["csd"].dtype == got["xc"].dtype == torch.complex128
    for k in got:
        w = np.asarray(want[k])
        assert np_of(got[k]).dtype == w.dtype, k
        np.testing.assert_allclose(np_of(got[k]), w, rtol=0,
                                   atol=1e-5 * np.abs(w).max(), err_msg=k)


def test_signals_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; the refusal needs a host without one")
    with pytest.raises(RuntimeError, match="cuda"):
        signal.welch_psd(np.zeros(64), 1.0, 16)
