"""PyTorch port of the digital-filter core (pods_digital_filter_tpu_torch/
ops/filters.py): float64 parity with the JAX functions on the same numpy
inputs (rtol 1e-10), the sequential scipy oracle, and mirrors of
tests/test_filters.py on the port's torch.Generator stream."""

import numpy as np
import pytest
import torch

from torch_parity import np_of, to_jax, to_torch, uniform_noise  # noqa: I001
from oracle import gaussian_coeffs, sequential_filter

from pods_digital_filter_tpu.ops import filters as jf
from pods_digital_filter_tpu_torch.ops import filters as tf

F64 = np.float64


@pytest.mark.parametrize("n,ln", [(2, 1.0), (3, 1.5), (8, 4.0), (12, 5.0)])
def test_gaussian_fir_coeffs_match_jax(n, ln):
    import jax.numpy as jnp

    got = np_of(tf.gaussian_fir_coeffs(n, ln, torch.float64))
    want = np.asarray(jf.gaussian_fir_coeffs(n, ln, jnp.float64))
    np.testing.assert_allclose(got, want, rtol=1e-10)


def test_toeplitz_band_matches_jax(rng):
    c = rng.standard_normal(7)
    got = np_of(tf.toeplitz_band(to_torch(c, F64), 19))
    want = np.asarray(jf.toeplitz_band(to_jax(c, F64), 19))
    np.testing.assert_allclose(got, want, rtol=1e-10)


@pytest.mark.parametrize("jma,kma,nfy,nfz", [(7, 9, 2, 3), (16, 5, 4, 1)])
def test_filter_spatial_matches_jax(jma, kma, nfy, nfz):
    rng = np.random.default_rng(11)
    x = uniform_noise(rng, (3, 4, jma + 2 * nfy, kma + 2 * nfz), F64)
    by, bz = gaussian_coeffs(nfy, 1.5), gaussian_coeffs(nfz, 2.0)
    got = np_of(tf.filter_spatial(to_torch(x, F64), to_torch(by, F64),
                                  to_torch(bz, F64), jma, kma))
    want = np.asarray(jf.filter_spatial(to_jax(x, F64), to_jax(by, F64),
                                        to_jax(bz, F64), jma, kma))
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-13)


@pytest.mark.parametrize("axis", [-3, 1])
def test_filter_temporal_matches_jax(axis):
    rng = np.random.default_rng(12)
    z = rng.standard_normal((3, 14, 5, 6))
    bx = gaussian_coeffs(3, 1.5)
    got = np_of(tf.filter_temporal(to_torch(z, F64), to_torch(bx, F64), axis))
    want = np.asarray(jf.filter_temporal(to_jax(z, F64), to_jax(bx, F64), axis))
    assert got.shape == (3, 8, 5, 6)
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-13)


def test_generate_given_noise_matches_jax_chain():
    """generate_correlated_noise(noise=...) == JAX filter_spatial ->
    filter_temporal on the same raw field (float64)."""
    import jax.numpy as jnp

    jma, kma, nsteps, nf, ln = 6, 7, 5, 2, 1.2
    rng = np.random.default_rng(13)
    raw = uniform_noise(rng, (3, nsteps + 2 * nf, jma + 2 * nf, kma + 2 * nf),
                        F64)
    got = np_of(tf.generate_correlated_noise(
        0, 0, nsteps, jma, kma, nf, nf, nf, ln, ln, ln, dtype=torch.float64,
        noise=to_torch(raw, F64)))
    b = jf.gaussian_fir_coeffs(nf, ln, jnp.float64)
    want = np.asarray(jf.filter_temporal(
        jf.filter_spatial(to_jax(raw, F64), b, b, jma, kma), b, axis=-3))
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-13)


def test_filter_direct_3d_matches_jax_oracle(rng):
    nf, ln, jma, kma = 2, 1.0, 4, 5
    buf = rng.standard_normal((2 * nf + 1, jma + 2 * nf, kma + 2 * nf))
    got = np_of(tf.filter_direct_3d(
        to_torch(buf, F64), tf.filter_kernel_3d(nf, nf, nf, ln, ln, ln,
                                                torch.float64)))
    import jax.numpy as jnp

    want = np.asarray(jf.filter_direct_3d(
        to_jax(buf, F64), jf.filter_kernel_3d(nf, nf, nf, ln, ln, ln,
                                              jnp.float64)))
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-13)


# --- mirrors of tests/test_filters.py ---------------------------------------

def test_coeff_normalization():
    for n, ln in [(3, 1.5), (6, 3.0), (12, 5.0)]:
        b = np_of(tf.gaussian_fir_coeffs(n, ln, torch.float64))
        assert b.shape == (2 * n + 1,)
        np.testing.assert_allclose(np.sum(b * b), 1.0, rtol=1e-12)
        np.testing.assert_allclose(b, gaussian_coeffs(n, ln), rtol=1e-12)
        np.testing.assert_allclose(b, b[::-1], rtol=1e-12)


def test_toeplitz_band_matches_convolve_valid(rng):
    x = rng.standard_normal(37)
    c = gaussian_coeffs(4, 2.0)
    B = np_of(tf.toeplitz_band(to_torch(c, F64), 37 - 8))
    np.testing.assert_allclose(B @ x, np.convolve(x, c, mode="valid"),
                               rtol=1e-10, atol=1e-12)


def test_generate_matches_sequential_oracle():
    """Batched formulation == the reference's sequential rolling-buffer
    filter on the port's own noise stream."""
    jma, kma, nsteps = 7, 9, 12
    nf, ln = 4, 2.0
    y = np_of(tf.generate_correlated_noise(
        7, 0, nsteps, jma, kma, nf, nf, nf, ln, ln, ln, dtype=torch.float64,
        device="cpu"))
    raw = np_of(tf.noise_slabs(7, 0, nsteps + 2 * nf, jma + 2 * nf,
                               kma + 2 * nf, 3, torch.float64, "cpu"))
    b = gaussian_coeffs(nf, ln)
    for c in range(3):
        want = sequential_filter(raw[c], b, b, b, jma, kma)
        np.testing.assert_allclose(y[c], want, rtol=1e-9, atol=1e-11)


def test_time_windows_are_consistent():
    """Per-slab generators: [0, 12) equals [0, 4) + [4, 12)."""
    args = (5, 6, 3, 3, 3, 1.5, 1.5, 1.5)
    gen = lambda t0, n: np_of(tf.generate_correlated_noise(
        3, t0, n, *args, dtype=torch.float64, device="cpu"))
    full = gen(0, 12)
    np.testing.assert_allclose(full[:, :4], gen(0, 4), rtol=1e-12)
    np.testing.assert_allclose(full[:, 4:], gen(4, 8), rtol=1e-12)


def test_direct_3d_filter_matches_separable(rng):
    nf, ln, jma, kma = 3, 1.5, 5, 6
    buf = to_torch(rng.standard_normal((2 * nf + 1, jma + 2 * nf,
                                        kma + 2 * nf)), F64)
    kern = tf.filter_kernel_3d(nf, nf, nf, ln, ln, ln, torch.float64)
    direct = np_of(tf.filter_direct_3d(buf, kern))
    b = tf.gaussian_fir_coeffs(nf, ln, torch.float64)
    sep = tf.filter_temporal(tf.filter_spatial(buf, b, b, jma, kma)[None], b,
                             axis=-3)[0, 0]
    np.testing.assert_allclose(direct, np_of(sep), rtol=1e-9, atol=1e-12)


def test_noise_stream_moments_and_seeds():
    """The torch.Generator stream: uniform on (-sqrt3, sqrt3), unit
    variance, a different field per seed and per slab."""
    x = np_of(tf.noise_slabs(5, 0, 16, 64, 64, 1, torch.float64, "cpu"))
    a = np.sqrt(3.0)
    assert x.min() >= -a and x.max() <= a
    assert abs(x.mean()) < 5.0 / np.sqrt(x.size)
    assert abs(x.var() - 1.0) < 0.02
    assert not np.allclose(x[0, 0], x[0, 1])
    other = np_of(tf.noise_slabs(6, 0, 1, 64, 64, 1, torch.float64, "cpu"))
    assert not np.allclose(x[0, 0], other[0, 0])


def test_output_statistics():
    """Unit variance and the Gaussian two-point correlation of the
    prescribed length scale (Klein 2003, eq. 14), at a size that runs in
    seconds (the JAX twin is marked slow)."""
    jma, kma, nsteps = 40, 40, 160
    nf, ln = 4, 2.0
    y = np_of(tf.generate_correlated_noise(
        123, 0, nsteps, jma, kma, nf, nf, nf, ln, ln, ln, num_components=1,
        dtype=torch.float64, device="cpu"))[0]
    var = y.var()
    assert abs(var - 1.0) < 0.1, var
    for r in (1, 2, 3):
        corr = np.mean(y[:, :, r:] * y[:, :, :-r]) / var
        expected = np.exp(-np.pi * r * r / (4.0 * ln * ln))
        assert abs(corr - expected) < 0.08, (r, corr, expected)


def test_scan_matches_batched():
    """The overlap-save block loop equals the batched generator on the
    port's own stream (float64)."""
    args = dict(jma=6, kma=8, nfx=3, nfy=3, nfz=3, lnx=1.5, lny=1.5, lnz=1.5,
                dtype=torch.float64, device="cpu")
    full = np_of(tf.generate_correlated_noise(11, 0, 12, **args))
    scanned = np_of(tf.generate_correlated_noise_scan(11, 12, 4, **args))
    np.testing.assert_allclose(scanned, full, rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("nfx,block", [(2, 3), (1, 6)])
def test_scan_matches_jax_on_injected_noise(monkeypatch, nfx, block):
    """The port's scan and the JAX scan on one injected raw field (float64,
    rtol 1e-10): the JAX module's noise_slabs is patched (in this test
    only) to slice that field at the traced t0 with dynamic_slice; the port
    takes it as ``noise``."""
    import jax
    import jax.numpy as jnp

    jma, kma, nfy, nfz, nsteps = 5, 7, 2, 1, 12
    rng = np.random.default_rng(17)
    raw = uniform_noise(rng, (3, nsteps + 2 * nfx, jma + 2 * nfy,
                              kma + 2 * nfz), F64)
    raw_j = to_jax(raw, F64)

    def sliced(key, t0, num, jn, kn, num_components, dtype):
        return jax.lax.dynamic_slice_in_dim(raw_j, t0, num, axis=1).astype(dtype)

    monkeypatch.setattr(jf, "noise_slabs", sliced)
    jf._generate_scan_jit.clear_cache()
    try:
        want = np.asarray(jf.generate_correlated_noise_scan(
            jax.random.key(0), nsteps, block, jma, kma, nfx, nfy, nfz, 1.3,
            1.1, 0.9, dtype=jnp.float64))
    finally:
        jf._generate_scan_jit.clear_cache()
    got = np_of(tf.generate_correlated_noise_scan(
        0, nsteps, block, jma, kma, nfx, nfy, nfz, 1.3, 1.1, 0.9,
        dtype=torch.float64, noise=to_torch(raw, F64)))
    assert got.shape == want.shape == (3, nsteps, jma, kma)
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-13)


def test_scan_without_temporal_taps():
    """nfx = 0 carries no slabs: the scan equals the batched generator on
    the same field (the JAX scan refuses this case: its carry
    ``window[:, -0:]`` is the whole window)."""
    rng = np.random.default_rng(19)
    raw = to_torch(uniform_noise(rng, (2, 8, 9, 10), F64), F64)
    args = (8, 4, 5, 6, 0, 2, 2, 1.0, 1.2, 1.4)
    got = tf.generate_correlated_noise_scan(0, *args, num_components=2,
                                            dtype=torch.float64, noise=raw)
    want = tf.generate_correlated_noise(0, 0, 8, *args[2:], num_components=2,
                                        dtype=torch.float64, noise=raw)
    np.testing.assert_allclose(np_of(got), np_of(want), rtol=1e-12, atol=1e-14)
