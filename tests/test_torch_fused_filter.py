"""Fused noise + spatial filter of the port (ops/fused_filter.py, ops/philox.py)
on the CPU, where the wrapper takes the plain PyTorch version: Philox
known answers, the element-keyed stream's statistics and window
independence, and float32 parity (atol 2e-5) with the JAX package's Pallas
kernels run in interpret mode on the same noise.  The CUDA kernel itself is
checked against these plain versions on the card by chip_smoke.py."""

import numpy as np
import pytest
import torch

from torch_parity import np_of  # noqa: I001

from pods_digital_filter_tpu.ops import filters as jf
from pods_digital_filter_tpu.ops import pallas_filter as pf
from pods_digital_filter_tpu_torch.ops import filters as tf
from pods_digital_filter_tpu_torch.ops import fused_filter as ff
from pods_digital_filter_tpu_torch.ops import philox

SQRT3 = float(np.sqrt(3.0))


def _philox_int(ctr, key):
    """Philox4x32-10 on Python ints — an independent statement of the
    algorithm (Salmon et al., SC'11) for the tests."""
    c = list(ctr)
    k0, k1 = key
    m = 0xFFFFFFFF
    for _ in range(10):
        p0, p1 = 0xD2511F53 * c[0], 0xCD9E8D57 * c[2]
        c = [(p1 >> 32) ^ c[1] ^ k0, p1 & m, (p0 >> 32) ^ c[3] ^ k1, p0 & m]
        k0, k1 = (k0 + 0x9E3779B9) & m, (k1 + 0xBB67AE85) & m
    return c


@pytest.mark.parametrize("ctr,key,want", [
    ((0, 0, 0, 0), (0, 0),
     (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
    ((0xffffffff,) * 4, (0xffffffff,) * 2,
     (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
    ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
     (0xa4093822, 0x299f31d0),
     (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1)),
])
def test_philox_known_answers(ctr, key, want):
    """Random123's Philox4x32-10 known-answer vectors."""
    words = philox.philox4x32(*(torch.tensor([v], dtype=torch.int64)
                                for v in ctr), *key)
    assert tuple(int(w) for w in words) == want
    assert tuple(_philox_int(ctr, key)) == want


def test_word_to_uniform_is_int32_bitcast():
    words = np.array([0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF, 0x12345678],
                     dtype=np.uint32)
    got = np_of(philox.words_to_uniform(torch.as_tensor(words.astype(np.int64))))
    want = words.view(np.int32).astype(np.float32) * np.float32(
        2.0 * SQRT3 * 2.0 ** -32)
    np.testing.assert_array_equal(got, want)
    assert got.min() >= -SQRT3 and got.max() <= SQRT3 + 1e-6


def test_raw_noise_is_element_keyed():
    """Element (c, s, j, k) is word k&3 of Philox((k>>2, j, t0+s, c),
    seed), whatever field it was drawn as part of."""
    seed, t0 = (5 << 32) | 77, 3
    big = np_of(ff.raw_noise(seed, t0, 4, 9, 14, 2))
    small = np_of(ff.raw_noise(seed, t0 + 1, 2, 5, 7, 2))
    np.testing.assert_array_equal(small, big[:, 1:3, :5, :7])
    for c, s, j, k in ((0, 0, 0, 0), (1, 2, 8, 13), (0, 3, 4, 6)):
        w = _philox_int((k >> 2, j, t0 + s, c), (77, 5))[k & 3]
        want = np.float32(np.int64(w) - (w >= 2 ** 31) * 2 ** 32) * np.float32(
            philox.SCALE)
        assert big[c, s, j, k] == want


def test_stream_statistics():
    """Port of the TPU-gated test_oncore_prng_statistics_tpu
    (tests/test_pallas_filter.py:128-169) on the plain stream, at ~0.5 M
    samples: moments of uniform(+/-sqrt3) and vanishing lag-1
    correlations along k, j and slab."""
    x = np_of(ff.raw_noise(7, 0, 8, 256, 256, 1))[0].astype(np.float64)
    n, flat = x.size, x.reshape(-1)
    var = flat.var()
    assert abs(flat.mean()) < 5.0 / np.sqrt(n)
    assert abs(var - 1.0) < 0.01
    assert abs((flat ** 4).mean() - 9.0 / 5.0) < 0.02
    for rho in (np.mean(x[:, :, :-1] * x[:, :, 1:]) / var,
                np.mean(x[:, :-1, :] * x[:, 1:, :]) / var,
                np.mean(x[:-1] * x[1:]) / var):
        assert abs(rho) < 5.0 / np.sqrt(n)
    assert flat.min() < -SQRT3 * 0.999 and flat.max() > SQRT3 * 0.999
    assert flat.min() >= -SQRT3 - 1e-5 and flat.max() <= SQRT3 + 1e-5


def test_blockwise_consistent_with_full():
    """Window [8, 16) equals the slice of [0, 16) (the JAX twin,
    test_blockwise_consistent_with_full_tpu_only, can run only on a TPU)."""
    gen = lambda t0, n: np_of(ff.generate_correlated_noise_fused(
        7, t0, n, 12, 8, 2, 2, 2, 1.0, 1.0, 1.0))
    np.testing.assert_allclose(gen(8, 8), gen(0, 16)[:, 8:], atol=1e-6)


def test_plain_chunks_match_one_pass(monkeypatch):
    """The plain version's slab chunking does not change its result."""
    by = tf.gaussian_fir_coeffs(3, 1.5)
    bz = tf.gaussian_fir_coeffs(2, 1.0)
    whole = ff.fused_spatial(9, 4, 7, 11, 13, by, bz, 2)
    raw = philox.raw_noise(9, 4, 7, 17, 17, 2)
    np.testing.assert_array_equal(
        np_of(whole), np_of(tf.filter_spatial(raw, by, bz, 11, 13)))
    monkeypatch.setattr(ff, "_MAX_GROUPS_PER_CHUNK", 1)
    np.testing.assert_array_equal(
        np_of(ff.fused_spatial(9, 4, 7, 11, 13, by, bz, 2)), np_of(whole))


def test_noise_in_matches_pallas_full_kernel():
    """Noise-in mode on the noise the Pallas kernel's interpret path draws
    (rebuilt as tests/test_pallas_filter.py:64-70 does), float32."""
    import jax
    import jax.numpy as jnp

    seed, t0, nsteps, jma, kma, nf, ln = 3, 5, 8, 24, 16, 2, 1.0
    want = np.asarray(pf.generate_correlated_noise_fused(
        seed, t0, nsteps, jma, kma, nf, nf, nf, ln, ln, ln, num_components=3,
        dtype=jnp.float32, interpret=True))
    num_slabs = nsteps + 2 * nf
    jn, kn = jma + 2 * nf, kma + 2 * nf
    key = jax.random.fold_in(jax.random.key(seed), t0)
    raw = np.array(jax.random.uniform(
        key, (3 * num_slabs, jn, kn), jnp.float32, -SQRT3, SQRT3)
    ).reshape(3, num_slabs, jn, kn)
    got = ff.generate_correlated_noise_fused(
        seed, t0, nsteps, jma, kma, nf, nf, nf, ln, ln, ln,
        dtype=torch.float32, noise=torch.as_tensor(raw))
    assert got.dtype == torch.float32 and want.dtype == np.float32
    np.testing.assert_allclose(np_of(got), want, atol=2e-5)


def test_noise_in_matches_pallas_tiled_kernel():
    """Noise-in mode on the tiled Pallas kernel's row-block field
    (pf.tiled_interpret_noise), jma 200 > one 128-row stripe, float32."""
    import jax.numpy as jnp

    seed, t0, nsteps, nf, ln = 7, 3, 4, 2, 1.0
    jma, kma = 200, 24
    num_slabs = nsteps + 2 * nf
    by = jf.gaussian_fir_coeffs(nf, ln, jnp.float32)
    seed_arr = jnp.asarray([[seed, t0, num_slabs, nf]], jnp.int32)
    want = np.asarray(pf._fused_spatial_tiled(
        seed_arr, jf.toeplitz_band(by, kma).T, jf.toeplitz_band(by, pf._TILE_J),
        num_slabs=num_slabs, jma=jma, kma=kma, nfy=nf, num_components=2,
        interpret=True))
    ntiles = -(-jma // pf._TILE_J)
    full = np.asarray(pf.tiled_interpret_noise(
        seed, t0, num_slabs, ntiles, pf._TILE_J, kma + 2 * nf, 2))
    raw = np.ascontiguousarray(full[:, :, : jma + 2 * nf])
    tby = tf.gaussian_fir_coeffs(nf, ln, torch.float32)
    got = ff.fused_spatial(seed, t0, num_slabs, jma, kma, tby, tby, 2,
                           noise=torch.as_tensor(raw))
    assert got.dtype == torch.float32 and want.dtype == np.float32
    np.testing.assert_allclose(np_of(got), want, atol=2e-5)


def test_fused_statistics_match_taps():
    """Generated fields: unit variance, zero mean, adjacent-z correlation
    equal to the tap autocorrelation, components decorrelated."""
    nf, ln = 4, 2.0
    y = np_of(ff.generate_correlated_noise_fused(
        1, 0, 48, 32, 48, nf, nf, nf, ln, ln, ln))
    b = np_of(tf.gaussian_fir_coeffs(nf, ln, torch.float64))
    assert abs(y.var() - 1.0) < 0.15 and abs(y.mean()) < 0.05
    prod = (y[..., :-1] * y[..., 1:]).mean() / y.var()
    assert abs(prod - float((b[:-1] * b[1:]).sum())) < 0.1
    assert abs(np.corrcoef(y[0].ravel(), y[1].ravel())[0, 1]) < 0.05


def test_wrapper_validates_inputs():
    by = tf.gaussian_fir_coeffs(2, 1.0)
    with pytest.raises(ValueError, match="noise shape"):
        ff.fused_spatial(0, 0, 3, 8, 8, by, by, 1,
                         noise=torch.zeros(1, 3, 8, 8))
    with pytest.raises(ValueError, match="several devices"):
        ff.fused_spatial(0, 0, 3, 8, 8, by, by.to("meta"), 1)
    with pytest.raises(ValueError, match="unsupported device"):
        ff.raw_noise(0, 0, 1, 4, 4, device="meta")


def test_stream_tags_never_equal_jax_tags():
    jax_tags = {pf.generation_stream_tag(u, 512, 512, 8, 8)
                for u in (False, True)}
    ours = {ff.generation_stream_tag(True, "cpu"),
            ff.generation_stream_tag(True, "cuda"),
            ff.generation_stream_tag(False, "cpu"),
            ff.generation_stream_tag(False, "cuda")}
    assert ff.generation_stream_tag(True, "cuda") == "cuda-philox-v1"
    assert len(ours) == 3 and not ours & jax_tags
