"""K3, the noise-draw probes (ops/noise_probe.py), on the CPU where the
wrapper takes its plain version.  The bodies without a generator (noprng,
storeonly, store2d) are held exactly against the experiment's Pallas bodies
run in interpret mode; the Philox bodies against Philox4x32-10 known
answers computed here on Python ints, and against the stream statistics of
uniform noise (test_torch_fused_filter.py).  The CUDA kernel is checked
against these plain versions bit for bit on the card by chip_smoke.py."""

import numpy as np
import pytest
import torch

from torch_parity import load_experiment, np_of, pallas_interpret  # noqa: I001

from pods_digital_filter_tpu_torch.ops import noise_probe as npr
from pods_digital_filter_tpu_torch.ops import philox

SQRT3 = float(np.sqrt(3.0))
S16 = np.float32(2.0 * SQRT3 / 65536.0)


@pytest.fixture(scope="module")
def exp():
    return load_experiment("exp_two_kernel_pipeline")


def _philox_int(ctr, key):
    """Philox4x32-10 on Python ints (Salmon et al., SC'11)."""
    c = list(ctr)
    k0, k1 = key
    m = 0xFFFFFFFF
    for _ in range(10):
        p0, p1 = 0xD2511F53 * c[0], 0xCD9E8D57 * c[2]
        c = [(p1 >> 32) ^ c[1] ^ k0, p1 & m, (p0 >> 32) ^ c[3] ^ k1, p0 & m]
        k0, k1 = (k0 + 0x9E3779B9) & m, (k1 + 0xBB67AE85) & m
    return c


def _i16(h):
    h &= 0xFFFF
    return h - 0x10000 if h >= 0x8000 else h


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("body", ["noprng", "storeonly"])
def test_generator_free_bodies_match_pallas(exp, body, dtype):
    """noprng and storeonly equal the TPU bodies exactly (interpret mode)."""
    import jax.numpy as jnp

    total, jn, kn = 6, 8, 20
    fn = {"noprng": exp._noise_body_noprng,
          "storeonly": exp._noise_body_store_only}[body]
    want = pallas_interpret(
        fn, (total,), ["smem"], ((1, jn, kn), lambda i: (i, 0, 0)),
        (total, jn, kn), getattr(jnp, dtype),
        jnp.asarray([[1, 0, total // 3]], jnp.int32))
    got = npr.probe(body, 1, 0, total // 3, jn, kn, 3, getattr(torch, dtype))
    np.testing.assert_array_equal(np_of(got.float()), want.astype(np.float32))


def test_store2d_matches_pallas(exp):
    import jax.numpy as jnp

    total, jma, kma = 6, 8, 300
    want = pallas_interpret(
        exp._store2d_body, (total,), ["smem"], ((jma, kma), lambda i: (0, i)),
        (jma, total * kma), jnp.float32,
        jnp.asarray([[3, 0, 2]], jnp.int32))
    got = npr.store2d(2, jma, kma, 3)
    np.testing.assert_array_equal(np_of(got), want)
    # the experiment's epilogue on both
    np.testing.assert_array_equal(np_of(got[:, ::257] * 3), want[:, ::257] * 3)


def test_noise_body_known_answers():
    """The production 16-bit draw: word (j, m) of slab (comp, t0+s) is word
    m&3 of Philox((m>>2, j, t0+s, comp), seed); lo half at column m, hi half
    at column m + kn/2."""
    seed, t0, slabs, jn, kn = (5 << 32) | 77, 3, 2, 5, 18
    x = np_of(npr.probe("noise", seed, t0, slabs, jn, kn, 2, torch.float32))
    for cs, j, m in ((0, 0, 0), (3, 4, 8), (1, 2, 5)):
        w = _philox_int((m >> 2, j, t0 + cs % slabs, cs // slabs), (77, 5))[m & 3]
        assert x[cs, j, m] == np.float32((w & 0xFFFF) - 32768) * S16
        assert x[cs, j, m + kn // 2] == np.float32(_i16(w >> 16)) * S16


def test_interleaved_bodies_known_answers():
    """noise16b and noisemin: word (r, k) gives int16 halves at rows 2r and
    2r+1; noisemin keeps the int16 value, unscaled."""
    seed, t0, jn, kn = 11, 0, 6, 7
    x = np_of(npr.probe("noise16b", seed, t0, 2, jn, kn, 1, torch.float32))
    y = np_of(npr.probe("noisemin", seed, t0, 2, jn, kn, 1, torch.float32))
    for cs, r, k in ((0, 0, 0), (1, 2, 6), (0, 1, 3)):
        w = _philox_int((k >> 2, r, t0 + cs, 0), (11, 0))[k & 3]
        assert x[cs, 2 * r, k] == np.float32(_i16(w)) * S16
        assert x[cs, 2 * r + 1, k] == np.float32(_i16(w >> 16)) * S16
        assert (y[cs, 2 * r, k], y[cs, 2 * r + 1, k]) == (_i16(w), _i16(w >> 16))


def test_one_seed_body_known_answers():
    """noise1seed: counter (f >> 2, 0, 0, 0), word f & 3, for the flat word
    index f over (C*S, jn, kn/2)."""
    seed, jn, kn = 9, 3, 10
    x = np_of(npr.probe("noise1seed", seed, 4, 2, jn, kn, 2, torch.float32))
    half = kn // 2
    for cs, j, m in ((0, 0, 0), (3, 2, 4), (2, 1, 3)):
        f = (cs * jn + j) * half + m
        w = _philox_int((f >> 2, 0, 0, 0), (9, 0))[f & 3]
        assert x[cs, j, m] == np.float32((w & 0xFFFF) - 32768) * S16
        assert x[cs, j, m + half] == np.float32(_i16(w >> 16)) * S16


def test_batched_body_known_answers():
    """batched: group g of component c has key (seed + (c*2^22 + t0 + g) *
    0x9E3779B9, seed >> 32) and counter (m>>2, j, slab in group, 0)."""
    seed, t0, slabs, jn, kn, G = 21, 2, 8, 3, 8, 4
    x = np_of(npr.probe("batched", seed, t0, slabs, jn, kn, 3, torch.float32,
                        group=G))
    per_comp = 3 * slabs // G // 3
    for cs, j, m in ((0, 0, 0), (13, 2, 3), (23, 1, 2)):
        gi, q = divmod(cs, G)
        stream = (gi // per_comp) * (1 << 22) + t0 + gi % per_comp
        key0 = (21 + stream * 0x9E3779B9) & 0xFFFFFFFF
        w = _philox_int((m >> 2, j, q, 0), (key0, 0))[m & 3]
        assert x[cs, j, m] == np.float32((w & 0xFFFF) - 32768) * S16
        assert x[cs, j, m + kn // 2] == np.float32(_i16(w >> 16)) * S16


@pytest.mark.parametrize("body", ["noise", "noise16b", "noise1seed",
                                  "noisemin", "batched"])
def test_philox_bodies_statistics(body):
    """About 0.5 M samples: mean, variance and fourth moment of uniform
    noise on +/-sqrt3 (after the 2sqrt3/65536 scale for noisemin) and
    vanishing lag-1 correlations along k, j and slab."""
    x = np_of(npr.probe(body, 7, 0, 8, 256, 256, 1, torch.float32))
    if body == "noisemin":
        x = x * S16
    x = x.astype(np.float64)
    n, flat = x.size, x.reshape(-1)
    var = flat.var()
    assert abs(flat.mean()) < 5.0 / np.sqrt(n)
    assert abs(var - 1.0) < 0.01
    assert abs((flat ** 4).mean() - 9.0 / 5.0) < 0.02
    for rho in (np.mean(x[:, :, :-1] * x[:, :, 1:]) / var,
                np.mean(x[:, :-1, :] * x[:, 1:, :]) / var,
                np.mean(x[:-1] * x[1:]) / var):
        assert abs(rho) < 5.0 / np.sqrt(n)
    assert flat.min() >= -SQRT3 - 1e-5 and flat.max() <= SQRT3 + 1e-5


@pytest.mark.parametrize("body", npr.BODIES)
def test_bf16_output_is_rounded_f32(body):
    """The bf16 output is the f32 value rounded to nearest even."""
    kw = dict(seed=(2 << 32) | 3, t0=1, num_slabs=4, jn=6, kn=12,
              num_components=3)
    f32 = npr.probe(body, dtype=torch.float32, **kw)
    bf = npr.probe(body, dtype=torch.bfloat16, **kw)
    assert bf.dtype == torch.bfloat16
    assert torch.equal(bf, f32.to(torch.bfloat16))


def test_plain_words_match_philox_module():
    """The probes' word helper is :mod:`philox` itself (one element)."""
    words = npr._words((1, 1), torch.tensor([[3]]), torch.tensor([[4]]), 5, 6,
                       7, 8).reshape(-1)
    assert [int(w) for w in words] == _philox_int((3, 4, 5, 6), (7, 8))
    assert philox.MASK32 == 0xFFFFFFFF


def test_cpu_path_does_not_launch_and_validates():
    before = npr.LAUNCHES
    npr.probe("noise", 0, 0, 1, 4, 4, 1)
    npr.store2d(1, 4, 4, 1)
    assert npr.LAUNCHES == before
    with pytest.raises(ValueError, match="unknown body"):
        npr.probe("noise32", 0, 0, 1, 4, 4, 1)
    with pytest.raises(ValueError, match="must be even"):
        npr.probe("noise", 0, 0, 1, 4, 5, 1)
    with pytest.raises(ValueError, match="must be even"):
        npr.probe("noise16b", 0, 0, 1, 5, 4, 1)
    with pytest.raises(ValueError, match="groups of 4"):
        npr.probe("batched", 0, 0, 3, 4, 4, 1)
    with pytest.raises(ValueError, match="unsupported device"):
        npr.probe("noise", 0, 0, 1, 4, 4, 1, device="meta")
    with pytest.raises(ValueError, match="at most 2"):
        npr.probe("storeonly", 0, 0, 2 ** 12, 2 ** 10, 2 ** 10, 1, device="meta")
    with pytest.raises(ValueError, match="at most 2"):
        npr.store2d(2 ** 12, 2 ** 10, 2 ** 10, 1, device="meta")
