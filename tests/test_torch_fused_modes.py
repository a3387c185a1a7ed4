"""K1's modes beyond the main path's (ops/fused_filter.py) on the CPU, where
the wrapper takes the plain versions: bf16 taps against the Pallas kernel
with bf16 tap matrices, the iota source against the experiment's
``_fused_body_noprng``, both in interpret mode; the dummy-in and
slab-pipelined modes' plain versions; the raw field in bf16.  The CUDA
kernel's modes are checked against these plain versions on the card by
chip_smoke.py (the pipelined mode against K1 bit for bit)."""

import math

import numpy as np
import pytest
import torch

from torch_parity import load_experiment, np_of, pallas_interpret  # noqa: I001

from pods_digital_filter_tpu.ops import filters as jf
from pods_digital_filter_tpu.ops import pallas_filter as pf
from pods_digital_filter_tpu_torch.ops import filters as tf
from pods_digital_filter_tpu_torch.ops import fused_filter as ff
from pods_digital_filter_tpu_torch.ops import philox

SQRT3 = float(np.sqrt(3.0))


@pytest.fixture(scope="module")
def exp():
    return load_experiment("exp_two_kernel_pipeline")


def _bands(nf, ln, jma, kma, dtype):
    import jax.numpy as jnp

    b = jf.gaussian_fir_coeffs(nf, ln, jnp.float32)
    return (jf.toeplitz_band(b, kma).T.astype(dtype),
            jf.toeplitz_band(b, jma).astype(dtype))


@pytest.mark.parametrize("seed,t0,slabs,jma,kma,nf,ln", [
    (3, 5, 6, 24, 16, 2, 1.0), (1, 0, 4, 40, 72, 8, 4.0),
    (2, 1, 3, 33, 20, 3, 1.5)])
def test_bf16_taps_match_pallas_kernel(seed, t0, slabs, jma, kma, nf, ln):
    """``matmul_dtype=bfloat16`` against ``pf._fused_spatial`` in interpret
    mode with bf16 ``BzT``/``ByM``, on the Threefry noise that path draws
    (rebuilt as test_torch_fused_filter.py does).  Both round the noise and
    t to bf16; they sum t in other orders, so an element of t may round to
    its neighbour: ``ff.bf16_tap_bound`` (one bf16 ulp of the largest |t|
    times sum(by), 0.021-0.088 here).  Measured: at most 4.8e-7.  With f32
    taps the same comparison is off by more than 0.01."""
    import jax
    import jax.numpy as jnp

    jn, kn = jma + 2 * nf, kma + 2 * nf
    BzT, ByM = _bands(nf, ln, jma, kma, jnp.bfloat16)
    want = np.asarray(pf._fused_spatial(
        jnp.asarray([[seed, t0, slabs]], jnp.int32), BzT, ByM,
        num_slabs=slabs, jma=jma, kma=kma, num_components=3, interpret=True))
    key = jax.random.fold_in(jax.random.key(seed), t0)
    raw = torch.as_tensor(np.array(jax.random.uniform(
        key, (3 * slabs, jn, kn), jnp.float32, -SQRT3, SQRT3)
    ).reshape(3, slabs, jn, kn))
    b = tf.gaussian_fir_coeffs(nf, ln)
    got = ff.fused_spatial(seed, t0, slabs, jma, kma, b, b, 3, noise=raw,
                           matmul_dtype=torch.bfloat16)
    bound = ff.bf16_tap_bound(b, b)
    np.testing.assert_allclose(np_of(got), want, rtol=0, atol=bound)
    f32 = ff.fused_spatial(seed, t0, slabs, jma, kma, b, b, 3, noise=raw)
    assert np.abs(np_of(f32) - want).max() > 0.01


def test_bf16_plain_rounds_noise_and_t():
    """The plain bf16-tap filter is the two products on bf16-rounded noise
    and taps, with t rounded to bf16 in between (pallas_filter.py:87-90)."""
    rng = np.random.default_rng(3)
    b = tf.gaussian_fir_coeffs(2, 1.0)
    x = torch.as_tensor(rng.uniform(-SQRT3, SQRT3, (2, 9, 10)).astype(np.float32))
    r = lambda a: a.to(torch.bfloat16).float()
    t = r(r(x) @ tf.toeplitz_band(r(b), 6).T)
    want = tf.toeplitz_band(r(b), 5) @ t
    got = ff.filter_taps(x, b, b, 5, 6, torch.bfloat16)
    assert torch.equal(got, want)
    assert torch.equal(ff.filter_taps(x, b, b, 5, 6),
                       tf.filter_spatial(x, b, b, 5, 6))


@pytest.mark.parametrize("matmul_dtype", ["float32", "bfloat16"])
def test_iota_matches_fused_body_noprng(exp, matmul_dtype):
    """The iota source against ``_fused_body_noprng`` in interpret mode,
    launch index ``cs = comp * S + slab``.  f32: atol 1e-6 (|out| < 0.05);
    bf16: ``ff.bf16_tap_bound`` with the iota's largest value in place of
    sqrt(3)."""
    import jax.numpy as jnp

    slabs, jma, kma, nf, ln = 4, 12, 20, 2, 1.0
    jn, kn = jma + 2 * nf, kma + 2 * nf
    total = 3 * slabs
    BzT, ByM = _bands(nf, ln, jma, kma, getattr(jnp, matmul_dtype))
    want = pallas_interpret(
        exp._fused_body_noprng, (total,),
        ["smem", ((kn, kma), lambda i: (0, 0)), ((jma, jn), lambda i: (0, 0))],
        ((1, jma, kma), lambda i: (i, 0, 0)), (total, jma, kma), jnp.float32,
        jnp.asarray([[1, 0, slabs]], jnp.int32), BzT, ByM)
    b = tf.gaussian_fir_coeffs(nf, ln)
    got = ff.fused_spatial_iota(slabs, jma, kma, b, b, 3,
                                getattr(torch, matmul_dtype))
    assert got.shape == (3, slabs, jma, kma)
    xmax = (kn - 1) * total * ff.IOTA_SCALE
    atol = 1e-6 if matmul_dtype == "float32" else ff.bf16_tap_bound(b, b, xmax)
    np.testing.assert_allclose(np_of(got).reshape(total, jma, kma), want,
                               rtol=0, atol=atol)


def test_iota_field_is_the_original_source():
    x = np_of(ff.iota_field(2, 3, 5, 2))
    k = np.arange(5, dtype=np.int32)
    for cs in range(4):
        want = (k * np.int32(cs + 1)).astype(np.float32) * np.float32(
            2.0 * SQRT3 / 65536.0)
        np.testing.assert_array_equal(x[cs // 2, cs % 2], np.broadcast_to(want, (3, 5)))


@pytest.mark.parametrize("matmul_dtype", [torch.float32, torch.bfloat16])
def test_dummy_in_adds_the_dummy_block(matmul_dtype):
    """out = K1's slab with dummy[cs] added to its [:8, :128] corner (the
    experiment's ``out_ref[0, :8, :128] += dummy_ref[0]``)."""
    b = tf.gaussian_fir_coeffs(2, 1.0)
    slabs, jma, kma = 2, 10, 130
    dummy = torch.as_tensor(np.random.default_rng(2).standard_normal(
        (3 * slabs, 8, 128)).astype(np.float32))
    got = ff.fused_spatial_dummy_in(4, 1, slabs, jma, kma, b, b, dummy, 3,
                                    matmul_dtype)
    base = ff.fused_spatial(4, 1, slabs, jma, kma, b, b, 3,
                            matmul_dtype=matmul_dtype)
    want = base.clone()
    want[:, :, :8, :128] += dummy.view(3, slabs, 8, 128)
    assert torch.equal(got, want)
    assert torch.equal(got[:, :, 8:], base[:, :, 8:])
    assert torch.equal(got[:, :, :, 128:], base[:, :, :, 128:])


def test_dummy_in_refuses_small_planes():
    b = tf.gaussian_fir_coeffs(2, 1.0)
    with pytest.raises(ValueError, match="kma >= 128"):
        ff.fused_spatial_dummy_in(0, 0, 1, 8, 64, b, b, torch.zeros(3, 8, 128))
    with pytest.raises(ValueError, match="dummy shape"):
        ff.fused_spatial_dummy_in(0, 0, 1, 8, 128, b, b, torch.zeros(1, 8, 128))


@pytest.mark.parametrize("matmul_dtype", [torch.float32, torch.bfloat16])
def test_pipelined_plain_is_fused_spatial(matmul_dtype):
    """The slab-pipelined mode computes K1's default mode (its plain version
    is K1's; on the card the two kernels agree bit for bit)."""
    b = tf.gaussian_fir_coeffs(3, 1.5)
    got = ff.fused_spatial_pipelined(9, 2, 5, 11, 13, b, b, 2, matmul_dtype)
    want = ff.fused_spatial(9, 2, 5, 11, 13, b, b, 2, matmul_dtype=matmul_dtype)
    assert torch.equal(got, want)


def test_raw_noise_bf16_is_rounded_stream():
    f32 = ff.raw_noise(5, 2, 3, 7, 9, 2)
    bf = ff.raw_noise(5, 2, 3, 7, 9, 2, dtype=torch.bfloat16)
    assert bf.dtype == torch.bfloat16
    assert torch.equal(bf, philox.raw_noise(5, 2, 3, 7, 9, 2).to(torch.bfloat16))
    assert torch.equal(bf, f32.to(torch.bfloat16))


def test_bf16_tap_bound_is_one_ulp_of_t():
    """The bound's arithmetic: bf16 ulp at sqrt(3) * sum(bz), times sum(by)."""
    b = tf.gaussian_fir_coeffs(8, 4.0)
    s = float(b.to(torch.bfloat16).float().sum())
    ulp = 2.0 ** (math.floor(math.log2(1.734375 * s)) - 7)
    assert ff.bf16_tap_bound(b, b) == pytest.approx(ulp * s + 1e-5)


def test_modes_validate_matmul_dtype():
    b = tf.gaussian_fir_coeffs(2, 1.0)
    for call in (lambda: ff.fused_spatial(0, 0, 1, 8, 8, b, b, 1,
                                          matmul_dtype=torch.float16),
                 lambda: ff.fused_spatial_iota(1, 8, 8, b, b, 1, torch.float64),
                 lambda: ff.raw_noise(0, 0, 1, 4, 4, dtype=torch.float16)):
        with pytest.raises(ValueError, match="float32 or bfloat16"):
            call()


def test_generate_fused_bf16_matches_pallas_generator():
    """``generate_correlated_noise_fused(matmul_dtype=bfloat16)`` against the
    JAX generator with the same ``matmul_dtype`` (interpret mode, its
    Threefry draw rebuilt): the bf16-tap filter, then the f32 temporal FIR,
    output in bf16.  Tolerance: one bf16 ulp of the largest output (|y| < 4
    here, so 2^-6) in at most 1 % of the elements, as in the generator test
    of test_torch_pipeline.py.  Measured: no element differs; with f32 taps
    59 % of them do."""
    import jax
    import jax.numpy as jnp

    seed, t0, nsteps, jma, kma, nf, ln = 4, 2, 6, 20, 12, 2, 1.0
    want = np.asarray(pf.generate_correlated_noise_fused(
        seed, t0, nsteps, jma, kma, nf, nf, nf, ln, ln, ln, num_components=3,
        dtype=jnp.bfloat16, interpret=True, matmul_dtype=jnp.bfloat16)
    ).astype(np.float32)
    num_slabs = nsteps + 2 * nf
    key = jax.random.fold_in(jax.random.key(seed), t0)
    raw = np.array(jax.random.uniform(
        key, (3 * num_slabs, jma + 2 * nf, kma + 2 * nf), jnp.float32,
        -SQRT3, SQRT3)).reshape(3, num_slabs, jma + 2 * nf, kma + 2 * nf)
    got = ff.generate_correlated_noise_fused(
        seed, t0, nsteps, jma, kma, nf, nf, nf, ln, ln, ln,
        dtype=torch.bfloat16, noise=torch.as_tensor(raw),
        matmul_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert np.abs(want).max() < 4.0
    np.testing.assert_allclose(np_of(got.float()), want, rtol=0, atol=2.0 ** -6)
    assert np.mean(np_of(got.float()) != want) <= 0.01
