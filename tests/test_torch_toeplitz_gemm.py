"""K2, the two filter products on given noise (ops/toeplitz_gemm.py), on the
CPU where the wrapper takes its plain version: against the experiment's
Pallas body ``_kernel_gemms`` (benchmarks/exp_two_kernel_pipeline.py:59-63)
run in interpret mode on the same inputs, for banded and general dense
matrices, f32 and bf16 taps, f32 and bf16 noise.  The CUDA kernel itself is
checked against the plain version on the card by chip_smoke.py."""

import math

import numpy as np
import pytest
import torch

from torch_parity import load_experiment, np_of, pallas_interpret, uniform_noise  # noqa: I001

from pods_digital_filter_tpu.ops import filters as jf
from pods_digital_filter_tpu_torch.ops import filters as tf
from pods_digital_filter_tpu_torch.ops import fused_filter as ff
from pods_digital_filter_tpu_torch.ops import toeplitz_gemm as tg


@pytest.fixture(scope="module")
def exp():
    return load_experiment("exp_two_kernel_pipeline")


def _jax_gemms(exp, noise, BzT, ByM):
    total, jn, kn = noise.shape
    jma, kma = ByM.shape[0], BzT.shape[1]
    return pallas_interpret(
        exp._kernel_gemms, (total,),
        [((1, jn, kn), lambda i: (i, 0, 0)), ((kn, kma), lambda i: (0, 0)),
         ((jma, jn), lambda i: (0, 0))],
        ((1, jma, kma), lambda i: (i, 0, 0)), (total, jma, kma), np.float32,
        noise, BzT, ByM)


def _bf16_bound(noise, BzT, ByM):
    """Two correct bf16-tap products may round an element of t to
    neighbouring bf16 values (their f32 sums differ in the last bits): one
    bf16 ulp at the largest |t|, spread by the largest row sum of |ByM|;
    plus f32 slack for the second product."""
    f = lambda a: torch.as_tensor(np.asarray(a, np.float32))
    t = torch.matmul(f(noise).to(torch.bfloat16).float(),
                     f(BzT).to(torch.bfloat16).float())
    ulp = 2.0 ** (math.floor(math.log2(float(t.abs().max()))) - 7)
    rows = float(f(ByM).to(torch.bfloat16).float().abs().sum(1).max())
    return ulp * rows + 1e-5 * (1.0 + float(t.abs().max()) * rows)


@pytest.mark.parametrize("kind", ["band", "dense"])
@pytest.mark.parametrize("noise_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("tap_dtype", ["float32", "bfloat16"])
def test_matches_kernel_gemms(exp, kind, noise_dtype, tap_dtype):
    """Same numbers on both sides: float32 numpy inputs, cast to each
    side's dtype (both round to nearest even).  f32 taps: atol 2e-5
    (rtol 1e-5 for the dense matrices' larger values); bf16 taps: the bound
    of ``_bf16_bound``, 0.021 for the band and 1.2 for the dense matrices
    (whose |t| reaches 20); measured under 2e-6 for both."""
    import jax.numpy as jnp

    rng = np.random.default_rng(5)
    total, jma, kma, nf = 4, 12, 10, 2
    jn, kn = jma + 2 * nf, kma + 2 * nf
    noise = uniform_noise(rng, (total, jn, kn), np.float32)
    if kind == "band":
        b = np.asarray(jf.gaussian_fir_coeffs(nf, 1.0, jnp.float32))
        ByM = np.array(jf.toeplitz_band(b, jma))
        BzT = np.array(jf.toeplitz_band(b, kma)).T.copy()
    else:
        ByM = rng.standard_normal((jma, jn)).astype(np.float32)
        BzT = rng.standard_normal((kn, kma)).astype(np.float32)
    jt = getattr(jnp, tap_dtype)
    want = _jax_gemms(exp, jnp.asarray(noise, getattr(jnp, noise_dtype)),
                      jnp.asarray(BzT, jt), jnp.asarray(ByM, jt))
    tt = getattr(torch, tap_dtype)
    got = tg.toeplitz_gemm(torch.as_tensor(noise).to(getattr(torch, noise_dtype)),
                           torch.as_tensor(BzT).to(tt), torch.as_tensor(ByM).to(tt))
    assert got.dtype == torch.float32 and want.dtype == np.float32
    assert got.shape == (total, jma, kma)
    if tap_dtype == "float32":
        np.testing.assert_allclose(np_of(got), want, rtol=1e-5, atol=2e-5)
    else:
        bound = _bf16_bound(noise, BzT, ByM)
        np.testing.assert_allclose(np_of(got), want, rtol=0, atol=bound)


def test_bf16_taps_differ_from_f32_taps(exp):
    """The casts are real: with bf16 taps the result is not the f32 one."""
    rng = np.random.default_rng(6)
    noise = torch.as_tensor(uniform_noise(rng, (2, 12, 12), np.float32))
    b = tf.gaussian_fir_coeffs(2, 1.0)
    ByM, BzT = tf.toeplitz_band(b, 8), tf.toeplitz_band(b, 8).T
    f32 = tg.toeplitz_gemm(noise, BzT, ByM)
    bf = tg.toeplitz_gemm(noise, BzT.to(torch.bfloat16), ByM.to(torch.bfloat16))
    assert float((f32 - bf).abs().max()) > 1e-3


def test_banded_matches_k1_noise_in():
    """On a Toeplitz band, K2 computes K1's noise-in filter: bit for bit
    in f32 on the CPU (both are the same two products there), within the
    bf16-tap bound with bf16 taps."""
    rng = np.random.default_rng(7)
    nf, jma, kma, slabs = 3, 14, 9, 5
    b = tf.gaussian_fir_coeffs(nf, 1.5)
    noise = torch.as_tensor(uniform_noise(
        rng, (1, slabs, jma + 2 * nf, kma + 2 * nf), np.float32))
    for md in (torch.float32, torch.bfloat16):
        k1 = ff.fused_spatial(0, 0, slabs, jma, kma, b, b, 1, noise=noise,
                              matmul_dtype=md)[0]
        k2 = tg.toeplitz_gemm(noise[0], tf.toeplitz_band(b, kma).T.to(md),
                              tf.toeplitz_band(b, jma).to(md))
        np.testing.assert_allclose(np_of(k2), np_of(k1), rtol=0,
                                   atol=0 if md == torch.float32
                                   else ff.bf16_tap_bound(b, b))


def test_cpu_path_does_not_launch():
    before = tg.LAUNCHES
    x = torch.zeros(1, 6, 6)
    tg.toeplitz_gemm(x, torch.eye(6)[:, :4], torch.eye(6)[:3])
    assert tg.LAUNCHES == before


def test_wrapper_validates_inputs():
    x = torch.zeros(2, 6, 7)
    with pytest.raises(ValueError, match="do not chain"):
        tg.toeplitz_gemm(x, torch.zeros(6, 3), torch.zeros(4, 6))
    with pytest.raises(ValueError, match="share a dtype"):
        tg.toeplitz_gemm(x, torch.zeros(7, 3), torch.zeros(4, 6).to(torch.bfloat16))
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tg.toeplitz_gemm(x.double(), torch.zeros(7, 3), torch.zeros(4, 6))
    with pytest.raises(ValueError, match="several devices"):
        tg.toeplitz_gemm(x, torch.zeros(7, 3), torch.zeros(4, 6, device="meta"))
    with pytest.raises(ValueError, match="expected"):
        tg.toeplitz_gemm(x[0], torch.zeros(7, 3), torch.zeros(4, 6))
