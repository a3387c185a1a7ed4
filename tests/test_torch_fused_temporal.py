"""K4, fused noise + spatial filter + temporal FIR (ops/fused_temporal.py),
on the CPU where the wrapper takes its plain version.  The noise-in mode is
held against the experiment's own reference for its Pallas kernel
(benchmarks/exp_two_kernel_pipeline.py:685-697: the fused spatial kernel,
then ``filters.filter_temporal``), run in interpret mode on the Threefry
noise that path draws, rebuilt here.  The CUDA kernel is checked against
the plain version on the card by chip_smoke.py."""

import numpy as np
import pytest
import torch

from torch_parity import np_of  # noqa: I001

from pods_digital_filter_tpu.ops import filters as jf
from pods_digital_filter_tpu.ops import pallas_filter as pf
from pods_digital_filter_tpu_torch.ops import filters as tf
from pods_digital_filter_tpu_torch.ops import fused_filter as ff
from pods_digital_filter_tpu_torch.ops import fused_temporal as ft

SQRT3 = float(np.sqrt(3.0))


@pytest.mark.parametrize("matmul_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("seed,t0,nsteps,jma,kma,nf,ln", [
    (3, 5, 8, 24, 16, 2, 1.0), (1, 0, 6, 20, 36, 3, 1.5)])
def test_noise_in_matches_experiment_reference(seed, t0, nsteps, jma, kma,
                                               nf, ln, matmul_dtype):
    """f32 taps: atol 2e-5 (float32 sums in other orders).  bf16 taps: an
    element of t may round to its neighbouring bf16 value in either
    version, so a filtered slab may differ by ``ff.bf16_tap_bound`` and the
    output by that times sum(bx).  Measured: at most 7.2e-7 (f32) and
    4.8e-7 (bf16)."""
    import jax
    import jax.numpy as jnp

    num_slabs = nsteps + 2 * nf
    jn, kn = jma + 2 * nf, kma + 2 * nf
    b = jf.gaussian_fir_coeffs(nf, ln, jnp.float32)
    md = getattr(jnp, matmul_dtype)
    seed_arr = jnp.asarray([[seed, t0, num_slabs]], jnp.int32)
    z = pf._fused_spatial(seed_arr, jf.toeplitz_band(b, kma).T.astype(md),
                          jf.toeplitz_band(b, jma).astype(md),
                          num_slabs=num_slabs, jma=jma, kma=kma,
                          num_components=3, interpret=True)
    want = np.asarray(jf.filter_temporal(z, b, axis=-3))
    key = jax.random.fold_in(jax.random.key(seed), t0)
    raw = np.array(jax.random.uniform(
        key, (3 * num_slabs, jn, kn), jnp.float32, -SQRT3, SQRT3)
    ).reshape(3, num_slabs, jn, kn)
    tb = tf.gaussian_fir_coeffs(nf, ln)
    got = ft.fused_temporal(seed, t0, nsteps, jma, kma, tb, tb, tb, 3,
                            noise=torch.as_tensor(raw),
                            matmul_dtype=getattr(torch, matmul_dtype))
    assert got.shape == (3, nsteps, jma, kma) == want.shape
    assert got.dtype == torch.float32 and want.dtype == np.float32
    atol = 2e-5 if matmul_dtype == "float32" else \
        ff.bf16_tap_bound(tb, tb) * float(tb.abs().sum())
    np.testing.assert_allclose(np_of(got), want, rtol=0, atol=atol)


def test_philox_mode_is_generate_correlated_noise_fused():
    """The Philox mode's plain version is the port's fused generator."""
    nf, ln = 2, 1.0
    b = tf.gaussian_fir_coeffs(nf, ln)
    got = ft.fused_temporal(7, 3, 10, 12, 8, b, b, b, 2)
    want = ff.generate_correlated_noise_fused(7, 3, 10, 12, 8, nf, nf, nf, ln,
                                              ln, ln, num_components=2)
    assert torch.equal(got, want)


def test_separate_taps_and_windows():
    """Different x, y and z taps land on their own axes, and a window
    [4, 10) equals the slice of [0, 10)."""
    bx, by, bz = (tf.gaussian_fir_coeffs(n, ln) for n, ln in
                  ((1, 0.8), (2, 1.0), (3, 1.5)))
    full = ft.fused_temporal(5, 0, 10, 9, 11, bx, by, bz, 1)
    part = ft.fused_temporal(5, 4, 6, 9, 11, bx, by, bz, 1)
    np.testing.assert_allclose(np_of(part), np_of(full[:, 4:]), atol=1e-6)
    z = ff.fused_spatial(5, 0, 12, 9, 11, by, bz, 1)
    np.testing.assert_allclose(np_of(full),
                               np_of(tf.filter_temporal(z, bx, axis=-3)),
                               atol=0)


def test_wrapper_validates_inputs():
    b = tf.gaussian_fir_coeffs(2, 1.0)
    before = ft.LAUNCHES
    with pytest.raises(ValueError, match="noise shape"):
        ft.fused_temporal(0, 0, 4, 8, 8, b, b, b, 1,
                          noise=torch.zeros(1, 4, 12, 12))
    with pytest.raises(ValueError, match="several devices"):
        ft.fused_temporal(0, 0, 4, 8, 8, b, b, b.to("meta"), 1)
    with pytest.raises(ValueError, match="matmul_dtype"):
        ft.fused_temporal(0, 0, 4, 8, 8, b, b, b, 1,
                          matmul_dtype=torch.float16)
    assert ft.LAUNCHES == before
