"""The port's time-axis operations (pods_digital_filter_tpu_torch/parallel/
time_ops.py), held to the JAX package's on the same numpy inputs.

Mirrors tests/test_time_ops.py (7; its sharded case becomes the parity
case: the port runs on one device).  Parity: float64 on both sides
(conftest turns on jax x64), within 1e-12 of the field's scale.
"""

import numpy as np
import pytest
import torch

from torch_parity import np_of  # noqa: I001

from pods_digital_filter_tpu.parallel import time_ops as jto
from pods_digital_filter_tpu_torch.parallel import time_ops as to

CPU = dict(device="cpu")


def test_temporal_interpolate_exact_at_samples():
    time_vec = np.arange(5) * 0.5
    A = np.random.RandomState(0).randn(7, 5)
    out = to.temporal_interpolate(A, time_vec, time_vec, **CPU)
    np.testing.assert_allclose(np_of(out), A, atol=1e-12)


def test_temporal_interpolate_midpoint_and_clamp():
    time_vec = np.asarray([0.0, 1.0, 2.0])
    A = np.asarray([[0.0, 2.0, 4.0]])
    out = to.temporal_interpolate(A, time_vec, np.asarray([0.5, 1.5, -1.0, 9.0]),
                                  **CPU)
    np.testing.assert_allclose(np_of(out)[0], [1.0, 3.0, 0.0, 4.0], atol=1e-12)
    # a scalar query gives one column
    assert to.temporal_interpolate(A, time_vec, 0.5, **CPU).shape == (1,)


def _reference_phase_average_numpy(B, time_vec, phase_freq, num_phase):
    """Sequential numpy oracle of the vectorized bin sums."""
    dt_phase = 1.0 / phase_freq / num_phase
    sums = np.zeros((B.shape[0], num_phase))
    counts = np.zeros(num_phase)
    t, q = 0.0, 0
    while t <= time_vec[-1] + 1e-12:
        i = min(np.searchsorted(time_vec, t, side="right"), len(time_vec) - 1)
        i = max(i, 1)
        w2 = np.clip((t - time_vec[i - 1]) / (time_vec[i] - time_vec[i - 1]),
                     0.0, 1.0)
        col = (1 - w2) * B[:, i - 1] + w2 * B[:, i]
        b = q % num_phase
        sums[:, b] += col
        counts[b] += 1
        q += 1
        t = q * dt_phase
    return sums / np.maximum(counts, 1.0), counts


def test_phase_average_matches_sequential_oracle():
    rng = np.random.RandomState(1)
    npts, ns = 4, 24
    time_vec = np.arange(ns) * 0.1
    B = rng.randn(3 * npts, ns)
    res = to.phase_average(B, time_vec, 2.5, npts, **CPU)
    assert res.v_phase.shape == (3 * npts, 4)
    v_ref, counts_ref = _reference_phase_average_numpy(B, time_vec, 2.5, 4)
    np.testing.assert_allclose(np_of(res.v_phase), v_ref, atol=1e-10)
    np.testing.assert_allclose(np_of(res.phase_counts), counts_ref)


def test_phase_average_periodic_signal_recovered():
    """A purely periodic signal phase-averages to itself and leaves ~zero
    fluctuation (the quantity the reference subtracts, 656-658)."""
    npts, nper, cycles = 3, 8, 6
    ns = nper * cycles
    dt = 0.05
    period = nper * dt
    t = np.arange(ns) * dt
    B = np.outer(np.arange(1, 3 * npts + 1), np.sin(2 * np.pi * t / period))
    res = to.phase_average(B, t, 1.0 / period, npts, num_phase=nper, **CPU)
    np.testing.assert_allclose(np_of(res.B_fluct), 0.0, atol=1e-8)
    np.testing.assert_allclose(np_of(res.nrs), 0.0, atol=1e-12)


def test_cross_stress_layout():
    """crs rows are [u*v; w*v; u*w] (nsigproclib_no_mpi.py:765-768)."""
    npts, ns = 2, 6
    B = np.random.RandomState(3).randn(3 * npts, ns)
    res = to.phase_average(B, np.arange(ns) * 0.1, 10.0 / 6.0, npts,
                           num_phase=3, **CPU)
    Bf = np_of(res.B_fluct)
    u, v, w = Bf[:npts], Bf[npts:2 * npts], Bf[2 * npts:]
    np.testing.assert_allclose(np_of(res.crs[:npts]), (u * v).mean(axis=1),
                               atol=1e-12)
    np.testing.assert_allclose(np_of(res.crs[2 * npts:]), (u * w).mean(axis=1),
                               atol=1e-12)


@pytest.mark.parametrize("num_phase", [None, 5])
def test_phase_average_matches_jax(num_phase):
    """Every field of the result, scalars included, against the JAX
    package's phase_average on the same float64 input (its sharded twin
    in tests/test_time_ops.py is held to the same local result)."""
    import jax.numpy as jnp

    rng = np.random.default_rng(4)
    npts, ns, nsc = 4, 32, 2
    B = rng.standard_normal((3 * npts, ns))
    sc = rng.standard_normal((nsc, npts, ns))
    t = np.arange(ns) * 0.1
    kw = dict(scalars=sc, num_phase=num_phase)
    got = to.phase_average(B, t, 1.25, npts, device="cpu", **kw)
    want = jto.phase_average(jnp.asarray(B), jnp.asarray(t), 1.25, npts, **kw)
    np.testing.assert_array_equal(got.phase, want.phase)
    for name in ("v_phase", "nrs_phase", "crs_phase", "phase_counts",
                 "B_fluct", "rms_scalars", "nrs", "crs"):
        g, w = np_of(getattr(got, name)), np.asarray(getattr(want, name))
        assert g.shape == w.shape and g.dtype == w.dtype, name
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-12 * np.abs(w).max(),
                                   err_msg=name)


def test_phase_average_float32_and_deterministic():
    """A float32 matrix stays float32 (the weights are cast; module
    docstring), within f32 round-off of the float64 result, and the one-hot
    product gives the same bits on every call."""
    rng = np.random.default_rng(6)
    npts, ns = 5, 40
    B = rng.standard_normal((3 * npts, ns))
    t = np.arange(ns) * 0.05
    r32 = to.phase_average(B.astype(np.float32), t, 2.0, npts, **CPU)
    again = to.phase_average(B.astype(np.float32), t, 2.0, npts, **CPU)
    r64 = to.phase_average(B, t, 2.0, npts, **CPU)
    for name in ("v_phase", "B_fluct", "nrs", "crs"):
        a, b = getattr(r32, name), getattr(again, name)
        assert a.dtype == torch.float32 and torch.equal(a, b), name
        np.testing.assert_allclose(np_of(a), np_of(getattr(r64, name)),
                                   rtol=0, atol=1e-5, err_msg=name)


def test_partition_snapshots():
    assert to.partition_snapshots(10, 3) == [(0, 4), (4, 7), (7, 10)]
    assert to.partition_snapshots(9, 3) == [(0, 3), (3, 6), (6, 9)]
    for n, p in ((10, 3), (17, 4), (5, 5)):
        assert to.partition_snapshots(n, p) == jto.partition_snapshots(n, p)
    assert to.num_phase_bins(2.5, 0.1, 24) == jto.num_phase_bins(2.5, 0.1, 24)


def test_time_ops_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; the refusal needs a host without one")
    with pytest.raises(RuntimeError, match="cuda"):
        to.phase_average(np.zeros((3, 4)), np.arange(4.0), 0.5, 1)
