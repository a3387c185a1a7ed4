"""Snapshot POD of the port (pods_digital_filter_tpu_torch/ops/pod.py):
float64 parity with the JAX functions on the same numpy snapshots
(spatial and temporal modes after per-mode sign alignment), the
reference's own POD in tests/golden/ref_pod.npz, and mirrors of
tests/test_pod.py."""

import os

import numpy as np
import pytest
import torch

from torch_parity import align_signs, np_of, to_jax, to_torch  # noqa: I001
from oracle import pod_oracle

from pods_digital_filter_tpu.ops import pod as jp
from pods_digital_filter_tpu_torch.ops import pod as tp

F64 = np.float64
GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


def _toy_snapshots(rng, npts=60, ns=25, rank=6, center=True):
    """Low-rank + noise snapshot matrix (tests/test_pod.py's)."""
    U = rng.standard_normal((npts, rank))
    t = np.arange(ns)
    T = np.stack([np.sin(2 * np.pi * (i + 1) * t / ns + i) * (rank - i)
                  for i in range(rank)], axis=1)
    A = U @ T.T + 0.01 * rng.standard_normal((npts, ns)) + 3.0
    return A - A.mean(axis=1, keepdims=True) if center else A


def test_center_and_gram_matches_jax(rng):
    A = _toy_snapshots(rng, center=False)
    got = tp.center_and_gram(to_torch(A, F64))
    want = jp.center_and_gram(to_jax(A, F64))
    for g, w in zip(got, want):
        np.testing.assert_allclose(np_of(g), np.asarray(w), rtol=1e-10,
                                   atol=1e-12)


@pytest.mark.parametrize("weighted", [False, True])
def test_gram_matrix_matches_jax(rng, weighted):
    A = rng.standard_normal((6 * 4, 5))
    w = rng.uniform(0.5, 2.0, 4) if weighted else None
    got = np_of(tp.gram_matrix(to_torch(A, F64), cell_weights=w))
    want = np.asarray(jp.gram_matrix(to_jax(A, F64), cell_weights=w))
    np.testing.assert_allclose(got, want, rtol=1e-10)
    wfull = np.tile(w, 6) if weighted else np.ones(24)
    np.testing.assert_allclose(got, (A * wfull[:, None]).T @ A / 5, rtol=1e-10)


@pytest.mark.parametrize("num_modes", [6, -1])
def test_snapshot_pod_matches_jax(rng, num_modes):
    A = _toy_snapshots(rng)
    got = tp.snapshot_pod(to_torch(A, F64), num_modes)
    want = jp.snapshot_pod(to_jax(A, F64), num_modes)
    assert (got.num_valid, got.num_trunc) == (want.num_valid, want.num_trunc)
    m = got.num_trunc
    # eigenvalues are backward-stable to ~eps * ||C||: small ones get an
    # absolute bound scaled by the largest
    np.testing.assert_allclose(got.energy, want.energy, rtol=1e-10,
                               atol=1e-12 * want.energy[0])
    assert isinstance(got.spatial_modes, np.ndarray)
    np.testing.assert_allclose(
        align_signs(got.spatial_modes, np.asarray(want.spatial_modes)),
        np.asarray(want.spatial_modes), atol=1e-8)
    np.testing.assert_allclose(
        align_signs(got.temporal_modes[:, :m], want.temporal_modes[:, :m]),
        want.temporal_modes[:, :m], atol=1e-8)


def test_deferred_spatial_modes_resolve(rng):
    A = to_torch(_toy_snapshots(rng), F64)
    pr = tp.snapshot_pod(A, 4, defer_spatial=True)
    assert isinstance(pr.spatial_modes, torch.Tensor)
    tp.resolve_spatial(pr)
    assert isinstance(pr.spatial_modes, np.ndarray)
    np.testing.assert_array_equal(pr.spatial_modes,
                                  tp.snapshot_pod(A, 4).spatial_modes)


def test_pod_matches_reference_on_its_snapshots():
    """The reference's own centred snapshots -> its spectrum, truncation and
    modes (up to sign); mirror of the JAX golden test."""
    npz = np.load(os.path.join(GOLDEN, "ref_pod.npz"))
    pr = tp.snapshot_pod(to_torch(npz["A_centered"], F64), num_modes_trunc=20)
    assert pr.num_trunc == int(npz["num_modes_trunc"])
    nm = pr.num_trunc
    t_ref = npz["temporal_modes"].real
    np.testing.assert_allclose(np.abs(pr.temporal_modes[:, :nm]),
                               np.abs(t_ref[:, :nm]), atol=1e-8)
    np.testing.assert_allclose(np.abs(pr.spatial_modes),
                               np.abs(npz["spatial_modes"]), atol=1e-8)
    np.testing.assert_allclose(pr.spatial_modes @ pr.temporal_modes[:, :nm].T,
                               npz["spatial_modes"] @ t_ref[:, :nm].T,
                               atol=1e-8)
    rows = []
    with open(os.path.join(GOLDEN, "ref_run", "POD.eigenvalues.dat")) as f:
        rows = [[float(v) for v in ln.split()] for ln in f
                if not ln.startswith("#") and ln.strip()]
    e_ref = np.asarray(rows)[:, 1]
    np.testing.assert_allclose(pr.energy[:e_ref.shape[0]], e_ref, rtol=1e-8,
                               atol=1e-14)


# --- mirrors of tests/test_pod.py -------------------------------------------

def test_eigenvalue_sum_is_total_energy(rng):
    A = _toy_snapshots(rng)
    res = tp.snapshot_pod(to_torch(A, F64), num_modes_trunc=-1)
    np.testing.assert_allclose(res.energy.sum(), np.sum(A * A) / A.shape[1],
                               rtol=1e-8)


def test_spatial_modes_orthonormal(rng):
    phi = tp.snapshot_pod(to_torch(_toy_snapshots(rng), F64), 6).spatial_modes
    np.testing.assert_allclose(phi.T @ phi, np.eye(6), atol=1e-6)


def test_temporal_mode_scaling_and_reconstruction(rng):
    A = _toy_snapshots(rng)
    res = tp.snapshot_pod(to_torch(A, F64), num_modes_trunc=-1)
    ns = A.shape[1]
    for j in range(res.num_valid):
        np.testing.assert_allclose(np.sum(res.temporal_modes[:, j] ** 2) / ns,
                                   res.energy[j], rtol=1e-8)
    recon = res.spatial_modes @ res.temporal_modes[:, :res.num_trunc].T
    np.testing.assert_allclose(recon, A, atol=1e-6)


def test_oracle_parity(rng):
    A = _toy_snapshots(rng)
    res = tp.snapshot_pod(to_torch(A, F64), num_modes_trunc=6)
    lam_o, _, phi_o, _, m_o = pod_oracle(A, 6)
    np.testing.assert_allclose(res.energy[:10], lam_o[:10], rtol=1e-7,
                               atol=1e-10)
    assert res.num_trunc == m_o
    np.testing.assert_allclose(align_signs(res.spatial_modes, phi_o[:, :6]),
                               phi_o[:, :6], atol=1e-6)


def test_count_valid_modes_reference_loop():
    assert tp.count_valid_modes(np.array([1.0, 0.5, 1e-5, 1e-9, 1e-12]),
                                1e-3) == 3
    assert tp.count_valid_modes(np.ones(6), 1e-3) == 4
    assert tp.count_valid_modes(np.array([1.0, -0.1, 0.05]), 1e-3) == 1


def test_two_phase_eig_parity(rng):
    n, k = 300, 7
    B = rng.standard_normal((n, 40))
    C = (B @ B.T) / 40 + 1e-8 * np.eye(n)
    e_f, t_f, nv_f, nt_f = tp.temporal_from_gram(C, n, k, 1e-15)
    e_t, t_t, nv_t, nt_t = tp.temporal_from_gram(C, n, k, 1e-15, num_vectors=k)
    assert t_f.shape == (n, n) and t_t.shape == (n, k)
    assert (nv_f, nt_f) == (nv_t, nt_t)
    np.testing.assert_allclose(e_t, e_f, rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(align_signs(t_t, t_f[:, :k]), t_f[:, :k],
                               rtol=1e-8, atol=1e-10)


def test_sort_eigenvalues_nan_handling():
    e = np.array([0.5, np.nan, 2.0])
    v = np.eye(3)
    es, vs = tp.sort_eigenvalues_desc(e, v)
    ej, vj = jp.sort_eigenvalues_desc(e, v)
    np.testing.assert_array_equal(es, ej)
    np.testing.assert_array_equal(vs, vj)
    assert es[-1] == -1.0e10 and not vs[:, -1].any()
