"""Snapshot POD — port of ``pods_digital_filter_tpu/ops/pod.py``.

The device half (Gram matrix, centring, the projection onto the truncated
modes) is torch on the snapshot matrix's device.  The eigen half stays on
the host in float64 numpy, as in the original (``eigh_desc``), except in
the sharded in-memory POD, whose rank 0 solves on its card
(:func:`temporal_from_gram_device`, the same semantics): the helpers
below, from ``count_valid_modes`` to ``temporal_from_gram``, are numpy
copies of the original's (that module imports jax), with the streaming
POD's ``resolve_num_vectors``, ``finalize_spectrum`` and
``scale_temporal_leading`` (``ops/pod.py:189-237``) among them.

Reference semantics (PODFS.py:1294-1393): ``C = A^T A / Ns``; symmetric
``eigh`` in place of the reference's general ``eig`` (same spectrum;
eigenvector signs are arbitrary in both, and the PODFS replay is
sign-invariant); NaN-robust descending sort; valid-mode count by the
condition-number tolerance, including its step-by-two quirk; temporal modes
scaled to ``sqrt(lambda_j / <a_j^2>)``; truncated spatial modes
``Phi = A @ T[:, :m] @ diag(1/lambda) / Ns``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch


def to_numpy(t) -> np.ndarray:
    """Host numpy copy of a tensor (bfloat16, which numpy lacks, becomes
    float32); numpy input passes through."""
    if isinstance(t, np.ndarray):
        return t
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.to(torch.float32)
    return t.cpu().numpy()


def gram_matrix(A: torch.Tensor, cell_weights=None) -> torch.Tensor:
    """``C = A^T A / Ns`` for the snapshot matrix ``A`` of shape
    ``(num_components*num_points, num_snapshots)``.

    ``cell_weights`` (optional, shape ``(num_points,)``) reproduces the
    reference's cell-volume-weighted correlation (PODFS.py:1456-1464): each
    point row is weighted by its cell volume/area, tiled across
    components."""
    ns = A.shape[1]
    if cell_weights is None:
        return (A.T @ A) / ns
    w = torch.as_tensor(cell_weights, dtype=A.dtype, device=A.device)
    ncomp = A.shape[0] // w.shape[0]
    return ((A * w.repeat(ncomp)[:, None]).T @ A) / ns


def center_and_gram(A: torch.Tensor):
    """The POD front half: column mean, centred matrix, Gram.  Returns
    ``(mean, Ac, C)``; ``A`` is left as it was."""
    ns = A.shape[1]
    mean = A.mean(dim=1)
    Ac = A - mean[:, None]
    return mean, Ac, (Ac.T @ Ac) / ns


def count_valid_modes(energy: np.ndarray, tol_cn: float) -> int:
    """Faithful replica of the reference's valid-mode loop (PODFS.py:1312-1318),
    including the double-increment structure (it affects the result only via
    the Ns-2 cap interplay)."""
    ns = energy.shape[0]
    tol2 = math.pow(tol_cn, 2.0)
    e0 = energy[0].real
    nv = 0
    while (energy[nv].real / e0 > tol2) and (nv < ns - 2) and (energy[nv].real > 0.0):
        nv += 1
        if (energy[nv].real / e0 > tol2) and (energy[nv].real > 0.0):
            nv += 1
    return nv


def sort_eigenvalues_desc(energy: np.ndarray, vectors: np.ndarray):
    """Descending real-part sort with the reference's NaN handling
    (PODFS.py:1430-1447): NaN eigenvalues become -1e10 with zeroed vectors."""
    e = energy.real.copy().astype(np.float64)
    v = vectors.real.copy()
    nan_mask = ~np.isfinite(energy.real) | ~np.isfinite(np.imag(np.asarray(energy, dtype=complex)))
    e[nan_mask] = -1.0e10
    v[:, nan_mask] = 0.0
    order = np.argsort(-e, kind="stable")
    return e[order], v[:, order]


@dataclass
class PODResult:
    """INVARIANT (two-phase eig path): ``temporal_modes`` may hold only
    the truncated leading columns — its width is ``>= num_trunc`` but can
    be SMALLER than ``num_valid``.  Consumers slicing by ``num_valid`` must
    clamp to ``min(num_valid, temporal_modes.shape[1])``.

    ``spatial_modes`` is a device tensor between ``snapshot_pod(...,
    defer_spatial=True)`` and :func:`resolve_spatial`, host numpy after."""
    energy: np.ndarray           # (>= num_trunc,) eigenvalues, descending
    temporal_modes: np.ndarray   # (Ns, >= num_trunc); leading cols scaled
    spatial_modes: np.ndarray    # (3*Np, num_trunc)
    num_valid: int
    num_trunc: int


def eigh_desc(C) -> tuple:
    """Descending symmetric eigendecomposition of the Gram matrix — always
    host float64 (LAPACK ``dsyevd``).  Returns (energy, vectors)."""
    Ch = np.asarray(C, dtype=np.float64)
    e, v = np.linalg.eigh((Ch + Ch.T) * 0.5)
    return e[::-1], v[:, ::-1]


def eig_spectrum_desc(C) -> np.ndarray:
    """Full eigenvalue spectrum only (descending, host float64) — LAPACK
    ``dsyevd`` with jobz='N' skips the eigenvector back-transform."""
    Ch = np.asarray(C, dtype=np.float64)
    return np.linalg.eigvalsh((Ch + Ch.T) * 0.5)[::-1]


def eigh_desc_topk(C, k: int) -> tuple:
    """Top-``k`` eigenpairs only (descending, host float64): Lanczos
    (``scipy.sparse.linalg.eigsh``) for large Ns, the dense subset solver
    for small problems.  Eigenvector signs are arbitrary."""
    Ch = np.asarray(C, dtype=np.float64)
    n = Ch.shape[0]
    k = min(k, n)
    Cs = (Ch + Ch.T) * 0.5
    if n < 2048 or k > n // 4:
        from scipy.linalg import eigh as scipy_eigh

        e, v = scipy_eigh(Cs, subset_by_index=[n - k, n - 1])
    else:
        from scipy.sparse.linalg import eigsh

        # deterministic start vector: ARPACK otherwise seeds its Krylov
        # space from an undocumented RNG
        v0 = np.full(n, 1.0 / math.sqrt(n))
        e, v = eigsh(Cs, k=k, which="LA", v0=v0)
    # explicit descending sort: neither solver GUARANTEES ascending output
    order = np.argsort(-e, kind="stable")
    return e[order], v[:, order]


def resolve_num_vectors(cfg, ns: int, num_modes_trunc: int) -> int | None:
    """How many eigenVECTORS the streaming POD needs (``cfg.eig_mode``):

    * ``"full"`` -> None (the complete basis);
    * ``"topk"`` -> the truncated mode count (two-phase eigvalsh+Lanczos);
    * ``"auto"`` -> topk for large non-verbose runs, where the full
      back-transform is pure waste (the flagship consumes 20 of 10,240
      vectors); full otherwise.  ``--verbose`` forces full: the temporal-
      mode export writes every valid mode (PODFS.py:1356,
      pipeline._export_model).
    """
    mode = getattr(cfg, "eig_mode", "auto")
    if mode == "full":
        return None
    if num_modes_trunc < 0:                 # "all valid modes" requested
        return None
    if mode == "topk":
        return num_modes_trunc
    return (num_modes_trunc
            if ns >= 4096 and not getattr(cfg, "verbose", False) else None)


def finalize_spectrum(e_full: np.ndarray, tol_cn: float,
                      num_modes_trunc: int):
    """Reference spectrum semantics applied to a raw eigenvalue array:
    NaN -> -1e10 + descending sort (``sort_eigenvalues``,
    PODFS.py:1430-1447), condition-number valid count (PODFS.py:1312-1318)
    and the truncation clamp.  Shared by every two-phase eigen path
    (serial + sharded, synchronous + deferred resolve).  Returns
    ``(energy_desc, num_valid, num_trunc)``."""
    energy = np.sort(np.where(np.isfinite(e_full), e_full, -1.0e10))[::-1]
    num_valid = count_valid_modes(energy, tol_cn)
    num_trunc = num_modes_trunc
    if num_trunc < 0 or num_trunc > num_valid:
        num_trunc = num_valid
    return energy, num_valid, num_trunc


def scale_temporal_leading(vecs: np.ndarray, energy_lead: np.ndarray,
                           ns: int) -> np.ndarray:
    """Reference temporal-mode scaling (PODFS.py:1322-1325) applied to a
    truncated (Ns, k) eigenvector block: each column scaled so its mean
    square equals its eigenvalue.  Returns a scaled COPY."""
    temporal = vecs.copy()
    mag = np.einsum("ij,ij->j", temporal, temporal) / ns
    scale = np.where(mag > 0, np.sqrt(
        np.maximum(energy_lead, 0.0) / np.where(mag > 0, mag, 1.0)), 1.0)
    temporal *= scale[None, :]
    return temporal


def temporal_from_gram(C, ns: int, num_modes_trunc: int, tol_cn: float,
                       num_vectors: int | None = None):
    """The eigen half of snapshot POD: Gram matrix -> sorted eigenvalues,
    valid-mode count, and reference-scaled temporal modes
    (PODFS.py:1309-1325).  Host numpy outputs.

    ``num_vectors=None`` computes the full eigenvector basis; an int ``k``
    switches to the two-phase decomposition (full spectrum via
    ``eigvalsh``, top ``max(k, num_modes_trunc)`` vectors only)."""
    if num_vectors is None:
        energy, vecs = eigh_desc(C)
        energy, vecs = sort_eigenvalues_desc(energy, vecs)
    else:
        energy = eig_spectrum_desc(C)
        # reference NaN semantics (sort_eigenvalues, PODFS.py:1430-1447)
        # applied to the spectrum alone
        nan_mask = ~np.isfinite(energy)
        energy = np.where(nan_mask, -1.0e10, energy)
        energy = np.sort(energy)[::-1]
        k = max(1, min(max(int(num_vectors), num_modes_trunc), ns))
        _, vecs = eigh_desc_topk(C, k)

    num_valid = count_valid_modes(energy, tol_cn)
    if num_modes_trunc < 0 or num_modes_trunc > num_valid:
        num_modes_trunc = num_valid

    # Temporal-mode scaling (PODFS.py:1322-1325): scale each valid column so
    # its mean square equals its eigenvalue.
    nv = min(num_valid, vecs.shape[1])
    temporal = vecs.copy()
    mag = np.einsum("ij,ij->j", temporal[:, :nv], temporal[:, :nv]) / ns
    scale = np.where(mag > 0,
                     np.sqrt(np.maximum(energy[:nv], 0.0)
                             / np.where(mag > 0, mag, 1.0)), 1.0)
    temporal[:, :nv] *= scale[None, :]
    return energy, temporal, num_valid, num_modes_trunc


def temporal_from_gram_device(C: torch.Tensor, ns: int, num_modes_trunc: int,
                              tol_cn: float, full_basis: bool = False):
    """:func:`temporal_from_gram` with the eigen solve on ``C``'s device:
    every eigenpair from one float64 ``torch.linalg.eigh`` of the
    symmetrised Gram (cuSOLVER on a card, LAPACK on the CPU).  Only the
    spectrum and the columns kept come to the host, where the host helpers
    apply the reference's semantics: :func:`finalize_spectrum`'s NaN
    handling, sort, valid count and truncation, the column order and
    zeroed NaN columns of :func:`sort_eigenvalues_desc`, and
    :func:`scale_temporal_leading`.

    Returns ``(energy, temporal, num_valid, num_trunc)`` as host numpy:
    ``temporal`` the scaled leading ``num_trunc`` columns, or with
    ``full_basis`` the whole basis (its first ``num_valid`` columns scaled,
    as :func:`temporal_from_gram` returns it)."""
    Cd = C.to(torch.float64)
    Cd = (Cd + Cd.T) * 0.5
    e, v = torch.linalg.eigh(Cd)
    del Cd
    e_desc = to_numpy(e)[::-1]
    energy, num_valid, num_trunc = finalize_spectrum(e_desc, tol_cn,
                                                     num_modes_trunc)
    bad = ~np.isfinite(e_desc)
    order = np.argsort(-np.where(bad, -1.0e10, e_desc), kind="stable")
    keep = order if full_basis else order[:num_trunc]
    cols = torch.as_tensor(e.shape[0] - 1 - keep, device=v.device)
    temporal = to_numpy(v.index_select(1, cols))
    temporal[:, bad[keep]] = 0.0
    nv = min(num_valid, temporal.shape[1])
    temporal[:, :nv] = scale_temporal_leading(temporal[:, :nv], energy[:nv],
                                              ns)
    return energy, temporal, num_valid, num_trunc


def _spatial_modes(A: torch.Tensor, T_scaled: torch.Tensor,
                   energy: torch.Tensor) -> torch.Tensor:
    """``Phi = A @ T @ diag(1/lambda) / Ns`` (PODFS.py:1329-1333)."""
    ns = A.shape[1]
    M = T_scaled * (1.0 / energy)[None, :]
    return (A @ M) / ns


def snapshot_pod(A: torch.Tensor, num_modes_trunc: int, tol_cn: float = 1.0e-15,
                 cell_weights=None, gram=None,
                 defer_spatial: bool = False) -> PODResult:
    """Full snapshot POD of ``A`` (shape ``(3*Np, Ns)``, mean already removed).

    Device work: the Gram matrix (unless ``gram`` is given, e.g. from
    :func:`center_and_gram`) and the projection.  Host work: the float64
    eigendecomposition and its O(Ns) bookkeeping.  With
    ``defer_spatial=True`` the spatial modes stay a device tensor until
    :func:`resolve_spatial`."""
    ns = A.shape[1]
    C = gram_matrix(A, cell_weights) if gram is None else gram
    energy, temporal, num_valid, num_modes_trunc = temporal_from_gram(
        to_numpy(C), ns, num_modes_trunc, tol_cn)

    T_scaled = torch.as_tensor(temporal[:, :num_modes_trunc], dtype=A.dtype,
                               device=A.device)
    lam = torch.as_tensor(energy[:num_modes_trunc], dtype=A.dtype,
                          device=A.device)
    phi = _spatial_modes(A, T_scaled, lam)
    return PODResult(
        energy=energy,
        temporal_modes=temporal,
        spatial_modes=phi if defer_spatial else to_numpy(phi),
        num_valid=num_valid,
        num_trunc=num_modes_trunc,
    )


def resolve_spatial(pr: PODResult) -> PODResult:
    """Bring deferred ``spatial_modes`` to the host; idempotent."""
    pr.spatial_modes = to_numpy(pr.spatial_modes)
    return pr
