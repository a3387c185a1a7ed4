"""Distributed snapshot POD over the ``('t', 's')`` mesh — counterpart of
``pods_digital_filter_tpu/parallel/pod.py`` (``:31-118``).

Works on the field-layout tiles ``X (C, Ns / n_t, jma, kma / n_s)`` (layout
:data:`.mesh.FIELD`), never the packed matrix, and holds no more than one
tile and a few chunks of one at a time:

* mean — the local time sum, all-reduced over ``'t'``; the tile is centred
  in place;
* Gram ``C[t, u] = sum_cjk Xc[c,t,j,k] Xc[c,u,j,k] / Ns``
  (:func:`distributed_gram_fields`, :func:`.sharding.distributed_gram`'s
  design on field tiles) — each rank forms its strip ``C[ti block, :]``
  from the ``'t'`` column's tiles exchanged ``chunk`` local steps at a
  time, the strips are all-reduced over ``'s'`` and all-gathered over
  ``'t'``: no rank multiplies the whole ``(Ns, Ns)`` or holds a gathered
  tile;
* the eigen half runs on rank 0, on its device
  (:func:`..ops.pod.temporal_from_gram_device`), which broadcasts the
  energy, the counts and the ``num_trunc`` scaled temporal modes as
  tensors: every rank projects with the same bits (a mode whose sign
  differed between the ranks of a ``'t'`` column would sum to garbage);
* spatial modes ``Phi[c,m,j,k] = sum_t Xc[c,t,j,k] M[t,m]`` — a local
  contraction with this rank's rows of ``M``, all-reduced over ``'t'``; the
  result stays split over ``'s'``.

Spans (:mod:`..utils.timing`): ``pod.gram``, ``pod.eigh``, ``pod.project``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from pods_digital_filter_tpu_torch.ops import pod as pod_ops
from pods_digital_filter_tpu_torch.parallel.mesh import MODES, PLANE, to_host
from pods_digital_filter_tpu_torch.utils import timing

#: local time steps of a tile exchanged over ``'t'`` at a time in the Gram
#: (1.6 GB a chunk of the flagship's 2 x 2 tile)
GRAM_CHUNK = 512


def _flat(X: torch.Tensor, c: int) -> torch.Tensor:
    """Component ``c`` of fields ``(C, T, jma, kma)`` as ``(T, jma*kma)``
    (a view for a contiguous tile; ``T`` may be 0)."""
    return X[c].reshape(X.shape[1], X.shape[2] * X.shape[3])


def gram_fields(Xi: torch.Tensor, Xj: torch.Tensor) -> torch.Tensor:
    """``sum_cjk Xi[c,t,j,k] Xj[c,u,j,k]`` -> ``(T_i, T_j)``: one product of
    the (time, plane) matrices per component."""
    out = _flat(Xi, 0) @ _flat(Xj, 0).T
    for c in range(1, Xi.shape[0]):
        out.addmm_(_flat(Xi, c), _flat(Xj, c).T)
    return out


def gram_strip(X: torch.Tensor, mesh, chunk: int = GRAM_CHUNK) -> torch.Tensor:
    """This rank's strip of the unnormalised Gram over its z tile,
    ``sum_cjk X[c,t,j,k] Xall[c,u,j,k]`` -> ``(T_local, Ns)``: the ``'t'``
    column's tiles are exchanged ``chunk`` local steps at a time, and each
    exchanged chunk of rank ``tj`` fills the strip's columns ``tj * T_local
    + [j0, j0 + chunk)``."""
    bt, nt = X.shape[1], mesh.shard_time
    strip = torch.empty((bt, nt * bt), dtype=X.dtype, device=X.device)
    for j0 in range(0, bt, chunk):
        c = min(chunk, bt - j0)
        got = mesh.exchange(X[:, j0:j0 + c], "t")     # (n_t, C, c, jma, kma)
        for tj in range(nt):
            strip[:, tj * bt + j0:tj * bt + j0 + c] = gram_fields(X, got[tj])
        del got
    return strip


def distributed_gram_fields(X: torch.Tensor, mesh,
                            chunk: int = GRAM_CHUNK) -> torch.Tensor:
    """The Gram ``Xall^T Xall / Ns`` of the field tiles -> the full ``(Ns,
    Ns)`` on every rank: the strips of :func:`gram_strip` all-reduced over
    ``'s'`` and all-gathered over ``'t'``."""
    ns = X.shape[1] * mesh.shard_time
    strip = mesh.all_reduce(gram_strip(X, mesh, chunk), "s")
    return mesh.all_gather(strip, "t", dim=0) / ns


def project_fields(phi: torch.Tensor, Xc: torch.Tensor,
                   M: torch.Tensor) -> torch.Tensor:
    """``phi[c,m,j,k] += sum_t Xc[c,t,j,k] M[t,m]`` in place."""
    for c in range(Xc.shape[0]):
        _flat(phi, c).addmm_(M.T, _flat(Xc, c))
    return phi


@dataclass
class DistributedPODResult:
    energy: np.ndarray                   # (Ns,) descending
    temporal_modes: np.ndarray           # (Ns, num_trunc) host, scaled
    spatial_modes_fields: torch.Tensor   # (C, m, jma, kma / n_s) local
    mean_fields: torch.Tensor            # (C, jma, kma / n_s) local
    num_valid: int
    num_trunc: int
    mesh: object = None
    #: rank 0 with ``keep_basis``: the whole (Ns, Ns) basis, its first
    #: ``num_valid`` columns scaled (what ``-v`` writes); else None
    temporal_basis: np.ndarray | None = None

    def spatial_modes_packed(self) -> np.ndarray:
        """The reference layout ``(3*Np, m)``, row ``c*Np + j*kma + k``, on
        every rank (an all-gather over ``'s'``: every rank calls it)."""
        phi = to_host(self.spatial_modes_fields, self.mesh, MODES)
        c, m, jma, kma = phi.shape
        return phi.transpose(0, 2, 3, 1).reshape(c * jma * kma, m)

    def mean_packed(self) -> np.ndarray:
        return to_host(self.mean_fields, self.mesh, PLANE).reshape(-1)


def _eigen_half(C: torch.Tensor, mesh, ns: int, num_modes_trunc: int,
                tol_cn: float, keep_basis: bool):
    """Rank 0 solves on its device and broadcasts the counts, the energy
    and the scaled leading columns; ``(energy, temporal, basis, num_valid,
    num_trunc)`` on every rank, ``basis`` rank 0's under ``keep_basis``."""
    f64 = torch.float64
    basis = None
    if mesh.lead:
        energy, cols, num_valid, num_trunc = pod_ops.temporal_from_gram_device(
            C, ns, num_modes_trunc, tol_cn, full_basis=keep_basis)
        if keep_basis:
            basis = cols
        head = torch.tensor([num_valid, num_trunc], dtype=torch.int64)
        energy = torch.from_numpy(energy.copy())
        cols = torch.from_numpy(np.ascontiguousarray(cols[:, :num_trunc]))
    else:
        head = torch.zeros(2, dtype=torch.int64)
    num_valid, num_trunc = (int(v) for v in mesh.broadcast(head))
    if not mesh.lead:
        energy = torch.empty(ns, dtype=f64)
        cols = torch.empty((ns, num_trunc), dtype=f64)
    energy = mesh.broadcast(energy).numpy()
    temporal = pod_ops.to_numpy(mesh.broadcast(cols))
    return energy, temporal, basis, num_valid, num_trunc


def distributed_pod(X: torch.Tensor, mesh, num_modes_trunc: int,
                    tol_cn: float = 1.0e-15, keep_basis: bool = False,
                    chunk: int = GRAM_CHUNK) -> DistributedPODResult:
    """POD of the sharded snapshot fields; the semantics of
    :func:`..ops.pod.snapshot_pod` on the gathered packed matrix.  ``X`` is
    centred in place (the tile holds ``Xc`` afterwards); ``keep_basis``
    keeps the whole scaled basis on rank 0 (``temporal_basis``)."""
    bt = X.shape[1]
    ns = bt * mesh.shard_time
    dev = X.device
    mean = mesh.all_reduce(X.sum(dim=1), "t") / ns
    X.sub_(mean[:, None])
    with timing.span("pod.gram", device=dev):
        C = distributed_gram_fields(X, mesh, chunk)
    with timing.span("pod.eigh", device=dev):
        energy, temporal, basis, num_valid, num_trunc = _eigen_half(
            C, mesh, ns, num_modes_trunc, tol_cn, keep_basis)
    del C
    with timing.span("pod.project", device=dev):
        M = temporal / (ns * energy[:num_trunc])[None, :]
        M = torch.as_tensor(M[mesh.ti * bt:(mesh.ti + 1) * bt],
                            dtype=X.dtype, device=dev)
        phi = torch.zeros((X.shape[0], num_trunc) + tuple(X.shape[2:]),
                          dtype=X.dtype, device=dev)
        phi = mesh.all_reduce(project_fields(phi, X, M), "t")
    return DistributedPODResult(
        energy=energy, temporal_modes=temporal, spatial_modes_fields=phi,
        mean_fields=mean, num_valid=num_valid, num_trunc=num_trunc,
        mesh=mesh, temporal_basis=basis)
