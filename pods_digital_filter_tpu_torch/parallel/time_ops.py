"""Time-axis operations: temporal interpolation + phase averaging — port of
``pods_digital_filter_tpu/parallel/time_ops.py`` on one device (the
directory mirrors the original's; nothing here is sharded).

The original replaces the reference's dead mpi4py layer
(nsigproclib_no_mpi.py): ``temporal_interpolation(_mult)_MPI`` (691-877)
fetched remote-rank snapshot columns through one-sided RMA windows and
``phase_average_MPI`` (507-688) drove them from rank 0 with a sequential
while-loop.  Here the snapshot matrix is one tensor on ``device`` (default
the card): a column fetch is a gather and the whole phase loop one product.

The phase bins are summed by one product with a one-hot ``(Q, num_phase)``
matrix, where the original calls ``jax.ops.segment_sum``.  A
``scatter_add_``/``index_add_`` on the card adds with atomics, in an order
that changes from run to run; the product sums in a fixed order, so the
same input gives the same bits every time.  It costs ``Q * num_phase``
multiply-adds per row, a few percent of the memory traffic of the
interpolation at the usual tens of bins.

Deviations (documented, as in the original):
* the reference subtracts only *half* the interpolated phase average
  (``B[:,i1] -= 0.5*(w1*v_phase[...] + w2*v_phase[...])``,
  nsigproclib_no_mpi.py:656-658) — an apparent bug; we subtract the full
  phase average.
* the reference's index walk (691-877) reconstructs (rank, local index)
  pairs by stepping time in dt increments; we use direct searchsorted
  interpolation, which is equivalent for the uniform time vectors it is
  called with.

And one of the port's own: the interpolation weights are formed from the
float64 time vector and cast to the snapshot matrix's dtype, so a float32
matrix gives float32 results (the original under ``jax_enable_x64``
promotes them to float64; on its TPU, without x64, they stay float32).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from pods_digital_filter_tpu_torch.device import resolve_device


def _on(x, dev, dtype=None) -> torch.Tensor:
    return torch.as_tensor(x if isinstance(x, torch.Tensor) else np.asarray(x),
                           dtype=dtype, device=dev)


def temporal_interpolate(A, time_vec, t_query, device="cuda") -> torch.Tensor:
    """Linear interpolation of snapshot columns at query times.

    ``A``: (rows, Ns) snapshot matrix; ``time_vec``: (Ns,) ascending sample
    times; ``t_query``: scalar or (Q,).  Returns (rows,) for a scalar query,
    else (rows, Q).  Out-of-range queries clamp to the end columns (the
    reference clamps its index walk the same way,
    nsigproclib_no_mpi.py:713-715).
    """
    dev = resolve_device(device)
    scalar = np.ndim(t_query) == 0
    A = _on(A, dev)
    time_vec = _on(time_vec, dev, torch.float64)
    t_query = torch.atleast_1d(_on(t_query, dev, torch.float64))
    ns = A.shape[1]
    hi = torch.clamp(torch.searchsorted(time_vec, t_query, right=True), 1, ns - 1)
    lo = hi - 1
    t_lo = time_vec[lo]
    t_hi = time_vec[hi]
    w2 = torch.clamp((t_query - t_lo) / torch.clamp(t_hi - t_lo, min=1e-300),
                     0.0, 1.0).to(A.dtype)
    out = A[:, lo] * (1.0 - w2)[None, :] + A[:, hi] * w2[None, :]
    return out[:, 0] if scalar else out


@dataclass
class PhaseAverageResult:
    """Outputs of :func:`phase_average` (mirrors the reference's return
    tuple, nsigproclib_no_mpi.py:688); tensors on the device."""
    phase: np.ndarray          # (num_phase,) phase angle in degrees
    v_phase: torch.Tensor      # (3*Np, num_phase) phase-averaged velocity
    nrs_phase: torch.Tensor    # (3*Np, num_phase) phase <u_i u_i>
    crs_phase: torch.Tensor    # (3*Np, num_phase) phase <u v>, <w v>, <u w>
    phase_counts: torch.Tensor  # (num_phase,) samples per bin
    B_fluct: torch.Tensor      # (3*Np, Ns) field minus its phase average
    rms_scalars: torch.Tensor | None  # (num_scalars, Np) RMS after subtraction
    nrs: torch.Tensor          # (3*Np,) non-periodic resolved stresses
    crs: torch.Tensor          # (3*Np,) non-periodic cross stresses


def _cross_products(B: torch.Tensor, num_points: int) -> torch.Tensor:
    """The reference's cross-stress component layout
    (nsigproclib_no_mpi.py:589-602, 765-768): rows [u*v; w*v; u*w]."""
    u = B[:num_points]
    v = B[num_points:2 * num_points]
    w = B[2 * num_points:3 * num_points]
    return torch.cat([u * v, w * v, u * w], dim=0)


def num_phase_bins(phase_freq: float, dt: float, num_snapshots: int,
                   stride: int = 1) -> int:
    """Snapshots per forcing period (nsigproclib_no_mpi.py:511-524)."""
    num_phase = int(1.0 / phase_freq / dt / stride)
    if num_phase >= num_snapshots:
        num_phase = num_snapshots - 1
    return num_phase


def phase_average(
    B,
    time_vec,
    phase_freq: float,
    num_points: int,
    num_components: int = 3,
    scalars=None,
    num_phase: int | None = None,
    device="cuda",
) -> PhaseAverageResult:
    """Phase-average a snapshot stream over a forcing period.

    ``B``: (num_points*num_components, Ns) velocity snapshots; ``scalars``:
    optional (num_scalars, num_points, Ns).  Resamples the stream at
    ``dt_phase = 1/(phase_freq*num_phase)`` and accumulates cyclic phase
    bins — the vectorized form of the reference's while-loop
    (nsigproclib_no_mpi.py:568-615).
    """
    dev = resolve_device(device)
    B = _on(B, dev)
    time_vec = _on(time_vec, dev, torch.float64)
    ns = B.shape[1]
    dt = float(time_vec[1] - time_vec[0])
    if num_phase is None:
        num_phase = num_phase_bins(phase_freq, dt, ns)
    dt_phase = 1.0 / phase_freq / num_phase

    t_end = float(time_vec[-1])
    num_q = int(np.floor(t_end / dt_phase)) + 1
    t_q = torch.arange(num_q, dtype=torch.float64, device=dev) * dt_phase
    bins = torch.arange(num_q, device=dev) % num_phase
    # (Q, num_phase) one-hot: the bin sums as one product (module docstring)
    onehot = (bins[:, None] == torch.arange(num_phase, device=dev)[None, :])

    S = temporal_interpolate(B, time_vec, t_q, device=dev)    # (3Np, Q)
    counts = onehot.sum(dim=0).to(torch.float64)
    denom = torch.clamp(counts, min=1.0)

    def seg_mean(X):
        return (X @ onehot.to(X.dtype)) / denom.to(X.dtype)[None, :]

    v_phase = seg_mean(S)
    nrs_phase = seg_mean(S * S)
    crs_phase = seg_mean(_cross_products(S, num_points))
    del S

    # subtract the phase average at each snapshot time (full subtraction;
    # see module docstring for the reference's 0.5 factor)
    snap_bins = torch.round(time_vec / dt_phase).to(torch.int64) % num_phase
    B_fluct = B - v_phase[:, snap_bins]

    nrs = torch.mean(B_fluct * B_fluct, dim=1)
    crs = torch.mean(_cross_products(B_fluct, num_points), dim=1)

    rms_scalars = None
    if scalars is not None:
        scalars = _on(scalars, dev)
        ns_sc = scalars.shape[0]
        sc2 = scalars.reshape(ns_sc * num_points, ns)
        sc_phase = seg_mean(temporal_interpolate(sc2, time_vec, t_q, device=dev))
        sc_fluct = sc2 - sc_phase[:, snap_bins]
        rms_scalars = torch.sqrt(torch.mean(sc_fluct * sc_fluct, dim=1)).reshape(
            ns_sc, num_points)

    return PhaseAverageResult(
        phase=np.linspace(0.0, 360.0, num_phase),
        v_phase=v_phase, nrs_phase=nrs_phase, crs_phase=crs_phase,
        phase_counts=counts, B_fluct=B_fluct,
        rms_scalars=rms_scalars, nrs=nrs, crs=crs,
    )


def partition_snapshots(num_snapshots: int, num_parts: int) -> list:
    """Contiguous snapshot ranges per worker — the reference's
    ``DivideByNP`` (nsigproclib_no_mpi.py:485-504, remainder to the first
    part); a copy of the original's."""
    base = num_snapshots // num_parts
    rem = num_snapshots - base * num_parts
    out = []
    start = 0
    for i in range(num_parts):
        n = base + (rem if i == 0 else 0)
        out.append((start, start + n))
        start += n
    return out
