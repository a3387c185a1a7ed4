"""Mesh-sharded out-of-core snapshot POD — counterpart of
``pods_digital_filter_tpu/parallel/streaming.py`` (``:35-433``): the
snapshot matrix is split over the ``('t', 's')`` mesh AND never
materialized.

Each block ``[t0, t0 + block)`` is regenerated on demand from the
counter-indexed noise stream (:mod:`.sharding`): rank ``(ti, si)`` makes
steps ``t0 + ti * block / n_t`` onward of its z tile.  The passes are those
of :func:`..streaming.streaming_pod`:

1. mean — local time sums, all-reduced over ``'t'``;
2. Gram — :func:`..streaming.streamed_gram` (resumable, ``gram_group``)
   on the blocks all-gathered over ``'t'``, each tile's partial product
   all-reduced over ``'s'``: every rank holds the complete ``(Ns, Ns)``
   accumulator, with no collective left for the eigen half;
3. eigen half — :func:`..streaming.eigen_half` on rank 0, which broadcasts
   its answer (modes, energies, counts, route); a deferred spectrum runs in
   rank 0's worker thread, which issues no collective, and
   :meth:`ShardedStreamingResult.resolve` broadcasts it from the main
   thread;
4. projection — local contractions, all-reduced over ``'t'``.

Only rank 0 writes the Gram store; the others read it.  Peak device memory
per rank: two gathered ``(3, block, jma, kma / n_s)`` panels plus the Gram
accumulator, independent of Ns.
"""

from __future__ import annotations

from contextlib import nullcontext
from dataclasses import dataclass

import numpy as np
import torch

from pods_digital_filter_tpu_torch.device import synchronize
from pods_digital_filter_tpu_torch.ops import lund, rotation
from pods_digital_filter_tpu_torch.ops import pod as pod_ops
from pods_digital_filter_tpu_torch.parallel import sharding as shard_lib
from pods_digital_filter_tpu_torch.parallel.mesh import (
    MODES, PLANE, put_global, to_host)
from pods_digital_filter_tpu_torch.parallel.pod import (gram_fields,
                                                        project_fields)
from pods_digital_filter_tpu_torch.pipeline import _DTYPES
from pods_digital_filter_tpu_torch.streaming import (
    StreamingPODResult, _block_starts, eigen_half, make_gram_store,
    start_spectrum, streamed_gram)
from pods_digital_filter_tpu_torch.utils import timing

#: global steps of each call of the sharded generator that fills a rank's
#: tile of the whole run (:func:`generate_tile`)
GENERATE_WINDOW = 512


@dataclass
class ShardedStreamingResult(StreamingPODResult):
    mean_fields: torch.Tensor | None = None    # (C, jma, kma / n_s) local
    # (C, m, jma, kma / n_s) local; on the deferred route m is the
    # optimistic truncation — resolve() slices only pod.spatial_modes
    spatial_mode_fields: torch.Tensor | None = None
    mesh: object = None

    def _join(self, spec_fut, pool):
        """Rank 0 joins its spectrum worker and broadcasts the spectrum;
        the other ranks hold no worker and receive it."""
        out = None if spec_fut is None else super()._join(spec_fut, pool)
        return self.mesh.broadcast_object(out)


def make_sharded_generator(cfg, fields, filt, mesh, block: int,
                           rotate: bool = True, halo: bool | None = None,
                           center=None):
    """``gen(t0)`` -> this rank's tile ``(3, block / n_t, jma, kma / n_s)``
    of the Lund-coloured velocity of the global window ``[t0, t0 +
    block)``: noise (the exact path, or with ``halo`` — default
    ``cfg.halo_exchange`` — the halo-exchange path), Lund, rotation into
    the plane frame, minus ``center`` (this rank's ``(3, jma, kma / n_s)``
    mean tile) when given."""
    p = cfg.plane
    dtype = _DTYPES[cfg.dtype]
    dev = mesh.device
    if halo is None:
        halo = cfg.halo_exchange
    gen_noise = (shard_lib.generate_sharded_halo if halo
                 else shard_lib.generate_sharded)
    tk = p.kma // mesh.shard_space
    k0 = mesh.si * tk

    def tile(a):
        a = np.broadcast_to(np.asarray(a, dtype=np.float64), (p.jma, p.kma))
        return torch.as_tensor(np.ascontiguousarray(a[:, k0:k0 + tk]),
                               dtype=dtype, device=dev)

    stresses = torch.stack([tile(s) for s in fields.stresses()])
    means = torch.stack([tile(m) for m in fields.means()])
    R = (torch.as_tensor(rotation.profile_rotation_matrix(*p.normal),
                         dtype=dtype, device=dev) if rotate else None)

    def gen(t0):
        X = gen_noise(cfg.seed, mesh, t0, block, p.jma, p.kma,
                      filt.nfx, filt.nfy, filt.nfz, filt.length_scale_x,
                      filt.length_scale_y, filt.length_scale_z,
                      num_components=3, dtype=dtype)
        X = lund.apply_lund_stacked(X, stresses, means)
        if R is not None:
            X = torch.tensordot(R, X, dims=([1], [0]))
        if center is not None:
            X.sub_(center[:, None])
        return X

    return gen


def generate_tile(cfg, fields, filt, mesh, rotate: bool = True,
                  window: int = GENERATE_WINDOW) -> torch.Tensor:
    """This rank's tile ``(3, nsteps / n_t, jma, kma / n_s)`` of the whole
    run — the tile of ``make_sharded_generator(..., cfg.nsteps)(0)`` —
    allocated once and filled ``window / n_t`` local steps at a time, so
    that only one window's transients live beside it.

    Each part is a call of :func:`make_sharded_generator` over a window of
    ``c * n_t`` global steps, started where rank ``ti``'s share of it is
    its own steps ``[ti * T_local + j0, + c)``: time blocks are independent
    by construction, so every part is exact, and the ranks of an ``'s'``
    row (the halo path's exchange partners) share their start.  A span
    ``sharded.generate`` a part."""
    nt = mesh.shard_time
    bt, tk = shard_lib._check_divisible(cfg.nsteps, cfg.plane.kma, mesh)
    step = max(1, min(window // nt, bt))
    X = torch.empty((3, bt, cfg.plane.jma, tk), dtype=_DTYPES[cfg.dtype],
                    device=mesh.device)
    gens = {}
    for j0 in range(0, bt, step):
        c = min(step, bt - j0)
        if c not in gens:
            gens[c] = make_sharded_generator(cfg, fields, filt, mesh, c * nt,
                                             rotate=rotate)
        with timing.span("sharded.generate", device=mesh.device):
            X[:, j0:j0 + c] = gens[c](mesh.ti * (bt - c) + j0)
    return X


def streaming_pod_sharded(
    cfg,
    fields,
    filt,
    mesh,
    rotate: bool = True,
    block: int = 512,
    num_modes_trunc: int | None = None,
    tol_cn: float = 1.0e-15,
    verbose: bool = False,
    timer=None,
    defer_spectrum: bool = False,
) -> ShardedStreamingResult:
    """Out-of-core POD with every block split over the mesh; the semantics
    of :func:`..streaming.streaming_pod` (the same counters, the same eigen
    half and routes).  Every rank calls it.  ``cfg.checkpoint_dir`` makes
    the mean and Gram passes resumable — the store holds host float64
    values that do not depend on the mesh on the exact path, so a run may
    resume on another mesh shape; ``cfg.gram_group`` keeps that many
    gathered row blocks on the device.  ``timer`` records per-pass wall
    times.  With ``defer_spectrum`` the full spectrum may still be pending:
    every rank calls ``result.resolve()``."""
    stage = (lambda name: nullcontext()) if timer is None else timer.stage
    ns = cfg.nsteps
    nt = mesh.shard_time
    block = min(block, ns)
    if block % nt:
        raise ValueError(
            f"streaming_block={block} not divisible by shard_time={nt}")
    bb = block // nt
    starts = _block_starts(ns, block)
    nb = len(starts)
    if num_modes_trunc is None:
        num_modes_trunc = cfg.podfs.num_modes
    p = cfg.plane
    dtype = _DTYPES[cfg.dtype]
    dev, lead = mesh.device, mesh.lead
    halo = cfg.halo_exchange

    store = None
    if cfg.checkpoint_dir != "none":
        # the halo path's noise stream depends on the 's' axis size; the
        # exact path's does not.  Rank 0 opens the store first; no rank
        # writes before every rank has read its state
        extra = ("halo", mesh.shard_space) if halo else ()
        if lead:
            store = make_gram_store(cfg, filt, fields, rotate, block, dev,
                                    extra)
        mesh.barrier()
        if not lead:
            store = make_gram_store(cfg, filt, fields, rotate, block, dev,
                                    extra, read_only=True)
        mesh.barrier()

    gen_block = make_sharded_generator(cfg, fields, filt, mesh, block,
                                       rotate=rotate, halo=halo)

    def n_local(t0):
        """This rank's steps of block ``t0`` inside ``[0, ns)``."""
        return max(0, min(bb, ns - t0 - mesh.ti * bb))

    # ---- pass 1: mean (split over 's') ----------------------------------
    with stage("streaming_mean"):
        m_host = store.load_mean() if store is not None else None
        if m_host is not None:
            mean_fields = put_global(m_host.reshape(3, p.jma, p.kma), mesh,
                                     PLANE, dtype)
            if verbose and lead:
                print("sharded streaming POD: mean loaded from checkpoint")
        else:
            s = None
            for t0 in starts:
                cs = gen_block(t0)[:, :n_local(t0)].sum(dim=1)
                s = cs if s is None else s.add_(cs)
            mean_fields = mesh.all_reduce(s, "t") / ns
            if store is not None:
                store.save_mean(to_host(mean_fields, mesh, PLANE).reshape(-1))
            if verbose and lead:
                print(f"sharded streaming POD: mean pass done "
                      f"({nb} blocks of {block})")
        synchronize(dev)

    # passes 2/3 take CENTERED blocks: the mean is subtracted in the
    # generator
    gen_c_block = make_sharded_generator(cfg, fields, filt, mesh, block,
                                         rotate=rotate, halo=halo,
                                         center=mean_fields)

    def gen_c_column(t0):
        """The centred block ``(3, n, jma, kma / n_s)`` of every step, on
        every rank of a ``'t'`` column."""
        X = mesh.all_gather(gen_c_block(t0), "t", dim=1)
        n = min(block, ns - t0)
        return X[:, :n] if n < block else X

    def pair(Ai, Aj, out):
        return out.copy_(mesh.all_reduce(gram_fields(Ai, Aj), "s"))

    # ---- pass 2: Gram (the shared resumable driver) ---------------------
    # only rank 0 solves: the others need no host Gram
    nvec = pod_ops.resolve_num_vectors(cfg, ns, num_modes_trunc)
    with stage("streaming_gram"):
        gram = list(streamed_gram(gen_c_column, ns, block, store=store,
                                  verbose=verbose and lead,
                                  group=cfg.gram_group, return_device=True,
                                  keep_host=lead and nvec is None,
                                  pair=pair))
        synchronize(dev)

    def project(temporal_k, energy_k, k):
        """Projection pass: this rank's steps against its rows of the mode
        coefficients, all-reduced over 't' (split over 's')."""
        Mfull = torch.as_tensor(
            (temporal_k[:, :k] * (1.0 / energy_k[:k])[None, :]) / ns,
            device=dev).to(dtype)
        phi = torch.zeros((3, k, p.jma, p.kma // mesh.shard_space),
                          dtype=dtype, device=dev)
        for t0 in starts:
            Xc, n = gen_c_block(t0), n_local(t0)
            s0 = t0 + mesh.ti * bb
            project_fields(phi, Xc[:, :n], Mfull[s0:s0 + n])
            del Xc
        phi = mesh.all_reduce(phi, "t")
        if verbose and lead:
            print("sharded streaming POD: projection pass done")
        return phi

    # ---- eigen half on rank 0, broadcast --------------------------------
    spectrum = sol = None
    if lead:
        sol = eigen_half(gram, ns, nvec, num_modes_trunc, tol_cn, dev, stage)
        spectrum, sol.spectrum = sol.spectrum, None
    gram.clear()
    sol, deferred = mesh.broadcast_object((sol, spectrum is not None))

    # ---- pass 3: spatial modes (split over 's') -------------------------
    with stage("streaming_projection"):
        phi = project(sol.temporal, sol.energy, sol.ncols)
        # the reference layout, row c*Np + j*kma + k, on every rank
        phi_packed = to_host(phi, mesh, MODES).transpose(0, 2, 3, 1) \
            .reshape(3 * p.jma * p.kma, sol.ncols)
    if lead:
        pending = start_spectrum(spectrum, tol_cn, num_modes_trunc)
    else:
        pending = (None, None, tol_cn, num_modes_trunc) if deferred else None
    res = ShardedStreamingResult(
        mean_field=to_host(mean_fields, mesh, PLANE).reshape(-1),
        pod=sol.pod_result(phi_packed), num_blocks=nb, block=block,
        route=sol.route, _pending=pending, mean_fields=mean_fields,
        spatial_mode_fields=phi, mesh=mesh)
    if res.spectrum_pending and not defer_spectrum:
        with stage("streaming_eigh_spectrum"):
            res.resolve()
    return res


def write_snapshot_tiles(cfg, geom, dt: float, X, mesh, t0: int = 0,
                         chunk: int = 64):
    """Verbose per-step ``.prf`` export of a field tile ``X (3, T_local,
    jma, kma / n_s)`` of the window starting at global step ``t0`` (rank
    ``ti`` holds steps ``t0 + ti * T_local`` onward; steps past
    ``cfg.nsteps`` are not written).  ``chunk`` local steps are gathered at
    a time; every rank calls it and rank 0 writes.  Returns the paths in
    step order (rank 0; empty elsewhere)."""
    from pods_digital_filter_tpu_torch.io import prf as prf_io

    nt, T = mesh.shard_time, X.shape[1]
    written = []
    for j0 in range(0, T, chunk):
        c = min(chunk, T - j0)
        # (3*Np, nt * c): rank ti's c steps after rank ti - 1's
        cols = mesh.all_gather(
            shard_lib.pack_sharded_snapshots(X[:, j0:j0 + c], mesh), "t", 1)
        if not mesh.lead:
            continue
        A = pod_ops.to_numpy(cols).astype(np.float64)
        for ti in range(nt):
            for j in range(c):
                step = t0 + ti * T + j0 + j
                if step < cfg.nsteps:
                    written.append((step, prf_io.write_snapshot_prf(
                        cfg.outdir, step * dt, A[:, ti * c + j], geom,
                        cfg.plane.normal, cfg.plane.origin)))
    return [path for _, path in sorted(written)]


def write_snapshots_sharded_streaming(cfg, fields, filt, mesh, geom,
                                      dt: float, rotate: bool = True,
                                      block: int = 512):
    """Verbose per-step ``.prf`` export of the sharded streaming path:
    blocks regenerated on the mesh and gathered a chunk at a time (bounded
    memory).  Every rank calls it; rank 0 writes."""
    block = min(block, cfg.nsteps)
    gen_block = make_sharded_generator(cfg, fields, filt, mesh, block,
                                       rotate=rotate)
    paths = []
    for t0 in _block_starts(cfg.nsteps, block):
        paths += write_snapshot_tiles(cfg, geom, dt, gen_block(t0), mesh, t0)
    return paths
