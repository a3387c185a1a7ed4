"""Out-of-core snapshot POD by deterministic regeneration — port of
``pods_digital_filter_tpu/streaming.py`` (``:57-892``), on one device.

The in-memory path holds the snapshot matrix ``A (3*Np, Ns)``; at the
flagship configuration (1024x512 plane, 10,240 snapshots) that is 64.4 GB in
float32, and the in-memory POD needs several times ``A``.  Generation is
stateless and counter-indexed (every block ``[t0, t0+nb)`` is a function
of ``(seed, t0)``), so ``A`` is never stored: it is regenerated block by
block.

Three streamed passes:

1. column sums  ->  mean field ``m``;
2. pairwise block products ``(A_i - m)^T (A_j - m)``  ->  centered Gram,
   accumulated in one ``(Ns, Ns)`` tensor on the device.  Each block is
   centered inside the generator (``make_generator(center=m)``): with a
   dominant mean (TI ~ 2 %) the centered entries are ~1e-4 of the raw
   ones, and a raw product with a rank-1 correction would lose 3-4
   significant digits in float32;
3. spatial-mode projection ``Phi = sum_b (A_b - m 1^T) M_b`` with
   ``M = T_scaled diag(1/lambda) / Ns`` (PODFS.py:1329-1333).

``gram_group`` keeps that many row blocks on the device as one panel while
the columns are swept once for all of them: O(B^2 / group) generations for
B = ceil(Ns / block).  With ``checkpoint_dir`` the mean and every finished
Gram row strip are stored (utils/checkpoint.GramCheckpoint) and a restarted
run recomputes only the missing rows.

What the original did for its remote TPU link and the port does not: a
periodic one-element drain of the dispatch queue, strips downloaded
asynchronously a panel late, the panel kept as a list of blocks against
heap fragmentation, and ``except Exception: pass`` around the asynchronous
copies.  Here a strip comes down with a plain ``.cpu()`` after its sweep
and the panel is one tensor; no ``except`` hides a failure.
"""

from __future__ import annotations

import os
import warnings
from contextlib import nullcontext
from dataclasses import dataclass, field

import numpy as np
import torch

from pods_digital_filter_tpu_torch.device import resolve_device, synchronize
from pods_digital_filter_tpu_torch.ops import fused_tail as tail_ops
from pods_digital_filter_tpu_torch.ops import pod as pod_ops
from pods_digital_filter_tpu_torch.pipeline import _DTYPES, make_generator
from pods_digital_filter_tpu_torch.utils import timing


@dataclass
class StreamingPODResult:
    mean_field: np.ndarray      # (3*Np,)
    pod: pod_ops.PODResult
    num_blocks: int
    block: int
    # which eigen route ran: {"vectors": ..., "spectrum": ...}
    route: dict = field(default_factory=dict)


def _block_starts(ns: int, block: int):
    return list(range(0, ns, block))


def _colsum_acc(s, A):
    """``s + A.sum(axis=1)`` — the mean pass's per-block accumulation
    (``s`` None for the first block)."""
    cs = A.sum(dim=1)
    return cs if s is None else s.add_(cs)


def _project_block_at(phi, Ac, Mfull, t0: int):
    """``phi += Ac @ Mfull[t0:t0+T]``, the projection pass's step."""
    return phi.addmm_(Ac, Mfull[t0:t0 + Ac.shape[1]].to(Ac.dtype))


def _pair_products(Ai, Aj, out=None):
    """Gram tile ``Ai^T Aj`` of two ALREADY-CENTERED blocks, written into
    ``out`` (a view of the device Gram accumulator) when given."""
    return torch.mm(Ai.T, Aj, out=out)


class HostBlockCache:
    """Host-side cache of generated blocks (``--streaming_cache``): pass 1
    stores each block once; later passes read it back instead of
    regenerating, cutting the Gram pass's O(B^2) generations to O(B) at the
    price of a host-to-device copy per block.

    ``mode='ram'`` keeps CPU tensors in host memory; ``mode='disk'`` keeps
    ``.npy`` files under ``directory`` (bounded RAM; a cache, not a
    checkpoint).  Which of regeneration and the cache wins depends on the
    host link against the generator's rate."""

    def __init__(self, mode: str = "ram", directory: str | None = None):
        if mode not in ("ram", "disk"):
            raise ValueError(f"streaming_cache mode {mode!r}: ram|disk")
        self.mode = mode
        self._ram: dict = {}
        self._paths: dict = {}
        self._dtype = self._device = None
        if mode == "disk":
            import tempfile
            self.dir = directory or tempfile.mkdtemp(prefix="pods_blockcache_")
            os.makedirs(self.dir, exist_ok=True)

    def put(self, t0: int, block: torch.Tensor) -> None:
        self._dtype, self._device = block.dtype, block.device
        if self.mode == "ram":
            self._ram[t0] = block.detach().to("cpu", copy=True)
        else:
            path = os.path.join(self.dir, f"block_{t0:08d}.npy")
            np.save(path, pod_ops.to_numpy(block))
            self._paths[t0] = path

    def get(self, t0: int):
        """A fresh device copy of the cached block, or None."""
        if self.mode == "ram":
            hit = self._ram.get(t0)
            return None if hit is None else hit.to(self._device, copy=True)
        path = self._paths.get(t0)
        if path is None:
            return None
        return torch.tensor(np.load(path, mmap_mode="r"),
                            device=self._device).to(self._dtype)

    def wrap(self, gen):
        """Memoizing wrapper around a block generator: only RAW blocks are
        cached (pass 1); the centered generator of passes 2/3 centers the
        fresh copy in place (:func:`make_centered_generator`)."""

        def cached(t0):
            hit = self.get(int(t0))
            if hit is not None:
                return hit
            A = gen(t0)
            self.put(int(t0), A)
            return A

        return cached


def symmetrize_gram_device(C_dev, ns: int):
    """Device-side equivalent of the host mirror-and-scale at the end of
    :func:`streamed_gram`: keep the upper triangle as truth (sub-diagonal
    tiles computed inside a wide panel are discarded, as the host assembly
    does), mirror it, divide by ``ns``.  Returns the full symmetric
    ``C = (A-m)^T(A-m)/ns`` on the device."""
    return (torch.triu(C_dev) + torch.triu(C_dev, 1).T) / ns


def _contiguous_runs(indices):
    """Split a sorted index list into maximal contiguous runs."""
    runs, run = [], []
    for i in indices:
        if run and i != run[-1] + 1:
            runs.append(run)
            run = []
        run.append(i)
    if run:
        runs.append(run)
    return runs


def _panel(gen, t0s, w):
    """The row panel: the blocks at ``t0s`` side by side along their time
    axis (dim 1: ``(3*Np, w)``, or ``(C, w, jma, kma)`` for field blocks;
    one block is its own panel).  Each block is copied in and dropped
    before the next generates."""
    if len(t0s) == 1:
        return gen(t0s[0])
    panel, off = None, 0
    for t0 in t0s:
        A = gen(t0)
        if panel is None:
            panel = torch.empty(A.shape[:1] + (w,) + A.shape[2:],
                                dtype=A.dtype, device=A.device)
        panel[:, off:off + A.shape[1]] = A
        off += A.shape[1]
        del A
    return panel


def streamed_gram(gen, ns: int, block: int, store=None,
                  verbose: bool = False, group: int = 1,
                  return_device: bool = False, keep_host: bool = True,
                  pair=_pair_products):
    """The O(B^2) pairwise Gram pass over regenerated blocks.

    ``gen(t0)`` returns the ALREADY-CENTERED ``(3*Np, n)`` block for steps
    ``[t0, min(t0+block, ns))``; ``pair(panel, Aj, out)`` writes each tile
    ``panel^T Aj`` into ``out``, a view of the accumulator
    (:func:`_pair_products`; the sharded path's blocks are field tiles,
    ``(C, n, jma, kma / n_s)``, and its ``pair`` reduces over the mesh).
    With a :class:`GramCheckpoint`
    ``store``, completed row strips are loaded instead of recomputed and
    new rows are stored as they finish.  Returns the centered Gram
    ``C = (A-m)^T (A-m) / ns`` as host float64.

    ``group`` (``--gram_group``) holds that many row blocks on the device
    as ONE panel while the columns are swept once for all of them.  Every
    tile goes straight into ONE device ``(ns, ns)`` accumulator, whose row
    strip comes to the host (``.cpu()``) when its sweep ends.

    ``return_device=True`` also returns the raw accumulator (un-normalized,
    upper-block-triangular — feed it to :func:`symmetrize_gram_device`),
    or None when any row was loaded from the store (it would be
    incomplete).  ``keep_host=False`` (device-eigen callers, no store)
    skips the strip downloads and the host assembly and returns
    ``(None, C_dev)``; it needs ``return_device=True``, checked on entry.
    A store forces ``keep_host`` (its rows are host-side)."""
    if not (keep_host or store is not None or return_device):
        raise ValueError("keep_host=False requires return_device=True")
    keep_host = keep_host or store is not None
    starts = _block_starts(ns, block)
    nb = len(starts)
    width = lambda bi: min(block, ns - starts[bi])
    C = np.zeros((ns, ns), dtype=np.float64) if keep_host else None
    group = max(1, int(group))
    C_dev = None                 # allocated with the first block's dtype
    device_complete = True       # False once any row comes from the store

    for g0 in range(0, nb, group):
        rows = list(range(g0, min(g0 + group, nb)))
        pending = [bi for bi in rows
                   if store is None or bi not in store.completed_rows]
        for bi in rows:
            if bi not in pending:
                ti = starts[bi]
                C[ti:ti + width(bi), ti:] = store.load_row(bi)
                device_complete = False
                if verbose:
                    print(f"streaming POD: gram row {bi + 1}/{nb} "
                          "(from checkpoint)")
        # rows complete in order, so pending is contiguous; a hand-edited
        # store may break that, so sweep each run
        for run in _contiguous_runs(pending):
            t_lo = starts[run[0]]
            w = sum(width(bi) for bi in run)
            panel = _panel(gen, [starts[bi] for bi in run], w)
            if C_dev is None:
                C_dev = torch.zeros((ns, ns), dtype=panel.dtype,
                                    device=panel.device)
            for ji in range(run[0], nb):
                tj, nj = starts[ji], width(ji)
                # panel columns reuse the resident blocks: no regeneration
                Aj = (panel[:, tj - t_lo:tj - t_lo + nj] if ji in run
                      else gen(tj))
                pair(panel, Aj, out=C_dev[t_lo:t_lo + w, tj:tj + nj])
                del Aj
            del panel
            if keep_host:
                strip = pod_ops.to_numpy(C_dev[t_lo:t_lo + w, t_lo:])
                for bi in run:
                    ti, off = starts[bi], starts[bi] - t_lo
                    C[ti:ti + width(bi), t_lo:] = strip[off:off + width(bi)]
                    if store is not None:
                        store.save_row(bi, strip[off:off + width(bi),
                                                 ti - t_lo:])
                    if verbose:
                        print(f"streaming POD: gram row {bi + 1}/{nb}")
            elif verbose:
                for bi in run:
                    print(f"streaming POD: gram row {bi + 1}/{nb} "
                          "(device-resident)")
    if not keep_host:
        return None, (C_dev if device_complete else None)
    # mirror upper -> lower, blockwise (a strided block transpose; the small
    # per-block fancy index covers the within-diagonal-block lower triangle)
    bs = 1024
    il = np.tril_indices(bs, -1)
    for j0 in range(0, ns, bs):
        j1 = min(j0 + bs, ns)
        C[j0:j1, :j0] = C[:j0, j0:j1].T
        blk = C[j0:j1, j0:j1]
        ib = il if j1 - j0 == bs else np.tril_indices(j1 - j0, -1)
        blk[ib] = blk.T[ib]
    C /= ns
    if return_device:
        return C, (C_dev if device_complete else None)
    return C


def make_centered_generator(cfg, fields, filt, block, ns, rotate, m,
                            cached_raw_gen=None, device="cuda"):
    """Block generator that yields MEAN-CENTERED blocks for the Gram and
    projection passes.

    Without a cache the mean is subtracted inside the generator
    (``make_generator(center=m)``, its last step).  With a
    :class:`HostBlockCache` (``cached_raw_gen`` set) the fresh device copy
    of a cached raw block is centered in place."""
    if cached_raw_gen is not None:
        return lambda t0: cached_raw_gen(t0).sub_(m[:, None])
    gen_block = make_generator(cfg, fields, filt, nsteps=block,
                               rotate=rotate, center=m, device=device)

    def gen_c(t0):
        with timing.span("streaming.generate"):
            A = gen_block(t0)
        n = min(block, ns - t0)
        return A[:, :n] if n < block else A

    return gen_c


def gram_pass_hbm_estimate(np3: int, block: int, group: int, itemsize: int,
                           nfx: int, ns: int = 0,
                           fused_tail: bool = False) -> int:
    """Analytic peak device bytes of the Gram-pass column sweep — the
    coexisting tensors (the original's formula):

    * the resident row panel: ``group`` blocks of ``np3 * block`` elements;
    * the regenerated column block (one more);
    * the generation transients of the column block: the filtered-slab
      tensor (``block + 2*nfx`` time slabs, the temporal-FIR input) and the
      FIR output block; with ``fused_tail`` (the generator's float32 and
      bfloat16 ``--pallas`` routes, :func:`.ops.fused_tail.fused_tail`)
      the slabs only, since the tail kernel writes the column block itself;
    * when ``ns`` is given, the ``(ns, ns)`` Gram accumulator plus two
      strip-sized buffers of ``group * block * ns`` elements."""
    blk = np3 * block * itemsize
    slab = np3 * (block + 2 * nfx) * itemsize     # temporal-FIR input
    transients = slab + (0 if fused_tail else blk)   # + FIR output block
    gram_acc = ns * ns * itemsize + 2 * group * block * ns * itemsize
    return int((group + 1) * blk + transients + gram_acc)


#: device memory held back from the Gram-pass budget: the CUDA context, the
#: cuBLAS workspaces and the caching allocator's rounding
DEVICE_RESERVE_BYTES = 4 * 2 ** 30


def device_memory_budget(device) -> int | None:
    """Bytes the Gram pass may plan for on ``device``: the card's total
    memory minus :data:`DEVICE_RESERVE_BYTES`; None on the CPU (host
    memory is not budgeted here)."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return None
    return torch.cuda.get_device_properties(dev).total_memory \
        - DEVICE_RESERVE_BYTES


def device_free_bytes(device) -> int | None:
    """Bytes a new allocation can take on ``device`` now: the card's free
    memory plus what the caching allocator holds reserved but unallocated
    (it releases those segments before it gives up on an allocation);
    None on the CPU."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return None
    free, _ = torch.cuda.mem_get_info(dev)
    return free + torch.cuda.memory_reserved(dev) \
        - torch.cuda.memory_allocated(dev)


def dense_eigh_fits(dev, ns: int) -> bool:
    """Whether the eigen half solves the whole ``(ns, ns)`` Gram with one
    float64 device ``eigh``: on a card whose free memory
    (:func:`device_free_bytes`) now holds the solve's bytes, about
    ``5 * ns**2 * 8`` (the f64 copy, its symmetrised sum, the vectors and
    cuSOLVER's workspace; 4.2 GB at ``ns`` = 10,240)."""
    free = device_free_bytes(dev)
    return free is not None and 5 * ns * ns * 8 <= free


def cache_host_ram_estimate(np3: int, ns: int, itemsize: int) -> int:
    """Host bytes a ``--streaming_cache ram`` run will retain: every raw
    generated block, i.e. the full ``(3*Np, Ns)`` snapshot matrix."""
    return np3 * ns * itemsize


def _warn_cache_host_ram(np3, ns, itemsize, phys_bytes=None):
    """``mode='ram'`` accumulating more than half of physical host RAM
    warns up front (suggesting ``--streaming_cache disk``), not as a host
    OOM kill mid-pass."""
    est = cache_host_ram_estimate(np3, ns, itemsize)
    if phys_bytes is None:
        try:
            phys_bytes = (os.sysconf("SC_PAGE_SIZE")
                          * os.sysconf("SC_PHYS_PAGES"))
        except (ValueError, OSError, AttributeError):
            return
    if est > 0.5 * phys_bytes:
        warnings.warn(
            f"--streaming_cache ram will retain every generated block: "
            f"~{est / 2 ** 30:.1f} GiB of host memory (the full snapshot "
            f"matrix) against {phys_bytes / 2 ** 30:.1f} GiB physical RAM "
            f"— use --streaming_cache disk (bounded RAM, .npy files) or "
            f"drop the cache (pure regeneration).",
            stacklevel=3)


def _warn_gram_hbm(np3, block, group, itemsize, nfx, ns=0, budget=None,
                   fused_tail=False):
    """Warn before a Gram pass whose estimated peak exceeds ``budget``
    device bytes (None: no budget, no warning) — at every group, the
    default 1 included."""
    if budget is None:
        return
    est = gram_pass_hbm_estimate(np3, block, group, itemsize, nfx, ns,
                                 fused_tail)
    if est > budget:
        warnings.warn(
            f"--gram_group {group} with --streaming_block {block} puts the "
            f"Gram-pass peak at an estimated {est / 2 ** 30:.1f} GiB of "
            f"device memory (panel {group} x "
            f"{np3 * block * itemsize / 2 ** 30:.1f} GiB + generation "
            f"transients + Gram accumulator) against a budget of "
            f"{budget / 2 ** 30:.1f} GiB; expect an out-of-memory error — "
            f"reduce --gram_group or --streaming_block.",
            stacklevel=3)


def make_gram_store(cfg, filt, fields, rotate, block, device, extra=(),
                    read_only=False):
    """GramCheckpoint keyed by everything that determines the Gram values —
    the resolved turbulence stress/mean fields and the port's noise stream
    included.  "gram-v2": rows store centered products."""
    from pods_digital_filter_tpu_torch.ops.fused_filter import \
        generation_stream_tag
    from pods_digital_filter_tpu_torch.utils.checkpoint import (
        GramCheckpoint, config_fingerprint)

    stream = generation_stream_tag(cfg.use_pallas, device)
    fp = config_fingerprint((cfg.plane, filt, cfg.seed, cfg.dtype, rotate,
                             cfg.use_pallas, fields, stream, "gram-v2")
                            + tuple(extra))
    return GramCheckpoint(cfg.checkpoint_dir, fp, cfg.nsteps, block,
                          read_only)


def streaming_pod(
    cfg,
    fields,
    filt,
    rotate: bool = True,
    block: int = 512,
    num_modes_trunc: int | None = None,
    tol_cn: float = 1.0e-15,
    verbose: bool = False,
    timer=None,
    device="cuda",
) -> StreamingPODResult:
    """Snapshot POD of the full ``cfg.nsteps`` generation run on ``device``
    without ever materializing the snapshot matrix.

    ``cfg/fields/filt`` are the arguments of
    :func:`pipeline.generate_snapshot_matrix`; blocks are regenerated with
    the same counters, so the result matches the in-memory pipeline.  With
    ``cfg.checkpoint_dir`` set, the mean and Gram passes are resumable;
    ``cfg.gram_group`` > 1 keeps that many row blocks resident during the
    Gram pass; ``cfg.streaming_cache`` memoizes generated blocks on the
    host.  ``timer`` (utils.timing.StageTimer) records the per-pass wall
    times (each pass ends in a device synchronize).

    Eigen routes: those of :func:`eigen_half`, which returns every count
    final before the projection pass.  ``result.route`` names the route
    taken."""
    dev = resolve_device(device)
    stage = (lambda name: nullcontext()) if timer is None else timer.stage
    ns = cfg.nsteps
    block = min(block, ns)
    starts = _block_starts(ns, block)
    nb = len(starts)
    if num_modes_trunc is None:
        num_modes_trunc = cfg.podfs.num_modes
    np3 = 3 * cfg.plane.jma * cfg.plane.kma
    itemsize = torch.empty((), dtype=_DTYPES[cfg.dtype]).element_size()

    store = None
    if getattr(cfg, "checkpoint_dir", "none") != "none":
        store = make_gram_store(cfg, filt, fields, rotate, block, dev)

    _warn_gram_hbm(np3, block, getattr(cfg, "gram_group", 1), itemsize,
                   filt.nfx, ns, budget=device_memory_budget(dev),
                   fused_tail=(cfg.use_pallas and
                               _DTYPES[cfg.dtype] in tail_ops.DTYPES))

    # the ragged final block generates a full window and keeps the first
    # ns-t0 columns (the same values: the stream is counter-indexed)
    gen_block = make_generator(cfg, fields, filt, nsteps=block, rotate=rotate,
                               device=dev)

    def gen(t0):
        with timing.span("streaming.generate"):
            A = gen_block(t0)
        n = min(block, ns - t0)
        return A[:, :n] if n < block else A

    cached_raw_gen = None
    cache_mode = getattr(cfg, "streaming_cache", "none")
    if cache_mode != "none":
        if cache_mode == "ram":
            _warn_cache_host_ram(np3, ns, itemsize)
        gen = cached_raw_gen = HostBlockCache(cache_mode).wrap(gen)

    # ---- pass 1: mean --------------------------------------------------
    with stage("streaming_mean"):
        m_host = store.load_mean() if store is not None else None
        if m_host is not None:
            m = torch.as_tensor(m_host, device=dev).to(_DTYPES[cfg.dtype])
            if verbose:
                print("streaming POD: mean loaded from checkpoint")
        else:
            s = None
            for t0 in starts:
                s = _colsum_acc(s, gen(t0))
            m = s / ns                           # (3*Np,) device
            if store is not None:
                store.save_mean(pod_ops.to_numpy(m).astype(np.float64))
            if verbose:
                print(f"streaming POD: mean pass done "
                      f"({nb} blocks of {block})")
        synchronize(dev)

    gen_c = make_centered_generator(cfg, fields, filt, block, ns, rotate, m,
                                    cached_raw_gen=cached_raw_gen, device=dev)

    # ---- pass 2: Gram (resumable) ----------------------------------------
    # on the device-eigen (topk) path with no store, the host Gram is only
    # a fallback input: skip its download and host assembly
    nvec = pod_ops.resolve_num_vectors(cfg, ns, num_modes_trunc)
    with stage("streaming_gram"):
        gram = list(streamed_gram(gen_c, ns, block,
                                  store=store, verbose=verbose,
                                  group=getattr(cfg, "gram_group", 1),
                                  return_device=True,
                                  keep_host=nvec is None))
        synchronize(dev)

    mean_host = pod_ops.to_numpy(m).astype(np.float64)

    def project(M):
        """Projection pass over the centered blocks (PODFS.py:1329-1333),
        with the coefficients ``M`` (:meth:`EigenHalf.projection`) uploaded
        once."""
        Mfull = torch.as_tensor(M, device=dev).to(m.dtype)
        phi = torch.zeros((m.shape[0], M.shape[1]), dtype=m.dtype,
                          device=dev)
        for t0 in starts:
            phi = _project_block_at(phi, gen_c(t0), Mfull, t0)
        if verbose:
            print("streaming POD: projection pass done")
        return pod_ops.to_numpy(phi)

    sol = eigen_half(gram, ns, nvec, num_modes_trunc, tol_cn, dev, stage)
    with stage("streaming_projection"):
        phi = project(sol.projection())
    return StreamingPODResult(
        mean_field=mean_host, pod=sol.pod_result(phi), num_blocks=nb,
        block=block, route=sol.route)


@dataclass
class EigenHalf:
    """The eigen half's answer, every count final, which the projection
    pass consumes: the spectrum, the scaled temporal modes and ``scale``,
    the eigenvalues their leading columns were scaled by (``energy``, or
    on the scalar-Lanczos and host top-k routes the top-k solver's own)."""

    energy: np.ndarray
    temporal: np.ndarray
    num_valid: int
    num_trunc: int
    route: dict
    scale: np.ndarray

    def projection(self) -> np.ndarray:
        """``M = T_scaled diag(1/lambda) / Ns`` of the ``num_trunc``
        leading modes (PODFS.py:1329-1333), host float64: the spatial
        modes are ``(A - m 1^T) M``."""
        k = self.num_trunc
        return (self.temporal[:, :k] * (1.0 / self.scale[:k])[None, :]) \
            / self.temporal.shape[0]

    def pod_result(self, spatial_modes) -> pod_ops.PODResult:
        return pod_ops.PODResult(
            energy=self.energy, temporal_modes=self.temporal,
            spatial_modes=spatial_modes, num_valid=self.num_valid,
            num_trunc=self.num_trunc)


def _top_k_half(e_full, e_lead, vecs, ns: int, k: int, num_modes_trunc: int,
                tol_cn: float, route: dict) -> EigenHalf:
    """A top-k route's answer: the reference's semantics on the full
    spectrum ``e_full`` (:func:`..ops.pod.finalize_spectrum`), and the
    ``k`` vectors ``vecs`` scaled by their eigenvalues ``e_lead`` (None:
    the spectrum's ``k`` leading)."""
    energy, num_valid, num_trunc = pod_ops.finalize_spectrum(
        e_full, tol_cn, num_modes_trunc)
    if e_lead is None:
        e_lead = energy[:k]
    temporal = pod_ops.scale_temporal_leading(vecs, e_lead, ns)
    return EigenHalf(energy, temporal, num_valid, min(num_trunc, k), route,
                     e_lead)


def eigen_half(gram: list, ns: int, nvec, num_modes_trunc: int,
               tol_cn: float, dev, stage=None) -> EigenHalf:
    """The eigen half of the streaming POD on a complete local Gram —
    shared by :func:`streaming_pod` and the sharded
    :func:`.parallel.streaming.streaming_pod_sharded` (on rank 0).

    ``gram`` is ``[C, C_dev]`` as :func:`streamed_gram` returns them (host
    float64 or None, the device accumulator or None); the list is emptied
    here, so that the device accumulator is freed once symmetrized.
    ``nvec`` is :func:`..ops.pod.resolve_num_vectors`'s answer.

    Routes: the full host eigh (``nvec`` None); or, for the top-k modes
    with a device Gram, one float64 device ``eigh`` of the whole Gram
    where :func:`dense_eigh_fits`, else one float64 block-Lanczos band
    reduction (spectrum and vectors at once), else the scalar Lanczos
    vectors and then the ``m = n`` Lanczos spectrum; the host top-k
    vectors and ``eigvalsh`` spectrum when the rows came from a store or a
    gate tripped.  Every route returns its counts final.  ``route`` names
    the route taken.  No collective runs here."""
    stage = stage or (lambda name: nullcontext())
    C, C_dev = gram
    gram.clear()
    if nvec is None:
        C_dev = None           # the full-eig path is host-side: free it
        with stage("streaming_eigh"):
            energy, temporal, num_valid, num_trunc = \
                pod_ops.temporal_from_gram(C, ns, num_modes_trunc, tol_cn)
        return EigenHalf(energy, temporal, num_valid, num_trunc,
                         {"vectors": "host eigh (f64, every vector)",
                          "spectrum": "host eigh (f64)"}, energy)

    from pods_digital_filter_tpu_torch.ops import lanczos

    k = max(1, min(max(nvec, num_modes_trunc), ns))
    route = {}
    top_k = lambda e_full, e_lead, vecs: _top_k_half(
        e_full, e_lead, vecs, ns, k, num_modes_trunc, tol_cn, route)
    if C_dev is not None:
        with stage("streaming_eigh_vectors"):
            with stage("eigh_vectors_symmetrize"):
                C_sym = symmetrize_gram_device(C_dev, ns)
                C_dev = None     # free the raw accumulator
                synchronize(dev)
            if dense_eigh_fits(dev, ns):
                # every eigenpair from one f64 solve
                with timing.span("streaming.eigh_dense", device=dev):
                    energy, temporal, num_valid, num_trunc = \
                        pod_ops.temporal_from_gram_device(
                            C_sym, ns, num_modes_trunc, tol_cn)
                solver = f"device eigh on {dev.type} (f64)"
                return EigenHalf(energy, temporal, num_valid, num_trunc,
                                 {"vectors": solver, "spectrum": solver},
                                 energy)
            if C_sym.dtype == torch.float64:
                # one complete block-Lanczos band reduction: the full
                # spectrum and the top-k vectors together
                with stage("eigh_vectors_lanczos"):
                    e_full, v_blk = lanczos.spectrum_and_topk(C_sym, k)
                if e_full is not None:
                    solver = f"block Lanczos on {dev.type} (f64)"
                    route.update(vectors=solver, spectrum=solver)
                    return top_k(e_full, None, v_blk)
                route["gate"] = "block Lanczos gates tripped"
            # float32, or the block gates tripped: scalar Lanczos vectors,
            # then the full spectrum from its own m = n scan
            with stage("eigh_vectors_lanczos"):
                e_k, v_k = lanczos.topk_or_none(C_sym, k)
            if e_k is not None:
                dtype = str(C_sym.dtype)[6:]
                route["vectors"] = f"Lanczos top-k on {dev.type} ({dtype})"
                e_full = lanczos.full_spectrum(C_sym)
                if e_full is not None:
                    route["spectrum"] = (f"Lanczos m = n on {dev.type} "
                                         f"({dtype})")
                else:
                    if C is None:
                        C = pod_ops.to_numpy(C_sym).astype(np.float64)
                    e_full = pod_ops.eig_spectrum_desc(C)
                    route["spectrum"] = (
                        "host eigvalsh (f64; the Lanczos spectrum failed its "
                        "finiteness or trace gate)")
                return top_k(e_full, e_k, v_k)
        route["gate"] = "Lanczos top-k residual gate tripped"
        if C is None:
            C = pod_ops.to_numpy(C_sym).astype(np.float64)
        C_sym = None
    # host: Gram rows came from the store, or a gate tripped
    route["vectors"] = ("host top-k eigh (f64, Gram rows from the "
                        "checkpoint store)" if not route
                        else "host top-k eigh (f64)")
    with stage("streaming_eigh_vectors"):
        e_k, v_k = pod_ops.eigh_desc_topk(C, k)
        e_full = pod_ops.eig_spectrum_desc(C)
    route["spectrum"] = "host eigvalsh (f64)"
    return top_k(e_full, e_k, v_k)


def write_snapshots_streaming(cfg, fields, filt, geom, dt: float,
                              rotate: bool = True, block: int = 512,
                              device="cuda"):
    """Verbose-mode per-step ``.prf`` snapshot export without holding A —
    regenerates blocks and writes columns as they appear."""
    from pods_digital_filter_tpu_torch.io import prf as prf_io

    block = min(block, cfg.nsteps)
    gen_block = make_generator(cfg, fields, filt, nsteps=block, rotate=rotate,
                               device=device)
    paths = []
    for t0 in _block_starts(cfg.nsteps, block):
        A = pod_ops.to_numpy(gen_block(t0)).astype(np.float64)
        A = A[:, :min(block, cfg.nsteps - t0)]
        for i in range(A.shape[1]):
            paths.append(prf_io.write_snapshot_prf(
                cfg.outdir, (t0 + i) * dt, A[:, i], geom,
                cfg.plane.normal, cfg.plane.origin))
    return paths
