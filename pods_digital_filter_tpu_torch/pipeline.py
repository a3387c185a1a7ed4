"""End-to-end pipeline: profile -> correlated noise -> Lund colouring ->
snapshot matrix -> POD -> Fourier compression -> PODFS export — port of
``pods_digital_filter_tpu/pipeline.py``: on one device in memory (with
``--checkpoint_dir``, resumable block by block) or out of core
(``--streaming_block``, :mod:`.streaming`); or over a ``('t', 's')`` mesh of
ranks (``--shard_time``/``--shard_space``, :mod:`.parallel`), in memory or
out of core.

``resolve_profile`` and ``_export_model`` are copies of the original's
(that module imports jax); the generator is an ``nn.Module`` whose buffers
hold the filter taps, the stress and mean fields, the rotation and an
optional centre.  With ``cfg.use_pallas`` the noise draw and spatial
filter run in the fused CUDA kernel (:mod:`.ops.fused_filter`), and in
float32 or bfloat16 the rest of the generation in the tail kernel
(:mod:`.ops.fused_tail`).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from pods_digital_filter_tpu_torch.config import PipelineConfig
from pods_digital_filter_tpu_torch.models import profiles as prof
from pods_digital_filter_tpu_torch.utils import timing
from pods_digital_filter_tpu_torch.utils.timing import StageTimer
from pods_digital_filter_tpu_torch.device import resolve_device, synchronize
from pods_digital_filter_tpu_torch.io import hdf5 as hdf5_io
from pods_digital_filter_tpu_torch.io import prf as prf_io
from pods_digital_filter_tpu_torch.io import vtk as vtk_io
from pods_digital_filter_tpu_torch.io.plane import PlaneGeometry, make_inflow_plane
from pods_digital_filter_tpu_torch.ops import (filters, fourier, fused_filter,
                                               fused_tail, pod, rotation)

_DTYPES = {"float32": torch.float32, "float64": torch.float64,
           "bfloat16": torch.bfloat16}


@dataclass
class PipelineResult:
    config: PipelineConfig
    dt: float
    geometry: PlaneGeometry
    # (3*Np, Ns) centred snapshot matrix, host — None on the streaming
    # and sharded paths, where A is never materialized on one device
    A: Optional[np.ndarray]
    mean_field: np.ndarray           # (3*Np,)
    pod: pod.PODResult
    fourier: fourier.FourierResult
    files: list = field(default_factory=list)
    timer: Optional[StageTimer] = None
    # the streaming path's eigen route (StreamingPODResult.route)
    eig_route: Optional[dict] = None
    # the sharded paths' parallel.mesh.Mesh (this rank's place and device)
    mesh: Optional[object] = None


def resolve_profile(cfg: PipelineConfig):
    """Copy of the original's ``resolve_profile`` (digitalfilters.py:1295-1310):
    synthetic tanh profiles, a 1-D column file, or a 2-D ``.prf`` file.

    Returns ``(fields, dt, filt, cfg, rotate)`` where ``fields`` is a
    :class:`PlaneStressFields`, ``filt`` the (possibly dt-rescaled)
    FilterConfig and ``rotate`` whether the packed snapshots get rotated into
    the plane frame (only for synthetic profiles, digitalfilters.py:1476-1477).
    """
    import dataclasses

    if cfg.profile_file != "none" and os.path.isfile(cfg.profile_file):
        if cfg.profile_file.endswith(".prf"):
            from pods_digital_filter_tpu_torch.models.prf_reader import read_prf

            r = read_prf(
                cfg.profile_file, cfg.plane.res, cfg.massflow, cfg.density,
                cfg.bulk_velocity, cfg.non_dim, cfg.test_gradients,
                outdir=cfg.outdir,
                make_plots=cfg.verbose,
            )
            plane = dataclasses.replace(
                cfg.plane, jma=r.jma, kma=r.kma, normal=r.normal, origin=r.center,
            )
            filt = dataclasses.replace(
                cfg.filt,
                length_scale_x=r.length_scale, length_scale_y=r.length_scale,
                length_scale_z=r.length_scale, nfx_override=None,
            )
            cfg = dataclasses.replace(cfg, plane=plane, filt=filt)
            fields = prof.fields_2d_prf(r.U, r.V, r.W, r.uu, r.vv, r.ww,
                                        r.uv, r.uw, r.vw)
            dt, filt = cfg.compute_dt(r.U, r.V, r.W)
            return fields, dt, filt, cfg, False
        else:
            from pods_digital_filter_tpu_torch.models.profile_1d import read_profile

            U, uu, vv, ww, uw = read_profile(cfg.profile_file, cfg.plane.kma)
    else:
        U, uu, vv, ww, uw = prof.build_profile(
            cfg.mean_profile, cfg.turb_profile, cfg.bulk_velocity,
            cfg.turbulence_intensity, cfg.plane.kma,
        )
    dt, filt = cfg.compute_dt(np.asarray(U))
    # clamp negative stresses (digitalfilters.py:1347-1354)
    uu, vv, ww = prof.clamp_negative_stresses(uu, vv, ww)
    fields = prof.plane_stress_fields(
        cfg.mean_profile, U, uu, vv, ww, uw,
        cfg.plane.jma, cfg.plane.kma, cfg.inner_d,
    )
    return fields, dt, filt, cfg, True


class InletGenerator(torch.nn.Module):
    """``forward(t0) -> (3*Np, nsteps)`` snapshots of the global time window
    ``[t0, t0 + nsteps)``: noise -> spatial filter -> temporal FIR -> Lund ->
    pack -> rotate (-> minus ``center``).

    ``use_fused`` selects the fused CUDA kernel for noise + spatial filter
    (Philox stream; bfloat16 taps when ``dtype`` is bfloat16, else float32,
    as the original's ``matmul_dtype``, ``pipeline.py:164-165``) and, in
    float32 or bfloat16, the tail kernel for FIR -> Lund -> pack -> rotate
    -> centre (:func:`.ops.fused_tail.fused_tail`, its plain chain on the
    CPU);
    otherwise the stages are torch products in ``dtype`` on a
    ``torch.Generator`` stream."""

    def __init__(self, *, seed: int, nsteps: int, jma: int, kma: int,
                 nfx: int, nfy: int, nfz: int, lnx: float, lny: float,
                 lnz: float, stresses, means, dtype=torch.float32,
                 use_fused: bool = False, rotation_matrix=None, center=None,
                 device="cuda"):
        super().__init__()
        device = torch.device(device)
        self.seed, self.nsteps = int(seed), int(nsteps)
        self.jma, self.kma = int(jma), int(kma)
        self.nfx, self.nfy, self.nfz = int(nfx), int(nfy), int(nfz)
        self.dtype, self.use_fused = dtype, bool(use_fused)
        self.matmul_dtype = (torch.bfloat16 if dtype == torch.bfloat16
                             else torch.float32)
        tap_dtype = torch.float32 if use_fused else dtype
        for name, n, ln in (("bx", nfx, lnx), ("by", nfy, lny), ("bz", nfz, lnz)):
            self.register_buffer(
                name, filters.gaussian_fir_coeffs(n, ln, tap_dtype, device))
        plane = lambda a: torch.as_tensor(
            np.asarray(a, dtype=np.float64), dtype=dtype,
            device=device).expand(jma, kma)
        self.register_buffer("stresses", torch.stack([plane(s) for s in stresses]))
        self.register_buffer("means", torch.stack([plane(m) for m in means]))
        self.register_buffer(
            "rotation", None if rotation_matrix is None else torch.as_tensor(
                rotation_matrix, dtype=dtype, device=device))
        self.register_buffer(
            "center", None if center is None else torch.as_tensor(
                center, dtype=dtype, device=device))

    @classmethod
    def from_numpy(cls, fields: prof.PlaneStressFields, filt, cfg: PipelineConfig,
                   device, nsteps: Optional[int] = None, rotate: bool = True,
                   center=None) -> "InletGenerator":
        """The JAX package's generator state — the numpy
        :class:`PlaneStressFields` its ``make_generator`` takes — on
        ``device``."""
        p = cfg.plane
        return cls(
            seed=cfg.seed, nsteps=cfg.nsteps if nsteps is None else nsteps,
            jma=p.jma, kma=p.kma, nfx=filt.nfx, nfy=filt.nfy, nfz=filt.nfz,
            lnx=filt.length_scale_x, lny=filt.length_scale_y,
            lnz=filt.length_scale_z, stresses=fields.stresses(),
            means=fields.means(), dtype=_DTYPES[cfg.dtype],
            use_fused=cfg.use_pallas,
            rotation_matrix=(rotation.profile_rotation_matrix(*p.normal)
                             if rotate else None),
            center=center, device=device)

    def forward(self, t0: int, noise: Optional[torch.Tensor] = None):
        """``noise`` (optional): the raw ``(3, nsteps + 2nfx, jma + 2nfy,
        kma + 2nfz)`` field to use instead of drawing one."""
        num_slabs = self.nsteps + 2 * self.nfx
        if self.use_fused:
            if noise is not None:
                noise = noise.to(torch.float32).contiguous()
            z = fused_filter.fused_spatial(self.seed, t0, num_slabs, self.jma,
                                           self.kma, self.by, self.bz, 3, noise,
                                           self.matmul_dtype)
            noise = None
            if self.dtype in fused_tail.DTYPES:
                # the slabs and the block are the only block-sized tensors
                # (streaming.gram_pass_hbm_estimate's fused_tail term)
                return fused_tail.fused_tail(z, self.bx, self.stresses,
                                             self.means, self.rotation,
                                             self.center)
            y = filters.filter_temporal(z, self.bx, axis=-3).to(self.dtype)
        else:
            if noise is None:
                noise = filters.noise_slabs(
                    self.seed, t0, num_slabs, self.jma + 2 * self.nfy,
                    self.kma + 2 * self.nfz, 3, self.dtype, self.bx.device)
            z = filters.filter_spatial(noise.to(self.dtype), self.by, self.bz,
                                       self.jma, self.kma)
            y = filters.filter_temporal(z, self.bx, axis=-3)
        # drop the slabs once the FIR has consumed them: at most three
        # block-sized tensors coexist (the slabs, the FIR's input copy and
        # its output; later y, its colouring and the pack), the transient
        # term of streaming.gram_pass_hbm_estimate
        del z, noise
        return fused_tail.colour_pack(y, self.stresses, self.means,
                                      self.rotation, self.center)


def make_generator(cfg: PipelineConfig, fields: prof.PlaneStressFields, filt,
                   nsteps: Optional[int] = None, rotate: bool = True,
                   center=None, device="cuda") -> InletGenerator:
    """``gen(t0) -> (3*Np, nsteps)``; ``center`` (a ``(3*Np,)`` mean vector)
    is subtracted inside the generator."""
    return InletGenerator.from_numpy(fields, filt, cfg, device, nsteps=nsteps,
                                     rotate=rotate, center=center)


def generate_snapshot_matrix(cfg: PipelineConfig, fields, filt, t0: int = 0,
                             nsteps: Optional[int] = None, rotate: bool = True,
                             device="cuda") -> torch.Tensor:
    """The generation hot path: noise -> spatial filter -> temporal FIR ->
    Lund -> pack -> rotate."""
    return make_generator(cfg, fields, filt, nsteps=nsteps, rotate=rotate,
                          device=device)(t0)


def run_pipeline(cfg: PipelineConfig, device="cuda",
                 write_outputs: bool = True) -> PipelineResult:
    """The run on ``device``: in memory, or out of core with
    ``cfg.streaming_block``; with ``cfg.shard_time * cfg.shard_space > 1``
    over the mesh of the job's ranks (every rank calls this; the process
    group must be initialised with that world size, else ``ValueError``
    names the launchers — :data:`.parallel.mesh.LAUNCHERS`).  In a job of
    several ranks only rank 0 writes files."""
    import torch.distributed as dist

    cfg.validate()
    mesh = None
    if cfg.shard_time * cfg.shard_space > 1:
        from pods_digital_filter_tpu_torch.parallel.mesh import make_mesh

        mesh = make_mesh(cfg.shard_time, cfg.shard_space, device)
        dev, lead = mesh.device, mesh.lead
    else:
        dev = resolve_device(device)
        lead = not dist.is_initialized() or dist.get_rank() == 0
    timer = StageTimer()
    files = []

    with timer.stage("profile"):
        fields, dt, filt, cfg, rotate = resolve_profile(cfg)
        cfg.validate()   # a .prf profile may have replaced plane dims
        if cfg.dt == 0.0 and lead:
            print("timestep set to: ", dt, " seconds")

    geom = make_inflow_plane(cfg.plane)
    outdir = cfg.outdir
    if write_outputs and lead:
        os.makedirs(outdir, exist_ok=True)

    # the sharded paths run collectives on their snapshot writers: every
    # rank runs them, and only rank 0 writes
    if mesh is None:
        write_outputs = write_outputs and lead
    if cfg.streaming_block:
        return _run_pipeline_streaming(cfg, fields, dt, filt, rotate, geom,
                                       timer, files, write_outputs, dev, mesh)
    if mesh is not None:
        return _run_pipeline_sharded(cfg, fields, dt, filt, rotate, geom,
                                     timer, files, write_outputs, mesh)

    with timer.stage("generate"):
        if cfg.checkpoint_dir != "none":
            from pods_digital_filter_tpu_torch.utils.checkpoint import (
                generate_with_checkpoints)

            A = torch.as_tensor(generate_with_checkpoints(
                cfg, fields, filt, cfg.checkpoint_dir,
                block=cfg.checkpoint_block or None, rotate=rotate,
                device=dev), device=dev).to(_DTYPES[cfg.dtype])
        else:
            A = generate_snapshot_matrix(cfg, fields, filt, rotate=rotate,
                                         device=dev)
        synchronize(dev)

    if cfg.verbose and write_outputs:
        with timer.stage("write_snapshots"):
            A_host = pod.to_numpy(A).astype(np.float64)
            for i in range(cfg.nsteps):
                files.append(prf_io.write_snapshot_prf(
                    outdir, i * dt, A_host[:, i], geom,
                    cfg.plane.normal, cfg.plane.origin))
            del A_host

    with timer.stage("pod"):
        mean_field, Ac, C = pod.center_and_gram(A)
        del A
        pr = pod.snapshot_pod(Ac, cfg.podfs.num_modes, cfg.podfs.tol_cn,
                              gram=C, defer_spatial=True)

    with timer.stage("fourier"):
        fr = fourier.fourier_compress(
            pr.temporal_modes, pr.num_trunc, dt, cfg.podfs.energy_target)

    with timing.span("pipeline.resolve_spatial"):
        pod.resolve_spatial(pr)
    mean_host = pod.to_numpy(mean_field).astype(np.float64)

    if write_outputs:
        with timer.stage("export"):
            _export_model(cfg, geom, pr, fr, mean_host, dt, files, device=dev)

    with timing.span("pipeline.result_to_host"):
        A_host = pod.to_numpy(Ac)
    timing.count("pipeline.result_to_host_bytes", A_host.nbytes)
    return PipelineResult(
        config=cfg, dt=dt, geometry=geom,
        A=A_host, mean_field=mean_host,
        pod=pr, fourier=fr, files=files, timer=timer,
    )


def _export_model(cfg, geom, pr, fr, mean_host, dt, files, device="cuda"):
    """Copy of the original's model export (PODFS.py:1341-1362 layout),
    shared by every path.

    Under ``cfg.verbose`` the POD plots' spectra are computed on
    ``device``; a plotting error fails the run, and only a host without
    matplotlib skips the plots (the original prints and goes on after any
    exception)."""
    outdir = cfg.outdir
    files.append(prf_io.write_eigenvalues(outdir, pr.num_valid, pr.energy))
    files.append(prf_io.write_mean_prf(outdir, mean_host, geom, cfg.plane.normal))
    # the reference always writes the mean-field VTK on the POD main
    # path (PODFS.py:1341) and the per-mode VTKs under verbose
    # (PODFS.py:1356-1362)
    files.append(vtk_io.write_mean_field_vtk(outdir, mean_host, geom))
    if cfg.verbose:
        files.extend(vtk_io.write_spatial_modes_vtk(
            outdir, pr.spatial_modes, geom, pr.num_trunc))
    files.append(prf_io.write_podfs_dat(outdir, fr))
    for i in range(pr.num_trunc):
        files.append(prf_io.write_mode_prf(
            outdir, i + 1, pr.spatial_modes[:, i], geom, cfg.plane.normal))
    if cfg.verbose:
        files.extend(prf_io.write_temporal_modes(
            outdir, min(pr.num_valid, pr.temporal_modes.shape[1]), dt,
            pr.temporal_modes))
        from pods_digital_filter_tpu_torch.diagnostics import load_plots

        plots = load_plots("the POD plots")
        if plots is not None:
            plots.pod_diagnostics(outdir, pr, fr, dt, device=device)
    if cfg.hdf5:
        files.append(hdf5_io.write_hdf5(
            outdir, pr.num_trunc, fr.period, fr.counts,
            fr.packed_fc(), geom.cell_centers, mean_host,
            pr.spatial_modes))
    return files


def _model_tail(cfg, geom, dt, timer, files, write_outputs, pr, mean_host,
                dev, eig_route=None, mesh=None):
    """The tail of the sharded and streaming paths after their POD: the
    Fourier compression, the model export (on a mesh by rank 0 alone), and
    the :class:`PipelineResult` (``A`` None)."""
    with timer.stage("fourier"):
        fr = fourier.fourier_compress(
            pr.temporal_modes, pr.num_trunc, dt, cfg.podfs.energy_target)
    if write_outputs and (mesh is None or mesh.lead):
        with timer.stage("export"):
            _export_model(cfg, geom, pr, fr, mean_host, dt, files,
                          device=dev)
    return PipelineResult(
        config=cfg, dt=dt, geometry=geom,
        A=None, mean_field=mean_host,
        pod=pr, fourier=fr, files=files, timer=timer, eig_route=eig_route,
        mesh=mesh,
    )


def _run_pipeline_streaming(cfg, fields, dt, filt, rotate, geom, timer,
                            files, write_outputs, dev, mesh):
    """Out-of-core pipeline tail: the snapshot matrix is never
    materialized — POD runs over regenerated blocks (:mod:`.streaming`),
    or with a ``mesh`` over blocks split across its ranks, the Gram
    reduced across them (:mod:`.parallel.streaming`).  Resumable with
    ``--checkpoint_dir``."""
    pod_args = dict(rotate=rotate, block=cfg.streaming_block,
                    num_modes_trunc=cfg.podfs.num_modes,
                    tol_cn=cfg.podfs.tol_cn, verbose=cfg.verbose, timer=timer)
    if mesh is None:
        from pods_digital_filter_tpu_torch import streaming

        with timer.stage("streaming_pod"):
            sp = streaming.streaming_pod(cfg, fields, filt, device=dev,
                                         **pod_args)
        write_snapshots = lambda: streaming.write_snapshots_streaming(
            cfg, fields, filt, geom, dt, rotate=rotate,
            block=cfg.streaming_block, device=dev)
    else:
        from pods_digital_filter_tpu_torch.parallel import \
            streaming as shard_streaming

        with timer.stage("sharded_streaming_pod"):
            sp = shard_streaming.streaming_pod_sharded(cfg, fields, filt,
                                                       mesh, **pod_args)
        write_snapshots = lambda: \
            shard_streaming.write_snapshots_sharded_streaming(
                cfg, fields, filt, mesh, geom, dt, rotate=rotate,
                block=cfg.streaming_block)

    if cfg.verbose and write_outputs:
        with timer.stage("write_snapshots"):
            files.extend(write_snapshots())

    return _model_tail(cfg, geom, dt, timer, files, write_outputs, sp.pod,
                       sp.mean_field, dev, sp.route, mesh)


def _run_pipeline_sharded(cfg, fields, dt, filt, rotate, geom, timer,
                          files, write_outputs, mesh):
    """Mesh-sharded pipeline tail: generation over the ``('t', 's')`` mesh
    (the exact per-slab path — the serial values up to the rounding of the
    tile-width products — or the halo-exchange path under ``--halo``), one
    window at a time into the rank's tile, and the distributed POD of
    :mod:`.parallel.pod`, which centres the tile in place (so ``-v`` writes
    the snapshots before it).

    ``PipelineResult.A`` is ``None``: the snapshot matrix stays split over
    the ranks and is never gathered (at the flagship scale it would not
    fit — the point of sharding)."""
    from pods_digital_filter_tpu_torch.parallel import pod as dist_pod
    from pods_digital_filter_tpu_torch.parallel import streaming as shard_streaming

    with timer.stage("generate_sharded"):
        X = shard_streaming.generate_tile(cfg, fields, filt, mesh,
                                          rotate=rotate)
        synchronize(mesh.device)

    if cfg.verbose and write_outputs:
        with timer.stage("write_snapshots"):
            files.extend(shard_streaming.write_snapshot_tiles(
                cfg, geom, dt, X, mesh))

    with timer.stage("pod"):
        dp = dist_pod.distributed_pod(X, mesh, cfg.podfs.num_modes,
                                      cfg.podfs.tol_cn,
                                      keep_basis=cfg.verbose)
        del X
        pr = pod.PODResult(
            energy=dp.energy,
            temporal_modes=(dp.temporal_modes if dp.temporal_basis is None
                            else dp.temporal_basis),
            spatial_modes=dp.spatial_modes_packed(),
            num_valid=dp.num_valid, num_trunc=dp.num_trunc)
        mean_host = dp.mean_packed()

    return _model_tail(cfg, geom, dt, timer, files, write_outputs, pr,
                       mean_host, mesh.device, mesh=mesh)
