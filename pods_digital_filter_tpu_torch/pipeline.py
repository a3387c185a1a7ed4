"""End-to-end pipeline: profile -> correlated noise -> Lund colouring ->
snapshot matrix -> POD -> Fourier compression -> PODFS export — port of
``pods_digital_filter_tpu/pipeline.py`` on one device: in memory (with
``--checkpoint_dir``, resumable block by block) or out of core
(``--streaming_block``, :mod:`.streaming`).

``resolve_profile`` and ``_export_model`` are copies of the original's
(that module imports jax); the generator is an ``nn.Module`` whose buffers
hold the filter taps, the stress and mean fields, the rotation and an
optional centre.  With ``cfg.use_pallas`` the noise draw and spatial
filter run in the fused CUDA kernel (:mod:`.ops.fused_filter`).

The sharded (``--shard_time``/``--shard_space``) and multi-host modes are
slice 5 of the port and raise here.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from pods_digital_filter_tpu_torch.config import PipelineConfig
from pods_digital_filter_tpu_torch.models import profiles as prof
from pods_digital_filter_tpu_torch.utils.timing import StageTimer
from pods_digital_filter_tpu_torch.device import resolve_device, synchronize
from pods_digital_filter_tpu_torch.io import hdf5 as hdf5_io
from pods_digital_filter_tpu_torch.io import prf as prf_io
from pods_digital_filter_tpu_torch.io import vtk as vtk_io
from pods_digital_filter_tpu_torch.io.plane import PlaneGeometry, make_inflow_plane
from pods_digital_filter_tpu_torch.ops import (filters, fourier, fused_filter,
                                               lund, pod, rotation)

_DTYPES = {"float32": torch.float32, "float64": torch.float64,
           "bfloat16": torch.bfloat16}


@dataclass
class PipelineResult:
    config: PipelineConfig
    dt: float
    geometry: PlaneGeometry
    # (3*Np, Ns) centred snapshot matrix, host — None on the streaming
    # path, where A is never materialized
    A: Optional[np.ndarray]
    mean_field: np.ndarray           # (3*Np,)
    pod: pod.PODResult
    fourier: fourier.FourierResult
    files: list = field(default_factory=list)
    timer: Optional[StageTimer] = None
    # the streaming path's eigen route (StreamingPODResult.route)
    eig_route: Optional[dict] = None
    # run_pipeline(defer_finalize=True) on the streaming path: the full
    # spectrum is still resolving in a worker thread; finalize() joins it,
    # redoes Fourier/export if the valid-mode count shrank, and writes the
    # eigenvalue file
    _finalize: Optional[object] = None

    @property
    def finalize_pending(self) -> bool:
        return self._finalize is not None

    def finalize(self) -> "PipelineResult":
        """Join a deferred spectrum and complete the model export (no-op
        when nothing was deferred)."""
        if self._finalize is not None:
            fin, self._finalize = self._finalize, None
            fin()
        return self


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


def _pack_snapshots(colored: torch.Tensor) -> torch.Tensor:
    """(3, Ns, jma, kma) -> (3*jma*kma, Ns) with the reference's row layout
    ``row = comp*Np + j*kma + k`` (digitalfilters.py:1471-1473)."""
    c, ns, jma, kma = colored.shape
    return colored.permute(0, 2, 3, 1).reshape(c * jma * kma, ns)


class InletGenerator(torch.nn.Module):
    """``forward(t0) -> (3*Np, nsteps)`` snapshots of the global time window
    ``[t0, t0 + nsteps)``: noise -> spatial filter -> temporal FIR -> Lund ->
    pack -> rotate (-> minus ``center``).

    ``use_fused`` selects the fused CUDA kernel for noise + spatial filter
    (Philox stream; bfloat16 taps when ``dtype`` is bfloat16, else float32,
    as the original's ``matmul_dtype``, ``pipeline.py:164-165``); otherwise
    the stages are torch products in ``dtype`` on a ``torch.Generator``
    stream."""

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
            y = filters.filter_temporal(z, self.bx, axis=-3).to(self.dtype)
        else:
            if noise is None:
                noise = filters.noise_slabs(
                    self.seed, t0, num_slabs, self.jma + 2 * self.nfy,
                    self.kma + 2 * self.nfz, 3, self.dtype, self.bx.device)
            z = filters.filter_spatial(noise.to(self.dtype), self.by, self.bz,
                                       self.jma, self.kma)
            y = filters.filter_temporal(z, self.bx, axis=-3)
        # drop each block-sized intermediate once consumed: at most three
        # coexist (the slabs, the FIR's input copy and its output), the
        # transient term of streaming.gram_pass_hbm_estimate
        del z, noise
        A = _pack_snapshots(lund.apply_lund_stacked(y, self.stresses, self.means))
        del y
        if self.rotation is not None:
            A = rotation.apply_rotation_packed(A, self.rotation)
        if self.center is not None:
            A = A - self.center[:, None]
        return A


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


def _check_supported(cfg: PipelineConfig) -> None:
    if cfg.shard_time * cfg.shard_space > 1:
        raise NotImplementedError(
            "--shard_time/--shard_space are slice 5 of the port (ROADMAP.md, "
            "queue A item 11); run them with the JAX package")


def run_pipeline(cfg: PipelineConfig, device="cuda",
                 write_outputs: bool = True,
                 defer_finalize: bool = False) -> PipelineResult:
    """The single-device run on ``device``: in memory, or out of core with
    ``cfg.streaming_block``.

    ``defer_finalize=True`` (streaming path): return while the deferred
    full spectrum still runs in its worker thread — every model file is
    written except ``POD.eigenvalues.dat``; the caller overlaps independent
    host work and then calls ``result.finalize()``."""
    cfg.validate()
    _check_supported(cfg)
    dev = resolve_device(device)
    timer = StageTimer()
    files = []

    with timer.stage("profile"):
        fields, dt, filt, cfg, rotate = resolve_profile(cfg)
        cfg.validate()   # a .prf profile may have replaced plane dims
        if cfg.dt == 0.0:
            print("timestep set to: ", dt, " seconds")

    geom = make_inflow_plane(cfg.plane)
    outdir = cfg.outdir
    if write_outputs:
        os.makedirs(outdir, exist_ok=True)

    if cfg.streaming_block:
        return _run_pipeline_streaming(cfg, fields, dt, filt, rotate, geom,
                                       timer, files, write_outputs,
                                       defer_finalize, dev)

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

    pod.resolve_spatial(pr)
    mean_host = pod.to_numpy(mean_field).astype(np.float64)

    if write_outputs:
        with timer.stage("export"):
            _export_model(cfg, geom, pr, fr, mean_host, dt, files, device=dev)

    return PipelineResult(
        config=cfg, dt=dt, geometry=geom,
        A=pod.to_numpy(Ac), mean_field=mean_host,
        pod=pr, fourier=fr, files=files, timer=timer,
    )


def _export_model(cfg, geom, pr, fr, mean_host, dt, files,
                  defer_eigenvalues: bool = False, device="cuda"):
    """Copy of the original's model export (PODFS.py:1341-1362 layout),
    shared by the in-memory and streaming paths.

    ``defer_eigenvalues``: skip the eigenvalue file — the streaming path
    writes it after the deferred spectrum resolves (the only export that
    consumes the full spectrum).  Under ``cfg.verbose`` the POD plots'
    spectra are computed on ``device``; a plotting error fails the run, and
    only a host without matplotlib skips the plots (the original prints and
    goes on after any exception)."""
    outdir = cfg.outdir
    if not defer_eigenvalues:
        files.append(prf_io.write_eigenvalues(outdir, pr.num_valid,
                                              pr.energy))
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


def _unlink_stale_mode_files(outdir: str, keep: int):
    """Delete per-mode artifacts with index > ``keep``.

    On the deferred-spectrum shrink-redo path the optimistic export wrote
    mode files beyond the final truncation (columns scaled by invalid
    eigenvalues); the re-export writes fewer, so the orphans are removed
    for the directory to equal a full-eig run's.  The verbose-only temporal
    ``.dat`` and spatial ``.vtk`` per-mode files are swept too."""
    import glob
    import re

    for pattern, rx in (
        ("PODFS_mode_*.prf", r"PODFS_mode_(\d+)\.prf$"),
        ("POD.temporal_mode_*.dat", r"POD\.temporal_mode_(\d+)\.dat$"),
        ("POD.spatial_mode_*.vtk", r"_(\d+)\.vtk$"),
    ):
        for path in glob.glob(os.path.join(outdir, pattern)):
            m = re.search(rx, path)
            if m and int(m.group(1)) > keep:
                os.unlink(path)


def _make_spectrum_finalizer(cfg, sp, result, geom, dt, timer, write, dev):
    """The deferred-spectrum completion of the streaming tail: join the
    spectrum worker; if the final valid-mode count shrank below the
    optimistic truncation, redo Fourier compression and the model export
    (removing now-stale mode files); write the eigenvalue file."""
    def fin():
        with timer.stage("streaming_eigh_spectrum"):
            shrank = sp.resolve()
        pr = result.pod
        if shrank:
            with timer.stage("fourier"):
                result.fourier = fourier.fourier_compress(
                    pr.temporal_modes, pr.num_trunc, dt,
                    cfg.podfs.energy_target)
            if write:
                with timer.stage("export"):
                    result.files.clear()
                    _unlink_stale_mode_files(cfg.outdir, pr.num_trunc)
                    _export_model(cfg, geom, pr, result.fourier,
                                  result.mean_field, dt, result.files,
                                  defer_eigenvalues=True, device=dev)
        if write:
            result.files.append(prf_io.write_eigenvalues(
                cfg.outdir, pr.num_valid, pr.energy))
    return fin


def _run_pipeline_streaming(cfg, fields, dt, filt, rotate, geom, timer,
                            files, write_outputs, defer_finalize, dev):
    """Out-of-core pipeline tail: the snapshot matrix is never
    materialized — POD runs over regenerated blocks (streaming.py).
    ``PipelineResult.A`` is ``None``."""
    from pods_digital_filter_tpu_torch import streaming

    with timer.stage("streaming_pod"):
        # defer_spectrum: on the two-phase eig path the full spectrum keeps
        # running in a worker thread while Fourier compression and the
        # exports below execute; resolve() finalizes it
        sp = streaming.streaming_pod(
            cfg, fields, filt, rotate=rotate, block=cfg.streaming_block,
            num_modes_trunc=cfg.podfs.num_modes, tol_cn=cfg.podfs.tol_cn,
            verbose=cfg.verbose, timer=timer, defer_spectrum=True,
            device=dev)
    pr = sp.pod
    mean_host = sp.mean_field

    if cfg.verbose and write_outputs:
        with timer.stage("write_snapshots"):
            files.extend(streaming.write_snapshots_streaming(
                cfg, fields, filt, geom, dt, rotate=rotate,
                block=cfg.streaming_block, device=dev))

    with timer.stage("fourier"):
        fr = fourier.fourier_compress(
            pr.temporal_modes, pr.num_trunc, dt, cfg.podfs.energy_target)

    deferred = sp.spectrum_pending
    if write_outputs:
        with timer.stage("export"):
            _export_model(cfg, geom, pr, fr, mean_host, dt, files,
                          defer_eigenvalues=deferred, device=dev)

    result = PipelineResult(
        config=cfg, dt=dt, geometry=geom,
        A=None, mean_field=mean_host,
        pod=pr, fourier=fr, files=files, timer=timer, eig_route=sp.route,
    )
    if deferred:
        result._finalize = _make_spectrum_finalizer(
            cfg, sp, result, geom, dt, timer, write_outputs, dev)
        if not defer_finalize:
            result.finalize()
    return result
