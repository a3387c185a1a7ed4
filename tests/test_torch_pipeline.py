"""The port's slice as a whole (pods_digital_filter_tpu_torch/pipeline.py):
the generator against the JAX chain on the same raw noise, the model
files against the JAX export from the same snapshot matrix, and
end-to-end runs on the CPU mirroring tests/test_pipeline.py."""

import os

import numpy as np
import pytest
import torch

from torch_parity import np_of, to_jax, uniform_noise  # noqa: I001

from pods_digital_filter_tpu import config as jconfig
from pods_digital_filter_tpu import replay
from pods_digital_filter_tpu_torch import config as tconfig
from pods_digital_filter_tpu_torch import pipeline as tpipe
from pods_digital_filter_tpu_torch.io import hdf5 as thdf5
from pods_digital_filter_tpu_torch.io import prf as tprf
from pods_digital_filter_tpu_torch.ops import fused_filter
from pods_digital_filter_tpu_torch.ops import pod as tpod
from pods_digital_filter_tpu_torch.ops import fourier as tfourier


def small_config(tmp_path, side="torch", plane=None, filt=None, podfs=None,
                 **kw):
    """A small configuration built from ``side``'s own package (``torch``:
    the port's copy of the config module, ``jax``: the original); ``plane``,
    ``filt`` and ``podfs`` are the keyword arguments of its parts."""
    c = tconfig if side == "torch" else jconfig
    defaults = dict(
        plane=c.PlaneConfig(**(plane or dict(jma=10, kma=11, res=0.1))),
        filt=c.FilterConfig(**(filt or dict(
            length_scale_x=2.0, length_scale_y=2.0, length_scale_z=2.0,
            fwidth=2.0))),
        podfs=c.PODFSConfig(**(podfs or dict(num_modes=5,
                                             energy_target=0.9))),
        nsteps=8, outdir=str(tmp_path / "PODFS"), dtype="float64",
        hdf5=True, verbose=True,
    )
    defaults.update(kw)
    return c.PipelineConfig(**defaults)


def _pallas_bf16_spatial(noise, filt, p):
    """The JAX main path's bf16-tap spatial filter on given noise: the Pallas
    body ``_kernel_body_noise_in`` in interpret mode with bfloat16 ``BzT``
    and ``ByM`` (``pipeline.py:164-165`` -> ``pallas_filter.py:553-577``),
    float32 out."""
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    from pods_digital_filter_tpu.ops import filters
    from pods_digital_filter_tpu.ops import pallas_filter as pf

    taps = lambda n, ln: filters.gaussian_fir_coeffs(n, ln, jnp.float32)
    BzT = filters.toeplitz_band(taps(filt.nfz, filt.length_scale_z),
                                p.kma).T.astype(jnp.bfloat16)
    ByM = filters.toeplitz_band(taps(filt.nfy, filt.length_scale_y),
                                p.jma).astype(jnp.bfloat16)
    c, s, jn, kn = noise.shape
    out = pl.pallas_call(
        pf._kernel_body_noise_in, grid=(c * s,),
        in_specs=[pl.BlockSpec((1, jn, kn), lambda i: (i, 0, 0)),
                  pl.BlockSpec((kn, p.kma), lambda i: (0, 0)),
                  pl.BlockSpec((p.jma, jn), lambda i: (0, 0))],
        out_specs=pl.BlockSpec((1, p.jma, p.kma), lambda i: (i, 0, 0)),
        out_shape=jax.ShapeDtypeStruct((c * s, p.jma, p.kma), jnp.float32),
        interpret=pltpu.InterpretParams(),
    )(jnp.asarray(noise, jnp.float32).reshape(c * s, jn, kn), BzT, ByM)
    return out.reshape(c, s, p.jma, p.kma)


def _jax_chain(noise, cfg):
    """The JAX package's generation chain on its own configuration,
    composed from its public functions: resolve_profile -> filter_spatial
    -> filter_temporal -> apply_lund_stacked -> _pack_snapshots ->
    rotate_velocity_packed.  With ``--pallas`` and bfloat16 the spatial
    filter is the fused kernel's bf16-tap body and the temporal FIR runs in
    float32, as ``generate_correlated_noise_fused`` does."""
    import jax.numpy as jnp

    from pods_digital_filter_tpu.ops import filters, lund, rotation
    from pods_digital_filter_tpu.pipeline import _pack_snapshots, resolve_profile

    fields, _, filt, cfg, rotate = resolve_profile(cfg)
    assert rotate
    dt = jnp.dtype(cfg.dtype)
    p = cfg.plane
    taps = lambda n, ln: filters.gaussian_fir_coeffs(n, ln, dt)
    if cfg.use_pallas and cfg.dtype == "bfloat16":
        z = _pallas_bf16_spatial(noise, filt, p)
        bx = filters.gaussian_fir_coeffs(filt.nfx, filt.length_scale_x,
                                         jnp.float32)
        y = filters.filter_temporal(z, bx, axis=-3).astype(dt)
    else:
        z = filters.filter_spatial(jnp.asarray(noise, dt),
                                   taps(filt.nfy, filt.length_scale_y),
                                   taps(filt.nfz, filt.length_scale_z),
                                   p.jma, p.kma)
        y = filters.filter_temporal(z, taps(filt.nfx, filt.length_scale_x),
                                    axis=-3)
    colored = lund.apply_lund_stacked(
        y, tuple(jnp.asarray(s, dt) for s in fields.stresses()),
        tuple(jnp.asarray(m, dt) for m in fields.means()))
    A = _pack_snapshots(colored)
    return np.asarray(rotation.rotate_velocity_packed(A, *p.normal) if rotate
                      else A)


@pytest.mark.parametrize("dtype,use_pallas,atol", [
    ("float64", False, 1e-12), ("float32", False, 2e-6),
    ("float32", True, 2e-6), ("bfloat16", True, 2.0 ** -7)])
@pytest.mark.parametrize("profile", ["hyperbolic-tangent",
                                     "double-hyperbolic-tangent"])
def test_generator_matches_jax_chain(tmp_path, dtype, use_pallas, atol, profile):
    """InletGenerator.forward(t0, noise) == the JAX chain on the same raw
    noise, on a tilted plane (normal (1, 0.3, 0.2)).

    bfloat16 with ``--pallas`` holds the port's bf16-tap K1 (plain version)
    against the Pallas body with bf16 tap matrices.  The two sum t in
    different orders, so an element of t, and then an element of the bf16
    output, may round to its neighbouring bf16 value: the bound is one bf16
    ulp of the largest output (|A| < 2 here, so 2^-7), in at most 1 % of
    the elements.  Measured: no element differs.  With float32 taps (the
    port before the repair) 17 % of the elements differ by that ulp."""
    kw = dict(dtype=dtype, use_pallas=use_pallas, mean_profile=profile,
              turbulence_intensity=0.1,
              plane=dict(jma=9, kma=12, res=0.1, normal=(1.0, 0.3, 0.2)))
    cfg = small_config(tmp_path, **kw)
    fields, _, filt, cfg, rotate = tpipe.resolve_profile(cfg)
    assert rotate
    p = cfg.plane
    np_dt = np.float64 if dtype == "float64" else np.float32
    noise = uniform_noise(np.random.default_rng(31),
                          (3, cfg.nsteps + 2 * filt.nfx, p.jma + 2 * filt.nfy,
                           p.kma + 2 * filt.nfz), np_dt)
    gen = tpipe.InletGenerator.from_numpy(fields, filt, cfg, "cpu")
    got = gen(5, noise=torch.as_tensor(noise))
    want = _jax_chain(noise, small_config(tmp_path, "jax", **kw))
    assert got.dtype == getattr(torch, dtype) and str(want.dtype) == dtype
    assert got.shape == (3 * p.num_points, cfg.nsteps)
    got, want = np_of(got.to(torch.float32)), np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)
    if dtype == "bfloat16":
        assert np.abs(want).max() < 2.0
        assert np.mean(got != want) <= 0.01


def test_generator_center_and_windows(tmp_path):
    """``center`` is subtracted inside the generator, and every window of
    the counter-keyed streams is reproducible on its own."""
    for use_pallas in (False, True):
        cfg = small_config(tmp_path, nsteps=12, use_pallas=use_pallas)
        fields, _, filt, cfg, _ = tpipe.resolve_profile(cfg)
        full = np_of(tpipe.make_generator(cfg, fields, filt, device="cpu")(0))
        part = np_of(tpipe.make_generator(cfg, fields, filt, nsteps=4,
                                         device="cpu")(8))
        np.testing.assert_allclose(part, full[:, 8:], atol=1e-6)
        c = full.mean(axis=1)
        centred = tpipe.make_generator(cfg, fields, filt, center=c,
                                         device="cpu")(0)
        np.testing.assert_allclose(np_of(centred), full - c[:, None],
                                   atol=1e-12)


def _prf_rows(path):
    with open(path) as f:
        lines = f.readlines()
    return lines[:11], replay.read_field_prf(str(path))


def test_model_files_match_jax_export(tmp_path):
    """From one snapshot matrix, the port's POD + Fourier + export writes
    the model JAX's center_and_gram + snapshot_pod + fourier_compress +
    _export_model writes (float64): mean .prf and eigenvalues to rtol
    1e-10, headers byte-equal, PODFS.dat and mode files equal after
    per-mode sign alignment (atol 1e-8)."""
    from pods_digital_filter_tpu.io.plane import make_inflow_plane as jplane
    from pods_digital_filter_tpu.ops import fourier as jfourier
    from pods_digital_filter_tpu.ops import pod as jpod
    from pods_digital_filter_tpu.pipeline import _export_model as jexport

    kw = dict(verbose=False, hdf5=False, nsteps=24,
              podfs=dict(num_modes=6, energy_target=0.9))
    cfg = small_config(tmp_path, **kw)
    fields, dt, filt, cfg, _ = tpipe.resolve_profile(cfg)
    A = np_of(tpipe.make_generator(cfg, fields, filt, device="cpu")(0))

    out = {}
    for side in ("jax", "torch"):
        d = tmp_path / side
        os.makedirs(d)
        c = small_config(tmp_path, side, outdir=str(d), **kw)
        if side == "jax":
            mean, Ac, C = jpod.center_and_gram(to_jax(A, np.float64))
            pr = jpod.snapshot_pod(Ac, 6, gram=C)
            fr = jfourier.fourier_compress(pr.temporal_modes, pr.num_trunc,
                                           dt, 0.9)
            jexport(c, jplane(c.plane), pr, fr, np.asarray(mean), dt, [])
        else:
            mean, Ac, C = tpod.center_and_gram(torch.as_tensor(A))
            pr = tpod.snapshot_pod(Ac, 6, gram=C)
            fr = tfourier.fourier_compress(pr.temporal_modes, pr.num_trunc,
                                           dt, 0.9)
            tpipe._export_model(c, tpipe.make_inflow_plane(c.plane), pr, fr,
                                np_of(mean), dt, [])
        out[side] = (d, pr)

    (dj, prj), (dt_, prt) = out["jax"], out["torch"]
    assert sorted(os.listdir(dj)) == sorted(os.listdir(dt_))
    hj, (pts_j, mean_j) = _prf_rows(dj / "PODFS_mean.prf")
    ht, (pts_t, mean_t) = _prf_rows(dt_ / "PODFS_mean.prf")
    assert hj == ht
    np.testing.assert_array_equal(pts_t, pts_j)
    np.testing.assert_allclose(mean_t, mean_j, rtol=1e-10, atol=1e-12)

    ej = np.loadtxt(dj / "POD.eigenvalues.dat")
    et = np.loadtxt(dt_ / "POD.eigenvalues.dat")
    assert et.shape == ej.shape
    np.testing.assert_array_equal(et[:, 0], ej[:, 0])
    # eigenvalues are backward-stable to ~eps * ||C||: the near-zero tail
    # gets an absolute bound scaled by the largest (the condition-number
    # column, sqrt(|e_i / e_0|), amplifies that tail and is not compared)
    np.testing.assert_allclose(et[:, 1], ej[:, 1], rtol=1e-10,
                               atol=1e-12 * ej[0, 1])

    per_j, modes_j = tprf.read_podfs_dat(str(dj / "PODFS.dat"))
    per_t, modes_t = tprf.read_podfs_dat(str(dt_ / "PODFS.dat"))
    assert per_t == per_j and len(modes_t) == len(modes_j) == prt.num_trunc
    for i in range(prt.num_trunc):
        name = "PODFS_mode_%04d.prf" % (i + 1)
        hj, (_, phi_j) = _prf_rows(dj / name)
        ht, (_, phi_t) = _prf_rows(dt_ / name)
        assert hj == ht
        s = np.sign(np.sum(phi_t * phi_j))
        np.testing.assert_allclose(s * phi_t, phi_j, atol=1e-8)
        fj = modes_j[i][np.argsort(modes_j[i][:, 0])]
        ft = modes_t[i][np.argsort(modes_t[i][:, 0])]
        np.testing.assert_array_equal(ft[:, 0], fj[:, 0])
        np.testing.assert_allclose(s * ft[:, 1:], fj[:, 1:], atol=1e-8)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_mwe_end_to_end(tmp_path, use_pallas):
    cfg = small_config(tmp_path, use_pallas=use_pallas)
    res = tpipe.run_pipeline(cfg, device="cpu")
    out = cfg.outdir
    for name in ("PODFS.dat", "PODFS_mean.prf", "POD.eigenvalues.dat",
                 "PODFS.hdf5", "0.00000E+00.prf", "POD.temporal_mode_0001.dat",
                 "POD.spatial_mean_field_velocity.vtk"):
        assert os.path.exists(os.path.join(out, name)), name
    for i in range(res.pod.num_trunc):
        assert os.path.exists(os.path.join(out, "PODFS_mode_%4.4i.prf" % (i + 1)))
    assert res.dt > 0
    e = res.pod.energy[: res.pod.num_valid]
    assert np.all(np.diff(e) <= 1e-12) and np.all(e > 0)
    assert res.A.shape == (3 * cfg.plane.num_points, cfg.nsteps)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_podfs_replay_consistency(tmp_path, use_pallas):
    """Replay equation from the written files == mean + truncated POD
    reconstruction (et = 1 keeps every Fourier coefficient)."""
    cfg = small_config(tmp_path, podfs=dict(num_modes=6, energy_target=1.0),
                       nsteps=12, use_pallas=use_pallas)
    res = tpipe.run_pipeline(cfg, device="cpu")
    period, modes_fc = tprf.read_podfs_dat(os.path.join(cfg.outdir, "PODFS.dat"))
    h = thdf5.read_hdf5(os.path.join(cfg.outdir, "PODFS.hdf5"))
    ns, nm = cfg.nsteps, h["N_POD"]
    t = np.arange(ns) * res.dt
    recon = np.tile(h["mean"][:, 3:6].reshape(-1, order="F")[:, None],
                    (1, ns)).astype(np.complex128)
    for i in range(nm):
        phi = h["modes"][i][:, 3:6].reshape(-1, order="F")
        a_t = sum((re + 1j * im) * np.exp(2j * np.pi * k * t / period)
                  for k, re, im in modes_fc[i])
        recon += phi[:, None] * a_t[None, :]
    want = (res.mean_field[:, None]
            + res.pod.spatial_modes @ res.pod.temporal_modes[:, :nm].T)
    np.testing.assert_allclose(recon.real, want, atol=1e-7)
    np.testing.assert_allclose(recon.imag, 0.0, atol=1e-7)
    if nm == res.pod.num_valid:
        np.testing.assert_allclose(recon.real, res.mean_field[:, None] + res.A,
                                   atol=1e-6)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_reynolds_stress_statistical_parity(tmp_path, use_pallas):
    """Both generators reproduce the target Reynolds stresses within
    ensemble SNR (the bounds of tests/test_pipeline.py)."""
    cfg = small_config(
        tmp_path, plane=dict(jma=48, kma=33, res=0.1),
        filt=dict(length_scale_x=1.5, length_scale_y=1.5, length_scale_z=1.5,
                  fwidth=2.0),
        nsteps=192, turbulence_intensity=0.1, verbose=False, hdf5=False,
        dtype="float32", use_pallas=use_pallas)
    fields, _, filt, cfg, _ = tpipe.resolve_profile(cfg)
    A = np_of(tpipe.generate_snapshot_matrix(cfg, fields, filt, rotate=False,
                                                device="cpu"))
    npts, jma, kma = cfg.plane.num_points, cfg.plane.jma, cfg.plane.kma
    u = A[:npts].reshape(jma, kma, -1)
    U_target = np.broadcast_to(np.asarray(fields.mean_u), (jma, kma))[0]
    uu_target = np.broadcast_to(np.asarray(fields.uu), (jma, kma))[0]
    np.testing.assert_allclose(u.mean(axis=(0, 2)), U_target, atol=0.08)
    core = slice(kma // 2 - 3, kma // 2 + 4)
    uu_meas, uu_tgt = u[:, core, :].var(), float(np.mean(uu_target[core]))
    assert abs(uu_meas - uu_tgt) < 0.25 * uu_tgt, (uu_meas, uu_tgt)
    w = A[2 * npts:].reshape(jma, kma, -1)
    uw = ((u - u.mean(axis=2, keepdims=True))
          * (w - w.mean(axis=2, keepdims=True))).mean(axis=2)
    assert abs(uw[:, core].mean()) < 0.05 * uu_tgt
    assert np.abs(uw[:, core]).max() < 0.5 * uu_tgt


def test_rotated_plane(tmp_path):
    cfg = small_config(tmp_path, nsteps=5, verbose=False, hdf5=False,
                       plane=dict(jma=8, kma=9, res=0.1, normal=(1.0, 1.0, 0.0)))
    res = tpipe.run_pipeline(cfg, device="cpu")
    npts = cfg.plane.num_points
    assert np.isfinite(res.A).all()
    assert res.mean_field[:npts].mean() == pytest.approx(
        res.mean_field[npts:2 * npts].mean(), rel=0.05)


def test_unported_modes_raise(tmp_path):
    """Only the sharded modes (slice 5) are left: they raise, with or
    without the streaming POD (which, like --checkpoint_dir, now runs:
    tests/test_torch_streaming.py, tests/test_torch_checkpoint.py)."""
    for kw in (dict(shard_time=2), dict(shard_time=2, streaming_block=4)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tpipe.run_pipeline(small_config(tmp_path, **kw), device="cpu")


def test_cli_smoke(tmp_path, monkeypatch):
    from pods_digital_filter_tpu_torch import cli

    monkeypatch.chdir(tmp_path)
    before = fused_filter.LAUNCHES
    rc = cli.main(["-n", "5", "-m", "4", "-j", "8", "-k", "9", "--pallas",
                   "--dtype", "float32", "--device", "cpu", "--timings",
                   "--outdir", str(tmp_path / "PODFS")])
    assert rc == 0
    assert os.path.exists(tmp_path / "PODFS" / "PODFS.dat")
    assert fused_filter.LAUNCHES == before      # CPU: the plain version ran
    with pytest.raises(NotImplementedError, match="slice 5"):
        cli.main(["-n", "5", "--multihost", "--device", "cpu"])


def test_cuda_device_without_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; the refusal needs a host without one")
    with pytest.raises(RuntimeError, match="cuda"):
        tpipe.run_pipeline(small_config(tmp_path), device="cuda")


def test_bf16_result_A_is_float32(tmp_path, monkeypatch):
    """A bf16 run's ``PipelineResult.A`` is float32 in the port (numpy has
    no bfloat16, ``ops/pod.py:29-37``) and bf16 (ml_dtypes) in JAX; the
    values are the same.  Both pipelines take one bf16 snapshot matrix
    (each package's ``generate_snapshot_matrix`` patched to return it: the
    noise streams differ by construction) and centre it in bf16."""
    import jax.numpy as jnp
    import ml_dtypes

    from pods_digital_filter_tpu import pipeline as jpipe

    kw = dict(dtype="bfloat16", nsteps=6, verbose=False, hdf5=False,
              plane=dict(jma=4, kma=5, res=0.1))
    rng = np.random.default_rng(23)
    A = (1.0 + 0.1 * rng.standard_normal((3 * 20, 6))).astype(ml_dtypes.bfloat16)
    monkeypatch.setattr(tpipe, "generate_snapshot_matrix",
                        lambda *a, **k: torch.as_tensor(
                            A.astype(np.float32)).to(torch.bfloat16))
    monkeypatch.setattr(jpipe, "generate_snapshot_matrix",
                        lambda *a, **k: jnp.asarray(A))
    got = tpipe.run_pipeline(small_config(tmp_path, **kw), device="cpu",
                             write_outputs=False).A
    want = jpipe.run_pipeline(small_config(tmp_path, "jax", **kw),
                              write_outputs=False).A
    assert got.dtype == np.float32
    assert want.dtype == ml_dtypes.bfloat16
    np.testing.assert_array_equal(got, want.astype(np.float32))
