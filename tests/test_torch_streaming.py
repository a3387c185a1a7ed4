"""The port's out-of-core streaming POD (pods_digital_filter_tpu_torch/streaming.py)
— mirrors tests/test_streaming.py on the CPU (f64 at its 9 x 10 planes
unless a test says otherwise), and holds it against the JAX package on the
same snapshot matrix.

The two packages' noise streams differ, so the parity tests feed both the
same numpy matrix: each package's ``streaming.make_generator`` is replaced
by a function that slices that matrix and subtracts ``center``.  The
port's streaming path is also held against the port's in-memory path on
the port's own streams."""

import dataclasses
import glob
import os
import warnings

import numpy as np
import pytest
import torch

from torch_parity import align_signs, np_of  # noqa: I001

from pods_digital_filter_tpu import config as jconfig
from pods_digital_filter_tpu import replay
from pods_digital_filter_tpu import streaming as jstreaming
from pods_digital_filter_tpu.pipeline import resolve_profile as jresolve
from pods_digital_filter_tpu_torch import config as tconfig
from pods_digital_filter_tpu_torch import pipeline as tpipe
from pods_digital_filter_tpu_torch import streaming
from pods_digital_filter_tpu_torch.ops import lanczos
from pods_digital_filter_tpu_torch.ops import pod as tpod


def _cfg(tmp_path, nsteps=14, side="torch", **kw):
    c = tconfig if side == "torch" else jconfig
    d = dict(
        plane=c.PlaneConfig(jma=9, kma=10, res=0.1),
        filt=c.FilterConfig(length_scale_x=2.0, length_scale_y=2.0,
                            length_scale_z=2.0, fwidth=2.0),
        podfs=c.PODFSConfig(num_modes=5, energy_target=0.9),
        nsteps=nsteps, outdir=str(tmp_path / "PODFS"), dtype="float64",
    )
    d.update(kw)
    return c.PipelineConfig(**d)


def _run(cfg, **kw):
    return tpipe.run_pipeline(cfg, device="cpu", **kw)


def _sp(cfg, block, **kw):
    fields, dt, filt, cfg2, rotate = tpipe.resolve_profile(cfg)
    return streaming.streaming_pod(cfg2, fields, filt, rotate=rotate,
                                   block=block, device="cpu", **kw)


@pytest.mark.parametrize("block", [4, 5, 14])
def test_streaming_matches_inmemory(tmp_path, block):
    """f64: mean to 1e-12, spectrum to 1e-9, modes to 1e-8 / 1e-7 in
    magnitude, the rank-num_trunc reconstruction to 1e-8."""
    cfg = _cfg(tmp_path)
    res = _run(cfg, write_outputs=False)
    sp = _sp(cfg, block)

    np.testing.assert_allclose(sp.mean_field, res.mean_field, atol=1e-12)
    nv = res.pod.num_valid
    assert sp.pod.num_valid == nv
    assert sp.pod.num_trunc == res.pod.num_trunc
    np.testing.assert_allclose(sp.pod.energy[:nv], res.pod.energy[:nv],
                               rtol=1e-9, atol=1e-14)
    np.testing.assert_allclose(
        np.abs(sp.pod.temporal_modes[:, :nv]),
        np.abs(res.pod.temporal_modes[:, :nv]), atol=1e-8)
    np.testing.assert_allclose(
        np.abs(sp.pod.spatial_modes), np.abs(res.pod.spatial_modes),
        atol=1e-7)
    rec_s = sp.pod.spatial_modes @ sp.pod.temporal_modes[:, :sp.pod.num_trunc].T
    rec_m = res.pod.spatial_modes @ res.pod.temporal_modes[:, :res.pod.num_trunc].T
    np.testing.assert_allclose(rec_s, rec_m, atol=1e-8)


def test_streaming_snapshot_writer(tmp_path):
    """Streamed per-step snapshots == the in-memory run's (f64, 1e-9)."""
    cfg = _cfg(tmp_path, nsteps=6, verbose=True)
    fields, dt, filt, cfg2, rotate = tpipe.resolve_profile(cfg)
    os.makedirs(cfg2.outdir, exist_ok=True)
    geom = tpipe.make_inflow_plane(cfg2.plane)
    paths = streaming.write_snapshots_streaming(cfg2, fields, filt, geom, dt,
                                                rotate=rotate, block=4,
                                                device="cpu")
    assert len(paths) == 6 and all(os.path.exists(p) for p in paths)
    res = _run(cfg, write_outputs=False)
    A = res.A + res.mean_field[:, None]
    pts, u0 = replay.read_field_prf(paths[3])
    np.testing.assert_allclose(u0.reshape(-1, order="F"), A[:, 3], atol=1e-9)


def test_pipeline_streaming_end_to_end(tmp_path):
    """--streaming_block writes the in-memory run's model (f64): mean to
    1e-11, modes to 1e-7 in magnitude, replayed fields to 1e-6."""
    cfg_m = _cfg(tmp_path, nsteps=10, outdir=str(tmp_path / "mem"), hdf5=True)
    cfg_s = _cfg(tmp_path, nsteps=10, outdir=str(tmp_path / "str"), hdf5=True,
                 streaming_block=4)
    rm = _run(cfg_m)
    rs = _run(cfg_s)
    assert rs.A is None                # never materialized
    np.testing.assert_allclose(rs.mean_field, rm.mean_field, atol=1e-12)
    mm = replay.load_prf(cfg_m.outdir)
    ms = replay.load_prf(cfg_s.outdir)
    assert mm.num_modes == ms.num_modes
    np.testing.assert_allclose(ms.mean, mm.mean, atol=1e-11)
    np.testing.assert_allclose(np.abs(ms.modes), np.abs(mm.modes), atol=1e-7)
    assert ms.period == pytest.approx(mm.period)
    ts = np.linspace(0.0, mm.period, 7)
    np.testing.assert_allclose(replay.Replayer(ms).batch(ts),
                               replay.Replayer(mm).batch(ts), atol=1e-6)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_streaming_f32_mean_dominated(tmp_path, use_pallas):
    """float32 with the mean-dominated default profile (TI 2 %): centering
    each block inside the generator keeps the streamed eigenvalues within
    rtol 1e-5 of an exact float64 Gram of the same f32 snapshots, on both
    of the port's generators."""
    cfg = _cfg(tmp_path, nsteps=16, dtype="float32", use_pallas=use_pallas,
               plane=tconfig.PlaneConfig(jma=16, kma=24, res=0.1))
    fields, dt, filt, cfg2, rotate = tpipe.resolve_profile(cfg)
    A = np_of(tpipe.make_generator(cfg2, fields, filt, rotate=rotate,
                                   device="cpu")(0)).astype(np.float64)
    Ac = A - A.mean(axis=1, keepdims=True)
    e_ref, _, _, _ = tpod.temporal_from_gram(Ac.T @ Ac / 16, 16, 5, 1e-15)
    sp = streaming.streaming_pod(cfg2, fields, filt, rotate=rotate, block=5,
                                 device="cpu")
    np.testing.assert_allclose(sp.pod.energy[:5], e_ref[:5], rtol=1e-5)


@pytest.mark.parametrize("kw", [
    dict(gram_group=2), dict(gram_group=3), dict(gram_group=99),
    dict(streaming_cache="ram"), dict(streaming_cache="disk"),
    dict(gram_group=2, streaming_cache="ram"),
])
def test_gram_group_and_cache_parity(tmp_path, kw):
    """--gram_group and --streaming_cache change the schedule only: the
    same result as the plain streaming POD (f64, rtol 1e-12, atol 1e-12)."""
    cfg = _cfg(tmp_path, nsteps=14, streaming_block=4)
    base = _sp(cfg, 4)
    sp = _sp(dataclasses.replace(cfg, **kw), 4)
    np.testing.assert_allclose(sp.mean_field, base.mean_field, atol=1e-14)
    nv = base.pod.num_valid
    assert sp.pod.num_valid == nv
    np.testing.assert_allclose(sp.pod.energy[:nv], base.pod.energy[:nv],
                               rtol=1e-12, atol=1e-16)
    np.testing.assert_allclose(sp.pod.spatial_modes, base.pod.spatial_modes,
                               atol=1e-12)


def test_gram_group_with_checkpoint_resume(tmp_path):
    """gram_group composes with the Gram store: a complete store resumes
    with no generation but the projection's, and a store cut to its first
    row (a killed run) recomputes only the missing rows — both to the
    uncheckpointed result (f64, rtol 1e-12)."""
    ck = str(tmp_path / "ck")
    cfg = _cfg(tmp_path, nsteps=16, streaming_block=4, gram_group=2,
               checkpoint_dir=ck)
    ref = _sp(dataclasses.replace(cfg, checkpoint_dir="none"), 4)
    r1 = _sp(cfg, 4)
    blocks = []
    fields, dt, filt, cfg2, rotate = tpipe.resolve_profile(cfg)
    store = streaming.make_gram_store(cfg2, filt, fields, rotate, 4, "cpu")
    assert store.has_mean and store.completed_rows == {0, 1, 2, 3}
    real = streaming.make_generator

    def counting(*a, **kw):
        gen = real(*a, **kw)
        return lambda t0: blocks.append(t0) or gen(t0)

    streaming.make_generator = counting
    try:
        r2 = _sp(cfg, 4)                # every row from the store
        assert blocks == [0, 4, 8, 12]  # the projection pass only
        store.completed_rows = {0}
        store._write_meta()             # a run killed after row 0
        blocks.clear()
        r3 = _sp(cfg, 4)
    finally:
        streaming.make_generator = real
    # rows 1-3 (panel 1 and 2: 1 + 2 column blocks, then the panel of
    # rows 2-3), then the projection
    assert blocks == [4, 8, 12, 8, 12, 0, 4, 8, 12]
    for r in (r1, r2, r3):
        np.testing.assert_allclose(r.mean_field, ref.mean_field, atol=1e-14)
        nv = ref.pod.num_valid
        np.testing.assert_allclose(r.pod.energy[:nv], ref.pod.energy[:nv],
                                   rtol=1e-12, atol=1e-16)


def test_cache_rejected_with_sharding(tmp_path):
    with pytest.raises(ValueError, match="streaming_cache"):
        _cfg(tmp_path, shard_space=2, streaming_block=4, streaming_cache="ram",
             plane=tconfig.PlaneConfig(jma=8, kma=8, res=0.1)).validate()
    with pytest.raises(ValueError, match="gram_group"):
        _cfg(tmp_path, gram_group=0, streaming_block=4).validate()
    with pytest.raises(ValueError, match="only apply"):
        _cfg(tmp_path, gram_group=4).validate()


def test_gram_hbm_estimate_and_warning():
    """The estimate is the JAX package's formula (equal at every size), and
    one column block less on the tail kernel's route (``fused_tail``: the
    kernel writes the block that the FIR's output was); the warning fires
    against the budget it is given: at the flagship (1024x512, block 512,
    f32, nfx 8, Ns 10,240) group 8 fits a 40 GiB budget and group 16 does
    not; an oversized block warns at group 1; no budget (the CPU), no
    warning."""
    np3 = 3 * 1024 * 512
    for args in ((512, 1, 4, 8, 10240), (512, 8, 4, 8, 10240),
                 (128, 12, 4, 8, 10240), (4, 2, 8, 2, 14)):
        est = streaming.gram_pass_hbm_estimate(np3, *args)
        assert est == jstreaming.gram_pass_hbm_estimate(np3, *args)
        assert est - streaming.gram_pass_hbm_estimate(
            np3, *args, fused_tail=True) == np3 * args[0] * args[2]
    budget = 40 * 2 ** 30
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        streaming._warn_gram_hbm(np3, 512, 8, 4, 8, 10240, budget=budget)
        streaming._warn_gram_hbm(np3, 4096, 16, 4, 8, 10240, budget=None)
    with pytest.warns(UserWarning, match="gram_group 16"):
        streaming._warn_gram_hbm(np3, 512, 16, 4, 8, 10240, budget=budget)
    with pytest.warns(UserWarning, match="gram_group 1 "):
        streaming._warn_gram_hbm(np3, 4096, 1, 4, 8, 10240, budget=budget)
    assert streaming.device_memory_budget("cpu") is None


def test_streaming_eig_mode_topk_model_parity(tmp_path):
    """--eig_mode topk writes the model of full (f64): the same spectrum
    (rtol 1e-10) and valid count, replayed fields equal to 1e-8."""
    cfg_f = _cfg(tmp_path, nsteps=12, outdir=str(tmp_path / "full"),
                 streaming_block=4, eig_mode="full")
    cfg_t = _cfg(tmp_path, nsteps=12, outdir=str(tmp_path / "topk"),
                 streaming_block=4, eig_mode="topk")
    rf = _run(cfg_f)
    rt = _run(cfg_t)
    assert rf.pod.temporal_modes.shape[1] == 12
    assert rt.pod.temporal_modes.shape[1] == rt.pod.num_trunc
    assert rt.eig_route["vectors"] == "block Lanczos on cpu (f64)"
    np.testing.assert_allclose(rt.pod.energy, rf.pod.energy,
                               rtol=1e-10, atol=1e-14)
    assert rt.pod.num_valid == rf.pod.num_valid
    mf, mt = replay.load_prf(cfg_f.outdir), replay.load_prf(cfg_t.outdir)
    ts = np.linspace(0.0, mf.period, 5)
    np.testing.assert_allclose(replay.Replayer(mt).batch(ts),
                               replay.Replayer(mf).batch(ts), atol=1e-8)


def test_eig_mode_validation(tmp_path):
    with pytest.raises(ValueError, match="eig_mode"):
        _cfg(tmp_path, eig_mode="bogus").validate()
    with pytest.raises(ValueError, match="topk"):
        _cfg(tmp_path, eig_mode="topk", verbose=True).validate()


def test_cache_host_ram_warning():
    np3, ns = 3 * 1024 * 512, 10240
    with pytest.warns(UserWarning, match="streaming_cache ram"):
        streaming._warn_cache_host_ram(np3, ns, 4, phys_bytes=64 * 2 ** 30)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        streaming._warn_cache_host_ram(3 * 16 * 24, 16, 8,
                                       phys_bytes=64 * 2 ** 30)


def _force_scalar_route(monkeypatch):
    """Take the float32 route in f64: the block reduction 'fails' its gates,
    so the top-k vectors come from the scalar recurrence and the spectrum
    from its own m = n scan — the route the card takes in float32 without
    room for the dense solve."""
    monkeypatch.setattr(lanczos, "spectrum_and_topk", lambda *a, **k:
                        (None, None))


def test_scalar_route_counts_final_under_a_huge_tol_cn(tmp_path,
                                                        monkeypatch):
    """A huge tol_cn makes the valid count SMALLER than the requested
    modes: the scalar route's one run returns the full-eig path's counts
    and spectrum and writes its model (f64: spectrum rtol 1e-10, replay
    1e-8), with exactly num_trunc spatial modes."""
    podfs = tconfig.PODFSConfig(num_modes=6, energy_target=0.9, tol_cn=0.4)
    cfg_f = _cfg(tmp_path, nsteps=12, outdir=str(tmp_path / "full"),
                 streaming_block=4, eig_mode="full", podfs=podfs)
    cfg_t = _cfg(tmp_path, nsteps=12, outdir=str(tmp_path / "topk"),
                 streaming_block=4, eig_mode="topk", podfs=podfs)
    rf = _run(cfg_f)
    _force_scalar_route(monkeypatch)
    rt = _run(cfg_t)
    assert rt.pod.spatial_modes.shape[1] == rt.pod.num_trunc
    assert rt.eig_route["vectors"] == "Lanczos top-k on cpu (float64)"
    assert rt.eig_route["spectrum"] == "Lanczos m = n on cpu (float64)"
    assert rf.pod.num_valid < 6
    assert rt.pod.num_valid == rf.pod.num_valid
    assert rt.pod.num_trunc == rf.pod.num_trunc
    np.testing.assert_allclose(rt.pod.energy, rf.pod.energy,
                               rtol=1e-10, atol=1e-14)
    mf, mt = replay.load_prf(cfg_f.outdir), replay.load_prf(cfg_t.outdir)
    assert mt.num_modes == mf.num_modes
    ts = np.linspace(0.0, mf.period, 5)
    np.testing.assert_allclose(replay.Replayer(mt).batch(ts),
                               replay.Replayer(mf).batch(ts), atol=1e-8)


def test_flagship_default_gram_config_fits_budget():
    """The flagship configuration the card runs (block 512 x group 8,
    chip_smoke.py phase 10) fits an 80 GB card's budget with at least
    20 GiB to spare; the original's TPU default (128 x 12) fits too."""
    np3 = 3 * 1024 * 512
    budget = 80 * 10 ** 9 - streaming.DEVICE_RESERVE_BYTES
    for block, group in ((512, 8), (128, 12)):
        est = streaming.gram_pass_hbm_estimate(np3, block, group, 4, 8, 10240)
        assert budget - est > 20 * 2 ** 30


def test_checkpoint_resume_writes_the_whole_model(tmp_path):
    """On checkpoint resume (Gram rows from the store, the host top-k
    vectors and eigvalsh spectrum) the run itself writes the whole model,
    the eigenvalue file included, and it equals the eager f64 block
    route's run."""
    cfg_e = _cfg(tmp_path, nsteps=12, outdir=str(tmp_path / "eager"),
                 streaming_block=4, eig_mode="topk")
    re_ = _run(cfg_e)
    assert re_.eig_route["vectors"] == "block Lanczos on cpu (f64)"

    ck = str(tmp_path / "ck")
    _run(_cfg(tmp_path, nsteps=12, outdir=str(tmp_path / "warm"),
              streaming_block=4, eig_mode="topk", checkpoint_dir=ck))
    cfg_d = _cfg(tmp_path, nsteps=12, outdir=str(tmp_path / "resume"),
                 streaming_block=4, eig_mode="topk", checkpoint_dir=ck)
    rd = _run(cfg_d)
    assert rd.eig_route["vectors"].startswith("host top-k eigh")
    assert rd.eig_route["spectrum"] == "host eigvalsh (f64)"
    assert sorted(os.listdir(cfg_d.outdir)) == sorted(os.listdir(cfg_e.outdir))
    assert "POD.eigenvalues.dat" in os.listdir(cfg_d.outdir)
    assert sorted(rd.files) == sorted(
        os.path.join(cfg_d.outdir, f) for f in os.listdir(cfg_d.outdir))
    assert rd.pod.num_valid == re_.pod.num_valid
    np.testing.assert_allclose(rd.pod.energy, re_.pod.energy,
                               rtol=1e-12, atol=1e-16)
    ev_e = np.genfromtxt(os.path.join(cfg_e.outdir, "POD.eigenvalues.dat"))
    ev_d = np.genfromtxt(os.path.join(cfg_d.outdir, "POD.eigenvalues.dat"))
    assert ev_e.shape == ev_d.shape
    sig = ev_e[:, 1] > 1e-10 * ev_e[:, 1].max()
    np.testing.assert_allclose(ev_d[sig], ev_e[sig], rtol=1e-9)
    np.testing.assert_allclose(ev_d[~sig, 1], ev_e[~sig, 1],
                               atol=1e-12 * ev_e[:, 1].max())


def test_scalar_route_writes_the_full_eig_file_list(tmp_path, monkeypatch):
    """Under the same huge tol_cn the scalar route's one run writes only
    the final truncation's mode files: the directory lists exactly the
    full-eig run's files."""
    podfs = tconfig.PODFSConfig(num_modes=6, energy_target=0.9, tol_cn=0.4)
    cfg_f = _cfg(tmp_path, nsteps=12, outdir=str(tmp_path / "full2"),
                 streaming_block=4, eig_mode="full", podfs=podfs)
    cfg_t = _cfg(tmp_path, nsteps=12, outdir=str(tmp_path / "topk2"),
                 streaming_block=4, eig_mode="topk", podfs=podfs)
    _run(cfg_f)
    _force_scalar_route(monkeypatch)
    rt = _run(cfg_t)
    modes = lambda d: sorted(os.path.basename(p) for p in
                             glob.glob(os.path.join(d, "PODFS_mode_*.prf")))
    assert rt.eig_route["vectors"] == "Lanczos top-k on cpu (float64)"
    assert rt.pod.num_trunc < 6                   # fewer than requested
    assert modes(cfg_t.outdir) == modes(cfg_f.outdir)
    assert len(modes(cfg_t.outdir)) == rt.pod.num_trunc
    assert sorted(os.listdir(cfg_t.outdir)) == sorted(os.listdir(cfg_f.outdir))


# --- the same snapshot matrix through both packages -------------------------

def _fake_make_generator(A, wrap):
    """``make_generator`` stand-in: window ``[t0, t0+nsteps)`` of the numpy
    matrix ``A`` minus ``center``, in the package's own array type."""
    def make(cfg, fields, filt, nsteps=None, rotate=True, center=None,
             device=None):
        n = cfg.nsteps if nsteps is None else nsteps
        c = 0.0 if center is None else np.asarray(np_of(center))[:, None]
        return lambda t0: wrap(A[:, t0:t0 + n] - c, cfg.dtype)
    return make


def _both(tmp_path, monkeypatch, A, block=4, **kw):
    import jax.numpy as jnp

    ns = A.shape[1]
    monkeypatch.setattr(jstreaming, "make_generator", _fake_make_generator(
        A, lambda x, dt: jnp.asarray(x, dtype=dt)))
    monkeypatch.setattr(streaming, "make_generator", _fake_make_generator(
        A, lambda x, dt: torch.as_tensor(np.asarray(x, dtype=dt))))
    out = {}
    for side, mod, resolve in (("jax", jstreaming, jresolve),
                               ("torch", streaming, tpipe.resolve_profile)):
        cfg = _cfg(tmp_path, nsteps=ns, side=side, streaming_block=block, **kw)
        fields, _, filt, cfg, rotate = resolve(cfg)
        extra = {"device": "cpu"} if side == "torch" else {}
        sp = mod.streaming_pod(cfg, fields, filt, rotate=rotate, block=block,
                               **extra)
        if side == "jax":
            sp.resolve()               # the JAX package keeps its deferral
        out[side] = sp
    return out["jax"], out["torch"]


def _matrix(ns=20, dtype=np.float64):
    """A mean-dominated snapshot matrix (3 * 9 * 10 rows) with a decaying
    spectrum, from a seed."""
    rng = np.random.default_rng(11)
    U = rng.standard_normal((270, 8)) * np.exp(-0.4 * np.arange(8))
    A = 1.0 + U @ rng.standard_normal((8, ns)) * 0.05 \
        + 1e-3 * rng.standard_normal((270, ns))
    return A.astype(dtype)


def _compare(sj, st, rtol, atol_rec):
    np.testing.assert_allclose(st.mean_field, sj.mean_field, rtol=rtol)
    nv = sj.pod.num_valid
    assert st.pod.num_valid == nv
    assert st.pod.num_trunc == sj.pod.num_trunc
    e = sj.pod.energy
    np.testing.assert_allclose(st.pod.energy[:nv], e[:nv], rtol=rtol,
                               atol=rtol * e[0])
    k = st.pod.num_trunc
    rec = lambda p: p.spatial_modes[:, :k] @ p.temporal_modes[:, :k].T
    np.testing.assert_allclose(rec(st.pod), rec(sj.pod), atol=atol_rec)
    np.testing.assert_allclose(
        align_signs(np.asarray(st.pod.spatial_modes[:, :k], np.float64),
                    np.asarray(sj.pod.spatial_modes[:, :k], np.float64)),
        sj.pod.spatial_modes[:, :k], atol=atol_rec * 1e2)


@pytest.mark.parametrize("eig_mode,group", [("full", 1), ("topk", 2),
                                            ("topk", 1)])
def test_streaming_pod_matches_jax_same_matrix(tmp_path, monkeypatch,
                                               eig_mode, group):
    """float64 on both sides, the same 270 x 20 matrix: mean, spectrum
    (rtol 1e-9), valid count, truncation and the rank-num_trunc
    reconstruction (atol 1e-10) agree; f64 top-k takes the block route on
    both."""
    A = _matrix()
    sj, st = _both(tmp_path, monkeypatch, A, eig_mode=eig_mode,
                   gram_group=group)
    if eig_mode == "topk":
        assert st.route["vectors"] == "block Lanczos on cpu (f64)"
    _compare(sj, st, 1e-9, 1e-10)


def test_streaming_pod_matches_jax_f32_scalar_route(tmp_path, monkeypatch):
    """float32 on both sides, --eig_mode topk: each package takes its
    scalar Lanczos vectors and its m = n Lanczos spectrum (the card's
    route without room for the dense solve; JAX defers the spectrum, the
    port runs it before the projection).  The leading spectrum agrees to rtol 1e-5 (f32 Gram
    accumulation), the valid count and the reconstruction (atol 1e-6)
    too."""
    A = _matrix(24, np.float32)
    sj, st = _both(tmp_path, monkeypatch, A, dtype="float32",
                   eig_mode="topk")
    assert st.route == {"vectors": "Lanczos top-k on cpu (float32)",
                        "spectrum": "Lanczos m = n on cpu (float32)"}
    np.testing.assert_allclose(st.mean_field, sj.mean_field, rtol=1e-6)
    np.testing.assert_allclose(st.pod.energy[:5], sj.pod.energy[:5],
                               rtol=1e-5)
    assert st.pod.num_trunc == sj.pod.num_trunc == 5
    rec = lambda p: p.spatial_modes @ p.temporal_modes[:, :5].T
    np.testing.assert_allclose(rec(st.pod), rec(sj.pod), atol=1e-6)


def test_streamed_gram_matches_jax_with_store(tmp_path):
    """The Gram pass with a store, on the same blocks (f64): the host
    Gram, the stored row strips and the resumed Gram equal the JAX
    package's (rtol 1e-13)."""
    import jax.numpy as jnp

    from pods_digital_filter_tpu.utils.checkpoint import GramCheckpoint as JG
    from pods_digital_filter_tpu_torch.utils.checkpoint import GramCheckpoint

    A = _matrix(14)
    A = A - A.mean(axis=1, keepdims=True)
    st = GramCheckpoint(str(tmp_path / "t"), "fp", 14, 4)
    sj = JG(str(tmp_path / "j"), "fp", 14, 4)
    C_t = streaming.streamed_gram(
        lambda t0: torch.as_tensor(A[:, t0:t0 + 4]), 14, 4, store=st, group=3)
    C_j = jstreaming.streamed_gram(
        lambda t0: jnp.asarray(A[:, t0:t0 + 4]), 14, 4,
        jstreaming._pair_products, store=sj, group=3)
    np.testing.assert_allclose(C_t, C_j, rtol=1e-13, atol=1e-15)
    np.testing.assert_allclose(C_t, A.T @ A / 14, rtol=1e-13, atol=1e-15)
    for bi in range(4):
        np.testing.assert_allclose(st.load_row(bi), sj.load_row(bi),
                                   rtol=1e-13, atol=1e-15)
    C_r = streaming.streamed_gram(lambda t0: pytest.fail("regenerated"), 14,
                                  4, store=GramCheckpoint(str(tmp_path / "t"),
                                                          "fp", 14, 4))
    np.testing.assert_array_equal(C_r, C_t)


def test_cli_streaming_and_checkpoint(tmp_path, monkeypatch):
    """The CLI runs --streaming_block (with --gram_group, --eig_mode topk,
    --checkpoint_dir) and the checkpointed in-memory path on the CPU with
    the fused generator's plain version, and both write the in-memory
    run's model (f32: replayed fields within 1e-4 of the in-memory
    model)."""
    from pods_digital_filter_tpu_torch import cli

    monkeypatch.chdir(tmp_path)
    common = ["-n", "10", "-m", "3", "-j", "8", "-k", "9", "--pallas",
              "--device", "cpu"]
    assert cli.main(common + ["--outdir", "mem"]) == 0
    assert cli.main(common + ["--streaming_block", "4", "--gram_group", "2",
                              "--eig_mode", "topk", "--checkpoint_dir",
                              "ck_s", "--outdir", "str"]) == 0
    assert cli.main(common + ["--checkpoint_dir", "ck_m", "--outdir",
                              "ckm"]) == 0
    assert os.path.exists(tmp_path / "ck_s" / "gram_meta.json")
    assert os.path.exists(tmp_path / "ck_m" / "meta.json")
    mm = replay.load_prf(str(tmp_path / "mem"))
    ts = np.linspace(0.0, mm.period, 5)
    for d in ("str", "ckm"):
        m = replay.load_prf(str(tmp_path / d))
        assert m.num_modes == mm.num_modes
        np.testing.assert_allclose(replay.Replayer(m).batch(ts),
                                   replay.Replayer(mm).batch(ts), atol=1e-4)


# --- the dense route: one f64 device eigh where the card holds it -----------

def _dense(monkeypatch, fits=True):
    """Decide :func:`streaming.dense_eigh_fits` (on the CPU it is False:
    no card, no budget), so LAPACK runs through the card's call."""
    monkeypatch.setattr(streaming, "dense_eigh_fits", lambda dev, ns: fits)


def _no_lanczos(monkeypatch):
    fail = lambda *a, **k: pytest.fail("a Lanczos scan ran")
    for name in ("spectrum_and_topk", "topk_or_none", "full_spectrum"):
        monkeypatch.setattr(lanczos, name, fail)


def _gram(A, block=4):
    """``[C, C_dev]`` of the centred ``A`` as the Gram pass returns them,
    and the symmetrised Gram in f64 that both routes solve."""
    ns = A.shape[1]
    Ac = A - A.mean(axis=1, keepdims=True, dtype=np.float64).astype(A.dtype)
    gram = list(streaming.streamed_gram(
        lambda t0: torch.as_tensor(Ac[:, t0:t0 + block]), ns, block,
        return_device=True))
    C = tpod.to_numpy(streaming.symmetrize_gram_device(gram[1], ns))
    return gram, C.astype(np.float64)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_dense_route_equals_host_eigh(monkeypatch, dtype):
    """The dense route's energy, valid count, truncation and scaled
    temporal modes equal the host eigh's on the same Gram (rtol 1e-10;
    modes to 1e-10 up to sign).  tol_cn 1e-6 keeps the Gram's null
    eigenvalue (rounding noise of either sign) out of the valid count."""
    _dense(monkeypatch)
    _no_lanczos(monkeypatch)
    A = _matrix(20, dtype)
    gram, C = _gram(A)
    sol = streaming.eigen_half(gram, 20, 5, 5, 1e-6, torch.device("cpu"))
    energy, temporal, nv, nt = tpod.temporal_from_gram(C, 20, 5, 1e-6)
    assert gram == []
    assert (sol.num_valid, sol.num_trunc) == (nv, nt)
    assert sol.projection().shape == (20, nt)
    assert (nv, nt) == (18, 5)            # the reference caps it at ns - 2
    np.testing.assert_allclose(sol.energy, energy, rtol=1e-10,
                               atol=1e-10 * energy[0])
    assert sol.temporal.shape == (20, nt)
    np.testing.assert_allclose(align_signs(sol.temporal, temporal[:, :nt]),
                               temporal[:, :nt], atol=1e-10)
    assert sol.route == {"vectors": "device eigh on cpu (f64)",
                         "spectrum": "device eigh on cpu (f64)"}


def test_dense_route_defers_nothing(tmp_path, monkeypatch):
    """streaming_pod on the dense route returns its counts final, with
    exactly num_trunc spatial modes, and the in-memory run's POD (f64:
    spectrum to 1e-9, reconstruction to 1e-8)."""
    _dense(monkeypatch)
    _no_lanczos(monkeypatch)
    cfg = _cfg(tmp_path, eig_mode="topk")
    res = _run(cfg, write_outputs=False)
    sp = _sp(cfg, 4)
    assert sp.pod.spatial_modes.shape[1] == sp.pod.num_trunc
    assert sp.route["spectrum"] == "device eigh on cpu (f64)"
    nv = res.pod.num_valid
    assert sp.pod.num_valid == nv
    assert sp.pod.num_trunc == res.pod.num_trunc
    np.testing.assert_allclose(sp.pod.energy[:nv], res.pod.energy[:nv],
                               rtol=1e-9, atol=1e-14)
    k = sp.pod.num_trunc
    rec = lambda p: p.spatial_modes[:, :k] @ p.temporal_modes[:, :k].T
    np.testing.assert_allclose(rec(sp.pod), rec(res.pod), atol=1e-8)


def test_run_pipeline_dense_route_writes_the_whole_model(tmp_path,
                                                         monkeypatch):
    """run_pipeline on the dense streaming route writes the whole model,
    the eigenvalue file included, and the full-eig run's file list;
    replayed fields equal the full-eig run's to 1e-8 (f64)."""
    cfg_f = _cfg(tmp_path, nsteps=12, outdir=str(tmp_path / "full"),
                 streaming_block=4, eig_mode="full")
    rf = _run(cfg_f)
    _dense(monkeypatch)
    _no_lanczos(monkeypatch)
    cfg_d = _cfg(tmp_path, nsteps=12, outdir=str(tmp_path / "dense"),
                 streaming_block=4, eig_mode="topk")
    rd = _run(cfg_d)
    assert rd.eig_route["vectors"] == "device eigh on cpu (f64)"
    listed = sorted(os.listdir(cfg_d.outdir))
    assert "POD.eigenvalues.dat" in listed
    assert sorted(rd.files) == sorted(
        os.path.join(cfg_d.outdir, f) for f in listed)
    assert listed == sorted(os.listdir(cfg_f.outdir))
    assert rd.pod.num_valid == rf.pod.num_valid
    mf, md = replay.load_prf(cfg_f.outdir), replay.load_prf(cfg_d.outdir)
    ts = np.linspace(0.0, mf.period, 5)
    np.testing.assert_allclose(replay.Replayer(md).batch(ts),
                               replay.Replayer(mf).batch(ts), atol=1e-8)


def test_dense_route_counted_once_per_model(tmp_path, monkeypatch):
    """Under a profiler each model counts one ``streaming.eigh_dense`` span
    (with its seconds) and no Lanczos step; with no profiler nothing is
    counted."""
    from torch.profiler import ProfilerActivity, profile

    from pods_digital_filter_tpu_torch.utils import timing

    _dense(monkeypatch)
    cfg = _cfg(tmp_path, nsteps=12, streaming_block=4, eig_mode="topk")
    timing.reset_counts()
    _run(cfg, write_outputs=False)
    assert "streaming.eigh_dense" not in timing.counts()
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(2):
            _run(cfg, write_outputs=False)
    c = timing.counts()
    timing.reset_counts()
    assert c["streaming.eigh_dense"] == 2
    assert c["streaming.eigh_dense_s"] > 0.0
    assert "lanczos.steps" not in c and "lanczos.scan" not in c


def test_dense_eigh_fits_the_solve_bytes(monkeypatch):
    """The dense route needs a card and 5 * ns^2 * 8 bytes of its free
    memory (4.19 GB at the flagship's 10,240 steps): the card's free
    bytes plus what the caching allocator holds reserved but
    unallocated."""
    assert streaming.device_free_bytes(torch.device("cpu")) is None
    assert streaming.dense_eigh_fits(torch.device("cpu"), 16) is False
    need = 5 * 10240 ** 2 * 8
    gib = 2 ** 30
    for free, reserved, allocated, fits in (
            (need, 0, 0, True), (need - 1, 0, 0, False),
            (40 * gib, 34 * gib, 34 * gib, True), (gib, 0, 0, False),
            # the Gram pass's freed group buffers, still cached
            (gib, 30 * gib, 5 * gib, True),
            (need - 1, 2 * gib, 2 * gib, False),
            (need - gib, 3 * gib, 2 * gib, True)):
        monkeypatch.setattr(torch.cuda, "mem_get_info",
                            lambda dev, free=free: (free, 80 * gib))
        monkeypatch.setattr(torch.cuda, "memory_reserved",
                            lambda dev, r=reserved: r)
        monkeypatch.setattr(torch.cuda, "memory_allocated",
                            lambda dev, a=allocated: a)
        assert streaming.device_free_bytes("cuda") == \
            free + reserved - allocated
        assert streaming.dense_eigh_fits("cuda", 10240) is fits


@pytest.mark.parametrize("dtype,route", [
    (np.float64, {"vectors": "block Lanczos on cpu (f64)",
                  "spectrum": "block Lanczos on cpu (f64)"}),
    (np.float32, {"vectors": "Lanczos top-k on cpu (float32)",
                  "spectrum": "Lanczos m = n on cpu (float32)"}),
])
def test_lanczos_routes_without_room(tmp_path, monkeypatch, dtype, route):
    """A card with too little free memory for the dense solve: the
    f64 block-Lanczos route and the f32 scalar route with its m = n
    spectrum run as before, under their own route strings."""
    monkeypatch.setattr(streaming, "device_free_bytes",
                        lambda dev: 5 * 24 ** 2 * 8 - 1)
    A = _matrix(24, dtype)
    sj, st = _both(tmp_path, monkeypatch, A, dtype=np.dtype(dtype).name,
                   eig_mode="topk")
    assert st.route == route
    rtol = 1e-9 if dtype == np.float64 else 1e-5
    np.testing.assert_allclose(st.pod.energy[:5], sj.pod.energy[:5],
                               rtol=rtol)
    assert st.pod.num_trunc == sj.pod.num_trunc == 5


#: each top-k route's vectors
TOP_K_ROUTES = {
    "dense": "device eigh on cpu (f64)",
    "block": "block Lanczos on cpu (f64)",
    "scalar": "Lanczos top-k on cpu (float32)",
    "host": "host top-k eigh (f64, Gram rows from the checkpoint store)",
}


@pytest.mark.parametrize("route", list(TOP_K_ROUTES))
def test_top_k_routes_return_final_counts(tmp_path, monkeypatch, route):
    """Every top-k route of streaming_pod returns its counts final: 8
    valid modes of the 10 asked for (tol_cn 0.014 cuts the matrix's gap
    after its 8 signal modes), so exactly 8 spatial modes where 10 vectors
    were solved for, the full-eig run's valid count, and its leading
    spectrum (f64 rtol 1e-9; the f32 scalar route rtol 1e-5)."""
    dtype = np.float32 if route == "scalar" else np.float64
    A = _matrix(24, dtype)
    monkeypatch.setattr(streaming, "make_generator", _fake_make_generator(
        A, lambda x, dt: torch.as_tensor(np.asarray(x, dtype=dt))))
    podfs = tconfig.PODFSConfig(num_modes=10, energy_target=0.9, tol_cn=0.014)
    cfg = lambda **kw: _cfg(tmp_path, nsteps=24, podfs=podfs,
                            dtype=np.dtype(dtype).name, **kw)
    full = _sp(cfg(eig_mode="full"), 4, tol_cn=podfs.tol_cn)
    topk = cfg(eig_mode="topk")
    if route == "dense":
        _dense(monkeypatch)
    if route == "host":
        topk = cfg(eig_mode="topk", checkpoint_dir=str(tmp_path / "ck"))
        _sp(topk, 4, tol_cn=podfs.tol_cn)       # fills the Gram store
    sp = _sp(topk, 4, tol_cn=podfs.tol_cn)
    assert sp.route["vectors"] == TOP_K_ROUTES[route]
    assert full.pod.num_valid == sp.pod.num_valid == 8
    assert sp.pod.num_trunc == 8
    assert sp.pod.spatial_modes.shape == (270, sp.pod.num_trunc)
    rtol = 1e-5 if route == "scalar" else 1e-9
    np.testing.assert_allclose(sp.pod.energy[:8], full.pod.energy[:8],
                               rtol=rtol)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_dense_route_matches_jax(tmp_path, monkeypatch, dtype):
    """The same matrix through both packages, the torch side on the dense
    route and the JAX side on its Lanczos routes: mean, leading spectrum,
    truncation and the rank-num_trunc reconstruction agree at the Lanczos
    parity tests' tolerances (f64: spectrum rtol 1e-9, reconstruction
    atol 1e-10, with the valid count; f32: rtol 1e-5, atol 1e-6)."""
    _dense(monkeypatch)
    _no_lanczos(monkeypatch)
    A = _matrix(24, dtype)
    sj, st = _both(tmp_path, monkeypatch, A, dtype=np.dtype(dtype).name,
                   eig_mode="topk")
    assert st.route == {"vectors": "device eigh on cpu (f64)",
                        "spectrum": "device eigh on cpu (f64)"}
    if dtype == np.float64:
        _compare(sj, st, 1e-9, 1e-10)
        return
    np.testing.assert_allclose(st.mean_field, sj.mean_field, rtol=1e-6)
    np.testing.assert_allclose(st.pod.energy[:5], sj.pod.energy[:5],
                               rtol=1e-5)
    assert st.pod.num_trunc == sj.pod.num_trunc == 5
    rec = lambda p: p.spatial_modes @ p.temporal_modes[:, :5].T
    np.testing.assert_allclose(rec(st.pod), rec(sj.pod), atol=1e-6)
