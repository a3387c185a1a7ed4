"""The port's PODFS replay (pods_digital_filter_tpu_torch/replay.py) and its
copy of the C replay library (native/podfs_replay.{c,h}), held to the JAX
package's replay on the same model files.

Mirrors tests/test_replay.py (10), the three replay tests of
tests/test_golden.py (the reference's own model in tests/golden/ref_run/)
and tests/test_native.py::test_solver_stub_links_and_runs.  Both sides run
in float64 (conftest turns on jax x64; the port's Replayer defaults to
float64): replays agree within 1e-10 of the field's scale, loaders exactly.
"""

import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (pins torch's thread count)

from pods_digital_filter_tpu import replay as jreplay
from pods_digital_filter_tpu_torch import config as tconfig
from pods_digital_filter_tpu_torch import native
from pods_digital_filter_tpu_torch import replay
from pods_digital_filter_tpu_torch.pipeline import run_pipeline

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUN = os.path.join(REPO, "tests", "golden", "ref_run")
GOLDEN = os.path.join(REPO, "tests", "golden")
#: f64 replays of the port and of JAX: within this share of max |field|
REL = 1e-10

needs_cc = pytest.mark.skipif(not native.podfs_replay_available(),
                              reason="no C compiler available")


def _cfg(outdir, jma=10, kma=11, ln=2.0, num_modes=6, et=1.0, nsteps=12,
         hdf5=True):
    return tconfig.PipelineConfig(
        plane=tconfig.PlaneConfig(jma=jma, kma=kma, res=0.1),
        filt=tconfig.FilterConfig(length_scale_x=ln, length_scale_y=ln,
                                  length_scale_z=ln, fwidth=2.0),
        podfs=tconfig.PODFSConfig(num_modes=num_modes, energy_target=et),
        nsteps=nsteps, outdir=str(outdir), dtype="float64", hdf5=hdf5)


@pytest.fixture(scope="module")
def model_run(tmp_path_factory):
    cfg = _cfg(tmp_path_factory.mktemp("replay") / "PODFS")
    return cfg, run_pipeline(cfg, device="cpu")


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=REL * np.abs(want).max())


def test_load_prf_and_hdf5_agree(model_run):
    cfg, res = model_run
    m_prf = replay.load_prf(cfg.outdir)
    m_h5 = replay.load_hdf5(os.path.join(cfg.outdir, "PODFS.hdf5"))

    assert m_prf.num_modes == m_h5.num_modes == res.pod.num_trunc
    assert m_prf.period == pytest.approx(m_h5.period)
    np.testing.assert_allclose(m_prf.points, m_h5.points, atol=1e-11)
    # .prf cells are %0.12f fixed-width; HDF5 is full float64
    np.testing.assert_allclose(m_prf.mean, m_h5.mean, atol=1e-11)
    np.testing.assert_allclose(m_prf.modes, m_h5.modes, atol=1e-11)
    np.testing.assert_allclose(m_prf.k, m_h5.k)
    np.testing.assert_allclose(m_prf.c_re, m_h5.c_re, rtol=1e-12)
    np.testing.assert_allclose(m_prf.c_im, m_h5.c_im, rtol=1e-12)
    np.testing.assert_array_equal(m_prf.counts, m_h5.counts)


@pytest.mark.parametrize("flavor", ["prf", "hdf5"])
def test_loaders_match_jax(model_run, flavor):
    """The port's loaders return the JAX loaders' arrays, exactly."""
    cfg, _ = model_run
    path = cfg.outdir if flavor == "prf" else os.path.join(cfg.outdir,
                                                            "PODFS.hdf5")
    mt, mj = replay.load_model(path), jreplay.load_model(path)
    for name in ("points", "mean", "modes", "k", "c_re", "c_im", "counts"):
        a, b = getattr(mt, name), getattr(mj, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert mt.period == mj.period and mt.columns == mj.columns


def test_load_model_dispatch(model_run):
    cfg, _ = model_run
    assert isinstance(replay.load_model(cfg.outdir), replay.PODFSModel)
    assert isinstance(
        replay.load_model(os.path.join(cfg.outdir, "PODFS.hdf5")),
        replay.PODFSModel)


def test_replay_matches_pod_reconstruction(model_run):
    cfg, res = model_run
    rp = replay.Replayer(replay.load_hdf5(os.path.join(cfg.outdir, "PODFS.hdf5")),
                         device="cpu")
    ns = cfg.nsteps
    nm = rp.model.num_modes
    ts = np.arange(ns) * res.dt

    got = rp.batch(ts)                       # (Ns, Np, 3)
    npts = rp.model.num_points
    got_packed = got.transpose(0, 2, 1).reshape(ns, 3 * npts).T  # (3Np, Ns)

    want = (res.mean_field[:, None]
            + res.pod.spatial_modes @ res.pod.temporal_modes[:, :nm].T)
    np.testing.assert_allclose(got_packed, want, atol=1e-7)

    # all valid modes kept -> the original snapshots themselves
    if nm == res.pod.num_valid:
        np.testing.assert_allclose(got_packed, res.mean_field[:, None] + res.A,
                                   atol=1e-6)


def test_replay_matches_jax_replayer(model_run):
    """Replayer.batch and batch_device against the JAX Replayer on the same
    files (both float64), at times spanning three periods; batch_device
    also takes the times as a tensor on its device, as JAX's takes a device
    array, with the same result."""
    cfg, _ = model_run
    rt = replay.Replayer(replay.load_prf(cfg.outdir), device="cpu")
    rj = jreplay.Replayer(jreplay.load_prf(cfg.outdir))
    ts = np.linspace(-0.3, 3.0, 9) * rt.model.period
    want = rj.batch(ts, alpha=1.5)
    _close(rt.batch(ts, alpha=1.5), want)
    dev = rt.batch_device(ts, alpha=1.5)
    assert isinstance(dev, torch.Tensor) and dev.dtype == torch.float64
    _close(dev.numpy(), np.asarray(rj.batch_device(ts, alpha=1.5)))
    torch.testing.assert_close(rt.batch_device(torch.as_tensor(ts), alpha=1.5),
                               dev, rtol=0, atol=0)


def test_replay_single_time_and_alpha(model_run):
    cfg, res = model_run
    rp = replay.Replayer(replay.load_prf(cfg.outdir), device="cpu")

    u0 = rp(0.0)
    assert u0.shape == (rp.model.num_points, 3)
    np.testing.assert_allclose(u0, rp.batch([0.0])[0])

    # alpha scales only the mean contribution
    u_a = rp(0.0, alpha=2.0)
    mean = rp.model.mean.reshape(3, -1).T
    np.testing.assert_allclose(u_a - u0, mean, atol=1e-9)


def test_replay_periodicity(model_run):
    """The Fourier series is T-periodic: t and t+T give identical fields."""
    cfg, _ = model_run
    rp = replay.Replayer(replay.load_prf(cfg.outdir), device="cpu")
    t = 0.37 * rp.model.period
    np.testing.assert_allclose(rp(t), rp(t + rp.model.period), atol=1e-8)


def test_replay_float32_option(model_run):
    """dtype=float32 keeps theta and the product in float32 (the original's
    dtype without x64): within f32 rounding of the float64 replay."""
    cfg, _ = model_run
    m = replay.load_prf(cfg.outdir)
    ts = np.linspace(0.0, m.period, 5)
    r32 = replay.Replayer(m, dtype=torch.float32, device="cpu")
    assert r32.batch_device(ts).dtype == torch.float32
    want = replay.Replayer(m, device="cpu").batch(ts)
    np.testing.assert_allclose(r32.batch(ts), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    with pytest.raises(ValueError, match="float64 or float32"):
        replay.Replayer(m, dtype=torch.bfloat16, device="cpu")


def test_from_arrays_matches_jax(rng):
    """Both packages' models from the same ragged numpy arrays replay the
    same fields (float64)."""
    npts, nm = 17, 4
    counts = [3, 1, 5, 0]
    fc = [np.column_stack([rng.integers(-4, 5, n).astype(float),
                           rng.standard_normal(n), rng.standard_normal(n)])
          for n in counts]
    points = rng.standard_normal((npts, 3))
    mean = rng.standard_normal(3 * npts)
    modes = rng.standard_normal((nm, 3 * npts))
    mt = replay.PODFSModel.from_arrays(points, mean, modes, 0.7, fc)
    k, c_re, c_im, cnt = jreplay._pad_fc(fc)
    mj = jreplay.PODFSModel(points=points, mean=mean, modes=modes, period=0.7,
                            k=k, c_re=c_re, c_im=c_im, counts=cnt)
    np.testing.assert_array_equal(mt.counts, counts)
    ts = np.linspace(0.0, 1.3, 11)
    _close(replay.Replayer(mt, device="cpu").batch(ts),
           jreplay.Replayer(mj).batch(ts))


def test_replay_cli(model_run, tmp_path):
    cfg, _ = model_run
    out_prf = str(tmp_path / "rp")
    rc = replay.main([cfg.outdir, "-n", "3", "--outdir", out_prf,
                      "--device", "cpu"])
    assert rc == 0
    prfs = [p for p in os.listdir(out_prf) if p.endswith(".prf")]
    assert len(prfs) == 3

    out_npy = str(tmp_path / "rpn")
    rc = replay.main([os.path.join(cfg.outdir, "PODFS.hdf5"), "-n", "4",
                      "--format", "npy", "--outdir", out_npy,
                      "--device", "cpu"])
    assert rc == 0
    f = np.load(os.path.join(out_npy, "fields.npy"))
    t = np.load(os.path.join(out_npy, "times.npy"))
    assert f.shape[0] == t.shape[0] == 4
    assert f.shape[2] == 3

    # CLI .prf output replays to the same values as the API
    rp = replay.Replayer(replay.load_prf(cfg.outdir), device="cpu")
    pts, u0 = replay.read_field_prf(os.path.join(out_prf, sorted(prfs)[0]))
    np.testing.assert_allclose(u0, rp(0.0), atol=1e-11)

    # the JAX CLI on the same model writes the same .npy fields
    out_j = str(tmp_path / "rpj")
    assert jreplay.main([os.path.join(cfg.outdir, "PODFS.hdf5"), "-n", "4",
                         "--format", "npy", "--outdir", out_j]) == 0
    np.testing.assert_array_equal(t, np.load(os.path.join(out_j, "times.npy")))
    _close(f, np.load(os.path.join(out_j, "fields.npy")))


def test_replay_cli_defaults_to_the_card(model_run, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; the refusal needs a host without one")
    cfg, _ = model_run
    with pytest.raises(RuntimeError, match="cuda"):
        replay.main([cfg.outdir, "-n", "2", "--outdir", str(tmp_path / "x")])
    with pytest.raises(RuntimeError, match="cuda"):
        replay.Replayer(replay.load_prf(cfg.outdir))


@needs_cc
def test_native_c_replayer_matches_torch(model_run):
    """The port's copy of the linkable C solver library agrees with the
    port's Replayer to float64 round-off on the same model directory."""
    cfg, _ = model_run
    rp = replay.Replayer(replay.load_prf(cfg.outdir), device="cpu")
    with native.NativePODFSReplayer(cfg.outdir) as nrp:
        assert nrp.num_points == rp.model.num_points
        assert nrp.num_modes == rp.model.num_modes
        assert nrp.period == pytest.approx(rp.model.period)
        np.testing.assert_allclose(nrp.points, rp.model.points, atol=1e-11)

        ts = np.array([0.0, 0.123, 0.5 * nrp.period, 0.999 * nrp.period])
        np.testing.assert_allclose(nrp.eval_batch(ts), rp.batch(ts), atol=1e-9)
        # single-time path + alpha semantics
        np.testing.assert_allclose(nrp.eval(0.123, alpha=2.0),
                                   rp(0.123, alpha=2.0), atol=1e-9)


@needs_cc
def test_native_c_replayer_bad_model(tmp_path):
    with pytest.raises(RuntimeError):
        native.NativePODFSReplayer(str(tmp_path / "nonexistent"))


@needs_cc
def test_native_c_replayer_ragged_counts(tmp_path):
    """With et<1 the per-mode coefficient counts differ (ragged PODFS.dat);
    the C loader's offset bookkeeping must still match the evaluator."""
    out = tmp_path / "PODFS"
    run_pipeline(_cfg(out, jma=8, kma=9, ln=1.5, num_modes=5, et=0.85,
                      nsteps=16, hdf5=False), device="cpu")
    rp = replay.Replayer(replay.load_prf(str(out)), device="cpu")
    counts = rp.model.counts
    assert len(set(counts.tolist())) > 1, "fixture should be ragged"
    with native.NativePODFSReplayer(str(out)) as nrp:
        ts = np.linspace(0.0, 1.7 * nrp.period, 7)
        np.testing.assert_allclose(nrp.eval_batch(ts), rp.batch(ts),
                                   atol=1e-9)


@needs_cc
def test_native_c_replayer_rejects_corrupt_model(model_run, tmp_path):
    """Truncated rows / trailing garbage fail podfs_load loudly (NULL)
    instead of silently defining a smaller model."""
    cfg, _ = model_run

    bad = tmp_path / "trunc_mean"
    shutil.copytree(cfg.outdir, bad)
    mean_path = bad / "PODFS_mean.prf"
    lines = mean_path.read_text().splitlines(keepends=True)
    lines[-1] = ",".join(lines[-1].split(",")[:4]) + "\n"  # 4 of 6 columns
    mean_path.write_text("".join(lines))
    with pytest.raises(RuntimeError):
        native.NativePODFSReplayer(str(bad))

    bad2 = tmp_path / "garbage_dat"
    shutil.copytree(cfg.outdir, bad2)
    with open(bad2 / "PODFS.dat", "a") as f:
        f.write("unexpected trailing text\n")
    with pytest.raises(RuntimeError):
        native.NativePODFSReplayer(str(bad2))

    bad3 = tmp_path / "corrupt_mode"
    shutil.copytree(cfg.outdir, bad3)
    mode_path = bad3 / "PODFS_mode_0001.prf"
    txt = mode_path.read_text().splitlines(keepends=True)
    k = len(txt) // 2
    txt[k] = "x" + txt[k]
    mode_path.write_text("".join(txt))
    with pytest.raises(RuntimeError):
        native.NativePODFSReplayer(str(bad3))


def test_c_sources_are_copies():
    """The port's C replay library is the JAX package's, byte for byte (the
    solver-side API does not fork)."""
    for name in ("podfs_replay.c", "podfs_replay.h"):
        with open(os.path.join(REPO, "pods_digital_filter_tpu", "native",
                               name), "rb") as f:
            want = f.read()
        with open(os.path.join(REPO, "pods_digital_filter_tpu_torch",
                               "native", name), "rb") as f:
            assert f.read() == want, name


def test_solver_stub_links_and_runs(tmp_path):
    """examples/solver_inlet_stub.c (read as it is) compiles against the
    port's podfs_replay.h, links the port's podfs_replay.c built as
    libpodfs_replay.so, and replays a model the port wrote."""
    cc = shutil.which("cc") or shutil.which("gcc")
    if cc is None:
        pytest.skip("no C compiler")
    outdir = str(tmp_path / "PODFS")
    run_pipeline(_cfg(outdir, jma=6, kma=5, ln=1.5, num_modes=3, et=0.9,
                      nsteps=6, hdf5=False), device="cpu")

    ndir = os.path.join(REPO, "pods_digital_filter_tpu_torch", "native")
    lib = str(tmp_path / "libpodfs_replay.so")
    exe = str(tmp_path / "solver_stub")
    subprocess.run([cc, "-O2", "-shared", "-fPIC",
                    os.path.join(ndir, "podfs_replay.c"), "-o", lib, "-lm"],
                   check=True, capture_output=True, timeout=120)
    subprocess.run([cc, "-O2", os.path.join(REPO, "examples",
                                            "solver_inlet_stub.c"),
                    "-o", exe, "-I", ndir, "-L", str(tmp_path),
                    "-lpodfs_replay", "-lm", f"-Wl,-rpath,{tmp_path}"],
                   check=True, capture_output=True, timeout=120)
    out = subprocess.run([exe, outdir, "5"], capture_output=True, text=True,
                         timeout=60)
    assert out.returncode == 0, out.stderr
    assert "OK np=30 nvars=3 nm=3" in out.stdout
    assert out.stdout.count("step ") == 5


# --- the reference's own model (tests/test_golden.py:53-103) -----------------

@pytest.fixture(scope="module")
def pod_npz():
    return np.load(os.path.join(GOLDEN, "ref_pod.npz"))


def test_replay_loads_reference_prf_model(pod_npz):
    m = replay.load_prf(RUN)
    assert m.num_modes == int(pod_npz["num_modes_trunc"])
    assert m.period == pytest.approx(float(pod_npz["period"]), rel=1e-12)
    assert m.columns == ("u", "v", "w")
    np.testing.assert_array_equal(m.counts, pod_npz["N_FC"])
    assert m.num_points == 10 * 11
    packed = []
    for i in range(m.num_modes):
        for j in range(int(m.counts[i])):
            packed.append((m.k[i, j], m.c_re[i, j], m.c_im[i, j]))
    np.testing.assert_allclose(np.asarray(packed), pod_npz["FC"],
                               rtol=1e-5, atol=1e-8)


def test_replay_loads_reference_hdf5_model(pod_npz):
    m = replay.load_hdf5(os.path.join(RUN, "PODFS.hdf5"))
    assert m.num_modes == int(pod_npz["num_modes_trunc"])
    assert m.period == pytest.approx(float(pod_npz["period"]), rel=1e-12)
    np.testing.assert_array_equal(m.counts, pod_npz["N_FC"])
    np.testing.assert_allclose(m.mean, pod_npz["mean_field"], atol=1e-12)


def test_reference_prf_and_hdf5_models_replay_identically():
    """As the original test, and each replay equal to JAX's (float64)."""
    mp = replay.Replayer(replay.load_prf(RUN), device="cpu")
    mh = replay.Replayer(replay.load_hdf5(os.path.join(RUN, "PODFS.hdf5")),
                         device="cpu")
    ts = np.linspace(0.0, mp.model.period, 6)
    # .prf coordinates/fields are float32-rounded by the reference's VTK
    # cell centers; hdf5 carries float64 — replayed fields agree to f32 eps
    np.testing.assert_allclose(mp.batch(ts), mh.batch(ts), rtol=1e-5, atol=1e-6)
    _close(mp.batch(ts), jreplay.Replayer(jreplay.load_prf(RUN)).batch(ts))
    _close(mh.batch(ts), jreplay.Replayer(
        jreplay.load_hdf5(os.path.join(RUN, "PODFS.hdf5"))).batch(ts))
