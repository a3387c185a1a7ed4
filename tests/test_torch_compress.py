"""The port's PODFS compression of existing snapshot data
(pods_digital_filter_tpu_torch/compress.py), held to the JAX package's
``compress_snapshot_matrix`` on the same numpy ``A``.

Mirrors tests/test_compress.py (3) and the export, HDF5, replay, native
and VTK cases of tests/test_multivar.py (:94-196).  Parity runs both
sides in float64 (``dtype="float64"``; conftest turns on jax x64): models
are compared by their replays (mode signs are arbitrary), within 1e-10 of
the field's scale; the mean ``.prf`` files are byte-identical.
"""

import os

import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (pins torch's thread count)

from pods_digital_filter_tpu import compress as jcompress
from pods_digital_filter_tpu import replay as jreplay
from pods_digital_filter_tpu.variables import VariableSet as JVariableSet
from pods_digital_filter_tpu_torch import compress, native, replay
from pods_digital_filter_tpu_torch.io.prf import read_podfs_dat
from pods_digital_filter_tpu_torch.postproc.probes import write_inflow_data
from pods_digital_filter_tpu_torch.variables import VariableSet

REL = 1e-10


def _periodic_snapshots(npts=12, ns=16):
    """Two spatial patterns oscillating at distinct frequencies — POD must
    recover a 2-mode structure."""
    rng = np.random.RandomState(0)
    phi1 = rng.randn(3 * npts)
    phi2 = rng.randn(3 * npts)
    t = np.arange(ns)
    a1 = np.cos(2 * np.pi * 2 * t / ns)
    a2 = np.sin(2 * np.pi * 3 * t / ns)
    return 1.0 + np.outer(phi1, a1) + np.outer(phi2, a2)


def _replays_agree(dir_t, dir_j, ts):
    want = jreplay.Replayer(jreplay.load_prf(dir_j)).batch(ts)
    got = replay.Replayer(replay.load_prf(dir_t), device="cpu").batch(ts)
    np.testing.assert_allclose(got, want, rtol=0, atol=REL * np.abs(want).max())


def test_compress_end_to_end(tmp_path):
    npts, ns = 12, 16
    A = _periodic_snapshots(npts, ns)
    points = np.random.RandomState(1).rand(npts, 3)
    pr, fr, files = compress.compress_snapshot_matrix(
        A, points, dt=0.01, num_modes=4, energy_target=0.99,
        outdir=str(tmp_path / "out"), device="cpu")
    # rank-2 data -> 2 dominant eigenvalues
    assert pr.energy[1] > 1e3 * max(pr.energy[2], 1e-30)
    period, modes = read_podfs_dat(str(tmp_path / "out" / "PODFS.dat"))
    assert period == 16 * 0.01
    for m in modes[:2]:
        assert m.shape[0] in (2, 4)
        assert {abs(int(k)) for k in m[:, 0]} <= {2, 3}


@pytest.mark.parametrize("weighted", [False, True])
def test_compress_matches_jax(tmp_path, weighted):
    """The same A (float64 on both sides), with and without cell weights:
    the same spectrum, the same Fourier counts, a byte-identical mean .prf
    and models that replay the same fields."""
    rng = np.random.default_rng(5)
    npts, ns = 20, 24
    A = 1.0 + 0.1 * rng.standard_normal((3 * npts, ns))
    points = rng.random((npts, 3))
    w = rng.uniform(0.5, 2.0, npts) if weighted else None
    kw = dict(dt=0.02, num_modes=6, energy_target=0.9, cell_weights=w,
              dtype="float64")
    pt, ft, files_t = compress.compress_snapshot_matrix(
        A, points, outdir=str(tmp_path / "t"), device="cpu", **kw)
    pj, fj, files_j = jcompress.compress_snapshot_matrix(
        A, points, outdir=str(tmp_path / "j"), **kw)
    assert [os.path.basename(p) for p in files_t] == \
        [os.path.basename(p) for p in files_j]
    assert (pt.num_valid, pt.num_trunc) == (pj.num_valid, pj.num_trunc)
    np.testing.assert_allclose(pt.energy, pj.energy, rtol=0,
                               atol=1e-12 * pj.energy[0])
    np.testing.assert_array_equal(ft.counts, fj.counts)
    with open(tmp_path / "t" / "PODFS_mean.prf", "rb") as a, \
            open(tmp_path / "j" / "PODFS_mean.prf", "rb") as b:
        assert a.read() == b.read()
    _replays_agree(str(tmp_path / "t"), str(tmp_path / "j"),
                   np.arange(ns) * 0.02)


def test_compress_float32_default_and_tensor_input(tmp_path):
    """The default POD dtype is float32, as the original's; a tensor A is
    taken as it is."""
    A = _periodic_snapshots(10, 16)
    points = np.zeros((10, 3))
    out = {}
    for name, a in (("np", A), ("tensor", torch.as_tensor(A))):
        pr, _, _ = compress.compress_snapshot_matrix(
            a, points, 0.01, 4, 1.0, str(tmp_path / name), device="cpu")
        out[name] = pr
    np.testing.assert_array_equal(out["np"].energy, out["tensor"].energy)
    assert out["np"].spatial_modes.dtype == np.float32


def test_compress_cli_roundtrip(tmp_path):
    npts, ns = 8, 10
    A = _periodic_snapshots(npts, ns)
    write_inflow_data(A, npts, 3, str(tmp_path))
    pts = np.random.RandomState(2).rand(npts, 3)
    np.savetxt(str(tmp_path / "points.txt"), pts)
    rc = compress.main([
        "--input-dir", str(tmp_path), "--num-snapshots", str(ns),
        "--num-cells", str(npts), "--dt", "0.5",
        "--points", str(tmp_path / "points.txt"),
        "-m", "3", "--outdir", str(tmp_path / "out"), "-5", "--device", "cpu",
    ])
    assert rc == 0
    assert (tmp_path / "out" / "PODFS.dat").exists()
    assert (tmp_path / "out" / "PODFS.hdf5").exists()
    with open(tmp_path / "out" / "PODFS_mean.prf") as f:
        lines = f.read().splitlines()
    assert len(lines) == 11 + npts
    vals = [float(v) for v in lines[11].split(",")[3:]]
    np.testing.assert_allclose(vals, 1.0, atol=1e-5)


def test_compress_cli_multivar(tmp_path):
    """--vars through the CLI: a velocity + 2-scalar model exports with the
    right columns and replays through both loaders."""
    npts, ns = 8, 10
    rng = np.random.RandomState(3)
    A = 1.0 + 0.1 * rng.randn(5 * npts, ns)
    write_inflow_data(A, npts, 5, str(tmp_path))
    pts = rng.rand(npts, 3)
    np.savetxt(str(tmp_path / "points.txt"), pts)
    common = ["--input-dir", str(tmp_path), "--num-snapshots", str(ns),
              "--num-cells", str(npts), "--dt", "0.5"]
    rc = compress.main(common + [
        "--points", str(tmp_path / "points.txt"),
        "--vars", "velocity:3,k,epsilon",
        "-m", "3", "--outdir", str(tmp_path / "out"), "-5", "--device", "cpu",
    ])
    assert rc == 0

    m = replay.load_prf(str(tmp_path / "out"))
    assert m.num_slots == 5
    assert m.columns == ("u", "v", "w", "k", "epsilon")
    h = replay.load_hdf5(str(tmp_path / "out" / "PODFS.hdf5"))
    np.testing.assert_allclose(h.mean, m.mean, atol=1e-11)
    u = replay.Replayer(m, device="cpu")(0.25)
    assert u.shape == (npts, 5)

    with pytest.raises(ValueError, match="num-components"):
        compress.main(common + ["--num-components", "3", "--vars",
                                "velocity:3,k", "--outdir",
                                str(tmp_path / "out2"), "--device", "cpu"])


def test_compress_cli_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; the refusal needs a host without one")
    with pytest.raises(RuntimeError, match="cuda"):
        compress.main(["--num-snapshots", "2", "--num-cells", "2", "--dt",
                       "1", "--input-dir", str(tmp_path)])


# --- the multi-variable model (tests/test_multivar.py:75-196) ----------------

@pytest.fixture(scope="module")
def multivar_model(tmp_path_factory):
    rng = np.random.default_rng(7)
    npts, ns, dt = 30, 10, 0.05
    vs = VariableSet.parse("velocity:3,k,epsilon")
    points = rng.normal(size=(npts, 3))
    u = rng.normal(size=(npts, 3, ns)) + 1.0
    k = np.abs(rng.normal(size=(npts, ns))) + 0.5
    eps = np.abs(rng.normal(size=(npts, ns))) + 0.1
    A = vs.pack([u, k, eps])

    root = tmp_path_factory.mktemp("multivar")
    outdir, jdir = str(root / "PODFS"), str(root / "PODFS_jax")
    kw = dict(num_modes=ns, energy_target=1.0, write_hdf5=True,
              dtype="float64")
    pr, fr, files = compress.compress_snapshot_matrix(
        A, points, dt, outdir=outdir, varset=vs, device="cpu", **kw)
    jcompress.compress_snapshot_matrix(
        A, points, dt, outdir=jdir,
        varset=JVariableSet.parse("velocity:3,k,epsilon"), **kw)
    return dict(A=A, points=points, dt=dt, ns=ns, npts=npts, vs=vs,
                pr=pr, fr=fr, outdir=outdir, jdir=jdir)


def test_multivar_export_files(multivar_model):
    m = multivar_model
    assert os.path.exists(os.path.join(m["outdir"], "PODFS.dat"))
    cols = replay.read_prf_columns(os.path.join(m["outdir"], "PODFS_mean.prf"))
    assert cols == ("u", "v", "w", "k", "epsilon")
    assert sorted(os.listdir(m["outdir"])) == sorted(os.listdir(m["jdir"]))


def test_multivar_hdf5_attrs(multivar_model):
    import h5py

    m = multivar_model
    with h5py.File(os.path.join(m["outdir"], "PODFS.hdf5")) as f:
        mean = f["main/mean"]
        assert int(mean.attrs["Nvar"]) == 8          # x,y,z + 5 slots
        assert mean.attrs["Vars"] == b"x,y,z,u,v,w,k,epsilon,dummy"
        assert list(mean.attrs["SF"]) == [1.0] * 8
        assert int(mean.attrs["Np"]) == m["npts"]


def test_multivar_replay_roundtrip(multivar_model):
    """et=1.0 model: replay at the snapshot times reproduces the truncated
    POD reconstruction of all 5 slots, from both flavors; and the port's
    model replays the JAX model's fields (float64)."""
    m = multivar_model
    pr = m["pr"]
    mean = m["A"].mean(axis=1)
    want = (mean[:, None]
            + pr.spatial_modes @ pr.temporal_modes[:, :pr.num_trunc].T)
    ts = np.arange(m["ns"]) * m["dt"]
    for model in (replay.load_prf(m["outdir"]),
                  replay.load_hdf5(os.path.join(m["outdir"], "PODFS.hdf5"))):
        assert model.num_slots == 5
        assert model.columns == ("u", "v", "w", "k", "epsilon")
        got = replay.Replayer(model, device="cpu").batch(ts)   # (Ns, Np, 5)
        assert got.shape == (m["ns"], m["npts"], 5)
        got_packed = got.transpose(0, 2, 1).reshape(m["ns"], 5 * m["npts"]).T
        np.testing.assert_allclose(got_packed, want, atol=1e-6)
    _replays_agree(m["outdir"], m["jdir"], ts)


def test_multivar_native_c_replayer(multivar_model):
    """The port's C evaluator handles multi-var models as its Replayer does
    (nvars from the .prf data header)."""
    if not native.podfs_replay_available():
        pytest.skip("no C compiler")
    m = multivar_model
    rp = replay.Replayer(replay.load_prf(m["outdir"]), device="cpu")
    ts = np.linspace(0.0, rp.model.period, 6)
    with native.NativePODFSReplayer(m["outdir"]) as c:
        assert c.num_vars == 5
        assert c.num_points == m["npts"]
        got = c.eval_batch(ts)
        assert got.shape == (6, m["npts"], 5)
    np.testing.assert_allclose(got, rp.batch(ts), atol=1e-9)


def test_multivar_vtk_mode_writer(multivar_model, tmp_path):
    """Multi-var VTK array layout (PODFS.py:299-345) from the port's copied
    writer, byte-identical to the original's."""
    from types import SimpleNamespace

    from pods_digital_filter_tpu.io import vtk as jvtk
    from pods_digital_filter_tpu_torch.io import vtk as vtk_io

    m = multivar_model
    jma, kma = 5, 6
    n_cells = jma * kma
    vs = m["vs"]
    packed = np.arange(vs.num_slots * n_cells, dtype=np.float64)
    nodes = np.stack(np.meshgrid(np.arange(jma + 1), np.arange(kma + 1),
                                 indexing="ij"), axis=-1).reshape(-1, 2)
    node_points = np.concatenate([np.zeros((nodes.shape[0], 1)), nodes], axis=1)
    geom = SimpleNamespace(config=SimpleNamespace(jma=jma, kma=kma),
                           node_points=node_points)

    paths = vtk_io.write_spatial_modes_vtk(str(tmp_path), packed[:, None], geom,
                                           varset=vs)
    assert paths == [os.path.join(
        str(tmp_path), "POD.spatial_mode_velocity,k,epsilon_0001.vtk")]
    d = vtk_io.read_unstructured_grid(paths[0])
    assert set(d["point_data"]) == {
        "velocity_1_POD", "velocity_2_POD", "velocity_3_POD",
        "velocity_magnitude_POD", "velocity_POD", "k_POD", "epsilon_POD"}
    mean_vtk = vtk_io.write_mean_field_vtk(str(tmp_path), packed, geom,
                                           varset=vs)
    dm = vtk_io.read_unstructured_grid(mean_vtk)
    np.testing.assert_array_equal(dm["cell_data"]["k_POD"],
                                  packed[3 * n_cells:4 * n_cells])
    jdir = tmp_path / "jax"
    os.makedirs(jdir)
    jvs = JVariableSet.parse("velocity:3,k,epsilon")
    for pt, pj in ((paths[0], jvtk.write_spatial_modes_vtk(
            str(jdir), packed[:, None], geom, varset=jvs)[0]),
            (mean_vtk, jvtk.write_mean_field_vtk(str(jdir), packed, geom,
                                                 varset=jvs))):
        with open(pt, "rb") as a, open(pj, "rb") as b:
            assert a.read() == b.read()
