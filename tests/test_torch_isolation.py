"""The port stands alone: it runs on a host without jax and without the
JAX package, and its numpy copies of the JAX package's writers are exact.

* In a subprocess that refuses every import of ``jax``, ``jaxlib`` and
  ``pods_digital_filter_tpu``, every module of the port and its CLI
  import, and the CLI runs the main path end to end, the streaming POD
  (``--streaming_block``, with ``--checkpoint_dir``) and the checkpointed
  in-memory path; then the replay and compress entry points run on the
  model it wrote (and the C replayer reads it).
* No file of the port, and not ``chip_smoke.py``, has an import whose root
  is ``pods_digital_filter_tpu`` (an AST walk).
* The copied ``io/prf.py``, ``io/vtk.py``, ``io/plane.py`` and
  ``ops/fourier.py`` write byte-identical files to the originals for the
  same inputs, and the copied readers return the originals' arrays.
* ``chip_smoke.py`` imports the port and nothing of jax or the JAX package.
"""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest

import torch_parity  # noqa: F401  (pins torch's thread count)

from pods_digital_filter_tpu.config import PlaneConfig as JPlaneConfig
from pods_digital_filter_tpu.io import plane as jplane
from pods_digital_filter_tpu.io import prf as jprf
from pods_digital_filter_tpu.io import vtk as jvtk
from pods_digital_filter_tpu.ops import fourier as jfourier
from pods_digital_filter_tpu_torch.config import PlaneConfig as TPlaneConfig
from pods_digital_filter_tpu_torch.io import plane as tplane
from pods_digital_filter_tpu_torch.io import prf as tprf
from pods_digital_filter_tpu_torch.io import vtk as tvtk
from pods_digital_filter_tpu_torch.ops import fourier as tfourier

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_NO_JAX = r"""
import importlib, importlib.abc, pkgutil, sys

REFUSED = ("jax", "jaxlib", "pods_digital_filter_tpu")

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in REFUSED:
            raise ImportError("refused: " + name)
        return None

sys.meta_path.insert(0, Refuse())
import pods_digital_filter_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
from pods_digital_filter_tpu_torch import cli
common = ["-n", "6", "-m", "3", "-j", "6", "-k", "7", "--device", "cpu"]
assert cli.main(common + ["--pallas", "-v", "-5", "--outdir", "fused"]) == 0
assert cli.main(common + ["--dtype", "float64", "--outdir", "plain"]) == 0
assert cli.main(common + ["--pallas", "--streaming_block", "4", "--gram_group",
                          "2", "--eig_mode", "topk", "--checkpoint_dir",
                          "ck_stream", "--outdir", "stream"]) == 0
assert cli.main(common + ["--checkpoint_dir", "ck_mem", "--outdir", "ckpt"]) == 0
import numpy as np
from pods_digital_filter_tpu_torch import compress, native, replay
from pods_digital_filter_tpu_torch.postproc.probes import write_inflow_data
assert replay.main(["fused", "-n", "4", "--format", "npy", "--outdir",
                    "replayed", "--device", "cpu"]) == 0
m = replay.load_prf("fused")
ts = np.arange(8) * m.period / 8
A = replay.Replayer(m, device="cpu").batch_device(ts).numpy().T
if native.podfs_replay_available():
    with native.NativePODFSReplayer("fused") as c:
        assert np.abs(c.eval_batch(ts).transpose(0, 2, 1).reshape(8, -1).T
                      - A).max() < 1e-9
write_inflow_data(A, m.num_points, 3, "inflow")
assert compress.main(["--input-dir", "inflow", "--num-snapshots", "8",
                      "--num-cells", str(m.num_points), "--dt",
                      str(m.period / 8), "-m", "2", "--outdir", "compressed",
                      "--device", "cpu"]) == 0
print("MODULES", len(names), "REFUSED",
      any(m.split(".")[0] in REFUSED for m in sys.modules))
"""


def test_port_imports_and_runs_without_jax(tmp_path):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run([sys.executable, "-c", _NO_JAX], cwd=tmp_path,
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    line = [ln for ln in out.stdout.splitlines() if ln.startswith("MODULES")]
    assert line and line[0].endswith("REFUSED False"), out.stdout[-2000:]
    assert int(line[0].split()[1]) >= 20
    for d in ("fused", "plain", "stream", "ckpt", "compressed"):
        assert (tmp_path / d / "PODFS.dat").exists()
    assert (tmp_path / "replayed" / "fields.npy").exists()
    assert (tmp_path / "ck_stream" / "gram_meta.json").exists()
    assert (tmp_path / "ck_mem" / "meta.json").exists()
    assert (tmp_path / "fused" / "PODFS.hdf5").exists()


# --- byte equality of the copied writers ------------------------------------

@pytest.fixture(scope="module")
def model():
    rng = np.random.default_rng(41)
    kw = dict(jma=6, kma=7, res=0.05, normal=(1.0, 0.4, -0.3),
              origin=(0.5, -1.0, 2.0), rot_deg=15.0)
    cfg = {"jax": JPlaneConfig(**kw), "torch": TPlaneConfig(**kw)}
    npts = cfg["jax"].num_points
    temporal = rng.standard_normal((24, 5))
    return dict(cfg=cfg, mean=rng.standard_normal(3 * npts),
                modes=rng.standard_normal((3 * npts, 4)), temporal=temporal,
                energy=np.sort(rng.uniform(0.0, 2.0, 24))[::-1])


def test_plane_geometry_is_identical(model):
    g_j = jplane.make_inflow_plane(model["cfg"]["jax"])
    g_t = tplane.make_inflow_plane(model["cfg"]["torch"])
    np.testing.assert_array_equal(g_t.cell_centers, g_j.cell_centers)
    np.testing.assert_array_equal(g_t.node_points, g_j.node_points)
    np.testing.assert_array_equal(g_t.cell_areas(), g_j.cell_areas())


def test_fourier_compress_is_identical(model):
    fj = jfourier.fourier_compress(model["temporal"], 4, 0.01, 0.9)
    ft = tfourier.fourier_compress(model["temporal"], 4, 0.01, 0.9)
    for name in ("coeffs", "counts", "order", "reconstruction"):
        np.testing.assert_array_equal(getattr(ft, name), getattr(fj, name))
    assert ft.period == fj.period
    np.testing.assert_array_equal(ft.packed_fc(), fj.packed_fc())


def _write(side, kind, outdir, m):
    prf, vtk, plane, fourier = ((jprf, jvtk, jplane, jfourier) if side == "jax"
                                else (tprf, tvtk, tplane, tfourier))
    cfg = m["cfg"][side]
    geom = plane.make_inflow_plane(cfg)
    normal, origin = cfg.normal, cfg.origin
    if kind == "snapshot":
        return [prf.write_snapshot_prf(outdir, 0.125, m["mean"], geom, normal,
                                       origin)]
    if kind == "mean_mode":
        return [prf.write_mean_prf(outdir, m["mean"], geom, normal),
                prf.write_mode_prf(outdir, 3, m["modes"][:, 2], geom, normal)]
    if kind == "podfs_dat":
        fr = fourier.fourier_compress(m["temporal"], 4, 0.01, 0.9)
        return [prf.write_podfs_dat(outdir, fr)]
    if kind == "eigen_temporal":
        return ([prf.write_eigenvalues(outdir, 20, m["energy"]),
                 prf.write_initial_conditions(outdir, 5, m["energy"])]
                + prf.write_temporal_modes(outdir, 5, 0.01, m["temporal"]))
    if kind == "vtk":
        return ([vtk.write_mean_field_vtk(outdir, m["mean"], geom),
                 vtk.write_field_vtk(outdir, "snap", m["mean"], geom)]
                + vtk.write_spatial_modes_vtk(outdir, m["modes"], geom))
    raise ValueError(kind)


@pytest.mark.parametrize("kind", ["snapshot", "mean_mode", "podfs_dat",
                                  "eigen_temporal", "vtk"])
def test_copied_writers_are_byte_identical(tmp_path, model, kind):
    paths = {}
    for side in ("jax", "torch"):
        d = tmp_path / side
        os.makedirs(d)
        paths[side] = _write(side, kind, str(d), model)
    assert [os.path.basename(p) for p in paths["jax"]] == \
        [os.path.basename(p) for p in paths["torch"]]
    for pj, pt in zip(paths["jax"], paths["torch"]):
        with open(pj, "rb") as fj, open(pt, "rb") as ft:
            assert ft.read() == fj.read(), os.path.basename(pj)


@pytest.mark.parametrize("kind", ["mean_mode", "podfs_dat"])
def test_copied_readers_are_identical(tmp_path, model, kind):
    """The port's readers give the originals' arrays, exactly, on the same
    files (``read_field_prf`` is a copy of the one in ``replay.py``)."""
    from pods_digital_filter_tpu import replay as jreplay

    for path in _write("jax", kind, str(tmp_path), model):
        if kind == "podfs_dat":
            (pj, mj), (pt, mt) = jprf.read_podfs_dat(path), tprf.read_podfs_dat(path)
            assert pt == pj and len(mt) == len(mj)
            for a, b in zip(mt, mj):
                np.testing.assert_array_equal(a, b)
            continue
        for a, b in zip(tprf.read_field_prf(path), jreplay.read_field_prf(path)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def _import_roots(path):
    """The root package of every import in ``path`` (relative imports stay
    inside the port and are left out)."""
    with open(path) as f:
        tree = ast.parse(f.read())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and not node.level:
            names.append(node.module or "")
    return {n.split(".")[0] for n in names}


def test_chip_smoke_imports_only_the_port():
    """``chip_smoke.py`` runs where jax is absent: no import of its own may
    name jax or the JAX package, even one that loads without jax today."""
    roots = _import_roots(os.path.join(REPO, "chip_smoke.py"))
    assert "pods_digital_filter_tpu_torch" in roots
    assert not roots & {"jax", "jaxlib", "pods_digital_filter_tpu"}, sorted(roots)


def _port_files():
    """The port's ``.py`` files, without build outputs (``_build``)."""
    out = []
    for d, dirs, files in os.walk(os.path.join(REPO, "pods_digital_filter_tpu_torch")):
        dirs[:] = sorted(x for x in dirs if x not in ("_build", "__pycache__"))
        out += [os.path.relpath(os.path.join(d, f), REPO) for f in files
                if f.endswith(".py")]
    return sorted(out)


PORT_FILES = _port_files()


@pytest.mark.parametrize("path", PORT_FILES)
def test_port_file_imports_nothing_of_the_jax_package(path):
    """Every module of the port: no import whose root is the JAX package
    (nor jax), even inside a function."""
    roots = _import_roots(os.path.join(REPO, path))
    assert not roots & {"jax", "jaxlib", "pods_digital_filter_tpu"}, sorted(roots)


def test_port_files_are_walked():
    assert len(PORT_FILES) >= 30
    for name in ("config.py", "replay.py", "compress.py", "ops/signal.py",
                 "parallel/time_ops.py", "diagnostics/plots.py",
                 "postproc/geometry.py", "postproc/planes.py",
                 "postproc/probes.py"):
        assert "pods_digital_filter_tpu_torch/" + name in PORT_FILES, name
