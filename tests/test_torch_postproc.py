"""The port's copy of ``postproc/`` (pods_digital_filter_tpu_torch/postproc/):
numpy and scipy on the host, so it must agree with the JAX package's
exactly — the same arrays, bit for bit, and byte-identical files.

Mirrors tests/test_postproc.py (10) and the two ``save_planes`` cases of
tests/test_multivar.py (:202-270), each also held to the original.
"""

import os

import numpy as np
import pytest

import torch_parity  # noqa: F401  (pins torch's thread count)

from pods_digital_filter_tpu.postproc import geometry as jgeo
from pods_digital_filter_tpu.postproc import planes as jpl
from pods_digital_filter_tpu.postproc import probes as jpb
from pods_digital_filter_tpu_torch.postproc import geometry as geo
from pods_digital_filter_tpu_torch.postproc import planes as pl
from pods_digital_filter_tpu_torch.postproc import probes as pb


def _same_bytes(a, b):
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read(), os.path.basename(a)


# ---------------------------------------------------------------- geometry

def test_polar_coordinates_clamps_axis():
    pts = np.array([[0.0, 0.0, 0.0], [0.0, 3.0, 4.0], [1.0, -1.0, 0.0]])
    r, theta = geo.polar_coordinates(pts, (0.0, 0.0, 0.0))
    assert r[0] == np.finfo(np.float32).eps          # PODFS.py:1104-1105
    np.testing.assert_allclose(r[1], 5.0)
    np.testing.assert_allclose(theta[2], np.pi)      # atan2(0, -1)
    for a, b in zip((r, theta), jgeo.polar_coordinates(pts, (0.0, 0.0, 0.0))):
        np.testing.assert_array_equal(a, b)


def test_cell_areas_unit_quad():
    pts = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
                    [2, 0, 0]], dtype=np.float64)
    areas, centers = geo.cell_areas(pts, np.array([[0, 1, 2, 3]]))
    np.testing.assert_allclose(areas, [1.0])
    np.testing.assert_allclose(centers[0], [0.5, 0.5, 0.0])
    tri, _ = geo.cell_areas(pts, np.array([[0, 1, 3]]))
    np.testing.assert_allclose(tri, [0.5])


def test_cell_volumes_unit_shapes():
    tet = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1]], float)
    np.testing.assert_allclose(
        geo.cell_volumes(tet, [np.arange(4)], [geo.VTK_TETRA]), [1.0 / 6.0],
        atol=1e-12)
    hexa = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
                     [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1]], float)
    np.testing.assert_allclose(
        geo.cell_volumes(hexa, [np.arange(8)], [geo.VTK_HEXAHEDRON]), [1.0],
        atol=1e-12)
    wedge = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0],
                      [0, 0, 1], [1, 0, 1], [0, 1, 1]], float)
    np.testing.assert_allclose(
        geo.cell_volumes(wedge, [np.arange(6)], [geo.VTK_WEDGE]), [0.5],
        atol=1e-12)
    pyr = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
                    [0.5, 0.5, 1.0]], float)
    np.testing.assert_allclose(
        geo.cell_volumes(pyr, [np.arange(5)], [geo.VTK_PYRAMID]), [1.0 / 3.0],
        atol=1e-12)


def test_cell_volumes_voxel_rejected():
    pts = np.zeros((8, 3))
    with pytest.raises(ValueError, match="[Vv]oxel"):
        geo.cell_volumes(pts, [np.arange(8)], [geo.VTK_VOXEL])


def test_cell_volumes_mixed_mesh():
    tet = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1]], float)
    hexa = np.array([[2, 0, 0], [3, 0, 0], [3, 1, 0], [2, 1, 0],
                     [2, 0, 1], [3, 0, 1], [3, 1, 1], [2, 1, 1]], float)
    pts = np.concatenate([tet, hexa])
    conn = [np.arange(4), 4 + np.arange(8)]
    v = geo.cell_volumes(pts, conn, [geo.VTK_TETRA, geo.VTK_HEXAHEDRON])
    np.testing.assert_allclose(v, [1.0 / 6.0, 1.0], atol=1e-12)


def test_geometry_matches_jax_on_a_distorted_mesh():
    """Every geometry function on random (distorted) cells equals the
    original's, bit for bit."""
    rng = np.random.default_rng(21)
    pts = rng.random((60, 3))
    quads = rng.integers(0, 60, (25, 4))
    tris = rng.integers(0, 60, (25, 3))
    for conn in (quads, tris):
        for a, b in zip(geo.cell_areas(pts, conn), jgeo.cell_areas(pts, conn)):
            np.testing.assert_array_equal(a, b)
    types = rng.choice([geo.VTK_TETRA, geo.VTK_HEXAHEDRON, geo.VTK_WEDGE,
                        geo.VTK_PYRAMID], 40)
    conn = [rng.integers(0, 60, 8) for _ in types]
    np.testing.assert_array_equal(geo.cell_volumes(pts, conn, types),
                                  jgeo.cell_volumes(pts, conn, types))
    for a, b in zip(geo.cell_polar_coordinates(pts, quads, (0.1, 0.5, 0.4)),
                    jgeo.cell_polar_coordinates(pts, quads, (0.1, 0.5, 0.4))):
        np.testing.assert_array_equal(a, b)


# ------------------------------------------------------------------ planes

@pytest.fixture
def volume():
    """A small box of scattered points with a linear field (exactly
    reproducible by linear interpolation)."""
    rng = np.random.RandomState(0)
    grid = np.stack(np.meshgrid(*[np.linspace(0, 1, 6)] * 3,
                                indexing="ij"), axis=-1).reshape(-1, 3)
    pts = np.concatenate([grid, rng.rand(200, 3)])
    vel = np.stack([2 * pts[:, 0] + 1,
                    pts[:, 1] - pts[:, 2],
                    3 * pts[:, 2]], axis=1)
    fields = {
        "velocity": vel,
        "k": pts[:, 0] + pts[:, 1],
        "epsilon": np.full(len(pts), 0.3),
    }
    return pts, fields


def test_extract_plane_linear_field(volume):
    pts, fields = volume
    plane = pl.extract_plane(pts, fields, normal=(1, 0, 0),
                             origin=(0.5, 0.5, 0.5), resolution=8,
                             extent=0.45)
    np.testing.assert_allclose(plane.points[:, 0], 0.5, atol=1e-12)
    np.testing.assert_allclose(plane.fields["velocity"][:, 0], 2.0, atol=1e-9)
    np.testing.assert_allclose(
        plane.fields["velocity"][:, 2], 3 * plane.points[:, 2], atol=1e-9)
    assert plane.connectivity.shape == (64, 4)


@pytest.mark.parametrize("normal,extent", [((1, 0, 0), 0.45),
                                           ((0.3, 1.0, -0.5), None)])
def test_extract_plane_matches_jax(volume, normal, extent):
    """The kept triangulation and KD-tree give the original's samples, bit
    for bit — inside the hull and (extent None: the plane spans the
    bounding diagonal) at the nearest-neighbour fill outside; twice, so the
    second call reads the kept structures."""
    pts, fields = volume
    want = jpl.extract_plane(pts, fields, normal, resolution=7, extent=extent)
    for _ in range(2):
        got = pl.extract_plane(pts, fields, normal, resolution=7,
                               extent=extent)
        np.testing.assert_array_equal(got.points, want.points)
        np.testing.assert_array_equal(got.connectivity, want.connectivity)
        for name in fields:
            np.testing.assert_array_equal(got.fields[name], want.fields[name])
    # another volume replaces the kept structures
    other = {k: v[:150] for k, v in fields.items()}
    np.testing.assert_array_equal(
        pl.extract_plane(pts[:150], other, normal, resolution=5).fields["k"],
        jpl.extract_plane(pts[:150], other, normal, resolution=5).fields["k"])


def test_save_planes_prf_and_pod_matrix(tmp_path, volume):
    pts, fields = volume
    res = 6
    n_cells = res * res
    out = {}
    for side, mod in (("torch", pl), ("jax", jpl)):
        specs = [mod.PlaneSpec("inlet", (1, 0, 0), (0.5, 0.5, 0.5), save=True,
                               pod=True, r_limits=(0.0, 10.0))]
        pod_matrix = {"inlet": np.zeros((3 * n_cells, 2))}
        paths = mod.save_planes(pts, fields, specs, time=0.1, snap_index=0,
                                outdir=str(tmp_path / side),
                                pod_matrix=pod_matrix, resolution=res)
        out[side] = (paths, pod_matrix)
    paths, pod_matrix = out["torch"]
    assert len(paths) == 1 and paths[0].endswith(".prf")
    with open(paths[0]) as f:
        head = f.read()
    assert "# inlet # name of the profile" in head
    assert "data,x,y,z,u,v,w,k,e" in head              # PODFS.py:676-677
    assert np.abs(pod_matrix["inlet"][:, 0]).max() > 0
    assert np.abs(pod_matrix["inlet"][:, 1]).max() == 0
    _same_bytes(paths[0], out["jax"][0][0])
    np.testing.assert_array_equal(pod_matrix["inlet"], out["jax"][1]["inlet"])


def test_save_planes_radius_mask(volume, tmp_path):
    pts, fields = volume
    specs = [pl.PlaneSpec("m", (1, 0, 0), (0.5, 0.5, 0.5), save=False,
                          pod=True, r_limits=(0.0, 1e-9))]
    pod_matrix = {"m": np.zeros((3 * 16, 1))}
    pl.save_planes(pts, fields, specs, 0.0, 0, str(tmp_path), pod_matrix,
                   resolution=4)
    np.testing.assert_allclose(pod_matrix["m"], 0.0)


def test_save_planes_multivar_packing(tmp_path):
    """The plane loop packs velocity + scalars into consecutive slots
    exactly like the reference (PODFS.py:706-734), and like the original."""
    g = np.linspace(0.0, 1.0, 6)
    X, Y, Z = np.meshgrid(g, g, g, indexing="ij")
    pts = np.stack([X, Y, Z], axis=-1).reshape(-1, 3)
    vel = np.stack([pts[:, 0], 2 * pts[:, 1], 3 * pts[:, 2]], axis=1)
    fields = {"velocity": vel, "k": pts[:, 0] + pts[:, 1],
              "epsilon": 2.0 * pts[:, 2] + 0.5}
    res = 8
    nc = res * res
    mats = {}
    for side, mod in (("torch", pl), ("jax", jpl)):
        spec = mod.PlaneSpec("p0", normal=(1.0, 0.0, 0.0), save=False, pod=True)
        mats[side] = {"p0": np.zeros((5 * nc, 2))}
        for i, t in enumerate((0.0, 0.1)):
            mod.save_planes(pts, fields, [spec], t, i, str(tmp_path),
                            pod_matrix=mats[side], resolution=res,
                            pod_vars=["velocity", "k", "epsilon"])
    col = mats["torch"]["p0"][:, 0]
    plane = pl.extract_plane(pts, fields, (1.0, 0.0, 0.0), resolution=res)
    np.testing.assert_allclose(col[:nc], plane.cell_field("velocity")[:, 0],
                               atol=1e-12)
    np.testing.assert_allclose(col[3 * nc:4 * nc], plane.cell_field("k"),
                               atol=1e-12)
    np.testing.assert_allclose(col[4 * nc:], plane.cell_field("epsilon"),
                               atol=1e-12)
    np.testing.assert_allclose(mats["torch"]["p0"][:, 1], col)
    np.testing.assert_array_equal(mats["torch"]["p0"], mats["jax"]["p0"])


def test_save_planes_polar_rotation(tmp_path):
    """spec.polar rotates vectors to (axial, radial, tangential) per cell
    (make_planes_polar, PODFS.py:711-720): a purely radial field maps to
    slot 2, zero tangential."""
    g = np.linspace(-1.0, 1.0, 7)
    X, Y, Z = np.meshgrid(g, g, g, indexing="ij")
    pts = np.stack([X, Y, Z], axis=-1).reshape(-1, 3)
    vel = np.stack([np.zeros(pts.shape[0]), pts[:, 1], pts[:, 2]], axis=1)
    res = 6
    nc = res * res
    spec = pl.PlaneSpec("p0", normal=(1.0, 0.0, 0.0), centre=(0.0, 0.0, 0.0),
                        save=False, pod=True, polar=True, r_limits=(0.0, 0.9))
    pod_matrix = {"p0": np.zeros((3 * nc, 1))}
    pl.save_planes(pts, {"velocity": vel}, [spec], 0.0, 0, str(tmp_path),
                   pod_matrix=pod_matrix, resolution=res, pod_vars=["velocity"])
    col = pod_matrix["p0"][:, 0]
    ur = col[nc:2 * nc]
    ut = col[2 * nc:]
    assert np.all(ur >= -1e-9)
    np.testing.assert_allclose(ut, 0.0, atol=1e-9)
    assert ur.max() > 0.3


def test_save_instants_vtk_and_images(tmp_path):
    """save_instants writes the original's VTK files byte for byte, and
    with make_images a contour PNG per instant, ``instant_%06d.png``
    (matplotlib is installed here).  The original's images raise on this
    5 x 6 plane (it hands contourf the (jma, kma) field where (kma, jma)
    is due): a fault of the JAX package that the port does not copy."""
    from pods_digital_filter_tpu.config import PlaneConfig as JPlaneConfig
    from pods_digital_filter_tpu.io.plane import make_inflow_plane as jplane
    from pods_digital_filter_tpu_torch.config import PlaneConfig
    from pods_digital_filter_tpu_torch.io.plane import make_inflow_plane

    rng = np.random.default_rng(3)
    geom = make_inflow_plane(PlaneConfig(jma=5, kma=6, res=0.1))
    A = rng.standard_normal((3 * 30, 4))
    mean = rng.standard_normal(3 * 30)
    times = [0.0, 0.1, 0.2, 0.3]
    got = pl.save_instants(A, mean, times, geom, str(tmp_path), indices=[1, 3],
                           make_images=True)
    os.makedirs(tmp_path / "jax")
    want = jpl.save_instants(A, mean, times,
                             jplane(JPlaneConfig(jma=5, kma=6, res=0.1)),
                             str(tmp_path / "jax"), indices=[1, 3])
    assert [os.path.basename(p) for p in got] == [os.path.basename(p) for p in want]
    for a, b in zip(got, want):
        _same_bytes(a, b)
    for i in (1, 3):
        with open(tmp_path / f"instant_{i:06d}.png", "rb") as f:
            assert f.read(8) == b"\x89PNG\r\n\x1a\n"
    with pytest.raises(TypeError, match="must match"):
        jpl.save_instants(A, mean, times,
                          jplane(JPlaneConfig(jma=5, kma=6, res=0.1)),
                          str(tmp_path / "jax"), indices=[1], make_images=True)


# ------------------------------------------------------------------ probes

def test_vi_dat_roundtrip(tmp_path):
    t = np.linspace(0, 1, 7)
    p = np.random.RandomState(1).randn(3, 7)
    path = pb.write_vi_dat(str(tmp_path / "probes"), t, p, fs=2.0,
                           fmax=[10.0, 20.0, 30.0])
    t2, p2 = pb.read_vi_dat(path)
    np.testing.assert_allclose(t2, t, atol=1e-9)
    np.testing.assert_allclose(p2, p, atol=1e-12)
    with open(path) as f:
        txt = f.read()
    assert "# No. of Sensors = 3" in txt
    assert "Variables = t,K1,K2,K3" in txt
    os.makedirs(tmp_path / "jax")
    _same_bytes(path, jpb.write_vi_dat(str(tmp_path / "jax" / "probes"), t, p,
                                       fs=2.0, fmax=[10.0, 20.0, 30.0]))


def test_inflow_roundtrip(tmp_path):
    rng = np.random.RandomState(2)
    num_cells, ns = 10, 4
    A = rng.randn(3 * num_cells, ns)
    paths = pb.write_inflow_data(A, num_cells, 3, str(tmp_path / "t"))
    A2 = pb.read_inflow_data(ns, num_cells, 3, str(tmp_path / "t"))
    np.testing.assert_allclose(A2, A, atol=1e-10)
    np.testing.assert_array_equal(
        A2, jpb.read_inflow_data(ns, num_cells, 3, str(tmp_path / "t")))
    for p, q in zip(paths, jpb.write_inflow_data(A, num_cells, 3,
                                                 str(tmp_path / "j"))):
        _same_bytes(p, q)
