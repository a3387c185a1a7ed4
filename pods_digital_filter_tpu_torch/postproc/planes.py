"""A copy of ``pods_digital_filter_tpu/postproc/planes.py`` (numpy and
scipy), with two changes.  :func:`save_instants` draws its images from the
(jma, kma) field transposed, where the original raises for jma != kma.
And, leaving every result as it was, :func:`extract_plane` triangulates a
volume mesh once and keeps the triangulation and its KD-tree for the next
call on the same points.  The
original builds a ``LinearNDInterpolator`` (a 3-D Delaunay triangulation)
for every field of every call, and with it a ``NearestNDInterpolator``
(a KD-tree) wherever the plane leaves the hull; a snapshot loop over one
LES mesh then triangulates it once per field per snapshot (about 10 s each
at 64^3 cells).  The interpolators given the kept triangulation, and the
tree's nearest points, are the ones the original builds anew.

Plane sampling of LES volume data + snapshot-plane export (VTK-free).

Reference: ``extract_plane`` (PODFS.py:515-581) probes a vtkPlaneSource grid
against a volume dataset with vtkProbeFilter; ``save_Planes``
(PODFS.py:623-852) loops configured planes per snapshot, writes ``.prf``
profile files with k-epsilon / k-omega headers and assembles the POD input
matrix with optional polar radius masking.  Here the probe is a vectorized
scipy interpolation and everything else is plain numpy.  The contour images
of :func:`save_instants` need matplotlib; without it they are skipped with a
printed line.
"""

from __future__ import annotations

import hashlib
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np
from scipy.interpolate import LinearNDInterpolator
from scipy.spatial import Delaunay, cKDTree

from pods_digital_filter_tpu_torch.postproc.geometry import (
    cell_areas, polar_coordinates)


@dataclass
class PlaneSample:
    """A sampling plane grid + fields probed from a volume."""
    points: np.ndarray                # (Np, 3) plane node points
    connectivity: np.ndarray          # (Nc, 4) quad cells
    fields: Dict[str, np.ndarray]     # name -> (Np,) or (Np, 3) point data

    @property
    def num_points(self) -> int:
        return self.points.shape[0]

    def cell_field(self, name: str) -> np.ndarray:
        """Point -> cell averaging (the reference's vtkPointDataToCellData,
        PODFS.py:694-696)."""
        return self.fields[name][self.connectivity].mean(axis=1)

    def areas(self):
        return cell_areas(self.points, self.connectivity)


def _plane_basis(normal: np.ndarray) -> tuple:
    n = np.asarray(normal, dtype=np.float64)
    n = n / np.linalg.norm(n)
    helper = np.array([0.0, 0.0, 1.0]) if abs(n[2]) < 0.9 \
        else np.array([0.0, 1.0, 0.0])
    e1 = np.cross(helper, n)
    e1 /= np.linalg.norm(e1)
    e2 = np.cross(n, e1)
    return e1, e2


#: the last volume mesh's (key, Delaunay triangulation, KD-tree), replaced
#: as one tuple so a caller never pairs one mesh's key with another's tree
_SEARCH = [None]


def _search_structures(pts: np.ndarray):
    """The Delaunay triangulation and KD-tree of ``pts``, kept for the next
    call on the same points (keyed by shape and a hash of the bytes)."""
    key = (pts.shape, hashlib.blake2b(pts.tobytes(), digest_size=16).digest())
    kept = _SEARCH[0]
    if kept is None or kept[0] != key:
        kept = (key, Delaunay(pts), cKDTree(pts))
        _SEARCH[0] = kept
    return kept[1], kept[2]


def extract_plane(
    volume_points: np.ndarray,
    volume_fields: Dict[str, np.ndarray],
    normal,
    origin=None,
    resolution: int = 50,
    extent: Optional[float] = None,
) -> PlaneSample:
    """Sample a plane (``normal`` through ``origin``) out of scattered volume
    point data — the VTK-free ``extract_plane`` (PODFS.py:515-581).

    The plane grid spans the volume bounds (the reference scales its
    vtkPlaneSource by the dataset bounds, PODFS.py:536-540) unless ``extent``
    overrides the half-width.  Fields are probed with linear scattered-data
    interpolation, nearest-neighbour outside the convex hull (the probe
    filter's out-of-domain points get nearest values rather than NaN holes).
    """
    pts = np.asarray(volume_points, dtype=np.float64)
    lo, hi = pts.min(axis=0), pts.max(axis=0)
    if origin is None:
        origin = 0.5 * (lo + hi)         # dataset centre (PODFS.py:546-552)
    origin = np.asarray(origin, dtype=np.float64)
    half = float(extent) if extent is not None else 0.5 * float(
        np.linalg.norm(hi - lo))

    e1, e2 = _plane_basis(normal)
    s = np.linspace(-half, half, resolution + 1)
    uu, vv = np.meshgrid(s, s, indexing="ij")
    plane_pts = (origin[None, :]
                 + uu.reshape(-1, 1) * e1[None, :]
                 + vv.reshape(-1, 1) * e2[None, :])

    n1 = resolution + 1
    j, i = np.meshgrid(np.arange(resolution), np.arange(resolution),
                       indexing="ij")
    n00 = j * n1 + i
    conn = np.stack([n00, n00 + 1, n00 + 1 + n1, n00 + n1],
                    axis=-1).reshape(-1, 4)

    tri, tree = _search_structures(pts)
    sampled = {}
    for name, vals in volume_fields.items():
        vals = np.asarray(vals, dtype=np.float64)
        lin = LinearNDInterpolator(tri, vals)
        out = lin(plane_pts)
        bad = np.isnan(out if out.ndim == 1 else out[:, 0])
        if np.any(bad):
            # NearestNDInterpolator's own query of the same tree
            out[bad] = vals[tree.query(plane_pts[bad])[1]]
        sampled[name] = out
    return PlaneSample(points=plane_pts, connectivity=conn, fields=sampled)


@dataclass
class PlaneSpec:
    """One configured plane of the legacy postprocessor (the reference reads
    these from ``i_d.plane_names/plane_normals/plane_centres``,
    PODFS.py:636-644)."""
    name: str
    normal: Sequence[float]
    centre: Optional[Sequence[float]] = None
    save: bool = True                 # write per-snapshot .prf
    pod: bool = False                 # accumulate into the POD input matrix
    r_limits: Optional[tuple] = None  # (r_in, r_out) polar mask (POD_planes_rin/rout)
    polar: bool = False               # rotate vector fields to (axial, radial,
                                      # tangential) per cell before packing
                                      # (make_planes_polar, PODFS.py:711-720)


_PRF_DATA_ROW = {
    "k_epsilon": "data,x,y,z,u,v,w,k,e\n",
    "k_omega": "data,x,y,z,u,v,w,k,sdr\n",
}


def write_plane_prf(
    path: str,
    plane: PlaneSample,
    name: str,
    normal,
    plane_rhs: float,
    turbulence_model: str = "k_epsilon",
    vel: str = "velocity",
    tke: str = "k",
    eps: str = "epsilon",
) -> str:
    """Per-snapshot ``.prf`` with the reference's header + row layout
    (PODFS.py:663-685)."""
    u = plane.fields[vel]
    k = plane.fields[tke]
    e = plane.fields[eps]
    with open(path, "w") as f:
        f.write(f"# {name} # name of the profile\n")
        f.write(f"# turbulence model, {turbulence_model}\n")
        f.write("# plane normal and translation "
                f"{normal[0]}\t{normal[1]}\t{normal[2]}\t{plane_rhs}\n")
        f.write("type, xyz # type of profile (rad or xyz)\n")
        f.write("localcs,origin,0,0,0 # origin of local coordinate system\n")
        f.write("localcs,xaxis,1,0,0 # x axis direction of local coordinate system\n")
        f.write("localcs,yaxis,0,1,0 # y axis direction of local coordinate system\n")
        f.write("localcs,zaxis,0,0,1 # z axis direction of local coordinate system\n")
        f.write("tolerance, 1.00E-08 # tolerance\n")
        f.write("scale,1,1,1,1,1,1,1,1 # scaling factors\n")
        f.write(_PRF_DATA_ROW.get(turbulence_model, _PRF_DATA_ROW["k_epsilon"]))
        P = plane.points
        for i in range(plane.num_points):
            f.write(f"{P[i, 0]},{P[i, 1]},{P[i, 2]},"
                    f"{u[i, 0]},{u[i, 1]},{u[i, 2]},{k[i]},{e[i]}\n")
    return path


def save_planes(
    volume_points: np.ndarray,
    volume_fields: Dict[str, np.ndarray],
    specs: Sequence[PlaneSpec],
    time: float,
    snap_index: int,
    outdir: str,
    pod_matrix: Optional[Dict[str, np.ndarray]] = None,
    resolution: int = 50,
    turbulence_model: str = "k_epsilon",
    vel: str = "velocity",
    pod_vars: Optional[Sequence[str]] = None,
) -> List[str]:
    """One snapshot of the legacy postproc loop (``save_Planes``,
    PODFS.py:623-852): extract every configured plane, write ``.prf`` for
    ``save`` planes, and append the (masked) packed field column into
    ``pod_matrix[name]`` for ``pod`` planes.

    ``pod_vars`` lists the fields to pack (the reference's
    ``pp_var_name_list``, PODFS.py:706-734) — vectors (``(Np, 3)`` fields)
    occupy three consecutive slots, scalars one; default is the velocity
    field alone.  With ``spec.polar`` vector fields are rotated to (axial,
    radial, tangential) per cell before packing (``make_planes_polar``,
    PODFS.py:711-720).  ``pod_matrix`` maps plane name -> (S*Nc, Ns) array
    the caller allocates; column ``snap_index`` is filled here.  Returns
    written paths.
    """
    pod_vars = list(pod_vars) if pod_vars is not None else [vel]
    written = []
    for spec in specs:
        plane = extract_plane(volume_points, volume_fields, spec.normal,
                              spec.centre, resolution)
        if spec.save:
            pdir = os.path.join(outdir, "post", spec.name)
            os.makedirs(pdir, exist_ok=True)
            n = np.asarray(spec.normal, dtype=np.float64)
            centre = (np.asarray(spec.centre, dtype=np.float64)
                      if spec.centre is not None
                      else plane.points.mean(axis=0))
            rhs = float(centre @ n)
            path = os.path.join(pdir, f"{time:.5E}.prf")
            written.append(write_plane_prf(
                path, plane, spec.name, n, rhs, turbulence_model, vel=vel))
        if spec.pod and pod_matrix is not None:
            centre = (np.asarray(spec.centre, dtype=np.float64)
                      if spec.centre is not None
                      else plane.points.mean(axis=0))
            cell_pts = plane.points[plane.connectivity].mean(axis=1)
            mask = np.ones(cell_pts.shape[0])
            r, theta = polar_coordinates(cell_pts, centre)
            if spec.r_limits is not None:
                r_in, r_out = spec.r_limits
                # zero cells outside the target radii (PODFS.py:700-716)
                mask = ((r >= r_in) & (r <= r_out)).astype(np.float64)
            slots = []
            for name in pod_vars:
                fc = plane.cell_field(name)
                if fc.ndim == 2:                    # vector: 3 slots
                    if spec.polar:
                        # (axial, radial, tangential) — PODFS.py:711-720
                        ur = fc[:, 1] * np.cos(theta) + fc[:, 2] * np.sin(theta)
                        ut = -fc[:, 1] * np.sin(theta) + fc[:, 2] * np.cos(theta)
                        comps = [fc[:, 0], ur, ut]
                    else:
                        comps = [fc[:, k] for k in range(fc.shape[1])]
                    slots.extend(c * mask for c in comps)
                else:                               # scalar: 1 slot
                    slots.append(fc * mask)
            pod_matrix[spec.name][:, snap_index] = np.concatenate(slots)
    return written


def save_instants(
    A: np.ndarray,
    mean_field: np.ndarray,
    times: Sequence[float],
    geom,
    outdir: str,
    indices: Optional[Sequence[int]] = None,
    make_images: bool = False,
) -> List[str]:
    """Re-emit selected snapshots as VTK fields (+ optional contour images)
    — the modern ``save_instants`` (reference PODFS.py:949-1041, which
    re-rendered snapshot planes/cylinders to PNG).  The images are
    ``instant_%06d.png``, u on the (y, z) plane."""
    from pods_digital_filter_tpu_torch.diagnostics import load_plots
    from pods_digital_filter_tpu_torch.io import vtk as vtk_io

    indices = range(A.shape[1]) if indices is None else indices
    plots = load_plots("the instant contour images") if make_images else None
    written = []
    for i in indices:
        packed = A[:, i] + mean_field
        name = f"instant_{i:06d}"
        written.append(vtk_io.write_field_vtk(outdir, name, packed, geom))
        if plots is not None:
            cfg = geom.config
            u = packed[:cfg.num_points].reshape(cfg.jma, cfg.kma)
            # u.T: contourf takes Z as (len(z), len(y)); the original
            # passes u itself, which raises for jma != kma, and a path that
            # already ends in .png (contourf appends one: "*.png.png")
            plots.contourf(
                np.arange(cfg.jma), np.arange(cfg.kma), u.T,
                f"u @ t={times[i]:.4g}", os.path.join(outdir, name))
    return written
