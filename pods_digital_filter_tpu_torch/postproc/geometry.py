"""A copy of ``pods_digital_filter_tpu/postproc/geometry.py`` (numpy only).

Mesh geometry utilities, vectorized numpy (no VTK).

Reference: ``GetPolarCoordinates`` (PODFS.py:1087-1121),
``calculate_cell_volume`` (PODFS.py:1124-1227), ``calc_cell_areas``
(PODFS.py:891-946).  The reference iterates cells one VTK object at a time;
here every formula is applied to the whole mesh at once with batched
determinants/norms.
"""

from __future__ import annotations

import numpy as np

# VTK cell-type ids (the reference dispatches on these, PODFS.py:1129-1215)
VTK_TETRA = 10
VTK_VOXEL = 11
VTK_HEXAHEDRON = 12
VTK_WEDGE = 13
VTK_PYRAMID = 14

_EPS32 = float(np.finfo(np.float32).eps)


def polar_coordinates(points: np.ndarray, origin) -> tuple:
    """(r, theta) about the x-aligned axis through ``origin``
    (reference PODFS.py:1100-1109: r from (y, z) offsets, clamped to
    float32 eps; theta = atan2(z, y))."""
    points = np.asarray(points, dtype=np.float64)
    y = points[:, 1] - origin[1]
    z = points[:, 2] - origin[2]
    r = np.maximum(np.sqrt(y * y + z * z), _EPS32)
    theta = np.arctan2(z, y)
    return r, theta


def cell_polar_coordinates(points: np.ndarray, connectivity: np.ndarray,
                           origin) -> tuple:
    """Per-cell (r, theta) at the cell-vertex mean (PODFS.py:1111-1119)."""
    centers = np.asarray(points, dtype=np.float64)[connectivity].mean(axis=1)
    return polar_coordinates(centers, origin)


def _heron(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    la = np.linalg.norm(a - b, axis=-1)
    lb = np.linalg.norm(b - c, axis=-1)
    lc = np.linalg.norm(c - a, axis=-1)
    s = 0.5 * (la + lb + lc)
    return np.sqrt(np.maximum(s * (s - la) * (s - lb) * (s - lc), 0.0))


def cell_areas(points: np.ndarray, connectivity: np.ndarray) -> tuple:
    """Areas + centres of tri/quad cells via the Heron split the reference
    uses (``calc_cell_areas``, PODFS.py:891-946).  ``connectivity`` is
    (Nc, 3) or (Nc, 4)."""
    pts = np.asarray(points, dtype=np.float64)[connectivity]  # (Nc, npc, 3)
    npc = pts.shape[1]
    if npc == 3:
        areas = _heron(pts[:, 0], pts[:, 1], pts[:, 2])
    elif npc == 4:
        areas = (_heron(pts[:, 0], pts[:, 1], pts[:, 2])
                 + _heron(pts[:, 0], pts[:, 2], pts[:, 3]))
    else:
        raise ValueError(f"cells must be tris or quads; got {npc} nodes/cell")
    return areas, pts.mean(axis=1)


def _det4_ones(p0, p1, p2, p3) -> np.ndarray:
    """|det [1 p]| for four point sets, batched — the reference builds these
    4x4 matrices per cell for hex/wedge volumes (PODFS.py:1160-1196)."""
    m = np.stack([
        np.concatenate([np.ones_like(p0[..., :1]), p0], axis=-1),
        np.concatenate([np.ones_like(p1[..., :1]), p1], axis=-1),
        np.concatenate([np.ones_like(p2[..., :1]), p2], axis=-1),
        np.concatenate([np.ones_like(p3[..., :1]), p3], axis=-1),
    ], axis=-2)
    return np.abs(np.linalg.det(m))


def _tet_volumes(p: np.ndarray) -> np.ndarray:
    """Tet volume via base-triangle Heron area x height / 3
    (PODFS.py:1131-1152)."""
    area = _heron(p[:, 0], p[:, 1], p[:, 2])
    r = p[:, 1] - p[:, 0]
    s = p[:, 2] - p[:, 0]
    n = np.cross(r, s)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    h = np.abs(np.einsum("ij,ij->i", p[:, 3] - p[:, 0], n))
    return area * h / 3.0


def _hex_volumes(p: np.ndarray) -> np.ndarray:
    """5-tet decomposition.  Deviation (documented): the reference sums only
    the four corner tets (PODFS.py:1160-1182) and omits the central tet
    [p0, p2, p5, p7], underestimating every hex volume (unit cube -> 2/3);
    the fifth term below completes the decomposition."""
    v1 = _det4_ones(p[:, 0], p[:, 1], p[:, 2], p[:, 5])
    v2 = _det4_ones(p[:, 2], p[:, 5], p[:, 6], p[:, 7])
    v3 = _det4_ones(p[:, 0], p[:, 2], p[:, 3], p[:, 7])
    v4 = _det4_ones(p[:, 0], p[:, 4], p[:, 5], p[:, 7])
    v5 = _det4_ones(p[:, 0], p[:, 2], p[:, 5], p[:, 7])
    return (v1 + v2 + v3 + v4 + v5) / 6.0


def _wedge_volumes(p: np.ndarray) -> np.ndarray:
    v1 = _det4_ones(p[:, 0], p[:, 1], p[:, 2], p[:, 4])
    v2 = _det4_ones(p[:, 0], p[:, 2], p[:, 3], p[:, 4])
    v3 = _det4_ones(p[:, 2], p[:, 3], p[:, 4], p[:, 5])
    return (v1 + v2 + v3) / 6.0


def _pyramid_volumes(p: np.ndarray) -> np.ndarray:
    """Quad-base split into two Heron triangles x apex height / 3
    (PODFS.py:1198-1225)."""
    A = (_heron(p[:, 3], p[:, 2], p[:, 0]) + _heron(p[:, 2], p[:, 1], p[:, 0]))
    r = p[:, 1] - p[:, 3]
    s = p[:, 2] - p[:, 0]
    n = np.cross(r, s)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    h = np.abs(np.einsum("ij,ij->i", p[:, 4] - p[:, 2], n))
    return A * h / 3.0


_VOLUME_FNS = {
    VTK_TETRA: (_tet_volumes, 4),
    VTK_HEXAHEDRON: (_hex_volumes, 8),
    VTK_WEDGE: (_wedge_volumes, 6),
    VTK_PYRAMID: (_pyramid_volumes, 5),
}


def cell_volumes(points: np.ndarray, connectivity, cell_types) -> np.ndarray:
    """Analytic volumes for mixed tet/hex/wedge/pyramid meshes
    (``calculate_cell_volume``, PODFS.py:1124-1227; voxels are an error
    there too, PODFS.py:1154-1157).

    ``connectivity`` may be a (Nc, max_npc) padded int array or a list of
    index lists; ``cell_types`` is (Nc,) VTK type ids.
    """
    points = np.asarray(points, dtype=np.float64)
    cell_types = np.asarray(cell_types)
    n_cells = len(cell_types)
    vols = np.zeros(n_cells, dtype=np.float64)
    if np.any(cell_types == VTK_VOXEL):
        raise ValueError("Voxel detected, cannot calculate volume "
                         "(reference PODFS.py:1154-1157)")
    conn_rows = [np.asarray(c, dtype=np.int64) for c in connectivity]
    for ctype, (fn, npc) in _VOLUME_FNS.items():
        sel = np.nonzero(cell_types == ctype)[0]
        if sel.size == 0:
            continue
        idx = np.stack([conn_rows[i][:npc] for i in sel])
        vols[sel] = fn(points[idx])
    unknown = ~np.isin(cell_types, list(_VOLUME_FNS) + [VTK_VOXEL])
    if np.any(unknown):
        raise ValueError(
            f"unsupported cell types: {sorted(set(cell_types[unknown]))}")
    return vols
