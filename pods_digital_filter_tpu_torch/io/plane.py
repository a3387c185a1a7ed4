"""Inlet-plane geometry, VTK-free — a numpy copy of
``pods_digital_filter_tpu/io/plane.py`` (the original imports ``rodrigues``
from a module that loads jax).

Reference: ``make_inflow_plane`` (PODFS.py:1243-1290) builds the plane mesh
through a vtkPlaneSource + four chained vtkTransforms:

1. unit plane with ``SetResolution(kma, jma)`` (kma cells along the first
   axis, jma along the second) and ``SetNormal(1, 0, 0)`` — which rotates the
   default (0,0,1)-normal plane about +y by 90 deg, mapping a parametric
   point ``(px, py, 0)`` to ``(0, py, -px)``;
2. ``Scale(0, s2, s3)`` with ``s2 = res*jma^2/(jma-1)``,
   ``s3 = res*kma^2/(kma-1)``;
3. ``RotateWXYZ(alpha, (0, -nz, ny))`` with ``alpha = acos(nx)`` — takes
   (1,0,0) to the requested normal;
4. ``RotateWXYZ(beta + rot, n)`` with ``beta = atan2(nz, ny)`` — twist about
   the normal;
5. ``Translate(origin)``.

VTK cell ordering is x-resolution-fastest, so cell ``c = j*kma + i`` — which
is exactly the reference's snapshot packing ``p = j*kma + k``
(digitalfilters.py:1471-1473); cell centres are at parametric centres
``px = -0.5 + (i+0.5)/kma``, ``py = -0.5 + (j+0.5)/jma``.

Everything below reproduces those transforms in closed form with numpy.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from pods_digital_filter_tpu.config import PlaneConfig
from pods_digital_filter_tpu_torch.ops.rotation import rodrigues


@dataclass
class PlaneGeometry:
    """Replaces the reference's vtkPolyData ``grid`` on the main path."""

    config: PlaneConfig
    cell_centers: np.ndarray   # (jma*kma, 3), ordering p = j*kma + k
    node_points: np.ndarray    # ((jma+1)*(kma+1), 3)

    @property
    def num_cells(self) -> int:
        return self.config.num_points

    def cell_areas(self) -> np.ndarray:
        """Quad cell areas via the two-triangle Heron split
        (reference ``calc_cell_areas``, PODFS.py:891-946)."""
        jma, kma = self.config.jma, self.config.kma
        pts = self.node_points.reshape(jma + 1, kma + 1, 3)
        p00 = pts[:-1, :-1].reshape(-1, 3)
        p01 = pts[:-1, 1:].reshape(-1, 3)
        p11 = pts[1:, 1:].reshape(-1, 3)
        p10 = pts[1:, :-1].reshape(-1, 3)

        def heron(a, b, c):
            la = np.linalg.norm(a - b, axis=1)
            lb = np.linalg.norm(b - c, axis=1)
            lc = np.linalg.norm(c - a, axis=1)
            s = 0.5 * (la + lb + lc)
            return np.sqrt(np.maximum(s * (s - la) * (s - lb) * (s - lc), 0.0))

        return heron(p00, p01, p11) + heron(p00, p11, p10)


def _plane_transform(cfg: PlaneConfig) -> np.ndarray:
    nx, ny, nz = cfg.normal
    alpha = np.degrees(np.arccos(np.clip(nx, -1.0, 1.0)))
    beta = np.degrees(np.arctan2(nz, ny))
    R2 = rodrigues(np.array([0.0, -nz, ny]), np.radians(alpha))
    R3 = rodrigues(np.array([nx, ny, nz]), np.radians(beta + cfg.rot_deg))
    return R3 @ R2


def make_inflow_plane(cfg: PlaneConfig) -> PlaneGeometry:
    jma, kma = cfg.jma, cfg.kma
    s2 = cfg.res * float(jma) * float(jma) / (float(jma) - 1.0)
    s3 = cfg.res * float(kma) * float(kma) / (float(kma) - 1.0)

    # node points: after SetNormal(1,0,0) the parametric point (px, py, 0)
    # maps to (0, py, -px); then Scale(0, s2, s3).
    #
    # Float32 rounding chain, reproduced EXACTLY from the reference's VTK
    # pipeline (vtkPlaneSource -> one concatenated vtkTransform ->
    # vtkCellCenters, PODFS.py:1243-1290, 1700-1704): (1) the plane
    # source STORES its unit-plane points as float32; (2) the transform
    # applies in double and stores float32 again; (3) cell centers are
    # double-accumulated averages of those float32 points, stored float32.
    # Only this chain reproduces the reference's coordinates bit-for-bit
    # (e.g. z = 0.110000006855, where rounding the exact center gives
    # 0.109999999404) — making our .prf data rows byte-equal to files the
    # reference actually wrote
    # (tests/test_golden.py::test_mean_prf_full_file_bytes_match).
    iN = np.arange(kma + 1)
    jN = np.arange(jma + 1)
    pxN = (-0.5 + iN[None, :] / kma).astype(np.float32).astype(np.float64)
    pyN = (-0.5 + jN[:, None] / jma).astype(np.float32).astype(np.float64)
    nn = np.zeros((jma + 1, kma + 1, 3))
    nn[..., 1] = s2 * np.broadcast_to(pyN, (jma + 1, kma + 1))
    nn[..., 2] = -s3 * np.broadcast_to(pxN, (jma + 1, kma + 1))

    R = _plane_transform(cfg)
    origin = np.asarray(cfg.origin)
    nodes_grid = nn.reshape(-1, 3) @ R.T + origin
    nodes_grid = nodes_grid.astype(np.float32)
    ng = nodes_grid.reshape(jma + 1, kma + 1, 3).astype(np.float64)
    centers = ((ng[:-1, :-1] + ng[:-1, 1:] + ng[1:, :-1] + ng[1:, 1:])
               * 0.25).astype(np.float32).astype(np.float64)
    centers = centers.reshape(jma * kma, 3)
    nodes = nodes_grid.astype(np.float64)
    return PlaneGeometry(config=cfg, cell_centers=centers, node_points=nodes)
