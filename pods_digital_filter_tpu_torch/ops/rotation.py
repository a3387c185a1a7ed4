"""Velocity-frame rotation onto the inlet-plane normal — port of
``pods_digital_filter_tpu/ops/rotation.py``.

``profile_rotation_matrix`` and ``rodrigues`` are numpy copies of the
originals (that module imports ``jax.numpy``); the two rotations of packed
and stacked velocity fields are torch.
"""

from __future__ import annotations

import numpy as np
import torch


def profile_rotation_matrix(nx: float, ny: float, nz: float) -> np.ndarray:
    """Rotation matrix R with R @ [1,0,0] == n, split azimuthal * polar
    (exact reference semantics incl. its sign conventions)."""
    n = np.sqrt(nx ** 2 + ny ** 2 + nz ** 2)
    n_proj = np.sqrt(nx ** 2 + ny ** 2)

    if ny > 0:
        azimuth = np.arccos(nx / n_proj)
    elif ny < 0:
        azimuth = -np.arccos(nx / n_proj)
    elif ny == 0 and nx >= 0:
        azimuth = 0.0
    else:  # ny == 0 and nx < 0
        azimuth = np.pi

    c, s = np.cos(azimuth), np.sin(azimuth)
    Ra = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])

    if nz > 0:
        polar = np.arccos(n_proj / n)
    elif nz < 0:
        polar = -np.arccos(n_proj / n)
    else:
        polar = 0.0

    c, s = np.cos(polar), np.sin(polar)
    Rp = np.array([[c, 0.0, -s], [0.0, 1.0, 0.0], [s, 0.0, c]])
    return Ra.dot(Rp)


def apply_rotation_packed(A: torch.Tensor, R: torch.Tensor) -> torch.Tensor:
    """``A`` packed ``[u(Np); v(Np); w(Np)]`` (trailing axes = snapshots)
    rotated by the (3, 3) matrix ``R`` of ``A``'s dtype and device."""
    pts = A.shape[0] // 3
    V = A.reshape((3, pts) + tuple(A.shape[1:]))
    return torch.tensordot(R, V, dims=([1], [0])).reshape(A.shape)


def rotate_velocity_packed(A: torch.Tensor, nx: float, ny: float,
                           nz: float) -> torch.Tensor:
    """Rotate a packed ``[u(Np); v(Np); w(Np)]`` vector (or a batch of them,
    trailing axis = snapshots) into the plane frame: one small matmul instead
    of the reference's per-point loop."""
    R = torch.as_tensor(profile_rotation_matrix(nx, ny, nz), dtype=A.dtype,
                        device=A.device)
    return apply_rotation_packed(A, R)


def rotate_velocity_fields(uvw: torch.Tensor, nx: float, ny: float,
                           nz: float) -> torch.Tensor:
    """Rotate stacked component fields ``(3, ...)`` into the plane frame."""
    R = torch.as_tensor(profile_rotation_matrix(nx, ny, nz), dtype=uvw.dtype,
                        device=uvw.device)
    return torch.tensordot(R, uvw, dims=([1], [0]))


def rodrigues(axis: np.ndarray, angle_rad: float) -> np.ndarray:
    """Rotation matrix about an arbitrary (not necessarily unit) axis —
    used by the plane-geometry builder (mirrors vtkTransform::RotateWXYZ)."""
    axis = np.asarray(axis, dtype=np.float64)
    nrm = np.linalg.norm(axis)
    if nrm == 0.0:
        return np.eye(3)
    x, y, z = axis / nrm
    c, s = np.cos(angle_rad), np.sin(angle_rad)
    t = 1.0 - c
    return np.array([
        [t * x * x + c,     t * x * y - s * z, t * x * z + s * y],
        [t * x * y + s * z, t * y * y + c,     t * y * z - s * x],
        [t * x * z - s * y, t * y * z + s * x, t * z * z + c],
    ])
