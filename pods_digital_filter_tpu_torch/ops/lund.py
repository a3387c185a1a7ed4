"""Lund/Cholesky Reynolds-stress colouring — port of
``pods_digital_filter_tpu/ops/lund.py``.

Per point, the lower-triangular factor ``A`` of the target stress tensor

    R = [[uu, uv, uw],
         [uv, vv, vw],
         [uw, vw, ww]]

colours unit-variance noise ``x``: ``u = A @ x + U``, with the reference's
clamps (negative square-root arguments -> 0, zero pivots -> 0) and its
``+1e-20`` regularizer (digitalfilters.py:196-223), branch-free.
"""

from __future__ import annotations

import torch


def lund_cholesky(uu, vv, ww, uv, uw, vw):
    """Batched lower-triangular Cholesky factor with the reference's clamping
    semantics.  Tensor inputs broadcast elementwise; returns the six
    nonzero entries ``(a00, a10, a11, a20, a21, a22)``."""
    eps = 1e-20
    a00 = torch.sqrt(torch.clamp(uu, min=0.0))
    a10 = torch.where(a00 > 0.0, uv / (a00 + eps), 0.0)
    a11 = torch.sqrt(torch.clamp(vv - a10 * a10, min=0.0))
    a20 = torch.where(a00 > 0.0, uw / (a00 + eps), 0.0)
    a21 = torch.where(a11 > 0.0, (vw - a10 * a20) / (a11 + eps), 0.0)
    a22 = torch.sqrt(torch.clamp(ww - a20 * a20 - a21 * a21, min=0.0))
    return a00, a10, a11, a20, a21, a22


def apply_lund(xu, xv, xw, uu, vv, ww, uv, uw, vw, mean_u, mean_v, mean_w):
    """Colour unit-variance noise components with the target stresses and
    add the mean: ``(u, v, w) = A @ (xu, xv, xw) + (U, V, W)``; every
    argument broadcasts against the noise shape ``(..., jma, kma)``."""
    a00, a10, a11, a20, a21, a22 = lund_cholesky(uu, vv, ww, uv, uw, vw)
    u = a00 * xu + mean_u
    v = a10 * xu + a11 * xv + mean_v
    w = a20 * xu + a21 * xv + a22 * xw + mean_w
    return u, v, w


def apply_lund_stacked(noise, stresses, means):
    """noise ``(3, ..., jma, kma)``; stresses ``(uu, vv, ww, uv, uw, vw)`` and
    means ``(U, V, W)`` broadcastable to ``(..., jma, kma)`` (a stacked
    ``(6, ...)`` / ``(3, ...)`` tensor works too).  Returns the coloured
    velocity ``(3, ..., jma, kma)``."""
    u, v, w = apply_lund(noise[0], noise[1], noise[2],
                         stresses[0], stresses[1], stresses[2],
                         stresses[3], stresses[4], stresses[5],
                         means[0], means[1], means[2])
    return torch.stack([u, v, w], dim=0)
