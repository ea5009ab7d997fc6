"""Reprojection factor (2 residuals); port of
``okvis2_tpu/factors/reprojection.py``.

Whitening follows the reference: sqrt_info = (8 / keypoint_size) * I. The
solver differentiates the residual with ``torch.func.jacfwd``.
"""

from __future__ import annotations

import torch

from okvis2_torch.core.se3 import Transformation


def reprojection_residual(
    T_WS: Transformation,
    T_SC: Transformation,
    hp_W: torch.Tensor,  # [..., 4] homogeneous landmark in world
    uv_meas: torch.Tensor,  # [..., 2] measured keypoint
    camera,
    sqrt_info: torch.Tensor,  # [...]: scalar whitening (8 / keypoint size)
):
    """Whitened reprojection residual (r [..., 2], valid [...]); invalid
    projections yield a zero residual."""
    T_CW = (T_WS @ T_SC).inverse()
    hp_C = T_CW.apply_homogeneous(hp_W)
    uv_hat, valid = camera.project_homogeneous(hp_C)
    r = (uv_hat - uv_meas) * sqrt_info[..., None]
    r = torch.where(valid[..., None], r, torch.zeros_like(r))
    return r, valid


def cauchy_weight(squared_norm: torch.Tensor, scale: float = 1.0):
    """Cauchy robust-loss IRLS weight sqrt(rho'(s))."""
    s = squared_norm / (scale * scale)
    return torch.sqrt(1.0 / (1.0 + s))
