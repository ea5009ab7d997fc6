"""Unary/binary prior factors; port of ``okvis2_tpu/factors/priors.py``
(PoseError, SpeedAndBiasError, RelativePoseError roles), in the decoupled
[dr, dalpha] minimal coordinates of the pose manifold."""

from __future__ import annotations

import torch

from okvis2_torch.core import so3
from okvis2_torch.core.se3 import Transformation


def pose_prior_residual(
    T_WS: Transformation,
    T_WS_prior: Transformation,
    sqrt_info: torch.Tensor,  # [6,6]
) -> torch.Tensor:
    """Whitened 6-vector pose prior residual [dr, dalpha]."""
    dr = T_WS.r - T_WS_prior.r
    dq = so3.quat_multiply(T_WS.q, so3.quat_conjugate(T_WS_prior.q))
    return sqrt_info @ torch.cat([dr, so3.quat_log(dq)])


def speed_bias_prior_residual(
    sb: torch.Tensor,  # [9]
    sb_prior: torch.Tensor,  # [9]
    sqrt_info_diag: torch.Tensor,  # [9] diagonal whitening
) -> torch.Tensor:
    return sqrt_info_diag * (sb - sb_prior)


def relative_pose_residual(
    T_WA: Transformation,
    T_WB: Transformation,
    T_AB_meas: Transformation,
    sqrt_info: torch.Tensor,  # [6,6]
) -> torch.Tensor:
    """Whitened 6-vector relative-pose residual, in frame A."""
    T_AB_est = T_WA.inverse() @ T_WB
    dr = T_AB_est.r - T_AB_meas.r
    dq = so3.quat_multiply(T_AB_est.q, so3.quat_conjugate(T_AB_meas.q))
    return sqrt_info @ torch.cat([dr, so3.quat_log(dq)])
