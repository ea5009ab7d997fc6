from okvis2_torch.factors.imu_factor import imu_residual
from okvis2_torch.factors.priors import (
    pose_prior_residual,
    relative_pose_residual,
    speed_bias_prior_residual,
)
from okvis2_torch.factors.reprojection import cauchy_weight, reprojection_residual

__all__ = [
    "reprojection_residual",
    "cauchy_weight",
    "imu_residual",
    "pose_prior_residual",
    "speed_bias_prior_residual",
    "relative_pose_residual",
]
