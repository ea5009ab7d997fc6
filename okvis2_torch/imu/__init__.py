from okvis2_torch.imu.preintegration import (
    ImuParameters,
    Preintegrated,
    correct_for_bias,
    init_pose_from_accel,
    preintegrate,
    preintegrate_np,
    propagate_state_np,
)

__all__ = [
    "ImuParameters",
    "Preintegrated",
    "preintegrate",
    "correct_for_bias",
    "init_pose_from_accel",
    "preintegrate_np",
    "propagate_state_np",
]
