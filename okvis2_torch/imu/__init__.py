from okvis2_torch.imu.preintegration import (
    ImuParameters,
    Preintegrated,
    correct_for_bias,
    preintegrate,
    preintegrate_np,
    propagate_state_np,
)

__all__ = [
    "ImuParameters",
    "Preintegrated",
    "preintegrate",
    "correct_for_bias",
    "preintegrate_np",
    "propagate_state_np",
]
