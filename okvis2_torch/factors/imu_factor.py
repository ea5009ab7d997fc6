"""IMU preintegration factor (15 residuals); port of
``okvis2_tpu/factors/imu_factor.py``. Block order [dp, dalpha, dv, dbg,
dba], whitened by the preintegrated covariance's sqrt information. One
link at a time; the solver batches links with ``torch.func.vmap``.
"""

from __future__ import annotations

import torch

from okvis2_torch.core import so3
from okvis2_torch.core.se3 import Transformation
from okvis2_torch.imu.preintegration import ImuParameters, Preintegrated, correct_for_bias


def imu_residual(
    params: ImuParameters,
    pre: Preintegrated,
    T_WS0: Transformation,
    sb0: torch.Tensor,  # [9] = [v_W, bg, ba]
    T_WS1: Transformation,
    sb1: torch.Tensor,
) -> torch.Tensor:
    """Whitened 15-vector residual between two consecutive states."""
    v0, bg0, ba0 = sb0[0:3], sb0[3:6], sb0[6:9]
    v1, bg1, ba1 = sb1[0:3], sb1[3:6], sb1[6:9]
    dt = pre.dt_total
    g_W = params.gravity_w
    C_WS0 = so3.quat_to_matrix(T_WS0.q)
    C_SW0 = C_WS0.T

    dq_hat, dv_hat, dp_hat = correct_for_bias(pre, bg0, ba0)

    # measured-vs-estimated deltas, expressed in S0
    dp_est = C_SW0 @ (T_WS1.r - T_WS0.r - v0 * dt - 0.5 * g_W * dt * dt)
    dv_est = C_SW0 @ (v1 - v0 - g_W * dt)
    q_est = so3.quat_multiply(so3.quat_conjugate(T_WS0.q), T_WS1.q)
    # left rotation error on the preintegrated rotation
    dq_err = so3.quat_multiply(q_est, so3.quat_conjugate(dq_hat))

    r = torch.cat(
        [
            dp_est - dp_hat,
            so3.quat_log(dq_err),
            dv_est - dv_hat,
            bg1 - bg0,
            ba1 - ba0,
        ]
    )
    return pre.sqrt_info @ r
