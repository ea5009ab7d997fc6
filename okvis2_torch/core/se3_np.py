"""Pure-numpy SE(3) helpers on 7-vectors [r(3), q_xyzw(4)].

Port of ``okvis2_tpu/core/se3_np.py``, operation for operation: host-side
bookkeeping math (pose composition for packing, prediction, deltas) that
needs no device. The device programs use ``core/se3.Transformation``.

Reference role: okvis::kinematics::Transformation
(okvis_kinematics/include/okvis/kinematics/Transformation.hpp:56-274).
"""

from __future__ import annotations

import numpy as np


def quat_conj(q: np.ndarray) -> np.ndarray:
    return np.concatenate([-q[:3], q[3:4]])


def quat_mul(q1: np.ndarray, q2: np.ndarray) -> np.ndarray:
    v1, w1 = q1[:3], q1[3]
    v2, w2 = q2[:3], q2[3]
    v = w1 * v2 + w2 * v1 + np.cross(v1, v2)
    w = w1 * w2 - v1 @ v2
    q = np.concatenate([v, [w]])
    return q / np.linalg.norm(q)


def quat_to_mat(q: np.ndarray) -> np.ndarray:
    x, y, z, w = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
    ])


def compose7(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """T_a @ T_b on 7-vectors."""
    Ra = quat_to_mat(a[3:7])
    r = a[:3] + Ra @ b[:3]
    q = quat_mul(a[3:7], b[3:7])
    return np.concatenate([r, q])


def inverse7(a: np.ndarray) -> np.ndarray:
    qi = quat_conj(a[3:7])
    Ri = quat_to_mat(qi)
    return np.concatenate([-(Ri @ a[:3]), qi])


def apply7(a: np.ndarray, p: np.ndarray) -> np.ndarray:
    """Transform points p [...,3] by pose7 a."""
    return p @ quat_to_mat(a[3:7]).T + a[:3]


def log_so3(q: np.ndarray) -> np.ndarray:
    """Rotation-vector of quaternion q (xyzw)."""
    v = q[:3]
    n = np.linalg.norm(v)
    w = abs(q[3])
    if n < 1e-12:
        return 2.0 * np.sign(q[3] if q[3] != 0 else 1.0) * v
    ang = 2.0 * np.arctan2(n, w)
    s = np.sign(q[3]) if q[3] != 0 else 1.0
    return s * ang * v / n
