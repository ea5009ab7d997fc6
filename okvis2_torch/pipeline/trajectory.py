"""Client-side trajectory, CSV output and trajectory metrics.

Port of ``okvis2_tpu/pipeline/trajectory.py``:

- ``Trajectory``: okvis::Trajectory (reference: okvis_common/include/okvis/
  ViInterface.hpp:183-274), the client's cache of optimised states, queried
  at any time by interpolation and rewritten when the backend updates
  history (loop closure);
- ``Propagator``: IMU dead-reckoning from the latest optimised state
  between backend updates (okvis::Propagator, ViInterface.hpp:72-140);
- TrajectoryOutput's CSV writers (okvis_multisensor_processing/src/
  TrajectoryOutput.cpp; EuRoC and RPG/TUM formats);
- the EuRoC evaluation (README.md:179-206): SE(3) Umeyama alignment and
  the aligned ATE RMSE.

Host numpy only.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np


class Trajectory:
    """Timestamp-indexed pose history with interpolation queries."""

    def __init__(self):
        self._states: Dict[int, Tuple[float, np.ndarray]] = {}
        self._order: List[int] = []

    def update(self, sid: int, t: float, pose: np.ndarray):
        if sid not in self._states:
            self._order.append(sid)
        self._states[sid] = (float(t), np.asarray(pose, np.float64).copy())

    def get_state(self, sid: int) -> Optional[Tuple[float, np.ndarray]]:
        return self._states.get(sid)

    def states(self) -> List[Tuple[float, np.ndarray]]:
        out = [self._states[i] for i in self._order]
        out.sort(key=lambda x: x[0])
        return out

    def state_at(self, t: float) -> Optional[np.ndarray]:
        """Linear/slerp interpolation between bracketing states."""
        st = self.states()
        if not st:
            return None
        ts = np.asarray([s[0] for s in st])
        i = int(np.searchsorted(ts, t))
        if i == 0:
            return st[0][1]
        if i >= len(st):
            return st[-1][1]
        t0, p0 = st[i - 1]
        t1, p1 = st[i]
        a = (t - t0) / max(t1 - t0, 1e-12)
        r = (1 - a) * p0[:3] + a * p1[:3]
        q0, q1 = p0[3:7], p1[3:7]
        if np.dot(q0, q1) < 0:
            q1 = -q1
        q = (1 - a) * q0 + a * q1
        q = q / np.linalg.norm(q)
        return np.concatenate([r, q])


class Propagator:
    """Lightweight host-side IMU dead-reckoning from the latest optimised
    state (okvis::Propagator role, ViInterface.hpp:72-140): supplies
    high-rate pose/speed estimates between backend updates for live
    publishing (Publisher::realtimePredictAndPublish analogue). Midpoint
    integration in numpy — per-sample device dispatch would dominate at
    200 Hz+."""

    def __init__(self, g: float = 9.81):
        self.g_W = np.asarray([0.0, 0.0, -g])
        self._state: Optional[Tuple[float, np.ndarray, np.ndarray]] = None
        self._last_imu: Optional[Tuple[float, np.ndarray, np.ndarray]] = None

    def set_state(self, t: float, pose: np.ndarray, speed_bias: np.ndarray):
        self._state = (float(t), pose.copy(), speed_bias.copy())

    @staticmethod
    def _quat_mul(q1, q2):
        x1, y1, z1, w1 = q1
        x2, y2, z2, w2 = q2
        return np.asarray([
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        ])

    @staticmethod
    def _rotate(q, v):
        qv = q[:3]
        w = q[3]
        t = 2.0 * np.cross(qv, v)
        return v + w * t + np.cross(qv, t)

    def add_imu_measurement(self, t: float, acc, gyr) -> Optional[np.ndarray]:
        """Advance the propagated state; returns current pose [7] or None."""
        if self._state is None:
            return None
        acc = np.asarray(acc, np.float64)
        gyr = np.asarray(gyr, np.float64)
        if self._last_imu is None or t <= self._last_imu[0]:
            self._last_imu = (t, acc, gyr)
            return self.current_pose()
        t0, a0, g0 = self._last_imu
        dt = t - t0
        st, pose, sb = self._state
        if t0 < st:
            self._last_imu = (t, acc, gyr)
            return self.current_pose()
        w = 0.5 * (g0 + gyr) - sb[3:6]
        a = 0.5 * (a0 + acc) - sb[6:9]
        q = pose[3:7]
        angle = w * dt
        n = np.linalg.norm(angle)
        if n > 1e-12:
            dq = np.concatenate([np.sin(n / 2) * angle / n, [np.cos(n / 2)]])
        else:
            dq = np.asarray([0.0, 0.0, 0.0, 1.0])
        q1 = self._quat_mul(q, dq)
        q1 /= np.linalg.norm(q1)
        a_W = self._rotate(q, a) + self.g_W
        v0 = sb[0:3]
        v1 = v0 + a_W * dt
        r1 = pose[:3] + v0 * dt + 0.5 * a_W * dt * dt
        pose1 = np.concatenate([r1, q1])
        sb1 = np.concatenate([v1, sb[3:9]])
        self._state = (t, pose1, sb1)
        self._last_imu = (t, acc, gyr)
        return pose1.copy()

    def current_pose(self) -> Optional[np.ndarray]:
        return None if self._state is None else self._state[1].copy()


def write_euroc_csv(path: str, states: List[Tuple[float, np.ndarray]]):
    """EuRoC format: timestamp[ns], p_x, p_y, p_z, q_w, q_x, q_y, q_z."""
    with open(path, "w") as f:
        f.write("#timestamp,p_x,p_y,p_z,q_w,q_x,q_y,q_z\n")
        for t, p in states:
            f.write(
                f"{int(round(t*1e9))},{p[0]:.6f},{p[1]:.6f},{p[2]:.6f},"
                f"{p[6]:.6f},{p[3]:.6f},{p[4]:.6f},{p[5]:.6f}\n"
            )


def write_rpg_csv(path: str, states: List[Tuple[float, np.ndarray]]):
    """RPG/TUM format: timestamp[s] tx ty tz qx qy qz qw."""
    with open(path, "w") as f:
        f.write("# timestamp tx ty tz qx qy qz qw\n")
        for t, p in states:
            f.write(
                f"{t:.9f} {p[0]:.6f} {p[1]:.6f} {p[2]:.6f} "
                f"{p[3]:.6f} {p[4]:.6f} {p[5]:.6f} {p[6]:.6f}\n"
            )


def align_umeyama(est: np.ndarray, gt: np.ndarray, with_scale: bool = False):
    """SE(3) (optionally Sim(3)) alignment of est -> gt point sets [N,3]."""
    mu_e = est.mean(axis=0)
    mu_g = gt.mean(axis=0)
    E = est - mu_e
    G = gt - mu_g
    C = G.T @ E / len(est)
    U, D, Vt = np.linalg.svd(C)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    s = float(np.trace(np.diag(D) @ S) / (E * E).sum(axis=None) * len(est)) \
        if with_scale else 1.0
    t = mu_g - s * R @ mu_e
    return s, R, t


def ate_rmse(
    est: List[Tuple[float, np.ndarray]],
    gt: List[Tuple[float, np.ndarray]],
    align: bool = True,
) -> float:
    """Absolute trajectory error RMSE after SE(3) alignment."""
    gt_ts = np.asarray([t for t, _ in gt])
    gt_ps = np.stack([p[:3] for _, p in gt])
    pairs_e, pairs_g = [], []
    for t, p in est:
        i = int(np.argmin(np.abs(gt_ts - t)))
        if abs(gt_ts[i] - t) < 0.05:
            pairs_e.append(p[:3])
            pairs_g.append(gt_ps[i])
    if len(pairs_e) < 3:
        return float("inf")
    E = np.stack(pairs_e)
    G = np.stack(pairs_g)
    if align:
        _, R, t = align_umeyama(E, G)
        E = E @ R.T + t
    return float(np.sqrt(np.mean(np.sum((E - G) ** 2, axis=-1))))
