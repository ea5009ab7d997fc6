"""Trajectory metrics and CSV output.

Port of the evaluation half of ``okvis2_tpu/pipeline/trajectory.py``
(the reference's EuRoC evaluation, README.md:179-206, and TrajectoryOutput's
EuRoC CSV writer, okvis_multisensor_processing/src/TrajectoryOutput.cpp):
SE(3) Umeyama alignment, aligned ATE RMSE and the EuRoC estimate CSV.
Host numpy only.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


def write_euroc_csv(path: str, states: List[Tuple[float, np.ndarray]]):
    """EuRoC format: timestamp[ns], p_x, p_y, p_z, q_w, q_x, q_y, q_z."""
    with open(path, "w") as f:
        f.write("#timestamp,p_x,p_y,p_z,q_w,q_x,q_y,q_z\n")
        for t, p in states:
            f.write(
                f"{int(round(t*1e9))},{p[0]:.6f},{p[1]:.6f},{p[2]:.6f},"
                f"{p[6]:.6f},{p[3]:.6f},{p[4]:.6f},{p[5]:.6f}\n"
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
