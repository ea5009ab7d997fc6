"""Run the VIO loop on the synthetic dataset.

Port of ``okvis2_tpu/pipeline/synthetic_run.py`` (star dataset, default
trajectory, synchronous or pipelined loop): renders stereo frames along the analytic
trajectory, feeds images and exact IMU through ``SlamSystem`` and
computes the aligned ATE against ground truth (the reference's validation
analogue: okvis_app_synchronous on EuRoC, README.md:179-206).
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from okvis2_torch import resolve_device
from okvis2_torch.cameras.distortion import RadialTangentialDistortion
from okvis2_torch.cameras.pinhole import PinholeCamera
from okvis2_torch.core.se3 import Transformation
from okvis2_torch.frontend.detection import DetectionConfig
from okvis2_torch.graph.estimator import EstimatorConfig
from okvis2_torch.imu.preintegration import ImuParameters
from okvis2_torch.pipeline.dataset import SyntheticDataset
from okvis2_torch.pipeline.frontend_pipeline import FrontendConfig
from okvis2_torch.pipeline.slam import SlamSystem
from okvis2_torch.pipeline.trajectory import ate_rmse


def small_rig(width=320, height=240, f=250.0, baseline=0.11, dtype=torch.float32, device=None):
    """Stereo radtan rig: two cameras of ``width`` x ``height``, focal
    ``f``, distortion [-0.05, 0.01, 0, 0], ``baseline`` along x. Returns
    (cameras, extrinsics)."""
    dev = resolve_device(device)
    cam = PinholeCamera.create(
        width, height, f, f, width / 2.0, height / 2.0,
        RadialTangentialDistortion.from_params([-0.05, 0.01, 0.0, 0.0]), dtype=dtype, device=dev)
    T_SC0 = Transformation.identity(dtype=dtype, device=dev)
    T_SC1 = Transformation(r=torch.tensor([baseline, 0.0, 0.0], dtype=dtype, device=dev),
                           q=torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=dtype, device=dev))
    return (cam, cam), [T_SC0, T_SC1]


def run_synthetic_vio(
    duration: float = 4.0,
    frame_rate: float = 5.0,
    width: int = 320,
    height: int = 240,
    max_keypoints: int = 256,
    estimator_config: Optional[EstimatorConfig] = None,
    n_stars: int = 3000,
    dtype=torch.float32,
    device=None,
    ransac_sampler=None,
    pipelined: bool = False,
    force_min_pending: int = 0,
):
    """Returns a dict with the aligned ATE, the trajectories, per-frame
    wall times and the system. The stereo radtan rig is built in
    ``dtype``; ``ransac_sampler`` is the frontend's per-frame RANSAC hook.
    ``force_min_pending`` keeps at least that many frames in flight in the
    pipelined loop (a test hook: it makes the multi-set device append
    happen on a fixed schedule, whatever the solves' timing). Runs on
    ``device`` (None: the CUDA card; raises without one)."""
    dev = resolve_device(device)
    cams, exts = small_rig(width, height, dtype=dtype, device=dev)
    imu_params = ImuParameters.create(g=9.81, device=dev)
    if estimator_config is None:
        estimator_config = EstimatorConfig(
            window_slots=10, landmark_slots=384, obs_slots=2048, imu_seg_capacity=128)
    fe_cfg = FrontendConfig(detection=DetectionConfig(max_keypoints=max_keypoints))
    slam = SlamSystem(cams, exts, imu_params, estimator_config, fe_cfg, pipelined=pipelined,
                      device=dev, ransac_sampler=ransac_sampler)
    slam._force_min_pending = force_min_pending
    ds = SyntheticDataset(cams, exts, imu_params, duration=duration, frame_rate=frame_rate,
                          n_stars=n_stars, device=dev)

    gt_traj = []
    t_start = time.time()
    frame_times = []
    n = 0
    for ev in ds.stream():
        if ev[0] == "imu":
            slam.add_imu_measurement(ev[1], ev[2], ev[3])
            continue
        _, t, images, pose_gt = ev
        gt_traj.append((t, pose_gt))
        slam.add_images(t, images)
        t0 = time.time()
        slam.process_frame()
        frame_times.append(time.time() - t0)
        n += 1

    est_traj = slam.trajectory()
    ate = ate_rmse(est_traj, gt_traj, align=True)
    # also the unaligned endpoint drift
    ep_err = float(np.linalg.norm(est_traj[-1][1][:3] - gt_traj[-1][1][:3]))
    return {
        "ate_rmse": ate,
        "endpoint_error": ep_err,
        "est_traj": est_traj,
        "gt_traj": gt_traj,
        "wall_time": time.time() - t_start,
        "frame_times": frame_times,
        "frames": n,
        "slam": slam,
    }
