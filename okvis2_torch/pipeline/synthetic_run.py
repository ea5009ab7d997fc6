"""Run the VIO loop on the synthetic dataset.

Port of ``okvis2_tpu/pipeline/synthetic_run.py`` (the star field or the
textured world, default or circle trajectory, synchronous or pipelined
loop, optional loop closure): renders stereo frames along the analytic trajectory, feeds
images and IMU (exact, or with white noise) through ``SlamSystem`` and
computes the aligned ATE against ground truth (the reference's validation
analogue: okvis_app_synchronous on EuRoC, README.md:179-206).
``run_regression_drive`` is the long-horizon drive: a noisy-IMU circle with
loop closure.
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
from okvis2_torch.pipeline.dataset import SyntheticDataset, TexturedWorldDataset
from okvis2_torch.pipeline.frontend_pipeline import FrontendConfig
from okvis2_torch.pipeline.full_graph import LoopClosureConfig
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
    imu_noise: float = 0.0,
    verbose: bool = False,
    n_stars: int = 3000,
    dtype=torch.float32,
    device=None,
    ransac_sampler=None,
    pipelined: bool = False,
    force_min_pending: int = 0,
    trajectory: str = "default",
    do_loop_closures: bool = False,
    loop_closure_config: Optional[LoopClosureConfig] = None,
    dataset: str = "stars",
    rig=None,
):
    """Returns a dict with the aligned ATE, the trajectories, per-frame
    wall times, the frames whose host work closed a loop ("lc_frames") and
    the system. The stereo radtan rig is built in ``dtype``;
    ``ransac_sampler`` is the frontend's per-frame RANSAC hook.
    ``force_min_pending`` keeps at least that many frames in flight in the
    pipelined loop (a test hook: it makes the multi-set device append
    happen on a fixed schedule, whatever the solves' timing).
    ``dataset="textured"`` renders the textured world
    (``TexturedWorldDataset``: textured surfaces, true occlusion, exposure
    changes) in place of the star field. ``rig`` injects a (cameras,
    extrinsics) pair (the fisheye and four-camera regression rigs) in place
    of the stereo radtan rig; ``imu_noise`` scales the IMU's white noise
    (1e-2 rad/s and 1e-1 m/s^2 per unit); ``verbose`` prints each frame's
    position error. Runs on ``device`` (None: the CUDA card; raises without
    one)."""
    dev = resolve_device(device)
    cams, exts = rig if rig is not None else small_rig(width, height, dtype=dtype, device=dev)
    imu_params = ImuParameters.create(g=9.81, device=dev)
    if estimator_config is None:
        estimator_config = EstimatorConfig(
            window_slots=10, landmark_slots=384, obs_slots=2048, imu_seg_capacity=128)
    fe_cfg = FrontendConfig(detection=DetectionConfig(max_keypoints=max_keypoints))
    slam = SlamSystem(cams, exts, imu_params, estimator_config, fe_cfg,
                      do_loop_closures=do_loop_closures, loop_closure_config=loop_closure_config,
                      pipelined=pipelined, device=dev, ransac_sampler=ransac_sampler)
    slam._force_min_pending = force_min_pending
    if dataset == "textured":
        ds = TexturedWorldDataset(cams, exts, imu_params, duration=duration,
                                  frame_rate=frame_rate, imu_noise=imu_noise,
                                  trajectory=trajectory, device=dev)
    else:
        ds = SyntheticDataset(cams, exts, imu_params, duration=duration, frame_rate=frame_rate,
                              n_stars=n_stars, imu_noise=imu_noise, trajectory=trajectory,
                              device=dev)

    gt_traj = []
    t_start = time.time()
    frame_times = []
    lc_frames = []
    n = 0
    for ev in ds.stream():
        if ev[0] == "imu":
            slam.add_imu_measurement(ev[1], ev[2], ev[3])
            continue
        _, t, images, pose_gt = ev
        gt_traj.append((t, pose_gt))
        slam.add_images(t, images)
        lc0 = slam.loop_backend.num_loop_closures if slam.loop_backend else 0
        t0 = time.time()
        slam.process_frame()
        frame_times.append(time.time() - t0)
        if slam.loop_backend is not None and slam.loop_backend.num_loop_closures > lc0:
            lc_frames.append(n)
        n += 1
        if verbose:
            est_pose = slam.estimator.states[slam.estimator.window[-1]].pose
            err = np.linalg.norm(est_pose[:3] - pose_gt[:3])
            print(f"frame {n}: t={t:.2f} err={err:.4f} kf={slam.tracking.is_keyframe} "
                  f"lms={len(slam.estimator.landmarks)} dt={frame_times[-1]:.2f}s", flush=True)

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
        "lc_frames": lc_frames,
        "frames": n,
        "slam": slam,
    }


def run_regression_drive(
    duration: float = 60.0,
    frame_rate: float = 10.0,
    imu_noise: float = 1.0,
    verbose: bool = True,
    **kwargs,
):
    """The long-horizon accuracy drive: a >= 600-frame circle with noisy
    IMU and loop closure, through the whole marginalisation cascade
    (IMU-frame elimination, keyframes to pose-graph factors, window drops),
    place recognition and loop closure; ``kwargs`` go to
    ``run_synthetic_vio`` (``device``, ``dtype``, ``pipelined``, ``rig``,
    ...). The JAX package's capacities: 512 landmark and 4096 observation
    slots, whose long drives reach 547-805 window landmarks (a truncation
    there drops real constraints; the reference's problem is uncapped)."""
    if "estimator_config" not in kwargs:
        kwargs["estimator_config"] = EstimatorConfig(
            window_slots=10, landmark_slots=512, obs_slots=4096, imu_seg_capacity=128)
    return run_synthetic_vio(duration=duration, frame_rate=frame_rate, imu_noise=imu_noise,
                             verbose=verbose, trajectory="circle", do_loop_closures=True,
                             **kwargs)
