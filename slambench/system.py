"""The system under test: the port's ``SlamSystem``, built from a
configuration file as the port's own entry points build it.

``app_synchronous``: as ``okvis2_torch/apps/app_synchronous.py`` maps the
YAML (with ``--sync``); ``app_realsense``: as
``okvis2_torch/apps/app_realsense.py`` maps it, with the config's
``realtime_min_iterations`` as the dataset app passes it, and the CNN gate
from the configuration's weights file when the YAML sets ``use_cnn``.
"""

from __future__ import annotations

import os

import torch

from slambench.generator import HERE

REPO = os.path.dirname(HERE)


def build(config: dict, device, overrides=None):
    """The SlamSystem of a configuration file's dict.

    ``overrides`` (CPU rehearsals only) scale the rig's images down:
    {"scale": s, "max_keypoints": n}."""
    from okvis2_torch.config import read_config_file
    from okvis2_torch.frontend.detection import DetectionConfig
    from okvis2_torch.graph.estimator import EstimatorConfig
    from okvis2_torch.pipeline.frontend_pipeline import FrontendConfig
    from okvis2_torch.pipeline.slam import SlamSystem

    dtype = getattr(torch, config["precision"])
    params = read_config_file(os.path.join(HERE, "configs", config["yaml"]), dtype=dtype,
                              device=device)
    cams, exts = params.camera_tuple, params.extrinsics_list
    ov = overrides or {}
    if "scale" in ov:
        cams = tuple(_scaled(c, ov["scale"]) for c in cams)
    e, f = params.estimator, params.frontend
    n_kp = ov.get("max_keypoints", f.max_num_keypoints)
    if config["app"] == "app_synchronous":
        est_cfg = EstimatorConfig(
            num_keyframes=e.num_keyframes, num_imu_frames=e.num_imu_frames,
            num_loop_closure_frames=e.num_loop_closure_frames,
            realtime_iterations=e.realtime_max_iterations,
            realtime_min_iterations=e.realtime_min_iterations,
            enforce_realtime=e.enforce_realtime, realtime_time_limit=e.realtime_time_limit,
            online_extrinsics=params.camera_rig.online_extrinsics,
            ext_sigma_r=params.camera_rig.sigma_r, ext_sigma_alpha=params.camera_rig.sigma_alpha)
        fe_cfg = FrontendConfig(
            detection=DetectionConfig(max_keypoints=n_kp, octaves=max(f.octaves, 1)),
            matching_threshold=int(f.matching_threshold),
            keyframe_overlap_threshold=f.keyframe_overlap)
    elif config["app"] == "app_realsense":
        est_cfg = EstimatorConfig(
            num_keyframes=e.num_keyframes, num_imu_frames=e.num_imu_frames,
            realtime_iterations=e.realtime_max_iterations,
            realtime_min_iterations=e.realtime_min_iterations,
            enforce_realtime=e.enforce_realtime, realtime_time_limit=e.realtime_time_limit)
        fe_cfg = FrontendConfig(detection=DetectionConfig(max_keypoints=n_kp),
                                matching_threshold=int(f.matching_threshold))
    else:
        raise ValueError(f"unknown app {config['app']!r}")
    cnn = os.path.join(REPO, config["cnn_weights"]) if f.use_cnn else None
    return SlamSystem(cams, exts, params.imu.params, est_cfg, fe_cfg,
                      do_loop_closures=e.do_loop_closures, pipelined=False,
                      cnn_params=cnn, device=device)


def _scaled(cam, s: float):
    from okvis2_torch.cameras.pinhole import PinholeCamera

    w, h = cam.image_size
    return PinholeCamera(cam.focal * s, (cam.center + 0.5) * s - 0.5, cam.distortion,
                         (int(round(w * s)), int(round(h * s))))


def scaled_rig(rig: dict, s: float) -> dict:
    """The rig of ``_scaled`` cameras, for the generator (CPU rehearsals)."""
    cams = []
    for c in rig["cameras"]:
        c = dict(c)
        c["size"] = [int(round(v * s)) for v in c["size"]]
        c["focal"] = [v * s for v in c["focal"]]
        c["center"] = [(v + 0.5) * s - 0.5 for v in c["center"]]
        cams.append(c)
    return dict(rig, cameras=cams)
