"""Configuration files in the reference's format, and their parameters.

Port of ``okvis2_tpu/config/parameters.py`` (okvis::ViParametersReader and
the ViParameters struct family; reference:
okvis_common/src/ViParametersReader.cpp:68-479,
okvis_common/include/okvis/Parameters.hpp:57-172). The same YAML files
(``configs/euroc.yaml``, TUM-VI, Hilti, RealSense) parse directly, with the
port's own reader for the subset of YAML they use
(``config/yaml_subset.py``), so no YAML package is needed.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from okvis2_torch import resolve_device
from okvis2_torch.cameras.distortion import distortion_by_name
from okvis2_torch.cameras.pinhole import PinholeCamera
from okvis2_torch.config import yaml_subset
from okvis2_torch.core.se3 import Transformation
from okvis2_torch.imu.preintegration import ImuParameters


@dataclasses.dataclass
class CameraConfig:
    camera: PinholeCamera
    T_SC: Transformation
    camera_type: str = "gray"  # gray, rgb, gray+depth, rgb+depth
    slam_use: str = "okvis"  # none, okvis, okvis-depth, okvis-virtual


@dataclasses.dataclass
class FrontendParameters:
    detection_threshold: float = 40.0
    absolute_threshold: float = 150.0
    matching_threshold: float = 60.0
    octaves: int = 0
    max_num_keypoints: int = 450
    keyframe_overlap: float = 0.55
    use_cnn: bool = False
    parallelise_detection: bool = True
    num_matching_threads: int = 4


@dataclasses.dataclass
class EstimatorParameters:
    num_keyframes: int = 5
    num_loop_closure_frames: int = 3
    num_imu_frames: int = 3
    do_loop_closures: bool = True
    do_final_ba: bool = False
    enforce_realtime: bool = False
    realtime_min_iterations: int = 3
    realtime_max_iterations: int = 10
    realtime_time_limit: float = 0.035
    realtime_num_threads: int = 3
    full_graph_iterations: int = 15
    full_graph_num_threads: int = 3


@dataclasses.dataclass
class OutputParameters:
    display_matches: bool = False
    display_overhead: bool = False


@dataclasses.dataclass
class CameraRigParameters:
    timestamp_tolerance: float = 0.005
    sync_cameras: Optional[List[int]] = None
    image_delay: float = 0.0
    online_extrinsics: bool = False
    online_extrinsics_final_ba: bool = False
    sigma_r: float = 0.01
    sigma_alpha: float = 0.05


@dataclasses.dataclass
class ImuConfig:
    params: ImuParameters
    use: bool = True
    a_max: float = 176.0
    g_max: float = 7.8
    sigma_bg: float = 0.01
    sigma_ba: float = 0.1
    g0: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    a0: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    T_BS: Optional[Transformation] = None


@dataclasses.dataclass
class ViParameters:
    cameras: List[CameraConfig]
    camera_rig: CameraRigParameters
    imu: ImuConfig
    frontend: FrontendParameters
    estimator: EstimatorParameters
    output: OutputParameters

    @property
    def camera_tuple(self):
        return tuple(c.camera for c in self.cameras if c.slam_use != "none")

    @property
    def extrinsics_list(self):
        return [c.T_SC for c in self.cameras if c.slam_use != "none"]


def _mat44_to_T(vals, dtype, device) -> Transformation:
    M = np.asarray(vals, np.float64).reshape(4, 4)
    return Transformation.from_matrix(torch.as_tensor(M, dtype=dtype, device=device))


def read_config_file(path: str, dtype=torch.float32, device=None) -> ViParameters:
    """Parse a reference-format YAML config (e.g. ``configs/euroc.yaml``);
    cameras, extrinsics and IMU parameters are made in ``dtype`` on
    ``device`` (None: the CUDA card; raises without one)."""
    dev = resolve_device(device)
    doc = yaml_subset.load(path) or {}

    cameras = []
    for c in doc.get("cameras", []):
        w, h = c["image_dimension"]
        f_u, f_v = c["focal_length"]
        c_u, c_v = c["principal_point"]
        dist = distortion_by_name(c["distortion_type"], c["distortion_coefficients"],
                                  dtype=dtype, device=dev)
        cam = PinholeCamera.create(w, h, f_u, f_v, c_u, c_v, dist, dtype=dtype, device=dev)
        cameras.append(CameraConfig(
            camera=cam,
            T_SC=_mat44_to_T(c["T_SC"], dtype, dev),
            camera_type=c.get("camera_type", "gray"),
            slam_use=c.get("slam_use", "okvis"),
        ))

    cp = doc.get("camera_parameters", {}) or {}
    oc = cp.get("online_calibration", {}) or {}
    rig = CameraRigParameters(
        timestamp_tolerance=cp.get("timestamp_tolerance", 0.005),
        sync_cameras=cp.get("sync_cameras"),
        image_delay=cp.get("image_delay", 0.0),
        online_extrinsics=bool(oc.get("do_extrinsics", False)),
        online_extrinsics_final_ba=bool(oc.get("do_extrinsics_final_ba", False)),
        sigma_r=oc.get("sigma_r", 0.01),
        sigma_alpha=oc.get("sigma_alpha", 0.05),
    )

    ip = doc.get("imu_parameters", {}) or {}
    imu = ImuConfig(
        params=ImuParameters.create(
            sigma_g_c=ip.get("sigma_g_c", 12e-4),
            sigma_a_c=ip.get("sigma_a_c", 8e-3),
            sigma_gw_c=ip.get("sigma_gw_c", 4e-6),
            sigma_aw_c=ip.get("sigma_aw_c", 4e-5),
            g=ip.get("g", 9.81007),
            dtype=dtype, device=dev,
        ),
        use=bool(ip.get("use", True)),
        a_max=ip.get("a_max", 176.0),
        g_max=ip.get("g_max", 7.8),
        sigma_bg=ip.get("sigma_bg", 0.01),
        sigma_ba=ip.get("sigma_ba", 0.1),
        g0=tuple(ip.get("g0", [0.0, 0.0, 0.0])),
        a0=tuple(ip.get("a0", [0.0, 0.0, 0.0])),
        T_BS=_mat44_to_T(ip["T_BS"], dtype, dev) if "T_BS" in ip else None,
    )

    fp = doc.get("frontend_parameters", {}) or {}
    frontend = FrontendParameters(
        detection_threshold=fp.get("detection_threshold", 40.0),
        absolute_threshold=fp.get("absolute_threshold", 150.0),
        matching_threshold=fp.get("matching_threshold", 60.0),
        octaves=int(fp.get("octaves", 0)),
        max_num_keypoints=int(fp.get("max_num_keypoints", 450)),
        keyframe_overlap=fp.get("keyframe_overlap", 0.55),
        use_cnn=bool(fp.get("use_cnn", False)),
        parallelise_detection=bool(fp.get("parallelise_detection", True)),
        num_matching_threads=int(fp.get("num_matching_threads", 4)),
    )

    ep = doc.get("estimator_parameters", {}) or {}
    estimator = EstimatorParameters(
        num_keyframes=int(ep.get("num_keyframes", 5)),
        num_loop_closure_frames=int(ep.get("num_loop_closure_frames", 3)),
        num_imu_frames=int(ep.get("num_imu_frames", 3)),
        do_loop_closures=bool(ep.get("do_loop_closures", True)),
        do_final_ba=bool(ep.get("do_final_ba", False)),
        enforce_realtime=bool(ep.get("enforce_realtime", False)),
        realtime_min_iterations=int(ep.get("realtime_min_iterations", 3)),
        realtime_max_iterations=int(ep.get("realtime_max_iterations", 10)),
        realtime_time_limit=ep.get("realtime_time_limit", 0.035),
        realtime_num_threads=int(ep.get("realtime_num_threads", 3)),
        full_graph_iterations=int(ep.get("full_graph_iterations", 15)),
        full_graph_num_threads=int(ep.get("full_graph_num_threads", 3)),
    )

    op = doc.get("output_parameters", {}) or {}
    output = OutputParameters(
        display_matches=bool(op.get("display_matches", False)),
        display_overhead=bool(op.get("display_overhead", False)),
    )

    return ViParameters(cameras=cameras, camera_rig=rig, imu=imu, frontend=frontend,
                        estimator=estimator, output=output)
