"""Drive specs of the tracked regression suite.

Port of ``okvis2_tpu/pipeline/regression_drives.py``: the rigs, durations,
ATE ceilings and loop-closure expectations of the long drives, one source
for every caller (the reference's validation analogue: running
okvis_app_synchronous on EuRoC and evaluating the ATE,
okvis_apps/src/okvis_app_synchronous.cpp, README.md:179-206).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from okvis2_torch import resolve_device
from okvis2_torch.cameras.distortion import EquidistantDistortion
from okvis2_torch.cameras.pinhole import PinholeCamera
from okvis2_torch.core.se3 import Transformation


@dataclasses.dataclass(frozen=True)
class DriveSpec:
    name: str
    duration: float  # seconds at 10 fps -> frames = duration * 10
    ate_bound: float  # tracked ATE RMSE ceiling [m]
    min_loop_closures: int  # expected verified closures (0: not gated)
    # every accepted closure's inlier ratio must exceed min_inlier_ratio by
    # this factor, so that acceptance drifting back near the threshold fails
    min_verify_margin: float = 0.0
    dataset: Optional[str] = None  # None: star field; "textured"
    # (dtype, device) -> ((cams...), [exts...])
    rig_builder: Optional[Callable] = None


def _ext(r, q, dtype, device) -> Transformation:
    return Transformation(r=torch.tensor(r, dtype=dtype, device=device),
                          q=torch.tensor(q, dtype=dtype, device=device))


def _rig_fisheye(dtype=torch.float64, device=None):
    """TUM-VI-style optics: a 320x240 equidistant stereo pair, 0.11 m."""
    dev = resolve_device(device)
    cam = PinholeCamera.create(320, 240, 190.0, 190.0, 160.0, 120.0,
                               EquidistantDistortion.from_params([-0.03, 0.008, -0.002, 0.0]),
                               dtype=dtype, device=dev)
    idq = [0.0, 0.0, 0.0, 1.0]
    exts = [_ext([0.0, 0.0, 0.0], idq, dtype, dev), _ext([0.11, 0.0, 0.0], idq, dtype, dev)]
    return (cam, cam), exts


def _rig_fourcam(dtype=torch.float64, device=None):
    """Two stereo pairs of 320x240 pinholes, the second yawed 0.44 rad."""
    dev = resolve_device(device)
    cam = PinholeCamera.create(320, 240, 250.0, 250.0, 160.0, 120.0, dtype=dtype, device=dev)
    idq = [0.0, 0.0, 0.0, 1.0]
    yaw = 0.44
    q_yaw = [0.0, float(np.sin(yaw / 2)), 0.0, float(np.cos(yaw / 2))]
    exts = [_ext([0.0, 0.0, 0.0], idq, dtype, dev), _ext([0.11, 0.0, 0.0], idq, dtype, dev),
            _ext([0.2, 0.0, 0.0], q_yaw, dtype, dev), _ext([0.31, 0.0, 0.0], q_yaw, dtype, dev)]
    return (cam, cam, cam, cam), exts


DRIVES = {
    # a 120 s / 1200-frame noisy circle; a verified loop closure is part of
    # the pass criterion (a run with none must not pass)
    "circle1200": DriveSpec("circle1200", 120.0, 0.08, min_loop_closures=1,
                            min_verify_margin=1.2),
    # a 30 s noisy circle in the textured world: real imagery's descriptors
    "textured": DriveSpec("textured", 30.0, 0.10, min_loop_closures=0, dataset="textured"),
    # 30 s with the equidistant fisheye rig
    "fisheye": DriveSpec("fisheye", 30.0, 0.08, min_loop_closures=0,
                         rig_builder=_rig_fisheye),
    # 30 s with four cameras (two stereo pairs, one yawed 25 deg)
    "fourcam": DriveSpec("fourcam", 30.0, 0.08, min_loop_closures=0,
                         rig_builder=_rig_fourcam),
}


def run_drive(spec: DriveSpec, verbose: bool = False, dtype=torch.float32, device=None):
    """Run one suite drive in the pipelined loop on ``device`` (None: the
    CUDA card); returns the ``run_regression_drive`` result."""
    from okvis2_torch.pipeline.synthetic_run import run_regression_drive

    dev = resolve_device(device)
    kw = dict(duration=spec.duration, pipelined=True, verbose=verbose, dtype=dtype, device=dev)
    if spec.dataset:
        kw["dataset"] = spec.dataset
    if spec.rig_builder is not None:
        kw["rig"] = spec.rig_builder(dtype=dtype, device=dev)
    return run_regression_drive(**kw)
