"""Synthetic dataset: a deterministic textured world along an analytic
trajectory, with exact IMU.

Port of ``okvis2_tpu/pipeline/dataset.py::SyntheticDataset`` (the
default and the circle trajectory). The world is a field of small
textured squares ("stars") drawn with the same numpy ``default_rng(seed)``
calls in the same order as the JAX package, so one seed gives one world. Each frame projects
the stars into every camera with the port's ``Transformation`` and
``PinholeCamera`` on the device, then paints them in numpy. Trajectory and
IMU come from ``utils/synthetic.true_state`` / ``imu_at``, or from
``utils/synthetic.CircleTrajectory`` with one circle per ``duration``.
"""

from __future__ import annotations

from typing import Iterator, List

import numpy as np
import torch
from torch.func import vmap

from okvis2_torch import resolve_device
from okvis2_torch.core.se3 import Transformation
from okvis2_torch.utils import synthetic


class SyntheticDataset:
    """Renders every camera of a rig along the canonical test trajectory
    (``trajectory="default"``) or one circle (``"circle"``).

    ``cameras``/``extrinsics``: PinholeCamera and Transformation per
    camera; ``imu_params``: ImuParameters. Runs on ``device`` (None: the
    CUDA card; raises without one)."""

    def __init__(self, cameras, extrinsics, imu_params, n_stars: int = 3000,
                 duration: float = 10.0, frame_rate: float = 10.0, imu_rate: float = 200.0,
                 seed: int = 0, imu_noise: float = 0.0, trajectory: str = "default",
                 device=None):
        if trajectory not in ("default", "circle"):
            raise ValueError(f"trajectory {trajectory!r}")
        self.device = resolve_device(device)
        self.syn = synthetic.CircleTrajectory(duration) if trajectory == "circle" else synthetic
        self.cameras = cameras
        self.extrinsics = extrinsics
        self.imu_params = imu_params
        self.duration = duration
        self.frame_rate = frame_rate
        self.imu_rate = imu_rate
        self.imu_noise = imu_noise
        rng = np.random.default_rng(seed)
        # stars distributed in a shell in front of/around the trajectory
        self.stars = np.concatenate([
            rng.uniform(-6, 10, (n_stars, 1)),
            rng.uniform(-6, 6, (n_stars, 1)),
            rng.uniform(2.0, 12.0, (n_stars, 1)),
        ], axis=-1)
        self.star_intensity = rng.uniform(0.25, 1.0, n_stars)
        self.star_size = rng.integers(3, 6, n_stars)
        # a random texture patch per star keeps binary descriptors
        # discriminative (constant squares alias heavily)
        self.star_pattern = rng.uniform(0.3, 1.0, (n_stars, 6, 6))
        dtype = cameras[0].focal.dtype
        self._stars_dev = torch.as_tensor(self.stars, dtype=dtype, device=self.device)
        self._T_SC = [Transformation(r=T.r.to(self.device, dtype), q=T.q.to(self.device, dtype))
                      for T in extrinsics]

    def _project(self, cam, T_WS7: np.ndarray, T_SC: Transformation):
        T7 = torch.as_tensor(np.asarray(T_WS7), dtype=self._stars_dev.dtype, device=self.device)
        T_CW = (Transformation(r=T7[:3], q=T7[3:7]) @ T_SC).inverse()
        p_C = T_CW.apply(self._stars_dev)
        uv, valid = cam.project(p_C)
        return uv.cpu().numpy(), (valid & (p_C[:, 2] > 0.2)).cpu().numpy()

    def render(self, T_WS) -> List[np.ndarray]:
        """Render all cameras at body pose T_WS (numpy [7]) -> float32
        images [H,W] in [0,1]."""
        out = []
        for cam, T_SC in zip(self.cameras, self._T_SC):
            uv, valid = self._project(cam, T_WS, T_SC)
            img = np.zeros((cam.height, cam.width), np.float32)
            for k in np.nonzero(valid)[0]:
                x, y = uv[k]
                s = int(self.star_size[k])
                x0, y0 = int(round(x)) - s // 2, int(round(y)) - s // 2
                x1, y1 = x0 + s, y0 + s
                x0c, y0c = max(x0, 0), max(y0, 0)
                x1c, y1c = min(x1, cam.width), min(y1, cam.height)
                if x1c > x0c and y1c > y0c:
                    patch = (self.star_intensity[k]
                             * self.star_pattern[k][: y1c - y0c, : x1c - x0c])
                    img[y0c:y1c, x0c:x1c] = np.maximum(img[y0c:y1c, x0c:x1c],
                                                       patch.astype(np.float32))
            out.append(img)
        return out

    def stream(self) -> Iterator[tuple]:
        """Yield ("imu", t, accel, gyro) and ("images", t, [img...], pose7)
        events in time order."""
        rng = np.random.default_rng(123)
        n_frames = int(self.duration * self.frame_rate)
        imu_dt = 1.0 / self.imu_rate
        n_imu = int(np.ceil((n_frames - 1) / self.frame_rate / imu_dt)) + 2
        ts_imu = np.arange(n_imu) * imu_dt
        w_all, a_all = vmap(lambda tt: self.syn.imu_at(tt, self.imu_params))(
            torch.as_tensor(ts_imu, dtype=torch.float64, device=self.imu_params.g.device))
        w_all, a_all = w_all.cpu().numpy(), a_all.cpu().numpy()
        ts_frame = np.arange(n_frames) / self.frame_rate
        if self.imu_noise > 0:
            w_all = w_all + rng.normal(0, self.imu_noise * 1e-2, w_all.shape)
            a_all = a_all + rng.normal(0, self.imu_noise * 1e-1, a_all.shape)

        ii = 0
        for fi in range(n_frames):
            t = ts_frame[fi]
            while ii < n_imu and ts_imu[ii] <= t + 1e-9:
                yield ("imu", ts_imu[ii], a_all[ii], w_all[ii])
                ii += 1
            pose = self.ground_truth(t)
            yield ("images", t, self.render(pose), pose)

    def ground_truth(self, t: float) -> np.ndarray:
        T_gt, _ = self.syn.true_state(t, device=self.device)
        return torch.cat([T_gt.r, T_gt.q]).cpu().numpy()
