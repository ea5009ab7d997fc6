"""Multi-camera rig: cameras + extrinsics + pairwise FoV overlap.

Port of ``okvis2_tpu/cameras/ncamera.py`` (re-designs
okvis::cameras::NCameraSystem, okvis_cv/include/okvis/cameras/
NCameraSystem.hpp, src/NCameraSystem.cpp:48 computeOverlaps). The
overlap check is vectorised: back-project a subsampled pixel grid of
camera A, push the rays to camera B at a set of probe depths, and mark the
pair overlapping if enough rays land inside B's image. Runs on the
cameras' device, in their dtype.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from okvis2_torch.cameras.pinhole import PinholeCamera
from okvis2_torch.core.se3 import Transformation


class NCameraSystem:
    """Host-side rig container. Device code receives stacked tensors."""

    def __init__(
        self,
        cameras: Sequence[PinholeCamera],
        T_SC: Sequence[Transformation],
        camera_types: Optional[Sequence[str]] = None,
        compute_overlaps: bool = True,
    ):
        assert len(cameras) == len(T_SC)
        self.cameras: List[PinholeCamera] = list(cameras)
        self.T_SC: List[Transformation] = list(T_SC)
        self.camera_types = list(camera_types) if camera_types else ["gray"] * len(cameras)
        self.overlaps = (
            self._compute_overlaps() if compute_overlaps else
            np.ones((len(cameras), len(cameras)), dtype=bool)
        )

    def __len__(self) -> int:
        return len(self.cameras)

    @property
    def num_cameras(self) -> int:
        return len(self.cameras)

    def has_overlap(self, cam_a: int, cam_b: int) -> bool:
        return bool(self.overlaps[cam_a, cam_b])

    def _compute_overlaps(self, grid: int = 16, min_fraction: float = 0.05) -> np.ndarray:
        """Pairwise FoV overlap via sampled-ray projection at probe depths."""
        n = len(self.cameras)
        out = np.eye(n, dtype=bool)
        for a in range(n):
            cam_a = self.cameras[a]
            dtype, dev = cam_a.focal.dtype, cam_a.focal.device
            depths = torch.tensor([0.5, 1.0, 2.0, 5.0, 20.0], dtype=dtype, device=dev)
            us = torch.linspace(0.0, cam_a.width - 1.0, grid, dtype=dtype, device=dev)
            vs = torch.linspace(0.0, cam_a.height - 1.0, grid, dtype=dtype, device=dev)
            vv, uu = torch.meshgrid(vs, us, indexing="ij")
            uv = torch.stack([uu.reshape(-1), vv.reshape(-1)], dim=-1)  # [G,2]
            rays_a = cam_a.back_project(uv)  # [G,3]
            # points at probe depths in camera-A frame: [D,G,3]
            pts_a = rays_a[None, :, :] * depths[:, None, None]
            T_S_Ca = self.T_SC[a]
            for b in range(n):
                if a == b:
                    continue
                T_CbCa = self.T_SC[b].inverse() @ T_S_Ca
                pts_b = T_CbCa.apply(pts_a.reshape(-1, 3))
                _, valid = self.cameras[b].project(pts_b)
                frac = float(torch.mean(valid.to(torch.float32)))
                out[a, b] = frac > min_fraction
        return out

    # stacked views for device code ------------------------------------
    def stacked_T_SC(self) -> Transformation:
        """Rig extrinsics as a batched Transformation [N]."""
        return Transformation(
            r=torch.stack([T.r for T in self.T_SC]),
            q=torch.stack([T.q for T in self.T_SC]),
        )
