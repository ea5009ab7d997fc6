"""Frame / MultiFrame containers.

Port of ``okvis2_tpu/cameras/multiframe.py``: okvis::Frame
(okvis_cv/include/okvis/Frame.hpp: image, geometry, keypoints, descriptors,
landmark ids, back-projections, CNN classifications) and okvis::MultiFrame
(okvis_cv/include/okvis/MultiFrame.hpp:53-335: synchronised Frames with a
timestamp and an id). Detection and description run batched on the device
(``pipeline/frontend_pipeline.py``); these classes are the host-side view
of their output in the reference's accessor vocabulary, for API users.
"""

from __future__ import annotations

import itertools
from typing import Dict, List, Optional

import numpy as np
import torch


class Frame:
    def __init__(self, image, camera, frame_data: Optional[dict] = None):
        self.image = image
        self.camera = camera
        # frontend output: xy, size, score, mask, signs, packed
        self._d = frame_data or {}
        # keypoint index -> landmark id (the reference's landmarkIds)
        self.landmark_ids: Dict[int, int] = {}
        # keypoint index -> CNN class (Frame::classifications)
        self.classifications: Dict[int, int] = {}

    @property
    def num_keypoints(self) -> int:
        return int(np.asarray(self._d.get("mask", [])).sum())

    def keypoint(self, idx: int) -> np.ndarray:
        return np.asarray(self._d["xy"])[idx]

    def keypoint_size(self, idx: int) -> float:
        return float(np.asarray(self._d["size"])[idx])

    def descriptor(self, idx: int) -> np.ndarray:
        """Packed uint32[16] (the 64-byte analogue of the 48-byte BRISK)."""
        return np.asarray(self._d["packed"])[idx]

    def descriptor_signs(self, idx: int) -> np.ndarray:
        return np.asarray(self._d["signs"])[idx]

    def set_landmark_id(self, kp_idx: int, lm_id: int):
        self.landmark_ids[kp_idx] = lm_id

    def landmark_id(self, kp_idx: int) -> int:
        return self.landmark_ids.get(kp_idx, -1)

    def back_project(self, idx: int) -> np.ndarray:
        """The keypoint's ray, back-projected by the camera on its device."""
        focal = self.camera.focal
        xy = torch.as_tensor(self.keypoint(idx), dtype=focal.dtype, device=focal.device)
        return self.camera.back_project(xy).cpu().numpy()


class MultiFrame:
    _ids = itertools.count(1)

    def __init__(self, timestamp: float, images: List, cameras, frames_data=None):
        self.timestamp = float(timestamp)
        self.id = next(MultiFrame._ids)
        self.frames = [Frame(img, cam, fd) for img, cam, fd in
                       zip(images, cameras, frames_data if frames_data else [None] * len(images))]

    @property
    def num_frames(self) -> int:
        return len(self.frames)

    def frame(self, i: int) -> Frame:
        return self.frames[i]

    def num_keypoints(self) -> int:
        return sum(f.num_keypoints for f in self.frames)

    def keypoint(self, cam_idx: int, kp_idx: int) -> np.ndarray:
        return self.frames[cam_idx].keypoint(kp_idx)

    def descriptor(self, cam_idx: int, kp_idx: int) -> np.ndarray:
        return self.frames[cam_idx].descriptor(kp_idx)

    def set_landmark_id(self, cam_idx: int, kp_idx: int, lm_id: int):
        self.frames[cam_idx].set_landmark_id(kp_idx, lm_id)

    def landmark_id(self, cam_idx: int, kp_idx: int) -> int:
        return self.frames[cam_idx].landmark_id(kp_idx)
