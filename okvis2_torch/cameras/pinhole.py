"""Pinhole camera model, batched and differentiable.

Port of ``okvis2_tpu/cameras/pinhole.py``: a frozen dataclass whose
``project``/``back_project`` broadcast over batch shapes, so the solver's
reprojection Jacobians come from ``torch.func``. Projection status is a
boolean validity mask (in front of the camera and inside the image, with
the reference's half-pixel margin).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from okvis2_torch import resolve_device
from okvis2_torch.cameras import distortion as D
from okvis2_torch.cameras.distortion import Distortion, NoDistortion


@dataclasses.dataclass(frozen=True)
class PinholeCamera:
    focal: torch.Tensor  # [2] = [fu, fv]
    center: torch.Tensor  # [2] = [cu, cv]
    distortion: Distortion
    image_size: Tuple[int, int] = (752, 480)  # (width, height)

    # ------------------------------------------------------------------
    @classmethod
    def create(cls, width, height, fu, fv, cu, cv, distortion=None,
               dtype=torch.float64, device=None):
        device = resolve_device(device)
        if distortion is None:
            distortion = NoDistortion()
        elif not isinstance(distortion, NoDistortion):
            distortion = distortion.with_params(
                distortion.params().to(dtype=dtype, device=device)
            )
        return cls(
            focal=torch.tensor([fu, fv], dtype=dtype, device=device),
            center=torch.tensor([cu, cv], dtype=dtype, device=device),
            distortion=distortion,
            image_size=(int(width), int(height)),
        )

    @classmethod
    def create_test_object(cls, distortion_cls=None, dtype=torch.float64,
                           device=None):
        """Synthetic 752x480 camera (the reference's createTestObject)."""
        if distortion_cls is None or distortion_cls is D.NoDistortion:
            dist = D.NoDistortion()
        elif distortion_cls is D.RadialTangentialDistortion:
            dist = D.RadialTangentialDistortion.from_params(
                [-0.28, 0.07, 0.0002, 1.8e-05]
            )
        elif distortion_cls is D.RadialTangentialDistortion8:
            dist = D.RadialTangentialDistortion8.from_params(
                [-0.28, 0.07, 0.0002, 1.8e-05, 0.0, 0.0, 0.0, 0.0]
            )
        elif distortion_cls is D.EquidistantDistortion:
            dist = D.EquidistantDistortion.from_params(
                [-0.01, 0.02, -0.004, 0.002]
            )
        else:
            raise ValueError(distortion_cls)
        return cls.create(752, 480, 458.65, 457.30, 367.21, 248.37, dist,
                          dtype=dtype, device=device)

    # ------------------------------------------------------------------
    @property
    def width(self) -> int:
        return self.image_size[0]

    @property
    def height(self) -> int:
        return self.image_size[1]

    def intrinsics(self) -> torch.Tensor:
        """[fu, fv, cu, cv, *distortion] flat vector."""
        k = self.distortion.params().to(self.focal)
        return torch.cat([self.focal, self.center, k])

    def with_params(self, focal, center, k) -> "PinholeCamera":
        """Same model with other parameter tensors (per-observation
        cameras under ``torch.func.vmap``)."""
        return PinholeCamera(focal, center, self.distortion.with_params(k),
                             self.image_size)

    def to(self, device=None, dtype=None) -> "PinholeCamera":
        return self.with_params(
            self.focal.to(device=device, dtype=dtype),
            self.center.to(device=device, dtype=dtype),
            self.distortion.params().to(device=device, dtype=dtype),
        )

    # ------------------------------------------------------------------
    def project(self, p_C: torch.Tensor):
        """Camera-frame points [..., 3] -> pixels [..., 2], valid mask."""
        z = p_C[..., 2]
        safe_z = torch.where(z.abs() > 1e-12, z, torch.full_like(z, 1e-12))
        xy = p_C[..., :2] / safe_z[..., None]
        xyd = self.distortion.distort(xy)
        uv = xyd * self.focal + self.center
        in_front = z > 1e-12
        in_image = (
            (uv[..., 0] >= -0.5)
            & (uv[..., 0] <= self.width - 0.5)
            & (uv[..., 1] >= -0.5)
            & (uv[..., 1] <= self.height - 0.5)
        )
        return uv, in_front & in_image

    def project_homogeneous(self, hp_C: torch.Tensor):
        """Project homogeneous camera-frame points [..., 4]; negative-w
        points are sign-flipped first (reference projectHomogeneous)."""
        w = hp_C[..., 3]
        sign = torch.where(w < 0.0, -torch.ones_like(w), torch.ones_like(w))
        return self.project(hp_C[..., :3] * sign[..., None])

    def back_project(self, uv: torch.Tensor) -> torch.Tensor:
        """Pixels [..., 2] -> unit-norm ray directions [..., 3]."""
        ray = self.back_project_unnormalized(uv)
        return ray / torch.linalg.norm(ray, dim=-1, keepdim=True)

    def back_project_unnormalized(self, uv: torch.Tensor) -> torch.Tensor:
        """Pixels -> rays with z=1."""
        xyd = (uv - self.center) / self.focal
        xy = self.distortion.undistort(xyd)
        return torch.cat([xy, torch.ones_like(xy[..., :1])], dim=-1)
