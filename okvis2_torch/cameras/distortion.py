"""Lens distortion models as batched torch functions.

Port of ``okvis2_tpu/cameras/distortion.py``. ``distort`` maps normalised
image coordinates [..., 2] to distorted ones and is differentiable;
``undistort`` inverts it with a fixed count of branch-free Gauss-Newton
steps, unrolled as in the reference.

Parameter orders (OpenCV / reference YAML):
  radialtangential   : [k1, k2, p1, p2]
  radialtangential8  : [k1, k2, p1, p2, k3, k4, k5, k6]
  equidistant        : [k1, k2, k3, k4]
"""

from __future__ import annotations

import dataclasses

import torch
import torch.func


class Distortion:
    """Base: subclasses are frozen dataclasses with a ``distort``."""

    n_params: int = 0

    def distort(self, xy: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def undistort(self, xy_d: torch.Tensor, iterations: int = 8) -> torch.Tensor:
        """Invert ``distort`` by Newton steps on the 2x2 system (statically
        unrolled, branch-free, batched)."""

        def step(x):
            y = self.distort(x)
            e = xy_d - y
            J = _jac2(self.distort, x)
            a, b = J[..., 0, 0], J[..., 0, 1]
            c, d = J[..., 1, 0], J[..., 1, 1]
            det = a * d - b * c
            det = torch.where(det.abs() < 1e-12, torch.full_like(det, 1e-12), det)
            dx = torch.stack(
                [
                    (d * e[..., 0] - b * e[..., 1]) / det,
                    (-c * e[..., 0] + a * e[..., 1]) / det,
                ],
                dim=-1,
            )
            return x + dx

        x = xy_d
        for _ in range(iterations):
            x = step(x)
        return x

    def params(self) -> torch.Tensor:
        raise NotImplementedError

    def with_params(self, k: torch.Tensor) -> "Distortion":
        """Same model with parameter tensor ``k`` (used to rebuild a
        camera per observation under ``torch.func.vmap``)."""
        return dataclasses.replace(self, k=k)


def _jac2(fn, x):
    """Jacobian of an R^2->R^2 map over the last axis, batched."""
    cols = []
    for i in range(2):
        t = torch.zeros_like(x)
        t[..., i] = 1.0
        cols.append(torch.func.jvp(fn, (x,), (t,))[1])
    return torch.stack(cols, dim=-1)  # [..., 2, 2]


@dataclasses.dataclass(frozen=True)
class NoDistortion(Distortion):
    n_params = 0

    def distort(self, xy):
        return xy

    def undistort(self, xy_d, iterations: int = 8):
        return xy_d

    def params(self):
        return torch.zeros((0,), dtype=torch.float64)

    def with_params(self, k):
        return self


@dataclasses.dataclass(frozen=True)
class RadialTangentialDistortion(Distortion):
    """Brown-Conrady [k1, k2, p1, p2]."""

    k: torch.Tensor  # [4]
    n_params = 4

    @classmethod
    def from_params(cls, p, dtype=torch.float64, device=None):
        return cls(k=torch.as_tensor(p, dtype=dtype, device=device))

    def distort(self, xy):
        k1, k2, p1, p2 = self.k[..., 0], self.k[..., 1], self.k[..., 2], self.k[..., 3]
        x, y = xy[..., 0], xy[..., 1]
        x2, y2, xy_ = x * x, y * y, x * y
        r2 = x2 + y2
        rad = 1.0 + r2 * (k1 + k2 * r2)
        xd = x * rad + 2.0 * p1 * xy_ + p2 * (r2 + 2.0 * x2)
        yd = y * rad + 2.0 * p2 * xy_ + p1 * (r2 + 2.0 * y2)
        return torch.stack([xd, yd], dim=-1)

    def params(self):
        return self.k


@dataclasses.dataclass(frozen=True)
class RadialTangentialDistortion8(Distortion):
    """Rational model [k1, k2, p1, p2, k3, k4, k5, k6] (OpenCV order)."""

    k: torch.Tensor  # [8]
    n_params = 8

    @classmethod
    def from_params(cls, p, dtype=torch.float64, device=None):
        return cls(k=torch.as_tensor(p, dtype=dtype, device=device))

    def distort(self, xy):
        k1, k2, p1, p2 = self.k[..., 0], self.k[..., 1], self.k[..., 2], self.k[..., 3]
        k3, k4, k5, k6 = self.k[..., 4], self.k[..., 5], self.k[..., 6], self.k[..., 7]
        x, y = xy[..., 0], xy[..., 1]
        x2, y2, xy_ = x * x, y * y, x * y
        r2 = x2 + y2
        num = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
        den = 1.0 + r2 * (k4 + r2 * (k5 + r2 * k6))
        rad = num / den
        xd = x * rad + 2.0 * p1 * xy_ + p2 * (r2 + 2.0 * x2)
        yd = y * rad + 2.0 * p2 * xy_ + p1 * (r2 + 2.0 * y2)
        return torch.stack([xd, yd], dim=-1)

    def params(self):
        return self.k


@dataclasses.dataclass(frozen=True)
class EquidistantDistortion(Distortion):
    """Kannala-Brandt fisheye [k1, k2, k3, k4]."""

    k: torch.Tensor  # [4]
    n_params = 4

    @classmethod
    def from_params(cls, p, dtype=torch.float64, device=None):
        return cls(k=torch.as_tensor(p, dtype=dtype, device=device))

    def distort(self, xy):
        k1, k2, k3, k4 = self.k[..., 0], self.k[..., 1], self.k[..., 2], self.k[..., 3]
        x, y = xy[..., 0], xy[..., 1]
        r2 = x * x + y * y
        r = torch.sqrt(r2)
        theta = torch.atan(r)
        t2 = theta * theta
        thetad = theta * (1.0 + t2 * (k1 + t2 * (k2 + t2 * (k3 + t2 * k4))))
        big = r > 1e-8
        safe_r = torch.where(big, r, torch.ones_like(r))
        scaling = torch.where(big, thetad / safe_r, torch.ones_like(r))
        return xy * scaling[..., None]

    def params(self):
        return self.k


_REGISTRY = {
    "none": NoDistortion,
    "radialtangential": RadialTangentialDistortion,
    "radial-tangential": RadialTangentialDistortion,
    "plumb_bob": RadialTangentialDistortion,
    "radialtangential8": RadialTangentialDistortion8,
    "radial-tangential8": RadialTangentialDistortion8,
    "equidistant": EquidistantDistortion,
}


def distortion_by_name(name: str, params, dtype=torch.float64, device=None) -> Distortion:
    """Build a distortion from the YAML ``distortion_type`` tag."""
    cls = _REGISTRY[name.strip().lower()]
    if cls is NoDistortion:
        return NoDistortion()
    return cls.from_params(params, dtype=dtype, device=device)
