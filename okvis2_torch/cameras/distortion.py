"""Lens distortion models as batched torch functions.

Port of ``okvis2_tpu/cameras/distortion.py``. ``distort`` maps normalised
image coordinates [..., 2] to distorted ones and is differentiable;
``undistort`` inverts it with a fixed count of branch-free Gauss-Newton
steps, unrolled as in the reference. Each model states its 2x2 Jacobian in
closed form (``jacobian``), where the reference takes it by forward-mode
differentiation: in eager PyTorch two ``torch.func.jvp`` calls cost about
50 times the ``distort`` they differentiate, and back-projection runs 8
steps per call.

Parameter orders (OpenCV / reference YAML):
  radialtangential   : [k1, k2, p1, p2]
  radialtangential8  : [k1, k2, p1, p2, k3, k4, k5, k6]
  equidistant        : [k1, k2, k3, k4]
"""

from __future__ import annotations

import dataclasses

import torch


class Distortion:
    """Base: subclasses are frozen dataclasses with a ``distort``."""

    n_params: int = 0

    def distort(self, xy: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def jacobian(self, xy: torch.Tensor) -> torch.Tensor:
        """d distort / d xy, [..., 2, 2] (row: output, column: input)."""
        raise NotImplementedError

    def undistort(self, xy_d: torch.Tensor, iterations: int = 8) -> torch.Tensor:
        """Invert ``distort`` by Newton steps on the 2x2 system (statically
        unrolled, branch-free, batched)."""

        def step(x):
            y = self.distort(x)
            e = xy_d - y
            J = self.jacobian(x)
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


def _split(v: torch.Tensor, n: int):
    """The ``n`` entries of ``v``'s last axis as [..., 1] slices. ``distort``
    computes on these, not on 0-d entries: under ``torch.func.jacfwd`` a
    Python scalar combined with a 0-d float32 tensor gives float64 tangents
    (torch 2.13), which would carry float64 into a float32 solve's
    Jacobians."""
    return [v[..., i:i + 1] for i in range(n)]


def _mat2(a, b, c, d):
    """[[a, b], [c, d]] over leading dims."""
    return torch.stack([torch.stack([a, b], dim=-1), torch.stack([c, d], dim=-1)], dim=-2)


def _radtan_jacobian(x, y, rad, drad, p1, p2):
    """Jacobian of (x rad + 2 p1 x y + p2 (r2 + 2 x^2),
    y rad + 2 p2 x y + p1 (r2 + 2 y^2)) with rad a function of r2 = x^2 +
    y^2 and drad = d rad / d r2."""
    xy2 = 2.0 * x * y * drad
    return _mat2(rad + 2.0 * x * x * drad + 2.0 * p1 * y + 6.0 * p2 * x,
                 xy2 + 2.0 * p1 * x + 2.0 * p2 * y,
                 xy2 + 2.0 * p2 * y + 2.0 * p1 * x,
                 rad + 2.0 * y * y * drad + 2.0 * p2 * x + 6.0 * p1 * y)


@dataclasses.dataclass(frozen=True)
class NoDistortion(Distortion):
    n_params = 0

    def distort(self, xy):
        return xy

    def jacobian(self, xy):
        one, zero = torch.ones_like(xy[..., 0]), torch.zeros_like(xy[..., 0])
        return _mat2(one, zero, zero, one)

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
        k1, k2, p1, p2 = _split(self.k, 4)
        x, y = _split(xy, 2)
        x2, y2, xy_ = x * x, y * y, x * y
        r2 = x2 + y2
        rad = 1.0 + r2 * (k1 + k2 * r2)
        xd = x * rad + 2.0 * p1 * xy_ + p2 * (r2 + 2.0 * x2)
        yd = y * rad + 2.0 * p2 * xy_ + p1 * (r2 + 2.0 * y2)
        return torch.cat([xd, yd], dim=-1)

    def jacobian(self, xy):
        k1, k2, p1, p2 = self.k[..., 0], self.k[..., 1], self.k[..., 2], self.k[..., 3]
        x, y = xy[..., 0], xy[..., 1]
        r2 = x * x + y * y
        return _radtan_jacobian(x, y, 1.0 + r2 * (k1 + k2 * r2), k1 + 2.0 * k2 * r2, p1, p2)

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
        k1, k2, p1, p2, k3, k4, k5, k6 = _split(self.k, 8)
        x, y = _split(xy, 2)
        x2, y2, xy_ = x * x, y * y, x * y
        r2 = x2 + y2
        num = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
        den = 1.0 + r2 * (k4 + r2 * (k5 + r2 * k6))
        rad = num / den
        xd = x * rad + 2.0 * p1 * xy_ + p2 * (r2 + 2.0 * x2)
        yd = y * rad + 2.0 * p2 * xy_ + p1 * (r2 + 2.0 * y2)
        return torch.cat([xd, yd], dim=-1)

    def jacobian(self, xy):
        k1, k2, p1, p2 = self.k[..., 0], self.k[..., 1], self.k[..., 2], self.k[..., 3]
        k3, k4, k5, k6 = self.k[..., 4], self.k[..., 5], self.k[..., 6], self.k[..., 7]
        x, y = xy[..., 0], xy[..., 1]
        r2 = x * x + y * y
        num = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
        den = 1.0 + r2 * (k4 + r2 * (k5 + r2 * k6))
        dnum = k1 + r2 * (2.0 * k2 + 3.0 * r2 * k3)
        dden = k4 + r2 * (2.0 * k5 + 3.0 * r2 * k6)
        return _radtan_jacobian(x, y, num / den, (dnum * den - num * dden) / (den * den),
                                p1, p2)

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
        k1, k2, k3, k4 = _split(self.k, 4)
        x, y = _split(xy, 2)
        r2 = x * x + y * y
        r = torch.sqrt(r2)
        theta = torch.atan(r)
        t2 = theta * theta
        thetad = theta * (1.0 + t2 * (k1 + t2 * (k2 + t2 * (k3 + t2 * k4))))
        big = r > 1e-8
        safe_r = torch.where(big, r, torch.ones_like(r))
        scaling = torch.where(big, thetad / safe_r, torch.ones_like(r))
        return xy * scaling

    def jacobian(self, xy):
        """d (xy s(r)) = s I + (s'(r) / r) xy xy^T, s = thetad / r; the
        identity where r <= 1e-8, as ``distort`` is there."""
        k1, k2, k3, k4 = self.k[..., 0], self.k[..., 1], self.k[..., 2], self.k[..., 3]
        x, y = xy[..., 0], xy[..., 1]
        r2 = x * x + y * y
        r = torch.sqrt(r2)
        theta = torch.atan(r)
        t2 = theta * theta
        thetad = theta * (1.0 + t2 * (k1 + t2 * (k2 + t2 * (k3 + t2 * k4))))
        dthetad = (1.0 + t2 * (3.0 * k1 + t2 * (5.0 * k2 + t2 * (7.0 * k3 + t2 * 9.0 * k4))))
        big = r > 1e-8
        safe_r = torch.where(big, r, torch.ones_like(r))
        s = torch.where(big, thetad / safe_r, torch.ones_like(r))
        # s'(r) / r = (thetad'(r) r - thetad) / r^3, thetad'(r) = dthetad / (1 + r2)
        ds = torch.where(big, (dthetad / (1.0 + r2) * safe_r - thetad) / (safe_r * safe_r * safe_r),
                         torch.zeros_like(r))
        return _mat2(s + ds * x * x, ds * x * y, ds * x * y, s + ds * y * y)

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
