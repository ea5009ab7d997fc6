"""Batched SE(3) transformations on torch tensors.

Port of ``okvis2_tpu/core/se3.py``: a frozen dataclass of a translation
``r`` [..., 3] and a unit quaternion ``q`` [..., 4] (xyzw), with the
reference's pose-manifold perturbation

    T ⊞ [dr, da] = (r + dr,  deltaQ(da) ⊗ q)      (world-frame/left).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from okvis2_torch.core import so3


@dataclasses.dataclass(frozen=True)
class Transformation:
    r: torch.Tensor  # [..., 3]
    q: torch.Tensor  # [..., 4] xyzw, unit

    # -- constructors ----------------------------------------------------
    @classmethod
    def identity(cls, batch_shape=(), dtype=torch.float64, device=None) -> "Transformation":
        return cls(
            r=torch.zeros(tuple(batch_shape) + (3,), dtype=dtype, device=device),
            q=so3.identity_quat(batch_shape, dtype=dtype, device=device),
        )

    @classmethod
    def from_matrix(cls, T: torch.Tensor) -> "Transformation":
        """[..., 4, 4] homogeneous matrix -> Transformation."""
        return cls(r=T[..., :3, 3], q=so3.matrix_to_quat(T[..., :3, :3]))

    @classmethod
    def from_rq(cls, r, q) -> "Transformation":
        return cls(r=torch.as_tensor(r), q=so3.quat_normalize(torch.as_tensor(q)))

    # -- accessors ---------------------------------------------------------
    @property
    def C(self) -> torch.Tensor:
        """Rotation matrix [..., 3, 3]."""
        return so3.quat_to_matrix(self.q)

    def matrix(self) -> torch.Tensor:
        """Homogeneous [..., 4, 4]."""
        C = self.C
        bottom = torch.zeros(C.shape[:-2] + (1, 4), dtype=C.dtype, device=C.device)
        bottom[..., 0, 3] = 1.0
        top = torch.cat([C, self.r[..., :, None]], dim=-1)
        return torch.cat([top, bottom], dim=-2)

    @property
    def batch_shape(self) -> Tuple[int, ...]:
        return tuple(self.r.shape[:-1])

    # -- group operations --------------------------------------------------
    def inverse(self) -> "Transformation":
        qi = so3.quat_conjugate(self.q)
        return Transformation(r=-so3.rotate(qi, self.r), q=qi)

    def __matmul__(self, other: "Transformation") -> "Transformation":
        """Composition T_AC = T_AB @ T_BC."""
        return Transformation(
            r=self.r + so3.rotate(self.q, other.r),
            q=so3.quat_normalize(so3.quat_multiply(self.q, other.q)),
        )

    def apply(self, p: torch.Tensor) -> torch.Tensor:
        """Transform points p [..., 3]."""
        return so3.rotate(self.q, p) + self.r

    def apply_homogeneous(self, hp: torch.Tensor) -> torch.Tensor:
        """Transform homogeneous points hp [..., 4]."""
        return torch.cat(
            [so3.rotate(self.q, hp[..., :3]) + self.r * hp[..., 3:4], hp[..., 3:4]],
            dim=-1,
        )

    # -- manifold ------------------------------------------------------------
    def oplus(self, delta: torch.Tensor) -> "Transformation":
        """Boxplus with world-frame rotation perturbation; delta [..., 6]."""
        dq = so3.delta_q(delta[..., 3:6])
        return Transformation(
            r=self.r + delta[..., :3],
            q=so3.quat_normalize(so3.quat_multiply(dq, self.q)),
        )

    def ominus(self, other: "Transformation") -> torch.Tensor:
        """Inverse of oplus: delta such that other ⊞ delta == self."""
        dq = so3.quat_multiply(self.q, so3.quat_conjugate(other.q))
        return torch.cat([self.r - other.r, so3.quat_log(dq)], dim=-1)

    def parameters(self) -> torch.Tensor:
        """[..., 7] = [r, q] flat parameter vector."""
        return torch.cat([self.r, self.q], dim=-1)

    @classmethod
    def from_parameters(cls, p: torch.Tensor) -> "Transformation":
        return cls(r=p[..., :3], q=so3.quat_normalize(p[..., 3:7]))

    def __getitem__(self, idx) -> "Transformation":
        return Transformation(r=self.r[idx], q=self.q[idx])


def se3_log(T: Transformation) -> torch.Tensor:
    """Pseudo-log used for pose-graph residuals: [dr, log(q)] (6,)."""
    return torch.cat([T.r, so3.quat_log(T.q)], dim=-1)
