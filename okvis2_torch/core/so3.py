"""Batched SO(3) / quaternion algebra on torch tensors.

Port of ``okvis2_tpu/core/so3.py``. Quaternions are ``[x, y, z, w]`` in
the last axis (Eigen order). Every function broadcasts over leading batch
axes and is branch-free (``torch.where`` instead of ifs), so it runs under
``torch.func.vmap``/``jacfwd`` and is differentiable at zero rotation —
the solver linearises exactly there.
"""

from __future__ import annotations

import torch


def cross_mx(v: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric cross-product matrix. v: [..., 3] -> [..., 3, 3]."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack(
        [
            torch.stack([zero, -z, y], dim=-1),
            torch.stack([z, zero, -x], dim=-1),
            torch.stack([-y, x, zero], dim=-1),
        ],
        dim=-2,
    )


def sinc(x: torch.Tensor) -> torch.Tensor:
    """sin(x)/x with a 6th-order Taylor fallback near 0 (branch-free)."""
    x2 = x * x
    small = 1.0 - x2 / 6.0 + x2 * x2 / 120.0 - x2 * x2 * x2 / 5040.0
    # guard the division so the unselected branch never produces nan grads
    big = x.abs() > 1e-6
    safe_x = torch.where(big, x, torch.ones_like(x))
    return torch.where(big, torch.sin(safe_x) / safe_x, small)


def delta_q(d_alpha: torch.Tensor) -> torch.Tensor:
    """Exponential-map quaternion of a rotation vector [..., 3] -> [..., 4].

    Written in |a|^2 with a guarded sqrt so it is differentiable AT zero
    (the derivative of norm() at 0 is nan).
    """
    n2 = torch.sum(d_alpha * d_alpha, dim=-1, keepdim=True)
    small = n2 < 1e-12
    safe_n2 = torch.where(small, torch.ones_like(n2), n2)
    halfnorm = 0.5 * torch.sqrt(safe_n2)
    sinc_series = 1.0 - n2 / 24.0 + n2 * n2 / 1920.0
    cos_series = 1.0 - n2 / 8.0 + n2 * n2 / 384.0
    sinc_half = torch.where(small, sinc_series, torch.sin(halfnorm) / halfnorm)
    w = torch.where(small, cos_series, torch.cos(halfnorm))
    vec = sinc_half * 0.5 * d_alpha
    return torch.cat([vec, w], dim=-1)


def right_jacobian(phi: torch.Tensor) -> torch.Tensor:
    """SO(3) right Jacobian J_r(phi). phi: [..., 3] -> [..., 3, 3]."""
    angle = torch.linalg.norm(phi, dim=-1)[..., None, None]
    px = cross_mx(phi)
    px2 = px @ px
    eye = torch.eye(3, dtype=phi.dtype, device=phi.device).expand(px.shape)
    a2 = angle * angle
    a3 = a2 * angle
    safe = angle > 1e-4
    one = torch.ones_like(a2)
    safe_a2 = torch.where(safe, a2, one)
    safe_a3 = torch.where(safe, a3, one)
    c1 = torch.where(safe, -(1.0 - torch.cos(angle)) / safe_a2, -0.5 * one)
    c2 = torch.where(safe, (angle - torch.sin(angle)) / safe_a3, one / 6.0)
    return eye + c1 * px + c2 * px2


def quat_multiply(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Hamilton product q1 ⊗ q2, both [..., 4] xyzw."""
    x1, y1, z1, w1 = q1[..., 0], q1[..., 1], q1[..., 2], q1[..., 3]
    x2, y2, z2, w2 = q2[..., 0], q2[..., 1], q2[..., 2], q2[..., 3]
    return torch.stack(
        [
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        ],
        dim=-1,
    )


def quat_conjugate(q: torch.Tensor) -> torch.Tensor:
    """Inverse of a unit quaternion."""
    return torch.cat([-q[..., :3], q[..., 3:4]], dim=-1)


def quat_normalize(q: torch.Tensor) -> torch.Tensor:
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def quat_positive(q: torch.Tensor) -> torch.Tensor:
    """Canonicalise sign so w >= 0 (double cover)."""
    return torch.where(q[..., 3:4] < 0.0, -q, q)


def quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion [..., 4] -> rotation matrix [..., 3, 3]."""
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    return torch.stack(
        [
            torch.stack([1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)], dim=-1),
            torch.stack([2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)], dim=-1),
            torch.stack([2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)], dim=-1),
        ],
        dim=-2,
    )


def matrix_to_quat(C: torch.Tensor) -> torch.Tensor:
    """Rotation matrix [..., 3, 3] -> unit quaternion [..., 4] xyzw.

    Branch-free Shepperd-style: all four candidates, the best-conditioned
    one picked elementwise.
    """
    m00, m01, m02 = C[..., 0, 0], C[..., 0, 1], C[..., 0, 2]
    m10, m11, m12 = C[..., 1, 0], C[..., 1, 1], C[..., 1, 2]
    m20, m21, m22 = C[..., 2, 0], C[..., 2, 1], C[..., 2, 2]
    tr = m00 + m11 + m22

    qw2 = 1.0 + tr
    qx2 = 1.0 + m00 - m11 - m22
    qy2 = 1.0 - m00 + m11 - m22
    qz2 = 1.0 - m00 - m11 + m22

    def _safe_sqrt(v):
        return torch.sqrt(torch.clamp(v, min=1e-12))

    sw = 2.0 * _safe_sqrt(qw2)
    cand_w = torch.stack(
        [(m21 - m12) / sw, (m02 - m20) / sw, (m10 - m01) / sw, sw / 4.0], dim=-1
    )
    sx = 2.0 * _safe_sqrt(qx2)
    cand_x = torch.stack(
        [sx / 4.0, (m01 + m10) / sx, (m02 + m20) / sx, (m21 - m12) / sx], dim=-1
    )
    sy = 2.0 * _safe_sqrt(qy2)
    cand_y = torch.stack(
        [(m01 + m10) / sy, sy / 4.0, (m12 + m21) / sy, (m02 - m20) / sy], dim=-1
    )
    sz = 2.0 * _safe_sqrt(qz2)
    cand_z = torch.stack(
        [(m02 + m20) / sz, (m12 + m21) / sz, sz / 4.0, (m10 - m01) / sz], dim=-1
    )

    mags = torch.stack([qw2, qx2, qy2, qz2], dim=-1)
    best = torch.argmax(mags, dim=-1)[..., None, None]
    cands = torch.stack([cand_w, cand_x, cand_y, cand_z], dim=-2)  # [..., 4, 4]
    q = torch.take_along_dim(cands, best, dim=-2)[..., 0, :]
    return quat_normalize(q)


def rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vector(s) v [..., 3] by unit quaternion q [..., 4]."""
    qv = q[..., :3]
    w = q[..., 3:4]
    qv, v = torch.broadcast_tensors(qv, v)
    t = 2.0 * torch.linalg.cross(qv, v, dim=-1)
    return v + w * t + torch.linalg.cross(qv, t, dim=-1)


def quat_log(q: torch.Tensor) -> torch.Tensor:
    """Log map: unit quaternion -> rotation vector [..., 3].

    atan2 form away from identity, an even-power series near it, guarded
    so it is differentiable AT the identity.
    """
    q = quat_positive(q)
    v = q[..., :3]
    w = q[..., 3:4]
    vn2 = torch.sum(v * v, dim=-1, keepdim=True)
    small = vn2 < 1e-12
    safe_vn = torch.sqrt(torch.where(small, torch.ones_like(vn2), vn2))
    angle = 2.0 * torch.atan2(safe_vn, w)
    safe_w = torch.clamp(w, min=1e-6)
    series = 2.0 / safe_w * (1.0 - vn2 / (3.0 * safe_w * safe_w))
    factor = torch.where(small, series, angle / safe_vn)
    return v * factor


def quat_plus(q: torch.Tensor) -> torch.Tensor:
    """Left-multiplication matrix: (q ⊗ p).coeffs = quat_plus(q) @ p.coeffs."""
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack(
        [
            torch.stack([w, -z, y, x], dim=-1),
            torch.stack([z, w, -x, y], dim=-1),
            torch.stack([-y, x, w, z], dim=-1),
            torch.stack([-x, -y, -z, w], dim=-1),
        ],
        dim=-2,
    )


def quat_oplus(q: torch.Tensor) -> torch.Tensor:
    """Right-multiplication matrix: (p ⊗ q).coeffs = quat_oplus(q) @ p.coeffs."""
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack(
        [
            torch.stack([w, z, -y, x], dim=-1),
            torch.stack([-z, w, x, y], dim=-1),
            torch.stack([y, -x, w, z], dim=-1),
            torch.stack([-x, -y, -z, w], dim=-1),
        ],
        dim=-2,
    )


def identity_quat(batch_shape=(), dtype=torch.float64, device=None) -> torch.Tensor:
    q = torch.zeros(tuple(batch_shape) + (4,), dtype=dtype, device=device)
    q[..., 3] = 1.0
    return q
