"""A fixed-count Gauss-Newton pose refine and its 6x6 Hessian.

Port of ``okvis2_tpu/frontend/pose_refine.py``. The reference refines a
recognised place's pose with a small Ceres solve over the inlier
reprojection errors and takes the loop edge's information from its 6x6
Hessian (okvis_frontend/src/Frontend.cpp:440-530). Here: five
Gauss-Newton steps on tangent-plane angular residuals between measured
bearings and predicted directions, the Jacobian from ``torch.func.jacfwd``
(under ``okvis2_torch.FORWARD_AD_LOCK``: the pipelined loop refines on the
host thread while the solve worker linearises), then J^T J at the final
pose and its Cholesky factor as the sqrt information.

A matrix that is not positive definite makes ``jnp.linalg.cholesky``
return NaN, and loop verification rejects a refine that is not finite
("refine diverged"). ``torch.linalg.cholesky`` raises instead, so the
factor comes from ``cholesky_ex`` and is replaced by the same NaN factor
where it failed: a degenerate verification is rejected, not raised.
"""

from __future__ import annotations

import torch
from torch.func import jacfwd

from okvis2_torch import forward_ad_locked
from okvis2_torch.core import so3
from okvis2_torch.core.se3 import Transformation


def _residuals(T_SW7, pts_W, rays_C, R_cs, t_cs, weights):
    """Tangent-plane angular residuals [N,2] of the predicted directions
    against the measured bearings, whitened by ``weights`` (~1/sigma)."""
    p_S = Transformation(r=T_SW7[:3], q=T_SW7[3:7]).apply(pts_W)
    p_C = torch.einsum("nij,nj->ni", R_cs, p_S) + t_cs
    p_n = p_C / (torch.linalg.norm(p_C, dim=-1, keepdim=True) + 1e-12)
    # a tangent basis of each measured ray
    ex = torch.tensor([1.0, 0.0, 0.0], dtype=rays_C.dtype, device=rays_C.device)
    ey = torch.tensor([0.0, 1.0, 0.0], dtype=rays_C.dtype, device=rays_C.device)
    a = torch.where(torch.abs(rays_C[:, 0:1]) < 0.9, ex, ey)
    e1 = torch.linalg.cross(rays_C, a)
    e1 = e1 / (torch.linalg.norm(e1, dim=-1, keepdim=True) + 1e-12)
    e2 = torch.linalg.cross(rays_C, e1)
    r = torch.stack([torch.sum(p_n * e1, -1), torch.sum(p_n * e2, -1)], dim=-1)
    return r * weights[:, None]


def _oplus(T7, d):
    r = T7[:3] + d[:3]
    q = so3.quat_normalize(so3.quat_multiply(so3.delta_q(d[3:6]), T7[3:7]))
    return torch.cat([r, q])


def _cholesky_or_nan(A):
    """Lower Cholesky factor of ``A``; where ``A`` is not positive definite,
    NaN on and below the diagonal and zeros above (``jnp.linalg.cholesky``'s
    answer)."""
    L, info = torch.linalg.cholesky_ex(A)
    return torch.where(info == 0, L, torch.tril(torch.full_like(L, float("nan"))))


@forward_ad_locked
def refine_pose_hessian(
    T_SW7_init: torch.Tensor,  # [7] body-from-world initial guess
    pts_W: torch.Tensor,  # [N,3]
    rays_C: torch.Tensor,  # [N,3] measured unit bearings (own camera)
    cam_idx: torch.Tensor,  # [N]
    mask: torch.Tensor,  # [N] bool
    T_SC7: torch.Tensor,  # [NC,7]
    angle_sigma: float = 0.002,  # ~1 px at f = 460
    n_iter: int = 5,
):
    """Gauss-Newton refine of T_SW on the masked set; returns (T_SW7 [7],
    H [6,6], sqrt_info [6,6]). H is the Gauss-Newton Hessian in the minimal
    [dr, dtheta] parametrisation at the returned pose; sqrt_info is the
    upper-triangular factor of H + 1e-10 I."""
    dtype = pts_W.dtype
    R_cs_all = so3.quat_to_matrix(T_SC7[:, 3:7]).transpose(-1, -2)
    t_cs_all = -torch.einsum("cij,cj->ci", R_cs_all, T_SC7[:, :3])
    cam_idx = cam_idx.long()
    R_cs, t_cs = R_cs_all[cam_idx], t_cs_all[cam_idx]
    w = mask.to(dtype) / angle_sigma
    eye = torch.eye(6, dtype=dtype, device=pts_W.device)
    z = torch.zeros(6, dtype=dtype, device=pts_W.device)

    def jac(T7):
        f = lambda d: _residuals(_oplus(T7, d), pts_W, rays_C, R_cs, t_cs, w).reshape(-1)  # noqa: E731
        return f(z), jacfwd(f)(z)  # [2N], [2N,6]

    T7 = T_SW7_init.to(dtype)
    for _ in range(n_iter):
        r, J = jac(T7)
        H = J.T @ J
        g = J.T @ r
        L = _cholesky_or_nan(H + 1e-8 * eye * (1.0 + torch.diagonal(H)))
        T7 = _oplus(T7, -torch.cholesky_solve(g[:, None], L)[:, 0])
    # J^T J once more at the final pose: the loop's last Hessian belongs to
    # the iterate before it
    _, J = jac(T7)
    H = J.T @ J
    sqrt_info = _cholesky_or_nan(H + 1e-10 * eye).T
    return T7, H, sqrt_info
