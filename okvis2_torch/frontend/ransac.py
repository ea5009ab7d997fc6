"""Batched-hypothesis RANSAC: DLT absolute pose, rotation-only and 8-point
relative pose.

Port of ``okvis2_tpu/frontend/ransac.py``. The reference runs opengv's
RANSAC loops one hypothesis at a time (GP3P absolute pose, Stewenius 5-pt
relative pose, 2-pt rotation-only; okvis_frontend/src/
Frontend.cpp:2208-2334). Here every hypothesis is drawn up front, each
minimal problem is solved in one batch, every hypothesis is scored against
every correspondence in one einsum, and the best score wins; larger than
minimal samples (6-point DLT, 8-point essential matrix) are paid for with
hypothesis count.

Each RANSAC is split in two, as ``p3p.py`` is: ``sample_indices`` draws
the samples from a ``torch.Generator`` (Gumbel top-k over the valid
correspondences), and ``*_from_samples`` solves and scores given samples,
so the parity tests can inject the JAX package's draws. The JAX package's
``jnp.linalg.det`` (LU) is a cofactor expansion here; both round
differently in the last bits.
"""

from __future__ import annotations

import math

import torch

from okvis2_torch.core import so3
from okvis2_torch.core.se3 import Transformation
from okvis2_torch.frontend.p3p import _det3
from okvis2_torch.ops.linalg import inv3x3


def sample_indices(generator: torch.Generator, n_hyp: int, sample_size: int,
                   weights: torch.Tensor) -> torch.Tensor:
    """[n_hyp, sample_size] correspondence indices per hypothesis: distinct
    within one hypothesis, drawn with probability ~ ``weights`` [N] (the
    Gumbel top-k trick), from ``generator``'s stream."""
    N = weights.shape[0]
    u = torch.rand((n_hyp, N), generator=generator, device=generator.device,
                   dtype=torch.float64)
    u = u.to(weights.device).clamp_min(torch.finfo(torch.float64).tiny)
    g = -torch.log(-torch.log(u)) + torch.log(weights.to(torch.float64) + 1e-30)
    return torch.topk(g, sample_size, dim=-1).indices


def _null_vector(M: torch.Tensor) -> torch.Tensor:
    """Eigenvector of the smallest eigenvalue of small PSD matrices
    [..., d, d], by 4 inverse iterations with Cholesky solves."""
    d = M.shape[-1]
    eye = torch.eye(d, dtype=M.dtype, device=M.device)
    eps = 1e-9 * torch.diagonal(M, dim1=-2, dim2=-1).sum(-1) + 1e-30
    L = torch.linalg.cholesky(M + eps[..., None, None] * eye)
    x = torch.ones(M.shape[:-1], dtype=M.dtype, device=M.device)
    for _ in range(4):
        x = torch.cholesky_solve(x[..., None], L)[..., 0]
        x = x / (torch.linalg.norm(x, dim=-1, keepdim=True) + 1e-30)
    return x


def _dlt_pose(points_W: torch.Tensor, rays_C: torch.Tensor):
    """Absolute poses from >= 6 point-ray correspondences by DLT and polar
    projection: points_W, rays_C [H, K, 3] -> (R_CW [H, 3, 3], t_CW [H, 3]).
    Behind-camera solutions are not flipped: they score no inliers."""
    H, K = points_W.shape[:2]
    # the projective equations ray x (R p + t) = 0, unknown
    # m = [r11..r13, r21..r23, r31..r33, t1..t3]
    rx = so3.cross_mx(rays_C)  # [H,K,3,3]
    A_R = torch.einsum("hkij,hkl->hkijl", rx, points_W).reshape(H, K, 3, 9)
    A = torch.cat([A_R, rx], dim=-1).reshape(H, K * 3, 12)
    m = _null_vector(A.transpose(-1, -2) @ A)
    R_raw = m[:, :9].reshape(H, 3, 3)
    t_raw = m[:, 9:12]
    # det > 0 and unit scale, then Newton's polar iteration X <- (X + X^-T)/2
    det_raw = _det3(R_raw)
    sign = torch.where(det_raw < 0, -1.0, 1.0).to(R_raw.dtype)
    scale = sign * det_raw.abs() ** (1.0 / 3.0)
    safe_scale = torch.where(scale.abs() > 1e-12, scale, torch.full_like(scale, 1e-12))
    X = R_raw / safe_scale[:, None, None]
    for _ in range(5):
        X = 0.5 * (X + inv3x3(X).transpose(-1, -2))
    return X, t_raw / safe_scale[:, None]


def _cos_threshold(threshold_deg: float) -> float:
    return math.cos(math.radians(threshold_deg))


def ransac_absolute_pose_from_samples(idx: torch.Tensor, points_W: torch.Tensor,
                                      rays_C: torch.Tensor, mask: torch.Tensor,
                                      threshold_deg: float = 0.6):
    """Solve the DLT hypotheses ``idx`` [H, K] and score each against every
    correspondence by the angle between the measured and the predicted ray;
    returns T_CW, the inliers [N], their number and ``ok`` (>= 10)."""
    Rs, ts = _dlt_pose(points_W[idx], rays_C[idx])
    pred = torch.einsum("hij,nj->hni", Rs, points_W) + ts[:, None, :]
    pred_n = pred / (torch.linalg.norm(pred, dim=-1, keepdim=True) + 1e-12)
    cosang = torch.einsum("hni,ni->hn", pred_n, rays_C)
    inl = (cosang > _cos_threshold(threshold_deg)) & mask[None, :]
    scores = inl.sum(dim=1)
    best = torch.argmax(scores)
    n_in = scores[best]
    return {
        "T_CW": Transformation(r=ts[best], q=so3.matrix_to_quat(Rs[best])),
        "inliers": inl[best],
        "num_inliers": n_in,
        "ok": n_in >= 10,
    }


def ransac_absolute_pose(generator: torch.Generator, points_W: torch.Tensor,
                         rays_C: torch.Tensor, mask: torch.Tensor,
                         threshold_deg: float = 0.6, n_hyp: int = 256, sample_size: int = 6):
    """Central absolute-pose RANSAC (runRansac3d2d, Frontend.cpp:2208-2278):
    points_W [N, 3] landmarks, rays_C [N, 3] unit bearings, mask [N]; the
    angular threshold ~4 px at f = 460."""
    idx = sample_indices(generator, n_hyp, sample_size, mask.to(points_W.dtype))
    return ransac_absolute_pose_from_samples(idx, points_W, rays_C, mask, threshold_deg)


def _rotation_from_pairs(d1: torch.Tensor, d2: torch.Tensor) -> torch.Tensor:
    """Procrustes rotations R with d2 ~= R d1: d1, d2 [H, K, 3] unit."""
    B = torch.einsum("hki,hkj->hij", d2, d1)
    u, _, vt = torch.linalg.svd(B)
    d = torch.ones(B.shape[:-1], dtype=B.dtype, device=B.device)
    d[:, 2] = _det3(u @ vt)
    return u @ torch.diag_embed(d) @ vt


def ransac_rotation_only_from_samples(idx: torch.Tensor, rays_A: torch.Tensor,
                                      rays_B: torch.Tensor, mask: torch.Tensor,
                                      threshold_deg: float = 0.5):
    """Score the 2-point rotation hypotheses ``idx`` [H, 2]; returns R_BA,
    the inliers and their number."""
    Rs = _rotation_from_pairs(rays_A[idx], rays_B[idx])
    pred = torch.einsum("hij,nj->hni", Rs, rays_A)
    cosang = torch.einsum("hni,ni->hn", pred, rays_B)
    inl = (cosang > _cos_threshold(threshold_deg)) & mask[None, :]
    scores = inl.sum(dim=1)
    best = torch.argmax(scores)
    return {"R_BA": Rs[best], "inliers": inl[best], "num_inliers": scores[best]}


def ransac_rotation_only(generator: torch.Generator, rays_A: torch.Tensor,
                         rays_B: torch.Tensor, mask: torch.Tensor, threshold_deg: float = 0.5,
                         n_hyp: int = 128, sample_size: int = 2):
    """2-point rotation-only RANSAC (the reference's rotation-only 2D-2D,
    Frontend.cpp:2311-2334): detects pure-rotation motion."""
    idx = sample_indices(generator, n_hyp, sample_size, mask.to(rays_A.dtype))
    return ransac_rotation_only_from_samples(idx, rays_A, rays_B, mask, threshold_deg)


def _essential_8pt(rays_A: torch.Tensor, rays_B: torch.Tensor) -> torch.Tensor:
    """Essential matrices from >= 8 bearing pairs [H, K, 3]: b^T E a = 0 on
    unit bearings without plane normalisation (rays with z <= 0, inside a
    > 180 deg fisheye's view, stay well-conditioned), rank 2 with equal
    singular values."""
    H = rays_A.shape[0]
    A = torch.einsum("hki,hkj->hkij", rays_B, rays_A).reshape(H, -1, 9)
    E = _null_vector(A.transpose(-1, -2) @ A).reshape(H, 3, 3)
    u, _, vt = torch.linalg.svd(E)
    d = torch.tensor([1.0, 1.0, 0.0], dtype=E.dtype, device=E.device)
    return u @ torch.diag_embed(d.expand(H, 3)) @ vt


def ransac_relative_pose_from_samples(idx: torch.Tensor, rays_A: torch.Tensor,
                                      rays_B: torch.Tensor, mask: torch.Tensor,
                                      threshold: float = 2e-3):
    """Score the 8-point hypotheses ``idx`` [H, 8] by the Sampson residual
    (angular, valid for any field of view); returns the best E, its inliers
    and their number."""
    Es = _essential_8pt(rays_A[idx], rays_B[idx])
    Ea = torch.einsum("hij,nj->hni", Es, rays_A)
    Etb = torch.einsum("hji,nj->hni", Es, rays_B)
    num = torch.einsum("ni,hni->hn", rays_B, Ea) ** 2
    den = (Ea * Ea).sum(-1) + (Etb * Etb).sum(-1)
    sampson = num / (den + 1e-18)
    inl = (sampson < threshold * threshold) & mask[None, :]
    scores = inl.sum(dim=1)
    best = torch.argmax(scores)
    return {"E": Es[best], "inliers": inl[best], "num_inliers": scores[best]}


def ransac_relative_pose(generator: torch.Generator, rays_A: torch.Tensor,
                         rays_B: torch.Tensor, mask: torch.Tensor, threshold: float = 2e-3,
                         n_hyp: int = 256, sample_size: int = 8):
    """Relative-pose (essential matrix) RANSAC, in place of the reference's
    Stewenius 5-point (Frontend.cpp:2311-2330); callers decompose E
    (``decompose_essential``) and triangulate."""
    idx = sample_indices(generator, n_hyp, sample_size, mask.to(rays_A.dtype))
    return ransac_relative_pose_from_samples(idx, rays_A, rays_B, mask, threshold)


def decompose_essential(E: torch.Tensor, ray_A: torch.Tensor, ray_B: torch.Tensor):
    """The (R_BA, t_BA) of E's four candidates under which the
    correspondence ``ray_A`` / ``ray_B`` lies in front of both cameras (the
    first such; the first candidate when none is)."""
    u, _, vt = torch.linalg.svd(E)
    u = u * torch.sign(_det3(u))
    vt = vt * torch.sign(_det3(vt))
    W = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
                     dtype=E.dtype, device=E.device)
    R1 = u @ W @ vt
    R2 = u @ W.T @ vt
    t = u[:, 2]

    def depth_ok(R, t):
        # triangulate the pair: both depths positive?
        e1 = ray_A
        e2 = R.T @ ray_B  # the B ray's direction in frame A
        b_ = -R.T @ t
        a11 = e1 @ e1
        a12 = -(e1 @ e2)
        a22 = e2 @ e2
        b1 = b_ @ e1
        b2 = -(b_ @ e2)
        det = a11 * a22 - a12 * a12
        l1 = (a22 * b1 - a12 * b2) / det
        l2 = (a11 * b2 - a12 * b1) / det
        return (l1 > 0) & (l2 > 0)

    cands = [(R1, t), (R1, -t), (R2, t), (R2, -t)]
    oks = torch.stack([depth_ok(R, tt) for R, tt in cands])
    best = int(torch.argmax(oks.to(torch.uint8)))
    return cands[best]
