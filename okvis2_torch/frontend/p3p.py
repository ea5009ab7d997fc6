"""Closed-form P3P (Lambda-Twist) and rig absolute-pose RANSAC.

Port of ``okvis2_tpu/frontend/p3p.py``. The reference solves absolute pose
with opengv's GP3P inside a sequential RANSAC loop over the whole camera
rig (Frontend.cpp:2208-2278). Here, as in the JAX package:

- the minimal solver is Lambda-Twist P3P (Persson & Nordberg, ECCV 2018)
  in closed form: one real cubic root, a rank-2 symmetric 3x3
  eigendecomposition via cross products, and a 3-point Procrustes. Every
  function takes a leading hypothesis dimension H;
- each hypothesis samples its 3 correspondences from ONE camera (P3P needs
  central bearings), hypotheses round-robin over the cameras, and every
  hypothesis is scored against the correspondences of ALL cameras in the
  body frame, so the accepted pose and inlier set are rig-consistent.

RANSAC is split in two: ``sample_hypotheses`` draws the indices from a
``torch.Generator`` and ``ransac_rig_pose_from_samples`` solves and scores
them, so the indices can also come from elsewhere (the parity tests inject
the JAX package's draws). 3x3 determinants use the cofactor expansion
where the reference calls ``jnp.linalg.det`` (LU): both round differently
in the last bits.
"""

from __future__ import annotations

import torch

from okvis2_torch.core import so3
from okvis2_torch.core.se3 import Transformation


def _cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def _norm(x):
    return torch.linalg.norm(x, dim=-1)


def _det3(A: torch.Tensor) -> torch.Tensor:
    """Determinant of [..., 3, 3] by cofactor expansion along row 0."""
    return (A[..., 0, 0] * (A[..., 1, 1] * A[..., 2, 2] - A[..., 1, 2] * A[..., 2, 1])
            - A[..., 0, 1] * (A[..., 1, 0] * A[..., 2, 2] - A[..., 1, 2] * A[..., 2, 0])
            + A[..., 0, 2] * (A[..., 1, 0] * A[..., 2, 1] - A[..., 1, 1] * A[..., 2, 0]))


def _bilinear(u, M, v):
    """u^T M v over leading dims: u, v [..., 3], M [..., 3, 3]."""
    return torch.sum(u * (M @ v[..., None])[..., 0], dim=-1)


def _pick(cond, a, b):
    """Batched select of vectors: cond [...], a, b [..., k]."""
    return torch.where(cond[..., None], a, b)


def _basis_hint(v):
    """(1,0,0) where |v_x| < 0.9, else (0,1,0), per row of v [..., 3]."""
    ex = torch.zeros_like(v)
    ex[..., 0] = 1.0
    ey = torch.zeros_like(v)
    ey[..., 1] = 1.0
    return _pick(v[..., 0].abs() < 0.9, ex, ey)


def _cubic_real_root(c2, c1, c0):
    """One real root of x^3 + c2 x^2 + c1 x + c0 (trigonometric Cardano,
    branch-free: both branches are computed with clamped arguments)."""
    p = c1 - c2 * c2 / 3.0
    q = 2.0 * c2**3 / 27.0 - c2 * c1 / 3.0 + c0
    disc = (q / 2.0) ** 2 + (p / 3.0) ** 3
    sq = torch.sqrt(disc.abs())
    # disc > 0: one real root via Cardano with cube roots
    u3 = -q / 2.0 + sq
    v3 = -q / 2.0 - sq

    def cbrt(x):
        return torch.sign(x) * x.abs() ** (1.0 / 3.0)

    root_pos = cbrt(u3) + cbrt(v3)
    # disc <= 0: three real roots; take the one of the cos branch
    safe_p = torch.where(p < -1e-30, p, torch.full_like(p, -1e-30))
    arg = torch.clamp(3.0 * q / (2.0 * safe_p) * torch.sqrt(-3.0 / safe_p), -1.0, 1.0)
    t = torch.arccos(arg) / 3.0
    root_neg = 2.0 * torch.sqrt(-safe_p / 3.0) * torch.cos(t)
    root = torch.where(disc > 0, root_pos, root_neg)
    return root - c2 / 3.0


def _eig_rank2_sym3(D: torch.Tensor):
    """Eigendecomposition of symmetric [..., 3, 3] with det ~ 0 (rank <= 2).

    Returns (sigma1, sigma2, u1, u2, u3) with sigma1 >= sigma2 the two
    possibly-nonzero eigenvalues and u3 the (approximate) null vector.
    """
    # null vector: the largest cross product of two rows (first on ties)
    cands = torch.stack([_cross(D[..., 0, :], D[..., 1, :]),
                         _cross(D[..., 0, :], D[..., 2, :]),
                         _cross(D[..., 1, :], D[..., 2, :])], dim=-2)
    best = torch.argmax(_norm(cands), dim=-1)
    u3 = torch.gather(cands, -2, best[..., None, None].expand(best.shape + (1, 3)))[..., 0, :]
    u3 = u3 / (_norm(u3)[..., None] + 1e-30)
    # orthonormal basis of the complement
    a = _basis_hint(u3)
    e1 = _cross(u3, a)
    e1 = e1 / (_norm(e1)[..., None] + 1e-30)
    e2 = _cross(u3, e1)
    E = torch.stack([e1, e2], dim=-1)  # [...,3,2]
    B = E.transpose(-1, -2) @ D @ E  # [...,2,2] symmetric
    tr = B[..., 0, 0] + B[..., 1, 1]
    dt = B[..., 0, 0] * B[..., 1, 1] - B[..., 0, 1] * B[..., 1, 0]
    s = torch.sqrt(torch.clamp(tr * tr / 4.0 - dt, min=0.0))
    s1 = tr / 2.0 + s
    s2 = tr / 2.0 - s
    # eigenvector of B for s1: the (B - s2 I) column with the larger norm
    M1 = B - s2[..., None, None] * torch.eye(2, dtype=D.dtype, device=D.device)
    col0, col1 = M1[..., :, 0], M1[..., :, 1]
    v1 = _pick(_norm(col0) > _norm(col1), col0, col1)
    v1 = v1 / (_norm(v1)[..., None] + 1e-30)
    v2 = torch.stack([-v1[..., 1], v1[..., 0]], dim=-1)
    u1 = (E @ v1[..., None])[..., 0]
    u2 = (E @ v2[..., None])[..., 0]
    return s1, s2, u1, u2, u3


def _procrustes_3pt(X_W: torch.Tensor, Y_C: torch.Tensor):
    """R, t with Y_C ~= R X_W + t from exactly 3 correspondences
    ([..., 3, 3] each, points in rows), via orthonormal triads of the
    difference vectors (closed form, no SVD)."""

    def triad(P):
        d1 = P[..., 1, :] - P[..., 0, :]
        d2 = P[..., 2, :] - P[..., 0, :]
        e1 = d1 / (_norm(d1)[..., None] + 1e-30)
        e3 = _cross(d1, d2)
        e3 = e3 / (_norm(e3)[..., None] + 1e-30)
        e2 = _cross(e3, e1)
        return torch.stack([e1, e2, e3], dim=-1)  # [...,3,3] columns

    R = triad(Y_C) @ triad(X_W).transpose(-1, -2)
    t = torch.mean(Y_C, dim=-2) - (R @ torch.mean(X_W, dim=-2)[..., None])[..., 0]
    return R, t


def p3p_lambda_twist(x_W: torch.Tensor, y_C: torch.Tensor):
    """Up to 4 camera poses per hypothesis from 3 world points + 3 unit
    bearings.

    x_W [H,3,3] world points, y_C [H,3,3] unit bearings (camera frame),
    points in rows. Returns (R [H,4,3,3], t [H,4,3], valid [H,4]) with
    y ~ normalize(R x + t); the 4 solutions are (+tau, root 0),
    (+tau, root 1), (-tau, root 0), (-tau, root 1), as the reference's.
    """
    x0, x1, x2 = x_W[..., 0, :], x_W[..., 1, :], x_W[..., 2, :]
    y0, y1, y2 = y_C[..., 0, :], y_C[..., 1, :], y_C[..., 2, :]
    a12 = torch.sum((x0 - x1) ** 2, dim=-1)
    a13 = torch.sum((x0 - x2) ** 2, dim=-1)
    a23 = torch.sum((x1 - x2) ** 2, dim=-1)
    b12 = torch.sum(y0 * y1, dim=-1)
    b13 = torch.sum(y0 * y2, dim=-1)
    b23 = torch.sum(y1 * y2, dim=-1)

    z = torch.zeros_like(a12)
    one = torch.ones_like(a12)

    def mat(rows):
        return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)

    M12 = mat([[one, -b12, z], [-b12, one, z], [z, z, z]])
    M13 = mat([[one, z, -b13], [z, z, z], [-b13, z, one]])
    M23 = mat([[z, z, z], [z, one, -b23], [z, -b23, one]])

    # homogeneous quadrics: lam^T D lam = 0
    D1 = M12 * a23[..., None, None] - M23 * a12[..., None, None]
    D2 = M13 * a23[..., None, None] - M23 * a13[..., None, None]

    # det(D1 + g D2) = 0: cubic c3 g^3 + ... + c0
    def rows(r0, r1, r2):
        return _det3(torch.stack([r0, r1, r2], dim=-2))

    A, Bm = [D1[..., i, :] for i in range(3)], [D2[..., i, :] for i in range(3)]
    c3 = _det3(D2)
    c0 = _det3(D1)
    # middle coefficients by row-multilinearity of det: gamma^1 collects the
    # terms with exactly ONE row taken from D2, gamma^2 those with two
    c1 = rows(Bm[0], A[1], A[2]) + rows(A[0], Bm[1], A[2]) + rows(A[0], A[1], Bm[2])
    c2 = rows(A[0], Bm[1], Bm[2]) + rows(Bm[0], A[1], Bm[2]) + rows(Bm[0], Bm[1], A[2])
    safe_c3 = torch.where(c3.abs() > 1e-20, c3, torch.full_like(c3, 1e-20))
    gamma = _cubic_real_root(c2 / safe_c3, c1 / safe_c3, c0 / safe_c3)
    D0 = D1 + gamma[..., None, None] * D2  # rank 2, signature (+,-,0)

    s1, s2, u1, u2, u3 = _eig_rank2_sym3(D0)
    # lam^T D0 lam = s1 (u1.lam)^2 + s2 (u2.lam)^2 = 0
    # => u1.lam = +/- tau u2.lam, tau = sqrt(-s2/s1)
    safe_s1 = torch.where(s1.abs() > 1e-30, s1, torch.full_like(s1, 1e-30))
    tau = torch.sqrt(torch.clamp(-s2 / safe_s1, min=0.0))

    lams, oks = [], []
    for sgn in (1.0, -1.0):
        # lam lies in the plane orthogonal to w = u1 - sgn*tau*u2
        w = u1 - sgn * tau[..., None] * u2
        aa = _basis_hint(w)
        wn = w / (_norm(w)[..., None] + 1e-30)
        p1 = _cross(wn, aa)
        p1 = p1 / (_norm(p1)[..., None] + 1e-30)
        p2 = _cross(wn, p1)
        # lam = a (p1 + r p2): lam^T D1 lam = 0 is quadratic in r; the scale
        # a comes from the inhomogeneous constraint lam^T M23 lam = a23
        A1 = _bilinear(p1, D1, p1)
        B1 = _bilinear(p1, D1, p2)
        C1 = _bilinear(p2, D1, p2)
        disc = B1 * B1 - A1 * C1
        ok_r = disc >= 0
        sqd = torch.sqrt(torch.clamp(disc, min=0.0))
        safe_C1 = torch.where(C1.abs() > 1e-20, C1, torch.full_like(C1, 1e-20))
        for r in ((-B1 + sqd) / safe_C1, (-B1 - sqd) / safe_C1):
            d = p1 + r[..., None] * p2
            denom = _bilinear(d, M23, d)
            a2 = a23 / torch.where(denom.abs() > 1e-20, denom, torch.full_like(denom, 1e-20))
            ok = (a2 > 0) & (denom > 1e-20)
            lam = torch.sqrt(torch.clamp(a2, min=0.0))[..., None] * d
            # depths must be positive; flip the overall sign if negative
            lam = _pick(torch.sum(lam, dim=-1) < 0, -lam, lam)
            lams.append(lam)
            oks.append(ok & torch.all(lam > 0, dim=-1) & ok_r)
    lams = torch.stack(lams, dim=-2)  # [H,4,3]
    valid = torch.stack(oks, dim=-1)  # [H,4]

    Y = lams[..., None] * y_C[..., None, :, :]  # [H,4,3,3] camera-frame points
    R, t = _procrustes_3pt(x_W[..., None, :, :].expand(Y.shape), Y)
    return R, t, valid


def sample_hypotheses(generator: torch.Generator, mask: torch.Tensor, cam_idx: torch.Tensor,
                      n_hyp: int, NC: int) -> torch.Tensor:
    """[n_hyp, 3] correspondence indices: hypothesis h draws 3 distinct
    correspondences of camera h % NC by Gumbel top-3 over the masked ones
    (p3p.py:255-263 of the JAX package, from ``generator``'s stream)."""
    N = mask.shape[0]
    dev = mask.device
    cam_of_hyp = torch.arange(n_hyp, device=dev) % NC
    w = (mask[None, :] & (cam_idx[None, :] == cam_of_hyp[:, None])).float()
    u = torch.rand((n_hyp, N), generator=generator, device=generator.device)
    u = u.to(dev).clamp_min(torch.finfo(torch.float32).tiny)
    g = -torch.log(-torch.log(u)) + torch.log(w + 1e-30)
    return torch.topk(g, 3, dim=-1).indices


def ransac_rig_pose_from_samples(
    idx: torch.Tensor,  # [H,3] sampled correspondence indices
    pts_W: torch.Tensor,  # [N,3] landmark positions
    rays_C: torch.Tensor,  # [N,3] unit bearings in each obs's OWN camera
    cam_idx: torch.Tensor,  # [N] camera of each correspondence
    mask: torch.Tensor,  # [N] bool
    T_SC: torch.Tensor,  # [NC,7] rig extrinsics
    threshold_deg: float = 0.6,
    min_inliers: int = 10,
):
    """Solve and score the hypotheses ``idx`` (hypothesis h from camera
    h % NC) rig-jointly; returns T_WS and the joint inlier set of the
    first best-scoring candidate (the reference's argmax)."""
    H = idx.shape[0]
    NC = T_SC.shape[0]
    dev = pts_W.device
    cam_of_hyp = torch.arange(H, device=dev) % NC
    Rs, ts, valid = p3p_lambda_twist(pts_W[idx], rays_C[idx])  # [H,4,...]
    # camera pose -> body pose: T_SW = T_SC @ T_CW
    R_sc = so3.quat_to_matrix(T_SC[:, 3:7])  # [NC,3,3]
    R_sc_h = R_sc[cam_of_hyp][:, None]  # [H,1,3,3]
    Rs = (R_sc_h @ Rs).reshape(H * 4, 3, 3)
    ts = ((R_sc_h @ ts[..., None])[..., 0] + T_SC[cam_of_hyp, None, :3]).reshape(H * 4, 3)
    valid = valid.reshape(H * 4)

    # score every candidate against ALL correspondences (rig-joint):
    # p_C = R_CS (R_SW p_W + t_SW) + t_CS per row's own camera
    R_cs = R_sc.transpose(-1, -2)
    t_cs = -torch.einsum("cij,cj->ci", R_cs, T_SC[:, :3])
    R_cs_o = R_cs[cam_idx]  # [N,3,3]
    t_cs_o = t_cs[cam_idx]  # [N,3]
    p_S = torch.einsum("hij,nj->hni", Rs, pts_W) + ts[:, None, :]  # [H4,N,3]
    p_C = torch.einsum("nij,hnj->hni", R_cs_o, p_S) + t_cs_o[None]
    p_n = p_C / (torch.linalg.norm(p_C, dim=-1, keepdim=True) + 1e-12)
    cosang = torch.einsum("hni,ni->hn", p_n, rays_C)
    cos_th = torch.cos(torch.deg2rad(torch.tensor(float(threshold_deg), dtype=pts_W.dtype)))
    inl = (cosang > cos_th) & mask[None, :]
    scores = torch.where(valid, torch.sum(inl, dim=1), torch.full_like(valid, -1, dtype=torch.long))
    best = torch.argmax(scores)
    n_in = scores[best]
    R_ws = Rs[best].T
    t_ws = -R_ws @ ts[best]
    return {
        "T_WS": Transformation(r=t_ws, q=so3.matrix_to_quat(R_ws)),
        "inliers": inl[best],
        "num_inliers": n_in,
        "ok": n_in >= min_inliers,
        "scores": scores,
        "best": best,
    }


def ransac_rig_pose(generator, pts_W, rays_C, cam_idx, mask, T_SC, threshold_deg=0.6,
                    n_hyp=128, min_inliers=10):
    """Rig-consistent absolute-pose RANSAC (runRansac3d2d role,
    Frontend.cpp:2208-2278): ``sample_hypotheses`` then
    ``ransac_rig_pose_from_samples``."""
    idx = sample_hypotheses(generator, mask, cam_idx, n_hyp, T_SC.shape[0])
    return ransac_rig_pose_from_samples(idx, pts_W, rays_C, cam_idx, mask, T_SC,
                                        threshold_deg, min_inliers)
