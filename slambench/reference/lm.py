"""Plain float64 Levenberg-Marquardt over a window problem: the reference
that the port's window solves and final BA are held to.

It follows the solver's published algorithm step for step from the
problem the program packed (its state: observations, IMU preintegrals,
priors and the starting estimate), in float64 and with one dense damped
system per iteration where the program eliminates landmarks by a Schur
complement in its own precision:

- residuals: whitened reprojection with the Cauchy loss as iteratively
  reweighted least squares (OKVIS2's ``ReprojectionError``), the IMU
  preintegration error with its first-order bias correction
  (``ImuError``), pose, speed/bias, extrinsics and landmark priors, and
  relative-pose errors, each with its validity mask;
- minimal perturbations: 6 per pose (translation, then a left rotation
  vector), 9 per speed/bias, 3 per landmark (its xyz, w fixed);
- damping: Marquardt (lambda times each diagonal entry) plus 1e-12 on
  states and the configured absolute floor on landmarks; a step is taken
  when it lowers the cost; lambda falls by ``lambda_down`` after a taken
  step and rises by ``lambda_up`` after a refused one (clipped to
  [1e-12, 1e8]); the loop ends at the iteration budget, after two taken
  steps of negligible relative decrease, a taken step whose largest state
  component is under the step tolerance, or when lambda reaches 1e7.

The cameras and gravity come from the configuration file, not from the
program; the problem's fields are read by name. It imports nothing of the
port.
"""

from __future__ import annotations

import math

import torch
from torch.func import jacfwd, vmap

F64 = torch.float64


# ---------------------------------------------------------------------------
# rotations
# ---------------------------------------------------------------------------

def qmul(a, b):
    x1, y1, z1, w1 = a.unbind(-1)
    x2, y2, z2, w2 = b.unbind(-1)
    return torch.stack([w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
                        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
                        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
                        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2], -1)


def qconj(q):
    return torch.cat([-q[..., :3], q[..., 3:]], -1)


def qexp(a):
    """Rotation vector -> unit quaternion, smooth at zero."""
    n2 = (a * a).sum(-1, keepdim=True)
    small = n2 < 1e-12
    safe = torch.where(small, torch.ones_like(n2), n2)
    h = 0.5 * torch.sqrt(safe)
    s = torch.where(small, 1.0 - n2 / 24.0 + n2 * n2 / 1920.0, torch.sin(h) / h)
    c = torch.where(small, 1.0 - n2 / 8.0 + n2 * n2 / 384.0, torch.cos(h))
    return torch.cat([0.5 * s * a, c], -1)


def qlog(q):
    """Unit quaternion -> rotation vector (w >= 0 branch), smooth at one."""
    q = torch.where(q[..., 3:4] < 0, -q, q)
    v, w = q[..., :3], q[..., 3:4]
    vn2 = (v * v).sum(-1, keepdim=True)
    small = vn2 < 1e-12
    vn = torch.sqrt(torch.where(small, torch.ones_like(vn2), vn2))
    sw = torch.clamp(w, min=1e-6)
    series = 2.0 / sw * (1.0 - vn2 / (3.0 * sw * sw))
    return v * torch.where(small, series, 2.0 * torch.atan2(vn, w) / vn)


def qmat(q):
    x, y, z, w = q.unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
    ], -2)


def qrot(q, v):
    return (qmat(q) @ v[..., None])[..., 0]


def oplus_pose(p7, d6):
    q = qmul(qexp(d6[..., 3:]), p7[..., 3:])
    return torch.cat([p7[..., :3] + d6[..., :3], q / torch.linalg.norm(q, dim=-1, keepdim=True)],
                     -1)


def compose(a7, b7):
    return torch.cat([a7[..., :3] + qrot(a7[..., 3:], b7[..., :3]), qmul(a7[..., 3:], b7[..., 3:])],
                     -1)


def inverse(a7):
    qi = qconj(a7[..., 3:])
    return torch.cat([-qrot(qi, a7[..., :3]), qi], -1)


# ---------------------------------------------------------------------------
# factors
# ---------------------------------------------------------------------------

class Rig:
    """Cameras (pinhole, radial-tangential) and gravity from a
    configuration file's ``rig``."""

    def __init__(self, rig: dict, device):
        cams = rig["cameras"]
        for c in cams:
            if c["distortion"] != "radialtangential":
                raise ValueError(f"reference: distortion {c['distortion']!r} is not modelled")
        t = lambda v: torch.tensor(v, dtype=F64, device=device)  # noqa: E731
        self.focal = t([c["focal"] for c in cams])
        self.center = t([c["center"] for c in cams])
        self.k = t([c["coefficients"] for c in cams])
        self.size = t([c["size"] for c in cams])
        self.g = float(rig["imu"]["g"])


def project(hp_C, focal, center, k, size):
    """Homogeneous camera-frame point -> (uv, valid), as OKVIS2's
    ``projectHomogeneous`` with the half-pixel image margin."""
    sign = torch.where(hp_C[..., 3:4] < 0, -1.0, 1.0)
    p = hp_C[..., :3] * sign
    z = p[..., 2:3]
    safe = torch.where(z.abs() > 1e-12, z, torch.full_like(z, 1e-12))
    xy = p[..., :2] / safe
    x, y = xy[..., 0:1], xy[..., 1:2]
    k1, k2, p1, p2 = k[..., 0:1], k[..., 1:2], k[..., 2:3], k[..., 3:4]
    r2 = x * x + y * y
    rad = 1.0 + r2 * (k1 + k2 * r2)
    xd = x * rad + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * rad + 2.0 * p2 * x * y + p1 * (r2 + 2.0 * y * y)
    uv = torch.cat([xd, yd], -1) * focal + center
    valid = ((z[..., 0] > 1e-12) & (uv[..., 0] >= -0.5) & (uv[..., 0] <= size[..., 0] - 0.5)
             & (uv[..., 1] >= -0.5) & (uv[..., 1] <= size[..., 1] - 0.5))
    return uv, valid


def reproj_residual(p7, e7, hp, uv, w, focal, center, k, size):
    T_WC = compose(p7, e7)
    T_CW = inverse(T_WC)
    hp_C = torch.cat([qrot(T_CW[..., 3:], hp[..., :3]) + T_CW[..., :3] * hp[..., 3:4],
                      hp[..., 3:4]], -1)
    uv_hat, valid = project(hp_C, focal, center, k, size)
    return (uv_hat - uv) * w[..., None], valid


def imu_residual(g, pre, p0, sb0, p1, sb1):
    (delta_q, c_int, c_dint, acc_int, acc_dint, d_a_bg, d_v_bg, d_p_bg, sqrt_info, dt, bg_lin,
     ba_lin) = pre
    v0, bg0, ba0 = sb0[:3], sb0[3:6], sb0[6:9]
    v1, bg1, ba1 = sb1[:3], sb1[3:6], sb1[6:9]
    g_W = torch.stack([torch.zeros_like(dt), torch.zeros_like(dt), -g * torch.ones_like(dt)])
    C_SW0 = qmat(p0[3:]).T
    dbg, dba = bg0 - bg_lin, ba0 - ba_lin
    dq_hat = qmul(qexp(d_a_bg @ dbg), delta_q)
    dv_hat = acc_int + d_v_bg @ dbg - c_int @ dba
    dp_hat = acc_dint + d_p_bg @ dbg - c_dint @ dba
    dp_est = C_SW0 @ (p1[:3] - p0[:3] - v0 * dt - 0.5 * g_W * dt * dt)
    dv_est = C_SW0 @ (v1 - v0 - g_W * dt)
    dq_err = qmul(qmul(qconj(p0[3:]), p1[3:]), qconj(dq_hat))
    r = torch.cat([dp_est - dp_hat, qlog(dq_err), dv_est - dv_hat, bg1 - bg0, ba1 - ba0])
    return sqrt_info @ r


def pose_prior_residual(p7, prior7, sq):
    return sq @ torch.cat([p7[:3] - prior7[:3], qlog(qmul(p7[3:], qconj(prior7[3:])))])


def rel_residual(pa, pb, meas, sq):
    T_ab = compose(inverse(pa), pb)
    return sq @ torch.cat([T_ab[:3] - meas[:3], qlog(qmul(T_ab[3:], qconj(meas[3:])))])


_PRE_FIELDS = ("delta_q", "c_int", "c_dint", "acc_int", "acc_dint", "d_alpha_dbg", "d_v_dbg",
               "d_p_dbg", "sqrt_info", "dt_total", "bg_lin", "ba_lin")


class Problem:
    """A packed window problem in float64 on ``device``: the program's
    fields, read by name and copied."""

    def __init__(self, prob, device):
        g = lambda name: getattr(prob, name).detach().to(device)  # noqa: E731
        f = lambda name: g(name).to(F64)  # noqa: E731
        self.pose, self.sb, self.ext = f("pose"), f("speed_bias"), f("extrinsics")
        self.state_mask, self.pose_frozen, self.sb_frozen = g("state_mask"), g("pose_frozen"), \
            g("sb_frozen")
        self.ext_frozen = g("ext_frozen")
        # only the landmark slots in use: the rest take no step
        lm_mask = g("lm_mask")
        self.lm_sel = torch.nonzero(lm_mask)[:, 0]
        slot = torch.full(lm_mask.shape, -1, dtype=torch.long, device=device)
        slot[self.lm_sel] = torch.arange(len(self.lm_sel), device=device)
        self.lm = f("landmarks")[self.lm_sel]
        self.lm_mask = torch.ones(len(self.lm_sel), dtype=torch.bool, device=device)
        m = g("obs_mask") & self.state_mask[g("obs_state")] & lm_mask[g("obs_lm")]
        sel = torch.nonzero(m)[:, 0]
        self.obs_state, self.obs_cam = g("obs_state")[sel], g("obs_cam")[sel]
        self.obs_lm = slot[g("obs_lm")[sel]]
        self.obs_uv, self.obs_w = f("obs_uv")[sel], f("obs_sqrt_info")[sel]
        pre = prob.imu_pre
        mi = g("imu_mask") & self.state_mask[g("imu_i")] & self.state_mask[g("imu_j")]
        si = torch.nonzero(mi)[:, 0]
        self.imu_i, self.imu_j = g("imu_i")[si], g("imu_j")[si]
        self.pre = tuple(getattr(pre, n).detach().to(device, F64)[si] for n in _PRE_FIELDS)
        mp = g("pose_prior_mask") & self.state_mask
        sp = torch.nonzero(mp)[:, 0]
        self.pp_idx, self.pp, self.pp_sq = sp, f("pose_prior")[sp], f("pose_prior_sqrt")[sp]
        msb = (g("sb_prior_mask") & self.state_mask).to(F64)
        self.sbp, self.sbp_sq = f("sb_prior"), f("sb_prior_sqrt") * msb[:, None]
        mr = g("rel_mask") & self.state_mask[g("rel_i")] & self.state_mask[g("rel_j")]
        sr = torch.nonzero(mr)[:, 0]
        self.rel_i, self.rel_j = g("rel_i")[sr], g("rel_j")[sr]
        self.rel_T, self.rel_sq = f("rel_T")[sr], f("rel_sqrt")[sr]
        mlp = g("lm_prior_mask")[self.lm_sel].to(F64)
        self.lmp, self.lmp_w = f("lm_prior")[self.lm_sel], f("lm_prior_sqrt")[self.lm_sel] * mlp
        me = g("ext_prior_mask")
        se = torch.nonzero(me)[:, 0]
        self.ep_idx, self.ep, self.ep_sq = se, f("ext_prior")[se], f("ext_prior_sqrt")[se]
        self.S, self.NC, self.L = self.pose.shape[0], self.ext.shape[0], self.lm.shape[0]


def cost(P: Problem, rig: Rig, x, cauchy: float):
    """0.5 * sum of the robustified squared residuals at x = (pose, sb, ext,
    lm)."""
    pose, sb, ext, lm = x
    oc = P.obs_cam
    r, valid = reproj_residual(pose[P.obs_state], ext[oc], lm[P.obs_lm], P.obs_uv, P.obs_w,
                               rig.focal[oc], rig.center[oc], rig.k[oc], rig.size[oc])
    s = torch.where(valid, (r * r).sum(-1), torch.zeros_like(r[:, 0]))
    c2 = cauchy * cauchy
    total = 0.5 * torch.sum(c2 * torch.log1p(s / c2))
    if len(P.imu_i):
        ri = vmap(lambda pre, a, b, c, d: imu_residual(rig.g, pre, a, b, c, d))(
            P.pre, pose[P.imu_i], sb[P.imu_i], pose[P.imu_j], sb[P.imu_j])
        total = total + 0.5 * torch.sum(ri * ri)
    if len(P.pp_idx):
        rp = vmap(pose_prior_residual)(pose[P.pp_idx], P.pp, P.pp_sq)
        total = total + 0.5 * torch.sum(rp * rp)
    rs = P.sbp_sq * (sb - P.sbp)
    total = total + 0.5 * torch.sum(rs * rs)
    if len(P.rel_i):
        rr = vmap(rel_residual)(pose[P.rel_i], pose[P.rel_j], P.rel_T, P.rel_sq)
        total = total + 0.5 * torch.sum(rr * rr)
    if len(P.ep_idx):
        re = vmap(pose_prior_residual)(ext[P.ep_idx], P.ep, P.ep_sq)
        total = total + 0.5 * torch.sum(re * re)
    dl = (lm[:, :3] - P.lmp[:, :3]) * P.lmp_w[:, None]
    return total + 0.5 * torch.sum(dl * dl)


def _scatter(H, b, idx, J, r):
    """H[idx, idx] += J^T J and b[idx] -= J^T r per row block (idx [N,k],
    J [N,m,k], r [N,m])."""
    k = idx.shape[1]
    blocks = torch.einsum("nmi,nmj->nij", J, J)
    rows = idx[:, :, None].expand(-1, k, k)
    cols = idx[:, None, :].expand(-1, k, k)
    H.index_put_((rows.reshape(-1), cols.reshape(-1)), blocks.reshape(-1), accumulate=True)
    b.index_put_((idx.reshape(-1),), -torch.einsum("nmi,nm->ni", J, r).reshape(-1),
                 accumulate=True)


def linearize(P: Problem, rig: Rig, x, cauchy: float):
    """Dense normal equations (H, b) over [pose 6S | sb 9S | ext 6NC |
    landmarks 3L] at x, each factor's Jacobian by forward differentiation
    against the minimal perturbation."""
    pose, sb, ext, lm = x
    S, NC, L = P.S, P.NC, P.L
    D = 15 * S + 6 * NC + 3 * L
    dev = pose.device
    H = torch.zeros((D, D), dtype=F64, device=dev)
    b = torch.zeros(D, dtype=F64, device=dev)
    o_sb, o_ext, o_lm = 6 * S, 15 * S, 15 * S + 6 * NC
    ar = lambda n: torch.arange(n, device=dev)  # noqa: E731

    # reprojection
    z6, z3 = torch.zeros(6, dtype=F64, device=dev), torch.zeros(3, dtype=F64, device=dev)

    def rep(p7, e7, hp, uv, w, fo, ce, kk, sz):
        def f(dp, de, dl):
            r, v = reproj_residual(oplus_pose(p7, dp), oplus_pose(e7, de),
                                   torch.cat([hp[:3] + dl, hp[3:]]), uv, w, fo, ce, kk, sz)
            return r, (r, v)
        (jp, je, jl), (r, v) = jacfwd(f, argnums=(0, 1, 2), has_aux=True)(z6, z6, z3)
        return r, v, torch.cat([jp, je, jl], -1)

    oc = P.obs_cam
    r, valid, J = vmap(rep)(pose[P.obs_state], ext[oc], lm[P.obs_lm], P.obs_uv, P.obs_w,
                            rig.focal[oc], rig.center[oc], rig.k[oc], rig.size[oc])
    w = torch.where(valid, torch.rsqrt(1.0 + (r * r).sum(-1) / cauchy ** 2), torch.zeros_like(r[:, 0]))
    idx = torch.cat([6 * P.obs_state[:, None] + ar(6), o_ext + 6 * oc[:, None] + ar(6),
                     o_lm + 3 * P.obs_lm[:, None] + ar(3)], 1)
    _scatter(H, b, idx, J * w[:, None, None], r * w[:, None])

    # IMU links
    if len(P.imu_i):
        z9 = torch.zeros(9, dtype=F64, device=dev)

        def imu(pre, p0, s0, p1, s1):
            def f(d0, e0, d1, e1):
                rr = imu_residual(rig.g, pre, oplus_pose(p0, d0), s0 + e0, oplus_pose(p1, d1),
                                  s1 + e1)
                return rr, rr
            j, rr = jacfwd(f, argnums=(0, 1, 2, 3), has_aux=True)(z6, z9, z6, z9)
            return rr, torch.cat(j, -1)

        ri, Ji = vmap(imu)(P.pre, pose[P.imu_i], sb[P.imu_i], pose[P.imu_j], sb[P.imu_j])
        i, j = P.imu_i[:, None], P.imu_j[:, None]
        idx = torch.cat([6 * i + ar(6), o_sb + 9 * i + ar(9), 6 * j + ar(6), o_sb + 9 * j + ar(9)],
                        1)
        _scatter(H, b, idx, Ji, ri)

    # pose priors, extrinsics priors, relative poses
    def pp(p7, prior, sq):
        def f(d):
            rr = pose_prior_residual(oplus_pose(p7, d), prior, sq)
            return rr, rr
        j, rr = jacfwd(f, has_aux=True)(z6)
        return rr, j

    if len(P.pp_idx):
        rp, Jp = vmap(pp)(pose[P.pp_idx], P.pp, P.pp_sq)
        _scatter(H, b, 6 * P.pp_idx[:, None] + ar(6), Jp, rp)
    if len(P.ep_idx):
        re, Je = vmap(pp)(ext[P.ep_idx], P.ep, P.ep_sq)
        _scatter(H, b, o_ext + 6 * P.ep_idx[:, None] + ar(6), Je, re)
    if len(P.rel_i):
        def rel(pa, pb, meas, sq):
            def f(da, db):
                rr = rel_residual(oplus_pose(pa, da), oplus_pose(pb, db), meas, sq)
                return rr, rr
            (ja, jb), rr = jacfwd(f, argnums=(0, 1), has_aux=True)(z6, z6)
            return rr, torch.cat([ja, jb], -1)

        rr, Jr = vmap(rel)(pose[P.rel_i], pose[P.rel_j], P.rel_T, P.rel_sq)
        idx = torch.cat([6 * P.rel_i[:, None] + ar(6), 6 * P.rel_j[:, None] + ar(6)], 1)
        _scatter(H, b, idx, Jr, rr)

    # speed/bias priors (diagonal) and landmark priors (isotropic)
    dsb = torch.arange(o_sb, o_sb + 9 * S, device=dev)
    H[dsb, dsb] += (P.sbp_sq ** 2).reshape(-1)
    b[dsb] -= (P.sbp_sq ** 2 * (sb - P.sbp)).reshape(-1)
    dlm = torch.arange(o_lm, D, device=dev)
    w_lp = (P.lmp_w ** 2).repeat_interleave(3)
    H[dlm, dlm] += w_lp
    b[dlm] -= w_lp * (lm[:, :3] - P.lmp[:, :3]).reshape(-1)
    return H, b


def free_mask(P: Problem):
    fp = (P.state_mask & ~P.pose_frozen).repeat_interleave(6)
    fs = (P.state_mask & ~P.sb_frozen).repeat_interleave(9)
    fe = (~P.ext_frozen).repeat_interleave(6)
    return torch.cat([fp, fs, fe]).to(F64)


def damped_step(P: Problem, H, b, lam, landmark_damping: float):
    """The LM step of the damped system; NaN where its matrix is not
    positive definite (the step is then refused)."""
    nx = 15 * P.S + 6 * P.NC
    free = free_mask(P)
    Hx, bx = H[:nx, :nx] * free[:, None] * free[None, :], b[:nx] * free
    Hxl, Hl, bl = H[:nx, nx:] * free[:, None], H[nx:, nx:], b[nx:]
    diag_l = torch.diagonal(Hl).reshape(-1, 3)
    active = (P.lm_mask & (diag_l.sum(-1) > 0)).repeat_interleave(3)
    dl = torch.where(active, lam * torch.diagonal(Hl) + landmark_damping, torch.ones_like(bl))
    act = active.to(F64)
    Hl = Hl * act[:, None] * act[None, :] + torch.diag(dl)
    Hxl = Hxl * act[None, :]
    bl = bl * act
    Hd = torch.cat([torch.cat([Hx + torch.diag(lam * torch.diagonal(Hx) + 1e-12 + 1.0 - free), Hxl],
                              1),
                    torch.cat([Hxl.T, Hl], 1)], 0)
    rhs = torch.cat([bx, bl])
    d = torch.rsqrt(torch.clamp(torch.diagonal(Hd), min=1e-30))
    Lc, info = torch.linalg.cholesky_ex(Hd * d[:, None] * d[None, :])
    if int(info) != 0:
        delta = torch.full_like(rhs, math.nan)
    else:
        delta = d * torch.cholesky_solve((d * rhs)[:, None], Lc)[:, 0]
    dx = delta[:nx] * free
    dlm = (delta[nx:] * act).reshape(-1, 3)
    return dx, dlm


def apply(P: Problem, x, dx, dlm):
    pose, sb, ext, lm = x
    S, NC = P.S, P.NC
    return (oplus_pose(pose, dx[:6 * S].reshape(S, 6)), sb + dx[6 * S:15 * S].reshape(S, 9),
            oplus_pose(ext, dx[15 * S:].reshape(NC, 6)),
            torch.cat([lm[:, :3] + dlm, lm[:, 3:]], -1))


def solve(prob, rig: dict, config: dict, device) -> dict:
    """Follow the LM loop from the problem's estimate. ``config``: the
    solve's settings (max_iterations, initial_lambda, lambda_up,
    lambda_down, min_cost_decrease, cauchy_scale, landmark_damping,
    step_tolerance). Returns {"pose", "speed_bias", "extrinsics",
    "landmarks" (the slots in use, ``problem.lm_sel``), "iterations",
    "initial_cost", "final_cost"} in float64, and the Problem
    (``problem``) for later cost evaluations."""
    P = Problem(prob, device)
    R = Rig(rig, device)
    c = config
    x = (P.pose, P.sb, P.ext, P.lm)
    cost0 = cost(P, R, x, c["cauchy_scale"])
    lam, cur = float(c["initial_lambda"]), cost0
    it, stall, lam_ok = 0, 0, c["initial_lambda"] < 1e7
    while it < c["max_iterations"] and stall < 2 and lam_ok:
        H, b = linearize(P, R, x, c["cauchy_scale"])
        dx, dlm = damped_step(P, H, b, lam, c["landmark_damping"])
        cand = apply(P, x, dx, dlm)
        new = cost(P, R, cand, c["cauchy_scale"])
        accept = bool(new < cur)
        lam = min(max(lam * (c["lambda_down"] if accept else c["lambda_up"]), 1e-12), 1e8)
        small_dec = bool((cur - new) / max(float(cur), 1e-12) < c["min_cost_decrease"])
        small_step = bool(torch.max(torch.abs(dx)) < c["step_tolerance"])
        lam_ok = lam < 1e7
        if accept:
            stall = stall + 1 if small_dec else 0
            if c["step_tolerance"] > 0.0 and small_step:
                stall = 2
            x, cur = cand, new
        it += 1
    return {"pose": x[0], "speed_bias": x[1], "extrinsics": x[2], "landmarks": x[3],
            "iterations": it, "initial_cost": float(cost0), "final_cost": float(cur),
            "problem": P, "rig": R}
