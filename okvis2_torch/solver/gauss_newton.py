"""Levenberg-Marquardt with a Schur complement over landmarks.

Port of ``okvis2_tpu/solver/gauss_newton.py``:

- residuals and Jacobians of every factor type come from
  ``torch.func.jacfwd`` against minimal perturbations (6 per pose, 9 per
  speed/bias, 3 per landmark), batched with ``torch.func.vmap``;
- the state part of the normal equations is dense over
  D = 15 S + 6 NC; on window-scale problems it is gathered through a
  per-solve (camera, landmark, state) -> observation table (the TABLE
  path), on full-graph-scale problems built from one-hot products (the
  DENSE path), whose per-landmark sums run along a per-solve layout of the
  observations sorted by landmark: no atomics, so a float32 solve on the
  card gives the same result on every run;
- landmarks are eliminated by an explicit block Schur complement with
  batched 3x3 adjugate inverses; the reduced system is Jacobi
  preconditioned and solved by Cholesky;
- the LM loop runs on the host, one small readback per iteration, with
  the reference's exit rules (accept rule, lambda up/down and clip, stall
  counter, step tolerance), so it takes the same number of iterations.

With a ``torch.distributed`` process ``group`` (the landmark-sharded
solve, ``parallel/sharded_ba.py``), each rank holds a block of landmarks
with their observations and a replica of everything else. The
observation terms are summed over the group where the JAX package psums
over its mesh axis: the cost's observation and landmark-prior parts, the
normal equations before the replicated factors are added, and the Schur
complement; each is one all-reduce of the concatenated tensors. The LM
loop's flags are broadcast from the group's first rank, so every rank
leaves the loop together. With ``group=None`` nothing of this runs.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.func import jacfwd, vmap

from okvis2_torch import forward_ad_locked
from okvis2_torch.core import so3
from okvis2_torch.core.se3 import Transformation
from okvis2_torch.factors.imu_factor import imu_residual
from okvis2_torch.factors.priors import pose_prior_residual, relative_pose_residual
from okvis2_torch.factors.reprojection import cauchy_weight
from okvis2_torch.imu.preintegration import ImuParameters, Preintegrated
from okvis2_torch.ops.linalg import inv3x3, spd_solve
from okvis2_torch.solver.window_problem import SolverConfig, WindowProblem


# ---------------------------------------------------------------------------
# parameter perturbation
# ---------------------------------------------------------------------------

def _oplus_pose(pose7: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """pose [...,7] boxplus minimal [...,6] (translation + left quat)."""
    r = pose7[..., :3] + d[..., :3]
    dq = so3.delta_q(d[..., 3:6])
    q = so3.quat_normalize(so3.quat_multiply(dq, pose7[..., 3:7]))
    return torch.cat([r, q], dim=-1)


def _oplus_hp(hp: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """homogeneous point [...,4] boxplus [...,3] (xyz shift, w fixed)."""
    return torch.cat([hp[..., :3] + d, hp[..., 3:4]], dim=-1)


def _T(pose7: torch.Tensor) -> Transformation:
    return Transformation(r=pose7[..., :3], q=pose7[..., 3:7])


def _homogeneous(cameras) -> bool:
    """One distortion class and one image size across the rig."""
    c0 = cameras[0]
    return all(type(c.distortion) is type(c0.distortion) and c.image_size == c0.image_size
               for c in cameras[1:])


def _cameras_per_obs(problem: WindowProblem, cameras):
    """One camera whose parameter tensors are gathered per observation by
    ``obs_cam`` ([O,2] focal/center, [O,k] distortion), so each
    observation is evaluated once with its own camera. For homogeneous
    rigs (``_homogeneous``)."""
    c0 = cameras[0]
    focal = torch.stack([c.focal for c in cameras])[problem.obs_cam]
    center = torch.stack([c.center for c in cameras])[problem.obs_cam]
    k = torch.stack([c.distortion.params().to(focal) for c in cameras])[problem.obs_cam]
    return c0, focal, center, k


def _camera_passes(problem: WindowProblem, cameras):
    """The reprojection's evaluations: [(camera, focal [O,2], center [O,2],
    k [O,k], rows)]. A homogeneous rig is one pass over every row with
    ``_cameras_per_obs``'s gathered parameters (rows None). A rig whose
    cameras differ in distortion class or image size (the JAX package's
    masked per-camera fallback) is one pass per camera over every row
    with that camera's own parameters; ``rows`` [O] marks the rows it
    owns (``obs_cam == ci``), whose results the caller selects. Fixed
    shapes, no host read."""
    if _homogeneous(cameras):
        return [(*_cameras_per_obs(problem, cameras), None)]
    O = problem.obs_cam.shape[0]
    return [(c, c.focal.expand(O, -1), c.center.expand(O, -1),
             c.distortion.params().to(c.focal).expand(O, -1), problem.obs_cam == ci)
            for ci, c in enumerate(cameras)]


def _select_rows(rows, new, old):
    """``new`` where ``rows`` [O] is set, else ``old`` (any trailing shape)."""
    return torch.where(rows.reshape(rows.shape + (1,) * (new.dim() - 1)), new, old)


def _obs_mask(problem: WindowProblem) -> torch.Tensor:
    return (
        problem.obs_mask
        & problem.state_mask[problem.obs_state]
        & problem.lm_mask[problem.obs_lm]
    )


def _sum_over(group, *tensors):
    """Each tensor summed over the ranks of ``group``, by one all-reduce of
    their flat concatenation. Counts its calls in ``_sum_over.calls``."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    _sum_over.calls += 1
    return [part.reshape(t.shape)
            for part, t in zip(torch.split(flat, [t.numel() for t in tensors]), tensors)]


_sum_over.calls = 0


def _from_first_rank(group, t: torch.Tensor) -> torch.Tensor:
    """``t`` as the group's first rank holds it (one broadcast, counted in
    ``_from_first_rank.calls``)."""
    dist.broadcast(t, src=dist.get_global_rank(group, 0), group=group)
    _from_first_rank.calls += 1
    return t


_from_first_rank.calls = 0


# ---------------------------------------------------------------------------
# residual evaluation (no Jacobians) — used for cost
# ---------------------------------------------------------------------------

def _reproj_residuals(problem: WindowProblem, cameras):
    """All reprojection residuals [O,2] (whitened, unrobustified) + mask."""
    T_CW = (_T(problem.pose[problem.obs_state])
            @ _T(problem.extrinsics[problem.obs_cam])).inverse()
    hp_C = T_CW.apply_homogeneous(problem.landmarks[problem.obs_lm])
    r = torch.zeros_like(problem.obs_uv)
    valid = torch.zeros_like(problem.obs_mask)
    for c, focal, center, k, rows in _camera_passes(problem, cameras):
        uv_hat, valid_c = c.with_params(focal, center, k).project_homogeneous(hp_C)
        r_c = (uv_hat - problem.obs_uv) * problem.obs_sqrt_info[:, None]
        if rows is None:
            r, valid = r_c, valid_c
        else:
            r, valid = _select_rows(rows, r_c, r), _select_rows(rows, valid_c, valid)
    sel = _obs_mask(problem) & valid
    return torch.where(sel[:, None], r, torch.zeros_like(r)), sel


def _imu_residuals(problem: WindowProblem, imu_params: ImuParameters):
    def one(pre_leaves, p0, sb0, p1, sb1):
        pre = Preintegrated(*pre_leaves)
        return imu_residual(imu_params, pre, _T(p0), sb0, _T(p1), sb1)

    r = vmap(one)(
        problem.imu_pre.leaves(),
        problem.pose[problem.imu_i], problem.speed_bias[problem.imu_i],
        problem.pose[problem.imu_j], problem.speed_bias[problem.imu_j],
    )
    m = (problem.imu_mask & problem.state_mask[problem.imu_i]
         & problem.state_mask[problem.imu_j])
    return torch.where(m[:, None], r, torch.zeros_like(r))


def _pose_prior_residuals(pose, prior, sqrt, mask):
    r = vmap(lambda p, pr, sq: pose_prior_residual(_T(p), _T(pr), sq))(pose, prior, sqrt)
    return torch.where(mask[:, None], r, torch.zeros_like(r))


def _other_residuals(problem: WindowProblem, imu_params: ImuParameters):
    """IMU-link, prior and relative-pose residuals, stacked per group."""
    r_imu = _imu_residuals(problem, imu_params)  # [S-1,15]
    r_pp = _pose_prior_residuals(
        problem.pose, problem.pose_prior, problem.pose_prior_sqrt,
        problem.pose_prior_mask & problem.state_mask,
    )  # [S,6]
    m_sbp = problem.sb_prior_mask & problem.state_mask
    r_sbp = problem.sb_prior_sqrt * (problem.speed_bias - problem.sb_prior)
    r_sbp = torch.where(m_sbp[:, None], r_sbp, torch.zeros_like(r_sbp))  # [S,9]
    r_rel = vmap(
        lambda pi, pj, Tm, sq: relative_pose_residual(_T(pi), _T(pj), _T(Tm), sq)
    )(problem.pose[problem.rel_i], problem.pose[problem.rel_j],
      problem.rel_T, problem.rel_sqrt)
    m_rel = (problem.rel_mask & problem.state_mask[problem.rel_i]
             & problem.state_mask[problem.rel_j])
    r_rel = torch.where(m_rel[:, None], r_rel, torch.zeros_like(r_rel))  # [R,6]
    r_extp = _pose_prior_residuals(
        problem.extrinsics, problem.ext_prior, problem.ext_prior_sqrt,
        problem.ext_prior_mask,
    )  # [NC,6]
    return r_imu, r_pp, r_sbp, r_rel, r_extp


def problem_cost(problem: WindowProblem, cameras, imu_params: ImuParameters,
                 config: SolverConfig = SolverConfig(), group=None) -> torch.Tensor:
    """Total robustified cost 0.5 * sum(rho(|r|^2)) (0-d tensor). With
    ``group``, the observation and landmark-prior parts are summed over its
    ranks (landmark-sharded), the other factors are replicated."""
    r_obs, _ = _reproj_residuals(problem, cameras)
    s = torch.sum(r_obs * r_obs, dim=-1)
    c2 = config.cauchy_scale**2
    cost_obs = 0.5 * torch.sum(c2 * torch.log1p(s / c2))
    r_imu, r_pp, r_sbp, r_rel, r_extp = _other_residuals(problem, imu_params)
    m_lp = problem.lm_prior_mask & problem.lm_mask
    d_lp = (problem.landmarks[:, :3] - problem.lm_prior[:, :3]) \
        * problem.lm_prior_sqrt[:, None]
    cost_lp = 0.5 * torch.sum(torch.where(m_lp[:, None], d_lp * d_lp, torch.zeros_like(d_lp)))
    if group is not None:
        cost_obs, cost_lp = _sum_over(group, cost_obs, cost_lp)
    return (
        cost_obs
        + cost_lp
        + 0.5 * torch.sum(r_imu * r_imu)
        + 0.5 * torch.sum(r_pp * r_pp)
        + 0.5 * torch.sum(r_sbp * r_sbp)
        + 0.5 * torch.sum(r_rel * r_rel)
        + 0.5 * torch.sum(r_extp * r_extp)
    )


# ---------------------------------------------------------------------------
# linearisation
# ---------------------------------------------------------------------------

# max (L*S*NC) entries for which the gather-table linearisation is used;
# beyond this (full-graph packs) the dense path avoids materialising the
# [NC*L*S, 256] gathered payload
TABLE_MAX_ENTRIES = 49152


def _build_obs_table(problem: WindowProblem) -> torch.Tensor:
    """Per-solve flat (camera, landmark, state) -> obs-row index table
    (-1: absent), shape [NC*L*S]. Observation indices never change across
    LM iterations, so this is the solve's only scatter. Each active
    observation occupies exactly one cell by construction."""
    S, L, NC, O = problem.S, problem.L, problem.NC, problem.O
    n = L * S * NC
    key = (problem.obs_cam * L + problem.obs_lm) * S + problem.obs_state
    tgt = torch.where(problem.obs_mask, key, torch.full_like(key, n))  # invalid -> spare cell
    tbl = torch.full((n + 1,), -1, dtype=torch.long, device=key.device)
    tbl[tgt] = torch.arange(O, dtype=torch.long, device=key.device)
    return tbl[:n]


def _build_lm_rows(problem: WindowProblem) -> torch.Tensor:
    """Per-solve layout of the observation rows by landmark for the dense
    path: [L, K] row indices, K the most rows any landmark has, each
    landmark's rows in row order and padded with O (a zero row). Sorting
    is stable and the counts are integer, so the layout is the same on
    every run; the dense path's per-landmark sums then add in the order it
    fixes, with no atomics. One host read (K) per solve."""
    L, O = problem.L, problem.O
    dev = problem.obs_lm.device
    lm = torch.where(problem.obs_mask, problem.obs_lm, torch.full_like(problem.obs_lm, L))
    order = torch.sort(lm, stable=True).indices
    count = torch.bincount(lm, minlength=L + 1)[:L]
    start = torch.cumsum(count, 0) - count
    K = max(int(count.max()), 1)
    k = torch.arange(K, dtype=torch.long, device=dev)
    pos = (start[:, None] + k[None, :]).clamp(max=max(O - 1, 0))
    return torch.where(k[None, :] < count[:, None], order[pos], torch.full_like(pos, O))


def _landmark_terms(rows, Jp, Je, Jl, r0, obs_state, obs_cam, S, NC):
    """The dense path's per-landmark reductions of the reprojection terms
    (``rows`` from ``_build_lm_rows``): Hll [L,3,3] = sum Jl^T Jl, bl [L,3]
    = -sum Jl^T r and W [L,D,3] = sum Jx^T Jl, whose pose rows come from Jp
    at the observation's state and extrinsics rows from Je at its camera
    (speed/bias rows zero). Each observation's products are gathered into
    its landmark's row of ``rows`` and summed along it, so the order of
    every sum is fixed."""
    L, dtype = rows.shape[0], Jl.dtype
    J = torch.cat([Jp, Je, Jl], dim=2)  # [O,2,15]
    Jlr = torch.cat([Jl, r0[:, :, None]], dim=2)  # [O,2,4]
    P = J[:, 0, :, None] * Jlr[:, 0, None, :] + J[:, 1, :, None] * Jlr[:, 1, None, :]
    P = torch.cat([P, torch.zeros((1, 15, 4), dtype=dtype, device=P.device)])  # row O: zero
    G = P[rows]  # [L,K,15,4]
    Hll = G[:, :, 12:15, 0:3].sum(1)
    bl = -G[:, :, 12:15, 3].sum(1)
    pad = torch.zeros(1, dtype=obs_state.dtype, device=obs_state.device)
    oh_s = F.one_hot(torch.cat([obs_state, pad])[rows], S).to(dtype)  # [L,K,S]
    oh_c = F.one_hot(torch.cat([obs_cam, pad])[rows], NC).to(dtype)  # [L,K,NC]
    Wp = torch.einsum("lkjt,lks->lsjt", G[:, :, 0:6, 0:3], oh_s)  # [L,S,6,3]
    We = torch.einsum("lkjt,lkc->lcjt", G[:, :, 6:12, 0:3], oh_c)  # [L,NC,6,3]
    W = torch.cat([Wp.reshape(L, S * 6, 3), torch.zeros((L, S * 9, 3), dtype=dtype,
                                                         device=P.device),
                   We.reshape(L, NC * 6, 3)], dim=1)
    return Hll, bl, W


def _block_diag(blocks: torch.Tensor) -> torch.Tensor:
    """[n,k,k] -> block-diagonal [n*k, n*k]."""
    n, k = blocks.shape[0], blocks.shape[-1]
    eye = torch.eye(n, dtype=blocks.dtype, device=blocks.device)
    return torch.einsum("sjk,sr->sjrk", blocks, eye).reshape(n * k, n * k)


def _scatter_states(J_a, J_b, oh_a, oh_b, width):
    """Place per-factor Jacobian blocks [K,m,width] of two endpoint states
    into [K, m, S*width] via one-hot products."""
    K, m = J_a.shape[0], J_a.shape[1]
    S = oh_a.shape[1]
    return (torch.einsum("kij,ks->kisj", J_a, oh_a)
            + torch.einsum("kij,ks->kisj", J_b, oh_b)).reshape(K, m, S * width)


def _reproj_val_jac(problem: WindowProblem, cameras):
    """Per-observation residual [O,2], validity [O] and Jacobians against
    the pose [O,2,6], extrinsics [O,2,6] and landmark [O,2,3]."""
    dtype, dev = problem.pose.dtype, problem.pose.device
    z6 = torch.zeros(6, dtype=dtype, device=dev)
    z3 = torch.zeros(3, dtype=dtype, device=dev)
    out = None
    for c0, focal, center, k, rows in _camera_passes(problem, cameras):

        def one(f, c, kk, p7, e7, hp, uv, w):
            cam = c0.with_params(f, c, kk)

            def res(dp, de, dl):
                T_WS = _T(_oplus_pose(p7, dp))
                T_SC = _T(_oplus_pose(e7, de))
                T_CW = (T_WS @ T_SC).inverse()
                hp_C = T_CW.apply_homogeneous(_oplus_hp(hp, dl))
                uv_hat, valid = cam.project_homogeneous(hp_C)
                r = torch.where(valid, (uv_hat - uv) * w, torch.zeros_like(uv_hat))
                return r, (r, valid)

            (jp, je, jl), (r, valid) = jacfwd(res, argnums=(0, 1, 2), has_aux=True)(z6, z6, z3)
            return r, valid, jp, je, jl

        out_c = vmap(one)(
            focal, center, k,
            problem.pose[problem.obs_state], problem.extrinsics[problem.obs_cam],
            problem.landmarks[problem.obs_lm], problem.obs_uv, problem.obs_sqrt_info,
        )
        out = out_c if out is None else tuple(
            _select_rows(rows, a, b) for a, b in zip(out_c, out))
    return out


@forward_ad_locked
def _linearize(problem: WindowProblem, cameras, imu_params, config, tbl=None, group=None,
               lm_rows=None):
    """Build the Schur-reducible normal equations at the current estimate.

    Returns (Hxx [D,D], bx [D], Hll [L,3,3], bl [L,3], W_rep, free_x [D]):
      - W_rep = ("blocks", Wp [L,S,6,3], We [L,NC,6,3]) on the TABLE path
        (``tbl`` from ``_build_obs_table``); speed/bias rows are
        structurally zero for vision and never materialised;
      - W_rep = ("dense", W [L,D,3]) on the DENSE path (tbl=None), whose
        per-landmark sums run along ``lm_rows`` (``_build_lm_rows``, built
        here when not given).

    With ``group``, Hxx and bx are summed over its ranks after the
    observation terms, before the replicated factors are added.
    """
    S, L, NC, O = problem.S, problem.L, problem.NC, problem.O
    dtype, dev = problem.pose.dtype, problem.pose.device
    D = S * 6 + S * 9 + NC * 6

    # ---- reprojection terms ------------------------------------------
    r0, valid_c, Jp, Je, Jl = _reproj_val_jac(problem, cameras)
    valid_any = _obs_mask(problem) & valid_c
    fv = valid_any[:, None].to(dtype)
    fvm = valid_any[:, None, None].to(dtype)
    r0 = r0 * fv
    Jp = Jp * fvm
    Je = Je * fvm
    Jl = Jl * fvm

    # Cauchy IRLS weights
    w_rob = cauchy_weight(torch.sum(r0 * r0, dim=-1), config.cauchy_scale)
    w_rob = torch.where(valid_any, w_rob, torch.zeros_like(w_rob))
    r0 = r0 * w_rob[:, None]
    Jp = Jp * w_rob[:, None, None]
    Je = Je * w_rob[:, None, None]
    Jl = Jl * w_rob[:, None, None]

    if tbl is not None:
        # ---- table path (window-scale problems) ----------------------
        # the augmented Jacobian [Jp|Je|Jl|r] gives every normal-equation
        # block and gradient term as entries of ONE per-obs outer product
        J_aug = torch.cat([Jp, Je, Jl, r0[:, :, None]], dim=2)  # [O,2,16]
        A = (
            J_aug[:, 0, :, None] * J_aug[:, 0, None, :]
            + J_aug[:, 1, :, None] * J_aug[:, 1, None, :]
        ).reshape(O, 256)
        tv = (tbl >= 0).to(dtype)  # [NC*L*S]
        G = A[tbl.clamp(min=0)] * tv[:, None]  # [NC*L*S, 256]

        # camera is the outermost key: reductions over leading axes
        B = G.reshape(NC, L, S * 256).sum(1).reshape(NC, S, 16, 16)
        Hpp = B[..., 0:6, 0:6].sum(0)  # [S,6,6]
        Hee = B[..., 6:12, 6:12].sum(1)  # [NC,6,6]
        Hpe = B[..., 0:6, 6:12].transpose(0, 1)  # [S,NC,6,6]
        bxp = -B[..., 0:6, 15].sum(0)  # [S,6]
        bxe = -B[..., 6:12, 15].sum(1)  # [NC,6]

        G_c = G.reshape(NC, L * S, 256).sum(0).reshape(L, S, 16, 16)
        Wp = G_c[..., 0:6, 12:15]  # [L,S,6,3]
        lb = G_c.sum(1)  # [L,16,16]
        Hll = lb[:, 12:15, 12:15]
        bl = -lb[:, 12:15, 15]
        G_s = G.reshape(NC, L, S, 256).sum(2).reshape(NC, L, 16, 16)
        We = G_s[..., 6:12, 12:15].transpose(0, 1)  # [L,NC,6,3]

        pe_flat = Hpe.transpose(1, 2).reshape(S * 6, NC * 6)
        Hxx = torch.zeros((D, D), dtype=dtype, device=dev)
        Hxx[: S * 6, : S * 6] = _block_diag(Hpp)
        Hxx[: S * 6, S * 15:] = pe_flat
        Hxx[S * 15:, : S * 6] = pe_flat.T
        Hxx[S * 15:, S * 15:] = _block_diag(Hee)
        bx = torch.cat([bxp.reshape(-1), torch.zeros(S * 9, dtype=dtype, device=dev),
                        bxe.reshape(-1)])
    else:
        # ---- dense path (full-graph-scale problems) ------------------
        oh_s = F.one_hot(problem.obs_state, S).to(dtype)  # [O,S]
        oh_c = F.one_hot(problem.obs_cam, NC).to(dtype)  # [O,NC]
        Jx_pose = torch.einsum("oij,os->oisj", Jp, oh_s).reshape(O, 2, S * 6)
        Jx_ext = torch.einsum("oij,oc->oicj", Je, oh_c).reshape(O, 2, NC * 6)
        Jx = torch.cat(
            [Jx_pose, torch.zeros((O, 2, S * 9), dtype=dtype, device=dev), Jx_ext], dim=-1
        )  # [O,2,D]
        Hxx = torch.einsum("oid,oie->de", Jx, Jx)
        bx = -torch.einsum("oid,oi->d", Jx, r0)
        if lm_rows is None:
            lm_rows = _build_lm_rows(problem)
        Hll, bl, W = _landmark_terms(lm_rows, Jp, Je, Jl, r0, problem.obs_state,
                                     problem.obs_cam, S, NC)

    if group is not None:
        Hxx, bx = _sum_over(group, Hxx, bx)

    # landmark priors: isotropic diagonal block + rhs
    m_lp = (problem.lm_prior_mask & problem.lm_mask).to(dtype)
    w_lp = (problem.lm_prior_sqrt**2) * m_lp  # [L]
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    Hll = Hll + eye3[None] * w_lp[:, None, None]
    bl = bl - w_lp[:, None] * (problem.landmarks[:, :3] - problem.lm_prior[:, :3])

    # ---- IMU links ----------------------------------------------------
    z6 = torch.zeros(6, dtype=dtype, device=dev)
    z9 = torch.zeros(9, dtype=dtype, device=dev)

    def imu_val_jac(pre_leaves, p0, sb0, p1, sb1):
        pre = Preintegrated(*pre_leaves)

        def f(d0, ds0, d1, ds1):
            r = imu_residual(imu_params, pre, _T(_oplus_pose(p0, d0)), sb0 + ds0,
                             _T(_oplus_pose(p1, d1)), sb1 + ds1)
            return r, r

        j, r = jacfwd(f, argnums=(0, 1, 2, 3), has_aux=True)(z6, z9, z6, z9)
        return r, j

    r_imu, (Ji_p0, Ji_s0, Ji_p1, Ji_s1) = vmap(imu_val_jac)(
        problem.imu_pre.leaves(),
        problem.pose[problem.imu_i], problem.speed_bias[problem.imu_i],
        problem.pose[problem.imu_j], problem.speed_bias[problem.imu_j],
    )
    m_imu = (problem.imu_mask & problem.state_mask[problem.imu_i]
             & problem.state_mask[problem.imu_j])
    r_imu = r_imu * m_imu[:, None].to(dtype)
    fim = m_imu[:, None, None].to(dtype)
    oh0 = F.one_hot(problem.imu_i, S).to(dtype)  # [S-1,S]
    oh1 = F.one_hot(problem.imu_j, S).to(dtype)
    K = r_imu.shape[0]
    Jx_imu = torch.cat(
        [
            _scatter_states(Ji_p0 * fim, Ji_p1 * fim, oh0, oh1, 6),
            _scatter_states(Ji_s0 * fim, Ji_s1 * fim, oh0, oh1, 9),
            torch.zeros((K, 15, NC * 6), dtype=dtype, device=dev),
        ],
        dim=-1,
    )  # [S-1,15,D]
    Hxx = Hxx + torch.einsum("kid,kie->de", Jx_imu, Jx_imu)
    bx = bx - torch.einsum("kid,ki->d", Jx_imu, r_imu)

    # ---- pose priors (block-diagonal, no cross terms) ----------------
    def pp_val_jac(p, prior, sq):
        def f(d):
            r = pose_prior_residual(_T(_oplus_pose(p, d)), _T(prior), sq)
            return r, r

        j, r = jacfwd(f, has_aux=True)(z6)
        return r, j

    r_pp, J_pp = vmap(pp_val_jac)(problem.pose, problem.pose_prior, problem.pose_prior_sqrt)
    m_pp = problem.pose_prior_mask & problem.state_mask
    r_pp = r_pp * m_pp[:, None].to(dtype)
    J_pp = J_pp * m_pp[:, None, None].to(dtype)
    HP = torch.einsum("sij,sik->sjk", J_pp, J_pp)  # [S,6,6]
    bP = -torch.einsum("sij,si->sj", J_pp, r_pp)  # [S,6]

    # ---- speed/bias priors (diagonal whitening) ----------------------
    m_sbp = problem.sb_prior_mask & problem.state_mask
    sqd = problem.sb_prior_sqrt * m_sbp[:, None].to(dtype)  # [S,9]
    r_sbp = sqd * (problem.speed_bias - problem.sb_prior)

    # ---- extrinsics priors (online calibration) -----------------------
    r_ep, J_ep = vmap(pp_val_jac)(problem.extrinsics, problem.ext_prior,
                                  problem.ext_prior_sqrt)
    m_ep = problem.ext_prior_mask
    r_ep = r_ep * m_ep[:, None].to(dtype)
    J_ep = J_ep * m_ep[:, None, None].to(dtype)
    HE = torch.einsum("cij,cik->cjk", J_ep, J_ep)  # [NC,6,6]
    bE = -torch.einsum("cij,ci->cj", J_ep, r_ep)  # [NC,6]

    diag_sb = (sqd * sqd).reshape(-1)  # [S*9]
    H_prior = torch.zeros((D, D), dtype=dtype, device=dev)
    H_prior[: S * 6, : S * 6] = _block_diag(HP)
    H_prior[S * 6: S * 15, S * 6: S * 15] = torch.diag(diag_sb)
    H_prior[S * 15:, S * 15:] = _block_diag(HE)
    Hxx = Hxx + H_prior
    bx = bx + torch.cat([bP.reshape(-1), (-sqd * r_sbp).reshape(-1), bE.reshape(-1)])

    # ---- relative pose factors ---------------------------------------
    R = problem.rel_i.shape[0]

    def rel_val_jac(pi, pj, Tm, sq):
        def f(di, dj):
            r = relative_pose_residual(_T(_oplus_pose(pi, di)), _T(_oplus_pose(pj, dj)),
                                       _T(Tm), sq)
            return r, r

        (ji, jj), r = jacfwd(f, argnums=(0, 1), has_aux=True)(z6, z6)
        return r, ji, jj

    r_rel, Jr_i, Jr_j = vmap(rel_val_jac)(
        problem.pose[problem.rel_i], problem.pose[problem.rel_j],
        problem.rel_T, problem.rel_sqrt,
    )
    m_rel = (problem.rel_mask & problem.state_mask[problem.rel_i]
             & problem.state_mask[problem.rel_j])
    frel = m_rel[:, None, None].to(dtype)
    r_rel = r_rel * m_rel[:, None].to(dtype)
    oh_i = F.one_hot(problem.rel_i, S).to(dtype)
    oh_j = F.one_hot(problem.rel_j, S).to(dtype)
    Jx_rel = torch.cat(
        [
            _scatter_states(Jr_i * frel, Jr_j * frel, oh_i, oh_j, 6),
            torch.zeros((R, 6, S * 9 + NC * 6), dtype=dtype, device=dev),
        ],
        dim=-1,
    )
    Hxx = Hxx + torch.einsum("kid,kie->de", Jx_rel, Jx_rel)
    bx = bx - torch.einsum("kid,ki->d", Jx_rel, r_rel)

    # ---- freeze masks -------------------------------------------------
    free_pose = problem.state_mask & ~problem.pose_frozen
    free_sb = problem.state_mask & ~problem.sb_frozen
    free_ext = ~problem.ext_frozen
    free_x = torch.cat(
        [
            torch.repeat_interleave(free_pose, 6),
            torch.repeat_interleave(free_sb, 9),
            torch.repeat_interleave(free_ext, 6),
        ]
    ).to(dtype)  # [D]
    Hxx = Hxx * free_x[:, None] * free_x[None, :]
    bx = bx * free_x
    if tbl is not None:
        Wp = Wp * free_pose.to(dtype)[None, :, None, None]
        We = We * free_ext.to(dtype)[None, :, None, None]
        W_rep = ("blocks", Wp, We)
    else:
        W_rep = ("dense", W * free_x[None, :, None])

    return Hxx, bx, Hll, bl, W_rep, free_x


def _schur_solve(Hxx, bx, Hll, bl, W_rep, free_x, lm_mask, lam, config, group=None):
    """Damped Schur-complement solve. Returns (dx [D], dl [L,3]).

    ``lam`` is the LM damping (0-d tensor or float). With ``group``, the
    landmark blocks are this rank's and the Schur complement is summed over
    the group's ranks."""
    dtype, dev = Hxx.dtype, Hxx.device
    D = Hxx.shape[0]
    eye3 = torch.eye(3, dtype=dtype, device=dev)

    # damp landmarks (Marquardt scaling + small absolute floor), mask empties
    diag_ll = torch.diagonal(Hll, dim1=-2, dim2=-1)  # [L,3]
    has_obs = torch.sum(diag_ll, dim=-1) > 0.0
    active = lm_mask & has_obs
    damp = lam * diag_ll + config.landmark_damping
    Hll_d = Hll + eye3 * damp[..., None, :]
    Hll_d = torch.where(active[:, None, None], Hll_d, eye3)
    bl_m = torch.where(active[:, None], bl, torch.zeros_like(bl))
    Hll_inv = inv3x3(Hll_d)

    if W_rep[0] == "blocks":
        _, Wp, We = W_rep
        S, NC = Wp.shape[1], We.shape[1]
        WHp = torch.einsum("lsjt,ltu->lsju", Wp, Hll_inv)  # [L,S,6,3]
        WHe = torch.einsum("lcjt,ltu->lcju", We, Hll_inv)  # [L,NC,6,3]
        s_pp = torch.einsum("lsju,lrku->sjrk", WHp, Wp)  # [S,6,S,6]
        s_pe = torch.einsum("lsju,lcku->sjck", WHp, We)  # [S,6,NC,6]
        s_ee = torch.einsum("lcju,ldku->cjdk", WHe, We)  # [NC,6,NC,6]
        sb_p = torch.einsum("lsju,lu->sj", WHp, bl_m)  # [S,6]
        sb_e = torch.einsum("lcju,lu->cj", WHe, bl_m)  # [NC,6]

        pe = s_pe.reshape(S * 6, NC * 6)
        schur_H = torch.zeros((D, D), dtype=dtype, device=dev)
        schur_H[: S * 6, : S * 6] = s_pp.reshape(S * 6, S * 6)
        schur_H[: S * 6, S * 15:] = pe
        schur_H[S * 15:, : S * 6] = pe.T
        schur_H[S * 15:, S * 15:] = s_ee.reshape(NC * 6, NC * 6)
        schur_b = torch.cat([sb_p.reshape(-1), torch.zeros(S * 9, dtype=dtype, device=dev),
                             sb_e.reshape(-1)])
    else:
        _, W = W_rep
        WHinv = torch.einsum("lds,lst->ldt", W, Hll_inv)  # [L,D,3]
        schur_H = torch.einsum("ldt,let->de", WHinv, W)
        schur_b = torch.einsum("ldt,lt->d", WHinv, bl_m)

    if group is not None:
        schur_H, schur_b = _sum_over(group, schur_H, schur_b)
    S_red = Hxx - schur_H
    b_red = bx - schur_b

    # damp states; pin frozen dims
    diag_xx = torch.diagonal(Hxx)
    eyeD = torch.eye(D, dtype=dtype, device=dev)
    S_red = S_red + eyeD * (lam * diag_xx + 1e-12 + 1.0 - free_x)[None, :]

    # Jacobi preconditioning (IMU-bias rows ~1e10 vs vision rows ~1e4)
    d_pre = torch.rsqrt(torch.clamp(torch.diagonal(S_red), min=1e-30))
    S_pre = S_red * d_pre[:, None] * d_pre[None, :]
    dx = d_pre * spd_solve(S_pre, d_pre * b_red)
    dx = dx * free_x

    # back-substitute landmarks
    if W_rep[0] == "blocks":
        _, Wp, We = W_rep
        S, NC = Wp.shape[1], We.shape[1]
        dxp = dx[: S * 6].reshape(S, 6)
        dxe = dx[S * 15:].reshape(NC, 6)
        rhs = (bl_m
               - torch.einsum("lsjt,sj->lt", Wp, dxp)
               - torch.einsum("lcjt,cj->lt", We, dxe))
    else:
        rhs = bl_m - torch.einsum("lds,d->ls", W_rep[1], dx)
    dl = torch.einsum("lst,lt->ls", Hll_inv, rhs)
    dl = torch.where(active[:, None], dl, torch.zeros_like(dl))
    return dx, dl


def _apply_deltas(problem: WindowProblem, dx, dl) -> WindowProblem:
    S, NC = problem.S, problem.NC
    return problem.replace(
        pose=_oplus_pose(problem.pose, dx[: S * 6].reshape(S, 6)),
        speed_bias=problem.speed_bias + dx[S * 6: S * 15].reshape(S, 9),
        extrinsics=_oplus_pose(problem.extrinsics, dx[S * 15:].reshape(NC, 6)),
        landmarks=_oplus_hp(problem.landmarks, dl),
    )


def solve_window(
    problem: WindowProblem,
    cameras,
    imu_params: ImuParameters,
    config: SolverConfig = SolverConfig(),
    group=None,
):
    """LM solve of one window. Returns (problem', stats dict with
    initial_cost, final_cost, lambda (0-d tensors) and iterations (int)).

    The reference's device ``while_loop`` is a host loop here: each
    iteration reads back one small flag vector (accept, negligible
    decrease, small step, lambda below the exit bound), and applies the
    reference's exit rules to it.

    With ``group``, ``problem`` holds this rank's landmark block (local
    landmark indices) and replicas of the rest; every rank of the group
    calls this together. The flag vector is the group's first rank's, and
    the stats add "collectives": the all-reduces and broadcasts this solve
    issued."""
    dtype, dev = problem.pose.dtype, problem.pose.device
    n_coll = _sum_over.calls + _from_first_rank.calls
    cost0 = problem_cost(problem, cameras, imu_params, config, group)
    use_table = problem.L * problem.S * problem.NC <= TABLE_MAX_ENTRIES
    tbl = _build_obs_table(problem) if use_table else None
    lm_rows = None if use_table else _build_lm_rows(problem)

    lam = torch.tensor(config.initial_lambda, dtype=dtype, device=dev)
    cost = cost0
    prob = problem
    it, stall = 0, 0
    lam_ok = config.initial_lambda < 1e7
    while it < config.max_iterations and stall < 2 and lam_ok:
        Hxx, bx, Hll, bl, W_rep, free_x = _linearize(prob, cameras, imu_params, config, tbl,
                                                     group, lm_rows)
        dx, dl = _schur_solve(Hxx, bx, Hll, bl, W_rep, free_x, prob.lm_mask, lam, config, group)
        cand = _apply_deltas(prob, dx, dl)
        new_cost = problem_cost(cand, cameras, imu_params, config, group)
        accept_t = new_cost < cost
        lam = torch.where(accept_t, lam * config.lambda_down, lam * config.lambda_up)
        lam = torch.clamp(lam, 1e-12, 1e8)
        rel_dec = (cost - new_cost) / torch.clamp(cost, min=1e-12)
        step_inf = torch.max(torch.abs(dx))
        flags = torch.stack([
            accept_t, rel_dec < config.min_cost_decrease,
            step_inf < config.step_tolerance, lam < 1e7,
        ])
        if group is not None:
            # the first rank's flags and damping: no rank leaves alone
            agreed = _from_first_rank(group, torch.cat([flags.to(dtype), lam.reshape(1)]))
            flags, lam = agreed[:4] > 0.5, agreed[4]
        accept, small_dec, small_step, lam_ok = flags.tolist()
        # stall: accepted-but-negligible decreases; rejects grow lambda
        if accept:
            stall = stall + 1 if small_dec else 0
            if config.step_tolerance > 0.0 and small_step:
                stall = 2
            prob, cost = cand, new_cost
        it += 1
    stats = {"initial_cost": cost0, "final_cost": cost, "iterations": it, "lambda": lam}
    if group is not None:
        stats["collectives"] = _sum_over.calls + _from_first_rank.calls - n_coll
    return prob, stats
