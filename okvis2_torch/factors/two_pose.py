"""Two-pose marginalisation factor construction.

Port of ``okvis2_tpu/factors/two_pose.py`` (reference:
okvis::ceres::TwoPoseGraphError, okvis_ceres/src/TwoPoseGraphError.cpp:
146-387 compute()). When a keyframe leaves the window, the reprojection
factors between it and its strongest covisible keyframe collapse into one
6-DoF relative-pose factor whose information is the Schur complement of
the landmark blocks, linearised in the reference pose's frame so the
factor can be relocated rigidly.

Per-observation Jacobians come from ``torch.func.jacfwd`` batched with
``vmap``, over fixed-size observation buffers; the landmark Schur
complement uses the batched 3x3 adjugate inverse, and the result is
eigen-clipped to a PSD 6x6 sqrt information. ``torch.linalg.eigh`` may
return other signs and order of eigenvectors than the JAX package's, so
``sqrt_info`` itself may differ; ``sqrt_info.T @ sqrt_info``, which is
all the solve sees, does not.
"""

from __future__ import annotations

import torch
from torch.func import jacfwd, vmap

from okvis2_torch import forward_ad_locked
from okvis2_torch.core import so3
from okvis2_torch.core.se3 import Transformation
from okvis2_torch.factors.reprojection import cauchy_weight
from okvis2_torch.ops.linalg import inv3x3


def _T(p7):
    return Transformation(r=p7[..., :3], q=p7[..., 3:7])


def _oplus_pose(pose7, d):
    r = pose7[..., :3] + d[..., :3]
    dq = so3.delta_q(d[..., 3:6])
    q = so3.quat_normalize(so3.quat_multiply(dq, pose7[..., 3:7]))
    return torch.cat([r, q], dim=-1)


@forward_ad_locked
def compute_two_pose_factor(
    pose_i7: torch.Tensor,  # [7] reference keyframe pose T_WSi
    pose_j7: torch.Tensor,  # [7] marginalised keyframe pose T_WSj
    ext7: torch.Tensor,  # [NC,7] extrinsics
    hp_W: torch.Tensor,  # [Lc,4] landmarks observed by BOTH frames
    obs: torch.Tensor,  # [Oc,6]: (frame 0/1, cam, lm_idx, u, v, sqrt_info)
    obs_mask: torch.Tensor,  # [Oc]
    lm_mask: torch.Tensor,  # [Lc]
    cameras: tuple,
    cauchy_scale: float = 1.0,
):
    """Marginalise the landmarks of a two-frame sub-problem into a 6x6
    sqrt information on the relative pose T_SiSj.

    Returns dict(T_ij [7], sqrt_info [6,6], num_obs, evals [6]); sqrt_info
    is eigen-clipped PSD (rank <= 6: low-parallax directions get small or
    zero information, as the reference's eigendecomposition,
    TwoPoseGraphError.cpp:334-364).

    Runs in float64 whatever the inputs' dtype, and returns float64 (as
    the reference, which computes in double). A landmark seen along one
    ray has a rank-2 block, regularised by 1e-9 I: in exact arithmetic
    its Jacobians have no component along the ray, but in float32 their
    rounding does, the 1e9 of the inverse amplifies it, and the factor's
    information came out wrong by up to 2.4 times its norm in a drive of
    the bench's system at 376x240 (float64 agrees with itself to 1e-13
    under any reduction order)."""
    f64 = torch.float64
    pose_i7, pose_j7, ext7, hp_W, obs = (
        x.to(f64) for x in (pose_i7, pose_j7, ext7, hp_W, obs))
    cameras = tuple(c.to(dtype=f64) for c in cameras)
    dtype, dev = f64, pose_i7.device
    Lc = hp_W.shape[0]
    T_iW = _T(pose_i7).inverse()
    # landmarks in frame i (the factor's anchor frame)
    hp_i = T_iW.apply_homogeneous(hp_W)
    T_ij = T_iW @ _T(pose_j7)
    T_ij0 = torch.cat([T_ij.r, T_ij.q])

    z6 = torch.zeros(6, dtype=dtype, device=dev)
    z3 = torch.zeros(3, dtype=dtype, device=dev)
    frame_sel = obs[:, 0].to(torch.long)  # 0 = frame i, 1 = frame j
    cam_sel = obs[:, 1].to(torch.long)
    lm_sel = obs[:, 2].to(torch.long)
    uv = obs[:, 3:5]
    w_obs = obs[:, 5]

    O = obs.shape[0]
    Jr = torch.zeros((O, 2, 6), dtype=dtype, device=dev)
    Jl = torch.zeros((O, 2, 3), dtype=dtype, device=dev)
    r0 = torch.zeros((O, 2), dtype=dtype, device=dev)
    valid = torch.zeros((O,), dtype=torch.bool, device=dev)

    for ci, cam in enumerate(cameras):
        T_ic = _T(ext7[ci])

        def val_jac(fsel, hp_il, uvm, wm, cam=cam, T_ic=T_ic):
            def res(d_ij, d_l):
                # the observing camera in frame i: at the extrinsics for
                # frame-i observations, at T_ij (perturbed) * extrinsics
                # for frame-j ones
                T_cam_j = _T(_oplus_pose(T_ij0, d_ij)) @ T_ic
                r_sel = torch.where(fsel == 0, T_ic.r, T_cam_j.r)
                q_sel = torch.where(fsel == 0, T_ic.q, T_cam_j.q)
                hp = torch.cat([hp_il[:3] + d_l, hp_il[3:4]])
                hp_C = Transformation(r=r_sel, q=q_sel).inverse().apply_homogeneous(hp)
                uv_hat, ok = cam.project_homogeneous(hp_C)
                rr = torch.where(ok, (uv_hat - uvm) * wm, torch.zeros_like(uv_hat))
                return rr, (rr, ok)

            (jij, jl), (rr, ok) = jacfwd(res, argnums=(0, 1), has_aux=True)(z6, z3)
            return rr, ok, jij, jl

        r_c, ok_c, jij_c, jl_c = vmap(val_jac)(frame_sel, hp_i[lm_sel], uv, w_obs)
        sel = obs_mask & (cam_sel == ci) & ok_c & lm_mask[lm_sel]
        f1 = sel[:, None].to(dtype)
        f2 = sel[:, None, None].to(dtype)
        r0 = r0 + r_c * f1
        Jr = Jr + jij_c * f2
        Jl = Jl + jl_c * f2
        valid = valid | sel

    # robust (Cauchy) reweighting as in the reference's Triggs correction
    w_rob = cauchy_weight(torch.sum(r0 * r0, dim=-1), cauchy_scale)
    w_rob = torch.where(valid, w_rob, torch.zeros_like(w_rob))
    r0 = r0 * w_rob[:, None]
    Jr = Jr * w_rob[:, None, None]
    Jl = Jl * w_rob[:, None, None]

    # normal equation blocks
    Hrr = torch.einsum("oid,oie->de", Jr, Jr)  # [6,6]
    Hll = torch.zeros((Lc, 3, 3), dtype=dtype, device=dev).index_add_(
        0, lm_sel, torch.einsum("oid,oie->ode", Jl, Jl))
    W = torch.zeros((Lc, 6, 3), dtype=dtype, device=dev).index_add_(
        0, lm_sel, torch.einsum("oid,oie->ode", Jr, Jl))

    eye3 = torch.eye(3, dtype=dtype, device=dev)
    diag_ll = torch.diagonal(Hll, dim1=-2, dim2=-1)
    active = lm_mask & (torch.sum(diag_ll, dim=-1) > 0)
    Hll_d = torch.where(active[:, None, None], Hll + eye3 * 1e-9, eye3)
    Hll_inv = inv3x3(Hll_d)
    H_marg = Hrr - torch.einsum("lds,lst,let->de", W, Hll_inv, W)
    H_marg = 0.5 * (H_marg + H_marg.T)

    # eigen clip -> PSD sqrt information (the reference's
    # SelfAdjointEigenSolver, the same way)
    evals, evecs = torch.linalg.eigh(H_marg)
    evals = torch.where(evals > 1e-8, evals, torch.zeros_like(evals))
    sqrt_info = torch.diag(torch.sqrt(evals)) @ evecs.T
    return {"T_ij": T_ij0, "sqrt_info": sqrt_info, "num_obs": torch.sum(valid), "evals": evals}
