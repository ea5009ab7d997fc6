"""IMU preintegration on torch tensors.

Port of the parts of ``okvis2_tpu/imu/preintegration.py`` that the window
solver and ``utils.synthetic.build_problem`` need: ``ImuParameters``,
``Preintegrated``, ``preintegrate`` (the reference's ``lax.scan`` becomes a
loop over the samples, batched over any leading segment axes),
``correct_for_bias``, the host mirrors ``preintegrate_np`` and
``propagate_state_np`` (numpy, with the reference's operation order), and
``init_pose_from_accel`` (the estimator's gravity-aligned first pose).

Error-state order [dp, dalpha, dv, dbg, dba]; rotation error is a left
perturbation on the preintegrated rotation. Bias Jacobians are stored for
first-order correction at evaluation time.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from okvis2_torch import resolve_device
from okvis2_torch.core import se3_np, so3
from okvis2_torch.core.se3 import Transformation
from okvis2_torch.ops.linalg import spd_inverse_sqrt


@dataclasses.dataclass(frozen=True)
class ImuParameters:
    """Continuous-time noise densities and gravity magnitude."""

    sigma_g_c: torch.Tensor  # gyro noise density [rad/s/sqrt(Hz)]
    sigma_a_c: torch.Tensor  # accel noise density [m/s^2/sqrt(Hz)]
    sigma_gw_c: torch.Tensor  # gyro bias random walk
    sigma_aw_c: torch.Tensor  # accel bias random walk
    g: torch.Tensor  # gravity magnitude

    @classmethod
    def create(cls, sigma_g_c=12.0e-4, sigma_a_c=8.0e-3, sigma_gw_c=4.0e-6,
               sigma_aw_c=4.0e-5, g=9.81007, dtype=torch.float64, device=None):
        device = resolve_device(device)
        a = lambda v: torch.tensor(v, dtype=dtype, device=device)
        return cls(a(sigma_g_c), a(sigma_a_c), a(sigma_gw_c), a(sigma_aw_c), a(g))

    @property
    def gravity_w(self) -> torch.Tensor:
        """Gravity acceleration in the world frame (z up): [0, 0, -g]."""
        z = torch.zeros_like(self.g)
        return torch.stack([z, z, -self.g])

    def to(self, device=None, dtype=None) -> "ImuParameters":
        return ImuParameters(*(
            getattr(self, f.name).to(device=device, dtype=dtype)
            for f in dataclasses.fields(self)
        ))


@dataclasses.dataclass(frozen=True)
class Preintegrated:
    """One preintegrated IMU segment (or a batch of them along leading
    axes), expressed in the segment's start frame S0."""

    delta_q: torch.Tensor  # [4] rotation S0 <- S1 (xyzw)
    c_int: torch.Tensor  # [3,3] integral of C_0t dt       (= -d v / d ba)
    c_dint: torch.Tensor  # [3,3] double integral           (= -d p / d ba)
    acc_int: torch.Tensor  # [3]  integral of C_0t a dt     (velocity delta)
    acc_dint: torch.Tensor  # [3] double integral           (position delta)
    d_alpha_dbg: torch.Tensor  # [3,3] rotation-error / gyro-bias Jacobian
    d_v_dbg: torch.Tensor  # [3,3]
    d_p_dbg: torch.Tensor  # [3,3]
    covariance: torch.Tensor  # [15,15] error-state covariance
    sqrt_info: torch.Tensor  # [15,15] whitening (inverse of chol(cov))
    dt_total: torch.Tensor  # []
    bg_lin: torch.Tensor  # [3] gyro bias linearisation point
    ba_lin: torch.Tensor  # [3] accel bias linearisation point

    def leaves(self) -> tuple:
        return tuple(getattr(self, f.name) for f in dataclasses.fields(self))

    def map(self, fn) -> "Preintegrated":
        return Preintegrated(*(fn(x) for x in self.leaves()))


def _mv(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Batched matrix [...,n,m] times vector [...,m]."""
    return torch.matmul(M, v[..., None])[..., 0]


def preintegrate(
    params: ImuParameters,
    gyro: torch.Tensor,  # [..., N, 3] averaged-interval gyro measurements
    accel: torch.Tensor,  # [..., N, 3]
    dt: torch.Tensor,  # [..., N] interval lengths (0 => masked out)
    bg: torch.Tensor,  # [..., 3] gyro bias linearisation point
    ba: torch.Tensor,  # [..., 3] accel bias linearisation point
) -> Preintegrated:
    """Preintegrate IMU segment(s) with midpoint integration.

    Leading axes are independent segments of equal length N; the loop
    over the N samples carries the same state as the reference's scan."""
    dtype, dev = gyro.dtype, gyro.device
    batch = tuple(dt.shape[:-1])
    N = dt.shape[-1]
    eye3 = torch.eye(3, dtype=dtype, device=dev).expand(batch + (3, 3))

    q = so3.identity_quat(batch, dtype=dtype, device=dev)
    zero3 = torch.zeros(batch + (3,), dtype=dtype, device=dev)
    zero33 = torch.zeros(batch + (3, 3), dtype=dtype, device=dev)
    c_int, c_dint, acc_int, acc_dint = zero33, zero33, zero3, zero3
    d_a_bg, d_v_bg, d_p_bg = zero33, zero33, zero33
    P = torch.zeros(batch + (15, 15), dtype=dtype, device=dev)
    s_g2 = params.sigma_g_c**2
    s_a2 = params.sigma_a_c**2
    s_gw2 = params.sigma_gw_c**2
    s_aw2 = params.sigma_aw_c**2

    for n in range(N):
        w_m, a_m, h = gyro[..., n, :], accel[..., n, :], dt[..., n]
        h1 = h[..., None]
        h2 = h[..., None, None]
        w = w_m - bg
        a = a_m - ba

        dq = so3.delta_q(w * h1)
        q1 = so3.quat_normalize(so3.quat_multiply(q, dq))
        C = so3.quat_to_matrix(q)
        C1 = so3.quat_to_matrix(q1)
        Ca = _mv(C, a)
        C1a = _mv(C1, a)
        half_sum_C = 0.5 * (C + C1)

        acc_int1 = acc_int + 0.5 * (Ca + C1a) * h1
        acc_dint1 = acc_dint + acc_int * h1 + 0.25 * (Ca + C1a) * h1 * h1
        c_int1 = c_int + half_sum_C * h2
        c_dint1 = c_dint + c_int * h2 + 0.5 * half_sum_C * h2 * h2

        # bias Jacobians (left rotation-error convention)
        Jr = so3.right_jacobian(w * h1)
        C1Jr = C1 @ Jr
        d_a_bg1 = d_a_bg - C1Jr * h2
        cross_k = -so3.cross_mx(Ca) @ d_a_bg
        cross_k1 = -so3.cross_mx(C1a) @ d_a_bg1
        d_v_bg1 = d_v_bg + 0.5 * h2 * (cross_k + cross_k1)
        d_p_bg1 = d_p_bg + h2 * d_v_bg + (0.25 * h * h)[..., None, None] * (cross_k + cross_k1)

        # discrete error-state transition F (order [dp, da, dv, dbg, dba])
        F_va = -0.5 * h2 * (so3.cross_mx(Ca) + so3.cross_mx(C1a))
        F_v_bg = (0.25 * h * h)[..., None, None] * (so3.cross_mx(C1a) @ C1Jr)
        F_v_ba = -half_sum_C * h2
        F_a_bg = -C1Jr * h2

        F = torch.zeros(batch + (15, 15), dtype=dtype, device=dev)
        F[..., 0:3, 0:3] = eye3
        F[..., 0:3, 3:6] = 0.5 * h2 * F_va
        F[..., 0:3, 6:9] = eye3 * h2
        F[..., 0:3, 9:12] = 0.5 * h2 * F_v_bg
        F[..., 0:3, 12:15] = 0.5 * h2 * F_v_ba
        F[..., 3:6, 3:6] = eye3
        F[..., 3:6, 9:12] = F_a_bg
        F[..., 6:9, 3:6] = F_va
        F[..., 6:9, 6:9] = eye3
        F[..., 6:9, 9:12] = F_v_bg
        F[..., 6:9, 12:15] = F_v_ba
        F[..., 9:12, 9:12] = eye3
        F[..., 12:15, 12:15] = eye3

        P1 = F @ P @ F.transpose(-1, -2)
        # additive discrete noise (diagonal approximation)
        s2_a = s_g2 * h
        s2_v = s_a2 * h
        diag = torch.stack(
            [0.25 * h * h * s2_v] * 3 + [s2_a] * 3 + [s2_v] * 3
            + [s_gw2 * h] * 3 + [s_aw2 * h] * 3,
            dim=-1,
        )
        P = P1 + torch.diag_embed(diag)

        q, c_int, c_dint, acc_int, acc_dint = q1, c_int1, c_dint1, acc_int1, acc_dint1
        d_a_bg, d_v_bg, d_p_bg = d_a_bg1, d_v_bg1, d_p_bg1

    P = 0.5 * (P + P.transpose(-1, -2))
    # covariance floor (zero-length segments stay invertible; near-noiseless
    # segments keep a float32-safe whitened scale)
    floor = torch.tensor(
        [1e-8] * 3 + [1e-10] * 3 + [1e-8] * 3 + [1e-12] * 6, dtype=dtype, device=dev
    )
    P = P + torch.diag(floor)
    sqrt_info = spd_inverse_sqrt(P)

    return Preintegrated(
        delta_q=q,
        c_int=c_int,
        c_dint=c_dint,
        acc_int=acc_int,
        acc_dint=acc_dint,
        d_alpha_dbg=d_a_bg,
        d_v_dbg=d_v_bg,
        d_p_dbg=d_p_bg,
        covariance=P,
        sqrt_info=sqrt_info,
        dt_total=torch.sum(dt, dim=-1),
        bg_lin=bg,
        ba_lin=ba,
    )


def correct_for_bias(pre: Preintegrated, bg: torch.Tensor, ba: torch.Tensor):
    """First-order bias-corrected (delta_q, delta_v, delta_p) in S0 frame."""
    dbg = bg - pre.bg_lin
    dba = ba - pre.ba_lin
    dq_corr = so3.quat_multiply(so3.delta_q(_mv(pre.d_alpha_dbg, dbg)), pre.delta_q)
    dv = pre.acc_int + _mv(pre.d_v_dbg, dbg) - _mv(pre.c_int, dba)
    dp = pre.acc_dint + _mv(pre.d_p_dbg, dbg) - _mv(pre.c_dint, dba)
    return dq_corr, dv, dp


def propagate_state_np(g, T_WS7, speed_and_bias, gyro, accel, dt):
    """Pure-numpy dead-reckoning for the per-frame pose prediction, in the
    reference's operation order (``propagate_state_np``; reference role:
    ThreadedSlam's propagation for detection, ThreadedSlam.cpp:397-409).

    g: scalar gravity magnitude; T_WS7 numpy [7]; speed_and_bias [9];
    gyro/accel [N,3]; dt [N]. Returns (T_WS7', speed_and_bias')."""
    r = T_WS7[:3].astype(np.float64).copy()
    q = T_WS7[3:7].astype(np.float64).copy()
    v = speed_and_bias[:3].astype(np.float64).copy()
    bg = speed_and_bias[3:6]
    ba = speed_and_bias[6:9]
    g_W = np.array([0.0, 0.0, -float(g)])
    for k in range(len(dt)):
        h = float(dt[k])
        if h <= 0.0:
            continue
        w = gyro[k] - bg
        a = accel[k] - ba
        half = 0.5 * w * h
        ang = np.linalg.norm(half)
        dq = np.concatenate([
            half * (np.sinc(ang / np.pi)), [np.cos(ang)]
        ])
        q1 = se3_np.quat_mul(q, dq)
        C = se3_np.quat_to_mat(q)
        C1 = se3_np.quat_to_mat(q1)
        acc_w = 0.5 * (C @ a + C1 @ a)
        r = r + v * h + 0.5 * g_W * h * h + 0.5 * acc_w * h * h
        v = v + g_W * h + acc_w * h
        q = q1
    sb1 = np.concatenate([v, bg, ba])
    return np.concatenate([r, q]), sb1


def preintegrate_np(params, gyro, accel, dt, bg, ba):
    """Pure-numpy mirror of ``preintegrate`` for host packing (one short
    segment per frame). Same math, same floor, the reference's operation
    order (vectorised precompute, exclusive-prefix cumsums, sequential
    quaternion chain and covariance loop). Whitening uses the symmetric
    eigh-based inverse square root: another factor than ``preintegrate``'s,
    the same quadratic form. Returns a Preintegrated with numpy leaves."""
    gyro = np.asarray(gyro, np.float64)
    accel = np.asarray(accel, np.float64)
    dt = np.asarray(dt, np.float64)
    bg = np.asarray(bg, np.float64)
    ba = np.asarray(ba, np.float64)

    dt_total = np.sum(dt)
    keep = dt > 0.0
    if not np.all(keep):
        gyro, accel, dt = gyro[keep], accel[keep], dt[keep]
    N = len(dt)

    eye3 = np.eye(3)
    s_g = float(params.sigma_g_c)
    s_a = float(params.sigma_a_c)
    s_gw = float(params.sigma_gw_c)
    s_aw = float(params.sigma_aw_c)
    noise_base = np.concatenate([
        np.full(3, s_a * s_a),  # x0.25*h*h per step (position channel)
        np.full(3, s_g * s_g),
        np.full(3, s_a * s_a),
        np.full(3, s_gw * s_gw),
        np.full(3, s_aw * s_aw),
    ])

    if N == 0:
        q = np.array([0.0, 0, 0, 1.0])
        c_int = np.zeros((3, 3)); c_dint = np.zeros((3, 3))
        acc_int = np.zeros(3); acc_dint = np.zeros(3)
        d_a_bg = np.zeros((3, 3)); d_v_bg = np.zeros((3, 3))
        d_p_bg = np.zeros((3, 3))
        P = np.zeros((15, 15))
    else:
        h = dt
        w_all = gyro - bg[None, :]
        a_all = accel - ba[None, :]
        half = 0.5 * w_all * h[:, None]
        ang = np.sqrt(np.sum(half * half, axis=1))
        dqs = np.empty((N, 4))
        dqs[:, :3] = half * np.sinc(ang / np.pi)[:, None]
        dqs[:, 3] = np.cos(ang)

        # quaternion chain: scalar arithmetic in quat_mul's operation order
        qs = np.empty((N + 1, 4))
        qs[0] = (0.0, 0.0, 0.0, 1.0)
        x1 = y1 = z1 = 0.0
        w1 = 1.0
        for k in range(N):
            x2, y2, z2, w2 = dqs[k]
            vx = w1 * x2 + w2 * x1 + (y1 * z2 - z1 * y2)
            vy = w1 * y2 + w2 * y1 + (z1 * x2 - x1 * z2)
            vz = w1 * z2 + w2 * z1 + (x1 * y2 - y1 * x2)
            vw = w1 * w2 - (x1 * x2 + y1 * y2 + z1 * z2)
            nrm = math.sqrt(vx * vx + vy * vy + vz * vz + vw * vw)
            x1, y1, z1, w1 = vx / nrm, vy / nrm, vz / nrm, vw / nrm
            qs[k + 1] = (x1, y1, z1, w1)
        q = qs[-1]

        x, y, z, w = qs[:, 0], qs[:, 1], qs[:, 2], qs[:, 3]
        C_all = np.empty((N + 1, 3, 3))
        C_all[:, 0, 0] = 1 - 2 * (y * y + z * z)
        C_all[:, 0, 1] = 2 * (x * y - z * w)
        C_all[:, 0, 2] = 2 * (x * z + y * w)
        C_all[:, 1, 0] = 2 * (x * y + z * w)
        C_all[:, 1, 1] = 1 - 2 * (x * x + z * z)
        C_all[:, 1, 2] = 2 * (y * z - x * w)
        C_all[:, 2, 0] = 2 * (x * z - y * w)
        C_all[:, 2, 1] = 2 * (y * z + x * w)
        C_all[:, 2, 2] = 1 - 2 * (x * x + y * y)
        C0, C1 = C_all[:-1], C_all[1:]

        def cross_b(v):  # [N,3] -> [N,3,3]
            K = np.zeros((len(v), 3, 3))
            K[:, 0, 1] = -v[:, 2]; K[:, 0, 2] = v[:, 1]
            K[:, 1, 0] = v[:, 2]; K[:, 1, 2] = -v[:, 0]
            K[:, 2, 0] = -v[:, 1]; K[:, 2, 1] = v[:, 0]
            return K

        Ca = np.einsum("nij,nj->ni", C0, a_all)
        C1a = np.einsum("nij,nj->ni", C1, a_all)
        CaC1a = Ca + C1a
        half_sum_C = 0.5 * (C0 + C1)

        def excl(inc):
            """Exclusive prefix sums of per-step increments (value ENTERING
            step k); cumsum accumulates sequentially."""
            c = np.cumsum(inc, axis=0)
            out = np.empty_like(c)
            out[0] = 0.0
            out[1:] = c[:-1]
            return out, c[-1]

        inc_ai = (0.5 * h)[:, None] * CaC1a
        ai_pre, acc_int = excl(inc_ai)
        _, acc_dint = excl(ai_pre * h[:, None]
                           + (0.25 * h * h)[:, None] * CaC1a)
        inc_ci = half_sum_C * h[:, None, None]
        ci_pre, c_int = excl(inc_ci)
        _, c_dint = excl(ci_pre * h[:, None, None]
                         + (0.5 * h * h)[:, None, None] * half_sum_C)

        phi = w_all * h[:, None]
        ang2 = 2.0 * ang
        K = cross_b(phi)
        KK = np.einsum("nij,njk->nik", K, K)
        small = ang2 < 1e-8
        angs = np.where(small, 1.0, ang2)
        c1 = np.where(small, 0.5, (1.0 - np.cos(angs)) / (angs * angs))
        c2 = np.where(small, 0.0,
                      (angs - np.sin(angs)) / (angs * angs * angs))
        Jr = (eye3[None] - c1[:, None, None] * K
              + c2[:, None, None] * KK)

        C1Jr = np.einsum("nij,njk->nik", C1, Jr)
        dabg_pre, d_a_bg = excl(-C1Jr * h[:, None, None])
        dabg_post = dabg_pre - C1Jr * h[:, None, None]
        crossCa = cross_b(Ca)
        crossC1a = cross_b(C1a)
        ck_sum = (-np.einsum("nij,njk->nik", crossCa, dabg_pre)
                  - np.einsum("nij,njk->nik", crossC1a, dabg_post))
        inc_dv = (0.5 * h)[:, None, None] * ck_sum
        dvbg_pre, d_v_bg = excl(inc_dv)
        _, d_p_bg = excl(h[:, None, None] * dvbg_pre
                         + (0.25 * h * h)[:, None, None] * ck_sum)

        F_va = -0.5 * h[:, None, None] * (crossCa + crossC1a)
        F_v_bg = (0.25 * h * h)[:, None, None] * np.einsum(
            "nij,njk->nik", crossC1a, C1Jr
        )
        F_v_ba = -half_sum_C * h[:, None, None]
        F_a_bg = -C1Jr * h[:, None, None]
        F_all = np.zeros((N, 15, 15))
        for d in range(0, 15, 3):
            F_all[:, d:d + 3, d:d + 3] = eye3
        F_all[:, 0:3, 3:6] = 0.5 * h[:, None, None] * F_va
        F_all[:, 0:3, 6:9] = eye3[None] * h[:, None, None]
        F_all[:, 0:3, 9:12] = 0.5 * h[:, None, None] * F_v_bg
        F_all[:, 0:3, 12:15] = 0.5 * h[:, None, None] * F_v_ba
        F_all[:, 3:6, 9:12] = F_a_bg
        F_all[:, 6:9, 3:6] = F_va
        F_all[:, 6:9, 9:12] = F_v_bg
        F_all[:, 6:9, 12:15] = F_v_ba
        noise_all = noise_base[None, :] * h[:, None]
        noise_all[:, 0:3] *= (0.25 * h * h)[:, None]
        P = np.zeros((15, 15))
        for k in range(N):
            Fk = F_all[k]
            P = Fk @ P @ Fk.T
            P.flat[::16] += noise_all[k]
        d_a_bg = dabg_post[-1]

    P = 0.5 * (P + P.T)
    P += np.diag(np.concatenate([
        np.full(3, 1e-8), np.full(3, 1e-10), np.full(3, 1e-8),
        np.full(6, 1e-12),
    ]))
    wvals, U = np.linalg.eigh(P)
    sqrt_info = (U * (1.0 / np.sqrt(np.maximum(wvals, 1e-30)))) @ U.T

    return Preintegrated(
        delta_q=q,
        c_int=c_int,
        c_dint=c_dint,
        acc_int=acc_int,
        acc_dint=acc_dint,
        d_alpha_dbg=d_a_bg,
        d_v_dbg=d_v_bg,
        d_p_dbg=d_p_bg,
        covariance=P,
        sqrt_info=sqrt_info,
        dt_total=dt_total,
        bg_lin=bg,
        ba_lin=ba,
    )


def init_pose_from_accel(accel_mean: torch.Tensor) -> Transformation:
    """Gravity-aligned initial pose (reference ImuError::initPose,
    ImuError.cpp:781-809): the q_WS that maps the measured specific force
    (about +g, up, in the sensor frame) to world +z; yaw is 0."""
    a = accel_mean / torch.linalg.norm(accel_mean)
    z_w = torch.tensor([0.0, 0.0, 1.0], dtype=a.dtype, device=a.device)
    # rotation taking sensor-frame 'up' (a) to world z
    v = torch.linalg.cross(a, z_w, dim=-1)
    c = torch.dot(a, z_w)
    s = torch.linalg.norm(v)
    safe_s = torch.where(s > 1e-9, s, torch.ones_like(s))
    angle = torch.atan2(s, c)
    axis = torch.where(s > 1e-9, v / safe_s,
                       torch.tensor([1.0, 0.0, 0.0], dtype=a.dtype, device=a.device))
    q_WS = so3.delta_q(axis * angle)
    return Transformation(r=torch.zeros(3, dtype=a.dtype, device=a.device), q=q_WS)
