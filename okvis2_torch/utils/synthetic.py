"""Synthetic VIO scene generation for tests, the chip smoke run and
benchmarks.

Port of ``okvis2_tpu/utils/synthetic.py``: an analytic trajectory, a wall
of landmarks, exact IMU measurements and exact (optionally noisy) keypoint
observations, packed into a ``WindowProblem``. Velocities, angular rates
and accelerations are derivatives of the analytic trajectory, taken with
``torch.func`` where the reference uses ``jax.jacfwd``/``jax.grad``.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.func import grad, jacfwd, vmap

from okvis2_torch import forward_ad_locked, resolve_device
from okvis2_torch.cameras.pinhole import PinholeCamera
from okvis2_torch.core import so3
from okvis2_torch.core.se3 import Transformation
from okvis2_torch.imu.preintegration import ImuParameters, preintegrate
from okvis2_torch.solver.gauss_newton import _oplus_hp, _oplus_pose
from okvis2_torch.solver.window_problem import WindowProblem

AXIS = np.array([0.3, 1.0, 0.1])
AXIS /= np.linalg.norm(AXIS)


def traj_theta(t):
    return 0.2 * torch.sin(1.1 * t)


def traj_pos(t):
    return torch.stack(
        [0.5 * t, 0.3 * torch.sin(0.8 * t), 0.1 * torch.cos(1.3 * t)]
    )


def _axis(t: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(AXIS, dtype=t.dtype, device=t.device)


@forward_ad_locked
def true_state(t, device=None):
    """Ground-truth (T_WS, v_W) at time t for the canonical test trajectory."""
    t = torch.as_tensor(t, dtype=torch.float64, device=resolve_device(device))
    q = so3.delta_q(_axis(t) * traj_theta(t))
    return Transformation(r=traj_pos(t), q=q), jacfwd(traj_pos)(t)


@forward_ad_locked
def imu_at(t: torch.Tensor, params: ImuParameters):
    """Exact (gyro, accel) in the sensor frame at time t (0-d tensor)."""
    u = _axis(t)
    w_S = u * grad(traj_theta)(t)
    a_W = jacfwd(jacfwd(traj_pos))(t)
    C_WS = so3.quat_to_matrix(so3.delta_q(u * traj_theta(t)))
    a_S = C_WS.T @ (a_W - params.gravity_w)
    return w_S, a_S


def imu_segment(t0, t1, n, params: ImuParameters):
    """Trapezoid-averaged (gyro [n,3], accel [n,3], dt [n]) over [t0, t1]."""
    dev = params.g.device
    ts = np.linspace(t0, t1, n + 1)
    w, a = vmap(lambda t: imu_at(t, params))(
        torch.as_tensor(ts, dtype=torch.float64, device=dev)
    )
    return (
        0.5 * (w[:-1] + w[1:]),
        0.5 * (a[:-1] + a[1:]),
        torch.as_tensor(np.diff(ts), dtype=torch.float64, device=dev),
    )


class CircleTrajectory:
    """Closed circuit at constant height (``period`` s, ``radius`` m),
    yawing gently to keep the star field in view; the same
    ``true_state`` / ``imu_at`` API as this module's trajectory."""

    def __init__(self, period: float = 10.0, radius: float = 1.5):
        self.w = 2.0 * np.pi / period
        self.radius = radius

    def _pos(self, t):
        a = self.w * t
        return torch.stack([self.radius * torch.sin(a), self.radius * (1.0 - torch.cos(a)),
                            0.05 * torch.sin(2.0 * a)])

    def _theta(self, t):
        return 0.15 * torch.sin(self.w * t)

    @forward_ad_locked
    def true_state(self, t, device=None):
        t = torch.as_tensor(t, dtype=torch.float64, device=resolve_device(device))
        u = torch.tensor([0.0, 1.0, 0.0], dtype=t.dtype, device=t.device)
        return Transformation(r=self._pos(t), q=so3.delta_q(u * self._theta(t))), \
            jacfwd(self._pos)(t)

    @forward_ad_locked
    def imu_at(self, t: torch.Tensor, params: ImuParameters):
        u = torch.tensor([0.0, 1.0, 0.0], dtype=t.dtype, device=t.device)
        w_S = u * grad(self._theta)(t)
        a_W = jacfwd(jacfwd(self._pos))(t)
        C_WS = so3.quat_to_matrix(so3.delta_q(u * self._theta(t)))
        return w_S, C_WS.T @ (a_W - params.gravity_w)


def stereo_rig(baseline=0.11, distortion_cls=None, device=None):
    dev = resolve_device(device)
    cam = PinholeCamera.create_test_object(distortion_cls, device=dev)
    T_SC0 = Transformation.identity(device=dev)
    # cameras look along +z of the body, stereo offset along x
    T_SC1 = Transformation(
        r=torch.tensor([baseline, 0.0, 0.0], dtype=torch.float64, device=dev),
        q=so3.identity_quat(device=dev),
    )
    return (cam, cam), (T_SC0, T_SC1)


def landmark_wall(n_side=8, z=6.0, extent=8.0, seed=0, device=None):
    """Grid of landmarks on a wall in front of the trajectory (world z)."""
    rng = np.random.default_rng(seed)
    xs = np.linspace(-extent / 2, extent / 2, n_side)
    ys = np.linspace(-extent / 2, extent / 2, n_side)
    X, Y = np.meshgrid(xs, ys)
    pts = np.stack(
        [X.ravel() + 2.0, Y.ravel(), np.full(X.size, z) + rng.uniform(-1, 1, X.size)],
        axis=-1,
    )
    hp = np.concatenate([pts, np.ones((len(pts), 1))], axis=-1)
    return torch.as_tensor(hp, device=resolve_device(device))


def build_problem(
    num_states=5,
    frame_dt=0.3,
    n_landmarks_side=8,
    imu_rate=200,
    imu_params=None,
    obs_noise=0.0,
    seed=0,
    device=None,
):
    """Build a fully-populated float64 WindowProblem at ground truth on
    ``device`` (``None``: the CUDA card).

    Returns (problem, cameras, imu_params, ground_truth dict).
    """
    dev = resolve_device(device)
    if imu_params is None:
        imu_params = ImuParameters.create(g=9.81, device=dev)
    cams, exts = stereo_rig(device=dev)
    hp_W = landmark_wall(n_landmarks_side, device=dev)
    L = hp_W.shape[0]
    S = num_states
    ts = [i * frame_dt for i in range(S)]

    poses, sbs = [], []
    zeros6 = torch.zeros(6, dtype=torch.float64, device=dev)
    for t in ts:
        T, v = true_state(t, device=dev)
        poses.append(torch.cat([T.r, T.q]))
        sbs.append(torch.cat([v, zeros6]))
    poses = torch.stack(poses)
    sbs = torch.stack(sbs)

    # IMU links: all S-1 segments preintegrated as one batch
    n_per = int(imu_rate * frame_dt)
    segs = [imu_segment(ts[i], ts[i + 1], n_per, imu_params) for i in range(S - 1)]
    w, a, dt = (torch.stack(x) for x in zip(*segs))
    z3 = torch.zeros((S - 1, 3), dtype=torch.float64, device=dev)
    pre = preintegrate(imu_params, w, a, dt, z3, z3)

    # observations: project all landmarks into all frames/cameras, in the
    # reference's (state, camera, landmark) order
    rng = np.random.default_rng(seed)
    obs_state, obs_cam, obs_lm, obs_uv = [], [], [], []
    for si in range(S):
        T_WS = Transformation(r=poses[si, :3], q=poses[si, 3:7])
        for ci, (cam, T_SC) in enumerate(zip(cams, exts)):
            T_CW = (T_WS @ T_SC).inverse()
            uv, valid = cam.project_homogeneous(T_CW.apply_homogeneous(hp_W))
            li = np.nonzero(valid.cpu().numpy())[0]
            uv = uv.cpu().numpy()[li]
            if obs_noise > 0 and len(li):
                uv = uv + np.stack([rng.normal(0, obs_noise, 2) for _ in li])
            obs_state += [si] * len(li)
            obs_cam += [ci] * len(li)
            obs_lm += li.tolist()
            obs_uv.append(uv)
    O = len(obs_state)

    problem = WindowProblem.empty(
        num_states=S, num_landmarks=L, num_obs=O, num_cameras=len(cams),
        imu_capacity=n_per, device=dev,
    )
    ext7 = torch.stack([torch.cat([e.r, e.q]) for e in exts])

    def idx(v):
        return torch.as_tensor(v, dtype=torch.long, device=dev)

    def ones(n):
        return torch.ones(n, dtype=torch.bool, device=dev)

    problem = problem.replace(
        pose=poses,
        speed_bias=sbs,
        extrinsics=ext7,
        landmarks=hp_W,
        state_mask=ones(S),
        lm_mask=ones(L),
        obs_state=idx(obs_state),
        obs_cam=idx(obs_cam),
        obs_lm=idx(obs_lm),
        obs_uv=torch.as_tensor(np.concatenate(obs_uv), device=dev),
        obs_sqrt_info=torch.full((O,), 8.0 / 9.0, dtype=torch.float64, device=dev),
        obs_mask=ones(O),
        imu_pre=pre,
        imu_mask=ones(S - 1),
    )
    gt = {"pose": poses, "speed_bias": sbs, "landmarks": hp_W, "times": ts}
    return problem, cams, imu_params, gt


def disturb_problem(problem: WindowProblem, pos_sigma=0.05, rot_sigma=0.02,
                    lm_sigma=0.1, sb_sigma=0.05, seed=1, keep_first=True):
    """Perturb all states/landmarks (except optionally the first state),
    with the reference's numpy draws."""
    rng = np.random.default_rng(seed)
    S, L = problem.S, problem.L
    dp = rng.normal(0, pos_sigma, (S, 3))
    da = rng.normal(0, rot_sigma, (S, 3))
    dsb = rng.normal(0, sb_sigma, (S, 9))
    dl = rng.normal(0, lm_sigma, (L, 3))
    if keep_first:
        dp[0] = 0
        da[0] = 0
        dsb[0] = 0

    def t(x):
        return torch.as_tensor(x, dtype=problem.pose.dtype, device=problem.pose.device)

    return problem.replace(
        pose=_oplus_pose(problem.pose, t(np.concatenate([dp, da], axis=-1))),
        speed_bias=problem.speed_bias + t(dsb),
        landmarks=_oplus_hp(problem.landmarks, t(dl)),
    )


def textured_stereo_pair(height, width, seed=0, disparity=6, n_rects=60):
    """Rectified stereo images [2,H,W] (numpy float64 in [0,1]) with
    corner-rich content: smoothed noise plus overlapping rectangles, so
    Harris maxima are distinct (no near-ties) as in real imagery. The
    right image sees the scene shifted left by ``disparity`` pixels."""
    rng = np.random.default_rng(seed)
    Wd = width + disparity
    noise = rng.random((height, Wd))
    base = sum(np.roll(noise, (dy, dx), (0, 1))
               for dy in range(-2, 3) for dx in range(-2, 3)) / 25.0
    img = 0.5 * (base - base.mean()) / base.std() * 0.08
    for _ in range(n_rects):
        h = int(rng.integers(8, max(9, height // 4)))
        w = int(rng.integers(8, max(9, width // 4)))
        y = int(rng.integers(0, height - h))
        x = int(rng.integers(0, Wd - w))
        img[y:y + h, x:x + w] += rng.uniform(-0.4, 0.4)
    img = (img - img.min()) / (img.max() - img.min())
    return np.stack([img[:, :width], img[:, disparity:]])
