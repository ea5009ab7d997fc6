"""Fixed-shape sliding-window least-squares problem.

Port of ``okvis2_tpu/solver/window_problem.py``: the whole window lives in
fixed-capacity tensors with validity masks, field for field as the
reference (``WindowProblem._FIELDS``).

Slot conventions
- state slot s in [0, S): a pose [7] + speed/bias [9]; IMU link k connects
  imu_i[k] -> imu_j[k].
- landmark slot l in [0, L): homogeneous world point [4].
- observation slot o in [0, O): (state, camera, landmark, uv, whitening).
- frozen masks reproduce ceres SetParameterBlockConstant.
"""

from __future__ import annotations

import dataclasses

import torch

from okvis2_torch import resolve_device
from okvis2_torch.imu.preintegration import Preintegrated


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Static solver settings (the reference's, value for value)."""

    max_iterations: int = 10
    initial_lambda: float = 1e-4
    lambda_up: float = 10.0
    lambda_down: float = 0.5
    min_cost_decrease: float = 1e-9
    cauchy_scale: float = 1.0
    landmark_damping: float = 1e-6
    # parameter-change tolerance: an ACCEPTED step whose largest state-delta
    # component is below this ends the LM loop. 0 = off.
    step_tolerance: float = 0.0


@dataclasses.dataclass(frozen=True)
class WindowProblem:
    # --- states -----------------------------------------------------------
    pose: torch.Tensor  # [S,7] (r, q_xyzw)
    speed_bias: torch.Tensor  # [S,9]
    extrinsics: torch.Tensor  # [NC,7] T_SC per camera
    landmarks: torch.Tensor  # [L,4] homogeneous world points
    # --- masks ------------------------------------------------------------
    state_mask: torch.Tensor  # [S] bool
    pose_frozen: torch.Tensor  # [S] bool
    sb_frozen: torch.Tensor  # [S] bool
    ext_frozen: torch.Tensor  # [NC] bool
    lm_mask: torch.Tensor  # [L] bool
    # --- reprojection observations ---------------------------------------
    obs_state: torch.Tensor  # [O] int
    obs_cam: torch.Tensor  # [O] int
    obs_lm: torch.Tensor  # [O] int
    obs_uv: torch.Tensor  # [O,2]
    obs_sqrt_info: torch.Tensor  # [O] scalar whitening (8/keypoint_size)
    obs_mask: torch.Tensor  # [O] bool
    # --- IMU links --------------------------------------------------------
    imu_pre: Preintegrated  # batched [S-1, ...]
    imu_i: torch.Tensor  # [S-1] int
    imu_j: torch.Tensor  # [S-1] int
    imu_mask: torch.Tensor  # [S-1] bool
    # --- priors -----------------------------------------------------------
    pose_prior: torch.Tensor  # [S,7]
    pose_prior_sqrt: torch.Tensor  # [S,6,6]
    pose_prior_mask: torch.Tensor  # [S] bool
    sb_prior: torch.Tensor  # [S,9]
    sb_prior_sqrt: torch.Tensor  # [S,9] diagonal whitening
    sb_prior_mask: torch.Tensor  # [S] bool
    # --- relative-pose factors -------------------------------------------
    rel_i: torch.Tensor  # [R] int
    rel_j: torch.Tensor  # [R] int
    rel_T: torch.Tensor  # [R,7]
    rel_sqrt: torch.Tensor  # [R,6,6]
    rel_mask: torch.Tensor  # [R] bool
    # --- landmark priors --------------------------------------------------
    lm_prior: torch.Tensor  # [L,4]
    lm_prior_sqrt: torch.Tensor  # [L] isotropic whitening (1/sigma)
    lm_prior_mask: torch.Tensor  # [L] bool
    # --- extrinsics priors ------------------------------------------------
    ext_prior: torch.Tensor  # [NC,7]
    ext_prior_sqrt: torch.Tensor  # [NC,6,6]
    ext_prior_mask: torch.Tensor  # [NC] bool

    _FIELDS = (
        "pose", "speed_bias", "extrinsics", "landmarks",
        "state_mask", "pose_frozen", "sb_frozen", "ext_frozen", "lm_mask",
        "obs_state", "obs_cam", "obs_lm", "obs_uv", "obs_sqrt_info",
        "obs_mask", "imu_pre", "imu_i", "imu_j", "imu_mask",
        "pose_prior", "pose_prior_sqrt", "pose_prior_mask",
        "sb_prior", "sb_prior_sqrt", "sb_prior_mask",
        "rel_i", "rel_j", "rel_T", "rel_sqrt", "rel_mask",
        "lm_prior", "lm_prior_sqrt", "lm_prior_mask",
        "ext_prior", "ext_prior_sqrt", "ext_prior_mask",
    )

    # --- shapes -------------------------------------------------------------
    @property
    def S(self) -> int:
        return self.pose.shape[0]

    @property
    def L(self) -> int:
        return self.landmarks.shape[0]

    @property
    def O(self) -> int:
        return self.obs_uv.shape[0]

    @property
    def NC(self) -> int:
        return self.extrinsics.shape[0]

    def replace(self, **kw) -> "WindowProblem":
        return dataclasses.replace(self, **kw)

    def to(self, device=None, dtype=None) -> "WindowProblem":
        """Move every tensor to ``device``; cast the floating ones to
        ``dtype`` (masks and indices keep theirs)."""

        def conv(x):
            if x.is_floating_point():
                return x.to(device=device, dtype=dtype)
            return x.to(device=device)

        kw = {}
        for f in self._FIELDS:
            v = getattr(self, f)
            kw[f] = v.map(conv) if isinstance(v, Preintegrated) else conv(v)
        return WindowProblem(**kw)

    @classmethod
    def empty(
        cls,
        num_states: int,
        num_landmarks: int,
        num_obs: int,
        num_cameras: int,
        imu_capacity: int,
        num_rel: int = 4,
        dtype=torch.float64,
        device=None,
    ) -> "WindowProblem":
        """Allocate an all-masked-out problem of the given capacities
        (``imu_capacity`` is accepted for the reference's signature)."""
        del imu_capacity
        dev = resolve_device(device)
        S, L, O, NC, R = num_states, num_landmarks, num_obs, num_cameras, num_rel

        def z(*shape):
            return torch.zeros(shape, dtype=dtype, device=dev)

        def ident(n, width):
            out = z(n, width)
            out[:, width - 1] = 1.0
            return out

        def eye_batch(n, d):
            return torch.eye(d, dtype=dtype, device=dev).repeat(n, 1, 1)

        def b(n, value=False):
            return torch.full((n,), value, dtype=torch.bool, device=dev)

        def i(n):
            return torch.zeros((n,), dtype=torch.long, device=dev)

        pre = Preintegrated(
            delta_q=ident(S - 1, 4),
            c_int=z(S - 1, 3, 3),
            c_dint=z(S - 1, 3, 3),
            acc_int=z(S - 1, 3),
            acc_dint=z(S - 1, 3),
            d_alpha_dbg=z(S - 1, 3, 3),
            d_v_dbg=z(S - 1, 3, 3),
            d_p_dbg=z(S - 1, 3, 3),
            covariance=eye_batch(S - 1, 15),
            sqrt_info=eye_batch(S - 1, 15),
            dt_total=z(S - 1),
            bg_lin=z(S - 1, 3),
            ba_lin=z(S - 1, 3),
        )
        lm = torch.cat([z(L, 3), torch.ones((L, 1), dtype=dtype, device=dev)], dim=-1)
        return cls(
            pose=ident(S, 7),
            speed_bias=z(S, 9),
            extrinsics=ident(NC, 7),
            landmarks=lm,
            state_mask=b(S),
            pose_frozen=b(S),
            sb_frozen=b(S),
            ext_frozen=b(NC, True),
            lm_mask=b(L),
            obs_state=i(O),
            obs_cam=i(O),
            obs_lm=i(O),
            obs_uv=z(O, 2),
            obs_sqrt_info=torch.ones((O,), dtype=dtype, device=dev),
            obs_mask=b(O),
            imu_pre=pre,
            imu_i=torch.arange(S - 1, device=dev),
            imu_j=torch.arange(1, S, device=dev),
            imu_mask=b(S - 1),
            pose_prior=ident(S, 7),
            pose_prior_sqrt=z(S, 6, 6),
            pose_prior_mask=b(S),
            sb_prior=z(S, 9),
            sb_prior_sqrt=z(S, 9),
            sb_prior_mask=b(S),
            rel_i=i(R),
            rel_j=i(R),
            rel_T=ident(R, 7),
            rel_sqrt=z(R, 6, 6),
            rel_mask=b(R),
            lm_prior=lm.clone(),
            lm_prior_sqrt=torch.ones((L,), dtype=dtype, device=dev),
            lm_prior_mask=b(L),
            ext_prior=ident(NC, 7),
            ext_prior_sqrt=z(NC, 6, 6),
            ext_prior_mask=b(NC),
        )
