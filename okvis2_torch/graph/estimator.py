"""Sliding-window VI estimator: host bookkeeping + one flat device solve.

Port of the synchronous-loop half of ``okvis2_tpu/graph/estimator.py``
(reference: ViGraph, okvis_ceres/include/okvis/ViGraph.hpp:83-618;
ViGraphEstimator's graph surgery, okvis_ceres/src/ViGraphEstimator.cpp;
the realtime half of ViSlamBackend, okvis_ceres/src/ViSlamBackend.cpp:
71-886):

- all dynamic bookkeeping (which states, landmarks and observations
  exist, keyframe flags, covisibility, marginalisation decisions) lives on
  the host in Python containers and numpy, as in the JAX package, with
  the same iteration orders (they decide which landmarks fill the slots
  and which keyframe a factor attaches to);
- every ``optimise`` packs the window into the fixed-shape
  ``WindowProblem`` (``pack_np``), copies it to the device and runs the
  LM solve there, which returns one flat output
  (``solver/packed_solve.py``);
- IMU segments keep their raw buffers, so IMU-frame elimination is buffer
  concatenation plus lazy re-preintegration (cached per link at a
  linearisation bias, redone past ``bias_redo_threshold``);
- a keyframe leaving the window becomes a relative-pose factor computed by
  landmark Schur marginalisation on the device (``factors/two_pose.py``);
  its observations stay on the host for ``expand_keyframe``.

The solve runs in the cameras' dtype on their device (float32 on the
card, as the JAX package's solve on the TPU; float64 where the cameras
are float64, as the JAX package under x64). The port's LM loop reads a
flag back every iteration, so ``optimise_async`` has finished the solve
when it returns; its result is still applied only at
``apply_pending_solve``, at the point in the frame where the JAX loop
applies it. The pipelined loop's solve is split in three:
``prepare_fused_solve`` packs the window and the slot maps of the frames
in flight on the host, ``upload_fused_solve`` copies them to the device,
and ``dispatch_fused_solve`` hands the fused append + solve to the solve
worker; ``apply_solved_flat`` applies its result when the loop consumes
the frame. Loop closure's hooks are ``reactivate_loop_states`` and
``LandmarkRecord.packed_rows`` (the full-graph pack's observation rows).
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from okvis2_torch import resolve_device
from okvis2_torch.core import se3_np
from okvis2_torch.factors.two_pose import compute_two_pose_factor
from okvis2_torch.graph.mst import max_spanning_tree
from okvis2_torch.imu.preintegration import (
    ImuParameters,
    Preintegrated,
    init_pose_from_accel,
    preintegrate_np,
    propagate_state_np,
)
from okvis2_torch.solver.packed_solve import (
    MAX_APPEND_SETS,
    SolveWorker,
    decode_solved,
    problem_to_device,
    solve_packed,
    solve_packed_fused,
)
from okvis2_torch.solver.window_problem import SolverConfig, WindowProblem
from okvis2_torch.utils.timing import SwitchableTimer

_PRE_FIELDS = tuple(f.name for f in dataclasses.fields(Preintegrated))


@dataclasses.dataclass(frozen=True)
class EstimatorConfig:
    # window composition (reference config/euroc.yaml:75-77)
    num_keyframes: int = 5
    num_imu_frames: int = 3
    num_loop_closure_frames: int = 3
    num_pose_graph_frames: int = 6  # unfrozen pose-graph frames kept in window
    # capacities (static shapes)
    window_slots: int = 16
    landmark_slots: int = 512
    obs_slots: int = 4096
    imu_seg_capacity: int = 256
    rel_slots: int = 32
    two_pose_obs_capacity: int = 256
    two_pose_lm_capacity: int = 96
    # solver iteration budget (the reference's CeresIterationCallback
    # wall-clock budget, okvis_ceres/src/CeresIterationCallback.cpp:73):
    # the solve drops to the min-iteration count when the last solve's
    # wall time exceeded the limit
    realtime_iterations: int = 10
    realtime_min_iterations: int = 3
    enforce_realtime: bool = False
    realtime_time_limit: float = 0.035
    # vision-only mode: no IMU links; consecutive states get weak
    # relative-pose regularisers instead (PseudoImuError role,
    # okvis_ceres/src/ImuError.cpp:1156-1325)
    use_imu: bool = True
    # landmark management (ViGraph::updateLandmarks, ViGraph.cpp:775-855)
    min_parallax_quality: float = 1e-3
    # bias deviation triggering IMU re-preintegration (ImuError.cpp:~865)
    bias_redo_threshold: float = 0.1
    # online extrinsics calibration (reference OnlineCalibrationParameters,
    # Parameters.hpp:57-100): extrinsics become variable blocks anchored by
    # a pose prior at the config values
    online_extrinsics: bool = False
    ext_sigma_r: float = 0.01
    ext_sigma_alpha: float = 0.05


class StateRecord:
    __slots__ = (
        "id", "t", "pose", "speed_bias", "is_keyframe", "in_window",
        "frozen", "is_pose_graph_frame", "imu_w", "imu_a", "imu_dt",
        "imu_from", "anchor_id", "T_anchor7",
    )

    def __init__(self, sid, t, pose, speed_bias):
        self.id = sid
        self.t = float(t)
        self.pose = np.asarray(pose, np.float64)  # [7]
        self.speed_bias = np.asarray(speed_bias, np.float64)  # [9]
        self.is_keyframe = False
        self.in_window = True
        self.frozen = False
        self.is_pose_graph_frame = False
        # non-keyframe states leave the optimised graph with their pose
        # recorded relative to a keyframe anchor (okvis::Trajectory's
        # keyframe-relative non-causal update, okvis_ceres/src/
        # Trajectory.cpp)
        self.anchor_id: Optional[int] = None
        self.T_anchor7: Optional[np.ndarray] = None
        # raw IMU buffers spanning from state `imu_from` to this one: the
        # chain invariant every packer checks before building an IMU factor
        # (ImuError::append merges exactly adjacent segments,
        # ViGraphEstimator.cpp:57-157)
        self.imu_w = np.zeros((0, 3))
        self.imu_a = np.zeros((0, 3))
        self.imu_dt = np.zeros((0,))
        self.imu_from: Optional[int] = None


class _ObsDict(dict):
    """Observation dict that bumps its landmark's revision on every
    mutation, direct writes included, and calls the estimator's
    ``hook(lid, key, added, val)`` so its state->observations index and
    observation arena stay exact."""

    __slots__ = ("owner", "hook")

    def __init__(self, owner):
        super().__init__()
        self.owner = owner
        self.hook = None

    def __setitem__(self, k, v):
        self.owner.obs_rev += 1
        super().__setitem__(k, v)
        if self.hook is not None:
            self.hook(self.owner.id, k, True, v)

    def __delitem__(self, k):
        self.owner.obs_rev += 1
        super().__delitem__(k)
        if self.hook is not None:
            self.hook(self.owner.id, k, False)

    def pop(self, k, *a):
        self.owner.obs_rev += 1
        had = k in self
        r = super().pop(k, *a)
        if had and self.hook is not None:
            self.hook(self.owner.id, k, False)
        return r

    def update(self, *a, **kw):
        self.owner.obs_rev += 1
        for src in a:
            items = src.items() if hasattr(src, "items") else src
            for k, v in items:
                super().__setitem__(k, v)
                if self.hook is not None:
                    self.hook(self.owner.id, k, True, v)
        for k, v in kw.items():
            super().__setitem__(k, v)
            if self.hook is not None:
                self.hook(self.owner.id, k, True, v)

    def clear(self):
        self.owner.obs_rev += 1
        if self.hook is not None:
            for k in self:
                self.hook(self.owner.id, k, False)
        super().clear()

    def __reduce__(self):
        # pickle and deepcopy: the items are restored without the hook and
        # the revision count, which belong to the copied records already
        return (_rebuild_obs_dict, (self.owner, self.hook, dict(self)))


def _rebuild_obs_dict(owner, hook, items):
    d = _ObsDict(owner)
    dict.update(d, items)
    d.hook = hook
    return d


class _ObsArena:
    """Global observation-row store, kept exact by the _ObsDict hook.
    Columns: lid/sid/cam (int32), u/v/w=8/size (float64), alive; pack_np's
    observation section is vectorised numpy over these arrays (the
    reference's persistent ceres::Problem, ViGraph.cpp:47-62, is the
    analogue)."""

    __slots__ = ("lid", "sid", "cam", "uvw", "alive", "n", "n_dead", "row_of")

    def __init__(self, cap: int = 8192):
        self.lid = np.zeros(cap, np.int32)
        self.sid = np.zeros(cap, np.int32)
        self.cam = np.zeros(cap, np.int32)
        self.uvw = np.zeros((cap, 3), np.float64)
        self.alive = np.zeros(cap, bool)
        self.n = 0
        self.n_dead = 0
        self.row_of: Dict[Tuple[int, int, int, int], int] = {}

    def set(self, lid: int, key, val):
        k = (lid, key[0], key[1], key[2])
        r = self.row_of.get(k)
        if r is None:
            if self.n == self.alive.size:
                self._grow()
            r = self.n
            self.n += 1
            self.row_of[k] = r
            self.lid[r] = lid
            self.sid[r] = key[0]
            self.cam[r] = key[1]
        self.uvw[r, 0] = val[0]
        self.uvw[r, 1] = val[1]
        self.uvw[r, 2] = 8.0 / val[2]
        self.alive[r] = True

    def drop(self, lid: int, key):
        r = self.row_of.pop((lid, key[0], key[1], key[2]), None)
        if r is not None and self.alive[r]:
            self.alive[r] = False
            self.n_dead += 1
            if self.n_dead > 4096 and self.n_dead * 2 > self.n:
                self._compact()

    def _grow(self):
        cap = self.alive.size * 2
        for name in ("lid", "sid", "cam", "alive"):
            a = getattr(self, name)
            b = np.zeros(cap, a.dtype)
            b[: self.n] = a[: self.n]
            setattr(self, name, b)
        b = np.zeros((cap, 3), np.float64)
        b[: self.n] = self.uvw[: self.n]
        self.uvw = b

    def _compact(self):
        keep = np.nonzero(self.alive[: self.n])[0]
        remap = np.full(self.n, -1, np.int64)
        remap[keep] = np.arange(len(keep))
        for name in ("lid", "sid", "cam", "alive", "uvw"):
            a = getattr(self, name)
            a[: len(keep)] = a[keep]
        self.row_of = {k: int(remap[r]) for k, r in self.row_of.items()}
        self.n = len(keep)
        self.n_dead = 0


class LandmarkRecord:
    __slots__ = ("id", "hp_W", "quality", "initialised", "obs", "info_scale", "obs_rev",
                 "_row_cache")

    def __init__(self, lid, hp_W):
        self.id = lid
        self.hp_W = np.asarray(hp_W, np.float64)  # [4]
        self.quality = 0.0
        self.initialised = False
        self.obs_rev = 0
        self._row_cache = None  # (obs_rev, rows [n,5])
        # obs: (state_id, cam_idx, kp_idx) -> (u, v, size)
        self.obs: Dict[Tuple[int, int, int], Tuple[float, float, float]] = _ObsDict(self)
        # information scale on all observations of this landmark (CNN
        # suppression, Frontend.cpp:986-1011)
        self.info_scale = 1.0

    def packed_rows(self) -> np.ndarray:
        """[n,5] float rows (sid, cam, u, v, 8/size) of the observations, in
        their insertion order; cached until the observations change."""
        cache = self._row_cache
        if cache is not None and cache[0] == self.obs_rev:
            return cache[1]
        if self.obs:
            rows = np.array([(s, ci, u, v, 8.0 / size)
                             for (s, ci, _kp), (u, v, size) in self.obs.items()], np.float64)
        else:
            rows = np.zeros((0, 5), np.float64)
        self._row_cache = (self.obs_rev, rows)
        return rows


class PoseGraphEdge:
    """A marginalisation or loop-closure relative-pose factor, reversible."""

    __slots__ = ("id_i", "id_j", "T_ij", "sqrt_info", "stored_obs", "kind")

    def __init__(self, id_i, id_j, T_ij, sqrt_info, stored_obs, kind):
        self.id_i = id_i
        self.id_j = id_j
        self.T_ij = np.asarray(T_ij, np.float64)  # [7]
        self.sqrt_info = np.asarray(sqrt_info, np.float64)  # [6,6]
        # stored_obs: list of (lm_id, state_id, cam, kp, u, v, size), to
        # convert back to observations (expand_keyframe)
        self.stored_obs = stored_obs
        self.kind = kind  # "marg" | "loop"


class Estimator:
    """Realtime sliding-window estimator (the ViSlamBackend realtime-graph
    role). ``cameras``: PinholeCamera per camera (their dtype is the
    solve's); ``extrinsics``: Transformation per camera; runs its solves
    on ``device`` (None: the CUDA card; raises without one)."""

    def __init__(
        self,
        cameras: tuple,
        extrinsics: list,
        imu_params: ImuParameters,
        config: EstimatorConfig = EstimatorConfig(),
        device=None,
    ):
        self.device = resolve_device(device)
        self.dtype = cameras[0].focal.dtype
        self.cameras = tuple(c.to(device=self.device) for c in cameras)
        self.T_SC = [torch.cat([T.r, T.q]).detach().cpu().numpy().astype(np.float64)
                     for T in extrinsics]
        # config/CAD extrinsics: the anchor for online-calibration priors
        self.T_SC_prior = [row.copy() for row in self.T_SC]
        self.imu_params = imu_params.to(device=self.device, dtype=self.dtype)
        self.cfg = config
        self.states: Dict[int, StateRecord] = {}
        self.state_order: List[int] = []  # insertion/time order, all history
        self.window: List[int] = []  # ids currently in the window
        self.landmarks: Dict[int, LandmarkRecord] = {}
        # incrementally maintained state -> {(lid, cam, kp)} index (kept
        # exact by the _ObsDict hook)
        self._by_state: Dict[int, set] = {}
        # cumulative observation insertions (monotone)
        self.n_obs_inserted = 0
        # per-state revision + cached lid array (pack_np: only states whose
        # observations changed re-materialise)
        self._by_state_rev: Dict[int, int] = {}
        self._obs_arena = _ObsArena()
        # lid -> info_scale for suppressed landmarks only
        self._lm_suppressed: Dict[int, float] = {}
        self._lid_cache: Dict[int, Tuple[int, np.ndarray]] = {}
        self.pose_graph_edges: List[PoseGraphEdge] = []
        self._next_state_id = 0
        self._next_lm_id = 0
        self._pre_cache: Dict[int, Tuple[np.ndarray, object, int, int]] = {}
        self._pre_rev = 0
        self._obs_rev = 0
        self._imu_buf = None  # persistent imu_pre link buffer (pack_np)
        self._np_template_cache: Optional[WindowProblem] = None
        self._pending_solve = None
        self._last_solve_wall = 0.0
        self._solve_t0 = 0.0
        self._solve_worker: Optional[SolveWorker] = None  # the pipelined loop's, on first use
        # realtime LM termination: relative cost decreases below 1e-6 and
        # accepted steps below 10 um end the solve (warm-started windows
        # converge in ~3 iterations)
        self._solver_cfg = SolverConfig(
            max_iterations=config.realtime_iterations,
            min_cost_decrease=1e-6,
            step_tolerance=1e-5,
        )
        self.initialised = False

    # ------------------------------------------------------------------
    # state management (ViGraph::addStatesInitialise / addStatesPropagate)
    # ------------------------------------------------------------------
    def add_state(self, t: float, imu_w: np.ndarray, imu_a: np.ndarray,
                  imu_dt: np.ndarray) -> int:
        """Add a new state at time t, propagated through the given IMU
        segment from the previous state. The first call initialises from
        gravity (ViGraph.cpp:79-191)."""
        sid = self._next_state_id
        self._next_state_id += 1

        if not self.window:
            # gravity-aligned initialisation + priors (host float64, as
            # all bookkeeping)
            a_mean = imu_a.mean(axis=0) if len(imu_a) else np.array([0, 0, 9.81])
            T0 = init_pose_from_accel(torch.as_tensor(np.asarray(a_mean, np.float64)))
            pose = torch.cat([T0.r, T0.q]).numpy()
            rec = StateRecord(sid, t, pose, np.zeros(9))
            self.states[sid] = rec
            self.state_order.append(sid)
            self.window.append(sid)
            self.initialised = True
            return sid

        prev = self.states[self.window[-1]]
        # propagate for the initial guess on the host
        if len(imu_dt):
            pose, sb = propagate_state_np(
                float(self.imu_params.g), prev.pose, prev.speed_bias,
                np.asarray(imu_w), np.asarray(imu_a), np.asarray(imu_dt),
            )
        else:
            pose = prev.pose.copy()
            sb = prev.speed_bias.copy()
        rec = StateRecord(sid, t, pose, sb)
        rec.imu_w = np.asarray(imu_w, np.float64)
        rec.imu_a = np.asarray(imu_a, np.float64)
        rec.imu_dt = np.asarray(imu_dt, np.float64)
        rec.imu_from = prev.id
        self.states[sid] = rec
        self.state_order.append(sid)
        self.window.append(sid)
        return sid

    def set_keyframe(self, sid: int, is_kf: bool = True):
        self.states[sid].is_keyframe = is_kf

    def repredict_from_previous(self, sid: int):
        """Re-propagate sid's pose/speed-bias prediction from its chain
        predecessor's current estimate (after the previous frame's solve
        lands mid-frame: the frontend tracked with a one-solve-stale
        prediction; the pack uses the refreshed one)."""
        rec = self.states[sid]
        if rec.imu_from is None or rec.imu_from not in self.states:
            return
        prev = self.states[rec.imu_from]
        if len(rec.imu_dt):
            rec.pose, rec.speed_bias = propagate_state_np(
                float(self.imu_params.g), prev.pose, prev.speed_bias,
                rec.imu_w, rec.imu_a, rec.imu_dt,
            )

    # ------------------------------------------------------------------
    # landmarks & observations (ViGraph header-inline add/remove)
    # ------------------------------------------------------------------
    def add_landmark(self, hp_W, initialised=False) -> int:
        lid = self._next_lm_id
        self._next_lm_id += 1
        rec = LandmarkRecord(lid, hp_W)
        rec.initialised = bool(initialised)
        rec.obs.hook = self._obs_hook
        self.landmarks[lid] = rec
        return lid

    def _obs_hook(self, lid: int, key, added: bool, val=None):
        """_ObsDict mutation hook: keep the state->observations index and
        the observation arena exact through every mutation path."""
        sid, ci, kp = key
        s = self._by_state.get(sid)
        if added:
            if s is None:
                s = self._by_state[sid] = set()
            if (lid, ci, kp) not in s:
                s.add((lid, ci, kp))
                self.n_obs_inserted += 1
            self._obs_arena.set(lid, key, val)
        else:
            if s is not None:
                s.discard((lid, ci, kp))
            self._obs_arena.drop(lid, key)
        self._by_state_rev[sid] = self._by_state_rev.get(sid, 0) + 1

    def _forget_landmark_obs(self, lm: LandmarkRecord):
        """Discard a to-be-deleted landmark's index entries (whole-record
        deletions bypass the dict hook)."""
        for (sid, ci, kp) in lm.obs:
            s = self._by_state.get(sid)
            if s is not None:
                s.discard((lm.id, ci, kp))
                self._by_state_rev[sid] = self._by_state_rev.get(sid, 0) + 1
            self._obs_arena.drop(lm.id, (sid, ci, kp))

    def set_info_scale(self, lm_id: int, scale: float):
        """Set a landmark's observation information scale (CNN
        suppression, Frontend.cpp:986-1011)."""
        lm = self.landmarks.get(lm_id)
        if lm is None:
            return
        lm.info_scale = float(scale)
        if scale != 1.0:
            self._lm_suppressed[lm_id] = float(scale)
        else:
            self._lm_suppressed.pop(lm_id, None)

    def add_observation(self, lm_id, state_id, cam_idx, kp_idx, uv, size=9.0):
        self.landmarks[lm_id].obs[(state_id, cam_idx, kp_idx)] = (
            float(uv[0]), float(uv[1]), float(size)
        )
        self._obs_rev += 1

    def remove_observation(self, lm_id, state_id, cam_idx, kp_idx):
        self.landmarks[lm_id].obs.pop((state_id, cam_idx, kp_idx), None)
        self._obs_rev += 1

    def obs_of_state(self, sid: int):
        """All (lm_id, cam_idx, kp_idx) observed from state sid, from the
        incrementally maintained index."""
        return self._by_state.get(sid, ())

    def merge_landmarks(self, keep_id: int, drop_id: int):
        drop = self.landmarks.pop(drop_id, None)
        if drop is None:
            return
        self._forget_landmark_obs(drop)
        self.landmarks[keep_id].obs.update(drop.obs)
        self._obs_rev += 1

    def clean_unobserved_landmarks(self, min_obs: int = 2):
        """ViGraph::cleanUnobservedLandmarks (ViGraph.cpp:908+)."""
        window = set(self.window)
        # landmarks referenced by stored (marginalised) observations must
        # survive for reversibility
        protected = set()
        for e in self.pose_graph_edges:
            for o in e.stored_obs:
                protected.add(o[0])
        dead = []
        for lid, lm in self.landmarks.items():
            if lid in protected:
                continue
            if not lm.obs and lm.initialised:
                # a map point loaded without observations stays matchable
                continue
            n_win = sum(1 for (s, _, _) in lm.obs if s in window)
            if n_win == 0 or (len(lm.obs) < min_obs and not lm.initialised):
                dead.append(lid)
        for lid in dead:
            self._forget_landmark_obs(self.landmarks[lid])
            del self.landmarks[lid]
        if dead:
            self._obs_rev += 1

    # ------------------------------------------------------------------
    # covisibility (ViGraph::covisibilities, ViGraph.cpp:505-563)
    # ------------------------------------------------------------------
    def covisibility(self, id_a: int, id_b: int) -> int:
        n = 0
        for lm in self.landmarks.values():
            sa = any(k[0] == id_a for k in lm.obs)
            if sa and any(k[0] == id_b for k in lm.obs):
                n += 1
        return n

    def covisible_landmark_counts(self) -> Dict[int, Dict[int, int]]:
        counts: Dict[int, Dict[int, int]] = {}
        for lm in self.landmarks.values():
            sids = {k[0] for k in lm.obs}
            for a in sids:
                for b in sids:
                    if a < b:
                        counts.setdefault(a, {}).setdefault(b, 0)
                        counts[a][b] += 1
        return counts

    # ------------------------------------------------------------------
    # IMU link handling with preintegration cache
    # ------------------------------------------------------------------
    def _get_preintegrated(self, sid: int):
        """Preintegrate the raw buffer ending at state sid (cached)."""
        rec = self.states[sid]
        bg = rec.speed_bias[3:6]
        ba = rec.speed_bias[6:9]
        cached = self._pre_cache.get(sid)
        if cached is not None:
            bias_lin, pre, n_meas, _rev = cached
            if (n_meas == len(rec.imu_dt)
                    and np.linalg.norm(bias_lin - np.concatenate([bg, ba]))
                    < self.cfg.bias_redo_threshold):
                return pre
        cap = self.cfg.imu_seg_capacity
        n = len(rec.imu_dt)
        if n > cap:
            # downsample by averaging adjacent pairs until it fits
            w, a, dt = rec.imu_w, rec.imu_a, rec.imu_dt
            while len(dt) > cap:
                m = (len(dt) // 2) * 2
                w2 = 0.5 * (w[:m:2] + w[1:m:2])
                a2 = 0.5 * (a[:m:2] + a[1:m:2])
                dt2 = dt[:m:2] + dt[1:m:2]
                if m < len(dt):
                    w2 = np.concatenate([w2, w[m:]])
                    a2 = np.concatenate([a2, a[m:]])
                    dt2 = np.concatenate([dt2, dt[m:]])
                w, a, dt = w2, a2, dt2
            wb, ab, dtb = w, a, dt
        else:
            wb, ab, dtb = rec.imu_w, rec.imu_a, rec.imu_dt
        with SwitchableTimer("3.131 preintegrate_np (cache miss)"):
            pre = preintegrate_np(self.imu_params, wb, ab, dtb, bg, ba)
        # monotone revision: keys the per-row imu_pre buffer in pack_np
        self._pre_rev += 1
        self._pre_cache[sid] = (np.concatenate([bg, ba]), pre, len(rec.imu_dt), self._pre_rev)
        return pre

    # ------------------------------------------------------------------
    # packing: host records -> WindowProblem
    # ------------------------------------------------------------------
    def _window_landmarks(self) -> List[int]:
        """Landmarks observed from the window, best-first (window
        observation count desc, then lid desc), up to capacity; only
        initialised ones."""
        arrs = []
        for sid in self.window:
            s = self._by_state.get(sid)
            if not s:
                continue
            rev = self._by_state_rev.get(sid, 0)
            c = self._lid_cache.get(sid)
            if c is None or c[0] != rev:
                a = np.fromiter((t[0] for t in s), np.int64, len(s))
                self._lid_cache[sid] = c = (rev, a)
            arrs.append(c[1])
        if not arrs:
            self._lm_nwin = {}
            return []
        lids_u, n_u = np.unique(np.concatenate(arrs), return_counts=True)
        order = np.lexsort((-lids_u, -n_u))
        scored = []
        for lid, n_win in zip(lids_u[order].tolist(), n_u[order].tolist()):
            lm = self.landmarks.get(lid)
            if lm is not None and lm.initialised:
                scored.append((n_win, lid))
        sel = scored[: self.cfg.landmark_slots]
        if len(scored) > len(sel):
            _warn_capacity(
                "landmark_slots",
                f"window sees {len(scored)} landmarks, packing best {len(sel)} "
                f"(landmark_slots={self.cfg.landmark_slots}) — raise "
                "EstimatorConfig.landmark_slots to keep them all",
            )
        self._lm_nwin = {lid: n for n, lid in sel}
        return [lid for _, lid in sel]

    def _np_template(self) -> WindowProblem:
        """A WindowProblem with numpy leaves at this estimator's capacities
        (cached, read-only: pack_np copies every leaf it changes)."""
        if self._np_template_cache is None:
            cfg = self.cfg
            prob = WindowProblem.empty(
                cfg.window_slots, cfg.landmark_slots, cfg.obs_slots, len(self.cameras),
                cfg.imu_seg_capacity, num_rel=cfg.rel_slots, dtype=torch.float64, device="cpu",
            )
            to_np = lambda x: x.numpy()  # noqa: E731
            kw = {f: (getattr(prob, f).map(to_np) if f == "imu_pre"
                      else to_np(getattr(prob, f))) for f in WindowProblem._FIELDS}
            self._np_template_cache = WindowProblem(**kw)
        return self._np_template_cache

    def pack_np(self) -> WindowProblem:
        cfg = self.cfg
        S, L, O = cfg.window_slots, cfg.landmark_slots, cfg.obs_slots
        NC = len(self.cameras)
        prob = self._np_template()
        win = self.window[-S:]
        slot_of = {sid: i for i, sid in enumerate(win)}
        n_win = len(win)

        _t_states = SwitchableTimer("3.11 pack: states+landmarks")
        _t_states.__enter__()
        pose = np.array(prob.pose)
        sb = np.array(prob.speed_bias)
        smask = np.zeros(S, bool)
        pfroz = np.zeros(S, bool)
        sbfroz = np.zeros(S, bool)
        for sid, i in slot_of.items():
            rec = self.states[sid]
            pose[i] = rec.pose
            sb[i] = rec.speed_bias
            smask[i] = True
            pfroz[i] = rec.frozen
            sbfroz[i] = rec.frozen or not cfg.use_imu

        # landmarks
        lm_ids = self._window_landmarks()
        lm_slot = {lid: i for i, lid in enumerate(lm_ids)}
        lms = np.array(prob.landmarks)
        lmask = np.zeros(L, bool)
        # weak isotropic anchors for under-constrained landmarks
        # (HomogeneousPointError role): a single-observation landmark must
        # not slide along its one ray
        lp = np.array(prob.lm_prior)
        lp_sq = np.zeros(L)
        lp_m = np.zeros(L, bool)
        sc_slot = np.ones(L)
        for lid, i in lm_slot.items():
            lm = self.landmarks[lid]
            lms[i] = lm.hp_W
            lmask[i] = True
            sc_slot[i] = lm.info_scale
            if self._lm_nwin.get(lid, 2) < 2:
                lp[i] = lm.hp_W
                lp_sq[i] = 0.5  # sigma ~2 m: holds, doesn't bias
                lp_m[i] = True
        # information x info_scale => sqrt-info x sqrt(info_scale)
        np.sqrt(sc_slot, out=sc_slot)
        _t_states.__exit__(None, None, None)

        # observations: vectorised over the arena rows of this window
        _t_obs = SwitchableTimer("3.12 pack: obs rows")
        _t_obs.__enter__()
        o_state = np.zeros(O, np.int32)
        o_cam = np.zeros(O, np.int32)
        o_lm = np.zeros(O, np.int32)
        o_uv = np.zeros((O, 2))
        o_w = np.ones(O)
        o_mask = np.zeros(O, bool)
        sid_to_slot = np.full(self._next_state_id + 1, -1, np.int32)
        for sid2, i in slot_of.items():
            sid_to_slot[sid2] = i
        lid_to_slot = np.full(self._next_lm_id + 1, -1, np.int32)
        if lm_ids:
            lid_to_slot[np.asarray(lm_ids, np.int64)] = np.arange(len(lm_ids), dtype=np.int32)
        self._lid_to_slot = lid_to_slot  # reused by the pipelined solve's slot maps
        ar = self._obs_arena
        n = ar.n
        st = sid_to_slot[ar.sid[:n]]
        ls = lid_to_slot[ar.lid[:n]]
        idxs = np.nonzero(ar.alive[:n] & (st >= 0) & (ls >= 0))[0]
        if len(idxs) > O:
            _warn_capacity(
                "obs_slots",
                f"obs cap bound: dropped {len(idxs) - O} observations (obs_slots={O}) — "
                "raise EstimatorConfig.obs_slots (the reference has no cap)",
            )
            idxs = idxs[:O]
        k = len(idxs)
        if k:
            uvw = ar.uvw[idxs]
            lm_rows = ls[idxs]
            o_state[:k] = st[idxs]
            o_cam[:k] = ar.cam[idxs]
            o_lm[:k] = lm_rows
            o_uv[:k] = uvw[:, :2]
            o_w[:k] = uvw[:, 2] * sc_slot[lm_rows]
            o_mask[:k] = True
        # the pipelined solve's device-side append starts after these rows
        self._n_obs_packed = k
        _t_obs.__exit__(None, None, None)

        # IMU links between consecutive window slots, in a persistent
        # per-slot buffer: only rows whose (from, to, preintegration
        # revision) key changed are rewritten. The returned problem's
        # imu_pre leaves are views of this buffer, valid until the next
        # pack_np.
        _t_imu = SwitchableTimer("3.13 pack: imu links")
        _t_imu.__enter__()
        imu_mask = np.zeros(S - 1, bool)
        if self._imu_buf is None:
            self._imu_buf = ([np.array(getattr(prob.imu_pre, f)) for f in _PRE_FIELDS],
                             [None] * (S - 1))
        buf, row_keys = self._imu_buf
        if cfg.use_imu:
            for i in range(n_win - 1):
                nxt = self.states[win[i + 1]]
                # chain check: the buffer must span exactly win[i]->win[i+1]
                if len(nxt.imu_dt) and nxt.imu_from == win[i]:
                    imu_mask[i] = True
                    pre = self._get_preintegrated(win[i + 1])
                    key = (win[i], win[i + 1], self._pre_cache[win[i + 1]][3])
                    if row_keys[i] != key:
                        for b, f in zip(buf, _PRE_FIELDS):
                            b[i] = getattr(pre, f)
                        row_keys[i] = key
        imu_pre = Preintegrated(*buf)
        _t_imu.__exit__(None, None, None)

        # priors: gravity-aligned init prior on the oldest ever state while
        # it is in the window (ViGraph.cpp:120-170)
        _t_rest = SwitchableTimer("3.14 pack: priors+rel+replace")
        _t_rest.__enter__()
        pp_T = np.array(prob.pose_prior)
        pp_sq = np.zeros((S, 6, 6))
        pp_m = np.zeros(S, bool)
        sb_p = np.zeros((S, 9))
        sb_sq = np.zeros((S, 9))
        sb_m = np.zeros(S, bool)
        first_id = self.state_order[0]
        if first_id in slot_of:
            i = slot_of[first_id]
            rec = self.states[first_id]
            pp_T[i] = rec.pose
            # strong position/yaw fixation, weaker roll/pitch (observable)
            pp_sq[i] = np.diag([1e4, 1e4, 1e4, 1e2, 1e2, 1e4])
            pp_m[i] = True
            sb_p[i] = rec.speed_bias
            sb_sq[i] = np.concatenate([
                np.full(3, 10.0),        # speed prior ~0.1 m/s
                np.full(3, 1.0 / 0.03),  # gyro bias prior sigma_bg
                np.full(3, 1.0 / 0.1),   # accel bias prior sigma_ba
            ])
            sb_m[i] = True

        # relative-pose edges with both endpoints in the window
        R = cfg.rel_slots
        r_i = np.zeros(R, np.int32)
        r_j = np.zeros(R, np.int32)
        r_T = np.tile(np.array([0, 0, 0, 0, 0, 0, 1.0]), (R, 1))
        r_sq = np.zeros((R, 6, 6))
        r_m = np.zeros(R, bool)
        k = 0
        if not cfg.use_imu:
            # PseudoImuError-style weak chaining of consecutive states
            for i in range(n_win - 1):
                if k >= R:
                    break
                pa = self.states[win[i]].pose
                pb = self.states[win[i + 1]].pose
                qa = pa[3:7]
                dq = se3_np.quat_mul(se3_np.quat_conj(qa), pb[3:7])
                Ca = se3_np.quat_to_mat(qa)
                dr = Ca.T @ (pb[:3] - pa[:3])
                r_i[k] = i
                r_j[k] = i + 1
                r_T[k] = np.concatenate([dr, dq])
                r_sq[k] = np.diag([1.0, 1.0, 1.0, 2.0, 2.0, 2.0])
                r_m[k] = True
                k += 1
        for e in self.pose_graph_edges:
            if e.id_i in slot_of and e.id_j in slot_of and k < R:
                r_i[k] = slot_of[e.id_i]
                r_j[k] = slot_of[e.id_j]
                r_T[k] = e.T_ij
                r_sq[k] = e.sqrt_info
                r_m[k] = True
                k += 1

        # online extrinsics: unfreeze T_SC blocks, anchored by priors at
        # the config values with sigma_r/sigma_alpha whitening
        ext_froz = np.ones(NC, bool)
        ep_T = np.stack(self.T_SC_prior)
        ep_sq = np.zeros((NC, 6, 6))
        ep_m = np.zeros(NC, bool)
        if cfg.online_extrinsics:
            ext_froz[:] = False
            ep_sq[:] = np.diag([1.0 / cfg.ext_sigma_r] * 3 + [1.0 / cfg.ext_sigma_alpha] * 3)
            ep_m[:] = True

        prob = dataclasses.replace(
            prob,
            pose=pose, speed_bias=sb, extrinsics=np.stack(self.T_SC), ext_frozen=ext_froz,
            ext_prior=ep_T, ext_prior_sqrt=ep_sq, ext_prior_mask=ep_m,
            landmarks=lms, state_mask=smask, pose_frozen=pfroz, sb_frozen=sbfroz,
            lm_mask=lmask, obs_state=o_state, obs_cam=o_cam, obs_lm=o_lm, obs_uv=o_uv,
            obs_sqrt_info=o_w, obs_mask=o_mask, imu_pre=imu_pre, imu_mask=imu_mask,
            pose_prior=pp_T, pose_prior_sqrt=pp_sq, pose_prior_mask=pp_m,
            sb_prior=sb_p, sb_prior_sqrt=sb_sq, sb_prior_mask=sb_m,
            rel_i=r_i, rel_j=r_j, rel_T=r_T, rel_sqrt=r_sq, rel_mask=r_m,
            lm_prior=lp, lm_prior_sqrt=lp_sq, lm_prior_mask=lp_m,
        )
        self._lm_ids = lm_ids
        self._slot_of = slot_of
        _t_rest.__exit__(None, None, None)
        return prob

    def unpack(self, prob: WindowProblem):
        """Write a solved problem (tensors or numpy) back into the records
        of the last pack."""
        to_np = lambda x: x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
            else np.asarray(x)  # noqa: E731
        pose = np.array(to_np(prob.pose), np.float64)
        sb = np.array(to_np(prob.speed_bias), np.float64)
        for sid, i in self._slot_of.items():
            rec = self.states[sid]
            if not rec.frozen:
                rec.pose = pose[i]
                rec.speed_bias = sb[i]
        lms = np.asarray(to_np(prob.landmarks), np.float64)
        for i, lid in enumerate(self._lm_ids):
            self.landmarks[lid].hp_W = lms[i]

    # ------------------------------------------------------------------
    def optimise_async(self, iterations: Optional[int] = None) -> None:
        """optimiseRealtimeGraph (ViSlamBackend.cpp:712-886): pack the
        window, copy it to the device, solve, and keep the flat output as
        the pending solve for ``apply_pending_solve``. The port's LM loop
        waits for the device each iteration, so the solve has finished
        when this returns."""
        cfg = self._solver_cfg
        if iterations is None and self.cfg.enforce_realtime:
            # realtime budget (CeresIterationCallback role): drop to the
            # min-iteration count when the last solve overran the limit
            if self._last_solve_wall > self.cfg.realtime_time_limit:
                iterations = self.cfg.realtime_min_iterations
        if iterations is not None and iterations != cfg.max_iterations:
            cfg = dataclasses.replace(cfg, max_iterations=iterations)

        with SwitchableTimer("3.1 pack_np"):
            prob_np = self.pack_np()
        self._solve_t0 = time.perf_counter()
        with SwitchableTimer("3.15 upload"):
            problem = problem_to_device(prob_np, self.device, self.dtype)
        with SwitchableTimer("3.2 solve"):
            out = solve_packed(problem, self.cameras, self.imu_params, cfg)
        self._pending_solve = (out, dict(self._slot_of), list(self._lm_ids))

    def prepare_fused_solve(self, sid: int, table, sets, iterations: Optional[int] = None):
        """Host half of the pipelined loop's solve: the iteration budget, the
        window packed from the host's (lagged) records, and the side inputs
        of the device-side append. ``sets`` lists the frames whose match
        rows the device must append, oldest first and ending with the
        current frame (``sid``): every frame whose solve output the host
        has not consumed yet, as {"sid": state id, "slot_lid": the landmark
        table's slot -> landmark id array as of that frame's prep}.

        Returns (problem_np, config, aux): aux holds numpy "maps" [K,cap]
        (table slot -> this pack's landmark slot; -1 rows for padding sets
        and for frames whose state has left the window), "cur_slots" [K],
        "n_obs_base" (the rows packed here), "w_scale" [cap]
        (sqrt(info_scale) of suppressed landmarks by current table slot),
        and "n_sets", the sets left enabled; K = MAX_APPEND_SETS."""
        cfg = self._solver_cfg
        if iterations is None and self.cfg.enforce_realtime:
            # realtime budget: _last_solve_wall spans dispatch to apply,
            # about one frame, so it acts on the end-to-end frame time
            if self._last_solve_wall > self.cfg.realtime_time_limit:
                iterations = self.cfg.realtime_min_iterations
        if iterations is not None and iterations != cfg.max_iterations:
            cfg = dataclasses.replace(cfg, max_iterations=iterations)

        K = MAX_APPEND_SETS
        assert len(sets) <= K, (len(sets), K)
        cap = table.capacity
        with SwitchableTimer("3.1 pack_np"):
            prob_np = self.pack_np()
        with SwitchableTimer("3.16 pack: aux maps"):
            maps = np.full((K, cap), -1, np.int64)
            cur_slots = np.zeros(K, np.int64)
            w_scale = np.ones(cap)
            # CNN-suppressed landmarks are the only info_scale writers
            for lid, sc in self._lm_suppressed.items():
                slot = table.slot_of.get(lid)
                if slot is not None:
                    w_scale[slot] = np.sqrt(sc)
            lid_to_slot = self._lid_to_slot
            n_sets = 0
            for k, st in enumerate(sets):
                if st["sid"] not in self._slot_of:
                    # the frame's state left the window before its
                    # bookkeeping ran: its matches constrain nothing
                    continue
                sl = st["slot_lid"]
                ok = (sl >= 0) & (sl < len(lid_to_slot))
                maps[k] = np.where(ok, lid_to_slot[np.where(ok, sl, 0)], -1)
                cur_slots[k] = self._slot_of[st["sid"]]
                n_sets += 1
        aux = {"maps": maps, "cur_slots": cur_slots, "n_obs_base": self._n_obs_packed,
               "w_scale": w_scale, "n_sets": n_sets}
        return prob_np, cfg, aux

    def upload_fused_solve(self, prob_np: WindowProblem, aux: dict):
        """Copy ``prepare_fused_solve``'s pack and side inputs to the device:
        (problem, aux tensors as ``solve_packed_fused`` takes them)."""
        dev = self.device
        with SwitchableTimer("3.15 upload"):
            problem = problem_to_device(prob_np, dev, self.dtype)
            aux_dev = {
                "maps": torch.from_numpy(aux["maps"]).to(dev),
                "cur_slots": torch.from_numpy(aux["cur_slots"]).to(dev),
                "n_obs_base": torch.tensor(aux["n_obs_base"], dtype=torch.long, device=dev),
                "w_scale": torch.from_numpy(aux["w_scale"]).to(device=dev, dtype=self.dtype),
            }
        return problem, aux_dev

    def dispatch_fused_solve(self, problem: WindowProblem, aux_dev: dict, match_sets, diag,
                             config: SolverConfig):
        """Submit the fused append + solve (``solve_packed_fused``) on the
        uploaded pack to the solve worker, without waiting. ``match_sets``
        are the frames' device-resident match tensors ({"idx", "keep",
        "xy", "size"}) in the order of ``prepare_fused_solve``'s ``sets``,
        padded to MAX_APPEND_SETS with any of them (their maps are -1);
        ``diag`` is the current frame program's flat diagnostics. Returns
        the job: {"future": resolves to the numpy [solve output | diag] or
        raises the solve's exception, "inputs": the tensors the job reads}.
        Hold the job until its result has been read."""
        assert len(match_sets) == MAX_APPEND_SETS
        self._solve_t0 = time.perf_counter()
        sets = tuple((m["idx"], m["keep"], m["xy"], m["size"]) for m in match_sets)
        inputs = (problem, aux_dev, sets, diag, self.cameras, self.imu_params, config)
        return {"future": self.solve_worker().submit(solve_packed_fused, *inputs),
                "inputs": inputs}

    def solve_worker(self) -> SolveWorker:
        """The pipelined loop's solve worker, created on first use."""
        if self._solve_worker is None:
            self._solve_worker = SolveWorker(self.device)
        return self._solve_worker

    def close_solve_worker(self):
        """End the solve worker's thread after its queued jobs (a later
        ``solve_worker()`` starts a new one)."""
        if self._solve_worker is not None:
            self._solve_worker.close()
            self._solve_worker = None

    def solve_out_size(self) -> int:
        """Length of solve_packed's flat output for this configuration."""
        c = self.cfg
        return c.window_slots * 16 + c.landmark_slots * 4 + len(self.cameras) * 7 + 5

    def take_pending_solve(self):
        """Hand the pending solve's device output to the caller; returns
        (out, slot_of, lm_ids) or None."""
        pending = self._pending_solve
        self._pending_solve = None
        return pending

    def apply_solved_flat(self, out, slot_of, lm_ids, T_corr7=None, solve_t0=None) -> dict:
        """Integrate a solve output (numpy or device tensor) into the host
        records. ``T_corr7`` composes a world-frame rigid correction onto
        every solved pose, velocity and landmark first: the pipelined loop
        passes the net correction applied after this solve was dispatched,
        so that the solve does not undo it (``SlamSystem.
        _note_pose_correction``). ``solve_t0``: this solve's dispatch time
        (the pipelined loop keeps one per frame in flight; default the
        last dispatch's)."""
        pose, sb, lms, ext, stats = decode_solved(
            out, self.cfg.window_slots, self.cfg.landmark_slots, len(self.cameras))
        # dispatch-to-apply wall time of THIS solve: the realtime budget's
        # input
        self._last_solve_wall = time.perf_counter() - (
            solve_t0 if solve_t0 is not None else self._solve_t0)
        if T_corr7 is not None:
            pose = np.array(pose, np.float64)
            sb = np.array(sb, np.float64)
            lms = np.array(lms, np.float64)
            R = se3_np.quat_to_mat(T_corr7[3:7])
            pose[:, :3] = pose[:, :3] @ R.T + T_corr7[:3]
            pose[:, 3:7] = np.stack([se3_np.quat_mul(T_corr7[3:7], q) for q in pose[:, 3:7]])
            sb[:, :3] = sb[:, :3] @ R.T  # the world velocity rotates
            lms[:, :3] = lms[:, :3] @ R.T + T_corr7[None, :3] * lms[:, 3:4]
        for sid, i in slot_of.items():
            rec = self.states.get(sid)
            if rec is not None and not rec.frozen:
                rec.pose = np.asarray(pose[i], np.float64)
                rec.speed_bias = np.asarray(sb[i], np.float64)
        for i, lid in enumerate(lm_ids):
            lm = self.landmarks.get(lid)
            if lm is not None:
                lm.hp_W = np.asarray(lms[i], np.float64)
        if self.cfg.online_extrinsics:
            self.T_SC = [np.asarray(ext[i], np.float64) for i in range(len(self.T_SC))]
        if stats["n_obs"] > self.cfg.obs_slots:
            _warn_capacity(
                "obs_append",
                f"device-appended match rows overflowed obs capacity ({stats['n_obs']:.0f} > "
                f"{self.cfg.obs_slots}): excess matches did not constrain this solve — raise "
                "obs_slots")
        self.update_landmark_quality()
        return stats

    def apply_pending_solve(self) -> Optional[dict]:
        """Integrate the results of the previous ``optimise_async``.
        Returns the solve stats, or None if no solve is pending."""
        pending = self.take_pending_solve()
        if pending is None:
            return None
        out, slot_of, lm_ids = pending
        return self.apply_solved_flat(out, slot_of, lm_ids)

    def optimise(self, iterations: Optional[int] = None) -> dict:
        """Synchronous solve (solve + apply): the offline/test path."""
        self.optimise_async(iterations)
        return self.apply_pending_solve()

    # ------------------------------------------------------------------
    def update_landmark_quality(self):
        """Parallax-based landmark quality (ViGraph::updateLandmarks,
        ViGraph.cpp:775-855: quality = sqrt of the smallest eigenvalue of
        the mean direction outer product; initialise above a threshold).
        Only uninitialised landmarks are scored (a one-way switch)."""
        window = set(self.window)
        cand = [lm for lm in self.landmarks.values() if not lm.initialised]
        if not cand:
            return
        ks, ps, cs = [], [], []
        for k, lm in enumerate(cand):
            w = lm.hp_W[3] if abs(lm.hp_W[3]) > 1e-12 else 1e-12
            p = lm.hp_W[:3] / w
            for (sid, _ci, _kp) in lm.obs:
                if sid in window:
                    ks.append(k)
                    ps.append(p)
                    cs.append(self.states[sid].pose[:3])
        if not ks:
            return
        ks = np.asarray(ks)
        d = np.asarray(ps) - np.asarray(cs)
        n = np.linalg.norm(d, axis=-1)
        keep = n > 1e-9
        ks, d, n = ks[keep], d[keep], n[keep]
        D = d / n[:, None]
        K = len(cand)
        M = np.zeros((K, 3, 3))
        np.add.at(M, ks, D[:, :, None] * D[:, None, :])
        count = np.bincount(ks, minlength=K)
        scored = count >= 2
        if not scored.any():
            return
        M_s = M[scored] / count[scored, None, None]
        ev = np.linalg.eigvalsh(M_s)
        quality = np.sqrt(np.maximum(ev[:, 0], 0.0))
        for q, k in zip(quality, np.nonzero(scored)[0]):
            lm = cand[k]
            lm.quality = float(q)
            if lm.quality > self.cfg.min_parallax_quality:
                lm.initialised = True

    # ------------------------------------------------------------------
    # marginalisation (applyStrategy, ViSlamBackend.cpp:451-710)
    # ------------------------------------------------------------------
    def apply_marginalisation_strategy(self):
        self._eliminate_imu_frames()
        self._convert_keyframes_to_pose_graph()
        self._freeze_and_shrink()

    def _eliminate_imu_frames(self):
        """Merge non-keyframe states older than the IMU-frame horizon into
        their successors' IMU buffers (eliminateStateByImuMerge,
        ViGraphEstimator.cpp:57-157)."""
        cfg = self.cfg
        # the newest num_imu_frames states are protected
        protected = set(self.window[-cfg.num_imu_frames:])
        for sid in list(self.window[:-cfg.num_imu_frames]):
            rec = self.states[sid]
            if rec.is_keyframe or sid in protected:
                continue
            idx = self.window.index(sid)
            if idx == 0 or idx >= len(self.window) - 1:
                continue
            nxt = self.states[self.window[idx + 1]]
            # remove its observations
            for lm in self.landmarks.values():
                for key in [k for k in lm.obs if k[0] == sid]:
                    del lm.obs[key]
            self._obs_rev += 1
            self._merge_imu_into_successor(sid, nxt)
            self._pre_cache.pop(sid, None)
            rec.in_window = False
            self.window.remove(sid)
            self._set_history_anchor(sid)

    def _merge_imu_into_successor(self, sid: int, nxt: StateRecord):
        """Merge state sid's IMU buffer into its chain successor and clear
        sid's own (ImuError::append consumes the eliminated segment,
        ViGraphEstimator.cpp:57-157)."""
        rec = self.states[sid]
        if nxt.imu_from != sid:
            # the window neighbour is not sid's chain successor: merge into
            # the actual successor if one still exists; clear only when the
            # chain is truly broken
            succ = next((s for s in self.states.values() if s.imu_from == sid), None)
            if succ is None:
                rec.imu_w = np.zeros((0, 3))
                rec.imu_a = np.zeros((0, 3))
                rec.imu_dt = np.zeros((0,))
                rec.imu_from = None
                return
            nxt = succ
        nxt.imu_w = np.concatenate([rec.imu_w, nxt.imu_w])
        nxt.imu_a = np.concatenate([rec.imu_a, nxt.imu_a])
        nxt.imu_dt = np.concatenate([rec.imu_dt, nxt.imu_dt])
        nxt.imu_from = rec.imu_from
        rec.imu_w = np.zeros((0, 3))
        rec.imu_a = np.zeros((0, 3))
        rec.imu_dt = np.zeros((0,))
        rec.imu_from = None
        self._pre_cache.pop(nxt.id, None)

    def _convert_keyframes_to_pose_graph(self, max_convert: int = 3):
        """Turn the least-covisible excess keyframes into pose-graph frames
        (convertToPoseGraphMst, ViGraphEstimator.cpp:319-574)."""
        cfg = self.cfg
        kf_in_window = [s for s in self.window
                        if self.states[s].is_keyframe and not self.states[s].is_pose_graph_frame]
        n_excess = len(kf_in_window) - cfg.num_keyframes
        if n_excess <= 0:
            return
        newest_kf = kf_in_window[-1]
        # covisibility of every frame with the newest keyframe, one pass
        cov_new = {s: 0 for s in kf_in_window[:-1]}
        for lm in self.landmarks.values():
            sids = {k[0] for k in lm.obs}
            if newest_kf in sids:
                for s in sids:
                    if s in cov_new:
                        cov_new[s] += 1
        to_convert = sorted(cov_new, key=cov_new.get)[: min(n_excess, max_convert)]
        for sid in to_convert:
            self._convert_one_keyframe(sid)

    def _convert_one_keyframe(self, sid: int):
        cfg = self.cfg
        rec = self.states[sid]
        # the reference keyframe: sid's neighbour in the covisibility
        # maximum spanning tree over {sid + window keyframes}
        # (convertToPoseGraphMst / buildMst, ViGraphEstimator.cpp:875-930)
        partners = {s: 0 for s in self.window if s != sid and self.states[s].is_keyframe}
        if not partners:
            # nothing to anchor against: just drop observations
            self._strip_observations(sid)
            rec.is_pose_graph_frame = True
            return
        nodes = [sid] + list(partners)
        node_idx = {s: i for i, s in enumerate(nodes)}
        pair_cov: Dict[Tuple[int, int], int] = {}
        node_set = set(nodes)
        for lm in self.landmarks.values():
            sids = sorted({k[0] for k in lm.obs} & node_set)
            for a_i in range(len(sids)):
                for b_i in range(a_i + 1, len(sids)):
                    key = (sids[a_i], sids[b_i])
                    pair_cov[key] = pair_cov.get(key, 0) + 1
        edges = [(node_idx[a], node_idx[b], w) for (a, b), w in pair_cov.items()]
        mst = max_spanning_tree(len(nodes), edges)
        # sid's neighbours in the MST; fall back to the strongest direct pair
        refs = [nodes[v] if nodes[u] == sid else nodes[u]
                for u, v, _ in mst if sid in (nodes[u], nodes[v])]
        if refs:
            ref = refs[0]
        else:
            for lm in self.landmarks.values():
                sids = {k[0] for k in lm.obs}
                if sid in sids:
                    for s in sids:
                        if s in partners:
                            partners[s] += 1
            ref = max(partners, key=partners.get)

        # shared observations (both frames' obs of common landmarks)
        lm_list = []
        for lid, lm in self.landmarks.items():
            keys_i = [k for k in lm.obs if k[0] == ref]
            keys_j = [k for k in lm.obs if k[0] == sid]
            if keys_i and keys_j and lm.initialised:
                lm_list.append(lid)
        lm_list = lm_list[: cfg.two_pose_lm_capacity]
        lm_idx = {lid: i for i, lid in enumerate(lm_list)}
        obs_rows = []
        stored = []
        for lid in lm_list:
            lm = self.landmarks[lid]
            for (s, ci, kp), (u, v, size) in lm.obs.items():
                if s == ref or s == sid:
                    obs_rows.append((0.0 if s == ref else 1.0, ci, lm_idx[lid], u, v, 8.0 / size))
                if s == sid:
                    stored.append((lid, s, ci, kp, u, v, size))

        if len(lm_list) >= 3 and len(obs_rows) >= 8:
            Oc = cfg.two_pose_obs_capacity
            Lc = cfg.two_pose_lm_capacity
            obs_arr = np.zeros((Oc, 6))
            obs_m = np.zeros(Oc, bool)
            n = min(len(obs_rows), Oc)
            obs_arr[:n] = np.asarray(obs_rows[:n])
            obs_m[:n] = True
            hp = np.zeros((Lc, 4))
            hp[:, 3] = 1.0
            lmm = np.zeros(Lc, bool)
            for lid, i in lm_idx.items():
                hp[i] = self.landmarks[lid].hp_W
                lmm[i] = True
            t = lambda x: torch.as_tensor(x, dtype=self.dtype, device=self.device)  # noqa: E731
            b = lambda x: torch.as_tensor(x, device=self.device)  # noqa: E731
            out = compute_two_pose_factor(
                t(self.states[ref].pose), t(rec.pose), t(np.stack(self.T_SC)), t(hp),
                t(obs_arr), b(obs_m), b(lmm), self.cameras,
            )
            self.pose_graph_edges.append(PoseGraphEdge(
                ref, sid, out["T_ij"].cpu().numpy(), out["sqrt_info"].cpu().numpy(), stored,
                "marg"))
        # remove this frame's observations from the live graph
        self._strip_observations(sid)
        rec.is_pose_graph_frame = True

    def reactivate_loop_states(self, chain: List[int]) -> int:
        """Re-admit the oldest ``num_loop_closure_frames`` states of a
        closed loop into the window, unfrozen (addLoopClosureFrame's
        loop-span unfreeze, ViSlamBackend.cpp:1284-1409; numLoopClosureFrames,
        config/euroc.yaml:77). Returns how many joined the window."""
        n = self.cfg.num_loop_closure_frames
        if n <= 0:
            return 0
        added = 0
        for sid in chain[:n]:
            rec = self.states.get(sid)
            if rec is None:
                continue
            rec.frozen = False
            if sid not in self.window:
                rec.in_window = True
                pos = 0  # keep the window time-ordered
                while pos < len(self.window) and self.window[pos] < sid:
                    pos += 1
                self.window.insert(pos, sid)
                added += 1
        return added

    def expand_keyframe(self, sid: int, min_shared: int = 12) -> bool:
        """Frontier re-activation (expandKeyframe, ViSlamBackend.cpp:
        357-406): when the current keyframe re-observes landmarks stored in
        a pose-graph frame's marginalisation edge, convert that edge back
        into live observations and return the frame to the window."""
        lms_cur = {lid for (lid, _c, _k) in self.obs_of_state(sid)}
        if not lms_cur:
            return False
        best, best_n = None, 0
        for e in self.pose_graph_edges:
            if e.kind != "marg" or not e.stored_obs:
                continue
            target = e.id_j
            if target in self.window or target not in self.states:
                continue
            n = sum(1 for o in e.stored_obs if o[0] in lms_cur)
            if n > best_n:
                best, best_n = e, n
        if best is None or best_n < min_shared:
            return False
        for (lid, s, ci, kp, u, v, size) in best.stored_obs:
            if lid in self.landmarks and s in self.states:
                self.landmarks[lid].obs[(s, ci, kp)] = (u, v, size)
        self._obs_rev += 1
        self.pose_graph_edges.remove(best)
        rec = self.states[best.id_j]
        rec.frozen = False
        rec.is_pose_graph_frame = False
        if best.id_j not in self.window:
            rec.in_window = True
            pos = 0
            while pos < len(self.window) and self.window[pos] < best.id_j:
                pos += 1
            self.window.insert(pos, best.id_j)
        return True

    def _strip_observations(self, sid: int):
        for lm in self.landmarks.values():
            for key in [k for k in lm.obs if k[0] == sid]:
                del lm.obs[key]
        self._obs_rev += 1

    def _freeze_and_shrink(self):
        """Freeze old pose-graph frames; drop states from the window when
        all their constraints are frozen (freezePosesUntil,
        ViGraphEstimator.cpp:201-318)."""
        cfg = self.cfg
        pg = [s for s in self.window if self.states[s].is_pose_graph_frame]
        # keep the newest num_pose_graph_frames unfrozen
        for sid in pg[:-cfg.num_pose_graph_frames] if cfg.num_pose_graph_frames else pg:
            self.states[sid].frozen = True
        # drop frozen pose-graph frames whose edges all touch frozen states
        for sid in list(self.window):
            rec = self.states[sid]
            if not (rec.is_pose_graph_frame and rec.frozen):
                continue
            partners_unfrozen = any(
                (e.id_i == sid and not self.states[e.id_j].frozen)
                or (e.id_j == sid and not self.states[e.id_i].frozen)
                for e in self.pose_graph_edges
            )
            has_obs = any(any(k[0] == sid for k in lm.obs) for lm in self.landmarks.values())
            if not partners_unfrozen and not has_obs:
                self._drop_from_window(sid)
        # hard cap: force-drop the oldest frozen states beyond capacity
        while len(self.window) > cfg.window_slots:
            for sid in self.window:
                if self.states[sid].frozen:
                    self._drop_from_window(sid)
                    break
            else:
                # nothing frozen to drop: freeze the oldest
                self.states[self.window[0]].frozen = True

    def _drop_from_window(self, sid: int):
        """Remove a state from the window keeping the IMU chain sound:
        plain IMU frames merge their buffer into the window successor;
        keyframes and pose-graph frames keep theirs (the pack masks the
        now non-adjacent link)."""
        rec = self.states[sid]
        idx = self.window.index(sid)
        if (not rec.is_keyframe and not rec.is_pose_graph_frame
                and 0 < idx < len(self.window) - 1):
            self._merge_imu_into_successor(sid, self.states[self.window[idx + 1]])
        self._pre_cache.pop(sid, None)
        rec.in_window = False
        self.window.remove(sid)
        if not rec.is_keyframe and not rec.is_pose_graph_frame:
            self._set_history_anchor(sid)

    # ------------------------------------------------------------------
    def _set_history_anchor(self, sid: int):
        """A non-keyframe state leaving the optimised graph records its
        pose relative to the nearest (by time) keyframe or pose-graph state
        still in the window; ``trajectory()`` recomposes through it."""
        rec = self.states[sid]
        best, best_dt = None, float("inf")
        for s in self.window:
            r = self.states[s]
            if not (r.is_keyframe or r.is_pose_graph_frame):
                continue
            dt = abs(r.t - rec.t)
            if dt < best_dt:
                best, best_dt = s, dt
        if best is None:
            return  # no optimised anchor exists (startup): keep absolute
        rec.anchor_id = best
        rec.T_anchor7 = se3_np.compose7(se3_np.inverse7(self.states[best].pose), rec.pose)

    def get_pose(self, sid: int) -> np.ndarray:
        return self.states[sid].pose

    def trajectory(self) -> List[Tuple[float, np.ndarray]]:
        out = []
        for s in self.state_order:
            rec = self.states[s]
            if rec.anchor_id is not None and rec.anchor_id in self.states:
                pose = se3_np.compose7(self.states[rec.anchor_id].pose, rec.T_anchor7)
            else:
                pose = rec.pose
            out.append((rec.t, pose))
        return out


_warn_counts: Dict[str, int] = {}


def _warn_capacity(key: str, msg: str):
    """Log capacity-bound truncation, rate-limited with exponential
    backoff: occurrences 1, 64, 512, 4096, ..."""
    n = _warn_counts.get(key, 0)
    _warn_counts[key] = n + 1
    if n == 0 or n == 64 or (n >= 512 and (n & (n - 1)) == 0):
        logging.getLogger("okvis2_torch").warning("%s (x%d)", msg, n + 1)
