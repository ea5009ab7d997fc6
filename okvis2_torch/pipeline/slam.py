"""SLAM system orchestration: the synchronous frame loop.

Port of ``okvis2_tpu/pipeline/slam.py`` with ``pipelined=False`` (the
ThreadedSlam role; reference: okvis_multisensor_processing/src/
ThreadedSlam.cpp:267-568 processFrame, :570-804
optimisePublishMarginalise). ``add_images`` / ``add_imu_measurement``
feed time-ordered queues; ``process_frame`` pops the next frame set and,
per frame:

1. adds a state propagated by IMU (one solve behind: the prediction starts
   from the pose before the previous frame's solve is applied);
2. runs the frontend's tracking program on that prediction
   (``Frontend.associate_frame``);
3. applies the previous frame's solve and re-predicts the new state;
4. decides on a keyframe, and on a keyframe runs static stereo, the
   descriptor fetch, the keyframe store and keyframe expansion;
5. solves the window (its result lands at step 3 of the next frame);
6. marginalises; 7. rates tracking and re-initialises when it is lost.

Not ported here: the pipelined loop (``pipelined=True``, ROADMAP A.11),
loop closure (``do_loop_closures``, A.12), CNN suppression
(``cnn_params``, A.14), depth-aided initialisation (``add_depth_image``,
A.15), map save/load (A.12) and the CSV taps; each raises
``NotImplementedError`` where it has an entry point.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Callable, Deque, List, Optional, Tuple

import numpy as np

from okvis2_torch import resolve_device
from okvis2_torch.graph.estimator import Estimator, EstimatorConfig
from okvis2_torch.imu.preintegration import ImuParameters
from okvis2_torch.pipeline.frontend_pipeline import Frontend, FrontendConfig
from okvis2_torch.utils.timing import SwitchableTimer


@dataclasses.dataclass
class TrackingState:
    """Mirror of okvis::TrackingState (ViInterface.hpp:143-180)."""

    id: int = -1
    is_keyframe: bool = False
    tracking_quality: str = "Good"  # Good | Marginal | Lost
    current_keyframe_id: int = -1


class SlamSystem:
    """End-to-end VIO pipeline on one device, synchronous loop.

    ``cameras``: PinholeCamera per camera (the solve runs in their
    dtype); ``extrinsics``: Transformation per camera. ``ransac_sampler``
    is the frontend's per-frame RANSAC hook (``Frontend``). Runs on
    ``device`` (None: the CUDA card; raises without one)."""

    def __init__(
        self,
        cameras,
        extrinsics: list,
        imu_params: ImuParameters,
        estimator_config: EstimatorConfig = EstimatorConfig(),
        frontend_config: FrontendConfig = FrontendConfig(),
        do_loop_closures: bool = False,
        loop_closure_config=None,
        cnn_params=None,
        pipelined: bool = False,
        device=None,
        ransac_sampler=None,
    ):
        if pipelined:
            raise NotImplementedError(
                "okvis2_torch: the pipelined frame loop is not ported yet (ROADMAP A.11)")
        if do_loop_closures or loop_closure_config is not None:
            raise NotImplementedError(
                "okvis2_torch: loop closure and the full graph are not ported yet (ROADMAP A.12)")
        if cnn_params is not None:
            raise NotImplementedError(
                "okvis2_torch: CNN suppression is not ported yet (ROADMAP A.14)")
        self.device = resolve_device(device)
        self.pipelined = False
        self.estimator = Estimator(cameras, extrinsics, imu_params, estimator_config,
                                   device=self.device)
        self.frontend = Frontend(cameras, extrinsics, frontend_config, device=self.device,
                                 ransac_sampler=ransac_sampler)
        self.imu_params = imu_params
        self._imu_queue: Deque[Tuple[float, np.ndarray, np.ndarray]] = collections.deque()
        self._image_queue: Deque[Tuple[float, List[np.ndarray]]] = collections.deque()
        self._last_frame_t: Optional[float] = None
        self._callbacks: List[Callable] = []
        self._lost_count = 0
        self.tracking = TrackingState()
        self.frames_processed = 0

    # ------------------------------------------------------------------
    # ViInterface-equivalent inputs
    # ------------------------------------------------------------------
    def add_imu_measurement(self, t: float, accel, gyro) -> bool:
        self._imu_queue.append(
            (float(t), np.asarray(accel, np.float64), np.asarray(gyro, np.float64)))
        return True

    def add_images(self, t: float, images: List[np.ndarray]) -> bool:
        self._image_queue.append((float(t), images))
        return True

    def add_depth_image(self, t: float, depth: np.ndarray, cam_idx: int = 0) -> bool:
        raise NotImplementedError(
            "okvis2_torch: depth-aided landmark initialisation is not ported yet (ROADMAP A.15)")

    def set_optimised_graph_callback(self, cb: Callable):
        self._callbacks.append(cb)

    # ------------------------------------------------------------------
    def _gather_imu(self, t0: Optional[float], t1: float):
        """The trapezoid IMU segment spanning exactly [t0, t1]: boundary
        measurements are linearly interpolated at the state timestamps
        (ImuError.cpp:318-334), so the preintegrated span matches the
        camera timestamps (ThreadedSlam.cpp:276-341 role)."""
        # keep one sample beyond each boundary for interpolation
        meas = [m for m in self._imu_queue
                if (t0 is None or m[0] > t0 - 0.05) and m[0] <= t1 + 0.05]
        # drop consumed entries well before t1 (keep overlap for the next
        # segment's left-boundary interpolation)
        while self._imu_queue and self._imu_queue[0][0] < t1 - 0.5:
            self._imu_queue.popleft()
        if len(meas) < 2:
            return np.zeros((0, 3)), np.zeros((0, 3)), np.zeros((0,))
        ts = np.asarray([m[0] for m in meas])
        acc = np.stack([m[1] for m in meas])
        gyr = np.stack([m[2] for m in meas])
        if t0 is None:
            # first frame: raw averages up to t1 (only used for the
            # gravity-aligned initial pose)
            sel = ts <= t1 + 0.005
            ts, acc, gyr = ts[sel], acc[sel], gyr[sel]
            if len(ts) < 2:
                return np.zeros((0, 3)), np.zeros((0, 3)), np.zeros((0,))
            w_avg = 0.5 * (gyr[:-1] + gyr[1:])
            a_avg = 0.5 * (acc[:-1] + acc[1:])
            dt = np.diff(ts)
            keep = dt > 0
            return w_avg[keep], a_avg[keep], dt[keep]
        # sample times: t0, interior measurements, t1 (np.interp clamps to
        # the edge values outside the measured range)
        interior = ts[(ts > t0) & (ts < t1)]
        tq = np.concatenate([[t0], interior, [t1]])
        g_at = np.stack([np.interp(tq, ts, gyr[:, i]) for i in range(3)], -1)
        a_at = np.stack([np.interp(tq, ts, acc[:, i]) for i in range(3)], -1)
        w_avg = 0.5 * (g_at[:-1] + g_at[1:])
        a_avg = 0.5 * (a_at[:-1] + a_at[1:])
        dt = np.diff(tq)
        keep = dt > 0
        return w_avg[keep], a_avg[keep], dt[keep]

    # ------------------------------------------------------------------
    def process_frame(self) -> bool:
        """Process the next queued frame set. Returns False if none."""
        return self._process_frame_sync()

    def _note_pose_correction(self, T_corr7):
        """A host-pose rewrite outside the solve flow (``T_corr7``: a rigid
        world-frame correction, or None). The synchronous loop, like the
        JAX package's, still applies the one pending solve after it; the
        pipelined loop (ROADMAP A.11) records correction epochs here."""

    def _keyframe_tail(self, sid, frames, images):
        """Host keyframe work after the descriptor fetch: frontier
        expansion (expandKeyframe, ViSlamBackend.cpp:357-406). Returns the
        detected loop keyframe id: always None, loop closure is not
        ported."""
        self.estimator.expand_keyframe(sid)
        return None

    def finish(self):
        """Nothing is in flight in the synchronous loop. As in the JAX
        package's synchronous loop, the last frame's solve stays pending
        and is not applied."""

    def _process_frame_sync(self) -> bool:
        if not self._image_queue:
            return False
        t, images = self._image_queue.popleft()
        est = self.estimator

        imu_w, imu_a, imu_dt = self._gather_imu(self._last_frame_t, t)
        self._last_frame_t = t
        sid = est.add_state(t, imu_w, imu_a, imu_dt)
        # the IMU-propagated prediction, one solve stale: the previous
        # frame's solve is applied after the frontend (and the state
        # re-predicted), where the JAX loop applies it
        T_WS_pred7 = est.states[sid].pose
        pending = est.take_pending_solve()

        with SwitchableTimer("1 frontend (fused)"):
            frames, m = self.frontend.associate_frame(
                est, images, sid, T_WS_pred7,
                extra_flat=pending[0] if pending is not None else None)
        if pending is not None:
            with SwitchableTimer("0 apply previous solve"):
                est.apply_solved_flat(m["extra"], pending[1], pending[2])
                est.repredict_from_previous(sid)
            if est.cfg.online_extrinsics:
                # calibrated extrinsics feed back into the frontend's
                # projection and epipolar geometry
                self.frontend.T_SC_np = [r.copy() for r in est.T_SC]
        self._frame_epilogue(t, sid, frames, m, images)
        self.frames_processed += 1
        return True

    def _frame_epilogue(self, t, sid, frames, m, images):
        """Keyframe work, the window solve, marginalisation, tracking state
        and callbacks."""
        est = self.estimator
        # keyframe decision (before stereo initialisation, like the
        # reference)
        is_kf = self.frontend.need_new_keyframe(est, frames, sid)
        est.set_keyframe(sid, is_kf)
        if is_kf:
            self.frontend.last_keyframe_id = sid
            with SwitchableTimer("2.05 keyframe extras"):
                self.frontend.fetch_signs(frames)
                self.frontend.match_stereo(est, frames, sid)
                self.frontend.remember_keyframe_frames(sid, frames)
            self._keyframe_tail(sid, frames, images)

        # the realtime window solve; its result is applied in the next frame
        with SwitchableTimer("3 optimise dispatch"):
            est.optimise_async()

        # marginalisation strategy (host bookkeeping, on the state as of
        # the last applied solve, like the reference's applyStrategy)
        with SwitchableTimer("5 marginalise"):
            est.apply_marginalisation_strategy()
            est.clean_unobserved_landmarks()

        # tracking state + callbacks; lost-tracking recovery (thresholds as
        # ThreadedSlam.cpp:628-634; restart as Frontend.cpp:1048-1055)
        q = self.frontend.tracking_quality(est, frames, sid)
        quality = "Good" if q > 0.05 else ("Marginal" if q > 0.01 else "Lost")
        if quality == "Lost" and self.frames_processed > 5:
            self._lost_count += 1
            if self._lost_count >= 5:
                self._reinitialise()
        else:
            self._lost_count = 0
        self.tracking = TrackingState(
            id=sid, is_keyframe=is_kf, tracking_quality=quality,
            current_keyframe_id=self.frontend.last_keyframe_id or -1,
        )
        for cb in self._callbacks:
            cb(t, sid, est.states[sid].pose.copy(), self.tracking)

    # ------------------------------------------------------------------
    def _reinitialise(self):
        """Tracking lost for several frames: keep the trajectory history
        but restart the landmark map and the window from the current
        state."""
        est = self.estimator
        keep = est.window[-1:]
        for sid in est.window[:-1]:
            est.states[sid].in_window = False
        est.window = list(keep)
        est.landmarks.clear()
        est._by_state.clear()
        est._obs_rev += 1
        est.pose_graph_edges.clear()
        self.frontend.lm_descriptors.clear()
        self.frontend.last_keyframe_id = None
        self._lost_count = 0
        # landmark map restarted: a solve packed before must not apply
        self._note_pose_correction(None)

    # ------------------------------------------------------------------
    def trajectory(self):
        self.finish()
        return self.estimator.trajectory()
