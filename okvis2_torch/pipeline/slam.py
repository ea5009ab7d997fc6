"""SLAM system orchestration: the synchronous and the pipelined frame loops.

Port of ``okvis2_tpu/pipeline/slam.py`` (the ThreadedSlam role;
reference: okvis_multisensor_processing/src/ThreadedSlam.cpp:267-568
processFrame, :570-804 optimisePublishMarginalise). ``add_images`` /
``add_imu_measurement`` feed time-ordered queues; ``process_frame`` pops
the next frame set.

The synchronous loop (``pipelined=False``), per frame:

1. adds a state propagated by IMU (one solve behind: the prediction starts
   from the pose before the previous frame's solve is applied);
2. runs the frontend's tracking program on that prediction
   (``Frontend.associate_frame``);
3. applies the previous frame's solve and re-predicts the new state;
4. decides on a keyframe, and on a keyframe runs static stereo, the
   descriptor fetch, the keyframe store and keyframe expansion;
5. solves the window (its result lands at step 3 of the next frame);
6. marginalises; 7. rates tracking and re-initialises when it is lost.

The pipelined loop (``pipelined=True``, the JAX bench's loop) never waits
for the device on the way in. Per frame it finishes the frames whose
solves have come back (oldest first; it waits for the oldest only when
more than MAX_APPEND_SETS - 2 are still in flight), predicts from the
newest consumed solve, dispatches the tracking program, and hands the
window solve to the estimator's solve worker: the solve appends, on the
device, the match rows of every frame still in flight (the host has not
inserted them yet) and returns [solve | the frame's diagnostics] as one
copy. Host bookkeeping (observations, the solve's application, keyframe
work, marginalisation, callbacks) runs one or two frames behind the
device (``_finish_one``). A keyframe's static stereo and descriptor fetch
start at its finish and are consumed at the next one. Pose rewrites
outside the solve flow are recorded as correction epochs
(``_note_pose_correction``), so a solve dispatched before one is composed
with it or skipped. ``finish()`` drains the loop.

Not ported here: loop closure (``do_loop_closures``, ROADMAP A.12), CNN
suppression (``cnn_params``, A.14), depth-aided initialisation
(``add_depth_image``, A.15), map save/load (A.12), the CSV taps and the
JAX bench's frame capture for its device-loop replay; each raises
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
from okvis2_torch.core import se3_np
from okvis2_torch.pipeline.frontend_pipeline import Frontend, FrontendConfig
from okvis2_torch.solver.packed_solve import MAX_APPEND_SETS
from okvis2_torch.utils.timing import SwitchableTimer


@dataclasses.dataclass
class TrackingState:
    """Mirror of okvis::TrackingState (ViInterface.hpp:143-180)."""

    id: int = -1
    is_keyframe: bool = False
    tracking_quality: str = "Good"  # Good | Marginal | Lost
    current_keyframe_id: int = -1


class SlamSystem:
    """End-to-end VIO pipeline on one device, synchronous or pipelined loop.

    ``cameras``: PinholeCamera per camera (the solve runs in their
    dtype); ``extrinsics``: Transformation per camera. ``ransac_sampler``
    is the frontend's per-frame RANSAC hook (``Frontend``). Runs on
    ``device`` (None: the CUDA card; raises without one)."""

    # _net_correction_since's "skip this solve" answer
    _CORR_SKIP = object()

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
        if do_loop_closures or loop_closure_config is not None:
            raise NotImplementedError(
                "okvis2_torch: loop closure and the full graph are not ported yet (ROADMAP A.12)")
        if cnn_params is not None:
            raise NotImplementedError(
                "okvis2_torch: CNN suppression is not ported yet (ROADMAP A.14)")
        self.device = resolve_device(device)
        self.pipelined = pipelined
        # in-flight frames of the pipelined loop, oldest first: dispatched,
        # solve running or done, host bookkeeping not yet run
        self._pending_frames: Deque[dict] = collections.deque()
        self._pending_kf: Optional[dict] = None  # a keyframe's deferred extras
        # test hook: keep at least this many frames in flight
        self._force_min_pending = 0
        # pose-correction epochs: every host-pose rewrite outside the solve
        # flow appends an entry (a rigid 7-vector, or None)
        self._corr_epoch = 0
        self._corr_log: List[Optional[np.ndarray]] = []
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
        if self.pipelined:
            return self._process_frame_pipelined()
        return self._process_frame_sync()

    def _process_frame_pipelined(self) -> bool:
        """The pipelined loop's frame (see the module docstring):

        1. finish every in-flight frame whose solve has come back, oldest
           first, without waiting; wait for the oldest only while more
           than MAX_APPEND_SETS - 2 frames would stay in flight;
        2. add the state and predict it from the newest consumed solve;
        3. prepare the frame's inputs and pack the window from the host's
           (lagged) records, with the slot maps of every frame in flight;
        4. upload the pack, dispatch the tracking program, and hand the
           fused append + solve to the solve worker (on the card: its own
           stream, after the frame program)."""
        if not self._image_queue:
            return False
        t, images = self._image_queue.popleft()
        est = self.estimator
        with SwitchableTimer("0 consume finished frames"):
            self._consume_pending(max_left=MAX_APPEND_SETS - 2)
        with SwitchableTimer("0.5 imu + predict"):
            imu_w, imu_a, imu_dt = self._gather_imu(self._last_frame_t, t)
            self._last_frame_t = t
            # frames still in flight contribute IMU propagation only
            sid = est.add_state(t, imu_w, imu_a, imu_dt)
            T_WS_pred7 = est.states[sid].pose
        with SwitchableTimer("1 prep"):
            prep = self.frontend.prepare_frame(est, images, sid, T_WS_pred7)
            sets = [{"sid": p["sid"], "slot_lid": p["ctx"]["slot_lid"]}
                    for p in self._pending_frames] + [{"sid": sid, "slot_lid": prep["slot_lid"]}]
            prob_np, scfg, aux = est.prepare_fused_solve(sid, self.frontend.table, sets)
        with SwitchableTimer("2 upload + dispatches"):
            # the upload first: a copy from pageable memory waits for the
            # stream, which the frame program would hold
            problem, aux_dev = est.upload_fused_solve(prob_np, aux)
            ctx = self.frontend.dispatch_prepared(prep)
            match_sets = [p["ctx"]["match"] for p in self._pending_frames] + [ctx["match"]]
            # padding sets are disabled by their all -1 slot maps
            match_sets += [ctx["match"]] * (MAX_APPEND_SETS - len(match_sets))
            job = est.dispatch_fused_solve(problem, aux_dev, match_sets, ctx["diag"], scfg)
        self._pending_frames.append({
            "t": t, "sid": sid, "ctx": ctx, "job": job, "n_sets": aux["n_sets"],
            "solve_t0": est._solve_t0, "slot_of": dict(est._slot_of),
            "lm_ids": list(est._lm_ids), "images": images, "epoch": self._corr_epoch,
        })
        self.frames_processed += 1
        return True

    def _consume_pending(self, max_left: int):
        """Finish in-flight frames, oldest first: every frame whose solve
        has come back is consumed without waiting; while more than
        ``max_left`` frames would remain in flight, wait for the oldest.
        ``max_left=0`` drains the loop."""
        q = self._pending_frames
        while q:
            if max_left > 0 and len(q) <= self._force_min_pending:
                break
            p = q[0]
            if not p["job"]["future"].done() and len(q) <= max_left:
                break
            q.popleft()
            self._finish_one(p)

    def _note_pose_correction(self, T_corr7):
        """Record a host-pose rewrite outside the solve flow: ``T_corr7``,
        the world-frame left correction, when the rewrite is rigid (the
        whole session moved by one transform), or None when it is not.
        ``_finish_one`` composes rigid corrections onto the solves in
        flight and skips solves a non-rigid rewrite made stale."""
        self._corr_log.append(None if T_corr7 is None
                              else np.asarray(T_corr7, np.float64).copy())
        self._corr_epoch += 1

    def _net_correction_since(self, epoch):
        """The net pose correction applied since ``epoch``: None (nothing),
        a 7-vector (compose onto the solve), or ``_CORR_SKIP`` (a non-rigid
        rewrite happened: the stale solve must not apply)."""
        entries = self._corr_log[epoch:]
        if not entries:
            return None
        if any(e is None for e in entries):
            return SlamSystem._CORR_SKIP
        net = entries[0]
        for e in entries[1:]:  # later corrections left-compose
            net = se3_np.compose7(e, net)
        return net

    def _keyframe_tail(self, sid, frames, images):
        """Host keyframe work after the descriptor fetch: frontier
        expansion (expandKeyframe, ViSlamBackend.cpp:357-406). Returns the
        detected loop keyframe id: always None, loop closure is not
        ported."""
        self.estimator.expand_keyframe(sid)
        return None

    def _finish_deferred_keyframe(self):
        """Pipelined loop: consume the previous keyframe's deferred extras
        (their copies have been crossing since its finish) and run the
        keyframe tail."""
        pk = self._pending_kf
        if pk is None:
            return
        self._pending_kf = None
        if pk["sid"] not in self.estimator.states:
            return  # the keyframe's state left the graph meanwhile
        with SwitchableTimer("2.05 keyframe extras finish"):
            self.frontend.finish_keyframe_extras(self.estimator, pk)
            self._keyframe_tail(pk["sid"], pk["frames"], pk["images"])

    def _finish_one(self, p):
        """Consume one in-flight frame's [solve | diag] output and run its
        host bookkeeping: observations, the solve's application, keyframe
        work, marginalisation, callbacks: the lagged half of the pipelined
        loop."""
        est = self.estimator
        # the previous keyframe's deferred extras precede this frame's
        # bookkeeping (its staged descriptor sources must stay aligned)
        self._finish_deferred_keyframe()
        with SwitchableTimer("0.1 lagged [solve|diag] fetch"):
            out = p["job"]["future"].result()  # raises the solve's exception
        n_solve = est.solve_out_size()
        with SwitchableTimer("0.2 finish bookkeeping"):
            frames, m = self.frontend.finish_frame(est, p["ctx"], out[n_solve:])
            corr = self._net_correction_since(p["epoch"])
            # a non-rigid pose rewrite after this frame's dispatch makes its
            # solve stale: skip it, the next solve was packed from the
            # corrected state
            if corr is not SlamSystem._CORR_SKIP:
                est.apply_solved_flat(out[:n_solve], p["slot_of"], p["lm_ids"], T_corr7=corr,
                                      solve_t0=p["solve_t0"])
        if est.cfg.online_extrinsics:
            self.frontend.T_SC_np = [r.copy() for r in est.T_SC]
        with SwitchableTimer("0.3 epilogue"):
            self._frame_epilogue(p["t"], p["sid"], frames, m, p["images"], dispatch_solve=False)

    def finish(self):
        """Drain the pipelined loop: finish every in-flight frame, then a
        last keyframe's deferred extras. In the synchronous loop nothing is
        in flight and, as in the JAX package's, the last frame's solve
        stays pending and is not applied."""
        self._consume_pending(max_left=0)
        self._finish_deferred_keyframe()

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
        self._frame_epilogue(t, sid, frames, m, images, dispatch_solve=True)
        self.frames_processed += 1
        return True

    def _frame_epilogue(self, t, sid, frames, m, images, dispatch_solve: bool):
        """Keyframe work, (optionally) the window solve, marginalisation,
        tracking state and callbacks: shared by both loops."""
        est = self.estimator
        # keyframe decision (before stereo initialisation, like the
        # reference)
        is_kf = self.frontend.need_new_keyframe(est, frames, sid)
        est.set_keyframe(sid, is_kf)
        if is_kf:
            self.frontend.last_keyframe_id = sid
            if self.pipelined:
                # start static stereo and the descriptor copy now; the
                # keyframe tail runs at the next finish
                with SwitchableTimer("2.05 keyframe extras dispatch"):
                    pk = self.frontend.dispatch_keyframe_extras(est, frames, sid)
                    pk["images"] = images
                    self._pending_kf = pk
            else:
                with SwitchableTimer("2.05 keyframe extras"):
                    self.frontend.finish_keyframe_extras(
                        est, self.frontend.dispatch_keyframe_extras(est, frames, sid))
                self._keyframe_tail(sid, frames, images)

        # the realtime window solve; its result is applied in the next
        # frame. The pipelined loop dispatched its solve with the frame.
        if dispatch_solve:
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
