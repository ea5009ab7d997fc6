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
with it or skipped. ``finish()`` drains the loop and ends the solve
worker.

Loop closure (``do_loop_closures``, ``pipeline/full_graph.py``): each
keyframe's tail queries place recognition and registers the keyframe. The
synchronous loop closes a detected loop at once and solves the full graph
inline; the pipelined loop closes it when the keyframe's deferred extras
are consumed, queues the full-graph solve on the solve worker behind the
realtime solves, and applies it at the next finished frame. Both record a
non-rigid correction epoch, so realtime solves packed before it are
skipped.

Multi-session (``save_map`` / ``load_map``, ``pipeline/component_io.py``):
a loaded map's landmarks enter the estimator and the device descriptor
table; with loop closure on, each keyframe's tail also relocalises against
the map's own place-recognition database, and a verified pose moves the
whole session rigidly onto the map's frame (a rigid correction epoch,
composed onto the solves in flight). ``add_depth_image`` enables
depth-aided landmark initialisation at the next keyframe. ``do_final_ba``
is the offline final bundle adjustment (``pipeline/final_ba.py``); like
the JAX package's it does not drain the loop, so call ``finish()`` first.

CNN suppression (``cnn_params``, ``models/suppression.py``): each
keyframe's tail segments its images with Fast-SCNN on the device and sets
the information of landmarks seen on sky or person pixels to 1e-4, after
keyframe expansion and before place recognition (inline in the
synchronous loop, one frame deferred in the pipelined one). With ``mesh``
(``parallel.make_mesh``), ``do_final_ba`` runs the landmark-sharded solve
over the mesh's process group; every rank calls it on the same session.

Debug CSV taps (``set_imu_csv_file``, ``set_tracks_csv_file``;
ViInterface::setImuCsvFile / setTracksCsvFile) write each IMU sample as it
is added and each frame's tracking record as its callbacks run, in the JAX
package's format; the files are line-buffered.

Frame capture (``_bench_record``, the JAX bench's hook): when it is a list,
the pipelined loop appends one record per frame of what the frame's
dispatches read (``device_replay.capture``), and
``device_replay.replay_device_loop`` runs those frames again with every
input already on the device. Absent or None, nothing is recorded.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Callable, Deque, List, Optional, Tuple

import numpy as np
import torch

from okvis2_torch import resolve_device
from okvis2_torch.graph.estimator import Estimator, EstimatorConfig
from okvis2_torch.imu.preintegration import ImuParameters
from okvis2_torch.core import se3_np
from okvis2_torch.models import suppression
from okvis2_torch.pipeline import device_replay
from okvis2_torch.pipeline.component_io import load_component, save_component
from okvis2_torch.pipeline.final_ba import do_final_ba
from okvis2_torch.pipeline.frontend_pipeline import Frontend, FrontendConfig
from okvis2_torch.pipeline.full_graph import LoopClosureBackend, LoopClosureConfig
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
    is the frontend's per-frame RANSAC hook (``Frontend``),
    ``loop_ransac_sampler`` loop verification's (``LoopClosureBackend``).
    Runs on ``device`` (None: the CUDA card; raises without one)."""

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
        loop_ransac_sampler=None,
    ):
        self.device = resolve_device(device)
        self.pipelined = pipelined
        # in-flight frames of the pipelined loop, oldest first: dispatched,
        # solve running or done, host bookkeeping not yet run
        self._pending_frames: Deque[dict] = collections.deque()
        self._pending_kf: Optional[dict] = None  # a keyframe's deferred extras
        # test hook: keep at least this many frames in flight
        self._force_min_pending = 0
        # frame capture for the device-loop replay (device_replay): a list
        # takes one record per pipelined frame
        self._bench_record: Optional[list] = None
        # pose-correction epochs: every host-pose rewrite outside the solve
        # flow appends an entry (a rigid 7-vector, or None)
        self._corr_epoch = 0
        self._corr_log: List[Optional[np.ndarray]] = []
        self.estimator = Estimator(cameras, extrinsics, imu_params, estimator_config,
                                   device=self.device)
        self.frontend = Frontend(cameras, extrinsics, frontend_config, device=self.device,
                                 ransac_sampler=ransac_sampler)
        self.imu_params = imu_params
        self.loop_backend: Optional[LoopClosureBackend] = None
        if do_loop_closures:
            self.loop_backend = LoopClosureBackend(
                cameras, extrinsics, loop_closure_config or LoopClosureConfig(),
                device=self.device, sampler=loop_ransac_sampler)
        self.cnn: Optional[suppression.CnnSuppressor] = None
        if cnn_params is not None:
            self.cnn = suppression.CnnSuppressor(cnn_params, device=self.device)
        self._imu_queue: Deque[Tuple[float, np.ndarray, np.ndarray]] = collections.deque()
        self._image_queue: Deque[Tuple[float, List[np.ndarray]]] = collections.deque()
        self._last_frame_t: Optional[float] = None
        self._callbacks: List[Callable] = []
        self._imu_csv = None
        self._tracks_csv = None
        self._lost_count = 0
        # multi-session: the landmarks of loaded maps (a relocalisation moves
        # the session, not them), the relocalisations applied, the latest
        # aligned depth frame (t, cam, depth)
        self._loaded_lids: set = set()
        self._relocalisations = 0
        self._latest_depth: Optional[Tuple[float, int, np.ndarray]] = None
        self.tracking = TrackingState()
        self.frames_processed = 0

    # ------------------------------------------------------------------
    # ViInterface-equivalent inputs
    # ------------------------------------------------------------------
    def add_imu_measurement(self, t: float, accel, gyro) -> bool:
        self._imu_queue.append(
            (float(t), np.asarray(accel, np.float64), np.asarray(gyro, np.float64)))
        if self._imu_csv is not None:
            g, a = np.asarray(gyro), np.asarray(accel)
            self._imu_csv.write(f"{int(round(t * 1e9))},{g[0]:.9f},{g[1]:.9f},{g[2]:.9f},"
                                f"{a[0]:.9f},{a[1]:.9f},{a[2]:.9f}\n")
        return True

    def add_images(self, t: float, images: List[np.ndarray]) -> bool:
        self._image_queue.append((float(t), images))
        return True

    def add_depth_image(self, t: float, depth: np.ndarray, cam_idx: int = 0) -> bool:
        """An aligned depth frame [H,W] in metres (the RealsenseRgbd path):
        enables depth-aided landmark initialisation at the next keyframe."""
        self._latest_depth = (float(t), cam_idx, np.asarray(depth))
        return True

    def _init_landmarks_from_depth(self, frames, sid: int) -> int:
        """Landmarks for the keypoints of the depth frame's camera that host
        none, at ray * depth / ray_z from the aligned depth map (the
        reference's depth-aided frontend for RGBD rigs); rays are
        back-projected on the estimator's device. Returns the number
        added."""
        if self._latest_depth is None:
            return 0
        t_d, ci, depth = self._latest_depth
        est = self.estimator
        rec = est.states[sid]
        if abs(t_d - rec.t) > 0.1:
            return 0  # stale depth
        fr = frames[ci]
        used = {kp for (_l, c, kp) in est.obs_of_state(sid) if c == ci}
        H, W = depth.shape
        free = [kp for kp in np.nonzero(fr["mask"])[0] if int(kp) not in used]
        if not free:
            return 0
        uv = fr["xy"][free]
        d = depth[np.clip(uv[:, 1].astype(int), 0, H - 1), np.clip(uv[:, 0].astype(int), 0, W - 1)]
        ok = (d > 0.1) & (d < 15.0) & np.isfinite(d)
        if not ok.any():
            return 0
        cam = self.frontend.cameras[ci]
        rays = cam.back_project(torch.as_tensor(uv[ok], dtype=cam.focal.dtype,
                                                device=self.device)).cpu().numpy()
        T_WC7 = se3_np.compose7(rec.pose, self.frontend.T_SC_np[ci])
        R_WC = se3_np.quat_to_mat(T_WC7[3:7])
        n = 0
        for ray, dz, kp in zip(rays.astype(np.float64), d[ok], np.asarray(free)[ok]):
            p_C = ray * (dz / max(ray[2], 1e-6))
            p_W = R_WC @ p_C + T_WC7[:3]
            lid = est.add_landmark(np.concatenate([p_W, [1.0]]), initialised=True)
            est.add_observation(lid, sid, ci, int(kp), fr["xy"][int(kp)], fr["size"][int(kp)])
            self.frontend.table.stage_descriptor(lid, ci, int(kp))
            n += 1
        self.frontend.table.flush(frames[0]["stacked"]["signs"])
        return n

    def set_optimised_graph_callback(self, cb: Callable):
        self._callbacks.append(cb)

    # debug CSV taps (ViInterface::setImuCsvFile / setTracksCsvFile,
    # okvis_common/include/okvis/ViInterface.hpp:298-314)
    def set_imu_csv_file(self, path: str):
        self._imu_csv = open(path, "w", buffering=1)
        self._imu_csv.write("#timestamp,w_x,w_y,w_z,a_x,a_y,a_z\n")

    def set_tracks_csv_file(self, path: str):
        self._tracks_csv = open(path, "w", buffering=1)
        self._tracks_csv.write("#timestamp,state_id,is_keyframe,num_matched,"
                               "num_motion_stereo,ransac_inliers,num_landmarks\n")

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
        record = self._bench_record
        if record is not None:
            # what the dispatch reads and then replaces or advances
            table_in = (self.frontend.table.signs, self.frontend.table.valid)
            gen_state = self.frontend._gen.get_state()
        with SwitchableTimer("2 upload + dispatches"):
            # the upload first: a copy from pageable memory waits for the
            # stream, which the frame program would hold
            problem, aux_dev = est.upload_fused_solve(prob_np, aux)
            ctx = self.frontend.dispatch_prepared(prep)
            match_sets = [p["ctx"]["match"] for p in self._pending_frames] + [ctx["match"]]
            # padding sets are disabled by their all -1 slot maps
            match_sets += [ctx["match"]] * (MAX_APPEND_SETS - len(match_sets))
            job = est.dispatch_fused_solve(problem, aux_dev, match_sets, ctx["diag"], scfg)
        if record is not None:
            record.append(device_replay.capture(self, prep, table_in, gen_state, ctx, job))
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
        """Host keyframe work after the descriptor fetch: depth-aided
        initialisation, frontier expansion (expandKeyframe,
        ViSlamBackend.cpp:357-406), CNN sky/person suppression
        (Frontend.cpp:969-1011), place recognition (Frontend.cpp:674-899)
        and relocalisation against loaded maps. Returns the detected loop
        keyframe id, or None."""
        est = self.estimator
        if self._latest_depth is not None:
            self._init_landmarks_from_depth(frames, sid)
        est.expand_keyframe(sid)
        if self.cnn is not None:
            with SwitchableTimer("2.07 cnn suppression"):
                self.cnn.suppress(est, frames, sid, images)
        loop_old_id = None
        if self.loop_backend is not None:
            with SwitchableTimer("2.06 place recognition"):
                loop_old_id = self.loop_backend.detect_loop(est, sid, frames, self.frontend)
                self.loop_backend.add_keyframe(est, sid, frames)
            # multi-session relocalisation: the loaded maps' own databases,
            # from an unknown pose
            if self.loop_backend.has_components():
                with SwitchableTimer("2.09 relocalisation"):
                    v = self.loop_backend.relocalise(est, sid, frames)
                    if v is not None:
                        self._apply_relocalisation(est, sid, frames, v)
        return loop_old_id

    def _finish_deferred_keyframe(self):
        """Pipelined loop: consume the previous keyframe's deferred extras
        (their copies have been crossing since its finish), run the
        keyframe tail and close a detected loop, queueing its full-graph
        solve."""
        pk = self._pending_kf
        if pk is None:
            return
        self._pending_kf = None
        est = self.estimator
        sid = pk["sid"]
        if sid not in est.states:
            return  # the keyframe's state left the graph meanwhile
        with SwitchableTimer("2.05 keyframe extras finish"):
            self.frontend.finish_keyframe_extras(est, pk)
            loop_old_id = self._keyframe_tail(sid, pk["frames"], pk["images"])
        if loop_old_id is not None:
            with SwitchableTimer("2.08 loop closure"):
                closed = self.loop_backend.close_loop(est, loop_old_id, sid, pk["frames"],
                                                      self.frontend, async_solve=True)
            if closed:
                # the drift distribution moved the chain's poses one by
                # one: solves packed before it are stale
                self._note_pose_correction(None)

    def _finish_one(self, p):
        """Consume one in-flight frame's [solve | diag] output and run its
        host bookkeeping: observations, the solve's application, keyframe
        work, marginalisation, callbacks: the lagged half of the pipelined
        loop."""
        est = self.estimator
        # a full-graph solve queued by the last loop closure lands first
        if self.loop_backend is not None:
            if self.loop_backend.apply_pending_full_graph(est) is not None:
                # it moved states one by one (and newer ones rigidly):
                # realtime solves in flight must not overwrite it
                self._note_pose_correction(None)
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
        last keyframe's deferred extras and a last full-graph solve; then
        end the solve worker (the next solve starts another). In the
        synchronous loop nothing is in flight and, as in the JAX package's,
        the last frame's solve stays pending and is not applied."""
        self._consume_pending(max_left=0)
        self._finish_deferred_keyframe()
        if self.loop_backend is not None:
            self.loop_backend.apply_pending_full_graph(self.estimator)
        self.estimator.close_solve_worker()

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
                loop_old_id = self._keyframe_tail(sid, frames, images)
                if loop_old_id is not None:
                    # before the window solve below, which then starts from
                    # the corrected state; the full graph is solved inline
                    with SwitchableTimer("2.08 loop closure"):
                        self.loop_backend.close_loop(est, loop_old_id, sid, frames, self.frontend)

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
        if self._tracks_csv is not None:
            self._tracks_csv.write(
                f"{int(round(t * 1e9))},{sid},{int(is_kf)},{m.get('num_matched', 0)},"
                f"{m.get('num_motion_stereo', 0)},{m.get('ransac_inliers', 0)},"
                f"{len(est.landmarks)}\n")

    # ------------------------------------------------------------------
    def _apply_relocalisation(self, est, sid, frames, v):
        """Multi-session relocalisation: where the verified map-frame pose
        differs from the session's estimate (> 5 cm or 0.05 rad), move the
        whole session rigidly onto the map's frame: states, world-frame
        velocities and the session's landmarks, not the loaded map's; then
        adopt the matched map landmarks as observations of this keyframe
        (the reference re-anchors through T_AiS and the loop-closure
        machinery, ViSlamBackend.hpp:686-687, Frontend.cpp:674-749)."""
        T_meas = np.asarray(v["T_WS7"])
        T_est = est.states[sid].pose
        d_pos = float(np.linalg.norm(T_meas[:3] - T_est[:3]))
        dq = se3_np.quat_mul(se3_np.quat_conj(T_est[3:7]), T_meas[3:7])
        d_rot = float(np.linalg.norm(se3_np.log_so3(dq)))
        if d_pos > 0.05 or d_rot > 0.05:
            T_corr = se3_np.compose7(T_meas, se3_np.inverse7(T_est))
            R = se3_np.quat_to_mat(T_corr[3:7])
            for rec in est.states.values():
                rec.pose = se3_np.compose7(T_corr, rec.pose)
                rec.speed_bias = rec.speed_bias.copy()
                rec.speed_bias[:3] = R @ rec.speed_bias[:3]
            for lid, lm in est.landmarks.items():
                if lid in self._loaded_lids:
                    continue
                hp = lm.hp_W
                lm.hp_W = np.concatenate([R @ hp[:3] + T_corr[:3] * hp[3], hp[3:4]])
            # the session moved rigidly: solves in flight, packed before,
            # are composed with the same correction
            self._note_pose_correction(T_corr)
        self.loop_backend._merge_loop_landmarks(est, sid, v["pairs"], frames, self.frontend)
        self._relocalisations += 1

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

    # ------------------------------------------------------------------
    # map save/load (ThreadedSlam::saveMap, Frontend::loadComponent) and
    # the final BA
    # ------------------------------------------------------------------
    def save_map(self, path: str):
        """Write the session's graph with its landmarks' descriptors, packed
        as uint32[16] words, bit k of word j the sign of bit 32 j + k
        (Component::save, okvis_ceres/src/Component.cpp:405-526)."""
        descs = {}
        for lid, signs in self.frontend.lm_descriptors.items():
            bits = (np.asarray(signs) > 0).astype(np.uint32).reshape(-1, 32)
            descs[lid] = (bits << np.arange(32, dtype=np.uint32)).sum(axis=-1, dtype=np.uint32)
        save_component(path, self.estimator, descs)

    def load_map(self, path: str) -> int:
        """Load a saved session as localisation context
        (Frontend::loadComponent, Frontend.cpp:180-218): its landmarks join
        the estimator (initialised, without observations), those with
        descriptors enter the device table, and with loop closure on the
        map's keyframes get a place-recognition database of their own.
        Returns the number of landmarks loaded."""
        data = load_component(path)
        id_map = {lid: self.estimator.add_landmark(hp, initialised=True)
                  for lid, hp in data["landmarks"].items()}
        loaded, kf_docs = {}, {}
        for obs in data["observations"]:
            if obs["lid"] not in id_map:
                continue
            new_id = id_map[obs["lid"]]
            kf_docs.setdefault(obs["sid"], []).append(new_id)
            if "descriptor" in obs:
                bits = ((obs["descriptor"][:, None] >> np.arange(32, dtype=np.uint32)) & 1)
                signs = np.where(bits.reshape(-1) > 0, 1.0, -1.0).astype(np.float32)
                self.frontend.lm_descriptors[new_id] = signs
                loaded[new_id] = signs
        # the load writes the device table directly: staged updates first
        self.frontend._flush_staged()
        self.frontend.table.load_host_descriptors(loaded,
                                                  dtype=self.frontend.cameras[0].focal.dtype)
        self._loaded_lids |= set(id_map.values())
        if self.loop_backend is not None and loaded:
            self.loop_backend.add_component(kf_docs, loaded)
        return len(id_map)

    def do_final_ba(self, iterations: int = 30, mesh=None) -> dict:
        """The offline final bundle adjustment (doFinalBa) on the estimator's
        device, or landmark-sharded over ``mesh`` (``parallel.make_mesh``;
        SPMD: every rank calls it on the same session)."""
        return do_final_ba(self.estimator, iterations, mesh)
