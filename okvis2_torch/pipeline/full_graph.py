"""Loop closure and the full-graph solve.

Port of ``okvis2_tpu/pipeline/full_graph.py`` (the loop-closure half of
okvis::ViSlamBackend, reference okvis_ceres/src/ViSlamBackend.cpp:
attemptLoopClosure :2033-2210, addLoopClosureFrame :1284-1409,
optimiseFullGraph :1726-1757). As in the JAX package there is no second
copy of the graph: a verified loop closure rewrites the estimator's records
and the full-graph solve works on them directly.

- Place recognition: a bag-of-words database over the keyframes that add
  view coverage (``add_keyframe`` / ``_pr_eligible``), queried at each new
  keyframe (``detect_loop``).
- Geometric verification (``_verify`` / ``_verify_entries``,
  verifyRecognisedPlace, Frontend.cpp:271-555): the current frame's
  descriptors, all cameras, against up to 3 descriptor variants of each
  landmark the old keyframe saw, one surviving row per landmark; the rig
  P3P RANSAC; a Gauss-Newton pose refine whose 6x6 Hessian becomes the
  loop edge's information. Matching, back-projection, RANSAC and the
  refine run on the estimator's device.
- A drift budget rejects corrections that odometry drift cannot explain
  (ViSlamBackend.cpp:2131-2153); an accepted one is distributed over the
  loop's states by path-length-weighted interpolation, landmarks follow
  their anchor keyframe, duplicates are merged, and the marginalisation
  edges inside the loop give their observations back.
- The full graph (all keyframes, pose-graph frames and window states, IMU
  links, relative-pose edges and the landmarks seen from two of its
  states) is packed at capacities that grow in powers of two and solved by
  the window solver at ``full_graph_iterations``.

``close_loop(async_solve=True)`` (the pipelined loop) queues the solve on
the estimator's solve worker, behind the realtime solves already
submitted, on the worker's stream; ``apply_pending_full_graph`` waits for
it. Otherwise the solve runs inline.

RANSAC draws come from a ``torch.Generator`` seeded 7; ``sampler(n)``, when
given, may return the n-th verification's hypothesis sampler (as
``Frontend``'s ``ransac_sampler``).

Multi-session: ``add_component`` registers a loaded map (``SlamSystem.
load_map``) with a place-recognition database of its own, and
``relocalise`` verifies a keyframe against it without a pose prior.

Left out: ``prewarm_shapes_async``, ``predicted_full_graph_shape`` and
``prewarm_predicted``, which compile the JAX package's XLA programs ahead
of time (eager PyTorch has nothing to compile).
"""

from __future__ import annotations

import dataclasses
import os
import time
from concurrent.futures import Future
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from okvis2_torch import resolve_device
from okvis2_torch.core import se3_np
from okvis2_torch.frontend.bow import BinaryVocabulary, PlaceRecognitionDatabase
from okvis2_torch.frontend.matching import match_descriptors
from okvis2_torch.frontend.p3p import ransac_rig_pose_from_samples, sample_hypotheses
from okvis2_torch.frontend.pose_refine import refine_pose_hessian
from okvis2_torch.graph.estimator import Estimator, PoseGraphEdge
from okvis2_torch.solver.gauss_newton import solve_window
from okvis2_torch.solver.packed_solve import problem_to_device
from okvis2_torch.solver.window_problem import SolverConfig, WindowProblem
from okvis2_torch.utils.timing import SwitchableTimer

_DEFAULT_VOCABULARY = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                   "resources", "default_voc.npz")


@dataclasses.dataclass(frozen=True)
class LoopClosureConfig:
    min_score: float = 0.4  # bag-of-words acceptance (Frontend.cpp:802)
    min_inliers: int = 10  # verifyRecognisedPlace (Frontend.cpp:359-389)
    # share of descriptor matches that must be RANSAC inliers (the reference
    # uses 0.7 with BRISK on real imagery; the ring descriptor aliases more)
    min_inlier_ratio: float = 0.35
    verify_match_threshold: int = 80  # Hamming, wider than tracking
    verify_capacity: int = 512  # landmark-candidate slots per verification
    # place-recognition pruning (prunePlaceRecognitionFrames,
    # ViSlamBackend.cpp:2276-2309): coverage bar and same-ray cone
    pr_max_overlap: float = 0.75
    pr_max_ray_angle: float = 0.03
    # the most recent N place-recognition frames are not matched against
    exclude_recent: int = 5
    full_graph_iterations: int = 15  # config/euroc.yaml:85
    vocabulary_size: int = 512
    # None: no file (online training); "": the committed default vocabulary
    vocabulary_path: Optional[str] = ""
    # online training starts once this many descriptors are buffered
    min_train_descriptors: int = 800
    # drift budget (ViSlamBackend.cpp:2135-2140): 1.35 %/m of path + 2 %
    # scale + noise/sqrt(steps); (4e-4 + 4e-3/sqrt(steps)) rad per step
    drift_pos_per_m: float = 0.0135
    drift_pos_scale: float = 0.02
    drift_pos_noise: float = 0.08
    drift_rot_per_step: float = 0.0004
    drift_rot_noise: float = 0.004
    check_drift_budget: bool = True
    reactivate_observations: bool = True
    max_reactivated_landmarks: int = 4096
    max_reactivated_obs: int = 16384


def _pow2_at_least(n: int, floor: int) -> int:
    s = floor
    while s < n:
        s *= 2
    return s


class LoopClosureBackend:
    """Place recognition, loop-closure verification and the full-graph
    solve. Verification runs on ``device`` (None: the CUDA card; raises
    without one), in the cameras' dtype."""

    def __init__(self, cameras, extrinsics, config: LoopClosureConfig = LoopClosureConfig(),
                 device=None, sampler=None):
        self.device = resolve_device(device)
        self.cameras = tuple(c.to(device=self.device) for c in cameras)
        self.dtype = self.cameras[0].focal.dtype
        self.T_SC_np = np.stack([torch.cat([T.r, T.q]).detach().cpu().numpy().astype(np.float64)
                                 for T in extrinsics])
        self.cfg = config
        self.voc: Optional[BinaryVocabulary] = None
        self.db: Optional[PlaceRecognitionDatabase] = None
        # the committed general vocabulary first; online training otherwise
        if config.vocabulary_path is not None:
            path = config.vocabulary_path or _DEFAULT_VOCABULARY
            if os.path.exists(path):
                self.voc = BinaryVocabulary.load(path)
                self.db = PlaceRecognitionDatabase(self.voc)
        self._train_buffer: List[np.ndarray] = []
        # per place-recognition keyframe: descriptor signs, mask, xy [NC,N,..]
        self._kf_data: dict = {}
        self._gen = torch.Generator(device=self.device).manual_seed(7)
        self._sampler = sampler
        self._n_ransac = 0  # verifications that reached RANSAC
        self.num_loop_closures = 0
        self.num_rejected_by_budget = 0
        # per accepted closure: inlier ratio / min_inlier_ratio
        self.verify_margins: List[float] = []
        self.num_loop_observations = 0
        self._pr_ids: List[int] = []
        self._components: List[dict] = []
        self._pending_fg = None
        self._cos_half_fov_v = None
        # introspection: the last query's results and verification outcome,
        # the last full-graph solve's capacities, iterations and times
        self.last_query_results = []
        self.last_verify_info = ""
        self.last_full_graph: dict = {}

    # ------------------------------------------------------------------
    def _cos_half_fov(self) -> float:
        if self._cos_half_fov_v is None:
            cam = self.cameras[0]
            f = cam.focal.detach().cpu().numpy().astype(np.float64)
            half = float(np.arctan(np.hypot(0.5 * cam.width / f[0], 0.5 * cam.height / f[1])))
            self._cos_half_fov_v = float(np.cos(half))
        return self._cos_half_fov_v

    def _pr_eligible(self, estimator: Estimator, sid: int, max_overlap: Optional[float] = None,
                     max_ray_angle: Optional[float] = None) -> bool:
        """prunePlaceRecognitionFrames (ViSlamBackend.cpp:2276-2309): a
        keyframe's observed landmark is covered by a stored frame when it
        lies in that frame's viewing cone and is seen from nearly the same
        ray (< max_ray_angle); a keyframe of which some stored frame covers
        more than max_overlap is not added."""
        if max_overlap is None:
            max_overlap = self.cfg.pr_max_overlap
        if max_ray_angle is None:
            max_ray_angle = self.cfg.pr_max_ray_angle
        rec_c = estimator.states[sid]
        pts = []
        for (lid, _ci, _kp) in estimator.obs_of_state(sid):
            lm = estimator.landmarks.get(lid)
            if lm is not None:
                hp = lm.hp_W
                w = hp[3] if abs(hp[3]) > 1e-12 else 1e-12
                pts.append(hp[:3] / w)
        if len(pts) < 8:
            return True  # too few points to judge overlap
        p = np.asarray(pts)  # [n,3]
        R_SC0 = se3_np.quat_to_mat(self.T_SC_np[0, 3:7])
        r_SC0 = self.T_SC_np[0, :3]
        o_c = rec_c.pose[:3] + se3_np.quat_to_mat(rec_c.pose[3:7]) @ r_SC0
        ray_c = p - o_c[None, :]
        ray_c = ray_c / np.maximum(np.linalg.norm(ray_c, axis=-1, keepdims=True), 1e-9)
        fwds, origins = [], []
        for prev in self._pr_ids:
            rec = estimator.states.get(prev)
            if rec is None:
                continue
            R_WS = se3_np.quat_to_mat(rec.pose[3:7])
            origins.append(rec.pose[:3] + R_WS @ r_SC0)
            fwds.append(R_WS @ R_SC0[:, 2])  # cam0's optical axis
        if not origins:
            return True
        o = np.stack(origins)  # [P,3]
        f = np.stack(fwds)  # [P,3]
        rel = p[None, :, :] - o[:, None, :]  # [P,n,3]
        dist = np.maximum(np.linalg.norm(rel, axis=-1), 1e-9)
        z = np.einsum("pnk,pk->pn", rel, f)
        in_cone = (z > 0.2) & (z > self._cos_half_fov() * dist)
        same_view = np.einsum("pnk,nk->pn", rel / dist[..., None], ray_c) > np.cos(max_ray_angle)
        overlap = (in_cone & same_view).mean(axis=1)  # [P]
        return float(overlap.max()) <= max_overlap

    @staticmethod
    def _stack_frames(frames):
        """[NC,N,...] host stacks of a keyframe's per-camera data."""
        signs = np.stack([f["signs_np"] for f in frames])
        mask = np.stack([np.asarray(f["mask"], bool) for f in frames])
        xy = np.stack([np.asarray(f["xy"]) for f in frames])
        return signs, mask, xy

    def add_keyframe(self, estimator: Estimator, sid: int, frames):
        """Register a keyframe for place recognition unless it is pruned for
        overlap. Its document concatenates all cameras' descriptors (as the
        reference's DBoW features, Frontend.cpp:660-673)."""
        if not self._pr_eligible(estimator, sid):
            return
        self._pr_ids.append(sid)
        signs, mask, xy = self._stack_frames(frames)
        self._kf_data[sid] = {"signs": signs, "mask": mask, "xy": xy}
        B = signs.shape[-1]
        flat_signs = signs.reshape(-1, B)
        flat_mask = mask.reshape(-1)
        if self.voc is None:
            self._train_buffer.append(flat_signs[flat_mask])
            if sum(len(b) for b in self._train_buffer) >= self.cfg.min_train_descriptors:
                self.voc = BinaryVocabulary.train(np.concatenate(self._train_buffer),
                                                  n_words=self.cfg.vocabulary_size)
                self.db = PlaceRecognitionDatabase(self.voc)
                for kid, d in self._kf_data.items():  # backfill the database
                    Bk = d["signs"].shape[-1]
                    self.db.add(kid, d["signs"].reshape(-1, Bk), d["mask"].reshape(-1))
                self._train_buffer = []
            return
        self.db.add(sid, flat_signs, flat_mask)

    # ------------------------------------------------------------------
    def detect_loop(self, estimator: Estimator, sid: int, frames, frontend=None) -> Optional[int]:
        """Query place recognition with the current keyframe (all cameras'
        descriptors) and verify the best three candidates geometrically;
        returns the first verified old keyframe id, or None."""
        if self.db is None or len(self.db) < self.cfg.exclude_recent + 2:
            return None
        signs, mask, _xy = self._stack_frames(frames)
        B = signs.shape[-1]
        results = self.db.query(signs.reshape(-1, B), mask.reshape(-1),
                                exclude_recent=self.cfg.exclude_recent,
                                min_score=self.cfg.min_score)
        self.last_query_results = results[:5]
        for old_id, _score in results[:3]:
            if self._verify(estimator, old_id, sid, frames, frontend) is not None:
                return old_id
        return None

    def _verify(self, estimator: Estimator, old_id: int, sid: int, frames, frontend=None):
        """Geometric verification of keyframe ``sid`` against ``old_id``'s
        landmarks. Returns {T_WS7, H, sqrt_info, pairs [(lid, cam, kp) of
        the current frame], num_inliers, margin} or None."""
        cfg = self.cfg
        old = self._kf_data.get(old_id)
        if old is None:
            return None
        N_old = old["signs"].shape[1]
        # the old keyframe's landmarks (any camera), each entered once even
        # when live and stored in marginalisation edges
        entry_of: Dict[int, Tuple[int, int]] = {}
        for lid, lm in estimator.landmarks.items():
            for (s, ci, kp) in lm.obs:
                if s == old_id and kp < N_old:
                    entry_of[lid] = (ci, kp)
                    break
        for e in estimator.pose_graph_edges:
            for (lid, s, ci, kp, _u, _v, _size) in e.stored_obs:
                if (s == old_id and kp < N_old and lid not in entry_of
                        and lid in estimator.landmarks):
                    entry_of[lid] = (ci, kp)
        if len(entry_of) < cfg.min_inliers:
            self.last_verify_info = f"few lm_entries {len(entry_of)}"
            return None
        # up to 3 descriptor variants per landmark: the old keyframe's view
        # and the frontend's distinct later views (Frontend.cpp:1224-1359);
        # every landmark's first variant enters before any second one
        desc_of_lid = {}
        for lid, (ci, kp) in entry_of.items():
            base_signs = old["signs"][ci][kp]
            descs = [base_signs]
            if frontend is not None:
                base = np.packbits(np.asarray(base_signs) > 0)
                for p in frontend.lm_desc_sets.get(lid, ()):
                    if int(np.unpackbits(p ^ base).sum()) < 16:
                        continue  # a near-duplicate of the old view
                    descs.append(np.unpackbits(p).astype(np.float32) * 2.0 - 1.0)
                    if len(descs) >= 3:
                        break
            desc_of_lid[lid] = descs
        lm_entries = []
        for r in range(max(len(d) for d in desc_of_lid.values())):
            for lid, descs in desc_of_lid.items():
                if r < len(descs) and len(lm_entries) < cfg.verify_capacity:
                    lm_entries.append((lid, descs[r]))
        pts = {lid: estimator.landmarks[lid].hp_W[:3] / max(estimator.landmarks[lid].hp_W[3], 1e-12)
               for lid in desc_of_lid}
        return self._verify_entries(lm_entries, pts, frames)

    def _ransac_sampler(self):
        """This verification's hypothesis sampler: the injected one, or
        ``sample_hypotheses`` on the backend's generator."""
        n = self._n_ransac
        self._n_ransac += 1
        s = self._sampler(n) if self._sampler is not None else None
        if s is None:
            gen = self._gen

            def s(mask, cam_idx, n_hyp, nc):
                return sample_hypotheses(gen, mask, cam_idx, n_hyp, nc)
        return s

    def _verify_entries(self, lm_entries, pts_of, frames):
        """The verification core: ``lm_entries`` [(lid, signs)] and
        ``pts_of`` {lid: p_W [3]} matched against all cameras of the current
        frame at fixed capacity, the rig P3P RANSAC, then the refine."""
        cfg = self.cfg
        dev, dt = self.device, self.dtype
        NC = len(self.cameras)
        cap = cfg.verify_capacity
        sel = lm_entries[:cap]
        n_sel = len(sel)
        B = sel[0][1].shape[-1]
        sg = np.zeros((cap, B), np.float32)
        sg[:n_sel] = np.stack([s for _, s in sel])
        sel_mask = np.zeros(cap, bool)
        sel_mask[:n_sel] = True
        pts_W = np.zeros((cap, 3))
        pts_W[:n_sel] = np.stack([pts_of[lid] for lid, _ in sel])
        # the current frame's cameras concatenated: index = cam * N + kp
        cur_signs = np.stack([f["signs_np"] for f in frames]).astype(np.float32)
        cur_mask = np.stack([np.asarray(f["mask"], bool) for f in frames])
        N = cur_signs.shape[1]
        m = match_descriptors(torch.from_numpy(sg).to(dev), torch.from_numpy(sel_mask).to(dev),
                              torch.from_numpy(cur_signs.reshape(NC * N, B)).to(dev),
                              torch.from_numpy(cur_mask.reshape(NC * N)).to(dev),
                              max_distance=cfg.verify_match_threshold)
        ok = m["valid"].cpu().numpy().copy()
        dist = m["dist"].cpu().numpy()
        idx_np = m["idx_b"].cpu().numpy()
        # one surviving row per landmark (variants of one landmark would
        # count twice in the inlier tally and the refine's Hessian)
        best_row: Dict[int, int] = {}
        for i in np.nonzero(ok[:n_sel])[0]:
            lid = sel[i][0]
            j = best_row.get(lid)
            if j is None or dist[i] < dist[j]:
                best_row[lid] = int(i)
        keep = np.zeros(cap, bool)
        keep[list(best_row.values())] = True
        ok &= keep
        n_lids = len({lid for lid, _ in sel})
        if ok.sum() < cfg.min_inliers:
            self.last_verify_info = f"few desc matches {int(ok.sum())}/{n_lids}"
            return None
        idx_full = np.where(ok, idx_np, 0)
        rays_all = torch.cat([cam.back_project(torch.as_tensor(np.asarray(f["xy"]), dtype=dt,
                                                               device=dev))
                              for cam, f in zip(self.cameras, frames)])
        idx_t = torch.from_numpy(idx_full.astype(np.int64)).to(dev)
        rays = rays_all[idx_t]
        cam_idx = idx_t // N
        T_SC7 = torch.as_tensor(self.T_SC_np, dtype=dt, device=dev)
        pts_t = torch.as_tensor(pts_W, dtype=dt, device=dev)
        ok_t = torch.from_numpy(ok).to(dev)
        hyp = self._ransac_sampler()(ok_t, cam_idx, 128, NC)
        res = ransac_rig_pose_from_samples(hyp, pts_t, rays, cam_idx, ok_t, T_SC7)
        n_in = int(res["num_inliers"])
        n_ok = int(ok.sum())
        if n_in < cfg.min_inliers or n_in < cfg.min_inlier_ratio * n_ok:
            self.last_verify_info = f"ransac inliers {n_in}/{n_ok}"
            return None
        verify_margin = (n_in / max(n_ok, 1)) / cfg.min_inlier_ratio
        # Gauss-Newton refine on the inliers; its Hessian is the edge's
        # information (the reference's small Ceres solve, Frontend.cpp:440-530)
        T = res["T_WS"]
        T_WS7 = torch.cat([T.r, T.q]).detach().cpu().numpy().astype(np.float64)
        inl = res["inliers"]
        T_SW7_r, H, sqrt_info = refine_pose_hessian(
            torch.as_tensor(se3_np.inverse7(T_WS7), dtype=dt, device=dev), pts_t, rays, cam_idx,
            inl, T_SC7)
        T_SW7_r, H, sqrt_info = (x.detach().cpu().numpy().astype(np.float64)
                                 for x in (T_SW7_r, H, sqrt_info))
        if not np.all(np.isfinite(T_SW7_r)):
            self.last_verify_info = "refine diverged"
            return None
        inl = inl.cpu().numpy()
        pairs = [(sel[i][0],) + divmod(int(idx_np[i]), N) for i in np.nonzero(inl[:n_sel])[0]]
        return {"T_WS7": se3_np.inverse7(T_SW7_r), "H": H, "sqrt_info": sqrt_info,
                "pairs": pairs, "num_inliers": n_in, "margin": verify_margin}

    # ------------------------------------------------------------------
    # multi-session relocalisation (one database per loaded component)
    # ------------------------------------------------------------------
    def has_components(self) -> bool:
        """Whether loaded maps are registered for relocalisation
        (``add_component``, called by ``SlamSystem.load_map``)."""
        return bool(self._components)

    def add_component(self, kf_docs: Dict[int, List[int]], lm_signs: Dict[int, np.ndarray]):
        """Register a loaded map for relocalisation: ``kf_docs`` maps each of
        its keyframe ids to the (session) ids of the landmarks it observed,
        ``lm_signs`` a landmark id to its descriptor signs. Each component
        gets a database of its own (Frontend.cpp:180-218, queried at
        :674-749), so a new session relocalises from an unknown pose, where
        projection-gated matching needs a roughly right prediction. Without
        a vocabulary, one is trained on the component's descriptors first."""
        docs = {kid: [lid for lid in lids if lid in lm_signs] for kid, lids in kf_docs.items()}
        docs = {k: v for k, v in docs.items() if len(v) >= 3}
        if not docs:
            return
        if self.voc is None:
            # a previous session's descriptors sample the scene far better
            # than this session's first keyframes, and relocalisation must
            # work from its first frame
            train = np.stack([lm_signs[lid] for lids in docs.values() for lid in lids])
            self.voc = BinaryVocabulary.train(train,
                                              n_words=min(self.cfg.vocabulary_size, len(train)))
            self.db = PlaceRecognitionDatabase(self.voc)
            for kid, d in self._kf_data.items():
                B = d["signs"].shape[-1]
                self.db.add(kid, d["signs"].reshape(-1, B), d["mask"].reshape(-1))
            self._train_buffer = []
        cdb = PlaceRecognitionDatabase(self.voc)
        for kid, lids in docs.items():
            cdb.add(kid, np.stack([lm_signs[lid] for lid in lids]))
        self._components.append({"db": cdb, "docs": docs, "signs": lm_signs})

    def relocalise(self, estimator: Estimator, sid: int, frames):
        """Query every loaded component's database with keyframe ``sid``
        (all cameras) and verify the best three answers geometrically,
        without a pose prior. Returns the first verified result (as
        ``_verify``'s: T_WS7 in the map's frame, pairs, ...) or None."""
        if not self._components:
            return None
        signs, mask, _xy = self._stack_frames(frames)
        B = signs.shape[-1]
        q_signs, q_mask = signs.reshape(-1, B), mask.reshape(-1)
        for comp in self._components:
            results = comp["db"].query(q_signs, q_mask, min_score=self.cfg.min_score)
            self.last_query_results = results[:5]
            for kid, _score in results[:3]:
                lids = [lid for lid in comp["docs"][kid] if lid in estimator.landmarks]
                if len(lids) < self.cfg.min_inliers:
                    continue
                lm_entries = [(lid, comp["signs"][lid]) for lid in lids]
                pts_of = {lid: estimator.landmarks[lid].hp_W[:3]
                          / max(estimator.landmarks[lid].hp_W[3], 1e-12) for lid in lids}
                v = self._verify_entries(lm_entries, pts_of, frames)
                if v is not None:
                    return v
        return None

    # ------------------------------------------------------------------
    def _loop_chain(self, estimator: Estimator, old_id: int, sid: int):
        """Keyframe, pose-graph and window state ids from old_id to sid."""
        ids = [s for s in estimator.state_order
               if old_id <= s <= sid and s in estimator.states
               and (estimator.states[s].is_keyframe or estimator.states[s].is_pose_graph_frame
                    or s in estimator.window)]
        if old_id not in ids:
            ids.insert(0, old_id)
        if sid not in ids:
            ids.append(sid)
        return ids

    def _drift_budget_ok(self, estimator, chain, T_WS_meas7, sid) -> bool:
        """attemptLoopClosure's error budget (ViSlamBackend.cpp:2131-2153):
        the implied correction must be explicable by odometry drift over
        the loop's path."""
        cfg = self.cfg
        poses = [estimator.states[s].pose for s in chain]
        steps = max(len(chain) - 1, 1)
        path = float(sum(np.linalg.norm(poses[k + 1][:3] - poses[k][:3])
                         for k in range(len(poses) - 1)))
        T_est = estimator.states[sid].pose
        d_pos = float(np.linalg.norm(T_WS_meas7[:3] - T_est[:3]))
        dq = se3_np.quat_mul(se3_np.quat_conj(T_est[3:7]), T_WS_meas7[3:7])
        d_rot = float(np.linalg.norm(se3_np.log_so3(dq)))
        rel_norm = float(np.linalg.norm(T_WS_meas7[:3] - estimator.states[chain[0]].pose[:3]))
        budget_pos = (cfg.drift_pos_per_m * path + cfg.drift_pos_scale * rel_norm
                      + cfg.drift_pos_noise * path / max(np.sqrt(steps), 1.0))
        budget_rot = (cfg.drift_rot_per_step + cfg.drift_rot_noise / np.sqrt(steps)) * steps
        ok = d_pos <= budget_pos and d_rot <= budget_rot
        if not ok:
            self.last_verify_info = (
                f"drift budget: d_pos {d_pos:.3f}>{budget_pos:.3f} or "
                f"d_rot {d_rot:.4f}>{budget_rot:.4f} (path {path:.2f} m, {steps} steps)")
        return ok

    def _distribute_drift(self, estimator, chain, T_WS_meas7, sid):
        """Spread the loop correction over the chain by path-length-weighted
        interpolation (slerp for the rotation); landmarks follow their
        anchor keyframe rigidly (ViSlamBackend.cpp:2160-2200)."""
        old_poses = {s: estimator.states[s].pose.copy() for s in chain}
        T_est = estimator.states[sid].pose
        # the world-frame left correction at the loop's end
        T_corr = se3_np.compose7(T_WS_meas7, se3_np.inverse7(T_est))
        r_c = T_corr[:3]
        rotvec = se3_np.log_so3(T_corr[3:7])
        cum = [0.0]
        for k in range(len(chain) - 1):
            cum.append(cum[-1] + float(np.linalg.norm(
                estimator.states[chain[k + 1]].pose[:3] - estimator.states[chain[k]].pose[:3])))
        total = max(cum[-1], 1e-9)
        for k, s in enumerate(chain):
            w = cum[k] / total
            half = 0.5 * w * rotvec
            ang = np.linalg.norm(half)
            q_w = (np.concatenate([half * np.sinc(ang / np.pi), [np.cos(ang)]])
                   if ang > 0 else np.array([0.0, 0, 0, 1.0]))
            dT = np.concatenate([w * r_c, q_w / np.linalg.norm(q_w)])
            estimator.states[s].pose = se3_np.compose7(dT, estimator.states[s].pose)
        self._reanchor_landmarks(estimator, old_poses, chain)
        return old_poses

    @staticmethod
    def _reanchor_landmarks(estimator: Estimator, old_poses: dict, ids):
        """Move each landmark rigidly with its anchor (its first observing
        state among ``ids``)."""
        idset = set(ids)
        lm_list, anchor_of = [], []
        for lid, lm in estimator.landmarks.items():
            for (s, _ci, _kp) in lm.obs:
                if s in idset:
                    lm_list.append(lid)
                    anchor_of.append(s)
                    break
        deltas = {a: se3_np.compose7(estimator.states[a].pose, se3_np.inverse7(old_poses[a]))
                  for a in set(anchor_of)}
        for lid, a in zip(lm_list, anchor_of):
            d = deltas[a]
            lm = estimator.landmarks[lid]
            hp = lm.hp_W
            p = se3_np.quat_to_mat(d[3:7]) @ hp[:3] + d[:3] * hp[3]
            lm.hp_W = np.concatenate([p, hp[3:4]])

    def _merge_loop_landmarks(self, estimator, sid, pairs, frames=None, frontend=None):
        """For each verified pair (old landmark, cam, kp of ``sid``): a
        keypoint that hosts another landmark merges the two
        (Frontend.cpp:853-879, ViSlamBackend::mergeLandmark); a keypoint
        that hosts none becomes an observation of the old landmark. Returns
        the number of merges."""
        kp_lm = {}
        for lid, lm in estimator.landmarks.items():
            for (s, ci, kp) in lm.obs:
                if s == sid:
                    kp_lm[(ci, kp)] = lid
        n = 0
        n_new_obs = 0
        for (lid_old, ci, kp) in pairs:
            lid_new = kp_lm.get((ci, kp))
            fr = frames[ci] if frames is not None else None
            if (lid_new is not None and lid_new != lid_old and lid_old in estimator.landmarks
                    and lid_new in estimator.landmarks):
                estimator.merge_landmarks(lid_old, lid_new)
                n += 1
            elif (lid_new is None and lid_old in estimator.landmarks and fr is not None
                  and kp < len(fr["xy"]) and fr["mask"][kp]):
                estimator.add_observation(lid_old, sid, ci, kp, fr["xy"][kp], fr["size"][kp])
                if frontend is not None:
                    frontend.table.stage_descriptor(lid_old, ci, kp)
                n_new_obs += 1
        if n_new_obs and frontend is not None and frames is not None and "stacked" in frames[0]:
            frontend.table.flush(frames[0]["stacked"]["signs"])
        self.num_loop_observations += n_new_obs
        return n

    def _reactivate_loop_observations(self, estimator, chain):
        """convertToObservations for the marginalisation edges with both ends
        in the loop span (ViSlamBackend.cpp:1284-1409): their stored
        observations rejoin the problem and the edges go."""
        idset = set(chain)
        kept, n_restored = [], 0
        for e in estimator.pose_graph_edges:
            if e.kind == "marg" and e.stored_obs and e.id_i in idset and e.id_j in idset:
                for (lid, s, ci, kp, u, v, size) in e.stored_obs:
                    if lid in estimator.landmarks and s in estimator.states:
                        estimator.landmarks[lid].obs[(s, ci, kp)] = (u, v, size)
                        n_restored += 1
            else:
                kept.append(e)
        estimator.pose_graph_edges = kept
        estimator._obs_rev += 1
        return n_restored

    # ------------------------------------------------------------------
    def close_loop(self, estimator: Estimator, old_id: int, sid: int, frames, frontend=None,
                   async_solve: bool = False) -> bool:
        """Verify, check the drift budget, add the loop edge, merge,
        distribute the drift, reactivate, then solve the full graph: inline,
        or with ``async_solve`` queued on the estimator's solve worker and
        applied by ``apply_pending_full_graph``."""
        with SwitchableTimer("2.081 loop verify"):
            v = self._verify(estimator, old_id, sid, frames, frontend)
        if v is None:
            return False
        T_WS_meas7 = v["T_WS7"]
        chain = self._loop_chain(estimator, old_id, sid)
        if self.cfg.check_drift_budget and not self._drift_budget_ok(
                estimator, chain, T_WS_meas7, sid):
            self.num_rejected_by_budget += 1
            return False
        # the relative measurement old -> new; its information's eigenvalues
        # are clipped (sqrt-info entries <= 1e4) so the edge cannot dwarf
        # the graph without distorting rotation against translation
        T_ij = se3_np.compose7(se3_np.inverse7(estimator.states[old_id].pose), T_WS_meas7)
        H = 0.5 * (v["H"] + v["H"].T)
        evals, evecs = np.linalg.eigh(H)
        evals = np.clip(evals, 0.0, 1e8)
        sqrt_info = np.diag(np.sqrt(evals)) @ evecs.T
        estimator.pose_graph_edges.append(PoseGraphEdge(old_id, sid, T_ij, sqrt_info, [], "loop"))
        self.num_loop_closures += 1
        self.verify_margins.append(float(v.get("margin", 0.0)))

        self._merge_loop_landmarks(estimator, sid, v["pairs"], frames, frontend)
        self._distribute_drift(estimator, chain, T_WS_meas7, sid)
        if self.cfg.reactivate_observations:
            self._reactivate_loop_observations(estimator, chain)
        # the oldest loop states rejoin the window unfrozen
        estimator.reactivate_loop_states(chain)
        if async_solve:
            self.dispatch_full_graph(estimator, async_solve=True)
        else:
            self.optimise_full_graph(estimator)
        return True

    # ------------------------------------------------------------------
    def pack_full_problem(self, estimator: Estimator):
        """Pack every keyframe, pose-graph frame and window state with their
        IMU links, relative-pose edges and the observations of landmarks
        seen from two or more packed states, at capacities that grow in
        powers of two from S 32, L 64, O 256, R 64. Returns (the problem on
        the estimator's device in its dtype, ids, slot_of, lm_ids)."""
        cfg = self.cfg
        ids = [s for s in estimator.state_order
               if s in estimator.states
               and (estimator.states[s].is_keyframe or estimator.states[s].is_pose_graph_frame
                    or s in estimator.window)]
        S = _pow2_at_least(len(ids), 32)
        slot_of = {s: i for i, s in enumerate(ids)}
        max_sid = max(ids) if ids else 0
        slot_lookup = np.full(max_sid + 1, -1, np.int32)
        for s, i in slot_of.items():
            slot_lookup[s] = i

        # landmarks observed by >= 2 packed states, from their cached rows
        lm_ids, lm_chunks = [], []
        for lid, lm in estimator.landmarks.items():
            if not lm.initialised:
                continue
            rows = lm.packed_rows()  # [n,5] sid, cam, u, v, 8/size
            if len(rows) < 2:
                continue
            sids = rows[:, 0].astype(np.int64)
            sl = np.where(sids <= max_sid, slot_lookup[np.minimum(sids, max_sid)], -1)
            m = sl >= 0
            if np.count_nonzero(m) < 2:
                continue
            lm_ids.append(lid)
            r = rows[m]
            lm_chunks.append((sl[m], r[:, 1], r[:, 2:4], r[:, 4] * float(np.sqrt(lm.info_scale))))
            if len(lm_ids) >= cfg.max_reactivated_landmarks:
                break
        L = _pow2_at_least(max(len(lm_ids), 1), 64)

        if lm_chunks:
            o_state_v = np.concatenate([c[0] for c in lm_chunks])
            o_cam_v = np.concatenate([c[1] for c in lm_chunks]).astype(np.int32)
            o_lm_v = np.concatenate([np.full(len(c[0]), i, np.int32)
                                     for i, c in enumerate(lm_chunks)])
            o_uv_v = np.concatenate([c[2] for c in lm_chunks])
            o_w_v = np.concatenate([c[3] for c in lm_chunks])
        else:
            o_state_v = o_cam_v = o_lm_v = np.zeros(0, np.int32)
            o_uv_v, o_w_v = np.zeros((0, 2)), np.zeros(0)
        n_obs = min(len(o_state_v), cfg.max_reactivated_obs)
        O = _pow2_at_least(max(n_obs, 1), 256)
        n_rel = sum(1 for e in estimator.pose_graph_edges if e.id_i in slot_of and e.id_j in slot_of)
        R = _pow2_at_least(max(n_rel, 1), 64)

        prob = WindowProblem.empty(S, L, O, len(self.cameras), estimator.cfg.imu_seg_capacity,
                                   num_rel=R, dtype=torch.float64, device="cpu")
        kw = {f: getattr(prob, f).map(lambda x: x.numpy())
              if f == "imu_pre" else getattr(prob, f).numpy() for f in WindowProblem._FIELDS}
        pose, sb, lms = kw["pose"], kw["speed_bias"], kw["landmarks"]
        smask = kw["state_mask"]
        for s, i in slot_of.items():
            rec = estimator.states[s]
            pose[i] = rec.pose
            sb[i] = rec.speed_bias
            smask[i] = True
        for i, lid in enumerate(lm_ids):
            lms[i] = estimator.landmarks[lid].hp_W
            kw["lm_mask"][i] = True
        for name, vals in (("obs_state", o_state_v), ("obs_cam", o_cam_v), ("obs_lm", o_lm_v),
                           ("obs_uv", o_uv_v), ("obs_sqrt_info", o_w_v)):
            kw[name][:n_obs] = vals[:n_obs]
        kw["obs_mask"][:n_obs] = True

        # IMU links between consecutive packed states whose buffers chain: a
        # factor over another span would count the IMU integrals twice
        pre_rows = [np.array(x) for x in kw["imu_pre"].leaves()]
        for i in range(len(ids) - 1):
            nxt = estimator.states[ids[i + 1]]
            if len(nxt.imu_dt) and nxt.imu_from == ids[i]:
                pre = estimator._get_preintegrated(ids[i + 1])
                for full, one in zip(pre_rows, pre.leaves()):
                    _set_row(full, i, one)
                kw["imu_mask"][i] = True
        kw["imu_pre"] = type(kw["imu_pre"])(*pre_rows)

        k = 0
        for e in estimator.pose_graph_edges:
            if e.id_i in slot_of and e.id_j in slot_of and k < R:
                kw["rel_i"][k] = slot_of[e.id_i]
                kw["rel_j"][k] = slot_of[e.id_j]
                kw["rel_T"][k] = e.T_ij
                kw["rel_sqrt"][k] = e.sqrt_info
                kw["rel_mask"][k] = True
                k += 1

        # gauge: a prior on the oldest packed state
        kw["pose_prior"][0] = pose[0]
        kw["pose_prior_sqrt"][0] = np.eye(6) * 1e4
        kw["pose_prior_mask"][0] = True
        kw["extrinsics"] = np.stack(estimator.T_SC)
        prob = problem_to_device(WindowProblem(**kw), estimator.device, estimator.dtype)
        self._last_pack_counts = (len(ids), len(lm_ids), n_obs, n_rel)
        return prob, ids, slot_of, lm_ids

    def optimise_full_graph(self, estimator: Estimator):
        """The full-graph solve inline: dispatch, then apply at once."""
        self.dispatch_full_graph(estimator)
        return self.apply_pending_full_graph(estimator)

    def dispatch_full_graph(self, estimator: Estimator, async_solve: bool = False) -> None:
        """Pack the full graph and solve it at ``full_graph_iterations``:
        inline, or queued on the estimator's solve worker (behind the
        realtime solves already submitted, on its stream) with
        ``async_solve``. ``apply_pending_full_graph`` integrates the result."""
        with SwitchableTimer("2.082 full-graph pack"):
            prob, ids, slot_of, lm_ids = self.pack_full_problem(estimator)
        inputs = (prob, self.cameras, estimator.imu_params,
                  SolverConfig(max_iterations=self.cfg.full_graph_iterations))
        t0 = time.perf_counter()
        if async_solve:
            out = estimator.solve_worker().submit(_solve_full_graph, *inputs,
                                                  timer="3.3 full-graph solve (worker)")
        else:
            with SwitchableTimer("2.083 full-graph solve"):
                out = _solve_full_graph(*inputs).cpu().numpy()
        self._pending_fg = {"out": out, "ids": ids, "slot_of": slot_of, "lm_ids": lm_ids,
                            "S": prob.S, "L": prob.L, "newest": ids[-1], "t0": t0,
                            "caps": (prob.S, prob.L, prob.O, prob.rel_mask.shape[0]),
                            "used": self._last_pack_counts, "inputs": inputs}

    def apply_pending_full_graph(self, estimator: Estimator):
        """Integrate a dispatched full-graph solve (waiting for it if it was
        queued). States added since the dispatch follow the newest solved
        state's correction rigidly (synchroniseRealtimeAndFullGraph's
        re-anchoring role, ViSlamBackend.cpp:1411-1650); landmarks outside
        the solve follow their anchor. Returns the stats, or None."""
        p = self._pending_fg
        if p is None:
            return None
        self._pending_fg = None
        out = p["out"]
        if isinstance(out, Future):
            with SwitchableTimer("2.084 full-graph wait"):
                out = out.result()  # raises the solve's exception
        S, L = p["S"], p["L"]
        o = 0
        pose = out[o:o + S * 7].reshape(S, 7); o += S * 7  # noqa: E702
        sb = out[o:o + S * 9].reshape(S, 9); o += S * 9  # noqa: E702
        lms_solved = out[o:o + L * 4].reshape(L, 4); o += L * 4  # noqa: E702
        stats = {"initial_cost": out[o], "final_cost": out[o + 1], "iterations": int(out[o + 2])}
        self.last_full_graph = {"S": p["caps"][0], "L": p["caps"][1], "O": p["caps"][2],
                                "R": p["caps"][3], "used": p["used"],
                                "iterations": stats["iterations"],
                                "ms": 1e3 * (time.perf_counter() - p["t0"])}
        ids = [s for s in p["ids"] if s in estimator.states]
        if not ids:
            return stats
        slot_of = p["slot_of"]
        newest = p["newest"]
        old_poses = {s: estimator.states[s].pose.copy() for s in ids}
        T_cur_newest = (estimator.states[newest].pose.copy() if newest in estimator.states
                        else None)
        for s, i in slot_of.items():
            rec = estimator.states.get(s)
            if rec is not None:
                rec.pose = np.asarray(pose[i], np.float64)
                rec.speed_bias = np.asarray(sb[i], np.float64)
        # states added since the dispatch move rigidly with the newest one
        if T_cur_newest is not None:
            T_corr = se3_np.compose7(estimator.states[newest].pose, se3_np.inverse7(T_cur_newest))
            if np.linalg.norm(T_corr[:3]) > 1e-12 or abs(T_corr[6] - 1.0) > 1e-12:
                R = se3_np.quat_to_mat(T_corr[3:7])
                for s in estimator.state_order:
                    if s > newest and s in estimator.states:
                        rec = estimator.states[s]
                        rec.pose = se3_np.compose7(T_corr, rec.pose)
                        rec.speed_bias = rec.speed_bias.copy()
                        rec.speed_bias[:3] = R @ rec.speed_bias[:3]
        # solved landmarks come back; the others follow their anchor
        solved_set = set(p["lm_ids"])
        for i, lid in enumerate(p["lm_ids"]):
            if lid in estimator.landmarks:
                estimator.landmarks[lid].hp_W = np.asarray(lms_solved[i], np.float64)
        idset = set(ids)
        deltas = {}
        for lid, lm in estimator.landmarks.items():
            if lid in solved_set:
                continue
            a = next((s for (s, _ci, _kp) in lm.obs if s in idset), None)
            if a is None:
                continue
            if a not in deltas:
                deltas[a] = se3_np.compose7(estimator.states[a].pose, se3_np.inverse7(old_poses[a]))
            d = deltas[a]
            hp = lm.hp_W
            p3 = se3_np.quat_to_mat(d[3:7]) @ hp[:3] + d[:3] * hp[3]
            lm.hp_W = np.concatenate([p3, hp[3:4]])
        estimator._pre_cache.clear()
        return stats


def _set_row(full: np.ndarray, i: int, one) -> np.ndarray:
    full[i] = np.asarray(one)
    return full


def _concat_fg_solved(pose, sb, lms, initial_cost, final_cost, iterations) -> torch.Tensor:
    """The full-graph solve's results as one flat tensor (one copy back):
    pose | speed_bias | landmarks | initial cost, final cost, iterations."""
    d = pose.dtype
    return torch.cat([pose.reshape(-1), sb.reshape(-1), lms.reshape(-1),
                      torch.stack([initial_cost.to(d), final_cost.to(d),
                                   torch.tensor(float(iterations), dtype=d, device=pose.device)])])


def _solve_full_graph(prob: WindowProblem, cameras, imu_params, config: SolverConfig):
    solved, stats = solve_window(prob, cameras, imu_params, config)
    return _concat_fg_solved(solved.pose, solved.speed_bias, solved.landmarks,
                             stats["initial_cost"], stats["final_cost"], stats["iterations"])
