"""Offline final bundle adjustment.

Port of ``okvis2_tpu/pipeline/final_ba.py`` (okvis::ViSlamBackend::
doFinalBa, reference okvis_ceres/src/ViSlamBackend.cpp:1759-1892): every
pose-graph edge of marginalisation gives its stored reprojection
observations back (TwoPoseGraphError::convertToReprojectionErrors), every
state is unfrozen, and the whole session is solved at once by the window
solver on the estimator's device, in its dtype. With a ``mesh``
(``parallel.make_mesh``), the solve is landmark-sharded over the mesh's
process group (``parallel/sharded_ba.py``) on each rank's device.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from okvis2_torch.graph.estimator import Estimator
from okvis2_torch.parallel.sharded_ba import shard_problem_by_landmark, solve_full_graph_sharded
from okvis2_torch.solver.gauss_newton import _reproj_residuals, solve_window
from okvis2_torch.solver.packed_solve import problem_to_device
from okvis2_torch.solver.window_problem import SolverConfig, WindowProblem


def convert_edges_to_observations(estimator: Estimator) -> int:
    """Reverse marginalisation: re-insert the stored observations of every
    "marg" pose-graph edge and drop the edge
    (ViGraphEstimator::convertToObservations, ViGraphEstimator.cpp:758-835).
    Loop-closure edges stay (they store no observations). Returns the
    number of observations restored."""
    kept = []
    n_restored = 0
    for e in estimator.pose_graph_edges:
        if e.kind == "marg" and e.stored_obs:
            for (lid, sid, ci, kp, u, v, size) in e.stored_obs:
                if lid in estimator.landmarks and sid in estimator.states:
                    estimator.landmarks[lid].obs[(sid, ci, kp)] = (u, v, size)
                    n_restored += 1
        else:
            kept.append(e)
    estimator.pose_graph_edges = kept
    estimator._obs_rev += 1
    return n_restored


def _pow2_at_least(n: int, floor: int) -> int:
    s = floor
    while s < n:
        s *= 2
    return s


def pack_full_ba_problem(estimator: Estimator, max_states: int = 0, max_landmarks: int = 8192,
                         max_obs: int = 65536, rel_slots: int = 256):
    """Pack the whole session into one problem: every state that carries an
    IMU buffer (and the first), every landmark seen from two of them, the
    IMU links between consecutive packed states whose buffers chain, and
    the remaining (loop-closure) relative edges. Everything is free but
    for a gauge prior on the first state. The state capacity grows in
    powers of two from 32 with the session; ``max_states`` > 0 caps it
    instead (the oldest states go, with a warning). Returns (the problem on
    the estimator's device in its dtype, ids, slot_of, lm_ids)."""
    ids = [s for s in estimator.state_order
           if len(estimator.states[s].imu_dt) or s == estimator.state_order[0]]
    if max_states:
        if len(ids) > max_states:
            warnings.warn(f"final BA truncating {len(ids) - max_states} oldest states "
                          f"(max_states={max_states})")
        ids = ids[-max_states:]
        S = max_states
    else:
        S = _pow2_at_least(max(len(ids), 2), 32)
    slot_of = {s: i for i, s in enumerate(ids)}

    prob = WindowProblem.empty(S, max_landmarks, max_obs, len(estimator.cameras),
                               estimator.cfg.imu_seg_capacity, num_rel=rel_slots,
                               dtype=torch.float64, device="cpu")
    kw = {f: getattr(prob, f).map(lambda x: x.numpy())
          if f == "imu_pre" else getattr(prob, f).numpy() for f in WindowProblem._FIELDS}
    pose, sb, smask = kw["pose"], kw["speed_bias"], kw["state_mask"]
    for s, i in slot_of.items():
        rec = estimator.states[s]
        pose[i] = rec.pose
        sb[i] = rec.speed_bias
        smask[i] = True

    # landmarks with >= 2 observations among the packed states
    lm_ids = [lid for lid, lm in estimator.landmarks.items()
              if sum(1 for (s, _, _) in lm.obs if s in slot_of) >= 2][:max_landmarks]
    for i, lid in enumerate(lm_ids):
        kw["landmarks"][i] = estimator.landmarks[lid].hp_W
        kw["lm_mask"][i] = True

    k = 0
    for i_lm, lid in enumerate(lm_ids):
        lm = estimator.landmarks[lid]
        w_scale = float(np.sqrt(lm.info_scale))
        for (sid, ci, _kp), (u, v, size) in lm.obs.items():
            if sid in slot_of and k < max_obs:
                kw["obs_state"][k] = slot_of[sid]
                kw["obs_cam"][k] = ci
                kw["obs_lm"][k] = i_lm
                kw["obs_uv"][k] = (u, v)
                kw["obs_sqrt_info"][k] = 8.0 / size * w_scale
                kw["obs_mask"][k] = True
                k += 1

    # chain adjacency: the buffer on ids[i+1] must span exactly ids[i] ->
    # ids[i+1] (eliminated frames cleared theirs); a gap left by a
    # reinitialisation is masked off, not integrated twice
    pre_rows = [np.array(x) for x in kw["imu_pre"].leaves()]
    for i in range(len(ids) - 1):
        nxt = estimator.states[ids[i + 1]]
        if len(nxt.imu_dt) and nxt.imu_from == ids[i]:
            pre = estimator._get_preintegrated(ids[i + 1])
            for full, one in zip(pre_rows, pre.leaves()):
                full[i] = np.asarray(one)
            kw["imu_mask"][i] = True
    kw["imu_pre"] = type(kw["imu_pre"])(*pre_rows)

    kk = 0
    for e in estimator.pose_graph_edges:
        if e.id_i in slot_of and e.id_j in slot_of and kk < rel_slots:
            kw["rel_i"][kk] = slot_of[e.id_i]
            kw["rel_j"][kk] = slot_of[e.id_j]
            kw["rel_T"][kk] = e.T_ij
            kw["rel_sqrt"][kk] = e.sqrt_info
            kw["rel_mask"][kk] = True
            kk += 1

    kw["pose_prior"][0] = pose[0]
    kw["pose_prior_sqrt"][0] = np.eye(6) * 1e4
    kw["pose_prior_mask"][0] = True
    kw["extrinsics"] = np.stack(estimator.T_SC)
    prob = problem_to_device(WindowProblem(**kw), estimator.device, estimator.dtype)
    return prob, ids, slot_of, lm_ids


def do_final_ba(estimator: Estimator, iterations: int = 30, mesh=None, max_states: int = 0,
                max_landmarks: int = 8192, max_obs: int = 65536) -> dict:
    """Expand the marginalisation edges, pack, solve, write back. Returns
    the restored observation count, the packed state and landmark counts
    and, without ``mesh``, ``final_ba_diagnostics``. ``max_states`` = 0
    grows the state capacity with the session.

    With ``mesh`` the call is SPMD: every rank of the mesh calls it with an
    estimator that holds the same session; the pack is sharded by landmark
    (``shard_problem_by_landmark``, which keeps the landmark order), solved
    over the group, and every rank writes back the same result."""
    n_restored = convert_edges_to_observations(estimator)
    prob, ids, slot_of, lm_ids = pack_full_ba_problem(estimator, max_states, max_landmarks,
                                                      max_obs)
    cfg = SolverConfig(max_iterations=iterations)
    if mesh is not None:
        solved, _stats = solve_full_graph_sharded(
            shard_problem_by_landmark(prob, mesh.size), estimator.cameras,
            estimator.imu_params, mesh, cfg, n_iterations=iterations)
    else:
        solved, _stats = solve_window(prob, estimator.cameras, estimator.imu_params, cfg)
    S = solved.S
    flat = torch.cat([solved.pose.reshape(-1), solved.speed_bias.reshape(-1),
                      solved.landmarks[:len(lm_ids)].reshape(-1)]).cpu().numpy()
    pose = flat[:S * 7].reshape(S, 7).astype(np.float64)
    sb = flat[S * 7:S * 16].reshape(S, 9).astype(np.float64)
    lms = flat[S * 16:].reshape(-1, 4).astype(np.float64)
    for s, i in slot_of.items():
        estimator.states[s].pose = pose[i]
        estimator.states[s].speed_bias = sb[i]
    for i, lid in enumerate(lm_ids):
        estimator.landmarks[lid].hp_W = lms[i]
    estimator._pre_cache.clear()
    info = {"restored_observations": n_restored, "states": len(ids), "landmarks": len(lm_ids)}
    if mesh is None:
        info.update(final_ba_diagnostics(solved, estimator.cameras, pose, sb, slot_of))
    return info


def final_ba_diagnostics(solved: WindowProblem, cameras, pose, sb, slot_of, grid: int = 12):
    """Final-BA observability (ViSlamBackend.cpp:1810-1881): per-camera
    reprojection-error heatmaps over a ``grid`` x ``grid`` image grid, the
    reprojection RMS in pixels, and the gyro and accelerometer biases'
    mean and spread over the session."""
    r_obs, m_obs = _reproj_residuals(solved, cameras)
    w = solved.obs_sqrt_info
    host = torch.cat([r_obs.reshape(-1), w, solved.obs_uv.reshape(-1)]).cpu().numpy()
    O = w.shape[0]
    r_obs, w, uv = host[:2 * O].reshape(O, 2), host[2 * O:3 * O], host[3 * O:].reshape(O, 2)
    sel = m_obs.cpu().numpy()
    cam_of = solved.obs_cam.cpu().numpy()
    # unwhiten to pixels
    err_px = np.linalg.norm(r_obs, axis=-1) / np.maximum(w, 1e-9)
    rms = float(np.sqrt(np.mean(err_px[sel] ** 2))) if sel.any() else 0.0
    heatmaps = []
    for ci, cam in enumerate(cameras):
        W, H = float(cam.width), float(cam.height)
        hm = np.zeros((grid, grid))
        cnt = np.zeros((grid, grid))
        s = sel & (cam_of == ci)
        gx = np.clip((uv[s, 0] / W * grid).astype(int), 0, grid - 1)
        gy = np.clip((uv[s, 1] / H * grid).astype(int), 0, grid - 1)
        np.add.at(hm, (gy, gx), err_px[s])
        np.add.at(cnt, (gy, gx), 1.0)
        heatmaps.append(hm / np.maximum(cnt, 1.0))
    idxs = sorted(slot_of.values())
    bg = sb[idxs, 3:6]
    ba = sb[idxs, 6:9]
    return {
        "reproj_rms_px": rms,
        "reproj_heatmaps": np.stack(heatmaps),
        "bias_gyro_mean": bg.mean(axis=0),
        "bias_gyro_std": bg.std(axis=0),
        "bias_accel_mean": ba.mean(axis=0),
        "bias_accel_std": ba.std(axis=0),
    }
