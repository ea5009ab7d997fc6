"""Options of the port's estimator and SLAM loop that no other parity file
drives, each run through both packages on the CPU at
``test_torch_slam.py``'s sizes and with its harness (float64 standing for
float32 in the JAX frame program, the JAX RANSAC draws injected into the
port, per-frame records through the optimised-graph callback):

- vision-only mode (``EstimatorConfig(use_imu=False)``, the pseudo-IMU
  links) on ``tests/test_vision_only.py``'s 6-frame drive at 192x128;
- online extrinsics: ``tests/test_online_calibration.py``'s solver case
  (a perturbed camera recovered within 1e-4 with the poses frozen) and its
  estimator wiring case, run through both packages' estimators on the same
  scripted window (calibrated extrinsics within 1e-6 m of each other);
- a 4-camera rig (``regression_drives._rig_fourcam``): all-pairs static
  stereo and rig-joint tracking on ``tests/test_multicamera_rig.py``'s
  4-frame drive;
- the lost-tracking restart (``SlamSystem._reinitialise``): five "Lost"
  frames in a row (blank images) restart the map and the window, and the
  next frame with images makes a keyframe and landmarks again.

The drives hold what ``test_synchronous_drive_matches`` holds: the same
states and keyframe flags, poses per frame within 1e-3 m and landmark
counts within 3 of the JAX run's; the restart also holds the tracking
quality per frame, the restart frame and the window after it equal. The
bars of the JAX package's own tests stay as extra checks.
"""

import dataclasses
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from okvis2_torch.core import se3_np
from okvis2_torch.core.se3 import Transformation as TT
from okvis2_torch.frontend.detection import DetectionConfig
from okvis2_torch.graph.estimator import Estimator, EstimatorConfig
from okvis2_torch.imu.preintegration import ImuParameters
from okvis2_torch.pipeline import regression_drives
from okvis2_torch.pipeline import slam as tslam
from okvis2_torch.pipeline.dataset import SyntheticDataset
from okvis2_torch.pipeline.frontend_pipeline import FrontendConfig
from okvis2_torch.pipeline.synthetic_run import small_rig
from okvis2_torch.pipeline.trajectory import ate_rmse
from okvis2_torch.solver.gauss_newton import SolverConfig, _oplus_pose, solve_window
from okvis2_torch.utils import synthetic as tsyn
from okvis2_tpu.core.se3 import Transformation as JT
from okvis2_tpu.frontend.detection import DetectionConfig as JDet
from okvis2_tpu.graph.estimator import Estimator as JEstimator
from okvis2_tpu.graph.estimator import EstimatorConfig as JEstimatorConfig
from okvis2_tpu.imu.preintegration import ImuParameters as JImu
from okvis2_tpu.pipeline import frontend_pipeline as jfp
from okvis2_tpu.pipeline import regression_drives as jdrives
from okvis2_tpu.pipeline import slam as jslam
from okvis2_tpu.pipeline import synthetic_run as jsr
from okvis2_tpu.pipeline.dataset import SyntheticDataset as JDataset
from okvis2_tpu.utils import synthetic as jsyn

from test_torch_slam import LM_TOL, POSE_TOL, _jax_indices, _recording

SMALL = dict(width=192, height=128, max_keypoints=128, n_stars=1500)


def _feed(slam, ds, blank, quality, gt):
    """Feed ``ds``'s stream; frames whose index is in ``blank`` get black
    images. Appends each frame's tracking quality and ground truth."""
    for ev in ds.stream():
        if ev[0] == "imu":
            slam.add_imu_measurement(ev[1], ev[2], ev[3])
            continue
        images = [np.zeros_like(im) for im in ev[2]] if len(quality) in blank else ev[2]
        slam.add_images(ev[1], images)
        slam.process_frame()
        quality.append(slam.tracking.tracking_quality)
        gt.append((ev[1], np.asarray(ev[3])))


def _drive(pkg, rig, est, fe, ds, blank=()):
    """One synchronous drive through ``pkg``'s ``SlamSystem`` ("jax" or
    "port") on that package's star dataset. ``rig`` is "small" (the
    192x128 stereo radtan rig) or "fourcam"; ``est``, ``fe`` and ``ds``
    are the estimator, frontend (with "max_keypoints") and dataset
    keywords. Returns the per-frame records (sid, pose, keyframe flag,
    landmark count), tracking qualities, ground truth and restarts (frame,
    landmarks before, landmarks after, window after) and the system."""
    out = dict(rec=[], quality=[], gt=[], restarts=[])
    fe = dict(fe)
    det = dict(max_keypoints=fe.pop("max_keypoints"))

    def run(cls, cams, exts, imu, est_cfg, fe_cfg, dataset_cls, **kw):
        slam = _recording(cls, out["rec"], [])(cams, exts, imu, est_cfg, fe_cfg, **kw)
        reinit = slam._reinitialise

        def recorded():
            n_before = len(slam.estimator.landmarks)
            reinit()
            out["restarts"].append((slam.frames_processed, n_before,
                                    len(slam.estimator.landmarks), list(slam.estimator.window)))

        slam._reinitialise = recorded
        dev = {} if cls is jslam.SlamSystem else {"device": "cpu"}
        _feed(slam, dataset_cls(cams, exts, imu, **ds, **dev), blank, out["quality"], out["gt"])
        slam.estimator.apply_pending_solve()
        out["slam"] = slam

    if pkg == "jax":
        shim = types.SimpleNamespace(**{k: getattr(np, k) for k in dir(np)
                                        if not k.startswith("__")})
        shim.float32 = np.float64
        with pytest.MonkeyPatch.context() as mp:
            # float64 stands for float32 in the JAX frontend, as in
            # test_torch_slam, and in the loop's zero solve buffer of the
            # first frames (one compile of the frame program, not two)
            mp.setattr(jnp, "float32", jnp.float64)
            mp.setattr(jfp, "np", shim)
            mp.setattr(jslam, "np", shim)
            cams, exts = (jsr.small_rig(SMALL["width"], SMALL["height"]) if rig == "small"
                          else jdrives._rig_fourcam())
            run(jslam.SlamSystem, cams, exts, JImu.create(g=9.81), JEstimatorConfig(**est),
                jfp.FrontendConfig(detection=JDet(**det), **fe), JDataset)
    else:
        cams, exts = (small_rig(SMALL["width"], SMALL["height"], dtype=torch.float64,
                                device="cpu") if rig == "small"
                      else regression_drives._rig_fourcam(device="cpu"))
        run(tslam.SlamSystem, cams, exts, ImuParameters.create(g=9.81, device="cpu"),
            EstimatorConfig(**est), FrontendConfig(detection=DetectionConfig(**det), **fe),
            SyntheticDataset, device="cpu", ransac_sampler=_jax_indices)
    return out


def _hold_to_jax(j, t):
    """The port's drive ``t`` against the JAX drive ``j``: the same states
    and keyframe flags, poses within POSE_TOL, landmark counts within
    LM_TOL."""
    assert [r[0] for r in t["rec"]] == [r[0] for r in j["rec"]]
    assert [r[2] for r in t["rec"]] == [r[2] for r in j["rec"]]
    for (sid, pj, _, nj), (_, pt, _, nt) in zip(j["rec"], t["rec"]):
        assert np.abs(pt[:3] - pj[:3]).max() < POSE_TOL, sid
        assert abs(nt - nj) <= LM_TOL, (sid, nt, nj)
    assert t["slam"].frames_processed == j["slam"].frames_processed


def test_vision_only_drive():
    est = dict(window_slots=10, landmark_slots=384, obs_slots=2048, imu_seg_capacity=16,
               use_imu=False)
    fe = dict(max_keypoints=SMALL["max_keypoints"])
    ds = dict(duration=1.5, frame_rate=4.0, n_stars=SMALL["n_stars"])
    j, t = (_drive(pkg, "small", est, fe, ds) for pkg in ("jax", "port"))
    _hold_to_jax(j, t)
    assert t["slam"].frames_processed == 6
    ate_t = ate_rmse(t["slam"].trajectory(), t["gt"], align=True)
    ate_j = ate_rmse(j["slam"].trajectory(), j["gt"], align=True)
    assert abs(ate_t - ate_j) < 1e-3, (ate_t, ate_j)
    assert np.isfinite(ate_t) and ate_t < 0.25, ate_t
    assert len(t["slam"].estimator.landmarks) > 50


def test_online_extrinsics_recovered():
    problem, cams, imu, _ = tsyn.build_problem(num_states=4, n_landmarks_side=6, device="cpu")
    ext_true = problem.extrinsics.clone()
    d = torch.zeros((2, 6), dtype=torch.float64)
    d[1] = torch.tensor([0.01, -0.008, 0.012, 0.01, -0.005, 0.008])
    problem = dataclasses.replace(
        problem, pose_frozen=torch.ones(problem.S, dtype=torch.bool),
        sb_frozen=torch.ones(problem.S, dtype=torch.bool),
        ext_frozen=torch.tensor([True, False]), extrinsics=_oplus_pose(problem.extrinsics, d),
        imu_mask=torch.zeros_like(problem.imu_mask))
    solved, _ = solve_window(problem, cams, imu, SolverConfig(max_iterations=15))
    ext = solved.extrinsics.numpy()
    np.testing.assert_allclose(ext[0], ext_true[0].numpy(), rtol=0, atol=1e-12)
    np.testing.assert_allclose(ext[1][:3], ext_true[1][:3].numpy(), atol=1e-4)
    dq = se3_np.quat_mul(se3_np.quat_conj(ext_true[1][3:7].numpy()), ext[1][3:7])
    assert float(np.linalg.norm(se3_np.log_so3(dq))) < 1e-4


def _scripted_online_extrinsics(pkg):
    """``test_online_calibration.py``'s wiring case through ``pkg``'s
    estimator: cam 1's extrinsics 14 mm off, three frozen states, 30
    landmarks; returns (error before, error after, calibrated T_SC[1])."""
    cams_j, exts_j = jsyn.stereo_rig()
    ext1_true = np.concatenate([np.asarray(exts_j[1].r), np.asarray(exts_j[1].q)])
    pert = ext1_true.copy()
    pert[0] += 0.012
    pert[1] -= 0.008
    cfg = dict(online_extrinsics=True, ext_sigma_r=0.05, ext_sigma_alpha=0.05)
    if pkg == "jax":
        cams = cams_j
        exts = [exts_j[0], JT(r=jnp.asarray(pert[:3]), q=jnp.asarray(pert[3:7]))]
        est = JEstimator(cams, exts, JImu.create(g=9.81), JEstimatorConfig(**cfg))

        def project(cam, p_C):
            uv, valid = cam.project(jnp.asarray(p_C))
            return np.asarray(uv), bool(valid)
    else:
        cams, exts_t = tsyn.stereo_rig(device="cpu")
        exts = [exts_t[0], TT(r=torch.tensor(pert[:3]), q=torch.tensor(pert[3:7]))]
        est = Estimator(cams, exts, ImuParameters.create(g=9.81, device="cpu"),
                        EstimatorConfig(**cfg), device="cpu")

        def project(cam, p_C):
            uv, valid = cam.project(torch.tensor(p_C))
            return uv.numpy(), bool(valid)
    rng = np.random.default_rng(0)
    pts = rng.uniform([-2, -2, 4], [2, 2, 8], size=(30, 3))
    poses = [np.array([0.0, 0, 0, 0, 0, 0, 1.0]), np.array([0.3, 0.1, 0, 0, 0, 0, 1.0]),
             np.array([-0.2, 0.2, 0.1, 0, 0, 0, 1.0])]
    sids = []
    for k, p in enumerate(poses):
        sid = est.add_state(k * 0.1, np.zeros((0, 3)), np.zeros((0, 3)), np.zeros(0))
        est.states[sid].pose = p
        est.states[sid].frozen = True
        sids.append(sid)
    T_SC7 = [np.concatenate([np.asarray(T.r), np.asarray(T.q)]) for T in exts_j]
    for i, pt in enumerate(pts):
        lid = est.add_landmark(np.concatenate([pt, [1.0]]), initialised=True)
        for sid, p in zip(sids, poses):
            for ci, cam in enumerate(cams):
                T_WC = se3_np.compose7(p, T_SC7[ci])
                p_C = se3_np.quat_to_mat(T_WC[3:7]).T @ (pt - T_WC[:3])
                if p_C[2] < 0.1:
                    continue
                uv, valid = project(cam, p_C)
                if valid:
                    est.add_observation(lid, sid, ci, i, uv)
    err0 = np.linalg.norm(est.T_SC[1][:3] - ext1_true[:3])
    est.optimise(iterations=15)
    return err0, np.linalg.norm(est.T_SC[1][:3] - ext1_true[:3]), np.asarray(est.T_SC[1])


def test_online_extrinsics_wiring_matches():
    e0j, e1j, Tj = _scripted_online_extrinsics("jax")
    e0t, e1t, Tt = _scripted_online_extrinsics("port")
    assert e0t == e0j
    assert e1t < e0t * 0.6, (e0t, e1t)
    np.testing.assert_allclose(Tt[:3], Tj[:3], rtol=0, atol=1e-6)
    assert abs(abs(float(np.dot(Tt[3:7], Tj[3:7]))) - 1.0) < 1e-9


def test_four_camera_drive():
    cams, _ = regression_drives._rig_fourcam(device="cpu")
    assert len(cams) == 4 and cams[0].focal.dtype == torch.float64
    est = dict(window_slots=8, landmark_slots=384, obs_slots=2048, imu_seg_capacity=64)
    fe = dict(max_keypoints=96, map_match_capacity=384)
    ds = dict(n_stars=3000, seed=13, duration=1.0, frame_rate=4.0, imu_rate=100.0)
    j, t = (_drive(pkg, "fourcam", est, fe, ds) for pkg in ("jax", "port"))
    _hold_to_jax(j, t)
    slam = t["slam"]
    pairs = slam.frontend._overlapping_pairs()
    assert pairs == j["slam"].frontend._overlapping_pairs()
    assert (0, 1) in pairs and (2, 3) in pairs, pairs
    est = slam.estimator
    assert slam.frames_processed == 4
    hosting = {ci for lm in est.landmarks.values() for (_s, ci, _kp) in lm.obs}
    assert {0, 1, 2, 3} <= hosting, hosting
    sid = est.window[-1]
    assert len({ci for (_l, ci, _k) in est.obs_of_state(sid)}) >= 3
    assert np.linalg.norm(est.states[sid].pose[:3] - t["gt"][-1][1][:3]) < 0.15


def test_lost_tracking_restart():
    # the vision-only drive's slots (the JAX frame program compiled there is
    # reused) and 3 LM iterations per frame (the bench's budget): the
    # restart, not the solve, is under test
    est = dict(window_slots=10, landmark_slots=384, obs_slots=2048, imu_seg_capacity=64,
               realtime_iterations=3)
    fe = dict(max_keypoints=SMALL["max_keypoints"])
    ds = dict(duration=3.0, frame_rate=4.0, n_stars=SMALL["n_stars"])
    j, t = (_drive(pkg, "small", est, fe, ds, blank=range(6, 11)) for pkg in ("jax", "port"))
    _hold_to_jax(j, t)
    quality = t["quality"]
    assert quality == j["quality"], (quality, j["quality"])
    assert t["restarts"] == j["restarts"], (t["restarts"], j["restarts"])
    assert quality[:6] == ["Good"] * 6, quality
    assert quality[6:11] == ["Lost"] * 5, quality
    # the fifth "Lost" frame in a row (frame 10) restarts the map and window
    assert len(t["restarts"]) == 1, t["restarts"]
    frame, n_before, n_after, window = t["restarts"][0]
    assert frame == 10 and n_before > 50 and n_after == 0 and len(window) == 1
    slam = t["slam"]
    assert slam.frontend.last_keyframe_id is not None  # a keyframe since the restart
    assert slam.frontend.last_keyframe_id == j["slam"].frontend.last_keyframe_id
    assert len(slam.estimator.landmarks) > 30
    assert quality[11] != "Lost" and slam.frames_processed == 12 and slam._lost_count == 0
