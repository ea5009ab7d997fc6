"""The port's synchronous SLAM loop against the JAX package's on the CPU.

The whole drive: both packages' ``run_synthetic_vio`` on the same star
dataset (192x128 stereo, 128 keypoints, 6 frames at 4 Hz, 1500 stars,
EstimatorConfig(window_slots=8, landmark_slots=192, obs_slots=1024,
imu_seg_capacity=64)), float64 cameras, the JAX package's RANSAC draws
injected into the port. The JAX package's frame program is float32 by
design, and under x64 its float32 carrier and readback mix float32 into a
float64 run; for this comparison it is run with float64 standing for
float32 in its frontend (as in test_torch_frontend_pipeline), so both
frontends run float64 on the same inputs and the port's applies the
previous solve at the frame program's precision, as the JAX loop does.

Measured on this drive: frames 0-1 agree to 1e-11 m; at frame 2 one
keypoint's descriptor differs by one bit between the packages (the
keypoints agree to 1e-14 px, and a descriptor comparison of two
intensities that tie to rounding can go either way), so static stereo
makes one landmark in the JAX run that the port does not, and the
trajectories part by ~1e-4 m over the next frames. Held: the same
keyframe flags, poses per frame within 1e-3 m, landmark counts within 3,
ATE within 1e-3 m of the JAX run's and below test_e2e_vio's 0.10 m.

Also held exactly, on the JAX drive's own records: need_new_keyframe at
several thresholds, tracking_quality, _coverage_iou and
_rank_keyframes_by_overlap; and _gather_imu's segments within 1e-12
(first frame, and boundaries between IMU samples).
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from okvis2_torch import interop
from okvis2_torch.graph.estimator import EstimatorConfig as TEst
from okvis2_torch.imu.preintegration import ImuParameters as TImu
from okvis2_torch.pipeline import frontend_pipeline as tfp
from okvis2_torch.pipeline import slam as tslam
from okvis2_torch.pipeline import synthetic_run as tsr
from okvis2_tpu.graph.estimator import EstimatorConfig as JEst
from okvis2_tpu.imu.preintegration import ImuParameters as JImu
from okvis2_tpu.pipeline import frontend_pipeline as jfp
from okvis2_tpu.pipeline import slam as jslam
from okvis2_tpu.pipeline import synthetic_run as jsr

DRIVE = dict(duration=1.5, frame_rate=4.0, width=192, height=128, max_keypoints=128,
             n_stars=1500)
EST = dict(window_slots=8, landmark_slots=192, obs_slots=1024, imu_seg_capacity=64)
POSE_TOL, LM_TOL, ATE_TOL = 1e-3, 3, 1e-3


def _jax_indices(counter):
    """The JAX frame program's RANSAC draws for frame ``counter``
    (frontend_pipeline.py:241, p3p.py:255-263), as the port's sampler."""
    key = jax.random.fold_in(jax.random.PRNGKey(42), counter)

    def sampler(mask, cam_idx, n_hyp, NC):
        keys = jax.random.split(key, n_hyp)
        m, ci = jnp.asarray(mask.cpu().numpy()), jnp.asarray(cam_idx.cpu().numpy(), jnp.int32)

        def one(k, cam):
            w = (m & (ci == cam)).astype(jnp.float64)
            return jax.lax.top_k(jax.random.gumbel(k, m.shape) + jnp.log(w + 1e-30), 3)[1]

        idx = jax.vmap(one)(keys, jnp.arange(n_hyp, dtype=jnp.int32) % NC)
        return torch.tensor(np.asarray(idx), dtype=torch.long, device=mask.device)

    return sampler


def _recording(cls, rec, frames_out):
    """``cls`` with every frame's (sid, pose, keyframe flag, landmark count)
    recorded through the optimised-graph callback, and the frontend's last
    frames kept."""

    class Recording(cls):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.set_optimised_graph_callback(lambda t, sid, pose, tr: rec.append(
                (sid, pose, tr.is_keyframe, len(self.estimator.landmarks))))
            assoc = self.frontend.associate_frame

            def associate(*a, **kw):
                frames, m = assoc(*a, **kw)
                frames_out[:] = [frames]
                return frames, m

            self.frontend.associate_frame = associate

    return Recording


@pytest.fixture(scope="module")
def drives():
    rj, rt, fj, ft = [], [], [], []
    shim = types.SimpleNamespace(**{k: getattr(np, k) for k in dir(np) if not k.startswith("__")})
    shim.float32 = np.float64
    with pytest.MonkeyPatch.context() as mp:
        # float64 stands for float32 in the JAX frontend (its program and
        # its numpy carrier); the compiled program stays in this module
        mp.setattr(jnp, "float32", jnp.float64)
        mp.setattr(jfp, "np", shim)
        mp.setattr(jsr, "SlamSystem", _recording(jslam.SlamSystem, rj, fj))
        jres = jsr.run_synthetic_vio(estimator_config=JEst(**EST), **DRIVE)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tsr, "SlamSystem", _recording(tslam.SlamSystem, rt, ft))
        tres = tsr.run_synthetic_vio(estimator_config=TEst(**EST), dtype=torch.float64,
                                     device="cpu", ransac_sampler=_jax_indices, **DRIVE)
    return {"jax": (jres, rj, fj[0]), "port": (tres, rt, ft[0])}


def test_synchronous_drive_matches(drives):
    jres, rj, _ = drives["jax"]
    tres, rt, _ = drives["port"]
    assert tres["frames"] == jres["frames"] == 6
    assert [r[0] for r in rt] == [r[0] for r in rj]
    assert [r[2] for r in rt] == [r[2] for r in rj]
    for (sid, pj, _, nj), (_, pt, _, nt) in zip(rj, rt):
        assert np.abs(pt[:3] - pj[:3]).max() < POSE_TOL, sid
        assert abs(nt - nj) <= LM_TOL, (sid, nt, nj)
    assert abs(tres["ate_rmse"] - jres["ate_rmse"]) < ATE_TOL, (tres["ate_rmse"],
                                                              jres["ate_rmse"])
    assert tres["ate_rmse"] < 0.10
    est = tres["slam"].estimator
    assert len(est.landmarks) > 50 and len(est.window) <= EST["window_slots"]
    assert len(est.pose_graph_edges) == len(jres["slam"].estimator.pose_graph_edges) >= 1


def _port_frontend(jslam_sys, **cfg):
    """A port Frontend holding the JAX frontend's keyframe store (host
    arrays only) and keyframe id, its config replaced by ``cfg``."""
    jfe = jslam_sys.frontend
    cams, exts = tsr.small_rig(DRIVE["width"], DRIVE["height"], dtype=torch.float64,
                               device="cpu")
    jcfg = dataclasses.replace(jfe.cfg, **cfg)
    tfe = tfp.Frontend(cams, exts, interop.frontend_config_from_numpy(dataclasses.asdict(jcfg)),
                       device="cpu")
    tfe._kf_store = {s: [{k: np.asarray(fr[k]) for k in ("xy", "size", "mask")} for fr in frs]
                     for s, frs in jfe._kf_store.items()}
    tfe.last_keyframe_id = jfe.last_keyframe_id
    return tfe, jcfg


def test_keyframe_and_tracking_decisions(drives):
    """The keyframe heuristic at several overlap and ratio thresholds, the
    tracking quality, the painted-disk coverage and the keyframe ranking,
    on the JAX drive's records (the estimator, the last frame, the
    keyframe store), from both packages' frontends."""
    jres, _, frames = drives["jax"]
    jsys = jres["slam"]
    est, jfe = jsys.estimator, jsys.frontend
    n_true = 0
    for thr in (0.0, 0.3, 0.6, 0.9, 1.01):
        for ratio in (0.0, 0.2, 0.5):
            tfe, jcfg = _port_frontend(jsys, keyframe_overlap_threshold=thr,
                                       keyframe_matching_ratio=ratio)
            jcfg_saved, jfe.cfg = jfe.cfg, jcfg
            try:
                for sid in est.window:
                    dj = jfe.need_new_keyframe(est, frames, sid)
                    assert tfe.need_new_keyframe(est, frames, sid) == dj, (thr, ratio, sid)
                    n_true += dj
            finally:
                jfe.cfg = jcfg_saved
    assert 0 < n_true < 5 * 3 * len(est.window)
    tfe, _ = _port_frontend(jsys)
    for sid in est.window:
        assert tfe.tracking_quality(est, frames, sid) == jfe.tracking_quality(est, frames, sid)
    rng = np.random.default_rng(0)
    for ci, fr in enumerate(frames):
        det = np.nonzero(np.asarray(fr["mask"]))[0]
        for _ in range(3):
            sub = rng.choice(det, size=len(det) // 3, replace=False)
            assert (tfe._coverage_iou(ci, fr["xy"], det, sub)
                    == jfe._coverage_iou(ci, fr["xy"], det, sub))
    cap = jfe.table.capacity
    hp = np.tile([0.0, 0, 0, 1], (cap, 1))
    lm_mask = np.zeros(cap, bool)
    for lid, s in jfe.table.slot_of.items():
        if lid in est.landmarks:
            hp[s], lm_mask[s] = est.landmarks[lid].hp_W, True
    sid = est.window[-1]
    for top_k in (1, 2, 3):
        for pose in (est.states[sid].pose, est.states[est.window[0]].pose):
            tr = tfe._rank_keyframes_by_overlap(est, pose, sid, hp, lm_mask, top_k)
            assert tr == jfe._rank_keyframes_by_overlap(est, pose, sid, hp, lm_mask, top_k)
            assert len(tr) >= 1


def test_gather_imu_segments():
    """The trapezoid segments with boundary interpolation: the first frame
    (raw averages up to t1), frames between IMU samples, and a frame after
    a gap in the IMU stream."""
    cams_j, exts_j = jsr.small_rig(64, 48)
    cams_t, exts_t = tsr.small_rig(64, 48, dtype=torch.float64, device="cpu")
    j = jslam.SlamSystem(cams_j, exts_j, JImu.create(g=9.81))
    t = tslam.SlamSystem(cams_t, exts_t, TImu.create(g=9.81, device="cpu"), device="cpu")
    rng = np.random.default_rng(1)
    ts = np.cumsum(rng.uniform(0.004, 0.006, 200))
    ts = ts[(ts < 0.4) | (ts > 0.5)]  # a gap of 0.1 s
    for tm in ts:
        a, w = rng.normal(size=3) + [0, 0, 9.81], rng.normal(size=3) * 0.1
        j.add_imu_measurement(tm, a, w)
        t.add_imu_measurement(tm, a, w)
    t0 = None
    for t1 in (0.0123, 0.0624, 0.1131, 0.2500, 0.4701, 0.5517, 0.7902):
        sj, st = j._gather_imu(t0, t1), t._gather_imu(t0, t1)
        for x, y in zip(st, sj):
            assert x.shape == y.shape
            np.testing.assert_allclose(x, y, rtol=0, atol=1e-12)
        assert len(st[2]) > 0
        if t0 is not None:  # the segment spans exactly [t0, t1]
            assert abs(st[2].sum() - (t1 - t0)) < 1e-12
        t0 = t1
    assert len(t._imu_queue) == len(j._imu_queue)


def test_circle_dataset_matches():
    """The circle trajectory (one circle per ``duration``): the datasets'
    IMU events and ground-truth poses within 1e-12, on the JAX package's
    CircleTrajectory and the port's."""
    from okvis2_torch.pipeline.dataset import SyntheticDataset as TData
    from okvis2_tpu.pipeline.dataset import SyntheticDataset as JData

    cams_j, exts_j = jsr.small_rig(64, 48)
    cams_t, exts_t = tsr.small_rig(64, 48, dtype=torch.float64, device="cpu")
    kw = dict(n_stars=50, duration=2.0, frame_rate=4.0, imu_rate=50.0, trajectory="circle")
    jd = JData(cams_j, exts_j, JImu.create(g=9.81), **kw)
    td = TData(cams_t, exts_t, TImu.create(g=9.81, device="cpu"), device="cpu", **kw)
    ev_j, ev_t = list(jd.stream()), list(td.stream())
    assert [e[0] for e in ev_t] == [e[0] for e in ev_j] and len(ev_t) > 90
    for a, b in zip(ev_t, ev_j):
        assert a[1] == b[1]
        for x, y in ((a[2], b[2]), (a[3], b[3])) if a[0] == "imu" else ((a[3], b[3]),):
            np.testing.assert_allclose(np.asarray(x), np.asarray(y), rtol=0, atol=1e-12)
    # half a circle: 2 * radius sideways
    np.testing.assert_allclose(td.ground_truth(1.0)[:2], [0.0, 3.0], atol=1e-12)
