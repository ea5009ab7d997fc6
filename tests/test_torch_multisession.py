"""Map save/load and multi-session relocalisation: the port against the JAX
package on the CPU, float64.

Session 1 is ``tests/test_multisession.py``'s (320x240 stereo, 128
keypoints, a 256-slot map table, 4 frames at 4 Hz of the star dataset,
seed 11) through the JAX package's synchronous ``SlamSystem``, with its
frontend run with float64 standing for float32 (as in
``tests/test_torch_slam.py``), and the map it saves is what the second
sessions of both packages load; the port's RANSAC draws are the JAX
package's. (A port-written map loaded by both packages is held in
``tests/test_torch_final_ba.py``, on records both packages share.) Held:

- the JAX-written map loaded by the port and by the JAX package gives
  equal landmarks, descriptors bit for bit, the same table slots and ring
  positions, and device table signs equal to the file's bits;
- twins of the three cases of ``tests/test_multisession.py``, each on
  both packages with the JAX-written map: the map relocalises at the start
  pose (both match > 10 landmarks, within 2 of each other: the frontends
  part where descriptor bits tie to rounding, ROADMAP C) and cleaning
  keeps the loaded points; depth-aided initialisation gives the same
  landmarks within 1e-9 m; relocalisation from a pose 3 m and 60 degrees
  off, on the JAX frontend's frames, gives the same query answers, a
  pose within 1e-9 m of the JAX one (within 0.25 m of the truth), the
  same pairs and the same observations after ``_apply_relocalisation``;
- the vocabulary bootstrapped from a map when none is loaded: equal words
  and weights, and equal component databases;
- the rigid correction epoch: a solve packed before a relocalisation is
  composed with its correction as ``_finish_one`` composes it, to 1e-12
  between the packages.
"""

import time

import numpy as np
import pytest
import torch

from okvis2_torch.core import se3_np
from okvis2_torch.frontend.detection import DetectionConfig as TDet
from okvis2_torch.graph import estimator as test_
from okvis2_torch.imu.preintegration import ImuParameters as TImu
from okvis2_torch.pipeline import frontend_pipeline as tfp
from okvis2_torch.pipeline.component_io import load_component
from okvis2_torch.pipeline import full_graph as tfg
from okvis2_torch.pipeline import slam as tslam
from okvis2_torch.pipeline import synthetic_run as tsr
from okvis2_tpu.frontend.detection import DetectionConfig as JDet
from okvis2_tpu.graph import estimator as jest
from okvis2_tpu.imu.preintegration import ImuParameters as JImu
from okvis2_tpu.pipeline import dataset as jds
from okvis2_tpu.pipeline import frontend_pipeline as jfp
from okvis2_tpu.pipeline import full_graph as jfg
from okvis2_tpu.pipeline import slam as jslam
from okvis2_tpu.pipeline import synthetic_run as jsr
from test_torch_loop_closure import _f64_jax_frontend, _jax_lc_sampler, _port_frames
from test_torch_pipelined import _flat_solve
from test_torch_slam import _jax_indices

EST = dict(window_slots=8, landmark_slots=256, obs_slots=1024, imu_seg_capacity=64)
WIDTH, HEIGHT, MAX_KP, TABLE_CAP = 320, 240, 128, 256
MATCH_GAP = 2


class _Pkg:
    """One package's SlamSystem constructor at the test's rig."""

    def __init__(self, name):
        self.jax = name == "jax"
        if self.jax:
            self.cams, self.exts = jsr.small_rig(width=WIDTH, height=HEIGHT)
            self.imu = JImu.create(g=9.81)
        else:
            self.cams, self.exts = tsr.small_rig(width=WIDTH, height=HEIGHT, dtype=torch.float64,
                                                 device="cpu")
            self.imu = TImu.create(g=9.81, device="cpu")

    def slam(self, loop=None):
        m = (jest, jfp, jfg, jslam, JDet) if self.jax else (test_, tfp, tfg, tslam, TDet)
        est, fp, fg, sl, Det = m
        kw = {} if self.jax else {"device": "cpu", "ransac_sampler": _jax_indices,
                                  "loop_ransac_sampler": _jax_lc_sampler}
        return sl.SlamSystem(
            self.cams, self.exts, self.imu, est.EstimatorConfig(**EST),
            fp.FrontendConfig(detection=Det(max_keypoints=MAX_KP), map_match_capacity=TABLE_CAP),
            do_loop_closures=loop is not None,
            loop_closure_config=None if loop is None else fg.LoopClosureConfig(**loop), **kw)


PKGS = {"jax": _Pkg("jax"), "port": _Pkg("port")}


def _table_np(table):
    as_np = lambda x: x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)  # noqa
    return as_np(table.signs), as_np(table.valid)


def _load(pkg, path, loop=None):
    slam = PKGS[pkg].slam(loop)
    n = slam.load_map(path)
    return slam, n


def _reloc_case(slam, ds, frames_to_port=None):
    """test_relocalisation_from_unknown_pose after the load: the frame at
    the true pose of t = 0.2 s, predicted 3 m and 60 degrees off."""
    est = slam.estimator
    true_pose = ds.ground_truth(0.2)
    ang = np.deg2rad(60.0)
    wrong = se3_np.compose7(np.array([3.0, -1.5, 0.5, 0.0, np.sin(ang / 2), 0.0, np.cos(ang / 2)]),
                            true_pose)
    sid = est.add_state(0.0, np.zeros((0, 3)), np.zeros((0, 3)), np.zeros(0))
    est.states[sid].pose = wrong.copy()
    frames, info = slam.frontend.associate_frame(est, ds.render(true_pose), sid, wrong)
    slam.frontend.fetch_signs(frames)
    if frames_to_port is not None:
        frames = frames_to_port(frames)
    lb = slam.loop_backend
    v = lb.relocalise(est, sid, frames)
    out = {"matched": int(info["num_matched"]), "query": list(lb.last_query_results), "v": v,
           "true": true_pose, "info": lb.last_verify_info}
    if v is not None:
        slam._apply_relocalisation(est, sid, frames, v)
        out["pose"] = est.states[sid].pose.copy()
        out["obs"] = sorted(est.obs_of_state(sid))
    return out


@pytest.fixture(scope="module")
def sessions(tmp_path_factory):
    d = tmp_path_factory.mktemp("maps")
    ds = jds.SyntheticDataset(PKGS["jax"].cams, PKGS["jax"].exts, PKGS["jax"].imu, n_stars=2000,
                              seed=11, duration=1.0, frame_rate=4.0)
    events = list(ds.stream())
    out = {"ds": ds}
    reloc_loop = dict(min_inliers=8)
    jframes = []
    with pytest.MonkeyPatch.context() as mp:
        _f64_jax_frontend(mp)
        slam = PKGS["jax"].slam()
        for ev in events:
            if ev[0] == "imu":
                slam.add_imu_measurement(ev[1], ev[2], ev[3])
            else:
                slam.add_images(ev[1], [np.asarray(im, np.float64) for im in ev[2]])
                slam.process_frame()
        out["jax landmarks"] = len(slam.estimator.landmarks)
        out["path"] = jmap = str(d / "jax.map")
        slam.save_map(jmap)
        # the cases' JAX sides, on the JAX-written map
        s, out["jax loaded"] = _load("jax", jmap)
        est = s.estimator
        pose0 = ds.ground_truth(0.0)
        sid = est.add_state(0.0, np.zeros((0, 3)), np.zeros((0, 3)), np.zeros(0))
        est.states[sid].pose = pose0
        _, info = s.frontend.associate_frame(est, ds.render(pose0), sid, pose0)
        est.clean_unobserved_landmarks()
        out["jax relocalises"] = (int(info["num_matched"]), len(est.landmarks))
        out["jax depth"] = _depth_case(PKGS["jax"].slam(), ds)
        s, _ = _load("jax", jmap, reloc_loop)
        out["jax unknown pose"] = _reloc_case(s, ds, lambda f: jframes.append(f) or f)
    s, _ = _load("port", jmap)
    est = s.estimator
    sid = est.add_state(0.0, np.zeros((0, 3)), np.zeros((0, 3)), np.zeros(0))
    est.states[sid].pose = pose0
    _, info = s.frontend.associate_frame(est, ds.render(pose0), sid, pose0)
    est.clean_unobserved_landmarks()
    out["port relocalises"] = (int(info["num_matched"]), len(est.landmarks))
    out["port depth"] = _depth_case(PKGS["port"].slam(), ds)
    s, _ = _load("port", jmap, reloc_loop)
    out["port unknown pose"] = _reloc_case(s, ds, lambda f: _port_frames(jframes[0]))
    return out


def _depth_case(slam, ds):
    """test_depth_aided_landmark_init: a 4 m depth map at the first frame."""
    est = slam.estimator
    pose0 = np.array([0.0, 0, 0, 0, 0, 0, 1.0])
    imgs = ds.render(pose0)
    sid = est.add_state(0.0, np.zeros((0, 3)), np.zeros((0, 3)), np.zeros(0))
    est.states[sid].pose = pose0
    frames, _ = slam.frontend.associate_frame(est, imgs, sid, pose0)
    H, W = imgs[0].shape
    slam.add_depth_image(0.0, np.full((H, W), 4.0))
    n = slam._init_landmarks_from_depth(frames, sid)
    lms = {lid: lm.hp_W.copy() for lid, lm in est.landmarks.items()
           if any(s == sid for (s, _, _) in lm.obs)}
    return n, lms, sorted(slam.frontend.table.slot_of.items())


def test_jax_map_loads_in_the_port(sessions):
    path = sessions["path"]
    with pytest.MonkeyPatch.context() as mp:
        _f64_jax_frontend(mp)
        sj, nj = _load("jax", path)
    st, nt = _load("port", path)
    assert nt == nj and nt > 30
    assert st.estimator.landmarks.keys() == sj.estimator.landmarks.keys()
    for lid, lm in sj.estimator.landmarks.items():
        np.testing.assert_array_equal(st.estimator.landmarks[lid].hp_W, lm.hp_W)
        assert st.estimator.landmarks[lid].initialised and not st.estimator.landmarks[lid].obs
    dj, dt = sj.frontend.lm_descriptors, st.frontend.lm_descriptors
    assert dt.keys() == dj.keys() and len(dt) > 30
    for lid in dj:
        np.testing.assert_array_equal(dt[lid], dj[lid])
    tj, tt = sj.frontend.table, st.frontend.table
    assert tt.slot_of == tj.slot_of and len(tt.slot_of) == len(dt)
    np.testing.assert_array_equal(tt.ring_next, tj.ring_next)
    assert tt.staged_count() == tj.staged_count() == 0
    (sg_j, va_j), (sg_t, va_t) = _table_np(tj), _table_np(tt)
    np.testing.assert_array_equal(sg_t, sg_j)
    np.testing.assert_array_equal(va_t, va_j)
    # the file's bits, read back from the port's device table (a fresh
    # system numbers the loaded landmarks in the file's order)
    data = load_component(path)
    words = {o["lid"]: o["descriptor"] for o in data["observations"] if "descriptor" in o}
    file_lid = list(data["landmarks"])
    for lid, s in tt.slot_of.items():
        bits = (words[file_lid[lid]][:, None] >> np.arange(32, dtype=np.uint32)) & 1
        np.testing.assert_array_equal(sg_t[s, 0] > 0, bits.reshape(-1) > 0)


def test_session_map_relocalises(sessions):
    assert sessions["jax landmarks"] > 30
    (mj, lj), (mt, lt) = sessions["jax relocalises"], sessions["port relocalises"]
    assert mj > 10 and mt > 10 and abs(mt - mj) <= MATCH_GAP, (mj, mt)
    # cleaning keeps every loaded map point, observed here or not
    assert lt == lj == sessions["jax loaded"] > 30, (lj, lt)


def test_depth_aided_landmark_init(sessions):
    nj, lj, sj = sessions["jax depth"]
    nt, lt, st = sessions["port depth"]
    assert nt == nj > 10
    assert lt.keys() == lj.keys() and st == sj
    for lid, hp in lj.items():
        np.testing.assert_allclose(lt[lid], hp, rtol=0, atol=1e-9)
        assert hp[2] / hp[3] > 3.0


def test_relocalisation_from_unknown_pose(sessions):
    j, t = sessions["jax unknown pose"], sessions["port unknown pose"]
    assert j["matched"] < 5 and t["matched"] < 5
    assert [k for k, _ in t["query"]] == [k for k, _ in j["query"]]
    np.testing.assert_allclose([s for _, s in t["query"]], [s for _, s in j["query"]], atol=1e-9)
    assert j["v"] is not None and t["v"] is not None, (j["info"], t["info"])
    np.testing.assert_allclose(t["v"]["T_WS7"], j["v"]["T_WS7"], rtol=0, atol=1e-9)
    assert t["v"]["pairs"] == j["v"]["pairs"] and t["v"]["num_inliers"] == j["v"]["num_inliers"]
    assert np.linalg.norm(t["v"]["T_WS7"][:3] - t["true"][:3]) < 0.25
    np.testing.assert_allclose(t["pose"], j["pose"], rtol=0, atol=1e-9)
    assert t["obs"] == j["obs"] and len(t["obs"]) >= 8


def test_bootstrapped_vocabulary_matches(sessions):
    loop = dict(vocabulary_path=None, min_inliers=8)
    path = sessions["path"]
    sj, _ = _load("jax", path, loop)
    st, _ = _load("port", path, loop)
    vj, vt = sj.loop_backend.voc, st.loop_backend.voc
    assert vj is not None and vt is not None
    np.testing.assert_array_equal(vt.centroid_signs, vj.centroid_signs)
    np.testing.assert_array_equal(vt.idf, vj.idf)
    cj, ct = sj.loop_backend._components, st.loop_backend._components
    assert len(ct) == len(cj) == 1 and ct[0]["docs"] == cj[0]["docs"]
    assert ct[0]["db"]._frame_ids == cj[0]["db"]._frame_ids
    for a, b in zip(ct[0]["db"]._vectors, cj[0]["db"]._vectors):
        np.testing.assert_array_equal(a, b)


def test_relocalisation_composes_onto_solves_in_flight():
    """A solve packed before a relocalisation (its epoch taken at dispatch)
    is composed with the relocalisation's rigid correction, as
    ``_finish_one`` composes it."""
    rng = np.random.default_rng(4)
    pose_s, vel_s = np.r_[0.2, -0.1, 0.05, 0.0, 0.0, 0.0, 1.0], rng.standard_normal(9)
    hp_s = np.array([0.5, -1.0, 4.0, 1.0])
    T_meas = np.r_[1.0, 3.0, -0.2, 0.0, 0.0, np.sin(0.2), np.cos(0.2)]
    recs = []
    with pytest.MonkeyPatch.context() as mp:
        _f64_jax_frontend(mp)
        for pkg in ("jax", "port"):
            slam = PKGS[pkg].slam(loop={})
            est = slam.estimator
            sid = est.add_state(0.0, np.zeros((0, 3)), np.zeros((0, 3)), np.zeros(0))
            lid = est.add_landmark([1.0, 2.0, 5.0, 1.0], initialised=True)
            epoch = slam._corr_epoch  # the in-flight solve's dispatch
            est._solve_t0 = time.perf_counter()
            slam._apply_relocalisation(est, sid, None, {"T_WS7": T_meas, "pairs": []})
            corr = slam._net_correction_since(epoch)
            est.apply_solved_flat(_flat_solve(est, {0: pose_s}, {0: vel_s}, [hp_s]), {sid: 0},
                                  [lid], T_corr7=corr, solve_t0=est._solve_t0)
            recs.append((corr, slam._corr_log[-1], est.states[sid].pose.copy(),
                         est.states[sid].speed_bias.copy(), est.landmarks[lid].hp_W.copy(),
                         slam._relocalisations))
    for a, b in zip(*recs):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)
    corr, logged, pose, sb, hp, n = recs[1]
    T_corr = se3_np.compose7(T_meas, se3_np.inverse7(np.r_[0.0, 0, 0, 0, 0, 0, 1]))
    np.testing.assert_allclose(corr, T_corr, rtol=0, atol=1e-12)
    np.testing.assert_allclose(logged, T_corr, rtol=0, atol=1e-12)
    np.testing.assert_allclose(pose, se3_np.compose7(T_corr, pose_s), rtol=0, atol=1e-12)
    R = se3_np.quat_to_mat(T_corr[3:7])
    np.testing.assert_allclose(sb[:3], R @ vel_s[:3], rtol=0, atol=1e-12)
    np.testing.assert_allclose(hp[:3], R @ hp_s[:3] + T_corr[:3], rtol=0, atol=1e-12)
    assert n == 1
