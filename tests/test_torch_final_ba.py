"""The port's final bundle adjustment and map files against the JAX
package's on the CPU, in float64.

The session is ``tests/test_torch_estimator.py``'s scripted estimator
drive without its window solves (IMU-propagated states on the synthetic
trajectory, noisy wall observations, keyframes on every other state,
marginalisation and landmark cleaning each step), fed to both packages;
after each step the port's pose-graph factors take the JAX values (eigh
may sign their sqrt_info differently), so both hold identical records.
Held on it:

- the map files: ``save_component`` of identical records and
  descriptors gives the same bytes in both packages, and each package's
  ``load_component`` reads either file to equal dicts, descriptors bit for
  bit; ``SlamSystem.save_map`` over the same records and descriptor signs
  writes the same bytes in both packages, and ``SlamSystem.load_map`` of
  the port-written file in both packages gives equal landmarks,
  descriptor signs bit for bit, the same table slots and ring positions,
  and device table signs equal to the file's bits;
- ``convert_edges_to_observations``: the same restored count and
  observations, the loop edge kept;
- ``pack_full_ba_problem``: every field within 1e-12 (indices and masks
  equal);
- ``do_final_ba`` (10 LM iterations at S/L/O 32/64/1024): poses within
  1e-6 m, landmark points within 1e-6 m, the diagnostics within 1e-9
  relative;
- the IMU-chain case of ``tests/test_imu_chain.py:82`` in both packages:
  each link integrates its own interval once, the packs' ``dt_total``
  within 1e-12;
- the reverse-marginalisation unit case of
  ``tests/test_final_ba.py::test_convert_edges_restores_observations``.
"""

import numpy as np
import pytest
import torch

from okvis2_torch.core import se3_np
from okvis2_torch.graph import estimator as test_
from okvis2_torch.imu import preintegration as tpre
from okvis2_torch.pipeline import component_io as tcio
from okvis2_torch.pipeline import final_ba as tfba
from okvis2_torch.pipeline import slam as tslam
from okvis2_torch.utils import synthetic as tsyn
from okvis2_tpu.graph import estimator as jest
from okvis2_tpu.imu import preintegration as jpre
from okvis2_tpu.pipeline import component_io as jcio
from okvis2_tpu.pipeline import final_ba as jfba
from okvis2_tpu.pipeline import slam as jslam
from okvis2_tpu.utils import synthetic as jsyn
from test_torch_estimator import _check_pack, _drive_estimators, _scene, _sync

FBA_CAPS = dict(max_states=0, max_landmarks=64, max_obs=1024)
FBA_ITERATIONS = 10
POSE_TOL_M, LM_TOL_M, DIAG_RTOL = 1e-6, 1e-6, 1e-9


def _session():
    """Both packages' estimators after the scripted drive (no window
    solves), with a loop edge between the first and last state that
    measures their relative pose with a small error."""
    j, t = _drive_estimators()
    steps, wall, v0, lm_noise = _scene()
    lid_of = {}
    for k, (time_k, imu_k, obs) in enumerate(steps):
        w, a, dt = imu_k if imu_k is not None else (np.zeros((0, 3)), np.full((1, 3), [0, 0, 9.81]),
                                                     np.zeros(0))
        sid = [e.add_state(time_k, w, a, dt) for e in (j, t)][0]
        if k == 0:
            for e in (j, t):
                e.states[sid].speed_bias[:3] = v0
        for (li, ci, u, v, size) in obs:
            if li not in lid_of:
                hp = np.concatenate([wall[li, :3] + lm_noise[li], [1.0]])
                lid_of[li] = [e.add_landmark(hp, initialised=li % 3 != 0) for e in (j, t)][0]
            for e in (j, t):
                e.add_observation(lid_of[li], sid, ci, li, (u, v), size)
        for e in (j, t):
            e.set_keyframe(sid, k % 2 == 0)
            if k % 2 == 0:
                e.expand_keyframe(sid)
            e.apply_marginalisation_strategy()
            e.clean_unobserved_landmarks()
        _sync(j, t)
    first, last = j.state_order[0], j.state_order[-1]
    T_ij = se3_np.compose7(se3_np.inverse7(j.states[first].pose), j.states[last].pose)
    T_ij[:3] += [0.004, -0.002, 0.003]
    sq = np.diag([50.0, 50.0, 50.0, 200.0, 200.0, 200.0])
    j.pose_graph_edges.append(jest.PoseGraphEdge(first, last, T_ij, sq, [], "loop"))
    t.pose_graph_edges.append(test_.PoseGraphEdge(first, last, T_ij.copy(), sq.copy(), [], "loop"))
    return j, t


@pytest.fixture(scope="module")
def session():
    j, t = _session()
    n_marg = sum(e.kind == "marg" and bool(e.stored_obs) for e in j.pose_graph_edges)
    assert n_marg >= 1, "the drive must leave marginalisation edges with stored observations"
    rng = np.random.default_rng(0)
    descs = {lid: rng.integers(0, 2 ** 32, 16, dtype=np.uint64).astype(np.uint32)
             for lid in list(j.landmarks)[::2]}
    return {"est": (j, t), "descs": descs}


def _equal_dicts(a, b, path="component"):
    assert type(a) is type(b) or (isinstance(a, np.ndarray) and isinstance(b, np.ndarray)), path
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _equal_dicts(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _equal_dicts(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert a == b, path


def test_component_files_identical(session, tmp_path):
    j, t = session["est"]
    pj, pt = str(tmp_path / "jax.map"), str(tmp_path / "port.map")
    jcio.save_component(pj, j, session["descs"])
    tcio.save_component(pt, t, session["descs"])
    text = open(pj, "rb").read()
    assert text == open(pt, "rb").read()
    assert text.count(b"EDGE_REL") == len(j.pose_graph_edges) and b"EDGE_IMU" in text
    for reader in (jcio.load_component, tcio.load_component):
        _equal_dicts(reader(pj), jcio.load_component(pt))
    loaded = tcio.load_component(pj)
    got = {o["lid"]: o["descriptor"] for o in loaded["observations"] if "descriptor" in o}
    assert got.keys() == session["descs"].keys()
    for lid, words in got.items():
        np.testing.assert_array_equal(words, session["descs"][lid])


def _words_to_signs(words):
    bits = (np.asarray(words, np.uint32)[:, None] >> np.arange(32, dtype=np.uint32)) & 1
    return np.where(bits.reshape(-1) > 0, 1.0, -1.0).astype(np.float32)


def _slam(pkg, est=None):
    """A SlamSystem of either package on the stereo rig, holding ``est``."""
    if pkg == "jax":
        cams, exts = jsyn.stereo_rig()
        slam = jslam.SlamSystem(cams, list(exts), jpre.ImuParameters.create(g=9.81))
    else:
        cams, exts = tsyn.stereo_rig(device="cpu")
        slam = tslam.SlamSystem(cams, list(exts), tpre.ImuParameters.create(g=9.81, device="cpu"),
                                device="cpu")
    if est is not None:
        slam.estimator = est
    return slam


def test_save_map_and_load_map_across_packages(session, tmp_path):
    j, t = session["est"]
    signs = {lid: _words_to_signs(w) for lid, w in session["descs"].items()}
    paths = {}
    for pkg, est in (("jax", j), ("port", t)):
        slam = _slam(pkg, est)
        slam.frontend.lm_descriptors = {lid: sg.copy() for lid, sg in signs.items()}
        paths[pkg] = str(tmp_path / f"{pkg}.map")
        slam.save_map(paths[pkg])
    assert open(paths["port"], "rb").read() == open(paths["jax"], "rb").read()
    data = tcio.load_component(paths["port"])
    file_lid = list(data["landmarks"])
    loaded = {pkg: _slam(pkg) for pkg in ("jax", "port")}
    n = {pkg: s.load_map(paths["port"]) for pkg, s in loaded.items()}
    sj, st = loaded["jax"], loaded["port"]
    assert n["port"] == n["jax"] == len(file_lid) == len(t.landmarks)
    assert st.estimator.landmarks.keys() == sj.estimator.landmarks.keys()
    for lid, lm in sj.estimator.landmarks.items():
        np.testing.assert_array_equal(st.estimator.landmarks[lid].hp_W, lm.hp_W)
    dj, dt = sj.frontend.lm_descriptors, st.frontend.lm_descriptors
    assert dt.keys() == dj.keys() and len(dt) == len(signs)
    for lid, sg in dt.items():
        np.testing.assert_array_equal(sg, dj[lid])
        np.testing.assert_array_equal(sg, signs[file_lid[lid]])
    tj, tt = sj.frontend.table, st.frontend.table
    assert tt.slot_of == tj.slot_of and tt.staged_count() == tj.staged_count() == 0
    np.testing.assert_array_equal(tt.ring_next, tj.ring_next)
    sg_t, va_t = tt.signs.numpy(), tt.valid.numpy()
    np.testing.assert_array_equal(sg_t, np.asarray(tj.signs))
    np.testing.assert_array_equal(va_t, np.asarray(tj.valid))
    for lid, s in tt.slot_of.items():
        np.testing.assert_array_equal(sg_t[s, 0], signs[file_lid[lid]])
        assert va_t[s, 0] and tt.ring_next[s] == 1


@pytest.fixture(scope="module")
def final_ba(session):
    j, t = session["est"]
    restored = (jfba.convert_edges_to_observations(j), tfba.convert_edges_to_observations(t))
    packs = (jfba.pack_full_ba_problem(j, **FBA_CAPS), tfba.pack_full_ba_problem(t, **FBA_CAPS))
    infos = (jfba.do_final_ba(j, FBA_ITERATIONS, **FBA_CAPS),
             tfba.do_final_ba(t, FBA_ITERATIONS, **FBA_CAPS))
    return {"restored": restored, "packs": packs, "infos": infos}


def test_convert_edges_to_observations_matches(session, final_ba):
    j, t = session["est"]
    nj, nt = final_ba["restored"]
    assert nt == nj > 0
    assert [(e.id_i, e.id_j, e.kind) for e in t.pose_graph_edges] == \
        [(e.id_i, e.id_j, e.kind) for e in j.pose_graph_edges]
    assert [e.kind for e in t.pose_graph_edges] == ["loop"]
    for lid, lm in j.landmarks.items():
        assert dict(t.landmarks[lid].obs) == dict(lm.obs), lid


def test_pack_full_ba_problem_matches(final_ba):
    (jp, jids, jslot, jlm), (tp, tids, tslot, tlm) = final_ba["packs"]
    assert tids == jids and tslot == jslot and tlm == jlm
    assert tp.S == 32 and len(tids) > 4 and len(tlm) > 10
    _check_pack(jp, tp)
    assert int(tp.rel_mask.sum()) == 1 and int(tp.imu_mask.sum()) >= 1


def test_do_final_ba_matches(session, final_ba):
    j, t = session["est"]
    ij, it = final_ba["infos"]
    for k in ("restored_observations", "states", "landmarks"):
        assert it[k] == ij[k], k
    for sid, rec in j.states.items():
        np.testing.assert_allclose(t.states[sid].pose, rec.pose, rtol=0, atol=POSE_TOL_M)
    for lid, lm in j.landmarks.items():
        p_t, p_j = t.landmarks[lid].hp_W, lm.hp_W
        np.testing.assert_allclose(p_t[:3] / p_t[3], p_j[:3] / p_j[3], rtol=0, atol=LM_TOL_M)
    for k in ("reproj_rms_px", "reproj_heatmaps", "bias_gyro_mean", "bias_gyro_std",
              "bias_accel_mean", "bias_accel_std"):
        a, b = np.asarray(it[k]), np.asarray(ij[k])
        assert a.shape == b.shape, k
        np.testing.assert_allclose(a, b, rtol=DIAG_RTOL, atol=DIAG_RTOL * max(np.abs(b).max(), 1e-30),
                                   err_msg=k)
    assert it["reproj_heatmaps"].shape == (2, 12, 12)
    assert 0.0 < it["reproj_rms_px"] < 3.0


def _chain_estimators():
    """tests/test_imu_chain.py's estimator in both packages: 20 states at
    10 Hz with constant IMU, keyframes on every other one, marginalised."""
    cfg = dict(num_keyframes=3, num_imu_frames=2, window_slots=8, num_pose_graph_frames=2)
    jcams, jexts = jsyn.stereo_rig()
    tcams, texts = tsyn.stereo_rig(device="cpu")
    j = jest.Estimator(jcams, list(jexts), jpre.ImuParameters.create(g=9.81),
                       jest.EstimatorConfig(**cfg))
    t = test_.Estimator(tcams, list(texts), tpre.ImuParameters.create(g=9.81, device="cpu"),
                        test_.EstimatorConfig(**cfg), device="cpu")
    for e in (j, t):
        for k in range(20):
            n = 0 if k == 0 else 10
            e.add_state(k * 0.1, np.zeros((n, 3)), np.tile([0.0, 0.0, 9.81], (n, 1)),
                        np.full(n, 0.01))
        for sid in list(e.states)[::2]:
            e.set_keyframe(sid)
        e.apply_marginalisation_strategy()
    return j, t


def test_final_ba_links_cover_session_once():
    j, t = _chain_estimators()
    (jp, jids, _, _), (tp, tids, _, _) = (jfba.pack_full_ba_problem(j, max_states=32),
                                          tfba.pack_full_ba_problem(t, max_states=32))
    assert tids == jids
    n = len(tids) - 1
    dt_t, m_t = tp.imu_pre.dt_total.numpy()[:n], tp.imu_mask.numpy()[:n]
    np.testing.assert_array_equal(m_t, np.asarray(jp.imu_mask)[:n])
    np.testing.assert_allclose(dt_t, np.asarray(jp.imu_pre.dt_total)[:n], rtol=0, atol=1e-12)
    for i in np.nonzero(m_t)[0]:
        gap = t.states[tids[i + 1]].t - t.states[tids[i]].t
        assert dt_t[i] == pytest.approx(gap, abs=1e-9)
    session = t.states[tids[-1]].t - t.states[tids[0]].t
    assert float(dt_t[m_t].sum()) == pytest.approx(session, abs=1e-9)


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_convert_edges_restores_observations(pkg):
    if pkg == "jax":
        cams, exts = jsyn.stereo_rig()
        est = jest.Estimator(cams, exts, jpre.ImuParameters.create(), jest.EstimatorConfig())
        Edge, convert = jest.PoseGraphEdge, jfba.convert_edges_to_observations
    else:
        cams, exts = tsyn.stereo_rig(device="cpu")
        est = test_.Estimator(cams, exts, tpre.ImuParameters.create(device="cpu"),
                              test_.EstimatorConfig(), device="cpu")
        Edge, convert = test_.PoseGraphEdge, tfba.convert_edges_to_observations
    s0 = est.add_state(0.0, np.zeros((5, 3)), np.tile([0, 0, 9.81], (5, 1)), np.full(5, 0.01))
    lid = est.add_landmark([1, 2, 5, 1.0], initialised=True)
    ident = np.array([0, 0, 0, 0, 0, 0, 1.0])
    est.pose_graph_edges.append(Edge(s0, s0, ident, np.eye(6),
                                     [(lid, s0, 0, 7, 100.0, 110.0, 9.0)], "marg"))
    est.pose_graph_edges.append(Edge(s0, s0, ident, np.eye(6), [], "loop"))
    assert convert(est) == 1
    assert est.landmarks[lid].obs[(s0, 0, 7)] == (100.0, 110.0, 9.0)
    assert (lid, 0, 7) in est.obs_of_state(s0)
    assert [e.kind for e in est.pose_graph_edges] == ["loop"]
