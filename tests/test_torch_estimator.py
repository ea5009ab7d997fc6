"""The port's estimator against the JAX package's on the CPU, in float64:
the covisibility MST (equal edge lists, ties included), the
gravity-aligned first pose (1e-12), the two-pose marginalisation factor
(T_ij 1e-12, sqrt_info^T sqrt_info 1e-9 relative; eigh may order and sign
eigenvectors differently, the solve sees only that product; float32
inputs give the float64 factor), the upload and the solve with its flat
output (round trips; solve output 1e-8), and a scripted estimator drive.

The drive feeds both estimators the same sequence: IMU-propagated states
along the synthetic trajectory, landmarks and observations projected from
the synthetic wall with 0.3 px noise (a third of the landmarks start
uninitialised), keyframes on every other state, then ``optimise``,
``apply_marginalisation_strategy`` and ``clean_unobserved_landmarks``
each step. Held at every step: ``pack_np``'s fields (ints and masks
exactly, floats 1e-12), the poses after ``optimise`` (1e-8), the window,
keyframe, frozen and pose-graph flags and landmark ids after
marginalisation, and the pose-graph edges (same ids and kind, T_ij and
information 1e-8). After each check the port's poses, speeds, landmarks
and pose-graph factors take the JAX values, so every step starts from
identical inputs (a solve's rounding-level difference would otherwise
reach the next pack, which is held at 1e-12; and eigh's sign choices make
the two sqrt_info differ where their products agree). The drive asserts that IMU-frame elimination,
keyframe-to-pose-graph conversion and ``expand_keyframe`` each ran.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from okvis2_torch import interop
from okvis2_torch.factors import two_pose as ttp
from okvis2_torch.graph import estimator as test_
from okvis2_torch.graph import mst as tmst
from okvis2_torch.imu import preintegration as tpre
from okvis2_torch.solver import packed_solve as tps
from okvis2_torch.utils import synthetic as tsyn
from okvis2_tpu.factors import two_pose as jtp
from okvis2_tpu.graph import estimator as jest
from okvis2_tpu.graph import mst as jmst
from okvis2_tpu.imu import preintegration as jpre
from okvis2_tpu.solver import packed_solve as jps
from okvis2_tpu.utils import synthetic as jsyn

# the drive's estimator: small capacities, the marginalisation cascade
# reached within 16 states
CFG = dict(window_slots=8, landmark_slots=64, obs_slots=1024, imu_seg_capacity=64,
           rel_slots=8, num_keyframes=3, num_imu_frames=2, num_pose_graph_frames=1)
N_STATES, FRAME_DT, N_SIDE, OBS_NOISE = 16, 0.15, 6, 0.3


# ---------------------------------------------------------------------------
# MST, gravity-aligned pose
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(4))
def test_max_spanning_tree_equal(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(3, 12))
    edges = [(int(u), int(v), int(rng.integers(0, 4)))  # few weights: many ties
             for u in range(n) for v in range(u + 1, n) if rng.random() < 0.6]
    t = tmst.max_spanning_tree(n, edges)
    assert t == jmst.max_spanning_tree(n, edges) and len(t) > 0


@pytest.mark.parametrize("accel", [[0.0, 0.0, 9.81], [0.3, -1.2, 9.7], [9.81, 0.0, 0.0],
                                   [0.0, 0.0, -9.81]])
def test_init_pose_from_accel(accel):
    j = jpre.init_pose_from_accel(jnp.asarray(accel, jnp.float64))
    t = tpre.init_pose_from_accel(torch.tensor(accel, dtype=torch.float64))
    np.testing.assert_allclose(t.q.numpy(), np.asarray(j.q), rtol=0, atol=1e-12)
    np.testing.assert_allclose(t.r.numpy(), np.asarray(j.r), rtol=0, atol=1e-12)


# ---------------------------------------------------------------------------
# two-pose factor
# ---------------------------------------------------------------------------

def _two_pose_inputs(problem, i, j, cams_only=(0, 1), n_lm=None, Oc=256, Lc=96):
    """The (i, j) sub-problem of a build_problem window: the first ``n_lm``
    landmarks both states observe (all by default), their observations as
    rows (frame 0/1, cam, lm idx, u, v, sqrt_info), padded to the factor's
    capacities."""
    st, cam, lm = (np.asarray(getattr(problem, f)) for f in ("obs_state", "obs_cam", "obs_lm"))
    uv, w = np.asarray(problem.obs_uv), np.asarray(problem.obs_sqrt_info)
    sel = np.isin(cam, cams_only)
    shared = sorted(set(lm[sel & (st == i)]) & set(lm[sel & (st == j)]))[:n_lm or Lc]
    idx = {l: k for k, l in enumerate(shared)}
    rows = [(0.0 if st[o] == i else 1.0, cam[o], idx[lm[o]], uv[o, 0], uv[o, 1], w[o])
            for o in range(len(st)) if sel[o] and st[o] in (i, j) and lm[o] in idx][:Oc]
    obs = np.zeros((Oc, 6))
    obs[:len(rows)] = rows
    obs_m = np.arange(Oc) < len(rows)
    hp = np.tile([0.0, 0, 0, 1], (Lc, 1))
    hp[:len(shared)] = np.asarray(problem.landmarks)[shared]
    lmm = np.arange(Lc) < len(shared)
    pose = np.asarray(problem.pose)
    return pose[i], pose[j], np.asarray(problem.extrinsics), hp, obs, obs_m, lmm


@pytest.fixture(scope="module")
def window():
    """The build_problem window (5 states, 8x8 wall), both packages."""
    jp, jcams, jimu, _ = jsyn.build_problem(num_states=5, n_landmarks_side=8, obs_noise=0.5)
    tp, tcams, timu, _ = tsyn.build_problem(num_states=5, n_landmarks_side=8, obs_noise=0.5,
                                            device="cpu")
    return jp, jcams, jimu, tp, tcams, timu


@pytest.mark.parametrize("case", ["stereo", "low_parallax_mono"])
def test_two_pose_factor(window, case):
    """Stereo: states 0 and 2 of the window, every landmark both see. Low
    parallax: states 0 and 1 (0.3 s apart, the wall ~6 m away) seen by
    camera 0 only, through the fewest landmarks the estimator builds a
    factor from (3): the scale direction has no information and its
    eigenvalue is clipped to 0."""
    jp, jcams, _, _, tcams, _ = window
    if case == "stereo":
        args = _two_pose_inputs(jp, 0, 2)
    else:
        args = _two_pose_inputs(jp, 0, 1, cams_only=(0,), n_lm=3)
    j = jtp.compute_two_pose_factor(*(jnp.asarray(a) for a in args), jcams)
    t = ttp.compute_two_pose_factor(*(torch.tensor(a) for a in args), tcams)
    np.testing.assert_allclose(t["T_ij"].numpy(), np.asarray(j["T_ij"]), rtol=0, atol=1e-12)
    assert int(t["num_obs"]) == int(j["num_obs"]) >= (100 if case == "stereo" else 6)
    Ij = np.asarray(j["sqrt_info"]).T @ np.asarray(j["sqrt_info"])
    It = t["sqrt_info"].numpy().T @ t["sqrt_info"].numpy()
    np.testing.assert_allclose(It, Ij, rtol=0, atol=1e-9 * np.abs(Ij).max())
    n_clipped = int((np.asarray(j["evals"]) == 0).sum())
    assert int((t["evals"].numpy() == 0).sum()) == n_clipped
    assert (n_clipped >= 1) == (case == "low_parallax_mono")


# ---------------------------------------------------------------------------
# upload and flat solve
# ---------------------------------------------------------------------------

def _np_problem(problem, cls):
    """A WindowProblem (either package's) with numpy leaves, as ``cls``."""
    kw = {}
    for f in test_.WindowProblem._FIELDS:
        v = getattr(problem, f)
        if f == "imu_pre":
            kw[f] = type(v)(*(np.asarray(getattr(v, g)) for g in test_._PRE_FIELDS))
        else:
            kw[f] = np.asarray(v)
    return cls(**kw)


def _pad(prob_np, template):
    """Copy a numpy problem into the leading rows of a larger template."""
    def fit(a, t):
        out = np.array(t)
        out[tuple(slice(0, n) for n in a.shape)] = a
        return out

    kw = {}
    for f in test_.WindowProblem._FIELDS:
        a, t = getattr(prob_np, f), getattr(template, f)
        kw[f] = (type(a)(*(fit(getattr(a, g.name), getattr(t, g.name))
                            for g in dataclasses.fields(a)))
                 if f == "imu_pre" else fit(a, t))
    return dataclasses.replace(template, **kw)


def test_two_pose_factor_float32_inputs(window):
    """Float32 inputs and cameras (as on the card) give the float64 factor:
    the stereo sub-problem with one landmark kept in a single observation,
    so its 3x3 block has rank 2. Computed in float32, the rounding of that
    landmark's Jacobians along its ray, amplified by the 1e9 of the
    regularised inverse, corrupted the information."""
    jp, _, _, _, tcams, _ = window
    pose_i, pose_j, ext, hp, obs, obs_m, lmm = _two_pose_inputs(jp, 0, 2)
    first = np.nonzero(obs_m & (obs[:, 2] == 0))[0]
    obs_m[first[1:]] = False  # landmark 0: one observation left
    args = (pose_i, pose_j, ext, hp, obs, obs_m, lmm)
    ref = ttp.compute_two_pose_factor(*(torch.tensor(a) for a in args), tcams)
    f32 = lambda a: torch.tensor(a, dtype=torch.float32) if a.dtype == np.float64 \
        else torch.tensor(a)  # noqa: E731
    cams32 = tuple(c.to(dtype=torch.float32) for c in tcams)
    got = ttp.compute_two_pose_factor(*(f32(a) for a in args), cams32)
    assert got["sqrt_info"].dtype == got["T_ij"].dtype == torch.float64
    info = lambda s: (s.T @ s).numpy()  # noqa: E731
    # the same float32-rounded inputs and cameras, given as float64
    ref64 = ttp.compute_two_pose_factor(
        *(f32(a).double() if a.dtype == np.float64 else torch.tensor(a) for a in args),
        tuple(c.to(dtype=torch.float64) for c in cams32))
    np.testing.assert_allclose(info(got["sqrt_info"]), info(ref64["sqrt_info"]), rtol=0,
                               atol=1e-9 * np.abs(info(ref64["sqrt_info"])).max())
    np.testing.assert_allclose(got["T_ij"].numpy(), ref64["T_ij"].numpy(), rtol=0, atol=1e-12)
    # the float32 inputs' rounding moves the factor itself only slightly
    np.testing.assert_allclose(info(got["sqrt_info"]), info(ref["sqrt_info"]), rtol=0,
                               atol=1e-3 * np.abs(info(ref["sqrt_info"])).max())


def test_decode_solved_round_trip():
    S, L, NC = 3, 5, 2
    rng = np.random.default_rng(0)
    parts = [rng.normal(size=(S, 7)), rng.normal(size=(S, 9)), rng.normal(size=(L, 4)),
             rng.normal(size=(NC, 7)), rng.normal(size=5)]
    flat = np.concatenate([p.ravel() for p in parts])
    for out in (flat, torch.tensor(flat)):
        pose, sb, lms, ext, stats = tps.decode_solved(out, S, L, NC)
        for a, b in zip((pose, sb, lms, ext), parts):
            np.testing.assert_array_equal(a, b)
        assert [stats[k] for k in ("initial_cost", "final_cost", "iterations", "lambda",
                                   "n_obs")] == list(parts[-1])
    jpose = jps.decode_solved(flat, S, L, NC)[0]
    np.testing.assert_array_equal(jpose, parts[0])


def test_problem_to_device_round_trip(drive):
    """problem_to_device gives the drive's last packed problem back
    (floats in the asked dtype, indices as int64, masks as bool)."""
    est = drive["estimators"][1]
    prob = est.pack_np()
    back = tps.problem_to_device(prob, "cpu", torch.float64)
    for f in test_.WindowProblem._FIELDS:
        a, b = getattr(back, f), getattr(prob, f)
        pairs = ([(getattr(a, g.name), getattr(b, g.name)) for g in dataclasses.fields(a)]
                 if f == "imu_pre" else [(a, b)])
        for x, y in pairs:
            assert x.dtype in (torch.float64, torch.int64, torch.bool)
            assert x.dtype == torch.bool or x.is_floating_point() == np.issubdtype(
                np.asarray(y).dtype, np.floating)
            np.testing.assert_array_equal(x.numpy(), np.asarray(y))


def test_solve_packed_matches(window, drive):
    """The disturbed build_problem window, padded into the drive's
    capacities (one compile of the JAX program serves both tests), solved
    by both flat programs with the estimator's solver settings."""
    jp, jcams, jimu, tp, tcams, timu = window
    jfroz = jnp.zeros(jp.S, bool).at[0].set(True)
    jd = jsyn.disturb_problem(dataclasses.replace(jp, pose_frozen=jfroz))
    frozen = torch.zeros(tp.S, dtype=torch.bool)
    frozen[0] = True
    td = tsyn.disturb_problem(tp.replace(pose_frozen=frozen))
    j_est, t_est = drive["estimators"]
    tmpl = t_est._np_template()
    t_np = _pad(_np_problem(td, test_.WindowProblem), tmpl)
    j_np = _pad(_np_problem(jd, type(j_est._np_template())), j_est._np_template())
    # the same inputs, field by field
    for f in test_.WindowProblem._FIELDS[:4]:
        np.testing.assert_allclose(getattr(t_np, f), getattr(j_np, f), rtol=0, atol=1e-12)

    jl = j_est._get_packed_layout()
    jf, ji, jbuf = jl.make_buffers()
    jl.fill(jf, ji, j_np)
    jout = np.asarray(jps.solve_packed(jnp.asarray(jbuf), j_est.cameras, j_est.imu_params, jl,
                                       j_est._solver_cfg))
    tout = tps.solve_packed(tps.problem_to_device(t_np, "cpu", torch.float64), t_est.cameras,
                            t_est.imu_params, t_est._solver_cfg).numpy()
    S, L, NC = CFG["window_slots"], CFG["landmark_slots"], 2
    jdec, tdec = jps.decode_solved(jout, S, L, NC), tps.decode_solved(tout, S, L, NC)
    assert tdec[4]["iterations"] == jdec[4]["iterations"] >= 3
    assert tdec[4]["n_obs"] == jdec[4]["n_obs"] > 300
    assert tdec[4]["final_cost"] < 1e-2 * tdec[4]["initial_cost"]
    for a, b in zip(tdec[:4], jdec[:4]):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-8)


# ---------------------------------------------------------------------------
# the scripted estimator drive
# ---------------------------------------------------------------------------

def _drive_estimators():
    """Both estimators at the drive's config, on the synthetic stereo rig."""
    jcams, jexts = jsyn.stereo_rig()
    tcams, texts = tsyn.stereo_rig(device="cpu")
    jcfg = jest.EstimatorConfig(**CFG)
    tcfg = interop.estimator_config_from_numpy(dataclasses.asdict(jcfg))
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    j = jest.Estimator(jcams, list(jexts), jpre.ImuParameters.create(g=9.81), jcfg)
    t = test_.Estimator(tcams, list(texts), tpre.ImuParameters.create(g=9.81, device="cpu"),
                        tcfg, device="cpu")
    return j, t


def _scene():
    """Per state: time, IMU segment since the previous state, and the
    noisy observations (lm, cam, u, v, size) of the wall; the trajectory is
    shifted so its start is the estimator's gravity-aligned origin."""
    imu = jpre.ImuParameters.create(g=9.81)
    cams, exts = jsyn.stereo_rig()
    wall = np.asarray(jsyn.landmark_wall(N_SIDE))
    r0 = np.asarray(jsyn.true_state(0.0)[0].r)
    wall_s = wall - np.concatenate([r0, [0.0]])
    rng = np.random.default_rng(7)
    steps = []
    for k in range(N_STATES):
        t = k * FRAME_DT
        T, _ = jsyn.true_state(t)
        T = type(T)(r=T.r - r0, q=T.q)
        obs = []
        for ci, (cam, T_SC) in enumerate(zip(cams, exts)):
            hp_C = jax.vmap((T @ T_SC).inverse().apply_homogeneous)(jnp.asarray(wall_s))
            uv, ok = (np.asarray(x) for x in cam.project_homogeneous(hp_C))
            for li in np.nonzero(ok)[0]:
                u, v = uv[li] + rng.normal(0, OBS_NOISE, 2)
                obs.append((int(li), ci, float(u), float(v), float(rng.choice([7.0, 9.0, 12.0]))))
        imu_k = (None if k == 0 else tuple(
            np.asarray(x) for x in jsyn.imu_segment(t - FRAME_DT, t, 30, imu)))
        steps.append((t, imu_k, obs))
    v0 = np.asarray(jsyn.true_state(0.0)[1])
    return steps, wall_s, v0, np.random.default_rng(3).normal(0, 0.05, (len(wall), 3))


def _check_pack(jprob, tprob):
    for f in test_.WindowProblem._FIELDS:
        a, b = getattr(tprob, f), getattr(jprob, f)
        pairs = ([(getattr(a, g), getattr(b, g)) for g in test_._PRE_FIELDS]
                 if f == "imu_pre" else [(a, b)])
        for x, y in pairs:
            x, y = np.asarray(x), np.asarray(y)
            assert x.shape == y.shape, f
            if np.issubdtype(y.dtype, np.floating):
                np.testing.assert_allclose(x, y, rtol=0, atol=1e-12, err_msg=f)
            else:
                np.testing.assert_array_equal(x, y, err_msg=f)


def _flags(est):
    return ([(s, est.states[s].is_keyframe, est.states[s].frozen,
              est.states[s].is_pose_graph_frame) for s in est.window],
            sorted(est.landmarks),
            sorted(s for s, r in est.states.items() if r.anchor_id is not None))


def _sync(j, t):
    """The port's solved records and pose-graph factors take the JAX
    package's values (eigh's sign choices make sqrt_info itself differ)."""
    for sid, r in j.states.items():
        t.states[sid].pose = np.array(r.pose)
        t.states[sid].speed_bias = np.array(r.speed_bias)
    for lid, lm in j.landmarks.items():
        t.landmarks[lid].hp_W = np.array(lm.hp_W)
        t.landmarks[lid].initialised = lm.initialised
    for te, je in zip(t.pose_graph_edges, j.pose_graph_edges):
        te.T_ij, te.sqrt_info = np.array(je.T_ij), np.array(je.sqrt_info)


@pytest.fixture(scope="module")
def drive():
    j, t = _drive_estimators()
    steps, wall, v0, lm_noise = _scene()
    lid_of = {}
    events = {"eliminated": 0, "converted": 0, "expanded": 0, "max_pose_err": 0.0}
    eliminate = t._eliminate_imu_frames

    def counted_elimination():
        n = len(t.window)
        eliminate()
        events["eliminated"] += n - len(t.window)

    t._eliminate_imu_frames = counted_elimination
    for k, (time_k, imu_k, obs) in enumerate(steps):
        w, a, dt = imu_k if imu_k is not None else (np.zeros((0, 3)), np.full((1, 3), [0, 0, 9.81]),
                                                     np.zeros(0))
        sids = [e.add_state(time_k, w, a, dt) for e in (j, t)]
        assert sids[0] == sids[1]
        sid = sids[0]
        if k == 0:
            for e in (j, t):
                e.states[sid].speed_bias[:3] = v0
        for (li, ci, u, v, size) in obs:
            if li not in lid_of:
                hp = np.concatenate([wall[li, :3] + lm_noise[li], [1.0]])
                ids = [e.add_landmark(hp, initialised=li % 3 != 0) for e in (j, t)]
                assert ids[0] == ids[1]
                lid_of[li] = ids[0]
            for e in (j, t):
                e.add_observation(lid_of[li], sid, ci, li, (u, v), size)
        is_kf = k % 2 == 0
        for e in (j, t):
            e.set_keyframe(sid, is_kf)
        if is_kf:
            ex = [e.expand_keyframe(sid) for e in (j, t)]
            assert ex[0] == ex[1]
            events["expanded"] += ex[0]
        _check_pack(j.pack_np(), t.pack_np())
        js, ts = j.optimise(), t.optimise()
        assert int(ts["iterations"]) == int(js["iterations"])
        for s in j.window:
            err = np.abs(t.states[s].pose - j.states[s].pose).max()
            events["max_pose_err"] = max(events["max_pose_err"], float(err))
            assert err < 1e-8, (k, s, err)
        for lid, lm in j.landmarks.items():
            np.testing.assert_allclose(t.landmarks[lid].hp_W, lm.hp_W, rtol=0, atol=1e-8)
            assert t.landmarks[lid].initialised == lm.initialised
        _sync(j, t)
        n_edges = len(t.pose_graph_edges)
        for e in (j, t):
            e.apply_marginalisation_strategy()
            e.clean_unobserved_landmarks()
        assert _flags(t) == _flags(j)
        assert len(t.window) <= CFG["window_slots"]
        events["converted"] += max(len(t.pose_graph_edges) - n_edges, 0)
        assert len(t.pose_graph_edges) == len(j.pose_graph_edges)
        for te, je in zip(t.pose_graph_edges, j.pose_graph_edges):
            assert (te.id_i, te.id_j, te.kind) == (je.id_i, je.id_j, je.kind)
            assert te.stored_obs == je.stored_obs
            np.testing.assert_allclose(te.T_ij, je.T_ij, rtol=0, atol=1e-8)
            Ij, It = je.sqrt_info.T @ je.sqrt_info, te.sqrt_info.T @ te.sqrt_info
            np.testing.assert_allclose(It, Ij, rtol=0, atol=1e-8 * np.abs(Ij).max())
        _sync(j, t)
    return {"estimators": (j, t), "events": events}


def test_estimator_drive(drive):
    j, t = drive["estimators"]
    ev = drive["events"]
    assert ev["eliminated"] >= 1 and ev["converted"] >= 1 and ev["expanded"] >= 1, ev
    rj, rt = interop.estimator_records_to_numpy(j), interop.estimator_records_to_numpy(t)
    assert rt["window"] == rj["window"] and rt["state_order"] == rj["state_order"]
    assert rt["landmarks"].keys() == rj["landmarks"].keys()
    for lid, lm in rj["landmarks"].items():
        assert rt["landmarks"][lid]["obs"] == lm["obs"]
    traj_j, traj_t = j.trajectory(), t.trajectory()
    for (tj, pj), (tt, pt) in zip(traj_j, traj_t):
        assert tj == tt
        np.testing.assert_allclose(pt, pj, rtol=0, atol=1e-12)
