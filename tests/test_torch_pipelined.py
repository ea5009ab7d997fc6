"""The port's pipelined SLAM loop against the JAX package's on the CPU.

(a) ``_append_matches_all`` on seeded inputs (K = 3 sets, 2 cameras, one
    set disabled by an all -1 slot map, rows that overflow the capacity):
    integer fields, the mask and the returned row count equal; uv and
    weights within 1e-12 (float64).
(b) ``Estimator.prepare_fused_solve``'s slot maps, window slots, packed
    row count and weight scales equal to the JAX package's on the same
    records (a scripted estimator drive fed to both packages; the landmark
    table carried across with ``interop``), with the iteration budget.
(c) The fused append + solve against ``solve_packed_fused_carrier`` on one
    packed window with three in-flight frames' matches: equal LM
    iterations, the flat output within 1e-8 relative to each section's
    largest value (float64), the frame diagnostics appended unchanged.
(d) The three cases of ``tests/test_correction_epochs.py`` through both
    packages: the net correction (1e-12) and the skip sentinel, the rigid
    correction composed onto a solve (1e-12), the append-overflow warning.
(e) The whole drive: both packages' ``run_synthetic_vio(pipelined=True,
    force_min_pending=2)`` on ``tests/test_torch_slam.py``'s drive (192x128,
    6 frames at 4 Hz), float64, the JAX RANSAC draws injected. As there,
    the JAX frontend runs with float64 standing for float32; its pipelined
    program reads its inputs from a uint8 carrier whose float section is
    bitcast from 4-byte words, so here it is read as 8-byte float64 words
    (``_carrier_program_f64``; the program itself is the package's
    ``_frame_associate_body``). Held: equal keyframe flags, poses per frame
    within 1e-3 m, landmark counts within 3, ATE within 1e-3 m of the JAX
    run's and below 0.10 m.
(f) The port against itself: two deep-lag runs equal within 1e-12 (a race
    between the solve worker and the host would show here); deep lag
    against the port's synchronous loop within 0.03 m of ATE
    (``tests/test_e2e_vio.py:64``); and ``n_obs_inserted`` of the deep-lag
    run at least 0.9x that of the port's pipelined run at its own lag, the
    comparison of ``tests/test_e2e_vio.py:139``. Against the synchronous
    loop the port's ratio is 0.84 on this 6-frame drive (450 / 534, the
    test prints it; the JAX package's deep-lag run inserts 452): the
    frames in flight see a map that lags their dispatch; so the 0.9 bar is
    held against the pipelined loop, as the JAX package's test holds it.
    Also here: the solve worker's error reaches the caller (alone and from
    the loop), and a stress test of the forward-mode AD lock.

Measured on this drive (port vs JAX, deep lag; ``-s`` prints it): poses
within 7e-12 m on every frame, landmark counts within 1 (a descriptor bit
that ties to rounding, as in test_torch_slam), ATE 0.0269837 m in both.
"""

import dataclasses
import functools
import logging
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from okvis2_torch import interop
from okvis2_torch.graph import estimator as test_
from okvis2_torch.imu.preintegration import ImuParameters as TImu
from okvis2_torch.pipeline import slam as tslam
from okvis2_torch.pipeline import synthetic_run as tsr
from okvis2_torch.solver import packed_solve as tps
from okvis2_torch.solver.window_problem import WindowProblem as TWP
from okvis2_torch.utils import synthetic as tsyn
from okvis2_tpu.core import se3_np
from okvis2_tpu.graph import estimator as jest
from okvis2_tpu.imu.preintegration import ImuParameters as JImu
from okvis2_tpu.pipeline import frontend_pipeline as jfp
from okvis2_tpu.pipeline import slam as jslam
from okvis2_tpu.pipeline import synthetic_run as jsr
from okvis2_tpu.solver import packed_solve as jps
from okvis2_tpu.solver.window_problem import WindowProblem as JWP
from okvis2_tpu.utils import synthetic as jsyn
from test_torch_estimator import _scene
from test_torch_slam import DRIVE, EST, _jax_indices

POSE_TOL, LM_TOL, ATE_TOL = 1e-3, 3, 1e-3


# ---------------------------------------------------------------------------
# (a) the device-side append
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(3))
def test_append_matches_all(seed):
    rng = np.random.default_rng(seed)
    S, L, O, NC, N, cap, K, n_base = 4, 16, 48, 2, 12, 16, 3, 20
    jp = JWP.empty(S, L, O, NC, 4, num_rel=2, dtype=jnp.float64)
    base = {
        "obs_state": np.r_[rng.integers(0, S, n_base), np.zeros(O - n_base)].astype(np.int32),
        "obs_cam": np.r_[rng.integers(0, NC, n_base), np.zeros(O - n_base)].astype(np.int32),
        "obs_lm": np.r_[rng.integers(0, L, n_base), np.zeros(O - n_base)].astype(np.int32),
        "obs_uv": rng.uniform(0, 200, (O, 2)),
        "obs_sqrt_info": rng.uniform(0.5, 2, O),
        "obs_mask": np.arange(O) < n_base,
    }
    jp = dataclasses.replace(jp, **{k: jnp.asarray(v) for k, v in base.items()})
    fields = interop.problem_to_numpy(interop.problem_from_numpy(
        {f: (jax.tree_util.tree_map(np.asarray, dataclasses.asdict(jp.imu_pre))
             if f == "imu_pre" else np.asarray(getattr(jp, f))) for f in TWP._FIELDS},
        device="cpu"))
    tp = interop.problem_from_numpy(fields, device="cpu")
    sets = [(rng.integers(0, N, (NC, cap)).astype(np.int32), rng.random((NC, cap)) < 0.8,
             rng.uniform(0, 200, (NC, N, 2)), rng.uniform(5, 15, (NC, N))) for _ in range(K)]
    maps = rng.integers(-1, L, (K, cap)).astype(np.int32)
    maps[1] = -1  # a disabled set
    w_scale = rng.uniform(0.5, 1.5, cap)
    cur = rng.integers(0, S, K).astype(np.int32)
    jout, jn = jps._append_matches_all(
        jp, [tuple(jnp.asarray(x) for x in s) for s in sets], jnp.asarray(maps),
        jnp.asarray(w_scale), jnp.asarray(cur), jnp.asarray(n_base, jnp.int32))
    tout, tn = tps._append_matches_all(
        tp, [tuple(torch.as_tensor(x) for x in s) for s in sets], torch.as_tensor(maps).long(),
        torch.as_tensor(w_scale), torch.as_tensor(cur).long(), torch.tensor(n_base))
    assert int(tn) == int(jn) > O  # rows past the capacity are counted, not kept
    for f in ("obs_state", "obs_cam", "obs_lm", "obs_mask"):
        np.testing.assert_array_equal(getattr(tout, f).numpy(), np.asarray(getattr(jout, f)), f)
    assert getattr(tout, "obs_mask").all()
    for f in ("obs_uv", "obs_sqrt_info"):
        np.testing.assert_allclose(getattr(tout, f).numpy(), np.asarray(getattr(jout, f)),
                                   rtol=0, atol=1e-12, err_msg=f)


# ---------------------------------------------------------------------------
# (b), (c): the fused solve's host half and the fused solve
# ---------------------------------------------------------------------------

CFG2 = dict(window_slots=8, landmark_slots=48, obs_slots=768, imu_seg_capacity=64, rel_slots=4)
N_SCENE, IN_FLIGHT, TABLE_CAP = 10, 3, 64


@pytest.fixture(scope="module")
def fused():
    """Both estimators fed the same scripted drive (tests/test_torch_
    estimator.py's scene, 10 states, keyframes on even states, two
    landmarks suppressed); the last three states' observations are held
    back as the in-flight frames' match sets. A landmark table with slot
    churn, carried to the port with ``interop``; three slot snapshots."""
    jcams, jexts = jsyn.stereo_rig()
    tcams, texts = tsyn.stereo_rig(device="cpu")
    jcfg = jest.EstimatorConfig(**CFG2)
    j = jest.Estimator(jcams, list(jexts), JImu.create(g=9.81), jcfg)
    t = test_.Estimator(tcams, list(texts), TImu.create(g=9.81, device="cpu"),
                        interop.estimator_config_from_numpy(dataclasses.asdict(jcfg)),
                        device="cpu")
    steps, wall, v0, lm_noise = _scene()
    lid_of, held = {}, {}
    for k, (time_k, imu_k, obs) in enumerate(steps[:N_SCENE]):
        w, a, dt = imu_k if imu_k is not None else (np.zeros((0, 3)), np.full((1, 3), [0, 0, 9.81]),
                                                     np.zeros(0))
        sid = j.add_state(time_k, w, a, dt)
        assert t.add_state(time_k, w, a, dt) == sid
        if k == 0:
            for e in (j, t):
                e.states[sid].speed_bias[:3] = v0
        if k >= N_SCENE - IN_FLIGHT:
            held[sid] = [o for o in obs if o[0] in lid_of]
            continue
        for (li, ci, u, v, size) in obs:
            if li not in lid_of:
                hp = np.concatenate([wall[li, :3] + lm_noise[li], [1.0]])
                lid_of[li] = j.add_landmark(hp, initialised=li % 3 != 0)
                assert t.add_landmark(hp, initialised=li % 3 != 0) == lid_of[li]
            for e in (j, t):
                e.add_observation(lid_of[li], sid, ci, li, (u, v), size)
        for e in (j, t):
            e.set_keyframe(sid, k % 2 == 0)
    for lid in sorted(lid_of.values())[::9][:2]:
        for e in (j, t):
            e.set_info_scale(lid, 0.25)
    rj, rt = interop.estimator_records_to_numpy(j), interop.estimator_records_to_numpy(t)
    assert rt["window"] == rj["window"] and rt["landmarks"].keys() == rj["landmarks"].keys()

    rng = np.random.default_rng(5)
    jtab = jfp.DeviceLandmarkTable(TABLE_CAP, 3)
    lids = sorted(lid_of.values())
    snaps = []
    for churn in range(3):
        for lid in rng.permutation(lids):
            jtab.alloc(int(lid))
        for lid in rng.choice(lids, size=6, replace=False):
            jtab.release(int(lid))
        snaps.append(jtab.slot_lid.copy())
    for lid in lids:  # the current table holds every landmark
        jtab.alloc(int(lid))
    ttab = interop.landmark_table_from_numpy(interop.landmark_table_to_numpy(jtab), device="cpu")
    assert ttab.slot_of == jtab.slot_of
    return {"j": j, "t": t, "jtab": jtab, "ttab": ttab, "snaps": snaps, "held": held,
            "lid_of": lid_of}


def _jax_aux(j, cap):
    """The side inputs the JAX package wrote into its carrier's aux regions."""
    layout = j._packed_layout
    buf_f, buf_i, _ = j._packed_bufs
    K, oi = jps.MAX_APPEND_SETS, layout.aux_i_off
    return {"maps": np.round(buf_i[oi:oi + K * cap]).astype(np.int64).reshape(K, cap),
            "cur_slots": np.round(buf_i[oi + K * cap:oi + K * cap + K]).astype(np.int64),
            "n_obs_base": int(round(buf_i[oi + K * cap + K])),
            "w_scale": np.array(buf_f[layout.aux_f_off:layout.aux_f_off + cap])}


def test_prepare_fused_solve_matches(fused):
    j, t, snaps = fused["j"], fused["t"], fused["snaps"]
    sids = t.window
    # a state left the pack (the window holds 10 states, the pack its last 8),
    # a state in it, and the newest
    cases = [
        [{"sid": sids[0], "slot_lid": snaps[0]}, {"sid": sids[5], "slot_lid": snaps[1]},
         {"sid": sids[-1], "slot_lid": snaps[2]}],
        [{"sid": sids[-1], "slot_lid": snaps[2]}],
    ]
    for budget in (False, True):
        for e in (j, t):
            e.cfg = dataclasses.replace(e.cfg, enforce_realtime=budget)
            e._last_solve_wall = 1.0  # over the limit: the min-iteration budget
        for sets in cases:
            _, jcfg, _ = j.prepare_fused_solve(sids[-1], fused["jtab"], sets)
            prob, tcfg, aux = t.prepare_fused_solve(sids[-1], fused["ttab"], sets)
            assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
            assert tcfg.max_iterations == (j.cfg.realtime_min_iterations if budget
                                           else j.cfg.realtime_iterations)
            ja = _jax_aux(j, TABLE_CAP)
            for k in ("maps", "cur_slots"):
                np.testing.assert_array_equal(aux[k], ja[k], k)
            assert aux["n_obs_base"] == ja["n_obs_base"] == int(prob.obs_mask.sum()) > 100
            np.testing.assert_allclose(aux["w_scale"], ja["w_scale"], rtol=0, atol=1e-12)
            assert (aux["w_scale"] == 0.5).sum() == 2
            assert aux["n_sets"] == sum(s["sid"] in t._slot_of for s in sets)
        assert (aux["maps"][0] >= 0).any() and (ja["maps"][1:] == -1).all()
    for e in (j, t):
        e.cfg = dataclasses.replace(e.cfg, enforce_realtime=False)
    # the first case: the packed-out state's set is disabled
    _, _, aux = t.prepare_fused_solve(sids[-1], fused["ttab"], cases[0])
    assert (aux["maps"][0] == -1).all() and (aux["maps"][1:] >= 0).any()


def _match_sets(fused):
    """The held-back observations of the in-flight states as match tensors
    against the current table: keypoint li hosts wall landmark li."""
    tab, lid_of = fused["jtab"], fused["lid_of"]
    N, sets = max(lid_of) + 1, []
    for sid, obs in fused["held"].items():
        idx, keep = np.zeros((2, TABLE_CAP), np.int32), np.zeros((2, TABLE_CAP), bool)
        xy, size = np.zeros((2, N, 2)), np.full((2, N), 9.0)
        for (li, ci, u, v, sz) in obs:
            s = tab.slot_of[lid_of[li]]
            idx[ci, s], keep[ci, s] = li, True
            xy[ci, li], size[ci, li] = (u, v), sz
        sets.append((sid, {"idx": idx, "keep": keep, "xy": xy, "size": size}))
    return sets


def test_fused_solve_matches(fused):
    j, t = fused["j"], fused["t"]
    msets = _match_sets(fused)
    sets = [{"sid": sid, "slot_lid": fused["jtab"].slot_lid.copy()} for sid, _ in msets]
    diag = np.random.default_rng(2).normal(size=37)
    layout, jcfg, buf_all = j.prepare_fused_solve(sets[-1]["sid"], fused["jtab"], sets)
    jout = np.asarray(j.dispatch_fused_solve_carrier(
        [{k: jnp.asarray(v) for k, v in m.items()} for _, m in msets], jnp.asarray(diag),
        jnp.asarray(buf_all.view(np.uint8)), 0, layout, jcfg))
    prob, tcfg, aux = t.prepare_fused_solve(sets[-1]["sid"], fused["ttab"], sets)
    problem, aux_dev = t.upload_fused_solve(prob, aux)
    job = t.dispatch_fused_solve(problem, aux_dev,
                                 [{k: torch.as_tensor(v) for k, v in m.items()} for _, m in msets],
                                 torch.as_tensor(diag), tcfg)
    tout = job["future"].result(timeout=300)
    n = t.solve_out_size()
    assert tout.shape == jout.shape == (n + len(diag),)
    np.testing.assert_array_equal(tout[n:], diag)
    c = t.cfg
    dj = tps.decode_solved(jout[:n], c.window_slots, c.landmark_slots, 2)
    dt = tps.decode_solved(tout[:n], c.window_slots, c.landmark_slots, 2)
    assert dt[4]["iterations"] == dj[4]["iterations"] >= 2
    # every held-back observation of a packed landmark appended, three sets
    n_held = sum(t._lid_to_slot[fused["lid_of"][o[0]]] >= 0
                 for obs in fused["held"].values() for o in obs)
    assert dt[4]["n_obs"] == dj[4]["n_obs"] == aux["n_obs_base"] + n_held > aux["n_obs_base"] + 90
    assert dt[4]["final_cost"] < 0.1 * dt[4]["initial_cost"]  # to the 0.3 px noise floor
    for a, b in zip(dt[:4], dj[:4]):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-8 * np.abs(b).max())
    for k in ("initial_cost", "final_cost", "lambda"):
        np.testing.assert_allclose(dt[4][k], dj[4][k], rtol=1e-8)


def test_solve_worker_raises_the_solve_error():
    """A failing job raises at the result, in the caller's thread, and the
    worker keeps running the jobs after it."""
    worker = tps.SolveWorker("cpu")
    try:
        def fail():
            raise ValueError("bad solve")

        with pytest.raises(ValueError, match="bad solve"):
            worker.submit(fail).result(timeout=60)
        assert (worker.submit(lambda: torch.arange(3.0)).result(timeout=60) == [0, 1, 2]).all()
    finally:
        worker.close()


def test_pipelined_loop_raises_the_solve_error(monkeypatch):
    """A fused solve that fails in the worker raises in the loop's thread
    when its frame is finished; nothing runs the solve another way."""
    calls = []

    def fail_second(*a):
        calls.append(1)
        if len(calls) == 2:
            raise RuntimeError("fused solve failed")
        return tps.solve_packed_fused(*a)

    monkeypatch.setattr(test_, "solve_packed_fused", fail_second)
    with pytest.raises(RuntimeError, match="fused solve failed"):
        tsr.run_synthetic_vio(duration=1.0, frame_rate=4.0, width=96, height=64,
                              max_keypoints=32, n_stars=300, dtype=torch.float64, device="cpu",
                              estimator_config=test_.EstimatorConfig(**EST), pipelined=True)
    assert len(calls) >= 2


def test_forward_ad_lock_under_threads():
    """torch.func's forward mode is not safe in two threads at once (its
    nesting count is a module global): every port function that runs it
    holds ``FORWARD_AD_LOCK``. The solve worker linearises window problems
    while this thread evaluates the synthetic trajectory's derivatives, with
    a short switch interval; every result equals the one-thread result."""
    import sys

    problem = tsyn.build_problem(num_states=3, n_landmarks_side=3, device="cpu")
    prob, cams, imu = problem[0], problem[1], problem[2]
    from okvis2_torch.solver.gauss_newton import _linearize
    from okvis2_torch.solver.window_problem import SolverConfig

    ref_lin = _linearize(prob, cams, imu, SolverConfig())[1]
    ts = torch.linspace(0.0, 2.0, 20, dtype=torch.float64)
    ref_traj = [tsyn.true_state(t, device="cpu")[1] for t in ts]
    worker = tps.SolveWorker("cpu")
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        jobs = [worker.submit(lambda: _linearize(prob, cams, imu, SolverConfig())[1])
                for _ in range(6)]
        for _ in range(5):
            for t, ref in zip(ts, ref_traj):
                assert torch.equal(tsyn.true_state(t, device="cpu")[1], ref)
        for job in jobs:
            assert np.array_equal(job.result(timeout=300), ref_lin.numpy())
    finally:
        sys.setswitchinterval(interval)
        worker.close()


# ---------------------------------------------------------------------------
# (d) correction epochs
# ---------------------------------------------------------------------------

def _rand_T7(rng):
    q = rng.standard_normal(4)
    return np.concatenate([rng.standard_normal(3), q / np.linalg.norm(q)])


def test_net_correction_since_matches():
    rng = np.random.default_rng(0)
    T1, T2 = _rand_T7(rng), _rand_T7(rng)
    for log, epoch in (([], 0), ([T1], 1), ([T1], 0), ([T1, T2], 0), ([T1, T2, _rand_T7(rng)], 1),
                       ([None], 0), ([T1, None, T2], 0), ([None, T2], 1)):
        outs = []
        for cls in (jslam.SlamSystem, tslam.SlamSystem):
            dummy = type("S", (), {"_corr_log": list(log)})()
            outs.append(cls._net_correction_since(dummy, epoch))
        jo, to = outs
        if jo is None or jo is jslam.SlamSystem._CORR_SKIP:
            assert (to is None) if jo is None else (to is tslam.SlamSystem._CORR_SKIP)
        else:
            np.testing.assert_allclose(to, jo, rtol=0, atol=1e-12)
    np.testing.assert_allclose(tslam.SlamSystem._net_correction_since(
        type("S", (), {"_corr_log": [T1, T2]})(), 0), se3_np.compose7(T2, T1), rtol=0, atol=1e-12)


def _small_estimators():
    jc, je = jsr.small_rig()
    tc, te = tsr.small_rig(dtype=torch.float64, device="cpu")
    cfg = dict(window_slots=4, landmark_slots=8, obs_slots=64, imu_seg_capacity=16)
    return (jest.Estimator(jc, je, JImu.create(g=9.81), jest.EstimatorConfig(**cfg)),
            test_.Estimator(tc, te, TImu.create(g=9.81, device="cpu"), test_.EstimatorConfig(**cfg),
                            device="cpu"))


def _flat_solve(est, pose_by_slot, sb_by_slot, lms, n_obs=3.0):
    """A solve's flat output at ``est``'s capacities (test_correction_epochs)."""
    c = est.cfg
    S, L, NC = c.window_slots, c.landmark_slots, len(est.cameras)
    pose = np.zeros((S, 7))
    pose[:, 6] = 1.0
    sb, lm = np.zeros((S, 9)), np.zeros((L, 4))
    for i, p in pose_by_slot.items():
        pose[i] = p
    for i, v in sb_by_slot.items():
        sb[i] = v
    for i, hp in enumerate(lms):
        lm[i] = hp
    ext = np.tile([0, 0, 0, 0, 0, 0, 1.0], (NC, 1))
    return np.concatenate([pose.ravel(), sb.ravel(), lm.ravel(), ext.ravel(),
                           [1.0, 0.5, 3.0, 1e-3, n_obs]])


def test_apply_solved_flat_composes_rigid_correction():
    rng = np.random.default_rng(1)
    recs = []
    pose_s, vel_s, hp_s = _rand_T7(rng), rng.standard_normal(9), np.array([0.5, -1.0, 4.0, 1.0])
    T_corr = _rand_T7(rng)
    for est in _small_estimators():
        sid = est.add_state(0.0, np.zeros((0, 3)), np.zeros((0, 3)), np.zeros(0))
        lid = est.add_landmark([1.0, 2.0, 5.0, 1.0], initialised=True)
        est._solve_t0 = time.perf_counter()
        est.apply_solved_flat(_flat_solve(est, {0: pose_s}, {0: vel_s}, [hp_s]), {sid: 0}, [lid],
                              T_corr7=T_corr)
        recs.append((est.states[sid].pose, est.states[sid].speed_bias, est.landmarks[lid].hp_W))
    for a, b in zip(*recs):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)
    pose, sb, hp = recs[1]
    R = se3_np.quat_to_mat(T_corr[3:7])
    np.testing.assert_allclose(pose, se3_np.compose7(T_corr, pose_s), rtol=0, atol=1e-12)
    np.testing.assert_allclose(sb[:3], R @ vel_s[:3], rtol=0, atol=1e-12)
    np.testing.assert_array_equal(sb[3:], vel_s[3:])  # body-frame biases stay
    np.testing.assert_allclose(hp, np.r_[R @ hp_s[:3] + T_corr[:3] * hp_s[3], hp_s[3]],
                               rtol=0, atol=1e-12)


def test_apply_solved_flat_warns_on_obs_append_overflow(caplog):
    _, est = _small_estimators()
    sid = est.add_state(0.0, np.zeros((0, 3)), np.zeros((0, 3)), np.zeros(0))
    test_._warn_counts.pop("obs_append", None)  # a fresh rate limiter
    with caplog.at_level(logging.WARNING, logger="okvis2_torch"):
        est.apply_solved_flat(_flat_solve(est, {}, {}, [], n_obs=est.cfg.obs_slots + 8.0),
                              {sid: 0}, [])
    assert any("overflowed obs capacity" in r.message for r in caplog.records), caplog.records
    caplog.clear()
    with caplog.at_level(logging.WARNING, logger="okvis2_torch"):
        est.apply_solved_flat(_flat_solve(est, {}, {}, [], n_obs=float(est.cfg.obs_slots)),
                              {sid: 0}, [])
    assert not caplog.records


# ---------------------------------------------------------------------------
# (e), (f): the whole pipelined drive
# ---------------------------------------------------------------------------

@functools.partial(
    jax.jit, donate_argnums=(2, 3),
    static_argnames=("det_cfg", "max_distance", "n_hyp", "min_inliers", "use_ransac",
                     "do_motion_stereo", "do_ff", "gravity_aligned", "img_shape", "n_aux"))
def _carrier_program_f64(cameras, carrier, tab_signs, tab_valid, prev_signs, kf_xy, kf_signs,
                         ff_xy, ff_signs, ff_mask, extra_flat, det_cfg, max_distance, n_hyp,
                         min_inliers, use_ransac, do_motion_stereo, do_ff, gravity_aligned,
                         img_shape=None, n_aux=0):
    """The JAX package's ``_frame_associate_from_carrier`` with the carrier's
    aux section read as float64 words: under the float64-for-float32 shim
    the host fills that section in float64."""
    NC, H, W = img_shape
    nimg = NC * H * W
    aux = jax.lax.bitcast_convert_type(carrier[nimg:nimg + 8 * n_aux].reshape(-1, 8), jnp.float64)
    return jfp._frame_associate_body(
        cameras, carrier[:nimg].reshape(NC, H, W), aux, tab_signs, tab_valid, prev_signs, kf_xy,
        kf_signs, ff_xy, ff_signs, ff_mask, extra_flat, det_cfg, max_distance, n_hyp,
        min_inliers, use_ransac, do_motion_stereo, do_ff, gravity_aligned)


def _recording(cls, rec):
    """``cls`` recording (sid, pose, keyframe flag, landmark count) at each
    frame's (lagged) callback."""

    class Recording(cls):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.set_optimised_graph_callback(lambda t, sid, pose, tr: rec.append(
                (sid, pose, tr.is_keyframe, len(self.estimator.landmarks))))

    return Recording


def _port_run(rec=None, **kw):
    with pytest.MonkeyPatch.context() as mp:
        if rec is not None:
            mp.setattr(tsr, "SlamSystem", _recording(tslam.SlamSystem, rec))
        return tsr.run_synthetic_vio(estimator_config=test_.EstimatorConfig(**EST),
                                     dtype=torch.float64, device="cpu",
                                     ransac_sampler=_jax_indices, **DRIVE, **kw)


@pytest.fixture(scope="module")
def deep_lag():
    """Both packages' deep-lag pipelined drives (two frames kept in flight)."""
    rj, rt = [], []
    shim = type("np64", (), {k: getattr(np, k) for k in dir(np) if not k.startswith("__")})
    shim.float32 = np.float64
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnp, "float32", jnp.float64)
        mp.setattr(jfp, "np", shim)
        mp.setattr(jfp, "_frame_associate_from_carrier", _carrier_program_f64)
        mp.setattr(jsr, "SlamSystem", _recording(jslam.SlamSystem, rj))
        jres = jsr.run_synthetic_vio(estimator_config=jest.EstimatorConfig(**EST),
                                     pipelined=True, force_min_pending=2, **DRIVE)
    tres = _port_run(rt, pipelined=True, force_min_pending=2)
    return {"jax": (jres, rj), "port": (tres, rt)}


def test_pipelined_drive_matches(deep_lag):
    jres, rj = deep_lag["jax"]
    tres, rt = deep_lag["port"]
    assert tres["frames"] == jres["frames"] == 6
    assert [r[0] for r in rt] == [r[0] for r in rj] == list(range(6))
    assert [r[2] for r in rt] == [r[2] for r in rj]
    d_pose = [float(np.abs(pt[:3] - pj[:3]).max()) for (_, pj, _, _), (_, pt, _, _) in zip(rj, rt)]
    nj, nt = jres["slam"].estimator.n_obs_inserted, tres["slam"].estimator.n_obs_inserted
    print(f"deep lag, port vs JAX: pose difference per frame {d_pose} m, landmarks "
          f"{[r[3] for r in rt]} vs {[r[3] for r in rj]}, ATE {tres['ate_rmse']:.9f} vs "
          f"{jres['ate_rmse']:.9f} m, observations inserted {nt} vs {nj}")
    for (sid, _, _, nj_s), (_, _, _, nt_s), d in zip(rj, rt, d_pose):
        assert d < POSE_TOL, sid
        assert abs(nt_s - nj_s) <= LM_TOL, (sid, nt_s, nj_s)
    assert abs(tres["ate_rmse"] - jres["ate_rmse"]) < ATE_TOL, (tres["ate_rmse"],
                                                              jres["ate_rmse"])
    assert tres["ate_rmse"] < 0.10
    assert abs(nt - nj) <= 0.02 * nj, (nt, nj)
    slam = tres["slam"]
    assert not slam._pending_frames and slam._pending_kf is None  # finish() drained


@pytest.fixture(scope="module")
def port_runs(deep_lag):
    """The port alone: a second deep-lag run, the loop's own lag, and the
    synchronous loop, on the same drive."""
    return {"deep": deep_lag["port"][0], "deep2": _port_run(pipelined=True, force_min_pending=2),
            "natural": _port_run(pipelined=True), "sync": _port_run()}


def test_deep_lag_runs_are_reproducible(port_runs):
    tr1, tr2 = port_runs["deep"]["est_traj"], port_runs["deep2"]["est_traj"]
    assert len(tr1) == len(tr2) == 6
    for (t1, p1), (t2, p2) in zip(tr1, tr2):
        assert t1 == t2
        np.testing.assert_allclose(p2, p1, rtol=0, atol=1e-12)


def test_deep_lag_against_the_synchronous_loop(port_runs):
    deep, sync, nat = port_runs["deep"], port_runs["sync"], port_runs["natural"]
    assert deep["frames"] == sync["frames"] == nat["frames"]
    assert deep["ate_rmse"] < 0.10 and nat["ate_rmse"] < 0.10
    assert abs(deep["ate_rmse"] - sync["ate_rmse"]) < 0.03, (sync["ate_rmse"], deep["ate_rmse"])
    n_s, n_d = (len(r["slam"].estimator.landmarks) for r in (sync, deep))
    assert n_d > 0.5 * n_s, (n_s, n_d)
    # every in-flight frame's appended rows land as host observations
    # after the drain: a lost set would cost a frame's insertions
    e_d, e_n = deep["slam"].estimator, nat["slam"].estimator
    e_s = sync["slam"].estimator
    print(f"port ATE: deep lag {deep['ate_rmse']:.6f}, own lag {nat['ate_rmse']:.6f}, "
          f"synchronous {sync['ate_rmse']:.6f} m; observations inserted: deep lag "
          f"{e_d.n_obs_inserted}, own lag {e_n.n_obs_inserted}, synchronous {e_s.n_obs_inserted}")
    assert e_d.n_obs_inserted >= 0.9 * e_n.n_obs_inserted, (e_n.n_obs_inserted,
                                                           e_d.n_obs_inserted)
