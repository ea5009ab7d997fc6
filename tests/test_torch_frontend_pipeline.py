"""The port's tracking program against the JAX package's on the CPU, in
float64: the min-over-3 gated match (exact), the descriptor-table update
and the landmark table's bookkeeping with LRU eviction (equal slots,
``last_seen``, evictions and tables), the synthetic renderer (>= 99.9 % of
pixels equal: a star's rounding can flip at .5), static stereo, and the
whole slice: ``frame_associate`` against ``_frame_associate_body`` on two
rendered 2x128x192 frames with 128 keypoints, capacity 64 and 16
hypotheses.

The JAX program takes its per-frame state as one flat carrier (``aux``);
``_pack_aux`` below builds it from the layout at frontend_pipeline.py:
216-245. Its readback is float32 by design; the whole-slice reference is
traced with ``jnp.float32`` standing for float64, so the readback keeps
float64 and the keypoints and triangulated points can be held to 1e-9.
RANSAC draws the JAX package's own indices (the port's ``sampler``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from okvis2_torch import interop
from okvis2_torch.cameras.pinhole import PinholeCamera as TCam
from okvis2_torch.core.se3 import Transformation as TT
from okvis2_torch.frontend.detection import DetectionConfig as TDet
from okvis2_torch.imu.preintegration import ImuParameters as TImu
from okvis2_torch.pipeline import dataset as tds
from okvis2_torch.pipeline import frontend_pipeline as tfp
from okvis2_tpu.cameras.pinhole import PinholeCamera as JCam
from okvis2_tpu.core import se3_np as jse3
from okvis2_tpu.core.se3 import Transformation as JT
from okvis2_tpu.frontend.detection import DetectionConfig as JDet
from okvis2_tpu.imu.preintegration import ImuParameters as JImu
from okvis2_tpu.pipeline import dataset as jds
from okvis2_tpu.pipeline import frontend_pipeline as jfp

W, H, F, BASE = 192, 128, 120.0, 0.11
N_KP, CAP, N_HYP, KF = 128, 64, 16, 3


# ---------------------------------------------------------------------------
# min-over-3 gated match, table update, landmark table
# ---------------------------------------------------------------------------

def _signs(rng, shape):
    return np.where(rng.random(shape) < 0.5, 1.0, -1.0)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_min3_gated_match_exact(seed):
    rng = np.random.default_rng(seed)
    Lc, K, B, N = 40, 3, 512, 50
    kp = _signs(rng, (N, B))
    tab = _signs(rng, (Lc, K, B))
    # a third of the stored descriptors are near copies of keypoints
    for l in range(0, Lc, 3):
        tab[l, rng.integers(K)] = kp[rng.integers(N)] * np.where(rng.random(B) < 0.05, -1, 1)
    tab_valid = rng.random((Lc, K)) < 0.6
    tab_valid[5] = False  # a landmark without descriptors
    tab = tab * tab_valid[..., None]
    kp_mask = rng.random(N) < 0.9
    gate = rng.random((Lc, N)) < 0.7
    ji, jv = jfp._min3_gated_match(*(jnp.asarray(x) for x in (tab, tab_valid, kp, kp_mask, gate)),
                                   60)
    ti, tv = tfp._min3_gated_match(*(torch.tensor(x) for x in (tab, tab_valid, kp, kp_mask, gate)),
                                   60)
    assert int(tv.sum()) >= 3
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


def test_table_update_body_exact():
    """Clears apply before writes; out-of-range targets and clears drop."""
    rng = np.random.default_rng(4)
    Lc, K, B, NC, N, U = 16, 3, 512, 2, 20, 12
    tab = _signs(rng, (Lc, K, B))
    valid = rng.random((Lc, K)) < 0.5
    kp = _signs(rng, (NC, N, B))
    tgt = rng.integers(0, Lc * K, U)
    tgt[-3:] = Lc * K  # dropped
    tgt[0] = 4 * K + 1  # slot 4 is cleared and written in one batch
    clear = np.full(U, Lc)
    clear[:3] = [4, 7, 9]
    upd = np.concatenate([tgt, rng.integers(0, NC, U), rng.integers(0, N, U), clear])
    js, jv = jfp._table_update_body(jnp.asarray(tab), jnp.asarray(valid), jnp.asarray(kp),
                                    jnp.asarray(upd, jnp.int32))
    ts, tv = tfp._table_update_body(torch.tensor(tab), torch.tensor(valid), torch.tensor(kp),
                                    torch.tensor(upd, dtype=torch.int32))
    assert bool(tv[4, 1]) and not bool(tv[7].any())
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def _table_state(t):
    """A landmark table's bookkeeping, either package's (same attributes)."""
    return (dict(t.slot_of), list(t.free), t.last_seen.tolist(), t.ring_next.tolist(),
            t.tick, t.num_evictions, list(t._upd), list(t._clear))


def _jax_table_numpy(t):
    """The JAX package's table as interop's numpy dict."""
    return {"capacity": t.capacity, "n_desc": t.n_desc, "signs": np.asarray(t.signs),
            "valid": np.asarray(t.valid), "slot_lid": t.slot_lid, "ring_next": t.ring_next,
            "last_seen": t.last_seen, "free": t.free, "tick": t.tick,
            "num_evictions": t.num_evictions, "upd": t._upd, "clear": t._clear}


def test_landmark_table_sequence_with_eviction():
    rng = np.random.default_rng(6)
    cap, K, B, NC, N = 8, 3, 512, 2, 16
    jt, tt = jfp.DeviceLandmarkTable(cap, K), tfp.DeviceLandmarkTable(cap, K, device="cpu")
    jt.ensure(B, jnp.float64)
    tt.ensure(B, torch.float64)
    lid = 0
    for frame in range(6):
        kp = _signs(rng, (NC, N, B))
        for _ in range(5):  # new landmarks: the table fills, then evicts
            for t in (jt, tt):
                t.stage_descriptor(lid, int(lid % NC), int(lid % N))
            lid += 1
        for old in rng.integers(0, lid, 3):  # re-observed landmarks
            if int(old) in tt.slot_of:
                for t in (jt, tt):
                    t.stage_descriptor(int(old), 1, int(old) % N)
        if frame == 2:
            for t in (jt, tt):
                t.release(next(iter(tt.slot_of)))
        assert _table_state(tt) == _table_state(jt)
        if frame % 2:
            np.testing.assert_array_equal(tt.drain(4), jt.drain(4))
        jt.flush(jnp.asarray(kp), upd_capacity=4)
        tt.flush(torch.tensor(kp), upd_capacity=4)
        assert _table_state(tt) == _table_state(jt)
        np.testing.assert_array_equal(tt.valid.numpy(), np.asarray(jt.valid))
        np.testing.assert_array_equal(tt.signs.numpy(), np.asarray(jt.signs))
    assert tt.num_evictions > 5
    # the JAX table carried across continues identically
    tc = interop.landmark_table_from_numpy(_jax_table_numpy(jt), device="cpu")
    assert _table_state(tc) == _table_state(jt)
    for t in (jt, tc):
        t.stage_descriptor(10_000, 0, 3)
    assert _table_state(tc) == _table_state(jt)
    back = interop.landmark_table_to_numpy(tc)
    np.testing.assert_array_equal(back["signs"], np.asarray(jt.signs))
    assert back["free"] == jt.free and back["upd"] == jt._upd


def test_frontend_config_from_numpy():
    j = jfp.FrontendConfig(detection=JDet(max_keypoints=N_KP), map_match_capacity=CAP,
                           ransac_hypotheses=N_HYP)
    t = interop.frontend_config_from_numpy(dataclasses.asdict(j))
    assert t == tfp.FrontendConfig(detection=TDet(max_keypoints=N_KP), map_match_capacity=CAP,
                                   ransac_hypotheses=N_HYP)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)


# ---------------------------------------------------------------------------
# the rig, the renderer and the whole slice
# ---------------------------------------------------------------------------

def _rigs():
    # no distortion: tracing the JAX package's unrolled undistort at its 24
    # call sites would double this file's time (distortion has its own
    # parity tests in test_torch_cameras)
    jcam = JCam.create(W, H, F, F, W / 2, H / 2)
    tcam = TCam.create(W, H, F, F, W / 2, H / 2, device="cpu")
    T_SC = np.array([[0, 0, 0, 0, 0, 0, 1.0], [BASE, 0, 0, 0, 0, 0, 1.0]])
    jext = [JT(r=jnp.asarray(T[:3]), q=jnp.asarray(T[3:])) for T in T_SC]
    text = [TT(r=torch.tensor(T[:3]), q=torch.tensor(T[3:])) for T in T_SC]
    return (jcam, jcam), jext, (tcam, tcam), text, T_SC


def _jax_indices(counter):
    """A sampler returning the JAX program's RANSAC draws for frame
    ``counter`` (frontend_pipeline.py:241, p3p.py:255-263)."""
    key = jax.random.fold_in(jax.random.PRNGKey(42), counter)

    def sampler(mask, cam_idx, n_hyp, NC):
        keys = jax.random.split(key, n_hyp)
        m, ci = jnp.asarray(mask.numpy()), jnp.asarray(cam_idx.numpy(), jnp.int32)

        def one(k, cam):
            w = (m & (ci == cam)).astype(jnp.float64)
            return jax.lax.top_k(jax.random.gumbel(k, m.shape) + jnp.log(w + 1e-30), 3)[1]

        idx = jax.vmap(one)(keys, jnp.arange(n_hyp, dtype=jnp.int32) % NC)
        return torch.tensor(np.asarray(idx), dtype=torch.long)

    return sampler


def _pack_aux(cfg, NC, T_WS7, T_WS_prev7, T_SC, hp, lm_mask, lm_init, T_WS_kf7, kf_free,
              kf_valid, counter, upd):
    """The JAX program's flat carrier (float section | int section)."""
    f = np.concatenate([
        T_WS7, T_WS_prev7, T_SC.ravel(), hp.ravel(), T_WS_kf7.ravel(),
        [cfg.map_match_radius, cfg.ransac_threshold_deg, cfg.stereo_epipolar_gate,
         cfg.min_depth, cfg.max_depth, cfg.ff_match_angle_deg]])
    i = np.concatenate([lm_mask, lm_init, kf_free.ravel(), kf_valid, [counter], upd])
    return np.concatenate([f, i.astype(np.float64)])


def _decode_diag(diag, NC, N, cap):
    """finish_frame's decode (frontend_pipeline.py:1379-1395)."""
    o = 0

    def take(n, shape):
        nonlocal o
        o += n
        return diag[o - n:o].reshape(shape)

    ms_n, ff_n = min(jfp._MS_ROWS, KF * NC * N), min(jfp._FF_ROWS, NC * N)
    out = {"xy": take(NC * N * 2, (NC, N, 2)), "size": take(NC * N, (NC, N)),
           "mask": take(NC * N, (NC, N)) > 0.5, "idx": take(NC * cap, (NC, cap)).astype(int),
           "keep": take(NC * cap, (NC, cap)) > 0.5, "ms_rows": take(ms_n * 8, (ms_n, 8)),
           "ff_rows": take(ff_n * 4, (ff_n, 4))}
    out.update(n_inl=int(diag[o]), ransac_ok=bool(diag[o + 1] > 0.5), rot_frac=diag[o + 2],
               ms_total=int(diag[o + 3]), ff_total=int(diag[o + 4]))
    return out


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.fixture(scope="module")
def slice_run():
    jcams, jext, tcams, text, T_SC = _rigs()
    jimu, timu = JImu.create(g=9.81), TImu.create(g=9.81, device="cpu")
    jd = jds.SyntheticDataset(jcams, jext, jimu, n_stars=2500, duration=1.0, frame_rate=10.0)
    td = tds.SyntheticDataset(tcams, text, timu, n_stars=2500, duration=1.0, frame_rate=10.0,
                              device="cpu")
    poses = [jd.ground_truth(t) for t in (0.0, 0.1)]
    renders = [(np.stack(jd.render(p)), np.stack(td.render(p))) for p in poses]
    # both packages see the same float64 images (the JAX render's)
    imgs = [r[0].astype(np.float64) for r in renders]

    jcfg = jfp.FrontendConfig(detection=JDet(max_keypoints=N_KP), map_match_capacity=CAP,
                              ransac_hypotheses=N_HYP)
    tcfg = interop.frontend_config_from_numpy(dataclasses.asdict(jcfg))
    NC, N, B = 2, N_KP, 512
    body = jax.jit(jfp._frame_associate_body, static_argnames=(
        "det_cfg", "max_distance", "n_hyp", "min_inliers", "use_ransac", "do_motion_stereo",
        "do_ff", "gravity_aligned"))

    def run_jax(img, aux, tab_s, tab_v, prev_signs, kf_xy, kf_signs, ff_xy, ff_signs, ff_mask,
                gravity=False):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jnp, "float32", jnp.float64)  # keep the readback in float64
            out = body(jcams, jnp.asarray(img), jnp.asarray(aux), jnp.asarray(tab_s),
                       jnp.asarray(tab_v), jnp.asarray(prev_signs), jnp.asarray(kf_xy),
                       jnp.asarray(kf_signs), jnp.asarray(ff_xy), jnp.asarray(ff_signs),
                       jnp.asarray(ff_mask), jnp.zeros(0), det_cfg=jcfg.detection,
                       max_distance=jcfg.matching_threshold, n_hyp=N_HYP,
                       min_inliers=jcfg.ransac_min_inliers, use_ransac=True,
                       do_motion_stereo=not gravity, do_ff=not gravity,
                       gravity_aligned=gravity)
        diag, stacked, _, tab_s, tab_v = out
        return (_decode_diag(np.asarray(diag), NC, N, CAP),
                {k: np.asarray(v) for k, v in stacked.items()}, np.asarray(tab_s),
                np.asarray(tab_v))

    zeros = lambda *s: np.zeros(s)  # noqa: E731
    ident = np.array([0, 0, 0, 0, 0, 0, 1.0])
    hp0 = np.tile([0, 0, 0, 1.0], (CAP, 1))
    no_upd = tfp.DeviceLandmarkTable(CAP, 3, device="cpu").drain(jfp._FLUSH_U)

    # ---- frame A: empty map, no keyframe, no previous frame
    aux = _pack_aux(jcfg, NC, poses[0], ident, T_SC, hp0, zeros(CAP), zeros(CAP),
                    np.tile(ident, (KF, 1)), zeros(KF, NC, N), zeros(KF), 1, no_upd)
    jA = run_jax(imgs[0], aux, zeros(CAP, 3, B), zeros(CAP, 3) > 0, zeros(NC, N, B),
                 zeros(KF, NC, N, 2), zeros(KF, NC, N, B), zeros(NC, N, 2), zeros(NC, N, B),
                 zeros(NC, N) > 0)
    landmarks = {"hp": hp0, "mask": zeros(CAP) > 0, "init": zeros(CAP) > 0}
    tA = tfp.frame_associate(tcams, T_SC, imgs[0], poses[0], landmarks, zeros(CAP, 3, B),
                             zeros(CAP, 3) > 0, tcfg, sampler=_jax_indices(1), device="cpu")

    # ---- static stereo on A at its true pose, inserted with the host dedup
    T_WA7 = np.stack([jse3.compose7(poses[0], T) for T in T_SC])
    gate = np.array([jcfg.stereo_epipolar_gate / F])
    free = jA[1]["mask"]
    s_aux = np.concatenate([T_WA7[0], T_WA7[1], gate, [jcfg.min_depth, jcfg.max_depth],
                            free[0], free[1]])
    jS = jfp._decode_stereo_flat(jfp._stereo_pairs_device(
        jcams, jnp.asarray(s_aux), jnp.asarray(jA[1]["xy"]), jnp.asarray(jA[1]["signs"]),
        ((0, 1),), jcfg.matching_threshold, True), 1, N)
    tS = tfp._stereo_pairs(tcams, T_WA7[:1], T_WA7[1:], gate, jcfg.min_depth, jcfg.max_depth,
                           tA["mask"][:1], tA["mask"][1:], tA["xy"], tA["signs"], ((0, 1),),
                           jcfg.matching_threshold, True)
    table = tfp.DeviceLandmarkTable(CAP, 3, device="cpu")
    table.ensure(B, torch.float64)
    idx_b, hp_W, good, parallel = (_np(x)[0] for x in tS)
    lms, used = {}, set()
    for a in np.nonzero(good)[0]:
        b = int(idx_b[a])
        if (0, a) in used or (1, b) in used:
            continue
        used |= {(0, int(a)), (1, b)}
        lms[len(lms)] = (hp_W[a], not parallel[a])
        table.stage_descriptor(len(lms) - 1, 0, int(a))

    # ---- frame B: map match + RANSAC, frame-to-frame vs A, motion stereo vs A
    hp, lm_mask, lm_init = hp0.copy(), zeros(CAP) > 0, zeros(CAP) > 0
    for lid, s in table.slot_of.items():
        hp[s], lm_mask[s], lm_init[s] = lms[lid][0], True, lms[lid][1]
    upd = table.drain(jfp._FLUSH_U)
    kf_free = np.zeros((KF, NC, N), bool)
    kf_free[0] = tA["mask"].numpy()
    for (c, k) in used:
        kf_free[0, c, k] = False
    T_pred = poses[1] + np.array([0.01, -0.005, 0.003, 0, 0, 0, 0])
    kf_T = np.tile(ident, (KF, 1))
    kf_T[0] = poses[0]
    kf_xy = np.concatenate([tA["xy"].numpy()[None], zeros(KF - 1, NC, N, 2)])
    kf_signs = np.concatenate([tA["signs"].numpy()[None], zeros(KF - 1, NC, N, B)])
    aux = _pack_aux(jcfg, NC, T_pred, poses[0], T_SC, hp, lm_mask, lm_init, kf_T, kf_free,
                    np.array([1, 0, 0]), 2, upd)
    jB = run_jax(imgs[1], aux, zeros(CAP, 3, B), zeros(CAP, 3) > 0, jA[1]["signs"], kf_xy,
                 kf_signs, jA[1]["xy"], jA[1]["signs"], jA[1]["mask"])
    tB = tfp.frame_associate(
        tcams, T_SC, imgs[1], T_pred, {"hp": hp, "mask": lm_mask, "init": lm_init},
        zeros(CAP, 3, B), zeros(CAP, 3) > 0, tcfg,
        staged={"signs": tA["signs"], "upd": upd},
        keyframes={"xy": kf_xy, "signs": kf_signs, "free": kf_free,
                   "valid": np.array([True, False, False]), "T_WS7": kf_T},
        prev={"xy": tA["xy"], "signs": tA["signs"], "mask": tA["mask"], "T_WS7": poses[0]},
        sampler=_jax_indices(2), device="cpu")

    # ---- frame A again with gravity-aligned descriptors (no motion stereo
    # and no frame-to-frame, to keep the extra compile small)
    aux = _pack_aux(jcfg, NC, poses[0], ident, T_SC, hp0, zeros(CAP), zeros(CAP),
                    np.tile(ident, (KF, 1)), zeros(KF, NC, N), zeros(KF), 1, no_upd)
    jG = run_jax(imgs[0], aux, zeros(CAP, 3, B), zeros(CAP, 3) > 0, zeros(NC, N, B),
                 zeros(KF, NC, N, 2), zeros(KF, NC, N, B), zeros(NC, N, 2), zeros(NC, N, B),
                 zeros(NC, N) > 0, gravity=True)
    tG = tfp.frame_associate(tcams, T_SC, imgs[0], poses[0], landmarks, zeros(CAP, 3, B),
                             zeros(CAP, 3) > 0,
                             dataclasses.replace(tcfg, gravity_aligned_description=True),
                             sampler=_jax_indices(1), device="cpu")
    return {"renders": renders, "A": (jA, tA), "S": (jS, tS), "B": (jB, tB), "G": (jG, tG),
            "n_landmarks": len(table.slot_of)}


def test_synthetic_render_matches(slice_run):
    for jr, tr in slice_run["renders"]:
        assert jr.shape == tr.shape == (2, H, W) and jr.max() > 0.2
        assert np.mean(jr == tr) >= 0.999


def _check_keypoints(j, t):
    (jd, _, _, _), tout = j, t
    mask = tout["mask"].numpy()
    np.testing.assert_array_equal(mask, jd["mask"])
    assert mask.sum(1).min() > 20
    np.testing.assert_allclose(tout["xy"].numpy()[mask], jd["xy"][mask], rtol=0, atol=1e-9)
    np.testing.assert_array_equal(tout["signs"].numpy(), j[1]["signs"])


@pytest.mark.parametrize("frame", ["A", "B", "G"])
def test_frame_associate_keypoints(slice_run, frame):
    """Keypoints within 1e-9 px and equal descriptors; "G" is frame A with
    gravity-aligned descriptors, which must differ from the plain ones."""
    _check_keypoints(*slice_run[frame])
    if frame == "G":
        assert not np.array_equal(slice_run["G"][0][1]["signs"], slice_run["A"][0][1]["signs"])


def test_static_stereo_matches(slice_run):
    jS, tS = slice_run["S"]
    idx_b, hp_W, good, parallel = (_np(x) for x in tS)
    np.testing.assert_array_equal(good, jS[2])
    np.testing.assert_array_equal(parallel, jS[3])
    np.testing.assert_array_equal(idx_b, jS[0])
    assert good.sum() > 20
    np.testing.assert_allclose(hp_W[good], jS[1][good], rtol=0, atol=1e-9)
    assert slice_run["n_landmarks"] > 20


def _good_rows(rows, col):
    return rows[rows[:, col] > 0.5]


def test_frame_associate_whole_slice(slice_run):
    (jd, _, j_ts, j_tv), t = slice_run["B"]
    np.testing.assert_array_equal(t["tab_valid"].numpy(), j_tv)
    np.testing.assert_array_equal(t["tab_signs"].numpy(), j_ts)
    # match to map and RANSAC
    np.testing.assert_array_equal(t["idx"].numpy(), jd["idx"])
    np.testing.assert_array_equal(t["keep"].numpy(), jd["keep"])
    assert int(t["n_inl"]) == jd["n_inl"] >= 20
    assert bool(t["ransac_ok"]) == jd["ransac_ok"] is True
    # frame-to-frame rows
    tff, jff = _good_rows(t["ff_rows"].numpy(), 3), _good_rows(jd["ff_rows"], 3)
    assert int(t["ff_total"]) == jd["ff_total"] == len(jff) > 0
    np.testing.assert_array_equal(tff, jff)
    # motion-stereo rows (hp_W in columns 3:7)
    tms, jms = _good_rows(t["ms_rows"].numpy(), 7), _good_rows(jd["ms_rows"], 7)
    assert int(t["ms_total"]) == jd["ms_total"] == len(jms) > 0
    np.testing.assert_array_equal(tms[:, [0, 1, 2, 7]], jms[:, [0, 1, 2, 7]])
    np.testing.assert_allclose(tms[:, 3:7], jms[:, 3:7], rtol=0, atol=1e-9)
    np.testing.assert_allclose(float(t["rot_frac"]), jd["rot_frac"], rtol=0, atol=1e-12)
    assert 0.0 < jd["rot_frac"] < 1.0


def test_frame_associate_without_map(slice_run):
    """Frame A: nothing to match, so RANSAC fails and no rows are good."""
    (jd, _, _, _), t = slice_run["A"]
    assert not bool(t["ransac_ok"]) and not jd["ransac_ok"]
    assert int(t["n_inl"]) == jd["n_inl"] <= 0
    assert not t["keep"].any() and int(t["ms_total"]) == int(t["ff_total"]) == 0
