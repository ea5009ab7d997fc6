"""Loop closure and the full graph: the port against the JAX package on the
CPU, float64.

(a) Bag of words: ``train`` / ``quantize`` / ``bow_vector`` / the database
    query exactly equal on seeded descriptors; ``load_dbow2_yml`` on a small
    ``.yml.gz`` written here; the port's default vocabulary byte-identical
    to the JAX package's file.
(b) ``refine_pose_hessian``: the refined pose within 1e-9, H and the sqrt
    information within 1e-9 of their largest entries, on a noisy inlier
    set; the same NaN entries in both packages where the final Cholesky
    fails (a single bearing at a tiny angle sigma) and from a non-finite
    point.
(c) Every case of ``tests/test_loop_closure.py`` but
    ``test_predicted_shape_bounds_packed_shape`` (its function, an XLA
    prewarm, is not ported), each run on the same fixture built with each
    package. In the place-recognition fixture the images are float64 in
    both packages and the JAX frontend runs with float64 standing for
    float32 (as in ``tests/test_torch_slam.py``), and the port takes the
    JAX loop verification's RANSAC draws. Held there: the same query
    results and verified keyframe, the full-graph pack at the closure
    (each field within 1e-12 of its largest entry, indices and masks
    equal), and the port's ``close_loop(async_solve=True)`` (the
    solve queued on the solve worker, applied at the next ``_finish_one``
    of a pipelined ``SlamSystem``) against the JAX package's inline close:
    poses within 1e-8 m, landmark points within 1e-6 m. The full-graph
    solve of ``test_full_graph_pack_includes_edges`` within 1e-8 in poses.
(d) ``_drive``, a small drive through ``SlamSystem`` in either package
    (``DRIVE``), with the frontend's and loop verification's JAX RANSAC
    draws injected, for ``tests/test_torch_closure_drive_sync.py`` and
    ``tests/test_torch_closure_drive_pipelined.py`` (files of their own so
    that the test workers run the three in parallel: most of their time is
    the JAX package compiling its frame programs and full-graph solves);
    and ``run_synthetic_vio``'s loop-closure options.
"""

import gzip
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from okvis2_torch.frontend import bow as tbow
from okvis2_torch.frontend import pose_refine as tpr
from okvis2_torch.graph import estimator as test_
from okvis2_torch.imu.preintegration import ImuParameters as TImu
from okvis2_torch.pipeline import dataset as tds
from okvis2_torch.pipeline import frontend_pipeline as tfp
from okvis2_torch.pipeline import full_graph as tfg
from okvis2_torch.pipeline import slam as tslam
from okvis2_torch.pipeline import synthetic_run as tsr
from okvis2_torch.pipeline.trajectory import ate_rmse as t_ate
from okvis2_torch.frontend.detection import DetectionConfig as TDet
from okvis2_tpu.frontend import bow as jbow
from okvis2_tpu.frontend import pose_refine as jpr
from okvis2_tpu.frontend.detection import DetectionConfig as JDet
from okvis2_tpu.graph import estimator as jest
from okvis2_tpu.imu.preintegration import ImuParameters as JImu
from okvis2_tpu.pipeline import dataset as jds
from okvis2_tpu.pipeline import frontend_pipeline as jfp
from okvis2_tpu.pipeline import full_graph as jfg
from okvis2_tpu.pipeline import slam as jslam
from okvis2_tpu.pipeline import synthetic_run as jsr
from okvis2_tpu.pipeline.trajectory import ate_rmse as j_ate
from test_torch_pipelined import _carrier_program_f64
from test_torch_slam import _jax_indices

REPO_VOC = ("okvis2_tpu/resources/default_voc.npz", "okvis2_torch/resources/default_voc.npz")


def _jax_lc_sampler(n):
    """The JAX loop verification's RANSAC draws for its n-th verification
    that reaches RANSAC (full_graph.py:145, :163-166: one split of
    PRNGKey(7) per call; p3p.py:255-263), as the port's sampler."""
    key = jax.random.PRNGKey(7)
    for _ in range(n + 1):
        key, k = jax.random.split(key)

    def sampler(mask, cam_idx, n_hyp, NC):
        keys = jax.random.split(k, n_hyp)
        m, ci = jnp.asarray(mask.cpu().numpy()), jnp.asarray(cam_idx.cpu().numpy(), jnp.int32)

        def one(kk, cam):
            w = (m & (ci == cam)).astype(jnp.float64)
            return jax.lax.top_k(jax.random.gumbel(kk, m.shape) + jnp.log(w + 1e-30), 3)[1]

        idx = jax.vmap(one)(keys, jnp.arange(n_hyp, dtype=jnp.int32) % NC)
        return torch.tensor(np.asarray(idx), dtype=torch.long, device=mask.device)

    return sampler


def _f64_jax_frontend(mp):
    """float64 standing for float32 in the JAX frontend (its programs and
    numpy buffers), as in tests/test_torch_slam.py and
    tests/test_torch_pipelined.py."""
    shim = types.SimpleNamespace(**{k: getattr(np, k) for k in dir(np) if not k.startswith("__")})
    shim.float32 = np.float64
    mp.setattr(jnp, "float32", jnp.float64)
    mp.setattr(jfp, "np", shim)
    mp.setattr(jfp, "_frame_associate_from_carrier", _carrier_program_f64)


class _Pkg:
    """One package's constructors at the fixtures' rig (small_rig, float64
    cameras; the port on the CPU)."""

    def __init__(self, name):
        self.jax = name == "jax"
        if self.jax:
            self.cams, self.exts = jsr.small_rig()
            self.imu = JImu.create(g=9.81)
            self.kw = {}
            self.est, self.fg, self.fp, self.ds, self.Det = jest, jfg, jfp, jds, JDet
        else:
            self.cams, self.exts = tsr.small_rig(dtype=torch.float64, device="cpu")
            self.imu = TImu.create(g=9.81, device="cpu")
            self.kw = {"device": "cpu"}
            self.est, self.fg, self.fp, self.ds, self.Det = test_, tfg, tfp, tds, TDet

    def estimator(self, **cfg):
        return self.est.Estimator(self.cams, self.exts, self.imu, self.est.EstimatorConfig(**cfg),
                                  **self.kw)

    def backend(self, **cfg):
        kw = dict(self.kw) if self.jax else dict(self.kw, sampler=_jax_lc_sampler)
        return self.fg.LoopClosureBackend(self.cams, self.exts, self.fg.LoopClosureConfig(**cfg),
                                          **kw)

    def frontend(self, max_kp):
        return self.fp.Frontend(self.cams, self.exts,
                                self.fp.FrontendConfig(detection=self.Det(max_keypoints=max_kp)),
                                **self.kw)

    def edge(self, *a):
        return self.est.PoseGraphEdge(*a)


PKGS = {"jax": _Pkg("jax"), "port": _Pkg("port")}


def _both(case, *a):
    """``case`` run on each package's fixture: (JAX result, port result)."""
    return case(PKGS["jax"], *a), case(PKGS["port"], *a)


# ---------------------------------------------------------------------------
# (a) bag of words
# ---------------------------------------------------------------------------

def test_vocabulary_and_database_match():
    rng = np.random.default_rng(5)
    signs = rng.choice([-1.0, 1.0], (600, 512)).astype(np.float32)
    vj = jbow.BinaryVocabulary.train(signs, n_words=48, iters=8, seed=0)
    vt = tbow.BinaryVocabulary.train(signs, n_words=48, iters=8, seed=0)
    np.testing.assert_array_equal(vt.centroid_signs, vj.centroid_signs)
    np.testing.assert_array_equal(vt.idf, vj.idf)
    mask = rng.random(600) > 0.1
    np.testing.assert_array_equal(vt.quantize(signs, mask), vj.quantize(signs, mask))
    np.testing.assert_array_equal(vt.bow_vector(signs[:200], mask[:200]),
                                  vj.bow_vector(signs[:200], mask[:200]))
    dj, dt = jbow.PlaceRecognitionDatabase(vj), tbow.PlaceRecognitionDatabase(vt)
    for k in range(6):
        sl = slice(100 * k, 100 * k + 100)
        dj.add(10 + k, signs[sl], mask[sl])
        dt.add(10 + k, signs[sl], mask[sl])
    q = np.concatenate([signs[:60], rng.choice([-1.0, 1.0], (40, 512)).astype(np.float32)])
    for excl, score in ((0, 0.0), (2, 0.0), (1, 0.2)):
        rj = dj.query(q, exclude_recent=excl, min_score=score)
        assert dt.query(q, exclude_recent=excl, min_score=score) == rj and len(rj) >= 1
    assert len(dt) == len(dj) == 6


def test_dbow2_yml_loader(tmp_path):
    """A DBoW2 OpenCV-YAML vocabulary (a root, two inner nodes, four
    words of 32-byte descriptors, one leaf that is no word)."""
    rng = np.random.default_rng(2)
    lines = ["%YAML:1.0", "vocabulary:", "   k: 2", "   L: 2", "   nodes:"]
    for nid in range(1, 8):
        desc = " ".join(str(int(b)) for b in rng.integers(0, 256, 32))
        lines.append(f'      - {{ nodeId:{nid}, parentId:{(nid - 1) // 2}, '
                     f'weight:{rng.uniform(0.1, 2.0):.6f}, descriptor:"{desc}" }}')
    lines.append("   words:")
    for wid, nid in enumerate((3, 4, 6, 5)):
        lines.append(f"      - {{ wordId:{wid}, nodeId:{nid} }}")
    path = str(tmp_path / "voc.yml.gz")
    with gzip.open(path, "wt") as f:
        f.write("\n".join(lines) + "\n")
    vj, vt = jbow.BinaryVocabulary.load(path), tbow.BinaryVocabulary.load(path)
    assert vt.n_words == vj.n_words == 4
    np.testing.assert_array_equal(vt.centroid_signs, vj.centroid_signs)
    np.testing.assert_array_equal(vt.idf, vj.idf)
    # 256 bits from the file, zero-padded to 512
    assert np.all(vt.centroid_signs[:, 256:] == 0) and np.all(np.abs(vt.centroid_signs[:, :256]) == 1)


def test_default_vocabulary_is_the_jax_file():
    import os

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    blobs = [open(os.path.join(repo, p), "rb").read() for p in REPO_VOC]
    assert blobs[0] == blobs[1] and len(blobs[0]) == 61546
    lt = PKGS["port"].backend().voc
    lj = PKGS["jax"].backend().voc
    np.testing.assert_array_equal(lt.centroid_signs, lj.centroid_signs)
    np.testing.assert_array_equal(lt.idf, lj.idf)


# ---------------------------------------------------------------------------
# (b) pose refine
# ---------------------------------------------------------------------------

def _refine_inputs(case):
    rng = np.random.default_rng(0)
    N = 40
    pts = rng.uniform(-2, 2, (N, 3)) + [0, 0, 6]
    T_SC = np.array([[0, 0, 0, 0, 0, 0, 1.0], [0.11, 0, 0, 0, 0, 0, 1.0]])
    cam = rng.integers(0, 2, N)
    T_SW = np.array([0.05, -0.02, 0.01, 0.01, 0.02, -0.01, 1.0])
    T_SW[3:] /= np.linalg.norm(T_SW[3:])
    rays = pts - T_SC[cam, :3] + rng.normal(0, 2e-3, (N, 3))
    rays /= np.linalg.norm(rays, axis=1, keepdims=True)
    mask = rng.random(N) > 0.2
    sigma = 0.002
    if case == "single bearing":
        mask[:] = False
        mask[3] = True
        sigma = 1e-6
    if case == "non-finite point":
        pts[5] = np.nan
    return (T_SW, pts, rays, cam, mask, T_SC), sigma


@pytest.mark.parametrize("case", ["inliers", "single bearing", "non-finite point"])
def test_refine_pose_hessian(case):
    (T_SW, pts, rays, cam, mask, T_SC), sigma = _refine_inputs(case)
    j = [np.asarray(x) for x in jax.device_get(jpr.refine_pose_hessian(
        jnp.asarray(T_SW), jnp.asarray(pts), jnp.asarray(rays), jnp.asarray(cam, jnp.int32),
        jnp.asarray(mask), jnp.asarray(T_SC), angle_sigma=sigma))]
    t = [x.numpy() for x in tpr.refine_pose_hessian(
        torch.tensor(T_SW), torch.tensor(pts), torch.tensor(rays), torch.tensor(cam),
        torch.tensor(mask), torch.tensor(T_SC), angle_sigma=sigma)]
    for a, b in zip(t, j):
        np.testing.assert_array_equal(np.isfinite(a), np.isfinite(b))
    if case == "non-finite point":
        assert not np.isfinite(t[0]).any()
    elif case == "single bearing":
        # the final factor fails: NaN on and below its diagonal, no
        # exception (the pose, refined on a rank-2 Hessian, is finite)
        assert np.isfinite(t[0]).all() and np.isnan(t[2][np.triu_indices(6)]).all()
    else:
        assert np.isfinite(t[2]).all()
        np.testing.assert_allclose(t[0], j[0], rtol=0, atol=1e-9)
        np.testing.assert_allclose(t[1], j[1], rtol=0, atol=1e-9 * np.abs(j[1]).max())
        np.testing.assert_allclose(t[2], j[2], rtol=0, atol=1e-9 * np.abs(j[2]).max())


# ---------------------------------------------------------------------------
# (c) the cases of tests/test_loop_closure.py
# ---------------------------------------------------------------------------

def _add_state(est, t, n=5, dt=0.02):
    return est.add_state(t, np.full((n, 3), 0.001) if n == 8 else np.zeros((n, 3)),
                         np.tile([0, 0, 9.81], (n, 1)), np.full(n, dt))


POSE_A = np.array([0.0, 0, 0, 0, 0, 0, 1.0])
VISITS = ((POSE_A, 0.0), (np.array([0.8, 0.3, 0, 0, 0, 0, 1.0]), 1.0),
          (np.array([0.0, 0.9, 0, 0, 0, 0, 1.0]), 2.0), (np.array([-0.8, 0.4, 0, 0, 0, 0, 1.0]), 2.5))


def _port_frames(frames):
    """The JAX frontend's per-camera detection and description as the
    port's frames (host arrays and the device-resident stacks)."""
    xy, mask, signs = (np.stack([np.asarray(f[k]) for f in frames])
                       for k in ("xy", "mask", "signs_np"))
    words = ((signs > 0).reshape(*signs.shape[:2], -1, 32).astype(np.uint64)
             << np.arange(32, dtype=np.uint64)).sum(-1).astype(np.uint32).view(np.int32)
    stacked = {"xy": torch.tensor(xy), "mask": torch.tensor(mask),
               "signs": torch.tensor(signs), "signs_packed": torch.tensor(words)}
    return [{"xy": xy[c], "size": np.asarray(f["size"]), "mask": mask[c], "signs_np": signs[c],
             "stacked": stacked, "cam": c} for c, f in enumerate(frames)]


def _place_fixture(P, describe, after_stereo=lambda est: None):
    """test_place_recognition_and_geometric_verify's fixture up to the
    query: four stereo-initialised keyframes, a fifth at pose A.
    ``describe(fe, images, visit)`` gives each visit's frames;
    ``after_stereo(est)`` runs after each static stereo."""
    fe = P.frontend(256)
    est = P.estimator()
    lc = P.backend(min_train_descriptors=400, exclude_recent=2, vocabulary_size=64)
    ds = P.ds.SyntheticDataset(P.cams, P.exts, P.imu, n_stars=2500, seed=3, **P.kw)
    sids = []
    for k, (pose7, t) in enumerate(VISITS):
        sid = _add_state(est, t)
        est.states[sid].pose = pose7.copy()
        est.set_keyframe(sid, True)
        frames = describe(fe, ds.render(pose7), k)
        fe.match_stereo(est, frames, sid)
        after_stereo(est)
        lc.add_keyframe(est, sid, frames)
        sids.append(sid)
    sid_D = _add_state(est, 3.0)
    est.states[sid_D].pose = POSE_A.copy()
    est.set_keyframe(sid_D, True)
    frames_D = describe(fe, ds.render(POSE_A), len(VISITS))
    old = lc.detect_loop(est, sid_D, frames_D)
    return dict(fe=fe, est=est, lc=lc, sids=sids, sid_D=sid_D, frames_D=frames_D, old=old,
                query=list(lc.last_query_results), n_lm=len(est.landmarks))


@pytest.fixture(scope="module")
def place():
    """Both packages' place-recognition fixtures, on float64 images; the
    port's frontend takes the JAX frontend's detection and description
    (its own differs from it in a few descriptor bits per image that tie
    to rounding, ROADMAP C; held separately here), and after each static
    stereo the JAX package's triangulated points (the same landmarks and
    observations, the points within 1e-9 m: held here), so that what
    follows sees the same records. The JAX package's loop is closed
    inline; the pack at the closure is recorded."""
    packs, jframes, own, lm_gap, jlms = {}, [], [], [], []

    def describe_jax(fe, images, k):
        jframes.append(fe.detect_and_describe([im.astype(np.float64) for im in images]))
        return jframes[-1]

    def describe_port(fe, images, k):
        own.append(fe.detect_and_describe([im.astype(np.float64) for im in images]))
        return _port_frames(jframes[k])

    with pytest.MonkeyPatch.context() as mp:
        _f64_jax_frontend(mp)
        fj = _place_fixture(PKGS["jax"], describe_jax, lambda est: jlms.append(
            {lid: (set(lm.obs), lm.initialised, lm.hp_W.copy()) for lid, lm in est.landmarks.items()}))
        fj["closed"] = _record_pack(fj, packs, "jax", _close_inline)
    def same_landmarks(est):
        ref = jlms.pop(0)
        assert est.landmarks.keys() == ref.keys()
        for lid, lm in est.landmarks.items():
            obs, init, hp = ref[lid]
            assert set(lm.obs) == obs and lm.initialised == init, lid
            lm_gap.append(float(np.abs(lm.hp_W[:3] / lm.hp_W[3] - hp[:3] / hp[3]).max()))
            lm.hp_W = hp.copy()

    ft = _place_fixture(PKGS["port"], describe_port, same_landmarks)
    return {"jax": fj, "port": ft, "packs": packs, "frames": (jframes, own), "lm_gap": lm_gap}


def _close_inline(f):
    return f["lc"].close_loop(f["est"], f["old"], f["sid_D"], f["frames_D"])


def _record_pack(f, packs, name, close):
    """``close(f)`` with the full-graph pack it solves kept in ``packs``."""
    lc = f["lc"]
    pack = lc.pack_full_problem

    def keep(est):
        out = pack(est)
        packs[name] = out
        return out

    lc.pack_full_problem = keep
    try:
        return close(f)
    finally:
        lc.pack_full_problem = pack


def test_detect_and_describe_matches(place):
    """The port's ``detect_and_describe`` on the fixture's images: the same
    keypoints in the same order, sizes equal, and descriptors equal but
    for bits that tie to rounding (at most 1 % of the bits). Its packed
    words unpack (``fetch_signs``) to its signs."""
    jframes, own = place["frames"]
    fe = PKGS["port"].frontend(256)
    n_bits = n_diff = 0
    for fj, ft in zip(jframes, own):
        signs = np.stack([f["signs_np"] for f in ft])
        np.testing.assert_array_equal(fe.fetch_signs(ft), signs)
        for a, b in zip(fj, ft):
            m = np.asarray(a["mask"])
            np.testing.assert_array_equal(b["mask"], m)
            np.testing.assert_allclose(b["xy"][m], np.asarray(a["xy"])[m], rtol=0, atol=1e-9)
            np.testing.assert_array_equal(b["size"][m], np.asarray(a["size"])[m])
            n_diff += int((b["signs_np"][m] != np.asarray(a["signs_np"])[m]).sum())
            n_bits += b["signs_np"][m].size
    assert n_diff <= 0.01 * n_bits, (n_diff, n_bits)


def test_place_recognition_and_geometric_verify(place):
    fj, ft = place["jax"], place["port"]
    assert max(place["lm_gap"]) < 1e-9
    assert ft["n_lm"] == fj["n_lm"] > 100
    assert ft["old"] == fj["old"] == ft["sids"][0], (ft["old"], ft["lc"].last_verify_info)
    assert [k for k, _ in ft["query"]] == [k for k, _ in fj["query"]]
    np.testing.assert_allclose([s for _, s in ft["query"]], [s for _, s in fj["query"]],
                               rtol=0, atol=1e-6)
    assert fj["closed"]
    est = fj["est"]
    assert any(e.kind == "loop" for e in est.pose_graph_edges)
    assert fj["lc"].num_loop_closures == 1


def test_close_loop_async_matches(place):
    """The port's closure with its full-graph solve queued on the solve
    worker (the pipelined loop's path), applied at the next frame's
    ``_finish_one`` (its other work stubbed), against the JAX package's
    inline closure: the loop edge, the pack at the closure, the solved
    poses and landmarks."""
    fj, ft, packs = place["jax"], place["port"], place["packs"]
    slam = tslam.SlamSystem(PKGS["port"].cams, PKGS["port"].exts, PKGS["port"].imu,
                            do_loop_closures=True, pipelined=True, device="cpu")
    slam.estimator, slam.frontend, slam.loop_backend = ft["est"], ft["fe"], ft["lc"]
    ok = _record_pack(ft, packs, "port", lambda f: f["lc"].close_loop(
        f["est"], f["old"], f["sid_D"], f["frames_D"], async_solve=True))
    assert ok and ft["lc"].num_loop_closures == 1
    assert ft["lc"]._pending_fg is not None  # queued, not yet applied
    pj, pt = packs["jax"], packs["port"]
    assert pt[1] == pj[1] and pt[2] == pj[2] and pt[3] == pj[3]
    for name in test_.WindowProblem._FIELDS:
        a, b = getattr(pt[0], name), getattr(pj[0], name)
        pairs = zip(a.leaves(), jax.tree_util.tree_leaves(b)) if name == "imu_pre" else [(a, b)]
        for x, y in pairs:
            x, y = x.numpy().astype(np.float64), np.asarray(y).astype(np.float64)
            assert x.shape == y.shape, name
            # each field within 1e-12 of its largest entry (the loop edge's
            # information comes from the refine's Hessian, ~1e7)
            np.testing.assert_allclose(x, y, rtol=0, atol=1e-12 * max(np.abs(y).max(), 1.0),
                                       err_msg=name)

    class Done:
        def result(self):
            return np.zeros(0)

    stubbed = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(slam, "_finish_deferred_keyframe", lambda: stubbed.append("kf"))
        mp.setattr(slam.frontend, "finish_frame", lambda *a: ([], {}))
        mp.setattr(slam.estimator, "solve_out_size", lambda: 0)
        mp.setattr(slam, "_frame_epilogue", lambda *a, **kw: stubbed.append("epilogue"))
        slam._finish_one({"job": {"future": Done()}, "ctx": None, "epoch": slam._corr_epoch,
                          "t": 3.0, "sid": ft["sid_D"], "images": None})
    assert stubbed == ["kf", "epilogue"] and ft["lc"]._pending_fg is None
    assert slam._corr_epoch == 1  # the non-rigid correction epoch
    ej, et = fj["est"], ft["est"]
    assert [(e.id_i, e.id_j, e.kind) for e in et.pose_graph_edges] == \
        [(e.id_i, e.id_j, e.kind) for e in ej.pose_graph_edges]
    for s in ej.state_order:
        np.testing.assert_allclose(et.states[s].pose, ej.states[s].pose, rtol=0, atol=1e-8)
    assert et.landmarks.keys() == ej.landmarks.keys()
    pts = lambda e: np.stack([l.hp_W[:3] / l.hp_W[3] for l in e.landmarks.values()])  # noqa
    np.testing.assert_allclose(pts(et), pts(ej), rtol=0, atol=1e-6)
    slam.finish()
    assert slam.estimator._solve_worker is None


def _pack_case(P):
    est = P.estimator()
    sids = []
    for i in range(4):
        sid = _add_state(est, i * 0.5, n=8, dt=0.0625)
        est.set_keyframe(sid, True)
        sids.append(sid)
    est.pose_graph_edges.append(P.edge(sids[0], sids[3], np.array([0.1, 0, 0, 0, 0, 0, 1.0]),
                                       np.eye(6) * 10, [], "loop"))
    lc = P.backend()
    prob, ids, slot_of, lm_ids = lc.pack_full_problem(est)
    stats = lc.optimise_full_graph(est)
    return (len(ids), int(np.asarray(prob.rel_mask).sum()), int(np.asarray(prob.imu_mask).sum()),
            float(stats["final_cost"]), np.stack([est.states[s].pose for s in sids]))


def test_full_graph_pack_includes_edges():
    j, t = _both(_pack_case)
    assert t[:3] == j[:3] == (4, 1, 3)
    assert np.isfinite(t[3])
    np.testing.assert_allclose(t[3], j[3], rtol=1e-8, atol=1e-12)
    np.testing.assert_allclose(t[4], j[4], rtol=0, atol=1e-8)


def _budget_case(P):
    est = P.estimator()
    sids = []
    for i in range(10):
        sid = _add_state(est, i * 0.5, n=8, dt=0.0625)
        est.states[sid].pose = np.array([0.3 * i, 0.0, 0.0, 0.0, 0.0, 0.0, 1.0])
        est.set_keyframe(sid, True)
        sids.append(sid)
    lc = P.backend()
    chain = lc._loop_chain(est, sids[0], sids[-1])
    good = est.states[sids[-1]].pose.copy()
    good[0] += 0.05
    bad = est.states[sids[-1]].pose.copy()
    bad[1] += 2.0
    rot = est.states[sids[-1]].pose.copy()
    rot[3:7] = np.array([0.247, 0, 0, 0.969])
    out = [lc._drift_budget_ok(est, chain, T, sids[-1]) for T in (good, bad, rot)]
    return chain, out, lc.last_verify_info


def test_drift_budget_rejects_false_positive():
    j, t = _both(_budget_case)
    assert t == j
    assert t[1] == [True, False, False]


def _reactivate_case(P):
    est = P.estimator()
    sids = []
    for i in range(4):
        sid = _add_state(est, i * 0.5, n=8, dt=0.0625)
        est.set_keyframe(sid, True)
        sids.append(sid)
    lid = est.add_landmark(np.array([0.0, 0, 5.0, 1.0]), initialised=True)
    stored = [(lid, sids[1], 0, 7, 100.0, 120.0, 9.0)]
    est.pose_graph_edges.append(P.edge(sids[0], sids[1], np.array([0.1, 0, 0, 0, 0, 0, 1.0]),
                                       np.eye(6) * 10, stored, "marg"))
    n = P.backend()._reactivate_loop_observations(est, sids)
    return n, dict(est.landmarks[lid].obs), len(est.pose_graph_edges)


def test_loop_reactivates_stored_observations():
    j, t = _both(_reactivate_case)
    assert t == j == (1, {(1, 0, 7): (100.0, 120.0, 9.0)}, 0)


def _rejoin_case(P):
    est = P.estimator(num_loop_closure_frames=2)
    sids = []
    for i in range(6):
        sid = _add_state(est, i * 0.5, n=8, dt=0.0625)
        est.set_keyframe(sid, True)
        sids.append(sid)
    for sid in sids[:3]:
        est.states[sid].frozen = True
        est.states[sid].in_window = False
        est.window.remove(sid)
    added = est.reactivate_loop_states(sids)
    return added, list(est.window), [est.states[s].frozen for s in sids]


def test_loop_states_rejoin_window():
    j, t = _both(_rejoin_case)
    assert t == j
    added, window, frozen = t
    assert added == 2 and window == sorted(window) and 0 in window and 1 in window
    assert frozen[:3] == [False, False, True]


def _pruning_case(P):
    est = P.estimator()
    lc = P.backend()
    wall_a = [est.add_landmark([float(x), float(y), 5.0, 1.0], initialised=True)
              for x in np.linspace(-2, 2, 5) for y in np.linspace(-1.5, 1.5, 3)]
    wall_b = [est.add_landmark([3.5 + float(x), float(y), 4.0, 1.0], initialised=True)
              for x in np.linspace(-0.5, 1.5, 5) for y in np.linspace(-1.5, 1.5, 3)]

    def state(t, pose7, obs):
        sid = est.add_state(t, np.zeros((0, 3)), np.zeros((0, 3)), np.zeros(0))
        est.states[sid].pose = np.asarray(pose7, np.float64)
        for kp, lid in enumerate(obs):
            est.add_observation(lid, sid, 0, kp, (100.0, 100.0), 9.0)
        return sid

    s0 = state(0.0, [0.0, 0, 0, 0, 0, 0, 1.0], wall_a)
    s1 = state(0.5, [0.02, 0.01, 0, 0, 0, 0, 1.0], wall_a)
    s2 = state(1.0, [1.0, 0, 0, 0, 0, 0, 1.0], wall_a)
    ang = 0.3
    s3 = state(1.5, [0.0, 0, 0, 0.0, np.sin(ang), 0.0, np.cos(ang)], wall_b)
    lc._pr_ids.append(s0)
    return [lc._pr_eligible(est, s) for s in (s1, s2, s3)]


def test_place_recognition_pruning():
    j, t = _both(_pruning_case)
    assert t == j == [False, True, True]


def _expand_case(P):
    est = P.estimator()
    s_old = est.add_state(0.0, np.zeros((0, 3)), np.zeros((0, 3)), np.zeros(0))
    s_anchor = _add_state(est, 0.5, n=8, dt=0.0625)
    s_now = _add_state(est, 1.0, n=8, dt=0.0625)
    lids = []
    for k in range(15):
        lid = est.add_landmark([0.1 * k, 0, 5, 1], initialised=True)
        est.add_observation(lid, s_now, 0, k, (10 * k, 20))
        lids.append(lid)
    stored = [(lid, s_old, 0, k, 10.0 * k, 30.0, 9.0) for k, lid in enumerate(lids)]
    est.pose_graph_edges.append(P.edge(s_anchor, s_old, np.array([0.1, 0, 0, 0, 0, 0, 1.0]),
                                       np.eye(6) * 10, stored, "marg"))
    est.states[s_old].is_pose_graph_frame = True
    est.states[s_old].frozen = True
    est.states[s_old].in_window = False
    est.window.remove(s_old)
    ok = est.expand_keyframe(s_now)
    rec = est.states[s_old]
    return (ok, s_old in est.window, rec.frozen, rec.is_pose_graph_frame,
            len(est.pose_graph_edges), (s_old, 0, 0) in est.landmarks[lids[0]].obs)


def test_expand_keyframe_reactivates_pose_graph_frame():
    j, t = _both(_expand_case)
    assert t == j == (True, True, False, False, 0, True)


def _merge_case(P):
    est = P.estimator()
    fe = P.frontend(64)
    sid = est.add_state(0.0, np.zeros((0, 3)), np.zeros((0, 3)), np.zeros(0))
    lid_old = est.add_landmark(np.array([0.0, 0, 5.0, 1.0]), initialised=True)
    lid_old2 = est.add_landmark(np.array([1.0, 0, 5.0, 1.0]), initialised=True)
    lid_live = est.add_landmark(np.array([1.01, 0, 5.0, 1.0]), initialised=True)
    est.add_observation(lid_live, sid, 0, 3, (30.0, 40.0), 9.0)
    N = 64
    frames = [{"xy": np.tile(np.array([[10.0, 20.0]]), (N, 1)), "size": np.full(N, 9.0),
               "mask": np.ones(N, bool)}]
    lc = P.backend()
    n_merged = lc._merge_loop_landmarks(est, sid, [(lid_old, 0, 7), (lid_old2, 0, 3)], frames, fe)
    return (n_merged, lc.num_loop_observations, sorted(est.landmarks),
            dict(est.landmarks[lid_old].obs), dict(est.landmarks[lid_old2].obs),
            fe.table._upd)


def test_loop_inserts_observations_of_old_landmarks():
    j, t = _both(_merge_case)
    assert t == j
    n_merged, n_obs, lids, obs_old, obs_old2, staged = t
    assert n_merged == 1 and n_obs == 1 and lids == [0, 1]
    assert (0, 0, 7) in obs_old and (0, 0, 3) in obs_old2 and len(staged) == 1


def _growth_case(P):
    est = P.estimator()
    lc = P.backend()
    rng = np.random.default_rng(3)
    lids = [est.add_landmark([float(x), float(y), 5.0, 1.0], initialised=True)
            for x in np.linspace(-2, 2, 6) for y in np.linspace(-1.5, 1.5, 4)]

    def fake_frames(n=48):
        return [{"signs_np": rng.choice([-1.0, 1.0], (n, 512)).astype(np.float32),
                 "mask": np.ones(n, bool), "xy": rng.uniform(10, 230, (n, 2)).astype(np.float32)}
                for _ in range(len(P.cams))]

    def keyframe(pose7, t, obs_lids):
        sid = est.add_state(t, np.zeros((0, 3)), np.zeros((0, 3)), np.zeros(0))
        est.states[sid].pose = np.asarray(pose7, np.float64)
        for kp, lid in enumerate(obs_lids):
            est.add_observation(lid, sid, 0, kp, (100.0, 100.0), 9.0)
        lc.add_keyframe(est, sid, fake_frames())

    for k in range(30):
        jit = rng.uniform(-0.05, 0.05, 3)
        keyframe([jit[0], jit[1], jit[2], 0, 0, 0, 1.0], 0.1 * k, lids)
    n_same = len(lc._pr_ids)
    q = [0.0, np.sin(np.pi / 4), 0.0, np.cos(np.pi / 4)]
    for k in range(5):
        x0 = 10.0 + 8.0 * k
        new = [est.add_landmark([x0 + 5.0, float(y), float(z), 1.0], initialised=True)
               for y in np.linspace(-1.5, 1.5, 4) for z in np.linspace(-2, 2, 6)]
        keyframe([x0, 0.0, 0.0] + q, 10.0 + 0.1 * k, new)
    return n_same, list(lc._pr_ids), len(lc.db)


def test_pr_database_growth_bounded_on_revisit():
    j, t = _both(_growth_case)
    assert t == j
    n_same, pr_ids, n_db = t
    assert n_same <= 3 and len(pr_ids) >= n_same + 4 and n_db == len(pr_ids)


# ---------------------------------------------------------------------------
# (d) drives through SlamSystem
# ---------------------------------------------------------------------------

# one circle (5 s) at 6 Hz of the star dataset at 192x128 with a wide
# lens (f = 120), 128 keypoints, 2 window keyframes; place recognition
# with exclude_recent=2 and without the drift budget (these few frames
# close against keyframes 3 frames back, where the budget is a few cm and
# sits within a few mm of the measured corrections, so its decision
# rests on millimetres the two packages do not share; the budget is held
# by test_drift_budget_rejects_false_positive)
DRIVE = dict(width=192, height=128, f=120.0, max_keypoints=128, n_stars=1500, duration=5.0,
             frame_rate=6.0)
EST = dict(window_slots=8, landmark_slots=192, obs_slots=1024, imu_seg_capacity=64,
           num_keyframes=2)
LOOP = dict(exclude_recent=2, check_drift_budget=False)


def _drive(jax_pkg, n_frames, pipelined):
    """The drive's first ``n_frames`` through one package's SlamSystem
    (pipelined: one frame kept in flight). Returns (ATE, closure frames,
    loop edges, [per keyframe: (sid, detect result, query results, verify
    info, budget rejections, closures)], the system)."""
    d = DRIVE
    if jax_pkg:
        cams, exts = jsr.small_rig(d["width"], d["height"], f=d["f"])
        imu = JImu.create(g=9.81)
        slam = jslam.SlamSystem(cams, exts, imu, jest.EstimatorConfig(**EST),
                                jfp.FrontendConfig(detection=JDet(max_keypoints=d["max_keypoints"])),
                                do_loop_closures=True, loop_closure_config=jfg.LoopClosureConfig(**LOOP),
                                pipelined=pipelined)
        ds = jds.SyntheticDataset(cams, exts, imu, duration=d["duration"], frame_rate=d["frame_rate"],
                                  n_stars=d["n_stars"], trajectory="circle")
        ate = j_ate
    else:
        cams, exts = tsr.small_rig(d["width"], d["height"], f=d["f"], dtype=torch.float64,
                                   device="cpu")
        imu = TImu.create(g=9.81, device="cpu")
        slam = tslam.SlamSystem(cams, exts, imu, test_.EstimatorConfig(**EST),
                                tfp.FrontendConfig(detection=TDet(max_keypoints=d["max_keypoints"])),
                                do_loop_closures=True, loop_closure_config=tfg.LoopClosureConfig(**LOOP),
                                pipelined=pipelined, device="cpu", ransac_sampler=_jax_indices,
                                loop_ransac_sampler=_jax_lc_sampler)
        ds = tds.SyntheticDataset(cams, exts, imu, duration=d["duration"], frame_rate=d["frame_rate"],
                                  n_stars=d["n_stars"], trajectory="circle", device="cpu")
        ate = t_ate
    slam._force_min_pending = 1 if pipelined else 0
    lb, decisions = slam.loop_backend, []
    detect = lb.detect_loop

    def recorded(est, sid, frames, fe=None):
        out = detect(est, sid, frames, fe)
        decisions.append((sid, out, [(k, round(s, 4)) for k, s in lb.last_query_results],
                          lb.last_verify_info, lb.num_rejected_by_budget, lb.num_loop_closures))
        return out

    lb.detect_loop = recorded
    gt, closures = [], []
    for ev in ds.stream():
        if ev[0] == "imu":
            slam.add_imu_measurement(ev[1], ev[2], ev[3])
            continue
        if len(gt) == n_frames:
            break
        gt.append((ev[1], ev[3]))
        slam.add_images(ev[1], ev[2])
        n0 = lb.num_loop_closures
        slam.process_frame()
        closures += [len(gt) - 1] * (lb.num_loop_closures - n0)
    traj = slam.trajectory()
    edges = [[e.id_i, e.id_j] for e in slam.estimator.pose_graph_edges if e.kind == "loop"]
    return ate(traj, gt, align=True), closures, edges, decisions, slam


def test_run_synthetic_vio_with_loop_closure():
    """``run_synthetic_vio``'s loop-closure options reach the system, and
    "lc_frames" lists each frame whose host work closed a loop (a short
    circle where every keyframe may close against the one before it)."""
    cfg = tfg.LoopClosureConfig(exclude_recent=0, check_drift_budget=False)
    res = tsr.run_synthetic_vio(duration=1.5, frame_rate=4.0, width=96, height=64,
                                max_keypoints=48, n_stars=400, dtype=torch.float64, device="cpu",
                                estimator_config=test_.EstimatorConfig(**EST), trajectory="circle",
                                do_loop_closures=True, loop_closure_config=cfg)
    lb = res["slam"].loop_backend
    assert res["frames"] == 6 and lb.cfg is cfg
    assert res["lc_frames"] == sorted(res["lc_frames"])
    assert len(res["lc_frames"]) == lb.num_loop_closures
    assert np.isfinite(res["ate_rmse"])
