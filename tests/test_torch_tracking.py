"""The port's tracking math against the JAX package on the CPU, in float64:
host SE(3) helpers and the IMU pose prediction (within 1e-12), two-view
triangulation (1e-12), Lambda-Twist P3P (equal valid flags, R and t within
1e-9 where valid) and the rig RANSAC.

RANSAC randomness cannot match bit for bit (the JAX package draws from its
own PRNG), so ``ransac_rig_pose_from_samples`` is fed the JAX package's own
indices (p3p.py:255-263 recomputed here) and held to the same score vector,
best hypothesis, inlier set and pose (1e-8); the port's own sampler is held
to test_p3p's outcome bars. The two P3P solvers differ only in how a 3x3
determinant is rounded (cofactors here, LU in the JAX package).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from okvis2_torch.core import se3_np as tse3
from okvis2_torch.core.se3 import Transformation as TT
from okvis2_torch.frontend import p3p as tp3p
from okvis2_torch.frontend import triangulation as ttri
from okvis2_torch.imu import preintegration as tpre
from okvis2_tpu.core import se3_np as jse3
from okvis2_tpu.core import so3 as jso3
from okvis2_tpu.core.se3 import Transformation as JT
from okvis2_tpu.frontend import p3p as jp3p
from okvis2_tpu.frontend import triangulation as jtri
from okvis2_tpu.imu import preintegration as jpre


def _rand_pose7(rng):
    q = rng.normal(size=4)
    return np.concatenate([rng.normal(size=3), q / np.linalg.norm(q)])


# ---------------------------------------------------------------------------
# host SE(3) and pose prediction
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fn", ["quat_conj", "quat_mul", "quat_to_mat", "compose7",
                                "inverse7", "apply7", "log_so3"])
def test_se3_np_matches(fn):
    rng = np.random.default_rng(1)
    for _ in range(20):
        a, b = _rand_pose7(rng), _rand_pose7(rng)
        args = {
            "quat_conj": (a[3:],), "quat_mul": (a[3:], b[3:]), "quat_to_mat": (a[3:],),
            "compose7": (a, b), "inverse7": (a,), "apply7": (a, rng.normal(size=(5, 3))),
            "log_so3": (a[3:],),
        }[fn]
        np.testing.assert_allclose(getattr(tse3, fn)(*args), getattr(jse3, fn)(*args),
                                   rtol=0, atol=1e-12)
    # the small-angle branch of log_so3
    q = np.array([1e-14, -2e-14, 0.0, -1.0])
    np.testing.assert_allclose(tse3.log_so3(q), jse3.log_so3(q), rtol=0, atol=1e-12)


def test_propagate_state_np_matches():
    rng = np.random.default_rng(2)
    T = _rand_pose7(rng)
    sb = rng.normal(size=9) * 0.1
    gyro = rng.normal(size=(11, 3)) * 0.5
    accel = rng.normal(size=(11, 3)) + np.array([0, 0, 9.81])
    dt = np.full(11, 0.005)
    dt[4] = 0.0  # a skipped sample
    T1, sb1 = tpre.propagate_state_np(9.81, T, sb, gyro, accel, dt)
    J1, jsb1 = jpre.propagate_state_np(9.81, T, sb, gyro, accel, dt)
    np.testing.assert_allclose(T1, J1, rtol=0, atol=1e-12)
    np.testing.assert_allclose(sb1, jsb1, rtol=0, atol=1e-12)


# ---------------------------------------------------------------------------
# triangulation
# ---------------------------------------------------------------------------

def test_triangulate_in_frames_matches():
    rng = np.random.default_rng(3)
    A, B = _rand_pose7(rng), _rand_pose7(rng)
    n = 64
    X = rng.normal(size=(n, 3)) * 3.0
    rays_a = tse3.apply7(tse3.inverse7(A), X)
    rays_b = tse3.apply7(tse3.inverse7(B), X) + rng.normal(size=(n, 3)) * 0.01
    rays_b[:8] = rays_a[:8] @ (tse3.quat_to_mat(B[3:]).T @ tse3.quat_to_mat(A[3:])).T  # parallel
    rays_a /= np.linalg.norm(rays_a, axis=1, keepdims=True)
    rays_b /= np.linalg.norm(rays_b, axis=1, keepdims=True)
    jout = jtri.triangulate_in_frames(JT(r=jnp.asarray(A[:3]), q=jnp.asarray(A[3:])),
                                      JT(r=jnp.asarray(B[:3]), q=jnp.asarray(B[3:])),
                                      jnp.asarray(rays_a), jnp.asarray(rays_b))
    t = lambda x: torch.tensor(x)  # noqa: E731
    tout = ttri.triangulate_in_frames(TT(r=t(A[:3]), q=t(A[3:])), TT(r=t(B[:3]), q=t(B[3:])),
                                      t(rays_a), t(rays_b))
    hp_j, valid_j, par_j = (np.asarray(x) for x in jout)
    hp_t, valid_t, par_t = (x.numpy() for x in tout)
    assert par_t[:8].all() and not par_t[8:].all()
    np.testing.assert_array_equal(par_t, par_j)
    np.testing.assert_array_equal(valid_t, valid_j)
    np.testing.assert_allclose(hp_t, hp_j, rtol=0, atol=1e-12)


# ---------------------------------------------------------------------------
# P3P
# ---------------------------------------------------------------------------

def _random_pose(rng):
    """test_p3p's pose draw, step for step."""
    axis = rng.normal(size=3)
    axis /= np.linalg.norm(axis)
    ang = rng.uniform(0.1, 2.0)
    q = np.concatenate([axis * np.sin(ang / 2), [np.cos(ang / 2)]])
    R = np.asarray(jso3.quat_to_matrix(jnp.asarray(q)))
    return q, R, rng.normal(size=3)


def test_p3p_lambda_twist_matches_on_test_p3p_problems():
    rng = np.random.default_rng(0)
    Xs, ys, Rs_true, ts_true = [], [], [], []
    for _ in range(30):
        _, R, t = _random_pose(rng)
        Y = rng.uniform([-1, -1, 2], [1, 1, 6], size=(3, 3))
        X = (Y - t) @ R
        Xs.append(X)
        ys.append(Y / np.linalg.norm(Y, axis=1, keepdims=True))
        Rs_true.append(R)
        ts_true.append(t)
    Xs, ys = np.stack(Xs), np.stack(ys)
    jR, jt, jv = (np.asarray(x) for x in jax.vmap(jp3p.p3p_lambda_twist)(
        jnp.asarray(Xs), jnp.asarray(ys)))
    tR, tt, tv = (x.numpy() for x in tp3p.p3p_lambda_twist(torch.tensor(Xs), torch.tensor(ys)))
    assert tR.shape == (30, 4, 3, 3) and tt.shape == (30, 4, 3) and tv.shape == (30, 4)
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_allclose(tR[tv], jR[jv], rtol=0, atol=1e-9)
    np.testing.assert_allclose(tt[tv], jt[jv], rtol=0, atol=1e-9)
    # and the port recovers the truth as test_p3p asks (>= 28 of 30)
    n_ok = sum(
        min((np.linalg.norm(tR[i, k] - Rs_true[i]) + np.linalg.norm(tt[i, k] - ts_true[i])
             for k in range(4) if tv[i, k]), default=1.0) < 1e-5
        for i in range(30))
    assert n_ok >= 28


# ---------------------------------------------------------------------------
# rig RANSAC
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def rig_scene():
    """test_p3p's two-camera scene with 30 % planted outliers."""
    rng = np.random.default_rng(3)
    N = 256
    pts_W = rng.uniform(-5, 5, size=(N, 3))
    T_SC = np.zeros((2, 7))
    T_SC[:, 6] = 1.0
    T_SC[1, 0] = 0.11
    q, R_ws, t_ws = _random_pose(rng)
    cam_idx = rng.integers(0, 2, size=N)
    rays = np.zeros((N, 3))
    mask = np.zeros(N, bool)
    for i in range(N):
        p_C = R_ws.T @ (pts_W[i] - t_ws) - T_SC[cam_idx[i], :3]
        if p_C[2] > 0.5:
            rays[i] = p_C / np.linalg.norm(p_C)
            mask[i] = True
    is_outlier = np.zeros(N, bool)
    for i in range(N):
        if mask[i] and rng.random() < 0.3:
            v = rng.normal(size=3)
            rays[i] = v / np.linalg.norm(v)
            is_outlier[i] = True
    return dict(pts_W=pts_W, rays=rays, cam_idx=cam_idx, mask=mask, T_SC=T_SC, q=q, t_ws=t_ws,
                is_outlier=is_outlier)


def _jax_indices(key, mask, cam_idx, n_hyp, NC):
    """p3p.py:255-263: the JAX package's hypothesis draws for ``key``."""
    keys = jax.random.split(key, n_hyp)
    cam_of_hyp = jnp.arange(n_hyp, dtype=jnp.int32) % NC

    def sample_one(k, cam):
        w = (mask & (cam_idx == cam)).astype(jnp.float64)
        g = jax.random.gumbel(k, (mask.shape[0],)) + jnp.log(w + 1e-30)
        return jax.lax.top_k(g, 3)[1]

    return np.asarray(jax.vmap(sample_one)(keys, cam_of_hyp))


def _jax_scores(idx, s, threshold_deg=0.6):
    """Score vector of the JAX package's P3P solutions for ``idx``
    (p3p.py:279-299, the scoring in numpy)."""
    H, NC = idx.shape[0], s["T_SC"].shape[0]
    R, t, valid = (np.asarray(x) for x in jax.vmap(jp3p.p3p_lambda_twist)(
        jnp.asarray(s["pts_W"][idx]), jnp.asarray(s["rays"][idx])))
    cam = np.arange(H) % NC
    R_sc = np.stack([jse3.quat_to_mat(s["T_SC"][c, 3:]) for c in range(NC)])
    Rs = np.einsum("hij,hkjl->hkil", R_sc[cam], R).reshape(H * 4, 3, 3)
    ts = (np.einsum("hij,hkj->hki", R_sc[cam], t) + s["T_SC"][cam, None, :3]).reshape(H * 4, 3)
    R_cs = R_sc.transpose(0, 2, 1)
    t_cs = -np.einsum("cij,cj->ci", R_cs, s["T_SC"][:, :3])
    p_S = np.einsum("hij,nj->hni", Rs, s["pts_W"]) + ts[:, None]
    p_C = np.einsum("nij,hnj->hni", R_cs[s["cam_idx"]], p_S) + t_cs[s["cam_idx"]][None]
    p_n = p_C / (np.linalg.norm(p_C, axis=-1, keepdims=True) + 1e-12)
    inl = (np.einsum("hni,ni->hn", p_n, s["rays"]) > np.cos(np.deg2rad(threshold_deg)))
    inl &= s["mask"][None]
    return np.where(valid.reshape(-1), inl.sum(1), -1)


def test_ransac_from_jax_samples_matches(rig_scene):
    s = rig_scene
    key = jax.random.PRNGKey(1)
    n_hyp = 128
    idx = _jax_indices(key, jnp.asarray(s["mask"]), jnp.asarray(s["cam_idx"], jnp.int32),
                       n_hyp, 2)
    jres = jp3p.ransac_rig_pose(key, jnp.asarray(s["pts_W"]), jnp.asarray(s["rays"]),
                                jnp.asarray(s["cam_idx"], jnp.int32), jnp.asarray(s["mask"]),
                                jnp.asarray(s["T_SC"]))
    t = torch.tensor
    tres = tp3p.ransac_rig_pose_from_samples(
        t(idx, dtype=torch.long), t(s["pts_W"]), t(s["rays"]), t(s["cam_idx"]), t(s["mask"]),
        t(s["T_SC"]))
    j_scores = _jax_scores(idx, s)
    np.testing.assert_array_equal(tres["scores"].numpy(), j_scores)
    assert int(tres["best"]) == int(np.argmax(j_scores))
    assert int(tres["num_inliers"]) == int(jres["num_inliers"])
    assert bool(tres["ok"]) == bool(jres["ok"]) is True
    np.testing.assert_array_equal(tres["inliers"].numpy(), np.asarray(jres["inliers"]))
    np.testing.assert_allclose(tres["T_WS"].r.numpy(), np.asarray(jres["T_WS"].r), rtol=0,
                               atol=1e-8)
    np.testing.assert_allclose(tres["T_WS"].q.numpy(), np.asarray(jres["T_WS"].q), rtol=0,
                               atol=1e-8)


def test_ransac_own_sampler_rejects_outliers_across_cameras(rig_scene):
    """The port's Gumbel sampler, held to test_p3p's outcome bars."""
    s = rig_scene
    gen = torch.Generator().manual_seed(1)
    t = torch.tensor
    res = tp3p.ransac_rig_pose(gen, t(s["pts_W"]), t(s["rays"]), t(s["cam_idx"]),
                               t(s["mask"]), t(s["T_SC"]))
    assert bool(res["ok"])
    assert np.linalg.norm(res["T_WS"].r.numpy() - s["t_ws"]) < 0.05
    qe = res["T_WS"].q.numpy()
    assert min(np.linalg.norm(qe - s["q"]), np.linalg.norm(qe + s["q"])) < 0.01
    inl = res["inliers"].numpy()
    assert not np.any(inl & s["is_outlier"])
    assert inl[s["mask"] & ~s["is_outlier"]].mean() > 0.9
    assert len(set(s["cam_idx"][inl])) == 2


def test_sample_hypotheses_draws_from_one_camera():
    rng = np.random.default_rng(5)
    mask = torch.tensor(rng.random(200) < 0.5)
    cam_idx = torch.tensor(rng.integers(0, 3, 200))
    idx = tp3p.sample_hypotheses(torch.Generator().manual_seed(0), mask, cam_idx, 30, 3)
    assert idx.shape == (30, 3)
    for h in range(30):
        assert len(set(idx[h].tolist())) == 3
        assert mask[idx[h]].all() and (cam_idx[idx[h]] == h % 3).all()
