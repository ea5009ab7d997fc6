"""The port's DLT / rotation-only / 8-point RANSAC, MultiFrame and
vocabulary training against the JAX package, on the CPU in float64.

- The three RANSAC scenarios of ``tests/test_frontend.py:145-215`` (30 %
  outliers for the absolute pose, 10 of 60 for the rotation, 20 of 120 for
  the relative pose), with the JAX package's draws (``_sample_indices`` of
  its keys) injected into the ``*_from_samples`` halves: poses, rotations
  and essential matrices within 1e-9, inlier masks and counts equal, and
  ``decompose_essential`` within 1e-9. The port's own draws
  (``torch.Generator``) meet ``test_frontend.py``'s bars.
- ``MultiFrame`` / ``Frame`` accessors and back-projection against the JAX
  classes on the same frontend records.
- ``collect_descriptors`` on two scenes (one textured world, one star
  field), compared as sets of descriptor rows (the top-k tie trap of
  ROADMAP C), and ``BinaryVocabulary.train`` on the same pooled signs:
  words and idf equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from okvis2_torch.cameras import multiframe as tmf
from okvis2_torch.cameras.distortion import RadialTangentialDistortion as TRad
from okvis2_torch.cameras.pinhole import PinholeCamera as TCam
from okvis2_torch.frontend import bow as tbow
from okvis2_torch.frontend import ransac as tr
from okvis2_torch.frontend import train_vocabulary as ttv
from okvis2_tpu.cameras import multiframe as jmf
from okvis2_tpu.cameras.distortion import RadialTangentialDistortion as JRad
from okvis2_tpu.cameras.pinhole import PinholeCamera as JCam
from okvis2_tpu.core import so3
from okvis2_tpu.core.se3 import Transformation
from okvis2_tpu.frontend import bow as jbow
from okvis2_tpu.frontend import ransac as jr
from okvis2_tpu.frontend import train_vocabulary as jtv

TOL = 1e-9


def _t(x):
    return torch.tensor(np.asarray(x), dtype=torch.float64)


def _draws(key, n_hyp, k, mask):
    w = jnp.asarray(mask).astype(jnp.float64)
    idx = jr._sample_indices(key, n_hyp, k, w.shape[0], w)
    return torch.tensor(np.asarray(idx), dtype=torch.long)


def _absolute_scene():
    rng = np.random.default_rng(7)
    N = 100
    pts_W = rng.uniform(-3, 3, (N, 3)) + np.array([0, 0, 6.0])
    q_true = so3.delta_q(jnp.asarray([0.1, -0.2, 0.15]))
    t_true = jnp.asarray([0.4, -0.3, 0.2])
    p_C = jax.vmap(Transformation(r=t_true, q=q_true).apply)(jnp.asarray(pts_W))
    rays = np.array(p_C / jnp.linalg.norm(p_C, axis=-1, keepdims=True))
    out_idx = rng.choice(N, 30, replace=False)
    bad = rng.normal(0, 1, (30, 3))
    rays[out_idx] = bad / np.linalg.norm(bad, axis=-1, keepdims=True)
    return pts_W, rays, np.ones(N, bool), out_idx, np.asarray(t_true), np.asarray(q_true)


def _quat_angle(q1, q2):
    return 2 * np.arccos(min(1.0, abs(float(np.dot(q1, q2)))))


def test_absolute_pose_with_jax_draws():
    pts, rays, mask, out_idx, t_true, q_true = _absolute_scene()
    key = jax.random.PRNGKey(0)
    j = jr.ransac_absolute_pose(key, jnp.asarray(pts), jnp.asarray(rays), jnp.asarray(mask))
    t = tr.ransac_absolute_pose_from_samples(_draws(key, 256, 6, mask), _t(pts), _t(rays),
                                             torch.tensor(mask))
    np.testing.assert_allclose(t["T_CW"].r.numpy(), np.asarray(j["T_CW"].r), rtol=0, atol=TOL)
    np.testing.assert_allclose(t["T_CW"].C.numpy(), np.asarray(j["T_CW"].C), rtol=0, atol=TOL)
    np.testing.assert_array_equal(t["inliers"].numpy(), np.asarray(j["inliers"]))
    assert int(t["num_inliers"]) == int(j["num_inliers"]) >= 60 and bool(t["ok"])


def test_absolute_pose_own_draws():
    pts, rays, mask, out_idx, t_true, q_true = _absolute_scene()
    g = torch.Generator().manual_seed(0)
    t = tr.ransac_absolute_pose(g, _t(pts), _t(rays), torch.tensor(mask))
    inl = t["inliers"].numpy()
    assert bool(t["ok"]) and inl.sum() >= 60 and inl[out_idx].mean() < 0.1
    np.testing.assert_allclose(t["T_CW"].r.numpy(), t_true, atol=1e-3)
    assert _quat_angle(t["T_CW"].q.numpy(), q_true) < 1e-3


def _rotation_scene():
    rng = np.random.default_rng(8)
    d1 = rng.normal(0, 1, (60, 3))
    d1 /= np.linalg.norm(d1, axis=-1, keepdims=True)
    R = np.asarray(so3.quat_to_matrix(so3.delta_q(jnp.asarray([0.2, 0.1, -0.3]))))
    d2 = d1 @ R.T
    d2[:10] = rng.normal(0, 1, (10, 3))
    d2[:10] /= np.linalg.norm(d2[:10], axis=-1, keepdims=True)
    return d1, d2, np.ones(60, bool), R


def test_rotation_only_with_jax_draws():
    d1, d2, mask, R = _rotation_scene()
    key = jax.random.PRNGKey(1)
    j = jr.ransac_rotation_only(key, jnp.asarray(d1), jnp.asarray(d2), jnp.asarray(mask))
    t = tr.ransac_rotation_only_from_samples(_draws(key, 128, 2, mask), _t(d1), _t(d2),
                                             torch.tensor(mask))
    np.testing.assert_allclose(t["R_BA"].numpy(), np.asarray(j["R_BA"]), rtol=0, atol=TOL)
    np.testing.assert_array_equal(t["inliers"].numpy(), np.asarray(j["inliers"]))
    assert int(t["num_inliers"]) == int(j["num_inliers"]) >= 45
    g = torch.Generator().manual_seed(1)
    own = tr.ransac_rotation_only(g, _t(d1), _t(d2), torch.tensor(mask))
    assert int(own["num_inliers"]) >= 45
    np.testing.assert_allclose(own["R_BA"].numpy(), R, atol=1e-6)


def _relative_scene():
    rng = np.random.default_rng(9)
    pts = rng.uniform(-2, 2, (120, 3)) + np.array([0, 0, 5.0])
    R = np.asarray(so3.quat_to_matrix(so3.delta_q(jnp.asarray([0.05, -0.1, 0.02]))))
    t_BA = np.array([0.5, 0.1, -0.05])
    rays_A = pts / np.linalg.norm(pts, axis=-1, keepdims=True)
    pts_B = pts @ R.T + t_BA
    rays_B = pts_B / np.linalg.norm(pts_B, axis=-1, keepdims=True)
    rays_B[:20] = rng.normal(0, 1, (20, 3))
    rays_B[:20] /= np.linalg.norm(rays_B[:20], axis=-1, keepdims=True)
    return rays_A, rays_B, np.ones(120, bool), R, t_BA


def test_relative_pose_and_decompose_with_jax_draws():
    a, b, mask, R, t_BA = _relative_scene()
    key = jax.random.PRNGKey(2)
    j = jr.ransac_relative_pose(key, jnp.asarray(a), jnp.asarray(b), jnp.asarray(mask))
    t = tr.ransac_relative_pose_from_samples(_draws(key, 256, 8, mask), _t(a), _t(b),
                                             torch.tensor(mask))
    np.testing.assert_allclose(t["E"].numpy(), np.asarray(j["E"]), rtol=0, atol=TOL)
    np.testing.assert_array_equal(t["inliers"].numpy(), np.asarray(j["inliers"]))
    assert int(t["num_inliers"]) == int(j["num_inliers"]) >= 80
    good = int(np.argmax(np.asarray(j["inliers"])))
    Rj, tj = jr.decompose_essential(j["E"], jnp.asarray(a[good]), jnp.asarray(b[good]))
    Rt, tt = tr.decompose_essential(t["E"], _t(a[good]), _t(b[good]))
    np.testing.assert_allclose(Rt.numpy(), np.asarray(Rj), rtol=0, atol=TOL)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), rtol=0, atol=TOL)
    np.testing.assert_allclose(Rt.numpy(), R, atol=1e-6)
    assert float(np.dot(tt.numpy() / np.linalg.norm(tt.numpy()), t_BA / np.linalg.norm(t_BA))) > 0.99


def test_relative_pose_own_draws():
    a, b, mask, R, t_BA = _relative_scene()
    g = torch.Generator().manual_seed(2)
    t = tr.ransac_relative_pose(g, _t(a), _t(b), torch.tensor(mask))
    assert int(t["num_inliers"]) >= 80
    good = int(np.argmax(t["inliers"].numpy()))
    _, tt = tr.decompose_essential(t["E"], _t(a[good]), _t(b[good]))
    t_dir = tt.numpy() / np.linalg.norm(tt.numpy())
    assert abs(float(np.dot(t_dir, t_BA / np.linalg.norm(t_BA)))) > 0.99


def test_sample_indices_distinct_and_masked():
    g = torch.Generator().manual_seed(3)
    mask = torch.zeros(50, dtype=torch.bool)
    mask[::3] = True
    idx = tr.sample_indices(g, 64, 6, mask.double())
    assert idx.shape == (64, 6)
    assert mask[idx].all()
    assert all(len(set(r.tolist())) == 6 for r in idx)


def test_multiframe_accessors():
    rng = np.random.default_rng(0)
    jcam = JCam.create(320, 240, 250.0, 250.0, 160.0, 120.0,
                       JRad.from_params([-0.05, 0.01, 0.001, -0.002]))
    tcam = TCam.create(320, 240, 250.0, 250.0, 160.0, 120.0,
                       TRad.from_params([-0.05, 0.01, 0.001, -0.002]), device="cpu")
    data = []
    for _ in range(2):
        n = 12
        data.append({"xy": rng.uniform(10, 230, (n, 2)), "size": rng.uniform(8, 20, n),
                     "mask": rng.uniform(size=n) > 0.3, "signs": rng.choice([-1.0, 1.0], (n, 512)),
                     "packed": rng.integers(0, 2**32, (n, 16), dtype=np.uint32)})
    imgs = [np.zeros((240, 320), np.float32)] * 2
    j = jmf.MultiFrame(1.25, imgs, [jcam, jcam], data)
    t = tmf.MultiFrame(1.25, imgs, [tcam, tcam], data)
    t2 = tmf.MultiFrame(1.5, imgs, [tcam, tcam])
    assert t2.id == t.id + 1 and t2.num_keypoints() == 0
    assert (t.timestamp, t.num_frames, t.num_keypoints()) == (j.timestamp, j.num_frames,
                                                                j.num_keypoints())
    for c in range(2):
        fj, ft = j.frame(c), t.frame(c)
        assert ft.num_keypoints == fj.num_keypoints
        for k in range(12):
            np.testing.assert_array_equal(t.keypoint(c, k), j.keypoint(c, k))
            np.testing.assert_array_equal(t.descriptor(c, k), j.descriptor(c, k))
            np.testing.assert_array_equal(ft.descriptor_signs(k), fj.descriptor_signs(k))
            assert ft.keypoint_size(k) == fj.keypoint_size(k)
            np.testing.assert_allclose(ft.back_project(k), fj.back_project(k), rtol=0, atol=1e-12)
        t.set_landmark_id(c, 3, 77)
        j.set_landmark_id(c, 3, 77)
        assert t.landmark_id(c, 3) == j.landmark_id(c, 3) == 77
        assert t.landmark_id(c, 4) == j.landmark_id(c, 4) == -1


@pytest.fixture(scope="module")
def pooled():
    kw = dict(n_scenes=2, per_scene=256, textured_frac=0.5)
    return jtv.collect_descriptors(**kw), ttv.collect_descriptors(device="cpu", **kw)


def test_collect_descriptors_matches(pooled):
    j, t = pooled
    assert t.shape == j.shape and t.shape[0] > 300
    rows_j = {tuple(r) for r in j.astype(np.int8)}
    rows_t = {tuple(r) for r in t.astype(np.int8)}
    # descriptor bits that tie to rounding (ROADMAP C) may flip a few rows
    assert len(rows_t & rows_j) >= 0.99 * len(rows_j)


def test_vocabulary_training_matches(pooled, tmp_path):
    _, signs = pooled
    vj = jbow.BinaryVocabulary.train(signs, n_words=32, iters=10)
    vt = tbow.BinaryVocabulary.train(signs, n_words=32, iters=10)
    np.testing.assert_array_equal(vt.centroid_signs, vj.centroid_signs)
    np.testing.assert_allclose(vt.idf, vj.idf, rtol=0, atol=1e-6)
    path = ttv.main(str(tmp_path / "voc.npz"), n_words=16, device="cpu", n_scenes=2,
                    per_scene=64)
    assert tbow.BinaryVocabulary.load(path).n_words == 16
