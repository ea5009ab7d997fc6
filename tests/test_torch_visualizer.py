"""The port's debug renderers (``okvis2_torch/pipeline/visualizer.py``)
against the JAX package's, byte for byte, on the CPU (this machine has
cv2):

- ``draw_keypoints``, ``draw_matches`` and ``draw_top_view`` on the same
  seeded inputs, given to the port as numpy arrays and as tensors;
- ``draw_overhead_image`` on the same records: a minimal estimator
  stand-in (``state_order``, ``states[s].pose`` / ``is_keyframe``,
  ``landmarks[l].hp_W`` / ``initialised``, what the JAX function reads),
  and the port's estimator after a short synchronous drive at
  ``tests/test_torch_slam.py``'s sizes (6 frames at 192x128).
"""

import types

import numpy as np
import pytest
import torch

from okvis2_torch.pipeline import visualizer as tvis
from okvis2_tpu.pipeline import visualizer as jvis


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    h, w, n = 48, 64, 30
    return dict(img_a=rng.uniform(-0.1, 1.1, (h, w)), img_b=rng.uniform(0, 1, (h, w)),
                xy_a=rng.uniform(0, [w, h], (n, 2)), xy_b=rng.uniform(0, [w, h], (n, 2)),
                mask=rng.uniform(size=n) > 0.2, matched={int(i) for i in rng.integers(0, n, 10)},
                pairs=[(int(i), int(j)) for i, j in rng.integers(0, n, (12, 2))])


@pytest.mark.parametrize("as_tensor", [False, True])
def test_cv2_renderers_equal_jax(as_tensor):
    d = _inputs()
    t = (lambda a: torch.as_tensor(a)) if as_tensor else (lambda a: a)  # noqa: E731
    got = tvis.draw_keypoints(t(d["img_a"]), t(d["xy_a"]), t(d["mask"]), d["matched"])
    want = jvis.draw_keypoints(d["img_a"], d["xy_a"], d["mask"], d["matched"])
    assert got.dtype == want.dtype == np.uint8 and np.array_equal(got, want)
    got = tvis.draw_matches(t(d["img_a"]), t(d["xy_a"]), t(d["img_b"]), t(d["xy_b"]), d["pairs"])
    want = jvis.draw_matches(d["img_a"], d["xy_a"], d["img_b"], d["xy_b"], d["pairs"])
    assert np.array_equal(got, want)
    traj = [(0.1 * k, np.array([np.cos(k / 5), np.sin(k / 4), 0.1, 0, 0, 0, 1.0]))
            for k in range(20)]
    lms = np.random.default_rng(1).uniform(-2, 2, (50, 3))
    got = tvis.draw_top_view([(s, t(p)) for s, p in traj], t(lms), size=200)
    want = jvis.draw_top_view(traj, lms, size=200)
    assert np.array_equal(got, want) and np.array_equal(tvis.draw_top_view([]),
                                                        jvis.draw_top_view([]))


def _stand_in(seed=2, n_states=12, n_lm=200):
    rng = np.random.default_rng(seed)
    ns = types.SimpleNamespace
    states = {10 + s: ns(pose=np.concatenate([[s * 0.3, np.sin(s / 3), 0.2], [0, 0, 0, 1.0]]),
                         is_keyframe=bool(s % 4 == 0)) for s in range(n_states)}
    hp = np.concatenate([rng.uniform(-3, 5, (n_lm, 3)), rng.choice([1.0, 0.5, 1e-9], (n_lm, 1))],
                        axis=1)
    landmarks = {k: ns(hp_W=hp[k], initialised=bool(k % 7)) for k in range(n_lm)}
    return ns(state_order=list(states), states=states, landmarks=landmarks)


def test_overhead_image_equals_jax_on_records():
    est = _stand_in()
    got, want = tvis.draw_overhead_image(est), jvis.draw_overhead_image(est)
    assert got.dtype == want.dtype == np.float32 and np.array_equal(got, want)
    assert got.max() == 1.0
    small = tvis.draw_overhead_image(est, size=64, margin=0.25)
    assert np.array_equal(small, jvis.draw_overhead_image(est, size=64, margin=0.25))
    empty = types.SimpleNamespace(state_order=[], states={}, landmarks={})
    assert np.array_equal(tvis.draw_overhead_image(empty), jvis.draw_overhead_image(empty))


def test_overhead_image_after_a_drive():
    from okvis2_torch.pipeline.synthetic_run import run_synthetic_vio

    res = run_synthetic_vio(duration=1.5, frame_rate=4.0, width=192, height=128,
                            max_keypoints=128, dtype=torch.float64, device="cpu")
    est = res["slam"].estimator
    got, want = tvis.draw_overhead_image(est), jvis.draw_overhead_image(est)
    assert len(est.state_order) == 6 and len(est.landmarks) > 50
    assert np.array_equal(got, want) and got.max() == 1.0 and (got == 0.25).sum() > 0
