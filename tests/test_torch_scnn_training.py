"""The port's Fast-SCNN trainer (``okvis2_torch/models/train_synthetic.py``)
against the JAX package's, on the CPU.

- One training step in float64 against the JAX step (restated from
  ``okvis2_tpu/models/train_synthetic.py:128-138``, where it is a closure
  inside ``train``) on the same variables (the JAX ``init_params`` carried
  across with ``interop.fast_scnn_state_dict_from_flax``, both sides in
  float64) and the same batch (2 x 64 x 128): the loss, the gradients of
  every parameter and batch statistic, and every Adam-updated leaf within
  1e-8 of each leaf's largest magnitude. The JAX step trains the BatchNorm
  statistics (its forward uses them, ``train=False``, and
  ``value_and_grad`` differentiates the whole variable dict), so the port's
  must too.
- ``make_textured_pool`` at 1 scene x 2 views (96x128) against the JAX pool:
  images within 1e-5, labels equal on at least 0.999 of the pixels.
- ``draw_batch`` draws what the JAX training loop draws from the same rng.
- The training model's BatchNorm (``StatsTrainedBatchNorm``) computes
  ``nn.BatchNorm2d``'s eval forward, and ``serving_model`` gives back a
  ``FastSCNN`` with the same variables: the serving forward is unchanged.
- ``train`` refuses to write inside the JAX package.

Training on the card (the float64 step card against CPU, ``train`` at full
width) is in ``tests/test_torch_kernels_cuda.py`` and ``chip_smoke.py``
phase 17.
"""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from okvis2_torch import interop
from okvis2_torch.models import fast_scnn as tfs
from okvis2_torch.models import train_synthetic as ttr
from okvis2_tpu.models import fast_scnn as jfs
from okvis2_tpu.models import train_synthetic as jtr

STEP_TOL, RENDER_TOL, LABEL_AGREE = 1e-8, 1e-5, 0.999
B, H, W, LR = 2, 64, 128, 1e-3


def _flat(tree) -> dict:
    return {"/".join(k): np.asarray(v) for k, v in flax.traverse_util.flatten_dict(tree).items()}


def _close(got: dict, want: dict, tag):
    assert got.keys() == want.keys(), tag
    worst = 0.0
    for k in want:
        scale = max(float(np.abs(want[k]).max()), 1e-300)
        err = float(np.abs(got[k] - want[k]).max()) / scale
        worst = max(worst, err)
        assert err <= STEP_TOL, (tag, k, err)
    return worst


@pytest.fixture(scope="module")
def step():
    """The JAX step and the port's on the same float64 variables and batch."""
    # init_params's seeded init, compiled (eager Flax init takes ~3x longer)
    variables = jax.jit(jfs.FastSCNN().init)(jax.random.PRNGKey(5), jnp.zeros((H, W, 3)))
    flat32 = _flat(variables)
    v64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), variables)
    rng = np.random.default_rng(0)
    imgs = rng.uniform(0, 1, (B, H, W, 3))
    labs = rng.choice(np.array([2, 10, 11], np.int32), (B, H, W))
    model, tx = jfs.FastSCNN(), optax.adam(LR)

    @jax.jit
    def jstep(params, opt_state, imgs, labs):
        def loss_fn(p):
            logits = model.apply(p, imgs)
            return optax.softmax_cross_entropy_with_integer_labels(logits, labs).mean()

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = tx.update(grads, opt_state)
        return optax.apply_updates(params, updates), opt_state, loss, grads

    new, _, jloss, jgrads = jstep(v64, tx.init(v64), jnp.asarray(imgs), jnp.asarray(labs))

    tmodel = tfs.FastSCNN()
    tmodel.load_state_dict(interop.fast_scnn_state_dict_from_flax(flat32))
    trained = ttr.trainable_model(tmodel.double())
    opt = torch.optim.Adam(trained.parameters(), lr=LR, eps=1e-8)
    x = torch.from_numpy(imgs).permute(0, 3, 1, 2).contiguous()
    loss = ttr.train_step(trained, opt, x, torch.from_numpy(labs))
    grads = interop.fast_scnn_flax_from_state_dict(
        {n: p.grad for n, p in trained.named_parameters()})
    return dict(jloss=float(jloss), jgrads=_flat(jgrads), jnew=_flat(new), loss=float(loss),
                grads=grads, new=interop.fast_scnn_flax_from_state_dict(trained.state_dict()),
                before=flat32)


def test_step_loss_and_gradients_match_jax(step):
    assert abs(step["loss"] - step["jloss"]) <= STEP_TOL * abs(step["jloss"])
    worst = _close(step["grads"], step["jgrads"], "gradients")
    print(f"loss {step['loss']:.12f} (JAX {step['jloss']:.12f}); gradients within {worst:.2e}")
    # the statistics are trained: their gradients are not zero
    stats = [k for k in step["grads"] if k.startswith("batch_stats/")]
    assert len(stats) == 2 * sum(1 for k in step["grads"] if k.endswith("/scale"))
    assert all(np.abs(step["grads"][k]).max() > 0 for k in stats)


def test_step_updated_leaves_match_jax(step):
    worst = _close(step["new"], step["jnew"], "updated leaves")
    print(f"updated leaves within {worst:.2e}")
    k = "batch_stats/ltd_conv/bn/mean"
    assert not np.array_equal(step["new"][k], step["before"][k])


def test_textured_pool_matches_jax():
    got = ttr.make_textured_pool(n_scenes=1, views_per=2, seed=1, H=96, W=128, device="cpu")
    want = jtr.make_textured_pool(n_scenes=1, views_per=2, seed=1, H=96, W=128)
    assert len(got) == len(want) == 2
    for (im_t, lab_t), (im_j, lab_j) in zip(got, want):
        assert im_t.dtype == np.float32 and im_t.shape == (96, 128, 3)
        np.testing.assert_allclose(im_t, np.asarray(im_j), rtol=0, atol=RENDER_TOL)
        assert (lab_t == np.asarray(lab_j)).mean() >= LABEL_AGREE


def test_draw_batch_follows_jax_loop():
    pool = [(np.full((192, 320, 3), 0.5, np.float32), np.full((192, 320), 10, np.int32))]
    r_port, r_jax = np.random.default_rng(7), np.random.default_rng(7)
    for _ in range(3):
        imgs, labs = ttr.draw_batch(r_port, 4, pool, 0.5)
        # train_synthetic.py:140-157, as the JAX loop draws a batch
        want_i, want_l = [], []
        for _ in range(4):
            if pool and r_jax.uniform() < 0.5:
                im, lb = pool[r_jax.integers(len(pool))]
                im = np.clip(im * r_jax.uniform(0.85, 1.15)
                             + 0.02 * r_jax.standard_normal(im.shape).astype(np.float32), 0, 1)
            else:
                im, lb = jtr.make_scene(r_jax)
            want_i.append(im)
            want_l.append(lb)
        assert np.array_equal(imgs, np.stack(want_i)) and np.array_equal(labs, np.stack(want_l))


def test_serving_forward_unchanged():
    torch.manual_seed(1)
    model = tfs.FastSCNN().double().eval()
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.normal_(0.0, 0.1)
                m.running_var.uniform_(0.5, 1.5)
    trained = ttr.trainable_model(model)
    x = torch.rand(1, 3, 64, 64, dtype=torch.float64)
    with torch.no_grad():
        a, b = model(x), trained(x)
    assert float((a - b).abs().max()) <= 1e-12 * float(a.abs().max())
    served = ttr.serving_model(trained)
    assert type(served) is tfs.FastSCNN and not served.training
    for k, v in model.state_dict().items():
        assert torch.equal(served.state_dict()[k], v), k


def test_train_refuses_the_jax_weights(tmp_path):
    with pytest.raises(ValueError):
        ttr.train(0, out_path=jtr.__file__.replace("train_synthetic.py", "weights/x.npz"),
                  device="cpu")


def test_init_variables_follow_flax(step):
    """``init_variables`` draws the JAX init's distribution: each conv
    kernel's spread within 10 % of the Flax kernel's (those of 1,000 or more
    weights), no weight beyond two standard deviations, biases zero."""
    model = ttr.init_variables(tfs.FastSCNN(), seed=0)
    flat = interop.fast_scnn_flax_from_state_dict(model.state_dict())
    kernels = [k for k in flat if k.endswith("/kernel")]
    assert kernels and flat.keys() == step["before"].keys()
    for k in kernels:
        w, want = flat[k], step["before"][k]
        fan_in = int(np.prod(w.shape[:-1]))
        assert np.abs(w).max() <= 2.0 / 0.87962566103423978 / np.sqrt(fan_in) * (1 + 1e-6), k
        if w.size >= 1000:
            assert abs(w.std() / want.std() - 1) < 0.1, (k, w.std(), want.std())
    for k in flat:
        if k.startswith("params/") and k.endswith("/bias") and k.replace("/bias", "/kernel") in flat:
            assert not flat[k].any(), k
