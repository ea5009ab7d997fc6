"""Train Fast-SCNN on procedurally generated sky/person scenes.

Port of ``okvis2_tpu/models/train_synthetic.py``, with ``torch.optim.Adam``
in place of ``optax.adam`` (both: eps 1e-8 outside the square root). The
reference ships a cityscapes-trained Fast-SCNN; without that dataset the
same architecture is trained on a proxy whose labels are the two classes
the SLAM pipeline reads: SKY (10) above a horizon and PERSON (11) as dark
upright blobs, everything else "building" (2), half of the batch from the
2-D scenes (``make_scene``) and half from rendered views of the textured
world (``make_textured_pool``). The weights drive the CNN gate
(``models/suppression.py``) end to end.

- Batches are drawn with the JAX trainer's numpy ``default_rng(seed)``
  calls in its order, so both packages see the same scenes, augmentation
  and labels.
- The JAX step differentiates all of the model's variables: its forward
  runs BatchNorm on the running statistics (``train=False``) and Adam moves
  the statistics like any weight. ``trainable_model`` follows that: each
  BatchNorm becomes ``StatsTrainedBatchNorm``, eval-mode BatchNorm from
  plain ops whose weight, bias, running mean and running variance are all
  parameters. The serving model (``FastSCNN``, ``serving_model``) is not
  changed.
- ``train`` starts from Flax's initialisers (``init_variables``: LeCun
  normal kernels, zero biases), drawn from a generator seeded with
  ``seed``: the JAX trainer's starting distribution, not its values.
  PyTorch's default initialisers scale the kernels by 1/sqrt(3) of that,
  and through the statistics-normalised BatchNorms the network then
  trains visibly slower (2-D pixel accuracy 0.83 after 200 steps against
  the JAX run's 0.97).
- ``train`` runs on the card unless ``device`` says otherwise; it saves
  only where ``out_path`` says, never into the JAX package's weights.

Run: python -m okvis2_torch.models.train_synthetic <steps> <out.npz>
"""

from __future__ import annotations

import copy
import os
import sys
import time

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from okvis2_torch import resolve_device
from okvis2_torch.models.fast_scnn import FastSCNN, save_params, segment_image
from okvis2_torch.models.scenes import make_scene

__all__ = ["make_scene", "make_textured_pool", "trainable_model", "serving_model",
           "draw_batch", "train_step", "train"]

_JAX_PACKAGE = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "okvis2_tpu")


def make_textured_pool(n_scenes=8, views_per=3, seed=1, H=192, W=320, device=None):
    """Pre-rendered (image [H,W,3] float32, labels [H,W] int32) pairs from
    the textured world (``pipeline/dataset.py::TexturedWorldDataset``):
    noise-textured surfaces with true occlusion, a bright "sky" ceiling
    (10) and a dark "person" occluder (11), under exposure variation. No
    hit and background become "building" (2). Rendered on ``device``."""
    from okvis2_torch.cameras.distortion import RadialTangentialDistortion
    from okvis2_torch.cameras.pinhole import PinholeCamera
    from okvis2_torch.core.se3 import Transformation
    from okvis2_torch.imu.preintegration import ImuParameters
    from okvis2_torch.pipeline.dataset import TexturedWorldDataset

    device = resolve_device(device)
    cam = PinholeCamera.create(W, H, 170.0, 170.0, W / 2.0, H / 2.0,
                               RadialTangentialDistortion.from_params([0.0, 0.0, 0.0, 0.0]),
                               device=device)
    T0 = Transformation.identity(dtype=cam.focal.dtype, device=device)
    rng = np.random.default_rng(seed)
    pool = []
    for k in range(n_scenes):
        ds = TexturedWorldDataset(
            (cam,), [T0], ImuParameters.create(g=9.81, device=device), seed=seed + k,
            exposure_amp=float(rng.uniform(0.0, 0.25)), n_occluders=int(rng.integers(1, 4)),
            device=device)
        for _ in range(views_per):
            # viewpoints that keep the ceiling ("sky") and occluders in view
            ang = rng.uniform(-0.35, 0.1)  # pitch up a bit
            pose = np.array([rng.uniform(-1.5, 3.0), rng.uniform(-1.0, 2.0),
                             rng.uniform(-1.0, 2.0), np.sin(ang / 2), 0.0, 0.0, np.cos(ang / 2)])
            im, lab = ds.render_with_labels(pose)[0]
            lab = np.where(lab < 0, 2, lab)  # no hit -> "building"
            lab = np.where(lab == 0, 2, lab)  # background -> "building"
            pool.append((np.stack([im] * 3, axis=-1).astype(np.float32), lab.astype(np.int32)))
    return pool


class StatsTrainedBatchNorm(nn.Module):
    """Eval-mode BatchNorm from plain ops, with the running statistics as
    parameters: y = (x - mean) * (rsqrt(var + eps) * weight) + bias, in the
    order Flax's BatchNorm computes it. Its ``state_dict`` keys are
    ``nn.BatchNorm2d``'s (without ``num_batches_tracked``)."""

    def __init__(self, bn: nn.BatchNorm2d):
        super().__init__()
        self.eps = bn.eps
        for name in ("weight", "bias", "running_mean", "running_var"):
            setattr(self, name, nn.Parameter(getattr(bn, name).detach().clone()))

    def forward(self, x):
        mul = torch.rsqrt(self.running_var + self.eps) * self.weight
        return ((x - self.running_mean[:, None, None]) * mul[:, None, None]
                + self.bias[:, None, None])


def init_variables(model: nn.Module, seed: int) -> nn.Module:
    """Flax's initialisers, in place, from a generator seeded with ``seed``:
    conv kernels LeCun normal (a normal truncated at two standard
    deviations, scaled to variance 1/fan_in, as ``variance_scaling(1.0,
    "fan_in", "truncated_normal")``), conv biases zero; BatchNorms keep
    scale 1, bias 0, mean 0 and variance 1. Returns ``model``."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.Conv2d):
                std = (1.0 / m.weight[0].numel()) ** 0.5 / 0.87962566103423978
                w = torch.empty(m.weight.shape, dtype=torch.float64)
                nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=gen)
                m.weight.copy_(w)
                if m.bias is not None:
                    m.bias.zero_()
    return model


def trainable_model(model: FastSCNN) -> nn.Module:
    """A copy of ``model`` whose BatchNorms are ``StatsTrainedBatchNorm``:
    its ``parameters()`` are every variable the JAX step trains."""
    out = copy.deepcopy(model)
    for mod in list(out.modules()):
        for child, sub in list(mod.named_children()):
            if isinstance(sub, nn.BatchNorm2d):
                setattr(mod, child, StatsTrainedBatchNorm(sub))
    return out


def serving_model(trained: nn.Module) -> FastSCNN:
    """The ``FastSCNN`` (eval mode) holding ``trained``'s variables."""
    p = next(trained.parameters())
    model = FastSCNN().to(device=p.device, dtype=p.dtype)
    missing, unexpected = model.load_state_dict(
        {k: v.detach() for k, v in trained.state_dict().items()}, strict=False)
    if unexpected or any(not k.endswith("num_batches_tracked") for k in missing):
        raise KeyError(f"serving_model: missing {missing}, unexpected {unexpected}")
    return model.eval()


def draw_batch(rng, batch, tex_pool, textured_frac):
    """One batch as the JAX trainer draws it: per image, a photometrically
    augmented textured view with probability ``textured_frac`` (when the
    pool is not empty), else a fresh 2-D scene. Returns (images [B,H,W,3]
    float32, labels [B,H,W] int32) as numpy arrays."""
    imgs, labs = [], []
    for _ in range(batch):
        if tex_pool and rng.uniform() < textured_frac:
            im, lb = tex_pool[rng.integers(len(tex_pool))]
            im = np.clip(im * rng.uniform(0.85, 1.15)
                         + 0.02 * rng.standard_normal(im.shape).astype(np.float32), 0, 1)
        else:
            im, lb = make_scene(rng)
        imgs.append(im)
        labs.append(lb)
    return np.stack(imgs), np.stack(labs)


def train_step(model: nn.Module, opt: torch.optim.Optimizer, imgs: torch.Tensor,
               labs: torch.Tensor) -> torch.Tensor:
    """One Adam step of ``trainable_model``'s output on images [B,3,H,W] (H,
    W multiples of 64) and integer labels [B,H,W]: the mean softmax cross
    entropy of the logits, its gradients with respect to every parameter
    (the BatchNorm statistics included), and the update. Returns the loss
    (before the update) as a 0-d tensor on the model's device."""
    opt.zero_grad(set_to_none=True)
    loss = F.cross_entropy(model(imgs), labs.long())
    loss.backward()
    opt.step()
    return loss.detach()


def _to_device(imgs, labs, device):
    x = torch.as_tensor(imgs, device=device).permute(0, 3, 1, 2).contiguous()
    return x, torch.as_tensor(labs, device=device)


def _pixel_accuracy(model, pairs, device):
    return float(np.mean([
        (segment_image(model, torch.as_tensor(im, device=device)).cpu().numpy() == lb).mean()
        for im, lb in pairs]))


def train(steps=400, out_path=None, batch=4, seed=0, lr=1e-3, textured_frac=0.5, device=None):
    """Train a ``FastSCNN`` (``init_variables(..., seed)``) for ``steps``
    Adam steps on ``device`` (None: the card) and evaluate it as the JAX
    trainer does: pixel accuracy on 8 fresh 2-D scenes and on 2 x 2
    held-out textured views.
    Saves with ``save_params`` to ``out_path`` if given (never inside the
    JAX package). Returns (serving model, record) with the record's
    "losses" (every step's), "acc_2d", "acc_textured" and "step_ms" (the
    training loop's wall time per step, batch drawing included)."""
    if out_path is not None and os.path.abspath(out_path).startswith(_JAX_PACKAGE + os.sep):
        raise ValueError(f"train: {out_path} is inside the JAX package; give another path")
    device = resolve_device(device)
    model = trainable_model(init_variables(FastSCNN(), seed)).to(device)
    opt = torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8)
    rng = np.random.default_rng(seed)
    tex_pool = make_textured_pool(seed=seed + 1, device=device) if textured_frac > 0 else []
    print(f"textured pool: {len(tex_pool)} rendered views")
    losses = []
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    for it in range(steps):
        imgs, labs = _to_device(*draw_batch(rng, batch, tex_pool, textured_frac), device)
        losses.append(train_step(model, opt, imgs, labs))
        if it % 25 == 0:
            print(f"step {it}: loss {float(losses[-1]):.4f}")
    losses = torch.stack(losses).double().cpu().numpy() if losses else np.zeros(0)
    step_ms = (time.perf_counter() - t0) * 1e3 / max(steps, 1)
    served = serving_model(model)
    acc = _pixel_accuracy(served, [make_scene(rng) for _ in range(8)], device)
    acc_tex = float("nan")
    if tex_pool:
        acc_tex = _pixel_accuracy(
            served, make_textured_pool(n_scenes=2, views_per=2, seed=seed + 999, device=device),
            device)
    print(f"pixel accuracy: 2d {acc:.3f}  textured {acc_tex:.3f}")
    if out_path:
        save_params(out_path, served)
        print(f"saved {out_path}")
    return served, {"losses": losses, "acc_2d": acc, "acc_textured": acc_tex,
                    "step_ms": step_ms}


if __name__ == "__main__":
    if len(sys.argv) != 3:
        print(__doc__)
        raise SystemExit(1)
    out = sys.argv[2]
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    train(int(sys.argv[1]), out)
