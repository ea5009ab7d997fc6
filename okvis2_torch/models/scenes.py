"""The 2-D sky/person proxy scenes the synthetic Fast-SCNN weights were
trained on.

A copy of ``okvis2_tpu/models/train_synthetic.py::make_scene`` (numpy
only): the same ``rng`` calls in the same order give the same scene.
Labels follow the cityscapes ids the suppression gate reads: SKY (10)
above a horizon, PERSON (11) as dark upright blobs, "building" (2)
elsewhere.
"""

from __future__ import annotations

import numpy as np


def make_scene(rng, H=192, W=320):
    """Returns (image [H,W,3] float32 in [0,1], labels [H,W] int32)."""
    img = np.zeros((H, W), np.float32)
    lab = np.full((H, W), 2, np.int32)  # "building"
    horizon = int(rng.uniform(0.2, 0.6) * H)
    # sky: bright smooth vertical gradient + slow horizontal waves
    yy = np.arange(horizon)[:, None] / max(horizon, 1)
    xx = np.arange(W)[None, :] / W
    sky = 0.75 + 0.2 * (1 - yy) + 0.05 * np.sin(
        2 * np.pi * (xx * rng.uniform(0.5, 2.0) + rng.uniform()))
    img[:horizon] = sky
    lab[:horizon] = 10  # SKY
    # ground/structures: textured blocks
    n_blocks = rng.integers(10, 25)
    for _ in range(n_blocks):
        bw = int(rng.uniform(10, 60))
        bh = int(rng.uniform(10, 50))
        x0 = rng.integers(0, max(W - bw, 1))
        y0 = rng.integers(horizon, max(H - bh, horizon + 1))
        img[y0:y0 + bh, x0:x0 + bw] = rng.uniform(0.2, 0.6) + \
            0.1 * rng.standard_normal((min(bh, H - y0), min(bw, W - x0)))
    # persons: dark upright ellipses with a head blob, can straddle horizon
    for _ in range(rng.integers(0, 4)):
        ph = int(rng.uniform(30, 70))
        pw = max(int(ph * rng.uniform(0.25, 0.4)), 6)
        cx = rng.integers(pw, W - pw)
        cy = rng.integers(max(horizon - ph // 4, ph), H - ph // 2)
        y, x = np.ogrid[:H, :W]
        body = ((x - cx) / (pw / 2)) ** 2 + ((y - cy) / (ph / 2)) ** 2 <= 1
        head_r = pw // 2
        head = ((x - cx) ** 2 + (y - (cy - ph // 2 - head_r)) ** 2 <= head_r ** 2)
        m = body | head
        img[m] = rng.uniform(0.02, 0.15)
        lab[m] = 11  # PERSON
    img = np.clip(img + 0.02 * rng.standard_normal((H, W)), 0, 1)
    return np.stack([img] * 3, axis=-1).astype(np.float32), lab
