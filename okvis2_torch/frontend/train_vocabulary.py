"""Train a place-recognition vocabulary over many synthetic scenes.

Port of ``okvis2_tpu/frontend/train_vocabulary.py``. The reference ships a
general pretrained DBoW2 vocabulary (resources/small_voc.yml.gz) instead
of training online from the first scene, whose opening frames would bias
it. This script detects and describes keypoints over many diverse
synthetic scenes (textured worlds and star fields of varied density, seen
from varied viewpoints) with the port's renderers, detector and
descriptor, and k-majority-clusters the pooled descriptors into a binary
codebook (``BinaryVocabulary.train``).

    python -m okvis2_torch.frontend.train_vocabulary [out.npz]

runs on the CUDA card and writes to ``out.npz``, or to the port's
``resources/default_voc.npz``; ``main(out, device="cpu")`` runs on the CPU.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from okvis2_torch import resolve_device


def collect_descriptors(n_scenes: int = 24, per_scene: int = 512, seed0: int = 100,
                        textured_frac: float = 0.75, dtype=torch.float32,
                        device=None) -> np.ndarray:
    """Descriptor signs [N, 512] pooled over ``n_scenes`` scenes, each seen
    once by camera 0 of the 320x240 stereo rig: the first
    ``textured_frac`` of them textured worlds (noise-textured surfaces,
    occluders, exposure changes: real imagery's descriptor statistics), the
    rest star fields (sparse, high-contrast scenes). Scene parameters and
    viewpoints come from ``default_rng(0)`` in the JAX package's order."""
    from okvis2_torch.frontend.descriptor import describe_keypoints
    from okvis2_torch.frontend.detection import DetectionConfig, detect_keypoints
    from okvis2_torch.imu.preintegration import ImuParameters
    from okvis2_torch.pipeline.dataset import SyntheticDataset, TexturedWorldDataset
    from okvis2_torch.pipeline.synthetic_run import small_rig

    dev = resolve_device(device)
    cams, exts = small_rig(width=320, height=240, dtype=dtype, device=dev)
    imu = ImuParameters.create(g=9.81, device=dev)
    det_cfg = DetectionConfig(max_keypoints=per_scene)
    rng = np.random.default_rng(0)
    pool = []
    n_tex = int(round(n_scenes * textured_frac))
    for k in range(n_scenes):
        if k < n_tex:
            ds = TexturedWorldDataset(cams, exts, imu, seed=seed0 + k,
                                      exposure_amp=float(rng.uniform(0.0, 0.25)),
                                      n_occluders=int(rng.integers(1, 5)), device=dev)
        else:
            ds = SyntheticDataset(cams, exts, imu, seed=seed0 + k,
                                  n_stars=int(rng.integers(800, 5000)), device=dev)
        ang = rng.uniform(-0.3, 0.3)
        pose = np.array([rng.uniform(-0.5, 0.5), rng.uniform(-0.5, 0.5), rng.uniform(-0.2, 0.2),
                         0.0, np.sin(ang / 2), 0.0, np.cos(ang / 2)])
        img = torch.as_tensor(ds.render(pose)[0], dtype=dtype, device=dev)
        det = detect_keypoints(img, det_cfg)
        desc = describe_keypoints(img, det["xy"], det["size"], det["mask"])
        pool.append(desc["signs"].cpu().numpy()[det["mask"].cpu().numpy().astype(bool)])
    return np.concatenate(pool)


def main(out_path: str | None = None, n_words: int = 512, device=None, **collect_kw):
    """Train an ``n_words`` vocabulary and save it to ``out_path`` (None:
    the port's committed ``resources/default_voc.npz``); returns the path."""
    from okvis2_torch.frontend.bow import BinaryVocabulary

    out_path = out_path or os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "resources", "default_voc.npz")
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    signs = collect_descriptors(device=device, **collect_kw)
    print(f"training on {len(signs)} descriptors from diverse scenes")
    voc = BinaryVocabulary.train(signs, n_words=n_words, iters=10)
    voc.save(out_path)
    print(f"saved {n_words}-word vocabulary to {out_path}")
    return out_path


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("out", nargs="?", default=None)
    main(p.parse_args().out)
