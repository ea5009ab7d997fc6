"""Parity of the port's Harris detection (okvis2_torch.frontend.detection
and the plain version in ops/harris_cuda.py) with the JAX package on the
CPU in float64 (the CUDA kernel against its plain version on the card is
in test_torch_kernels_cuda.py).

The JAX side runs Harris through its XLA path (the Pallas kernel is
opt-in and TPU-only). Tolerances: the response and NMS maps 1e-12 absolute
over the whole map (both wrap cyclically at the borders); detection gives
the same keypoint SET (top-k tie order may differ between lax.top_k and
torch.topk) with xy within 1e-9.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from okvis2_torch.frontend import detection as tdet
from okvis2_torch.ops import harris_cuda
from okvis2_torch.utils.synthetic import textured_stereo_pair
from okvis2_tpu.frontend import detection as jdet

CONFIGS = {
    "default": dict(max_keypoints=128),
    "two_octaves_fine_grid": dict(max_keypoints=96, octaves=2, cell_size=16, per_cell=4),
}


@pytest.fixture(scope="module")
def images():
    return textured_stereo_pair(128, 192, seed=3)


@pytest.mark.parametrize("shape", ["textured", (1, 37, 53), (1, 2, 40), (2, 20, 3), (1, 12, 94)],
                         ids=str)
def test_harris_nms_plain_matches_reference(images, shape):
    """The plain version is the CUDA kernel's oracle, so it is held against
    the JAX XLA path at the kernel test's odd shapes too: ragged, H or
    W <= 3 (the halo wraps onto itself) and W = 94 (the fourth octave)."""
    if shape != "textured":
        images = np.random.default_rng(4).random(shape)
    resp_j, nms_j = jdet.harris_nms(jnp.asarray(images))
    resp_t, nms_t = tdet.harris_nms(torch.tensor(images))
    np.testing.assert_allclose(resp_t.numpy(), np.asarray(resp_j), rtol=0, atol=1e-12)
    fin_j = np.isfinite(np.asarray(nms_j))
    assert (np.isfinite(nms_t.numpy()) == fin_j).all()
    np.testing.assert_allclose(nms_t.numpy()[fin_j], np.asarray(nms_j)[fin_j], rtol=0, atol=1e-12)


def test_harris_nms_single_image(images):
    resp_t, nms_t = tdet.harris_nms(torch.tensor(images[0]))
    resp_b, nms_b = tdet.harris_nms(torch.tensor(images[:1]))
    assert resp_t.shape == images.shape[1:]
    assert torch.equal(resp_t, resp_b[0]) and torch.equal(nms_t, nms_b[0])


def test_subpixel_offsets(images):
    resp = np.asarray(jdet.harris_response(jnp.asarray(images[0])))
    dx_j, dy_j = jdet._subpixel_offsets(jnp.asarray(resp))
    dx_t, dy_t = tdet._subpixel_offsets(torch.tensor(resp))
    np.testing.assert_allclose(dx_t.numpy(), np.asarray(dx_j), rtol=0, atol=1e-12)
    np.testing.assert_allclose(dy_t.numpy(), np.asarray(dy_j), rtol=0, atol=1e-12)


def _valid_sorted(xy, mask):
    v = xy[mask]
    return v[np.lexsort((v[:, 1], v[:, 0]))]


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_detect_keypoints_batch(images, name):
    kw = CONFIGS[name]
    out_j = jdet.detect_keypoints_batch(jnp.asarray(images), jdet.DetectionConfig(**kw))
    out_t = tdet.detect_keypoints_batch(torch.tensor(images), tdet.DetectionConfig(**kw))
    for k in ("xy", "score", "octave", "size", "mask"):
        assert out_t[k].shape == out_j[k].shape, k
    for c in range(images.shape[0]):
        mj = np.asarray(out_j["mask"][c])
        mt = out_t["mask"][c].numpy()
        assert mj.sum() == mt.sum() > 20
        np.testing.assert_allclose(
            _valid_sorted(out_t["xy"][c].numpy(), mt),
            _valid_sorted(np.asarray(out_j["xy"][c]), mj), rtol=0, atol=1e-9)
        np.testing.assert_allclose(
            np.sort(out_t["score"][c].numpy()[mt]),
            np.sort(np.asarray(out_j["score"][c])[mj]), rtol=1e-9, atol=0)


def test_harris_cuda_rejects_cpu_tensor():
    with pytest.raises(ValueError):
        harris_cuda.harris_nms_cuda(torch.zeros(1, 8, 8))

