"""The port's CUDA kernels against their plain PyTorch versions, on the card.

A hand-written CUDA kernel has no CPU mode, so every test here is marked
``cuda`` and skips without a card. This file imports no JAX, so it also
runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_kernels_cuda.py

Tolerance 0: the kernel rounds each float32 operation as the plain version
does, so the response and NMS maps are held bit for bit over the whole map.
(An absolute bar such as 1e-6 would hold nothing on the textured images,
where most of |resp| lies far below it.)
"""

import numpy as np
import pytest
import torch

from okvis2_torch.frontend import detection as tdet
from okvis2_torch.ops import harris_cuda
from okvis2_torch.utils.synthetic import textured_stereo_pair

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _check(imgs, k=0.04):
    n0 = harris_cuda.harris_nms_cuda.launches
    resp_k, nms_k = tdet.harris_nms(imgs, k)
    torch.cuda.synchronize()
    assert harris_cuda.harris_nms_cuda.launches == n0 + 1
    resp_p, nms_p = harris_cuda.harris_nms_reference(imgs, k)
    err = (resp_k - resp_p).abs().max().item()
    assert torch.equal(resp_k, resp_p), (err, resp_p.abs().median().item())
    assert torch.equal(nms_k, nms_p)


@pytest.mark.parametrize("shape", [(2, 480, 752), (1, 37, 53), (3, 8, 32), (2, 240, 376)])
def test_harris_kernel_matches_plain(cuda, shape):
    """The main path's shape, a ragged one smaller than a tile in neither
    axis, one that is exactly one tile, and the second octave's."""
    imgs = torch.tensor(np.random.default_rng(0).random(shape), dtype=torch.float32, device=cuda)
    _check(imgs)


def test_harris_kernel_detection_keypoints(cuda):
    """The frontend's keypoints through the kernel equal those through the
    plain version at the main path's size, and so do the maps."""
    imgs = torch.tensor(textured_stereo_pair(480, 752, seed=0), dtype=torch.float32, device=cuda)
    _check(imgs)
    cfg = tdet.DetectionConfig(max_keypoints=512)
    a = tdet.detect_keypoints_batch(imgs, cfg)
    b = tdet._detect_batch(imgs, cfg, harris_cuda.harris_nms_reference)
    for c in range(2):
        sa = {tuple(p) for p in torch.round(a["xy"][c][a["mask"][c]]).int().tolist()}
        sb = {tuple(p) for p in torch.round(b["xy"][c][b["mask"][c]]).int().tolist()}
        assert len(sa & sb) >= 0.99 * len(sb)


@pytest.mark.parametrize("bad", ["float64", "non_contiguous", "two_dims"])
def test_harris_kernel_rejects(cuda, bad):
    x = torch.rand(2, 16, 64, device=cuda)
    x = {"float64": x.double(), "non_contiguous": x.transpose(1, 2), "two_dims": x[0]}[bad]
    with pytest.raises(ValueError):
        harris_cuda.harris_nms_cuda(x)
