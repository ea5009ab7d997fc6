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


@pytest.mark.parametrize("shape", [
    (2, 480, 752),   # the main path
    (2, 240, 376),   # its octaves; W = 94 has W*4 not a multiple of 16
    (2, 120, 188),
    (2, 60, 94),
    (2, 14, 360),    # an exact multiple of the 120-column x 7-row tile
    (1, 37, 53),     # ragged in both axes
    (1, 4, 115),     # smaller than one tile in both axes
    (1, 2, 40),      # H, W <= 3: the 3-px halo wraps onto itself
    (2, 20, 3),
    (1, 3, 2),
    (1, 1, 1),
    (3, 33, 71),     # C = 3
], ids=str)
def test_harris_kernel_matches_plain(cuda, shape):
    imgs = torch.tensor(np.random.default_rng(0).random(shape), dtype=torch.float32, device=cuda)
    _check(imgs)


def test_harris_kernel_non_default_k(cuda):
    imgs = torch.tensor(np.random.default_rng(1).random((2, 64, 96)), dtype=torch.float32,
                        device=cuda)
    _check(imgs, k=0.06)


@pytest.mark.parametrize("shape", [(2, 60, 94), (2, 48, 64)])
def test_harris_kernel_misaligned_input(cuda, shape):
    """A contiguous view whose data pointer is 4 bytes off 16-byte
    alignment takes the scalar path and still agrees bit for bit."""
    n = int(np.prod(shape))
    buf = torch.tensor(np.random.default_rng(2).random(n + 1), dtype=torch.float32, device=cuda)
    imgs = buf[1:].view(shape)
    assert imgs.data_ptr() % 16 == 4 and imgs.is_contiguous()
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


@pytest.mark.parametrize("bad", ["float64", "non_contiguous", "two_dims", "no_rows", "no_cameras",
                                 "too_many_cameras"])
def test_harris_kernel_rejects(cuda, bad):
    """What the kernel does not take raises ValueError and counts no launch:
    other types, layouts and ranks, empty shapes (no task to launch), and
    more cameras than the grid's z extent (65535) holds."""
    x = torch.rand(2, 16, 64, device=cuda)
    x = {"float64": x.double(), "non_contiguous": x.transpose(1, 2), "two_dims": x[0],
         "no_rows": x[:, :0], "no_cameras": x[:0],
         "too_many_cameras": torch.zeros(65536, 1, 1, device=cuda)}[bad]
    n0 = harris_cuda.harris_nms_cuda.launches
    with pytest.raises(ValueError):
        harris_cuda.harris_nms_cuda(x)
    assert harris_cuda.harris_nms_cuda.launches == n0
