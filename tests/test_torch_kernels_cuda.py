"""The port's CUDA kernels against their plain PyTorch versions, on the card,
and the tracking program (whose detection runs the Harris kernel) on the
card against the same program on the CPU.

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


def _track_two_frames(device, imgs, poses):
    """frame_associate on frame A (empty map), static stereo on A at its
    true pose into the landmark table, then frame_associate on frame B
    with A as keyframe and previous frame, float32 at 2x128x192, 128
    keypoints, capacity 64, 16 hypotheses drawn by one CPU generator."""
    from okvis2_torch.cameras.pinhole import PinholeCamera
    from okvis2_torch.core import se3_np
    from okvis2_torch.pipeline import frontend_pipeline as fp

    cam = PinholeCamera.create(192, 128, 120.0, 120.0, 96.0, 64.0, dtype=torch.float32,
                               device=device)
    cams, cap = (cam, cam), 64
    T_SC = np.array([[0, 0, 0, 0, 0, 0, 1.0], [0.11, 0, 0, 0, 0, 0, 1.0]])
    cfg = fp.FrontendConfig(detection=tdet.DetectionConfig(max_keypoints=128),
                            map_match_capacity=cap, ransac_hypotheses=16)

    def sampler(mask, cam_idx, n_hyp, nc):
        gen = torch.Generator().manual_seed(3)
        return fp.sample_hypotheses(gen, mask.cpu(), cam_idx.cpu(), n_hyp, nc).to(mask.device)

    table = fp.DeviceLandmarkTable(cap, 3, device=device)
    table.ensure(512)
    lm = {"hp": np.tile([0, 0, 0, 1.0], (cap, 1)), "mask": np.zeros(cap, bool),
          "init": np.zeros(cap, bool)}
    a = fp.frame_associate(cams, T_SC, imgs[0], poses[0], lm, table.signs, table.valid, cfg,
                           sampler=sampler, device=device)
    T7 = np.stack([se3_np.compose7(poses[0], T) for T in T_SC])
    idx_b, hp_W, good, parallel = (x[0].cpu().numpy() for x in fp._stereo_pairs(
        cams, T7[:1], T7[1:], [3.0 / 120.0], 0.1, 60.0, a["mask"][:1], a["mask"][1:], a["xy"],
        a["signs"], ((0, 1),), 60, True))
    hosted, lms = set(), []
    for k in np.nonzero(good)[0]:
        if (1, int(idx_b[k])) in hosted:
            continue
        hosted |= {(0, int(k)), (1, int(idx_b[k]))}
        lms.append((hp_W[k], not parallel[k]))
        table.stage_descriptor(len(lms) - 1, 0, int(k))
    table.flush(a["signs"])
    for lid, s in table.slot_of.items():
        lm["hp"][s], lm["mask"][s], lm["init"][s] = lms[lid][0], True, lms[lid][1]
    free = a["mask"].clone()
    for c, k in hosted:
        free[c, k] = False
    b = fp.frame_associate(
        cams, T_SC, imgs[1], poses[1], lm, table.signs, table.valid, cfg, sampler=sampler,
        keyframes={"xy": a["xy"][None], "signs": a["signs"][None], "free": free[None],
                   "valid": [True], "T_WS7": poses[0][None]},
        prev={"xy": a["xy"], "signs": a["signs"], "mask": a["mask"], "T_WS7": poses[0]},
        device=device)
    # map match + RANSAC of frame B again, on given inputs (a device's own
    # frame-B outputs), for comparing devices on identical inputs
    def match_and_ransac(dev, out):
        cams_d = tuple(c.to(device=dev) for c in cams)
        t = lambda x: torch.as_tensor(x, device=dev)  # noqa: E731
        f = lambda x: torch.as_tensor(x, dtype=torch.float32, device=dev)  # noqa: E731
        rays = torch.stack([c.back_project(t(out["xy"][i])) for i, c in enumerate(cams_d)])
        return fp._associate_core(
            cams_d, f(poses[1]), f(T_SC), f(lm["hp"]), t(lm["mask"]), t(lm["init"]),
            t(out["tab_signs"]), t(out["tab_valid"]), t(out["xy"]), rays, t(out["mask"]),
            t(out["signs"]), cfg.map_match_radius, cfg.ransac_threshold_deg,
            cfg.matching_threshold, cfg.ransac_hypotheses, cfg.ransac_min_inliers, True, sampler)

    return a, b, match_and_ransac


def test_frame_associate_card_matches_cpu(cuda):
    """Tolerances: keypoints 1e-3 px (float32 reductions such as the
    response's std run in another order on the card), matches and RANSAC
    outcome equal. RANSAC pose: 1e-4 when map match + RANSAC run on
    identical inputs; 1e-3 m end to end, where the keypoints' last-bit
    differences pass through static-stereo depths (disparities of a few px)
    and a minimal P3P solve in float32 (2.6e-4 m measured on the H100)."""
    from okvis2_torch.cameras.pinhole import PinholeCamera
    from okvis2_torch.core.se3 import Transformation
    from okvis2_torch.imu.preintegration import ImuParameters
    from okvis2_torch.pipeline.dataset import SyntheticDataset

    cam = PinholeCamera.create(192, 128, 120.0, 120.0, 96.0, 64.0, device="cpu")
    ext = [Transformation(r=torch.tensor([x, 0.0, 0.0], dtype=torch.float64),
                          q=torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=torch.float64))
           for x in (0.0, 0.11)]
    ds = SyntheticDataset((cam, cam), ext, ImuParameters.create(g=9.81, device="cpu"),
                          n_stars=2500, duration=1.0, frame_rate=10.0, device="cpu")
    poses = np.stack([ds.ground_truth(t) for t in (0.0, 0.1)])
    imgs = [np.stack(ds.render(p)) for p in poses]
    n0 = harris_cuda.harris_nms_cuda.launches
    *card, redo = _track_two_frames(cuda, imgs, poses)
    torch.cuda.synchronize()
    assert harris_cuda.harris_nms_cuda.launches == n0 + 2
    *host, _ = _track_two_frames("cpu", imgs, poses)
    for g, c in zip(card, host):
        mask = c["mask"]
        assert torch.equal(g["mask"].cpu(), mask) and mask.sum(1).min() > 20
        assert (g["xy"].cpu()[mask] - c["xy"][mask]).abs().max() < 1e-3
    (_, gb), (_, cb) = card, host
    assert torch.equal(gb["keep"].cpu(), cb["keep"]) and int(cb["keep"].sum()) >= 20
    assert torch.equal(gb["idx"].cpu()[cb["keep"]], cb["idx"][cb["keep"]])
    assert bool(gb["ransac_ok"]) and bool(cb["ransac_ok"])
    assert int(gb["n_inl"]) == int(cb["n_inl"])
    assert int(gb["ms_total"]) == int(cb["ms_total"])
    assert int(gb["ff_total"]) == int(cb["ff_total"])
    assert (gb["T_WS7"].cpu() - cb["T_WS7"]).abs().max() < 1e-3
    # identical inputs: the card's frame-B outputs, copied to the CPU
    same = {k: gb[k].cpu() for k in ("xy", "mask", "signs", "tab_signs", "tab_valid")}
    rg, rc = redo(cuda, same), redo("cpu", same)
    for x, y in zip(rg[:3], rc[:3]):  # idx, ok, keep
        assert torch.equal(x.cpu(), y)
    assert int(rg[3]) == int(rc[3]) and bool(rg[4]) and bool(rc[4])
    assert (rg[5].cpu() - rc[5]).abs().max() < 1e-4
