"""Oriented binary pattern descriptor on torch tensors.

Port of ``okvis2_tpu/frontend/descriptor.py``: a BRISK-style ring pattern
(60 points on 5 rings, 512 short-distance comparison pairs), one box blur
per ring, orientation from the blurred image's gradient at the keypoint,
bilinear sampling for the centre ring and nearest sampling for the outer
rings. Descriptors come back as ±1 sign vectors [N,512] (for the matmul
Hamming distance) and bit-packed as 16 32-bit words per keypoint, with the
same bit pattern as the reference's ``uint32[16]`` (map files and the BoW
store keep those words). Torch has no uint32 arithmetic, so the words are
packed in int64 and returned as int32 with the identical bits.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

DESCRIPTOR_BITS = 512


def _build_pattern():
    """BRISK-like pattern: rings of sample points + comparison pairs
    (the reference's construction, step for step)."""
    ring_r = [0.0, 2.9, 4.9, 7.4, 10.8]
    ring_n = [1, 10, 14, 15, 20]
    pts = []
    ring_id = []
    for ri, (r, n) in enumerate(zip(ring_r, ring_n)):
        for i in range(n):
            a = 2.0 * np.pi * i / n + (0.5 * np.pi * ri / len(ring_r))
            pts.append([r * np.cos(a), r * np.sin(a)])
            ring_id.append(ri)
    pts = np.asarray(pts, np.float64)  # [60,2]
    ring_id = np.asarray(ring_id, np.int32)

    # short-distance pairs -> descriptor bits; long-distance -> orientation
    P = len(pts)
    pairs = []
    dists = []
    long_pairs = []
    for i in range(P):
        for j in range(i + 1, P):
            d = np.linalg.norm(pts[i] - pts[j])
            if d < 9.75:
                pairs.append((i, j))
                dists.append(d)
            elif d > 13.67:
                long_pairs.append((i, j))
    order = np.argsort(dists)
    pairs = np.asarray(pairs, np.int32)[order][:DESCRIPTOR_BITS]
    if len(pairs) < DESCRIPTOR_BITS:
        raise AssertionError(
            f"pattern yields only {len(pairs)} short pairs (<{DESCRIPTOR_BITS})"
        )
    long_pairs = np.asarray(long_pairs, np.int32)
    return pts, ring_id, pairs, long_pairs


_PATTERN, _RING_ID, _PAIRS, _LONG_PAIRS = _build_pattern()
_NUM_RINGS = int(_RING_ID.max()) + 1
# each point is sampled only from its own ring's blurred image
_RING_MEMBERS = [np.nonzero(_RING_ID == r)[0] for r in range(_NUM_RINGS)]


def _box_blur(img: torch.Tensor, k: int) -> torch.Tensor:
    """Separable box blur of odd width k over [H,W] as cyclic shift-adds.
    It multiplies by 1/k where the JAX package divides by k, as XLA compiles
    that division: on uint8 images many samples tie, and the same rounding
    keeps the descriptor bits of the JAX package's CPU run."""
    if k <= 1:
        return img
    r = k // 2
    acc = img
    for d in range(1, r + 1):
        acc = acc + torch.roll(img, d, 0) + torch.roll(img, -d, 0)
    acc = acc * (1.0 / k)
    out = acc
    for d in range(1, r + 1):
        out = out + torch.roll(acc, d, 1) + torch.roll(acc, -d, 1)
    return out * (1.0 / k)


def nearest_sample(img: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour sample of [H,W] at xy [...,2] (clamped;
    round-half-to-even as jnp.round)."""
    H, W = img.shape
    x = torch.clamp(torch.round(xy[..., 0]), 0.0, W - 1.0).to(torch.long)
    y = torch.clamp(torch.round(xy[..., 1]), 0.0, H - 1.0).to(torch.long)
    return img[y, x]


def bilinear_sample(img: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """Sample [H,W] at xy [...,2] (x right, y down) with clamping."""
    H, W = img.shape
    x = torch.clamp(xy[..., 0], 0.0, W - 1.001)
    y = torch.clamp(xy[..., 1], 0.0, H - 1.001)
    x0 = torch.floor(x).to(torch.long)
    y0 = torch.floor(y).to(torch.long)
    fx = x - x0
    fy = y - y0
    i00 = img[y0, x0]
    i01 = img[y0, x0 + 1]
    i10 = img[y0 + 1, x0]
    i11 = img[y0 + 1, x0 + 1]
    return (
        i00 * (1 - fx) * (1 - fy)
        + i01 * fx * (1 - fy)
        + i10 * (1 - fx) * fy
        + i11 * fx * fy
    )


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """Bool [N,512] -> int32 [N,16] words whose bits equal the reference's
    uint32 words (bit b of word w = comparison 32*w + b)."""
    N = bits.shape[0]
    b = bits.reshape(N, DESCRIPTOR_BITS // 32, 32).to(torch.int64)
    weights = torch.bitwise_left_shift(
        torch.ones(32, dtype=torch.int64, device=bits.device),
        torch.arange(32, dtype=torch.int64, device=bits.device),
    )
    words = torch.sum(b * weights, dim=-1)  # [N,16] in [0, 2^32)
    # two's-complement reinterpretation of the unsigned word
    words = torch.where(words >= 2**31, words - 2**32, words)
    return words.to(torch.int32)


@functools.lru_cache(maxsize=None)
def _tables(dtype: torch.dtype, device: torch.device):
    """The pattern [P,2], the comparison pairs [512,2] and each ring's
    member indices on ``device``, copied there once: a copy per call cost
    each image an 8 KB upload and a synchronisation."""
    return (torch.as_tensor(_PATTERN, dtype=dtype, device=device),
            torch.as_tensor(_PAIRS, dtype=torch.long, device=device),
            tuple(torch.as_tensor(m, dtype=torch.long, device=device) for m in _RING_MEMBERS))


def describe_keypoints(
    image: torch.Tensor,  # [H,W] float
    xy: torch.Tensor,  # [N,2]
    size: torch.Tensor,  # [N] keypoint diameter (scales the pattern)
    mask: torch.Tensor,  # [N] bool
    extraction_direction: torch.Tensor | None = None,  # [N] radians
    use_orientation: bool = True,
):
    """Binary descriptors of one image's keypoints.

    Returns dict:
      signs  [N,512] float (+1/-1; 0 rows for invalid keypoints)
      packed [N,16] int32, the reference's uint32 words bit for bit
      angle  [N] the orientation used
    """
    dtype = image.dtype
    dev = image.device
    N = xy.shape[0]
    pattern, pairs, ring_idx = _tables(dtype, dev)  # [P,2], [512,2], per ring

    blurred = [_box_blur(image, 2 * r + 1) for r in range(_NUM_RINGS)]
    scale = (size / 9.0)[:, None, None]  # pattern defined for size 9

    def sample_at(angle):
        ca, sa = torch.cos(angle), torch.sin(angle)  # [N]
        rot = torch.stack(
            [torch.stack([ca, -sa], -1), torch.stack([sa, ca], -1)], -2
        )  # [N,2,2]
        pts = torch.einsum("nij,pj->npi", rot, pattern) * scale + xy[:, None, :]
        vals = torch.zeros(pts.shape[:2], dtype=dtype, device=dev)
        for r, idx in enumerate(ring_idx):
            sampler = bilinear_sample if r == 0 else nearest_sample
            vals[:, idx] = sampler(blurred[r], pts[:, idx, :])
        return vals  # [N,P]

    if use_orientation and extraction_direction is None:
        g_img = blurred[2]
        gx_map = 0.5 * (torch.roll(g_img, -1, 1) - torch.roll(g_img, 1, 1))
        gy_map = 0.5 * (torch.roll(g_img, -1, 0) - torch.roll(g_img, 1, 0))
        gx = bilinear_sample(gx_map, xy)
        gy = bilinear_sample(gy_map, xy)
        angle = torch.atan2(gy, gx)
    elif extraction_direction is not None:
        angle = extraction_direction.to(dtype)
    else:
        angle = torch.zeros((N,), dtype=dtype, device=dev)

    vals = sample_at(angle)
    bits = vals[:, pairs[:, 0]] < vals[:, pairs[:, 1]]  # [N,512] bool
    signs = torch.where(bits, 1.0, -1.0).to(dtype)
    signs = signs * mask[:, None].to(dtype)
    return {"signs": signs, "packed": pack_bits(bits), "angle": angle}
