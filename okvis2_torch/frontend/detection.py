"""Multi-scale Harris keypoint detection on torch tensors.

Port of ``okvis2_tpu/frontend/detection.py``: 2x2 average-pool octaves,
the Harris response and 3x3 NMS per octave, sub-pixel quadratic offsets,
per-grid-cell top-k then a global top-k, and an absolute threshold on the
std-normalised response, all at fixed output shapes [C, max_keypoints].

``harris_nms`` sends a CUDA tensor to the hand-written kernel
(``ops/harris_cuda.py``, always, with no switch) and a CPU tensor to the
plain PyTorch version.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from okvis2_torch.ops.harris_cuda import (
    harris_nms_cuda,
    harris_nms_reference,
    harris_response_reference as harris_response,
    nms3_reference as _nms3,
)

__all__ = [
    "DetectionConfig", "harris_response", "harris_nms",
    "detect_keypoints_batch", "detect_keypoints",
]


@dataclasses.dataclass(frozen=True)
class DetectionConfig:
    max_keypoints: int = 512  # per image (<=700 EuRoC)
    octaves: int = 1  # detection_octaves (0 in the EuRoC config == 1 level)
    cell_size: int = 32  # uniformity grid cell (px)
    per_cell: int = 8  # max keypoints per cell before the global top-k
    absolute_threshold: float = 1e-4  # on the normalised Harris response
    harris_k: float = 0.04
    border: int = 16  # reject keypoints near the border (descriptor support)


def harris_nms(img: torch.Tensor, k: float = 0.04):
    """Fused Harris response + 3x3 NMS -> (response, nms).

    Accepts [H,W] or a camera stack [C,H,W]. A CUDA tensor always goes
    through the CUDA kernel (which raises on what it does not take); only
    a CPU tensor takes the plain version.
    """
    squeeze = img.dim() == 2
    if squeeze:
        img = img[None]
    if img.is_cuda:
        resp, nms = harris_nms_cuda(img.contiguous(), k)
    elif img.device.type == "cpu":
        resp, nms = harris_nms_reference(img, k)
    else:
        raise ValueError(f"harris_nms: unsupported device {img.device}")
    return (resp[0], nms[0]) if squeeze else (resp, nms)


def _subpixel_offsets(score: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-pixel quadratic-fit offsets (dx, dy) from a score map [..., H, W]."""
    sl = torch.roll(score, 1, dims=-1)
    sr = torch.roll(score, -1, dims=-1)
    st = torch.roll(score, 1, dims=-2)
    sb = torch.roll(score, -1, dims=-2)
    denx = sl - 2.0 * score + sr
    deny = st - 2.0 * score + sb
    zero = torch.zeros_like(score)
    dx = torch.where(denx.abs() > 1e-12, 0.5 * (sl - sr) / denx, zero)
    dy = torch.where(deny.abs() > 1e-12, 0.5 * (st - sb) / deny, zero)
    return torch.clamp(dx, -0.5, 0.5), torch.clamp(dy, -0.5, 0.5)


def _topk(x: torch.Tensor, k: int):
    """The k largest entries along the last dimension, ties in index order
    (as ``lax.top_k`` orders them; ``torch.topk`` leaves tie order open)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _grid_topk(score: torch.Tensor, cfg: DetectionConfig):
    """Per-cell top-k then global top-k over [C,H,W].
    Returns (flat_idx [C,N], score [C,N])."""
    C, H, W = score.shape
    cs = cfg.cell_size
    gh, gw = H // cs, W // cs
    s = score[:, : gh * cs, : gw * cs]
    cells = s.reshape(C, gh, cs, gw, cs).permute(0, 1, 3, 2, 4).reshape(
        C, gh * gw, cs * cs
    )
    kc = min(cfg.per_cell, cs * cs)
    cell_scores, cell_idx = _topk(cells, kc)  # [C, ncells, kc]
    ci = torch.arange(gh * gw, device=score.device)
    cy, cx = ci // gw, ci % gw
    iy = cell_idx // cs + (cy * cs)[:, None]
    ix = cell_idx % cs + (cx * cs)[:, None]
    flat = (iy * W + ix).reshape(C, -1)
    scores = cell_scores.reshape(C, -1)
    n = min(cfg.max_keypoints, flat.shape[1])
    top_scores, top_i = _topk(scores, n)
    return torch.gather(flat, 1, top_i), top_scores


def _select_from_maps(resp, nms, octave: int, cfg: DetectionConfig):
    """Keypoint selection from (response, nms) maps [C,H,W] (per image)."""
    dtype = resp.dtype
    C, H, W = resp.shape
    # population std (ddof=0), as jnp.std
    std = torch.std(resp.reshape(C, -1), dim=-1, correction=0)
    scale_n = (1.0 / (std + 1e-12))[:, None, None]
    resp = resp * scale_n
    nms = nms * scale_n
    dx, dy = _subpixel_offsets(resp)
    flat_idx, scores = _grid_topk(nms, cfg)
    ys = (flat_idx // W).to(dtype)
    xs = (flat_idx % W).to(dtype)
    xs = xs + torch.gather(dx.reshape(C, -1), 1, flat_idx)
    ys = ys + torch.gather(dy.reshape(C, -1), 1, flat_idx)
    scale = 2.0**octave
    xy = torch.stack([xs, ys], dim=-1) * scale
    valid = (
        (scores > cfg.absolute_threshold)
        & (xs > cfg.border) & (xs < W - cfg.border)
        & (ys > cfg.border) & (ys < H - cfg.border)
    )
    n = xy.shape[1]
    return (
        xy,
        torch.where(valid, scores, torch.full_like(scores, -torch.inf)),
        torch.full((C, n), octave, dtype=torch.int32, device=resp.device),
        torch.full((C, n), 9.0 * scale, dtype=dtype, device=resp.device),
    )


def detect_keypoints_batch(images: torch.Tensor, cfg: DetectionConfig = DetectionConfig()):
    """Detect up to cfg.max_keypoints corners per image of a camera stack
    [C,H,W] (float, [0,1]). The response/NMS maps of all cameras come from
    ONE kernel launch per octave.

    Returns a dict of fixed shapes, leading dim C:
      xy [C,N,2], score [C,N], octave [C,N], size [C,N], mask [C,N]
    """
    return _detect_batch(images, cfg, harris_nms)


def _detect_batch(images: torch.Tensor, cfg: DetectionConfig, harris_fn):
    """``detect_keypoints_batch`` with the (response, nms) maps taken from
    ``harris_fn``; the smoke run passes the plain version to hold the
    kernel's keypoints against it on the card."""
    N = cfg.max_keypoints
    per_oct = []
    img = images
    for o in range(max(cfg.octaves, 1)):
        resp, nms = harris_fn(img, cfg.harris_k)
        per_oct.append(_select_from_maps(resp, nms, o, cfg))
        if o + 1 < cfg.octaves:
            C, H, W = img.shape
            Hc, Wc = (H // 2) * 2, (W // 2) * 2
            img = img[:, :Hc, :Wc].reshape(C, Hc // 2, 2, Wc // 2, 2).mean(dim=(2, 4))

    xy = torch.cat([p[0] for p in per_oct], dim=1)
    score = torch.cat([p[1] for p in per_oct], dim=1)
    octv = torch.cat([p[2] for p in per_oct], dim=1)
    size = torch.cat([p[3] for p in per_oct], dim=1)

    top_scores, ti = _topk(score, N)
    return {
        "xy": torch.gather(xy, 1, ti[..., None].expand(-1, -1, 2)),
        "score": top_scores,
        "octave": torch.gather(octv, 1, ti),
        "size": torch.gather(size, 1, ti),
        "mask": torch.isfinite(top_scores) & (top_scores > cfg.absolute_threshold),
    }


def detect_keypoints(image: torch.Tensor, cfg: DetectionConfig = DetectionConfig()):
    """Single-image variant of detect_keypoints_batch ([H,W] in)."""
    out = detect_keypoints_batch(image[None], cfg)
    return {k: v[0] for k, v in out.items()}
