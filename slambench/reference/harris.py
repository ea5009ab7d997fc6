"""Plain keypoint detection: Harris response, 3x3 non-maximum suppression
and the keypoint selection, in float32 as the configuration runs it.

A frozen copy of the port's plain version (``ops/harris_cuda.py``'s
``harris_response_reference`` / ``nms3_reference``, the algorithm of
OKVIS2's detector as the JAX package writes it: Sobel gradients and 3x3
box-filtered structure tensor as cyclic shift-adds, k = 0.04) and of its
selection (``frontend/detection.py``: response normalised by its
population standard deviation, sub-pixel quadratic offsets, per-cell
top-k over 32-pixel cells, a global top-k with ties in index order, the
absolute threshold and the border). It imports nothing of the port.
"""

from __future__ import annotations

import torch


def _shift(img, dy, dx):
    return torch.roll(img, shifts=(dy, dx), dims=(-2, -1))


def _box3(img):
    row = _shift(img, 0, -1) + img + _shift(img, 0, 1)
    return (_shift(row, -1, 0) + row + _shift(row, 1, 0)) * (1.0 / 9.0)


def harris_response(img, k: float = 0.04):
    sm_v = _shift(img, -1, 0) + 2.0 * img + _shift(img, 1, 0)
    ix = (_shift(sm_v, 0, -1) - _shift(sm_v, 0, 1)) * (1.0 / 8.0)
    sm_h = _shift(img, 0, -1) + 2.0 * img + _shift(img, 0, 1)
    iy = (_shift(sm_h, -1, 0) - _shift(sm_h, 1, 0)) * (1.0 / 8.0)
    ixx, iyy, ixy = _box3(ix * ix), _box3(iy * iy), _box3(ix * iy)
    tr = ixx + iyy
    return ixx * iyy - ixy * ixy - k * tr * tr


def nms3(score):
    m = score
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy or dx:
                m = torch.maximum(m, _shift(score, dy, dx))
    return torch.where(score >= m, score, torch.full_like(score, -torch.inf))


def _topk(x, k):
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _subpixel(score):
    sl, sr = torch.roll(score, 1, dims=-1), torch.roll(score, -1, dims=-1)
    st, sb = torch.roll(score, 1, dims=-2), torch.roll(score, -1, dims=-2)
    denx, deny = sl - 2.0 * score + sr, st - 2.0 * score + sb
    zero = torch.zeros_like(score)
    dx = torch.where(denx.abs() > 1e-12, 0.5 * (sl - sr) / denx, zero)
    dy = torch.where(deny.abs() > 1e-12, 0.5 * (st - sb) / deny, zero)
    return torch.clamp(dx, -0.5, 0.5), torch.clamp(dy, -0.5, 0.5)


def detect(images, max_keypoints: int, cell: int = 32, per_cell: int = 8,
           threshold: float = 1e-4, border: int = 16, k: float = 0.04):
    """One octave over a camera stack [C,H,W] -> {"xy" [C,N,2], "mask"
    [C,N]} in the detector's output order."""
    resp = harris_response(images, k)
    nms = nms3(resp)
    C, H, W = resp.shape
    scale = (1.0 / (torch.std(resp.reshape(C, -1), dim=-1, correction=0) + 1e-12))[:, None, None]
    resp, nms = resp * scale, nms * scale
    dx, dy = _subpixel(resp)
    gh, gw = H // cell, W // cell
    cells = nms[:, :gh * cell, :gw * cell].reshape(C, gh, cell, gw, cell).permute(
        0, 1, 3, 2, 4).reshape(C, gh * gw, cell * cell)
    cs, ci = _topk(cells, min(per_cell, cell * cell))
    cidx = torch.arange(gh * gw, device=images.device)
    iy = ci // cell + (cidx // gw * cell)[:, None]
    ix = ci % cell + (cidx % gw * cell)[:, None]
    flat = (iy * W + ix).reshape(C, -1)
    scores = cs.reshape(C, -1)
    top, ti = _topk(scores, min(max_keypoints, flat.shape[1]))
    flat = torch.gather(flat, 1, ti)
    ys = (flat // W).to(images.dtype)
    xs = (flat % W).to(images.dtype)
    xs = xs + torch.gather(dx.reshape(C, -1), 1, flat)
    ys = ys + torch.gather(dy.reshape(C, -1), 1, flat)
    valid = ((top > threshold) & (xs > border) & (xs < W - border)
             & (ys > border) & (ys < H - border))
    score = torch.where(valid, top, torch.full_like(top, -torch.inf))
    # the global top-k of one octave keeps the per-octave order
    s2, order = _topk(score, max_keypoints)
    xy = torch.gather(torch.stack([xs, ys], -1), 1, order[..., None].expand(-1, -1, 2))
    return {"xy": xy, "mask": torch.isfinite(s2) & (s2 > threshold)}
