"""Fast-SCNN semantic segmentation.

Port of ``okvis2_tpu/models/fast_scnn.py`` (the reference's LibTorch
fast-scnn, okvis_cv/include/okvis/internal/Network.hpp:50-60, used by
Frame::computeClassifications, okvis_cv/src/Frame.cpp:46-147): 19-class
cityscapes segmentation whose sky (10) and person (11) classes suppress
landmarks (Frontend.cpp:969-1011, information x 1e-4).

Learning to downsample -> global feature extractor (inverted-residual
bottlenecks + pyramid pooling) -> feature fusion -> classifier, in NCHW
with library convolutions (depthwise ones as ``groups`` = channels) and
BatchNorm in eval mode. Submodules keep the Flax names (``ltd_conv``,
``gfe_bottleneck1_0``, ``gfe_ppm.conv1``, ...), so the JAX package's
parameters map onto the ``state_dict`` leaf by leaf
(``interop.fast_scnn_state_dict_from_flax``). Stride-2 convolutions pad
``(k-1)//2`` on both sides, bilinear resizes use ``align_corners=True``,
and inputs are zero-padded to multiples of 64, as in the JAX package.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

NUM_CLASSES = 19  # cityscapes
SKY_CLASS = 10
PERSON_CLASS = 11


def resize_align_corners(x: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """Bilinear resize of [B,C,H,W] with x_in = x_out * (in-1)/(out-1)."""
    if tuple(x.shape[-2:]) == tuple(out_hw):
        return x
    return F.interpolate(x, size=tuple(out_hw), mode="bilinear", align_corners=True)


def _adaptive_avg_pool(x: torch.Tensor, bins: int) -> torch.Tensor:
    """[B,C,H,W] -> [B,C,bins,bins] over windows floor(i*H/bins) ..
    ceil((i+1)*H/bins), as the JAX package's static slices."""
    return F.adaptive_avg_pool2d(x, bins)


def _conv(cin, cout, k, stride=1, groups=1, bias=False):
    return nn.Conv2d(cin, cout, k, stride, (k - 1) // 2, groups=groups, bias=bias)


class ConvBNReLU(nn.Module):
    def __init__(self, cin: int, cout: int, kernel: int = 3, stride: int = 1):
        super().__init__()
        self.conv = _conv(cin, cout, kernel, stride)
        self.bn = nn.BatchNorm2d(cout)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


class DSConv(nn.Module):
    """Depthwise 3x3 + BN + relu, pointwise 1x1 + BN + relu."""

    def __init__(self, cin: int, cout: int, stride: int = 1):
        super().__init__()
        self.dw = _conv(cin, cin, 3, stride, groups=cin)
        self.dw_bn = nn.BatchNorm2d(cin)
        self.pw = _conv(cin, cout, 1)
        self.pw_bn = nn.BatchNorm2d(cout)

    def forward(self, x):
        x = F.relu(self.dw_bn(self.dw(x)))
        return F.relu(self.pw_bn(self.pw(x)))


class Bottleneck(nn.Module):
    """Inverted residual: expand 1x1, depthwise 3x3, linear project 1x1;
    shortcut when the shape is kept."""

    def __init__(self, cin: int, cout: int, stride: int = 1, expansion: int = 6):
        super().__init__()
        hid = cin * expansion
        self.expand = ConvBNReLU(cin, hid, 1)
        self.dw = _conv(hid, hid, 3, stride, groups=hid)
        self.dw_bn = nn.BatchNorm2d(hid)
        self.project = _conv(hid, cout, 1)
        self.project_bn = nn.BatchNorm2d(cout)
        self.shortcut = stride == 1 and cin == cout

    def forward(self, x):
        h = F.relu(self.dw_bn(self.dw(self.expand(x))))
        h = self.project_bn(self.project(h))
        return h + x if self.shortcut else h


class PyramidPooling(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        for k in range(4):
            setattr(self, f"conv{k + 1}", ConvBNReLU(cin, cin // 4, 1))
        self.out = ConvBNReLU(cin * 2, cout, 1)

    def forward(self, x):
        outs = [x]
        for k, bins in enumerate((1, 2, 3, 6)):
            p = getattr(self, f"conv{k + 1}")(_adaptive_avg_pool(x, bins))
            outs.append(resize_align_corners(p, x.shape[-2:]))
        return self.out(torch.cat(outs, dim=1))


# (Flax name, in, out, stride) of the global feature extractor's bottlenecks
_BOTTLENECKS = tuple(
    (f"gfe_bottleneck{b}_{i}", cin if i == 0 else cout, cout, stride if i == 0 else 1)
    for b, cin, cout, stride in ((1, 64, 64, 2), (2, 64, 96, 2), (3, 96, 128, 1))
    for i in range(3)
)


class FastSCNN(nn.Module):
    """[B,3,H,W] (H, W multiples of 64) -> logits [B,num_classes,H,W]."""

    def __init__(self, num_classes: int = NUM_CLASSES):
        super().__init__()
        self.ltd_conv = ConvBNReLU(3, 32, 3, 2)
        self.ltd_dsconv1 = DSConv(32, 48, 2)
        self.ltd_dsconv2 = DSConv(48, 64, 2)
        for name, cin, cout, stride in _BOTTLENECKS:
            setattr(self, name, Bottleneck(cin, cout, stride))
        self.gfe_ppm = PyramidPooling(128, 128)
        self.ffm_dw = _conv(128, 128, 3, groups=128)
        self.ffm_dw_bn = nn.BatchNorm2d(128)
        self.ffm_conv_lower = _conv(128, 128, 1, bias=True)
        self.ffm_bn_lower = nn.BatchNorm2d(128)
        self.ffm_conv_higher = _conv(64, 128, 1, bias=True)
        self.ffm_bn_higher = nn.BatchNorm2d(128)
        self.cls_dsconv1 = DSConv(128, 128)
        self.cls_dsconv2 = DSConv(128, 128)
        self.cls_conv = _conv(128, num_classes, 1, bias=True)

    def forward(self, x):
        d = self.ltd_dsconv2(self.ltd_dsconv1(self.ltd_conv(x)))  # 1/8
        g = d
        for name, *_ in _BOTTLENECKS:  # 1/32
            g = getattr(self, name)(g)
        g = self.gfe_ppm(g)
        g_up = resize_align_corners(g, d.shape[-2:])
        g_up = F.relu(self.ffm_dw_bn(self.ffm_dw(g_up)))
        g_up = self.ffm_bn_lower(self.ffm_conv_lower(g_up))
        d_p = self.ffm_bn_higher(self.ffm_conv_higher(d))
        f = F.relu(g_up + d_p)
        f = self.cls_dsconv2(self.cls_dsconv1(f))
        return resize_align_corners(self.cls_conv(f), x.shape[-2:])


def _pad_to_64(img: torch.Tensor) -> torch.Tensor:
    """[C,H,W] -> zero-padded at the bottom and right to multiples of 64."""
    H, W = img.shape[-2:]
    return F.pad(img, (0, -W % 64, 0, -H % 64))


def image_logits(model: FastSCNN, img: torch.Tensor) -> torch.Tensor:
    """[H,W] gray or [H,W,3] image -> logits [num_classes,H,W], computed in
    the image's floating dtype (integer images in float32, as they are
    given: a uint8 image reaches the network as 0-255 values, as in the
    JAX package). ``model`` must hold that dtype."""
    if img.ndim == 2:
        img = torch.stack([img] * 3, dim=-1)
    H, W = img.shape[:2]
    dtype = img.dtype if img.is_floating_point() else torch.float32
    x = _pad_to_64(img.to(dtype).permute(2, 0, 1))
    with torch.inference_mode():
        return model(x[None])[0, :, :H, :W]


def segment_image(model: FastSCNN, img: torch.Tensor) -> torch.Tensor:
    """[H,W] gray or [H,W,3] image -> per-pixel class ids [H,W] (the first
    largest logit)."""
    return torch.argmax(image_logits(model, img), dim=0)


def classify_keypoints(seg: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """Per-keypoint class from a segmentation map (Frame::
    computeClassifications role): xy [N,2] rounded half to even, clipped
    to the image -> class ids [N]."""
    x = torch.round(xy[:, 0]).long().clamp(0, seg.shape[1] - 1)
    y = torch.round(xy[:, 1]).long().clamp(0, seg.shape[0] - 1)
    return seg[y, x]


def suppression_weights(classes: torch.Tensor) -> torch.Tensor:
    """Observation weight per keypoint: sky/person -> 1e-2, the square root
    of the 1e-4 information scale (Frontend.cpp:986-1011)."""
    suppressed = (classes == SKY_CLASS) | (classes == PERSON_CLASS)
    ones = torch.ones(classes.shape, dtype=torch.float32, device=classes.device)
    return torch.where(suppressed, ones * 1e-2, ones)


def load_params(path: str) -> dict:
    """The JAX package's flattened Flax checkpoint (``save_params``):
    {"params/<module>/.../<leaf>" or "batch_stats/...": numpy array}."""
    with np.load(path, allow_pickle=False) as data:
        return {k: np.asarray(v) for k, v in data.items()}


def save_params(path: str, model) -> None:
    """Write a ``FastSCNN`` (or its ``state_dict``) as the JAX package's
    flattened Flax checkpoint (its ``save_params``: a compressed ``.npz``
    of ``interop.fast_scnn_flax_from_state_dict``), which ``load_params``
    and the JAX package's ``load_params`` both read."""
    from okvis2_torch.interop import fast_scnn_flax_from_state_dict

    sd = model.state_dict() if isinstance(model, nn.Module) else model
    np.savez_compressed(path, **fast_scnn_flax_from_state_dict(sd))
