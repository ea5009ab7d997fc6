"""Plain Fast-SCNN forward pass (Poudel et al. 2019, "Fast-SCNN: Fast
Semantic Segmentation Network", arXiv:1902.04502), the CNN gate's network
in OKVIS2 (19 cityscapes classes; sky 10 and person 11 gate landmarks).

Functional float32 torch in NCHW, weights read straight from the flattened
Flax checkpoint (``params/<module>/kernel`` [kh,kw,in/groups,out],
``bias``, BatchNorm ``scale``/``bias`` and ``batch_stats/<module>/mean``
/``var``, eps 1e-5, eval mode): learning to downsample (conv 3x3/2, two
depthwise-separable convs /2), the global feature extractor (three
stages of three inverted-residual bottlenecks, expansion 6, strides
2, 2, 1; pyramid pooling over 1, 2, 3 and 6 bins), feature fusion and
the classifier; stride-2 convs pad (k-1)//2, bilinear resizes align
corners, inputs are zero-padded to multiples of 64. It imports nothing of
the port.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

BOTTLENECKS = tuple((f"gfe_bottleneck{b}_{i}", stride if i == 0 else 1)
                    for b, stride in ((1, 2), (2, 2), (3, 1)) for i in range(3))


class Weights:
    def __init__(self, path: str, device):
        with np.load(path, allow_pickle=False) as data:
            self.w = {k: torch.as_tensor(np.asarray(v, np.float32), device=device)
                      for k, v in data.items()}

    def conv(self, x, mod, stride=1, groups=1):
        k = self.w[f"params/{mod}/kernel"].permute(3, 2, 0, 1).contiguous()
        b = self.w.get(f"params/{mod}/bias")
        pad = (k.shape[-1] - 1) // 2
        return F.conv2d(x, k, b, stride, pad, 1, groups)

    def bn(self, x, mod):
        return F.batch_norm(x, self.w[f"batch_stats/{mod}/mean"], self.w[f"batch_stats/{mod}/var"],
                            self.w[f"params/{mod}/scale"], self.w[f"params/{mod}/bias"], False,
                            0.1, 1e-5)


def _resize(x, hw):
    if tuple(x.shape[-2:]) == tuple(hw):
        return x
    return F.interpolate(x, size=tuple(hw), mode="bilinear", align_corners=True)


def _cbr(W, x, mod, stride=1):
    return F.relu(W.bn(W.conv(x, f"{mod}/conv", stride), f"{mod}/bn"))


def _dsconv(W, x, mod, stride=1):
    c = x.shape[1]
    x = F.relu(W.bn(W.conv(x, f"{mod}/dw", stride, groups=c), f"{mod}/dw_bn"))
    return F.relu(W.bn(W.conv(x, f"{mod}/pw"), f"{mod}/pw_bn"))


def _bottleneck(W, x, mod, stride):
    h = _cbr(W, x, f"{mod}/expand")
    h = F.relu(W.bn(W.conv(h, f"{mod}/dw", stride, groups=h.shape[1]), f"{mod}/dw_bn"))
    h = W.bn(W.conv(h, f"{mod}/project"), f"{mod}/project_bn")
    return h + x if stride == 1 and h.shape == x.shape else h


def forward(W: Weights, x):
    """[B,3,H,W] (multiples of 64) -> logits [B,19,H,W]."""
    d = _dsconv(W, _dsconv(W, _cbr(W, x, "ltd_conv", 2), "ltd_dsconv1", 2), "ltd_dsconv2", 2)
    g = d
    for mod, stride in BOTTLENECKS:
        g = _bottleneck(W, g, mod, stride)
    outs = [g]
    for k, bins in enumerate((1, 2, 3, 6)):
        p = _cbr(W, F.adaptive_avg_pool2d(g, bins), f"gfe_ppm/conv{k + 1}")
        outs.append(_resize(p, g.shape[-2:]))
    g = _cbr(W, torch.cat(outs, 1), "gfe_ppm/out")
    g = _resize(g, d.shape[-2:])
    g = F.relu(W.bn(W.conv(g, "ffm_dw", groups=g.shape[1]), "ffm_dw_bn"))
    g = W.bn(W.conv(g, "ffm_conv_lower"), "ffm_bn_lower")
    f = F.relu(g + W.bn(W.conv(d, "ffm_conv_higher"), "ffm_bn_higher"))
    f = _dsconv(W, _dsconv(W, f, "cls_dsconv1"), "cls_dsconv2")
    return _resize(W.conv(f, "cls_conv"), x.shape[-2:])


def image_logits(W: Weights, img):
    """[H,W] gray image (float32 in [0, 1]) -> logits [19,H,W]: the gray
    value in all three channels, zero-padded to multiples of 64."""
    H, Wd = img.shape
    x = torch.stack([img] * 3, 0)
    x = F.pad(x, (0, -Wd % 64, 0, -H % 64))
    with torch.inference_mode():
        return forward(W, x[None])[0, :, :H, :Wd]
