"""Convert a public Fast-SCNN PyTorch checkpoint into the port's weights.

Port of ``okvis2_tpu/models/import_torch_fast_scnn.py``. The reference
ships cityscapes-pretrained Fast-SCNN weights consumed through LibTorch
(cnn/demo.py:31-76 -> okvis_cv/src/Frame.cpp:46-147). This tool maps that
checkpoint's ``state_dict`` (the layout of ``torch_fast_scnn.py``) onto the
Flax names that ``models/fast_scnn.py``'s modules keep, and writes the JAX
package's flattened checkpoint format, which both packages load (the port
through ``load_params`` and ``interop.fast_scnn_state_dict_from_flax``):

    python -m okvis2_torch.models.import_torch_fast_scnn fast_scnn_citys.pth out.npz

Accepts a raw ``state_dict`` file or a TorchScript archive (demo.py's
fast-scnn.pt), whose modules expose the same ``state_dict``. Weight
transforms, as the JAX converter's: conv OIHW -> HWIO; depthwise
(C,1,kh,kw) -> (kh,kw,1,C); BatchNorm weight/bias -> scale/bias and the
running statistics -> batch_stats; the arrays equal the JAX converter's
bit for bit.

Inputs: the checkpoint expects ImageNet-normalised RGB (demo.py:37-41);
``normalize_imagenet`` applies that transform to [0,1] images. The
checkpoint is not in the repo; the tests convert the mirror with random
weights.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def normalize_imagenet(img: np.ndarray) -> np.ndarray:
    """[H,W,3] in [0,1] -> ImageNet-normalised (demo.py's transform)."""
    mean = np.asarray([0.485, 0.456, 0.406], img.dtype)
    std = np.asarray([0.229, 0.224, 0.225], img.dtype)
    return (img - mean) / std


def _conv(w) -> np.ndarray:
    # torch OIHW -> flax HWIO; depthwise torch (C,1,kh,kw) with
    # groups=C becomes flax (kh,kw,1,C) under the same transpose
    return np.ascontiguousarray(np.transpose(np.asarray(w), (2, 3, 1, 0)))


def _bn(sd: Dict[str, np.ndarray], prefix: str):
    """(params {scale,bias}, batch_stats {mean,var}) of a torch BN."""
    p = {
        "scale": np.asarray(sd[prefix + ".weight"]),
        "bias": np.asarray(sd[prefix + ".bias"]),
    }
    s = {
        "mean": np.asarray(sd[prefix + ".running_mean"]),
        "var": np.asarray(sd[prefix + ".running_var"]),
    }
    return p, s


def convert_state_dict(sd: Dict[str, np.ndarray]):
    """torch state_dict -> {'params': ..., 'batch_stats': ...} matching
    models/fast_scnn.py's named module tree."""
    params: Dict = {}
    stats: Dict = {}

    def put(path, p, s=None):
        node_p, node_s = params, stats
        for key in path[:-1]:
            node_p = node_p.setdefault(key, {})
            node_s = node_s.setdefault(key, {})
        node_p[path[-1]] = p
        if s is not None:
            node_s[path[-1]] = s

    def conv_bn_relu(tprefix, fpath):
        """torch _ConvBNReLU (conv.0 conv + conv.1 BN)."""
        put(fpath + ("conv",), {"kernel": _conv(sd[tprefix + ".conv.0.weight"])})
        p, s = _bn(sd, tprefix + ".conv.1")
        put(fpath + ("bn",), p, s)

    def dsconv(tprefix, fpath):
        """torch _DSConv (conv.0 dw, conv.1 BN, conv.3 pw, conv.4 BN)."""
        put(fpath + ("dw",), {"kernel": _conv(sd[tprefix + ".conv.0.weight"])})
        p, s = _bn(sd, tprefix + ".conv.1")
        put(fpath + ("dw_bn",), p, s)
        put(fpath + ("pw",), {"kernel": _conv(sd[tprefix + ".conv.3.weight"])})
        p, s = _bn(sd, tprefix + ".conv.4")
        put(fpath + ("pw_bn",), p, s)

    def bottleneck(tprefix, fname):
        conv_bn_relu(tprefix + ".block.0", (fname, "expand"))
        put((fname, "dw"),
            {"kernel": _conv(sd[tprefix + ".block.1.conv.0.weight"])})
        p, s = _bn(sd, tprefix + ".block.1.conv.1")
        put((fname, "dw_bn"), p, s)
        put((fname, "project"),
            {"kernel": _conv(sd[tprefix + ".block.2.weight"])})
        p, s = _bn(sd, tprefix + ".block.3")
        put((fname, "project_bn"), p, s)

    # learning to downsample
    conv_bn_relu("learning_to_downsample.conv", ("ltd_conv",))
    dsconv("learning_to_downsample.dsconv1", ("ltd_dsconv1",))
    dsconv("learning_to_downsample.dsconv2", ("ltd_dsconv2",))
    # global feature extractor
    for n in (1, 2, 3):
        for i in range(3):
            bottleneck(
                f"global_feature_extractor.bottleneck{n}.{i}",
                f"gfe_bottleneck{n}_{i}",
            )
    for k in (1, 2, 3, 4):
        conv_bn_relu(f"global_feature_extractor.ppm.conv{k}",
                     ("gfe_ppm", f"conv{k}"))
    conv_bn_relu("global_feature_extractor.ppm.out", ("gfe_ppm", "out"))
    # feature fusion
    put(("ffm_dw",),
        {"kernel": _conv(sd["feature_fusion.dwconv.conv.0.weight"])})
    p, s = _bn(sd, "feature_fusion.dwconv.conv.1")
    put(("ffm_dw_bn",), p, s)
    put(("ffm_conv_lower",), {
        "kernel": _conv(sd["feature_fusion.conv_lower_res.0.weight"]),
        "bias": np.asarray(sd["feature_fusion.conv_lower_res.0.bias"]),
    })
    p, s = _bn(sd, "feature_fusion.conv_lower_res.1")
    put(("ffm_bn_lower",), p, s)
    put(("ffm_conv_higher",), {
        "kernel": _conv(sd["feature_fusion.conv_higher_res.0.weight"]),
        "bias": np.asarray(sd["feature_fusion.conv_higher_res.0.bias"]),
    })
    p, s = _bn(sd, "feature_fusion.conv_higher_res.1")
    put(("ffm_bn_higher",), p, s)
    # classifier
    dsconv("classifier.dsconv1", ("cls_dsconv1",))
    dsconv("classifier.dsconv2", ("cls_dsconv2",))
    put(("cls_conv",), {
        "kernel": _conv(sd["classifier.conv.1.weight"]),
        "bias": np.asarray(sd["classifier.conv.1.bias"]),
    })

    return {"params": params, "batch_stats": stats}


def load_torch_checkpoint(path: str) -> Dict[str, np.ndarray]:
    """Read a .pth ``state_dict`` (``weights_only``) or, failing that, a
    TorchScript .pt archive; ``num_batches_tracked`` is dropped."""
    import torch

    try:
        obj = torch.load(path, map_location="cpu", weights_only=True)
    except Exception:
        obj = torch.jit.load(path, map_location="cpu")
    if hasattr(obj, "state_dict"):
        obj = obj.state_dict()
    if not isinstance(obj, dict):
        raise ValueError(f"unsupported checkpoint object: {type(obj)}")
    return {k: v.detach().cpu().numpy() for k, v in obj.items()
            if "num_batches_tracked" not in k}


def flatten_variables(variables: Dict) -> Dict[str, np.ndarray]:
    """{'params': {...}, 'batch_stats': {...}} -> the flattened checkpoint's
    {"params/<module>/.../<leaf>": array} (the JAX ``save_params`` keys)."""
    out = {}

    def walk(prefix, node):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(prefix + (k,), v)
            else:
                out["/".join(prefix + (k,))] = v

    walk((), variables)
    return out


def main(argv=None):
    """``in.pth out.npz``: convert and write; returns the exit code."""
    import sys

    from okvis2_torch import interop
    from okvis2_torch.models.fast_scnn import save_params

    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 2:
        print(__doc__)
        return 1
    src, dst = argv
    sd = load_torch_checkpoint(src)
    flat = flatten_variables(convert_state_dict(sd))
    # through the port's model: a key or shape it lacks raises here
    save_params(dst, interop.fast_scnn_state_dict_from_flax(flat))
    print(f"converted {len(sd)} torch tensors -> {dst}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
