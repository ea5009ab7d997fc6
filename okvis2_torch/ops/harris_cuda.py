"""Fused Harris + 3x3 NMS: the CUDA kernel's wrapper and its plain version.

Port of the TPU kernel ``okvis2_tpu/ops/harris_pallas.py::harris_nms_pallas``.
The kernel lives in ``okvis2_torch/csrc/harris_nms.cu`` (its header states
the bound and the design); ``harris_nms_reference`` is the plain PyTorch
version with the operation order of ``okvis2_tpu/frontend/detection.py``
(``harris_response`` + ``_nms3``), used for CPU tensors and as the kernel's
oracle. Both wrap cyclically at the borders.
"""

from __future__ import annotations

import ctypes
import functools

import torch


def _shift(img: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """Cyclic shift of the last two axes (jnp.roll semantics)."""
    return torch.roll(img, shifts=(dy, dx), dims=(-2, -1))


def _box3(img: torch.Tensor) -> torch.Tensor:
    """3x3 box filter as separable shift-adds."""
    row = _shift(img, 0, -1) + img + _shift(img, 0, 1)
    return (_shift(row, -1, 0) + row + _shift(row, 1, 0)) * (1.0 / 9.0)


def harris_response_reference(img: torch.Tensor, k: float = 0.04) -> torch.Tensor:
    """Harris response of [..., H, W]: Sobel gradients + box-filtered
    structure tensor, all as cyclic shift-adds."""
    sm_v = _shift(img, -1, 0) + 2.0 * img + _shift(img, 1, 0)
    ix = (_shift(sm_v, 0, -1) - _shift(sm_v, 0, 1)) * (1.0 / 8.0)
    sm_h = _shift(img, 0, -1) + 2.0 * img + _shift(img, 0, 1)
    iy = (_shift(sm_h, -1, 0) - _shift(sm_h, 1, 0)) * (1.0 / 8.0)
    ixx = _box3(ix * ix)
    iyy = _box3(iy * iy)
    ixy = _box3(ix * iy)
    det = ixx * iyy - ixy * ixy
    tr = ixx + iyy
    return det - k * tr * tr


def nms3_reference(score: torch.Tensor) -> torch.Tensor:
    """3x3 non-max suppression as 8 shifted maxima (-inf where suppressed)."""
    m = score
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy == 0 and dx == 0:
                continue
            m = torch.maximum(m, _shift(score, dy, dx))
    return torch.where(score >= m, score, torch.full_like(score, -torch.inf))


def harris_nms_reference(img: torch.Tensor, k: float = 0.04):
    """Plain PyTorch version: [C,H,W] -> (response, nms), both [C,H,W]."""
    resp = harris_response_reference(img, k)
    return resp, nms3_reference(resp)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    from okvis2_torch.ops._build import load_library

    lib = load_library("harris_nms")
    lib.harris_nms_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_void_p,
    ]
    lib.harris_nms_launch.restype = ctypes.c_int
    return lib


def harris_nms_cuda(img: torch.Tensor, k: float = 0.04):
    """[C,H,W] float32 CUDA stack -> (response, nms) from the CUDA kernel.

    Raises on anything the kernel does not take; there is no fallback.
    Each launch adds one to ``harris_nms_cuda.launches``.
    """
    if not img.is_cuda:
        raise ValueError("harris_nms_cuda: input must be a CUDA tensor")
    if img.dtype != torch.float32:
        raise ValueError(f"harris_nms_cuda: float32 required, got {img.dtype}")
    if img.dim() != 3:
        raise ValueError(f"harris_nms_cuda: [C,H,W] required, got {tuple(img.shape)}")
    if not img.is_contiguous():
        raise ValueError("harris_nms_cuda: input must be contiguous")
    C, H, W = img.shape
    if C == 0 or H == 0 or W == 0:
        raise ValueError(f"harris_nms_cuda: unsupported shape {tuple(img.shape)}")
    lib = _library()
    resp = torch.empty_like(img)
    nms = torch.empty_like(img)
    with torch.cuda.device(img.device):
        stream = torch.cuda.current_stream(img.device).cuda_stream
        err = lib.harris_nms_launch(
            img.data_ptr(), resp.data_ptr(), nms.data_ptr(),
            C, H, W, float(k), stream,
        )
    if err == -1:
        raise ValueError(f"harris_nms_cuda: the kernel's grid cannot hold shape {tuple(img.shape)}")
    if err != 0:
        raise RuntimeError(f"harris_nms_cuda: launch failed (cudaError {err})")
    harris_nms_cuda.launches += 1
    return resp, nms


harris_nms_cuda.launches = 0
