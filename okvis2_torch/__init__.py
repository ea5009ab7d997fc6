"""okvis2_torch — the PyTorch/CUDA port of okvis2_tpu for NVIDIA Hopper.

The package mirrors ``okvis2_tpu``'s layout and names, module for module,
so a reader finds each counterpart at the same path. It imports torch and
numpy only; the JAX package is the reference that the tests hold it
against and is never imported here.

Device rule: entry points that create state (``build_problem``,
``PinholeCamera.create``, ``WindowProblem.empty``, the ``interop``
converters) take ``device=None``, and ``None`` means the CUDA card. Without
a card they raise instead of dropping to the CPU; CPU work is asked for
explicitly with ``device="cpu"``.
"""

from __future__ import annotations

import functools
import threading

import torch

__version__ = "0.1.0"

# The solver's normal equations and the IMU covariance propagation are
# precision-critical in float32 (the reference forces "highest" matmul
# precision for the same reason, okvis2_tpu/__init__.py). TF32 keeps ~3
# decimal digits, so it is off for both matmuls and cuDNN convolutions.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")


def resolve_device(device=None) -> torch.device:
    """``None`` -> the CUDA card (raises when there is none); anything
    else is taken as given, so ``"cpu"`` must be asked for explicitly."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "okvis2_torch: no CUDA device available; pass device='cpu' "
                "to run on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)


# torch.func's forward mode (jacfwd, jvp) counts its nesting in a module
# global and opens one process-wide dual level for the outermost call, so
# two threads must not run it at the same time: the pipelined loop's solve
# worker linearises while the host thread may compute a two-pose factor or
# a synthetic trajectory's derivatives. Every function of the port that
# runs forward mode holds this lock (re-entrant: nested jacfwd).
FORWARD_AD_LOCK = threading.RLock()


def forward_ad_locked(fn):
    """``fn`` run under ``FORWARD_AD_LOCK``."""

    @functools.wraps(fn)
    def locked(*args, **kwargs):
        with FORWARD_AD_LOCK:
            return fn(*args, **kwargs)

    return locked
