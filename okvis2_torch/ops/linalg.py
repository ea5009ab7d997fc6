"""Small dense linear-algebra helpers (port of ``okvis2_tpu/ops/linalg.py``).

Every solve in the framework is SPD (normal equations, covariances), so
everything goes through Cholesky or adjugate forms; no LU, as in the
reference.
"""

from __future__ import annotations

import torch


def inv3x3(A: torch.Tensor) -> torch.Tensor:
    """Closed-form adjugate inverse of [..., 3, 3] matrices."""
    a = A[..., 0, 0]; b = A[..., 0, 1]; c = A[..., 0, 2]
    d = A[..., 1, 0]; e = A[..., 1, 1]; f = A[..., 1, 2]
    g = A[..., 2, 0]; h = A[..., 2, 1]; i = A[..., 2, 2]
    A11 = e * i - f * h
    A12 = c * h - b * i
    A13 = b * f - c * e
    A21 = f * g - d * i
    A22 = a * i - c * g
    A23 = c * d - a * f
    A31 = d * h - e * g
    A32 = b * g - a * h
    A33 = a * e - b * d
    det = a * A11 + b * A21 + c * A31
    safe_det = torch.where(det.abs() > 1e-300, det, torch.ones_like(det))
    adj = torch.stack(
        [
            torch.stack([A11, A12, A13], dim=-1),
            torch.stack([A21, A22, A23], dim=-1),
            torch.stack([A31, A32, A33], dim=-1),
        ],
        dim=-2,
    )
    return adj / safe_det[..., None, None]


def _cholesky(A: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor; NaN where A is not positive definite, as the
    reference's Cholesky gives (the LM loop then rejects the step). It
    neither raises nor waits for the device."""
    L, info = torch.linalg.cholesky_ex(A)
    return torch.where((info == 0)[..., None, None], L, torch.nan)


def spd_solve(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve A x = b for SPD A [..., n, n], b [..., n] via Cholesky."""
    return torch.cholesky_solve(b[..., None], _cholesky(A))[..., 0]


def spd_inverse_sqrt(P: torch.Tensor) -> torch.Tensor:
    """U with U^T U = P^{-1} for SPD P, as U = L^{-1} (L = chol(P))."""
    L = _cholesky(P)
    eye = torch.eye(P.shape[-1], dtype=P.dtype, device=P.device).expand(P.shape)
    return torch.linalg.solve_triangular(L, eye, upper=False)
