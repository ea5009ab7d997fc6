"""Descriptor matching as one matrix product.

Port of ``okvis2_tpu/frontend/matching.py``. For sign vectors a, b in
{-1,+1}^B, hamming(a, b) = (B - a.b) / 2, so one [N,B] x [B,M] product gives
the whole distance matrix. The product of ±1 values is exact in float32
(TF32 is off package-wide; the sums are integers below 2^24). Mutual-best
selection with a Hamming threshold follows; ``argmin`` returns the first
minimum on ties, as ``jnp.argmin`` does.
"""

from __future__ import annotations

import torch

from okvis2_torch.frontend.descriptor import DESCRIPTOR_BITS


def hamming_distance_matrix(signs_a: torch.Tensor, signs_b: torch.Tensor) -> torch.Tensor:
    """[N,M] Hamming distances (float). Invalid (0) rows give B/2."""
    dot = torch.matmul(signs_a, signs_b.T)
    return 0.5 * (DESCRIPTOR_BITS - dot)


def match_descriptors(
    signs_a: torch.Tensor,
    mask_a: torch.Tensor,  # [N] bool
    signs_b: torch.Tensor,
    mask_b: torch.Tensor,  # [M] bool
    max_distance: int = 60,  # matching threshold (config/euroc.yaml:65)
    gate: torch.Tensor | None = None,  # [N,M] bool extra gating
):
    """Mutual-nearest matching with a Hamming threshold.

    Returns dict:
      idx_b  [N] int32: best match in b for each a (or -1)
      dist   [N] float: its distance
      valid  [N] bool
    """
    d = hamming_distance_matrix(signs_a, signs_b)
    m = mask_a[:, None] & mask_b[None, :]
    if gate is not None:
        m = m & gate
    d = torch.where(m, d, torch.full_like(d, 1e9))

    best_b = torch.argmin(d, dim=1)  # first minimum on ties
    best_d = torch.gather(d, 1, best_b[:, None])[:, 0]
    best_a_of_b = torch.argmin(d, dim=0)
    mutual = best_a_of_b[best_b] == torch.arange(d.shape[0], device=d.device)
    valid = mutual & (best_d <= max_distance) & mask_a
    return {
        "idx_b": torch.where(valid, best_b, torch.full_like(best_b, -1)).to(torch.int32),
        "dist": best_d,
        "valid": valid,
    }
