"""Two-view triangulation, batched over any leading shape.

Port of ``okvis2_tpu/frontend/triangulation.py``: the reference's fast
closed-form midpoint triangulation (okvis_frontend/src/
stereo_triangulation.cpp:50-132 triangulateFast). Given two rays (unit
directions) and their origins, find the homogeneous midpoint and classify
parallel / invalid rays.
"""

from __future__ import annotations

import torch

from okvis2_torch.core.se3 import Transformation


def triangulate_midpoint(
    p_A: torch.Tensor,  # [...,3] origin of ray 1 (in frame A)
    e_A: torch.Tensor,  # [...,3] unit direction of ray 1 (in A)
    p_B: torch.Tensor,  # [...,3] origin of ray 2 (in A!)
    e_B: torch.Tensor,  # [...,3] unit direction of ray 2 (in A)
    sigma: float = 1e-3,  # angular uncertainty (rad)
):
    """Midpoint triangulation of two rays, all quantities in frame A.

    Returns (hp [...,4] homogeneous point, valid [...], parallel [...]):
    parallel rays get a far-point representation (direction, w = 1e-3)
    as the reference returns (e1+e2, 1e-3) for parallel geometry.
    """
    t = p_B - p_A
    e1, e2 = e_A, e_B
    # solve [e1 -e2] [l1 l2]^T = t in least squares (2x2 normal equations)
    a = torch.sum(e1 * e1, dim=-1)
    b = -torch.sum(e1 * e2, dim=-1)
    c = torch.sum(e2 * e2, dim=-1)
    d1 = torch.sum(t * e1, dim=-1)
    d2 = -torch.sum(t * e2, dim=-1)
    det = a * c - b * b
    cross = torch.linalg.cross(e1, e2, dim=-1)
    sin2 = torch.sum(cross * cross, dim=-1)
    parallel = sin2 < (sigma * sigma)
    safe_det = torch.where(parallel, torch.ones_like(det), det)
    l1 = (c * d1 - b * d2) / safe_det
    l2 = (a * d2 - b * d1) / safe_det
    x1 = p_A + l1[..., None] * e1
    x2 = p_B + l2[..., None] * e2
    mid = 0.5 * (x1 + x2)

    # parallel: represent as a far point along the mean direction
    far = 0.5 * (e1 + e2)
    xyz = torch.where(parallel[..., None], far, mid)
    w = torch.where(parallel, torch.full_like(det, 1e-3), torch.ones_like(det))
    hp = torch.cat([xyz, w[..., None]], dim=-1)

    # validity: both depths positive (in front) unless parallel
    valid = parallel | ((l1 > 0.0) & (l2 > 0.0))
    return hp, valid, parallel


def triangulate_in_frames(
    T_WA: Transformation,
    T_WB: Transformation,
    ray_A: torch.Tensor,  # [...,3] unit rays in camera frame A
    ray_B: torch.Tensor,  # [...,3] unit rays in camera frame B
    sigma: float = 1e-3,
):
    """Triangulate in world coordinates from two camera poses (each a
    single pose or batched like the rays)."""
    e_A = (T_WA.C @ ray_A[..., None])[..., 0]
    e_B = (T_WB.C @ ray_B[..., None])[..., 0]
    return triangulate_midpoint(
        T_WA.r.expand(e_A.shape), e_A, T_WB.r.expand(e_B.shape), e_B, sigma,
    )
