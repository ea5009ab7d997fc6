"""Landmark-sharded bundle adjustment over a ``torch.distributed`` group.

Port of ``okvis2_tpu/parallel/sharded_ba.py``. The reference has no
distributed backend (its analogue is the background full-graph thread,
ViSlamBackend.cpp:1726-1757); the JAX package scales the full-graph /
final-BA solve over a device mesh, and this module does the same over the
ranks of a process group (NCCL across GPUs, gloo on the CPU or for several
ranks on one card):

- landmarks and their observations are sharded (each observation lands in
  its landmark's shard, so the landmark Schur blocks never cross ranks);
- states are replicated;
- each LM iteration sums the observation terms over the group
  (``solver/gauss_newton.py`` with ``group``); the reduced system is
  solved replicated on every rank, the landmark back-substitution stays
  local, and the landmark blocks are gathered once at the end.

SPMD: every rank calls ``solve_full_graph_sharded`` with the same sharded
problem and gets the same replicated result.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from okvis2_torch import resolve_device
from okvis2_torch.imu.preintegration import ImuParameters
from okvis2_torch.solver.gauss_newton import _sum_over, solve_window
from okvis2_torch.solver.window_problem import SolverConfig, WindowProblem

_LM_FIELDS = ("landmarks", "lm_mask", "lm_prior", "lm_prior_sqrt", "lm_prior_mask")
_OBS_FIELDS = ("obs_state", "obs_cam", "obs_lm", "obs_uv", "obs_sqrt_info", "obs_mask")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The ranks of one process group: this process's ``rank`` of
    ``size``, computing on ``device``."""

    group: object
    rank: int
    size: int
    device: torch.device


def make_mesh(n_devices: Optional[int] = None, group=None, device=None) -> Mesh:
    """A Mesh over ``group`` (None: the default group) of an initialised
    ``torch.distributed``; ``n_devices``, when given, must be its size.
    ``device`` is where this rank computes (None: the current CUDA card;
    raises without one)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: torch.distributed is not initialised")
    group = group if group is not None else dist.group.WORLD
    size = dist.get_world_size(group)
    if n_devices is not None and n_devices != size:
        raise ValueError(f"make_mesh: {n_devices} devices asked, the group has {size} ranks")
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return Mesh(group=group, rank=dist.get_rank(group), size=size, device=dev)


def _pad_rows(a: np.ndarray, n: int) -> np.ndarray:
    if a.shape[0] >= n:
        return a[:n]
    pad = np.zeros((n - a.shape[0],) + a.shape[1:], dtype=a.dtype)
    if a.dtype == np.float64 and a.ndim == 2 and a.shape[1] == 4:
        pad[:, 3] = 1.0  # homogeneous points stay valid (float64 only, as in JAX)
    return np.concatenate([a, pad])


def shard_problem_by_landmark(problem: WindowProblem, n_shards: int) -> WindowProblem:
    """Re-pack so that landmarks lie in contiguous per-shard blocks and each
    observation lands in its landmark's shard (on the host, numpy).

    L is padded to a multiple of ``n_shards``; each shard's observations
    are padded to a common count, a multiple of 8. Landmark indices stay
    global; ``solve_full_graph_sharded`` makes them local. The result is
    on ``problem``'s device."""
    dev = problem.pose.device
    host = lambda f: getattr(problem, f).cpu().numpy()  # noqa: E731
    L = problem.L
    Lp = -(-L // n_shards) * n_shards
    lm_per = Lp // n_shards
    obs_lm, obs_mask = host("obs_lm"), host("obs_mask")
    shard_of_obs = np.where(obs_mask, obs_lm // lm_per, -1)
    per_shard = [np.nonzero(shard_of_obs == k)[0] for k in range(n_shards)]
    o_per = max(max((len(p) for p in per_shard), default=1), 1)
    o_per = -(-o_per // 8) * 8  # pad for tiling
    Op = o_per * n_shards

    def gather_obs(field, fill=0):
        src = host(field)
        out = np.full((Op,) + src.shape[1:], fill, dtype=src.dtype)
        for k, idx in enumerate(per_shard):
            out[k * o_per:k * o_per + len(idx)] = src[idx]
        return out

    new = {f: _pad_rows(host(f), Lp) for f in _LM_FIELDS}
    new.update({f: gather_obs(f) for f in _OBS_FIELDS})
    new["obs_sqrt_info"] = gather_obs("obs_sqrt_info", fill=1)
    new["obs_mask"] = gather_obs("obs_mask", fill=False)
    return problem.replace(**{f: torch.from_numpy(a).to(dev) for f, a in new.items()})


def solve_full_graph_sharded(problem: WindowProblem, cameras, imu_params: ImuParameters,
                             mesh: Mesh, config: SolverConfig = SolverConfig(),
                             n_iterations: int = 15):
    """Sharded LM solve of the full graph (the reference's
    optimiseFullGraph runs 15 iterations, config/euroc.yaml:85). SPMD:
    every rank of ``mesh`` calls it with the same ``problem``, already
    re-packed by ``shard_problem_by_landmark``. Each rank solves its
    landmark and observation block on ``mesh.device``; the landmark blocks
    are gathered at the end. Returns (the solved problem, replicated on
    every rank, on ``mesh.device``; the stats of ``solve_window``, with
    "collectives")."""
    n, r, dev = mesh.size, mesh.rank, mesh.device
    lm_per, o_per = problem.L // n, problem.O // n
    lm_blk, o_blk = slice(r * lm_per, (r + 1) * lm_per), slice(r * o_per, (r + 1) * o_per)
    local = problem.replace(**{f: getattr(problem, f)[lm_blk] for f in _LM_FIELDS},
                            **{f: getattr(problem, f)[o_blk] for f in _OBS_FIELDS}).to(device=dev)
    # global landmark ids -> this shard's (padding rows point at row 0)
    local = local.replace(obs_lm=torch.where(local.obs_mask, local.obs_lm - r * lm_per,
                                             torch.zeros_like(local.obs_lm)))
    out, stats = solve_window(local, tuple(c.to(device=dev) for c in cameras),
                              imu_params.to(device=dev),
                              dataclasses.replace(config, max_iterations=n_iterations),
                              group=mesh.group)
    # every rank's landmark block, gathered by one all-reduce over zeros
    landmarks = torch.zeros((problem.L, 4), dtype=out.landmarks.dtype, device=dev)
    landmarks[lm_blk] = out.landmarks
    (landmarks,) = _sum_over(mesh.group, landmarks)
    stats["collectives"] += 1
    solved = problem.to(device=dev).replace(pose=out.pose, speed_bias=out.speed_bias,
                                            extrinsics=out.extrinsics, landmarks=landmarks)
    return solved, stats
