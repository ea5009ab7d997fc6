"""Window solve with one flat readback.

Port of the synchronous half of ``okvis2_tpu/solver/packed_solve.py``:
the host packs the window into a ``WindowProblem`` of numpy arrays
(``Estimator.pack_np``), ``problem_to_device`` copies it to the device
leaf by leaf, the LM solve runs there, and ``solve_packed`` returns only
the solved outputs and the stats as one flat tensor: one device-to-host
copy per solve.

The JAX package also packs the input into one flat float carrier (ints
stored as floats), to make one host-to-device transfer of the whole
problem. The port copies the leaves one by one instead: its LM loop reads
a flag back every iteration anyway, and the copies are timed in the
estimator's ``3.15 upload`` stage. The pipelined loop's carrier, its aux
regions and its device-side match append are not ported here (ROADMAP
A.11).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from okvis2_torch.imu.preintegration import Preintegrated
from okvis2_torch.solver.gauss_newton import solve_window
from okvis2_torch.solver.window_problem import SolverConfig, WindowProblem


def problem_to_device(problem_np: WindowProblem, device, dtype) -> WindowProblem:
    """A WindowProblem whose leaves are numpy arrays, on ``device``: float
    leaves in ``dtype``, indices as int64, masks as bool."""

    def conv(a):
        a = np.asarray(a)
        if a.dtype == np.bool_:
            return torch.from_numpy(a).to(device)
        if np.issubdtype(a.dtype, np.integer):
            return torch.from_numpy(a.astype(np.int64)).to(device)
        return torch.from_numpy(a).to(device=device, dtype=dtype)

    kw = {}
    for f in WindowProblem._FIELDS:
        v = getattr(problem_np, f)
        kw[f] = (Preintegrated(*(conv(getattr(v, g.name)) for g in dataclasses.fields(v)))
                 if f == "imu_pre" else conv(v))
    return WindowProblem(**kw)


def solve_packed(problem: WindowProblem, cameras, imu_params,
                 config: SolverConfig) -> torch.Tensor:
    """LM solve -> ONE flat output on the problem's device: pose |
    speed_bias | landmarks | extrinsics | 5 stats (initial cost, final
    cost, iterations, lambda, observation rows used)."""
    solved, stats = solve_window(problem, cameras, imu_params, config)
    dtype = solved.pose.dtype
    return torch.cat([
        solved.pose.reshape(-1),
        solved.speed_bias.reshape(-1),
        solved.landmarks.reshape(-1),
        solved.extrinsics.reshape(-1),
        torch.stack([
            stats["initial_cost"].to(dtype),
            stats["final_cost"].to(dtype),
            torch.tensor(float(stats["iterations"]), dtype=dtype, device=problem.pose.device),
            stats["lambda"].to(dtype),
            torch.sum(problem.obs_mask).to(dtype),
        ]),
    ])


def decode_solved(out, S: int, L: int, NC: int):
    """Host-side decode of solve_packed's flat output (a tensor on any
    device, or numpy)."""
    if isinstance(out, torch.Tensor):
        out = out.detach().cpu().numpy()
    out = np.asarray(out)
    o = 0
    pose = out[o:o + S * 7].reshape(S, 7); o += S * 7
    sb = out[o:o + S * 9].reshape(S, 9); o += S * 9
    lms = out[o:o + L * 4].reshape(L, 4); o += L * 4
    ext = out[o:o + NC * 7].reshape(NC, 7); o += NC * 7
    stats = {
        "initial_cost": out[o], "final_cost": out[o + 1],
        "iterations": out[o + 2], "lambda": out[o + 3],
        "n_obs": out[o + 4],
    }
    return pose, sb, lms, ext, stats
