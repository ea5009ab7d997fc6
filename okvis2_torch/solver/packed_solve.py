"""Window solve with one flat readback, and the pipelined loop's fused solve.

Port of ``okvis2_tpu/solver/packed_solve.py``: the host packs the window
into a ``WindowProblem`` of numpy arrays (``Estimator.pack_np``),
``problem_to_device`` copies it to the device leaf by leaf, the LM solve
runs there, and ``solve_packed`` returns only the solved outputs and the
stats as one flat tensor: one device-to-host copy per solve.

The pipelined loop's solve, ``solve_packed_fused`` (the JAX package's
``solve_packed_fused_carrier`` without its uint8 carrier), first appends
the match rows of every frame still in flight to the packed observations
on the device (``_append_matches_all``): the host has not inserted them
yet. It returns ``[solve output | frame diagnostics]``. ``SolveWorker``
runs these solves in dispatch order on one thread and, on the card, on a
stream of its own, so the host goes on with the next frame meanwhile.

The JAX package also packs the input into one flat float carrier (ints
stored as floats), to make one host-to-device transfer of the whole
problem; the port copies the leaves one by one (the estimator's ``3.15
upload`` stage), and the pipelined solve's side inputs (slot maps, window
slots, weight scales) are tensors of their own.
"""

from __future__ import annotations

import dataclasses
import time
from concurrent.futures import Future, ThreadPoolExecutor

import numpy as np
import torch

from okvis2_torch.imu.preintegration import Preintegrated
from okvis2_torch.solver.gauss_newton import solve_window
from okvis2_torch.solver.window_problem import SolverConfig, WindowProblem
from okvis2_torch.utils.timing import Timing

# How many not-yet-finished frames' match rows a fused solve can append on
# the device: the pipelined loop keeps up to MAX_APPEND_SETS - 1 frames in
# flight plus the current one.
MAX_APPEND_SETS = 3


def problem_to_device(problem_np: WindowProblem, device, dtype) -> WindowProblem:
    """A WindowProblem whose leaves are numpy arrays, on ``device``: float
    leaves in ``dtype``, indices as int64, masks as bool. Every leaf is a
    copy (``pack_np`` reuses some of its buffers at the next pack, while a
    pipelined solve may still read this problem)."""

    def conv(a):
        a = np.asarray(a)
        if a.dtype == np.bool_:
            return torch.from_numpy(a).to(device, copy=True)
        if np.issubdtype(a.dtype, np.integer):
            return torch.from_numpy(a.astype(np.int64)).to(device)
        return torch.from_numpy(a).to(device=device, dtype=dtype, copy=True)

    kw = {}
    for f in WindowProblem._FIELDS:
        v = getattr(problem_np, f)
        kw[f] = (Preintegrated(*(conv(getattr(v, g.name)) for g in dataclasses.fields(v)))
                 if f == "imu_pre" else conv(v))
    return WindowProblem(**kw)


def _flat_output(solved: WindowProblem, stats, n_obs: torch.Tensor) -> torch.Tensor:
    """pose | speed_bias | landmarks | extrinsics | 5 stats (initial cost,
    final cost, iterations, lambda, observation rows)."""
    dtype = solved.pose.dtype
    return torch.cat([
        solved.pose.reshape(-1),
        solved.speed_bias.reshape(-1),
        solved.landmarks.reshape(-1),
        solved.extrinsics.reshape(-1),
        torch.stack([
            stats["initial_cost"].to(dtype),
            stats["final_cost"].to(dtype),
            torch.tensor(float(stats["iterations"]), dtype=dtype, device=solved.pose.device),
            stats["lambda"].to(dtype),
            n_obs.to(dtype),
        ]),
    ])


def solve_packed(problem: WindowProblem, cameras, imu_params,
                 config: SolverConfig) -> torch.Tensor:
    """LM solve -> ONE flat output on the problem's device: pose |
    speed_bias | landmarks | extrinsics | 5 stats (initial cost, final
    cost, iterations, lambda, observation rows used)."""
    solved, stats = solve_window(problem, cameras, imu_params, config)
    return _flat_output(solved, stats, torch.sum(problem.obs_mask))


def _append_matches_all(problem: WindowProblem, match_sets, maps: torch.Tensor,
                        w_scale: torch.Tensor, cur_slots: torch.Tensor,
                        n_obs_base: torch.Tensor):
    """Append every in-flight frame's match rows to the packed observations
    on the device: the host has not inserted these matches yet, so they go
    from the frame programs' outputs straight into the window problem.

    ``match_sets``: K tuples (idx [NC,cap] keypoint per table slot, keep
    [NC,cap] RANSAC survivors, xy [NC,N,2], size [NC,N]); ``maps`` [K,cap]
    table slot -> solver landmark slot (-1: none; an all -1 row disables a
    set); ``w_scale`` [cap] per-slot sqrt(info_scale); ``cur_slots`` [K]
    each set's window slot; ``n_obs_base`` [] the first free row.

    All K sets land in one row scatter of a combined [K*NC*cap, 8] payload
    in the observations' float dtype (indices and masks are exact there,
    and are rounded on the way back); the rows are placed by one cumsum
    over the valid flags, rows past the capacity O are dropped, and the
    returned row count still counts them (the host warns when it exceeds
    O). Returns (problem, row count)."""
    O = problem.obs_mask.shape[0]
    fdt = problem.obs_uv.dtype
    dev = problem.obs_uv.device
    payloads, valids = [], []
    for k, (idx, keep, xy, size) in enumerate(match_sets):
        NC, cap = idx.shape
        valid = (keep & (maps[k] >= 0)[None, :]).reshape(-1)
        kp = idx.reshape(-1).long()
        ci = torch.arange(NC, device=dev).repeat_interleave(cap)
        uv = xy[ci, kp].to(fdt)
        sz = size[ci, kp]
        w = (8.0 / torch.clamp(sz, min=1e-6)).to(fdt) * w_scale.to(fdt).repeat(NC)
        lm_slot = torch.clamp(maps[k], min=0).repeat(NC)
        cur = cur_slots[k].expand(ci.shape)
        payloads.append(torch.stack([
            cur.to(fdt), ci.to(fdt), lm_slot.to(fdt), uv[:, 0], uv[:, 1], w,
            torch.ones_like(w),   # mask
            torch.zeros_like(w),  # pad to 8 lanes
        ], dim=1))
        valids.append(valid)
    vflat = torch.cat(valids)  # [K*NC*cap]
    payload = torch.cat(payloads)  # [K*NC*cap, 8]
    pos = n_obs_base + torch.cumsum(vflat.long(), 0) - 1
    # invalid and overflowing rows go to a spare row O, dropped below
    tgt = torch.where(vflat, torch.clamp(pos, max=O), O)
    m = torch.stack([
        problem.obs_state.to(fdt), problem.obs_cam.to(fdt), problem.obs_lm.to(fdt),
        problem.obs_uv[:, 0], problem.obs_uv[:, 1], problem.obs_sqrt_info.to(fdt),
        problem.obs_mask.to(fdt), torch.zeros(O, dtype=fdt, device=dev),
    ], dim=1)  # [O,8]
    m = torch.cat([m, torch.zeros((1, 8), dtype=fdt, device=dev)])
    m[tgt] = payload
    m = m[:O]
    problem = problem.replace(
        obs_state=torch.round(m[:, 0]).to(problem.obs_state.dtype),
        obs_cam=torch.round(m[:, 1]).to(problem.obs_cam.dtype),
        obs_lm=torch.round(m[:, 2]).to(problem.obs_lm.dtype),
        obs_uv=m[:, 3:5].to(problem.obs_uv.dtype),
        obs_sqrt_info=m[:, 5].to(problem.obs_sqrt_info.dtype),
        obs_mask=m[:, 6] > 0.5,
    )
    return problem, n_obs_base + vflat.sum()


def solve_packed_fused(problem: WindowProblem, aux: dict, match_sets, diag: torch.Tensor,
                       cameras, imu_params, config: SolverConfig) -> torch.Tensor:
    """The pipelined loop's solve: append every in-flight frame's match rows
    (``aux``: "maps", "w_scale", "cur_slots", "n_obs_base" tensors, as
    ``_append_matches_all`` takes them; ``match_sets`` oldest first), solve,
    and return ONE flat tensor [solve output | ``diag``], the frame
    program's diagnostics in the solve's dtype. The fifth stat is the final
    row count, appends included."""
    problem, n_obs = _append_matches_all(problem, match_sets, aux["maps"], aux["w_scale"],
                                         aux["cur_slots"], aux["n_obs_base"])
    solved, stats = solve_window(problem, cameras, imu_params, config)
    out = _flat_output(solved, stats, n_obs)
    return torch.cat([out, diag.to(out.dtype).reshape(-1)])


class SolveWorker:
    """One thread that runs jobs in submission order (the pipelined loop's
    fused solves), so the host goes on with the next frame meanwhile.

    On the card each job runs on the worker's own stream: it first waits
    for an event recorded on the submitting thread's stream when the job
    was submitted (after the frame program and the uploads it reads), and
    its flat result comes back through pinned memory before the job
    returns. On the CPU the same thread runs the same jobs without streams.
    The caller keeps every input tensor referenced until it has read the
    job's result. ``submit`` returns a ``Future`` whose ``result()``
    returns the numpy copy or raises the job's exception."""

    def __init__(self, device):
        self.device = torch.device(device)
        self._pool = ThreadPoolExecutor(max_workers=1, thread_name_prefix="okvis2-solve")
        self._stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None

    def submit(self, fn, *args) -> Future:
        ready = None
        if self._stream is not None:
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(self.device))
        return self._pool.submit(self._run, ready, fn, args)

    def _run(self, ready, fn, args) -> np.ndarray:
        t0 = time.perf_counter()
        if self._stream is None:
            out = fn(*args).numpy()
        else:
            with torch.cuda.stream(self._stream):
                self._stream.wait_event(ready)
                dev_out = fn(*args)
                host = torch.empty(dev_out.shape, dtype=dev_out.dtype, pin_memory=True)
                host.copy_(dev_out, non_blocking=True)
            self._stream.synchronize()
            out = host.numpy()
        if Timing.enabled:
            Timing.add("3.2 fused solve (worker)", time.perf_counter() - t0)
        return out

    def close(self):
        self._pool.shutdown(wait=True)


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
