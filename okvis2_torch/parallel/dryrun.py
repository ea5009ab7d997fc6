"""SPMD runs of the sharded solve in spawned processes, and the multi-device
dry run.

``run_spmd`` starts one process per rank (``torch.multiprocessing``'s
spawn context), joins them into a process group and calls one function on
every rank. ``dryrun_multichip`` is the counterpart of
``__graft_entry__.dryrun_multichip``: the landmark-sharded full-graph
solve on the smallest problem that still has every factor type, as a
correctness check. ``solve_saved_pack`` and ``final_ba_saved_session``
are rank functions over inputs the caller wrote to a file (a float64 pack
from ``save_pack``, a pickled ``Estimator``), so that every rank starts
from the same bytes. The rank functions live here, so that spawned
processes import nothing but this package.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import pickle
import queue
import tempfile
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from okvis2_torch import interop
from okvis2_torch.parallel.sharded_ba import (
    make_mesh,
    shard_problem_by_landmark,
    solve_full_graph_sharded,
)
from okvis2_torch.solver.gauss_newton import problem_cost
from okvis2_torch.solver.window_problem import SolverConfig

# init_process_group's and each join's limit: a hang fails instead of
# stalling the caller
TIMEOUT_S = 60.0


def _rank_main(rank, n, backend, device, init_file, fn, args, results):
    try:
        kw = {}
        if device.startswith("cuda"):
            torch.cuda.set_device(rank % torch.cuda.device_count())
            device = f"cuda:{torch.cuda.current_device()}"
            if backend == "nccl":  # NCCL's rank -> card map, stated
                kw["device_id"] = torch.device(device)
        dist.init_process_group(backend, init_method=f"file://{init_file}", world_size=n,
                                rank=rank, timeout=datetime.timedelta(seconds=TIMEOUT_S), **kw)
        try:
            results.put((rank, True, fn(make_mesh(n, device=device), *args)))
        finally:
            dist.destroy_process_group()
    except BaseException:  # reported to the parent, which raises
        results.put((rank, False, traceback.format_exc()))


def run_spmd(fn, n: int, args=(), backend=None, device="cpu", init_dir=None) -> list:
    """``fn(mesh, *args)`` on ``n`` spawned ranks of one process group;
    returns each rank's result, by rank (results and ``args`` are pickled:
    numpy arrays, not device tensors). ``device``: "cpu", or "cuda" (rank
    r on card r modulo the cards). ``backend``: None takes NCCL when every
    rank has a card of its own, else gloo (two ranks on one card go over
    gloo, which all-reduces CUDA tensors through the host). The group
    meets in a file under ``init_dir`` (None: a temporary directory).
    Raises if a rank fails, or when a rank has not answered within
    TIMEOUT_S of the previous answer."""
    if backend is None:
        per_card = device.startswith("cuda") and torch.cuda.device_count() >= n
        backend = "nccl" if per_card else "gloo"
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(dir=init_dir) as tmp:
        init_file = os.path.join(tmp, "rendezvous")
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(r, n, backend, device, init_file, fn, args, results))
                 for r in range(n)]
        for p in procs:
            p.start()
        got, errors = {}, []
        try:
            for _ in range(n):  # drain before joining
                rank, ok, value = results.get(timeout=TIMEOUT_S)
                if ok:
                    got[rank] = value
                else:
                    errors.append(f"rank {rank}:\n{value}")
        except queue.Empty:
            errors.append(f"ranks {sorted(set(range(n)) - set(got))} gave no answer within "
                          f"{TIMEOUT_S:g} s")
        finally:
            for p in procs:
                p.join(TIMEOUT_S)
                if p.is_alive():
                    p.terminate()
                    p.join(TIMEOUT_S)
    if errors:
        raise RuntimeError("run_spmd: " + "\n".join(errors))
    return [got[r] for r in range(n)]


def save_pack(path: str, problem, cameras, imu_params) -> None:
    """A problem with its cameras and IMU parameters, as numpy arrays in
    one ``.npz`` (``load_pack`` reads it back)."""
    arrays = {}
    for f, v in interop.problem_to_numpy(problem).items():
        if f == "imu_pre":
            arrays.update({f"imu_pre/{g}": a for g, a in v.items()})
        else:
            arrays[f"problem/{f}"] = v
    for ci, cam in enumerate(cameras):
        arrays[f"camera{ci}/focal"] = cam.focal.cpu().numpy()
        arrays[f"camera{ci}/center"] = cam.center.cpu().numpy()
        arrays[f"camera{ci}/k"] = cam.distortion.params().cpu().numpy()
        arrays[f"camera{ci}/image_size"] = np.asarray(cam.image_size)
        arrays[f"camera{ci}/distortion"] = np.asarray(type(cam.distortion).__name__)
    arrays.update({f"imu/{f.name}": getattr(imu_params, f.name).cpu().numpy()
                   for f in dataclasses.fields(imu_params)})
    np.savez(path, **arrays)


def load_pack(path: str, device=None):
    """(problem, cameras, imu parameters) saved by ``save_pack``, on
    ``device`` (None: the CUDA card)."""
    with np.load(path, allow_pickle=False) as z:
        d = {k: z[k] for k in z.files}
    fields = {k.split("/", 1)[1]: v for k, v in d.items() if k.startswith("problem/")}
    fields["imu_pre"] = {k.split("/", 1)[1]: v for k, v in d.items() if k.startswith("imu_pre/")}
    n_cams = sum(k.endswith("/focal") for k in d)
    cams = tuple(interop.camera_from_numpy({
        "focal": d[f"camera{ci}/focal"], "center": d[f"camera{ci}/center"],
        "k": d[f"camera{ci}/k"], "image_size": tuple(d[f"camera{ci}/image_size"]),
        "distortion": str(d[f"camera{ci}/distortion"])}, device) for ci in range(n_cams))
    imu = interop.imu_params_from_numpy(
        {k.split("/", 1)[1]: v for k, v in d.items() if k.startswith("imu/")}, device)
    return interop.problem_from_numpy(fields, device), cams, imu


def _device_kernels(fn) -> int:
    """The device kernels ``fn`` launches (torch.profiler, device activity
    only)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages() if e.device_type == DeviceType.CUDA)


def solve_saved_pack(mesh, path: str, n_iterations: int, config: SolverConfig = SolverConfig(),
                     count_kernels: bool = False) -> dict:
    """Rank function: the pack at ``path`` (``save_pack``) on this rank's
    device, sharded over the mesh and solved twice: once to warm the
    process (its first solve pays one-time set-up), then timed. Returns
    numpy {"pose", "landmarks", "cost0", "cost", "iterations",
    "collectives", "ms", "kernels"} (ms: this rank's synchronised wall time
    of the second solve; kernels: with ``count_kernels`` on a card, the
    device kernels of the first solve, run under the profiler, else
    None)."""
    problem, cams, imu = load_pack(path, mesh.device)
    sharded = shard_problem_by_landmark(problem, mesh.size)

    def solve():
        return solve_full_graph_sharded(sharded, cams, imu, mesh, config, n_iterations)

    kernels = None
    if count_kernels and mesh.device.type == "cuda":
        kernels = _device_kernels(lambda: solve()[0].pose.cpu())
    else:
        solve()
    sync = torch.cuda.synchronize if mesh.device.type == "cuda" else (lambda: None)
    sync()
    dist.barrier(group=mesh.group)
    t0 = time.perf_counter()
    solved, stats = solve()
    sync()
    ms = (time.perf_counter() - t0) * 1e3
    return {"pose": solved.pose.cpu().numpy(), "landmarks": solved.landmarks.cpu().numpy(),
            "cost0": float(stats["initial_cost"]), "cost": float(stats["final_cost"]),
            "iterations": stats["iterations"], "collectives": stats["collectives"], "ms": ms,
            "kernels": kernels}


def final_ba_saved_session(mesh, path: str, iterations: int, kw: dict) -> dict:
    """Rank function: ``do_final_ba(mesh=mesh, **kw)`` on the pickled
    ``Estimator`` at ``path`` (a file this program wrote). Returns
    {"info", "poses" {sid: pose}, "landmarks" {lid: hp_W}}."""
    from okvis2_torch.pipeline.final_ba import do_final_ba

    with open(path, "rb") as f:
        est = pickle.load(f)
    info = do_final_ba(est, iterations, mesh=mesh, **kw)
    return {"info": info, "poses": {s: r.pose for s, r in est.states.items()},
            "landmarks": {lid: lm.hp_W for lid, lm in est.landmarks.items()}}


def _dryrun_rank(mesh):
    from okvis2_torch.utils import synthetic

    problem, cams, imu_params, _ = synthetic.build_problem(num_states=4, n_landmarks_side=4,
                                                           device=mesh.device)
    problem = problem.replace(pose_frozen=torch.zeros_like(problem.pose_frozen).index_fill_(
        0, torch.tensor([0], device=mesh.device), True))
    sharded = shard_problem_by_landmark(problem, mesh.size)
    c0 = float(problem_cost(sharded, cams, imu_params))
    solved, stats = solve_full_graph_sharded(sharded, cams, imu_params, mesh,
                                             SolverConfig(initial_lambda=1e-6), n_iterations=2)
    c1 = float(problem_cost(solved, cams, imu_params))
    if not bool(torch.isfinite(solved.pose).all()):
        raise AssertionError("dryrun_multichip: non-finite poses")
    if not c1 <= c0 * 1.5 + 1e-6:
        raise AssertionError(f"dryrun_multichip: cost exploded: {c0} -> {c1}")
    return {"c0": c0, "c1": c1, "iterations": stats["iterations"],
            "collectives": stats["collectives"], "pose": solved.pose.cpu().numpy()}


def dryrun_multichip(n: int, backend=None, device=None, init_dir=None) -> list:
    """The sharded full-graph solve (landmarks and observations sharded,
    states replicated) on ``n`` spawned ranks: ``build_problem(4 states,
    4x4 landmarks)``, 2 LM iterations; each rank asserts finite poses and
    a cost that did not grow by more than half. ``device``: None, the CUDA
    cards (raises without one), or "cpu" (gloo). Returns each rank's
    {"c0", "c1", "iterations", "collectives", "pose"}."""
    device = "cuda" if device is None and torch.cuda.is_available() else device
    if device is None:
        raise RuntimeError("dryrun_multichip: no CUDA device available; pass device='cpu'")
    out = run_spmd(_dryrun_rank, n, backend=backend, device=str(device), init_dir=init_dir)
    print(f"dryrun_multichip({n}): cost {out[0]['c0']:.3e} -> {out[0]['c1']:.3e} OK, "
          f"{out[0]['collectives']} collectives in {out[0]['iterations']} LM iterations")
    return out

