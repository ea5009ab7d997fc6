"""One run of one cell: build the system from the cell's configuration,
drive it with the cell's traffic, measure the window, check what the timed
path produced, and return the result line.

Everything a cell needs is found by name: ``BENCHMARK.json`` names the
cell's configuration (``slambench/configs/<name>.json``) and traffic
(``slambench/traffic/<name>.json``); each metric is read by
``slambench/metrics/<name>.py``; the cell's correctness limits are in
``slambench/limits/<cell>.json``.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import os
import sys
import time

import numpy as np

from slambench.generator import HERE, load_json

ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "okvis2_tpu")


def benchmark() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def reader(name: str):
    """``slambench/metrics/<name>.py``'s ``read``."""
    path = os.path.join(HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"slambench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def metrics_of(bench: dict, workload: str, kind: str):
    """The metrics of ``kind`` ("end_to_end" or "per_layer") that the cell
    reports."""
    return [m for m in bench[kind] if workload in m.get("workloads", [workload])]


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def lm_settings(config: dict, prog_iterations: int) -> dict:
    """The reference's LM settings for one solve, from the configuration
    file alone: its frozen ``solver`` settings and its iteration budget.
    Under ``enforce_realtime`` the deployment's time budget ends a solve
    anywhere between the minimum and the maximum, so the reference takes
    the program's count held to that range; otherwise the maximum."""
    it = config["iterations"]
    budget = it["max"]
    if it["enforce_realtime"]:
        budget = min(max(int(prog_iterations), it["min"]), it["max"])
    settings = {k: v for k, v in config["solver"].items() if k != "about"}
    settings["max_iterations"] = budget
    return settings


def _decode(out, S: int, L: int, NC: int) -> dict:
    """The window solve's flat answer: pose | speed_bias | landmarks |
    extrinsics | initial cost, final cost, iterations, lambda, rows."""
    o = 0
    d = {}
    for k, n, w in (("pose", S, 7), ("speed_bias", S, 9), ("landmarks", L, 4),
                    ("extrinsics", NC, 7)):
        d[k] = out[o:o + n * w].reshape(n, w)
        o += n * w
    d["iterations"] = float(out[o + 2])
    return d


def run_cell(workload: str, seed: int, seconds: float, trace: bool, t_start: float,
             device=None, overrides=None, log=print, control: bool = False):
    """(the result dict of one run (see ``run.py``), every number the checks
    computed). ``device``: None for the card; ``overrides`` (CPU rehearsals
    only) shrink the rig and the checks; ``control``: the program with TF32
    matrix products and convolutions switched on, the precision below the
    configuration's float32, whose run the checks must refuse."""
    import torch

    from slambench import drive, system, trace as tr
    from slambench.generator import Stream
    from slambench.reference import check

    bench = benchmark()
    cell = next(w for w in bench["workloads"] if w["name"] == workload)
    config = load_json("configs", cell["config"])
    traffic = load_json("traffic", cell["traffic"])
    limits = load_json("limits", workload)
    ov = overrides or {}
    dev = torch.device(device or "cuda")
    torch.manual_seed(seed)
    rig = config["rig"]
    if "scale" in ov:
        rig = system.scaled_rig(rig, ov["scale"])
    for k in ("warmup_frames", "trace_frames", "check_solves"):
        if k in ov:
            traffic[k] = ov[k]

    from okvis2_torch.utils.timing import Timing

    stream = Stream(traffic, rig, seed, dev)
    slam = system.build(config, dev, ov)
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    if control:
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    taps = drive.Taps(seed, n_detections=4, n_solves=traffic["check_solves"])
    taps.install()
    ctx = {"rig": rig}
    try:
        run = drive.LoopRun(slam, stream, dev)
        run.warm(traffic["warmup_frames"])
        ctx["setup_s"] = time.time() - t_start
        Timing.reset()
        taps.on = True
        lost = [0]

        def on_frame(_fr):
            lost[0] += slam.tracking.tracking_quality == "Lost"

        ctx["inside_s"] = run.window(seconds, on_frame)
        taps.on = False
        ctx.update(frame_s=run.frame_s, keyframes=len(run.keyframes))
        ctx["timing"] = {n: (s.total, s.n) for n, s in Timing._timers.items()}
        peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
        est = slam.estimator
        S, L, NC = est.cfg.window_slots, est.cfg.landmark_slots, len(est.cameras)
        log(f"[slambench] {workload} seed {seed}: set-up {ctx['setup_s']:.3f} s, window "
            f"{ctx['inside_s']:.3f} s inside the port's calls, {len(run.frame_s)} frames "
            f"({ctx['keyframes']} keyframes), generation off the clock {run.gen_s:.3f} s")

        iters = [int(_decode(o.detach(), S, L, NC)["iterations"]) for o in taps.outs]
        ctx["lm_iterations"] = iters
        log(f"[slambench] LM iterations per window solve: "
            f"{json.dumps({n: iters.count(n) for n in sorted(set(iters))})}")
        if trace:
            if dev.type != "cuda":
                raise RuntimeError("a traced run needs the card")
            frames = [run._generate() for _ in range(traffic["trace_frames"])]
            ctx["trace"] = tr.traced(lambda: run.run_frames(frames), Timing)
            ctx["traced_frames"] = len(frames)

        # ---- correctness, after the window and the peak reading ----------
        numbers = {"ate_m": check.umeyama_ate(*run.trajectory())}
        weights = os.path.join(ROOT, config["cnn_weights"]) if slam.cnn is not None else None
        del slam, run, stream, est
        taps.outs.clear()
        taps.remove()
        # the references run at their own precision
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        t_check = time.perf_counter()
        dets = [d for _i, d in taps.detections.items()]
        numbers.update(check.detection(dets, max_keypoints=dets[0][1]["xy"].shape[1]))
        median_leaf = []
        for i, (problem, out) in taps.solves.items():
            prog = _decode(out.detach().double(), S, L, NC)
            g = check.solve(problem, prog, rig, lm_settings(config, prog["iterations"]), dev)
            log(f"[slambench] solve {i}: {json.dumps(g)}")
            g["step_gap_worst"] = g["step_gap"]
            for key in ("pose_m", "lm_rel", "vel_mps", "bias_g", "bias_a", "step_gap_worst",
                        "cost_gap"):
                numbers[f"solve_{key}"] = max(numbers.get(f"solve_{key}", -np.inf), g[key])
            short = g["iterations"][1] - g["iterations"][0]
            numbers["solve_iter_short"] = max(numbers.get("solve_iter_short", -np.inf), short)
            median_leaf.append(g["step_gap_median_leaf"])
        if median_leaf:
            # steady from seed to seed: the worst leaf of the worst solve swings
            # with the one solve whose float32 and float64 LM paths part
            numbers["solve_step_gap"] = float(np.median(median_leaf))
        if weights is not None:
            numbers.update(check.cnn(taps.logits, weights, dev))
        log(f"[slambench] checks took {time.perf_counter() - t_check:.3f} s")
    finally:
        taps.remove()
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32

    # a number that was never read (no solve in the window) fails its limit
    checks = {n: {"value": float(numbers.get(n, np.nan)), "limit": lim}
              for n, lim in limits.items()}
    correct = all(np.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in metrics_of(bench, workload, kind):
        v = reader(m["name"])(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                   "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": len(ctx["frame_s"]), "failed": lost[0],
              "metrics": metrics, "device": device_info}
    if trace and ctx.get("trace"):
        device_info["busy_s"] = ctx["trace"]["busy_s"]
        device_info["window_s"] = ctx["trace"]["window_s"]
        result["breakdown"] = tr.breakdown(ctx["trace"])
    result["checks"] = checks
    return result, numbers
