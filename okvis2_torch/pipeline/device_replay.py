"""The pipelined loop's frame capture and its device-loop replay.

Port of the JAX bench's capture (``okvis2_tpu/pipeline/slam.py:368-376``)
and of ``bench.py::replay_device_loop`` (:198-275). With
``SlamSystem._bench_record`` set to a list, each pipelined frame appends
``capture``'s record of what its dispatches read. ``replay_device_loop``
runs the recorded frames again, inline on the current stream, with every
input staged on the device before the timed region: the tracking program
(``frame_associate``), its diagnostics (``frame_diag``) and the fused
append + solve (``solve_packed_fused``), the functions the live frame ran.
It reports frames/s with the host's bookkeeping taken out.

A record must hold more than the JAX record's ``prep``, because the port's
dispatch reads state that the next frame changes: the live descriptor
table (replaced, never written in place, by the next dispatch), the RANSAC
generator (advanced by every dispatch) and the previous frame's pose in
the estimator (copied here). The replay leaves the system as it found it:
it adopts nothing, writes no table and draws from a generator of its own,
set to each frame's recorded state.

Each replayed solve appends the match sets of the live solve in the live
order: the frames that were in flight at the dispatch, oldest first, then
the frame itself, padded with the frame. A set comes from this pass's
replay of that frame where the frame is replayed, else from the live
frame's tensors, so that a replay of the last N records is well defined.
(The JAX replay builds ``[the previous two replayed frames] + [current]``,
which differs from the live order whenever fewer frames were in flight.)

The port's solve reads one flag vector per LM iteration, and the tracking
program makes a few scalar constants on the host, so the timed region is
not free of transfers; ``transfer_census`` counts them.
"""

from __future__ import annotations

import bisect
import collections
import json
import math
import os
import tempfile
import time

import numpy as np
import torch
from torch.profiler import record_function

from okvis2_torch.ops.harris_cuda import harris_nms_cuda
from okvis2_torch.pipeline.frontend_pipeline import frame_associate, frame_diag
from okvis2_torch.solver.packed_solve import MAX_APPEND_SETS, solve_packed_fused

MODES = ("full", "frontend", "solve")
_STAGE = "replay "  # the prefix of the replay's profiler ranges


def capture(slam, prep, table_in, gen_state, ctx, job) -> dict:
    """The record of one pipelined frame, made after its dispatches and
    before it joins the frames in flight. ``table_in``: the descriptor
    table (signs, valid) the dispatch read; ``gen_state``: the RANSAC
    generator's state before it; ``ctx``/``job``: the frame's dispatch
    context and solve job. Device tensors are referenced, not copied; the
    one host array the estimator may rewrite (the previous frame's pose)
    is copied. No device work."""
    sid = prep["sid"]
    set_sids = [p["sid"] for p in slam._pending_frames] + [sid]
    set_sids += [sid] * (MAX_APPEND_SETS - len(set_sids))
    problem, aux_dev, live_sets, diag, _, _, config = job["inputs"]
    prev = prep["prev"]
    if prev is not None:
        prev = dict(prev, T_WS7=np.array(prev["T_WS7"], np.float64))
    return {
        "sid": sid, "prep": prep, "scfg": config, "problem": problem, "aux_dev": aux_dev,
        "frame_inputs": {
            "T_SC7": np.stack(slam.frontend.T_SC_np), "images": prep["imgs_u8"],
            "T_WS7": prep["T_WS7"], "landmarks": prep["landmarks"],
            "tab_signs": table_in[0], "tab_valid": table_in[1], "staged": prep["staged"],
            "keyframes": prep["keyframes"], "prev": prev, "sampler": prep["sampler"],
        },
        "gen_state": gen_state,
        "set_sids": set_sids, "live_sets": live_sets, "diag": diag, "job": job,
    }


def live_output(record) -> np.ndarray:
    """The live frame's [solve output | diag], as the loop read it."""
    return record["job"]["future"].result()


def _stage(inputs: dict, dtype, dev) -> dict:
    """``frame_associate``'s inputs on ``dev``, converted once as
    ``frame_associate`` converts them (it then converts nothing)."""

    def t(x, dt=dtype):
        return torch.as_tensor(x, dtype=dt, device=dev)

    def tb(x):
        return torch.as_tensor(x, dtype=torch.bool, device=dev)

    def opt(d, conv):
        return None if d is None else {k: conv[k](v) for k, v in d.items()}

    return {
        "images": torch.as_tensor(inputs["images"], device=dev),
        "T_WS7": t(inputs["T_WS7"]), "T_SC7": t(inputs["T_SC7"]),
        "landmarks": opt(inputs["landmarks"], {"hp": t, "mask": tb, "init": tb}),
        "tab_signs": t(inputs["tab_signs"]), "tab_valid": tb(inputs["tab_valid"]),
        "staged": opt(inputs["staged"], {"signs": t, "upd": lambda x: t(x, torch.long)}),
        "keyframes": opt(inputs["keyframes"], {"xy": t, "signs": t, "free": tb, "valid": tb,
                                               "T_WS7": t}),
        "prev": opt(inputs["prev"], {"xy": t, "signs": t, "mask": tb, "T_WS7": t}),
        "sampler": inputs["sampler"],
    }


def _sync(dev):
    if dev.type == "cuda":
        with record_function(_STAGE + "synchronize"):
            torch.cuda.synchronize(dev)


def replay_device_loop(slam, records, n_pass: int = 3, mode: str = "full",
                       census: int = 0) -> dict:
    """Run ``records`` (``capture``'s, oldest first; any run of consecutive
    frames) again on ``slam``'s device: one untimed warm pass, then
    ``n_pass`` timed passes, ended by one synchronisation and timed on the
    host clock.

    mode "full": tracking program + fused append and solve per frame;
    "frontend": the tracking program and its diagnostics alone; "solve":
    the fused solves alone, on frontend outputs fixed by one untimed pass.

    Returns {"fps": frames/s over the timed passes, "seconds", "frames",
    "first": the warm pass's outputs, "outputs": the last pass's (per
    record, [solve output | diag] in the solve's dtype, or in mode
    "frontend" the diag), "harris_launches": the Harris kernel's launches
    in the timed passes}; with ``census`` > 0, also "transfers": one more
    pass over the last ``census`` records under ``transfer_census`` (the
    frames before them supply their live match sets). Runs on
    ``slam.device``: a system on the card needs the card (there is no
    fallback), a CPU system runs on the CPU."""
    if mode not in MODES or n_pass < 1:
        raise ValueError(f"replay_device_loop: mode {mode!r} (one of {MODES}), n_pass {n_pass} "
                         "(at least 1)")
    fe, est = slam.frontend, slam.estimator
    dev = torch.device(slam.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("replay_device_loop: the system's device is a CUDA card and none "
                           "is available")
    dtype = fe.cameras[0].focal.dtype
    staged = [_stage(r["frame_inputs"], dtype, dev) for r in records]
    gen = torch.Generator(device=dev)

    def frontend(r, x):
        gen.set_state(r["gen_state"])
        with record_function(_STAGE + "frame_associate"):
            out = frame_associate(
                fe.cameras, x["T_SC7"], x["images"], x["T_WS7"], x["landmarks"],
                x["tab_signs"], x["tab_valid"], fe.cfg, staged=x["staged"],
                keyframes=x["keyframes"], prev=x["prev"], generator=gen, sampler=x["sampler"],
                device=dev)
        with record_function(_STAGE + "frame_diag"):
            return (out["idx"], out["keep"], out["xy"], out["size"]), frame_diag(out)

    def solve(r, match_of, diag):
        sets = tuple(match_of.get(s, live) for s, live in zip(r["set_sids"], r["live_sets"]))
        with record_function(_STAGE + "solve_packed_fused"):
            return solve_packed_fused(r["problem"], r["aux_dev"], sets, diag, est.cameras,
                                      est.imu_params, r["scfg"])

    fixed = None
    if mode == "solve":
        fixed = [frontend(r, x) for r, x in zip(records, staged)]

    def one_pass(start=0):
        outs, match_of = [], {}
        for i in range(start, len(records)):
            r = records[i]
            match, diag = fixed[i] if fixed is not None else frontend(r, staged[i])
            match_of[r["sid"]] = match
            outs.append(diag if mode == "frontend" else solve(r, match_of, diag))
        return outs

    first = one_pass()
    _sync(dev)
    n0 = harris_nms_cuda.launches
    t0 = time.perf_counter()
    for _ in range(n_pass):
        outs = one_pass()
    _sync(dev)
    secs = time.perf_counter() - t0
    res = {"fps": n_pass * len(records) / secs, "seconds": secs, "frames": len(records),
           "first": first, "outputs": outs, "harris_launches": harris_nms_cuda.launches - n0}
    if census:
        n = min(census, len(records))
        res["transfers"] = transfer_census(
            lambda: (one_pass(len(records) - n), _sync(dev)), n)
    return res


_SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize")


def _end(e) -> float:
    return e["ts"] + e.get("dur", 0.0)


def _innermost(spans, starts, t0, t1):
    """The latest-starting of ``spans`` (sorted by start) that contains
    [t0, t1], else None."""
    i = bisect.bisect_right(starts, t0) - 1
    while i >= 0:
        if _end(spans[i]) >= t1:
            return spans[i]
        i -= 1
    return None


def _outermost_op(ops, starts, t0, t1, since, depth=64):
    """The earliest-starting ATen op of the ``depth`` before ``t0`` that
    contains [t0, t1] and starts at or after ``since``, else None."""
    best = None
    i = bisect.bisect_right(starts, t0) - 1
    while i >= 0 and depth > 0 and starts[i] >= since:
        if _end(ops[i]) >= t1:
            best = ops[i]
        i -= 1
        depth -= 1
    return best


_TYPE_BYTES = {"bool": 1, "signed char": 1, "unsigned char": 1, "short int": 2,
               "c10::Half": 2, "c10::BFloat16": 2, "int": 4, "float": 4, "long int": 8,
               "double": 8}


def _smallest_input_bytes(args):
    """The bytes of an op's smallest tensor input (an upper bound on a
    host<->device copy that an indexed write, a conversion, a copy or a
    scalar read makes of one of its inputs), else None."""
    sizes = [math.prod(d) * _TYPE_BYTES[t]
             for d, t in zip(args.get("Input Dims") or [], args.get("Input type") or [])
             if t in _TYPE_BYTES and isinstance(d, list) and all(isinstance(x, int) for x in d)]
    return min(sizes) if sizes else None


def _attribute(trace, targets):
    """For each target event (a CUDA runtime call of a Chrome trace), the
    call that caused it: the replay's stage around it and the outermost
    ATen op of that stage around it, with its first input's shape and type,
    e.g. "solve_packed_fused: aten::to [4] bool"; ``_smallest_input_bytes``
    of that op (None without one); and the op's end (the event's own end
    without one)."""
    stages = sorted((e for e in trace if e.get("cat") == "user_annotation"
                     and e["name"].startswith(_STAGE)), key=lambda e: e["ts"])
    ops = sorted((e for e in trace if e.get("cat") == "cpu_op"
                  and e["name"].startswith("aten::")), key=lambda e: e["ts"])
    s_starts = [e["ts"] for e in stages]
    o_starts = [e["ts"] for e in ops]
    causes = []
    for ev in targets:
        t0, t1 = ev["ts"], _end(ev)
        st = _innermost(stages, s_starts, t0, t1)
        op = _outermost_op(ops, o_starts, t0, t1, st["ts"] if st is not None else -math.inf)
        where = st["name"][len(_STAGE):] if st is not None else "(outside the replay)"
        bound, op_end = None, t1
        if op is not None:
            op_end = _end(op)
            args = op.get("args", {})
            dims, types = args.get("Input Dims") or [], args.get("Input type") or []
            arg = f" {list(dims[0])} {types[0]}" if dims and types and types[0] else ""
            where += f": {op['name']}{arg}"
            bound = _smallest_input_bytes(args)
        causes.append((where, bound, op_end))
    return causes


def transfer_census(fn, n_frames: int) -> dict:
    """Run ``fn`` (e.g. one replay pass) under ``torch.profiler`` (CPU ops
    with their input shapes, and the card's activity), read its Chrome
    trace, and count the host<->device copies (a CUDA runtime copy whose
    device copy is not device-to-device, with the device copy's bytes) and
    the host synchronisations it made, each by the call that caused it
    (``_attribute``). A runtime copy whose device record is missing from
    the trace counts as host<->device where its op then synchronises with
    the host, as PyTorch's blocking copies between host and device do,
    with ``_smallest_input_bytes`` as its size bound; else it is taken as
    device-to-device.

    Returns {"copies": [{"kind", "bytes", "cause", "count"}], "unsized":
    [{"bytes_at_most", "cause", "count"}] (copies the device recorded no
    size for, bounded by ``_smallest_input_bytes``), "syncs": [{"name",
    "cause", "count"}], "copies_per_frame", "syncs_per_frame",
    "max_copy_bytes"}. A CPU run makes no such calls."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts, record_shapes=True) as prof:
        fn()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    device_copies, copies_rt, syncs_rt = {}, [], []
    for e in trace:
        cat, name = e.get("cat"), e["name"]
        if cat == "gpu_memcpy":
            device_copies[e.get("args", {}).get("correlation")] = e
        elif cat == "cuda_runtime" and name.startswith("cudaMemcpy"):
            copies_rt.append(e)
        elif cat == "cuda_runtime" and name in _SYNCS:
            syncs_rt.append(e)
    syncs_rt.sort(key=lambda e: e["ts"])
    sync_starts = [e["ts"] for e in syncs_rt]

    def then_syncs(t0, t1):
        i = bisect.bisect_left(sync_starts, t0)
        return i < len(syncs_rt) and _end(syncs_rt[i]) <= t1

    copies, syncs, unsized = collections.Counter(), collections.Counter(), collections.Counter()
    for ev, (cause, bound, op_end) in zip(copies_rt, _attribute(trace, copies_rt)):
        gpu = device_copies.get(ev.get("args", {}).get("correlation"))
        if gpu is not None and "DtoD" in gpu["name"]:
            continue
        if gpu is None or "bytes" not in gpu.get("args", {}):
            if not then_syncs(_end(ev), op_end):
                continue  # device to device
            unsized[(-1 if bound is None else bound, cause)] += 1
        else:
            kind = "HtoD" if "HtoD" in gpu["name"] else "DtoH"
            copies[(kind, int(gpu["args"]["bytes"]), cause)] += 1
        if "Async" not in ev["name"]:
            syncs[(ev["name"], cause)] += 1  # a synchronous copy
    for ev, (cause, _, _) in zip(syncs_rt, _attribute(trace, syncs_rt)):
        syncs[(ev["name"], cause)] += 1
    n = max(n_frames, 1)
    n_unsized = sum(unsized.values())
    return {
        "copies": [{"kind": k, "bytes": b, "cause": c, "count": m}
                   for (k, b, c), m in sorted(copies.items(), key=lambda kv: -kv[1])],
        "unsized": [{"bytes_at_most": b, "cause": c, "count": m}
                    for (b, c), m in sorted(unsized.items(), key=lambda kv: -kv[1])],
        "syncs": [{"name": s, "cause": c, "count": m}
                  for (s, c), m in sorted(syncs.items(), key=lambda kv: -kv[1])],
        "copies_per_frame": (sum(copies.values()) + n_unsized) / n,
        "syncs_per_frame": sum(syncs.values()) / n,
        # the largest copy, or the bound of one the device recorded no size
        # for (unbounded: infinite)
        "max_copy_bytes": max([b for (_, b, _) in copies]
                              + [math.inf if b < 0 else b for (b, _) in unsized], default=0),
    }
