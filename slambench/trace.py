"""Device trace of a bounded run of steady frames or solves, reduced in
memory: device activity only (tracing host operations stretches a frame
that launches tens of thousands of kernels), no Chrome trace written.

The host's stages come from the port's ``utils/timing.py`` timers, whose
intervals are recorded while the trace runs; the host clock is tied to
the device's by a marker operation launched at a known host time when
the trace starts.
"""

from __future__ import annotations

import time

import numpy as np
import torch


class Recorder:
    """Intervals [(name, t0, t1)] (host ``perf_counter`` s) of the port's
    timers while installed."""

    def __init__(self):
        self.spans = []
        self._orig = None

    def install(self, timing_cls):
        self._orig = timing_cls.__dict__["add"]
        spans, orig = self.spans, self._orig.__func__

        def add(cls, name, dt):
            t1 = time.perf_counter()
            spans.append((name, t1 - dt, t1))
            return orig(cls, name, dt)

        timing_cls.add = classmethod(add)
        self._cls = timing_cls

    def remove(self):
        if self._orig is not None:
            self._cls.add = self._orig
            self._orig = None


def _events(prof):
    """[(name, start_us, duration_us)] of the device's operations."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA:
            continue
        start = e.start_ns() / 1e3 if hasattr(e, "start_ns") else float(e.start_us())
        dur = e.duration_ns() / 1e3 if hasattr(e, "duration_ns") else float(e.duration_us())
        out.append((e.name(), start, dur))
    return out


def union(intervals):
    """Merged [(t0, t1)] of intervals, sorted."""
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            if b > merged[-1][1]:
                merged[-1][1] = b
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def traced(run, timing_cls):
    """Run ``run()`` under the profiler (device activity only) and reduce the
    trace: {"busy_s", "window_s", "kernels", "ops": {name: (count, s)},
    "idle_by_stage": {stage: s}}."""
    from torch.profiler import ProfilerActivity, profile

    rec = Recorder()
    rec.install(timing_cls)
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            marker = torch.empty(1 << 16, device="cuda")
            t_mark = time.perf_counter()
            marker.fill_(1.0)
            run()
            torch.cuda.synchronize()
            t_end = time.perf_counter()
    finally:
        rec.remove()
    return reduce(_events(prof), t_mark, t_end, rec.spans)


def reduce(ev, t_mark, t_end, host_spans):
    """Summary of device events [(name, start_us, duration_us)] whose first
    is the marker launched at host time ``t_mark``, over the traced window
    [t_mark, t_end] (host s), with host spans [(name, t0, t1)]."""
    if not ev:
        return None
    ev = sorted(ev, key=lambda e: e[1])
    # device us = host s * 1e6 + offset, from the marker (the first op)
    offset = ev[0][1] - t_mark * 1e6
    ev = ev[1:]
    t0_us, t1_us = t_mark * 1e6 + offset, t_end * 1e6 + offset
    busy = union([(s, s + d) for _, s, d in ev])
    busy_us = sum(b - a for a, b in busy)
    ops = {}
    kernels = 0
    for name, _s, d in ev:
        c, t = ops.get(name, (0, 0.0))
        ops[name] = (c + 1, t + d * 1e-6)
        if not name.startswith("Memcpy") and not name.startswith("Memset"):
            kernels += 1
    # device idle gaps, each charged to the innermost host span of the
    # port's timers open at its midpoint
    spans = [(n, a * 1e6 + offset, b * 1e6 + offset) for n, a, b in host_spans]
    gaps, prev = [], t0_us
    for a, b in busy:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    if t1_us > prev:
        gaps.append((prev, t1_us))
    g = np.asarray(gaps, np.float64).reshape(-1, 2)
    mids, lens = 0.5 * (g[:, 0] + g[:, 1]), (g[:, 1] - g[:, 0]) * 1e-6
    order = np.argsort(mids)
    mids, lens = mids[order], lens[order]
    names = ["outside the port's timers"]
    label = np.zeros(len(mids), np.int64)
    # longest spans first, so that the innermost one open at a gap's
    # midpoint is the last written
    for n, s0, s1 in sorted(spans, key=lambda s: s[1] - s[2]):
        lo, hi = np.searchsorted(mids, s0), np.searchsorted(mids, s1, side="right")
        if hi > lo:
            names.append(n)
            label[lo:hi] = len(names) - 1
    idle = {}
    for k, t in zip(label.tolist(), lens.tolist()):
        idle[names[k]] = idle.get(names[k], 0.0) + t
    return {"busy_s": busy_us * 1e-6, "window_s": (t1_us - t0_us) * 1e-6, "kernels": kernels,
            "ops": ops, "idle_by_stage": idle}


def breakdown(summary):
    """The result line's ``breakdown``: the ten device operations that took
    the most time, and the ten host stages under which the device idled
    longest, each [name, seconds]."""
    ops = sorted(summary["ops"].items(), key=lambda kv: -kv[1][1])[:10]
    idle = sorted(summary["idle_by_stage"].items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[n[:200], t] for n, (_c, t) in ops],
            "idle_gaps": [[n[:200], t] for n, t in idle]}
