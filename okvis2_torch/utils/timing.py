"""Named-timer registry with rolling statistics.

Port of ``okvis2_tpu/utils/timing.py`` (pure Python, kept as a copy so
the port imports nothing of the JAX package). Covers
okvis::timing::Timer/Timing (reference: okvis_timing/include/okvis/
timing/Timer.hpp:62-176, src/Timer.cpp:1-272): globally-registered
named timers with total/mean/min/max/stddev and a print report, used to
tag pipeline stages hierarchically ("2.01 match to map" style,
Frontend.cpp:582). `Timer` doubles as a context manager; `SwitchableTimer`
becomes a no-op when timing is disabled (the DO_TIMING=OFF /
DummyTimer equivalent, Timer.hpp:170-176). A timed block that launches
device work measures it only if it waits for the device (a readback or
``torch.cuda.synchronize``); ``torch.profiler`` gives the kernel-level
detail.
"""

from __future__ import annotations

import math
import threading
import time
from typing import Dict, List, Optional


class _Stats:
    __slots__ = ("n", "total", "min", "max", "m2", "mean", "last",
                 "recent")

    def __init__(self):
        self.n = 0
        self.total = 0.0
        self.min = math.inf
        self.max = 0.0
        self.mean = 0.0
        self.m2 = 0.0
        self.last = 0.0
        self.recent: List[float] = []  # ring of the last 128 samples

    def add(self, dt: float):
        self.n += 1
        self.total += dt
        self.min = min(self.min, dt)
        self.max = max(self.max, dt)
        self.last = dt
        d = dt - self.mean
        self.mean += d / self.n
        self.m2 += d * (dt - self.mean)
        if len(self.recent) >= 128:
            self.recent[self.n % 128] = dt
        else:
            self.recent.append(dt)

    @property
    def p50(self) -> float:
        """Median of the most recent <=128 samples (robust to the
        compile-dominated first calls)."""
        if not self.recent:
            return 0.0
        s = sorted(self.recent)
        return s[len(s) // 2]

    @property
    def std(self) -> float:
        return math.sqrt(self.m2 / self.n) if self.n > 1 else 0.0


class Timing:
    """Global registry singleton (okvis::timing::Timing)."""

    _lock = threading.Lock()
    _timers: Dict[str, _Stats] = {}
    enabled: bool = True

    @classmethod
    def add(cls, name: str, dt: float):
        with cls._lock:
            cls._timers.setdefault(name, _Stats()).add(dt)

    @classmethod
    def get(cls, name: str) -> Optional[_Stats]:
        return cls._timers.get(name)

    @classmethod
    def mean(cls, name: str) -> float:
        s = cls._timers.get(name)
        return s.mean if s else 0.0

    @classmethod
    def total(cls, name: str) -> float:
        s = cls._timers.get(name)
        return s.total if s else 0.0

    @classmethod
    def reset(cls):
        with cls._lock:
            cls._timers.clear()

    @classmethod
    def print_report(cls) -> str:
        lines = ["timing report:"]
        for name in sorted(cls._timers):
            s = cls._timers[name]
            lines.append(
                f"  {name}: n={s.n} total={s.total:.3f}s "
                f"p50={s.p50*1e3:.2f}ms mean={s.mean*1e3:.2f}ms "
                f"min={s.min*1e3:.2f}ms max={s.max*1e3:.2f}ms "
                f"std={s.std*1e3:.2f}ms"
            )
        report = "\n".join(lines)
        print(report, flush=True)
        return report


class Timer:
    """Context-manager timer registered under a hierarchical name."""

    def __init__(self, name: str):
        self.name = name
        self._t0 = 0.0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.stop()
        return False

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self):
        Timing.add(self.name, time.perf_counter() - self._t0)


class SwitchableTimer(Timer):
    """No-op when Timing.enabled is False (TimerSwitchable/DummyTimer)."""

    def __exit__(self, *exc):
        if Timing.enabled:
            self.stop()
        return False

    def stop(self):
        if Timing.enabled:
            super().stop()
