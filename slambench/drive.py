"""The synchronous frame loop, in a closed loop (the next frame
goes in when the last returns, as the dataset app feeds the system), with
the window measured on the host clock around the port's calls only.

``Taps`` keep references to what the timed path produced (the frontend's
keypoints, the window solves' packs and answers, the CNN gate's logits) by
wrapping the port's functions where its modules call them; nothing is
copied or synchronised inside the window. Of the keypoints and the solves
they keep only a sample of fixed size, drawn from the seed as the calls
come, so what they hold does not grow with the window.
"""

from __future__ import annotations

import time

import numpy as np
import torch


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize()


class Reservoir:
    """A uniform sample of ``k`` items of a stream of unknown length, drawn
    from a seed as the items come (Algorithm R): only ``k`` are held."""

    def __init__(self, k: int, seed: int, salt: int):
        self.k, self.n, self.kept = k, 0, []
        self.rng = np.random.default_rng([abs(int(seed)), salt])

    def offer(self, item):
        if len(self.kept) < self.k:
            self.kept.append((self.n, item))
        else:
            j = int(self.rng.integers(0, self.n + 1))
            if j < self.k:
                self.kept[j] = (self.n, item)
        self.n += 1

    def items(self):
        """(index in the stream, item), in stream order."""
        return sorted(self.kept, key=lambda e: e[0])


class Taps:
    """Wrappers around the port's module-level functions; ``on`` decides
    whether a call is recorded. ``solves`` and ``detections`` are
    reservoirs of ``n_solves`` and ``n_detections`` calls; ``outs`` holds
    every solve's flat answer (a few kB each)."""

    def __init__(self, seed: int, n_detections: int, n_solves: int):
        self.on = False
        self.solves = Reservoir(n_solves, seed, 1)
        self.detections = Reservoir(n_detections, seed, 2)
        self.logits = []
        self.outs = []  # every solve's answer, for its iteration count
        self._undo = []

    def _wrap(self, module, name, make):
        orig = getattr(module, name)
        setattr(module, name, make(orig))
        self._undo.append((module, name, orig))

    def install(self):
        from okvis2_torch.graph import estimator
        from okvis2_torch.models import fast_scnn
        from okvis2_torch.pipeline import frontend_pipeline

        def solve_packed(orig):
            def f(problem, cameras, imu_params, config):
                out = orig(problem, cameras, imu_params, config)
                if self.on:
                    self.solves.offer((problem, out))
                    self.outs.append(out)
                return out
            return f

        def detect(orig):
            def f(images, cfg):
                out = orig(images, cfg)
                if self.on:
                    self.detections.offer((images, {"xy": out["xy"], "mask": out["mask"]}))
                return out
            return f

        def logits(orig):
            # every keyframe's, the set-up's too: a window may hold none
            def f(model, img):
                out = orig(model, img)
                self.logits.append((img, out))
                return out
            return f

        self._wrap(estimator, "solve_packed", solve_packed)
        self._wrap(frontend_pipeline, "detect_keypoints_batch", detect)
        self._wrap(fast_scnn, "image_logits", logits)

    def remove(self):
        for module, name, orig in reversed(self._undo):
            setattr(module, name, orig)
        self._undo = []


def feed(slam, stream, frame):
    """Hand one generated frame (and its IMU) to the system."""
    t, images, _pose, _labels = frame
    for ts, acc, gyr in stream.imu_until(t):
        slam.add_imu_measurement(ts, acc, gyr)
    slam.add_images(t, images)


class LoopRun:
    """The synchronous loop over a stream: ``warm(n)`` frames of set-up,
    then ``window(seconds)``: frames until the time inside the port's calls
    reaches ``seconds``. Frames are generated off the clock."""

    def __init__(self, slam, stream, device):
        self.slam, self.stream, self.device = slam, stream, device
        self.next = 0
        self.gt = {}  # state id -> ground-truth pose
        self.keyframes = []
        self.frame_s = []
        self.gen_s = 0.0
        self._kf = {}
        slam.set_optimised_graph_callback(
            lambda t, sid, pose, tr: self._kf.__setitem__(sid, bool(tr.is_keyframe)))

    def _generate(self):
        t0 = time.perf_counter()
        fr = self.stream.frame(self.next)
        self.next += 1
        self.gen_s += time.perf_counter() - t0
        return fr

    def _one(self, fr):
        slam = self.slam
        ta = time.perf_counter()
        feed(slam, self.stream, fr)
        slam.process_frame()
        sync(self.device)
        dt = time.perf_counter() - ta
        sid = slam.tracking.id
        self.gt[sid] = fr[2]
        return dt, sid

    def warm(self, n: int):
        for _ in range(n):
            self._one(self._generate())

    def window(self, seconds: float, on_frame=None):
        inside = 0.0
        while inside < seconds:
            fr = self._generate()
            dt, sid = self._one(fr)
            inside += dt
            self.frame_s.append(dt)
            if self._kf.get(sid):
                self.keyframes.append(sid)
            if on_frame is not None:
                on_frame(fr)
        return inside

    def run_frames(self, frames):
        """Process pre-generated frames (the traced segment)."""
        for fr in frames:
            self._one(fr)

    def trajectory(self):
        """(estimated positions, true positions) of every state with a
        ground truth, in time order."""
        est = self.slam.estimator
        sids = [s for s in est.state_order if s in self.gt]
        return (np.stack([est.states[s].pose[:3] for s in sids]),
                np.stack([self.gt[s][:3] for s in sids]))
