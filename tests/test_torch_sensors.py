"""The port's live-sensor modules (``okvis2_torch.pipeline.sensors``,
``apps/app_realsense.py``, ``apps/app_realsense_recorder.py``) against the
JAX package's on the CPU.

The four cases of ``tests/test_sensors.py`` (metadata timestamps, the host
fallback, frame-counter gaps, the emitter mode) on both packages. Then a
scripted stand-in for the librealsense SDK, installed as ``pyrealsense2``,
serves framesets of IR pairs at the size ``enable_stream`` asks for, gyro at
200 Hz and accel at 250 Hz, timestamp, counter and emitter metadata (with a
dropped frame) and z16 depth; both packages' ``RealsenseSensor`` and
``RealsenseRgbdSensor`` threads run on it, and their image, IMU and depth
callbacks must be equal: times, pixels bit for bit, the interpolated accel.
The recorder app writes the same folder as the JAX recorder (the CSVs byte
for byte; the PNGs decode to the same pixels: the JAX writer encodes with
OpenCV, the port with its own zlib codec), and ``app_realsense`` feeds the
same config fields, callbacks (``--rgbd`` depth too) and trajectory CSV
through a recording stand-in for ``SlamSystem`` in both packages.
"""

import collections
import logging
import os
import sys
import threading
import time
import types

import numpy as np
import pytest
import torch

import chip_smoke
from okvis2_torch.apps import app_realsense as tapp
from okvis2_torch.apps import app_realsense_recorder as trec
from okvis2_torch.pipeline import sensors as tsens
from okvis2_torch.pipeline import slam as tslam
from okvis2_tpu.apps import app_realsense as japp
from okvis2_tpu.apps import app_realsense_recorder as jrec
from okvis2_tpu.pipeline import sensors as jsens
from okvis2_tpu.pipeline import slam as jslam

from test_sensors import _FAKE_RS, _FakeFrame

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
D455 = os.path.join(ROOT, "configs", "realsense_D455.yaml")
PACKAGES = {"jax": (jsens, "okvis2_tpu"), "port": (tsens, "okvis2_torch")}


# -- the cases of tests/test_sensors.py, on both packages ----------------------

def _bare_sensor(mod, rgbd=False):
    """A sensor without the SDK (its constructor is gated)."""
    s = object.__new__(mod.RealsenseRgbdSensor if rgbd else mod.RealsenseSensor)
    s._rs = _FAKE_RS
    s._has_device_ts = True
    s._host_offset_us = 0.0
    s._ts_samples = 0
    s._last_frame_counter = None
    if rgbd:
        s._supports_emitter_md = True
        s._alt_ctr = 0
    return s


@pytest.mark.parametrize("pkg", PACKAGES)
def test_metadata_timestamp_uses_sensor_clock_plus_offset(pkg):
    s = _bare_sensor(PACKAGES[pkg][0])
    t = s._frame_time(_FakeFrame(5.0, {"frame_timestamp": 1000}))
    assert abs(t - 5.0e-3) < 1e-12
    t2 = s._frame_time(_FakeFrame(5.0 + 33.333 + 1.0, {"frame_timestamp": 34333}))
    assert 0.0333 < t2 - t < 0.0343 and s._ts_samples == 2


@pytest.mark.parametrize("pkg", PACKAGES)
def test_host_fallback_when_metadata_missing(pkg, caplog):
    mod, logger = PACKAGES[pkg]
    s = _bare_sensor(mod)
    with caplog.at_level(logging.WARNING, logger=logger):
        t = s._frame_time(_FakeFrame(7.5))
    assert abs(t - 7.5e-3) < 1e-12 and not s._has_device_ts
    assert any("host timestamps" in r.message and r.name == logger for r in caplog.records)
    assert abs(s._frame_time(_FakeFrame(9.5, {"frame_timestamp": 1})) - 9.5e-3) < 1e-12


@pytest.mark.parametrize("pkg", PACKAGES)
def test_frame_counter_gap_warns(pkg, caplog):
    mod, logger = PACKAGES[pkg]
    s = _bare_sensor(mod)
    s._check_frame_counter(_FakeFrame(0.0, {"frame_counter": 10}))
    with caplog.at_level(logging.WARNING, logger=logger):
        s._check_frame_counter(_FakeFrame(0.0, {"frame_counter": 11}))
        assert not caplog.records
        s._check_frame_counter(_FakeFrame(0.0, {"frame_counter": 14}))
    assert any("dropped 2 frame" in r.message and r.name == logger for r in caplog.records)


@pytest.mark.parametrize("pkg", PACKAGES)
def test_emitter_mode_metadata_and_fallback(pkg, caplog):
    mod, logger = PACKAGES[pkg]
    s = _bare_sensor(mod, rgbd=True)
    assert s._emitter_on(_FakeFrame(0, {"frame_emitter_mode": 1})) is True
    assert s._emitter_on(_FakeFrame(0, {"frame_emitter_mode": 0})) is False
    with caplog.at_level(logging.WARNING, logger=logger):
        assert s._emitter_on(_FakeFrame(0)) is None
    assert any("emitter mode" in r.message and r.name == logger for r in caplog.records)
    assert s._emitter_on(_FakeFrame(0, {"frame_emitter_mode": 1})) is None


def test_sdk_missing(monkeypatch):
    monkeypatch.setitem(sys.modules, "pyrealsense2", None)
    for mod, _ in PACKAGES.values():
        for cls in (mod.RealsenseSensor, mod.RealsenseRgbdSensor):
            with pytest.raises(RuntimeError, match="pyrealsense2"):
                cls()


# -- the scripted SDK ------------------------------------------------------------

N_FRAMESETS = 12
DROPPED = 7  # the frame counter skips this frameset's number


class _Frame:
    def __init__(self, kind, host_ms, md, data=None, motion=None, index=0):
        self.kind, self.index = kind, index
        self._host_ms, self._md, self._data, self._motion = host_ms, md, data, motion
        self.profile = types.SimpleNamespace(stream_type=lambda: kind)

    def is_motion_frame(self):
        return self.kind in ("gyro", "accel")

    def as_motion_frame(self):
        return self

    def get_motion_data(self):
        return types.SimpleNamespace(x=self._motion[0], y=self._motion[1], z=self._motion[2])

    def get_timestamp(self):
        return self._host_ms

    def supports_frame_metadata(self, key):
        return key in self._md

    def get_frame_metadata(self, key):
        return self._md[key]

    def get_data(self):
        return self._data


class _Frameset:
    def __init__(self, frames):
        self.frames = frames

    def __iter__(self):
        return iter(self.frames)

    def get_infrared_frame(self, i):
        return next((f for f in self.frames if f.kind == "infrared" and f.index == i), None)

    def get_depth_frame(self):
        return next((f for f in self.frames if f.kind == "depth"), None)


def _framesets(streams, metadata):
    """The script: framesets at 30 Hz of what ``streams`` (the config's
    enable_stream calls) asked for. ``metadata``: "full" (timestamps,
    counters, the emitter alternating), "no_emitter" or "none"."""
    rng = np.random.default_rng(8)
    ir = [s for s in streams if s[0] == "infrared"]
    (_, _, w, h, _, _), depth = ir[0], [s for s in streams if s[0] == "depth"]
    host0_ms, sensor0_us = 1_700_000_000_000.0, 5_000_000
    motion = sorted([(k * 5000, "gyro") for k in range(1, 80)]
                    + [(k * 4000, "accel") for k in range(1, 100)])
    out, mi = [], 0

    def host(us):  # the host clock: the sensor's plus jitter
        return host0_ms + us * 1e-3 + rng.uniform(-0.5, 0.5)

    def md(us, **extra):
        if metadata == "none":
            return {}
        return {"frame_timestamp": sensor0_us + us, **extra}

    for n in range(N_FRAMESETS):
        us = round(n * 1e6 / 30)
        frames = []
        while mi < len(motion) and motion[mi][0] <= us:
            t_us, kind = motion[mi]
            vals = rng.normal(size=3) + (0.0, 0.0, 9.81 if kind == "accel" else 0.0)
            frames.append(_Frame(kind, host(t_us), md(t_us), motion=vals.astype(np.float32)))
            mi += 1
        extra = {"frame_counter": n + (n >= DROPPED)}
        if metadata == "full":
            extra["frame_emitter_mode"] = n % 2
        ts = host(us)
        for i in (1, 2):
            frames.append(_Frame("infrared", ts, md(us, **extra),
                                 data=rng.integers(0, 256, (h, w), dtype=np.uint8), index=i))
        if depth:
            frames.append(_Frame("depth", ts + 0.25, md(us + 250),
                                 data=rng.integers(0, 6000, (h, w), dtype=np.uint16)))
        out.append(_Frameset(frames))
    return out


class _Pipeline:
    def __init__(self, rs):
        self.rs, self.index, self.stopped = rs, 0, False
        self.exhausted = threading.Event()
        rs.pipelines.append(self)

    def start(self, cfg):
        self.cfg = cfg
        self.script = _framesets(cfg.streams, self.rs.metadata)
        self.device_sensor = _DepthSensor()
        return self.get_active_profile()

    def get_active_profile(self):
        dev = types.SimpleNamespace(first_depth_sensor=lambda: self.device_sensor)
        return types.SimpleNamespace(get_device=lambda: dev)

    def wait_for_frames(self):
        if self.index < len(self.script):
            self.index += 1
            return self.script[self.index - 1]
        self.exhausted.set()
        time.sleep(0.001)
        return _Frameset([])

    def stop(self):
        self.stopped = True


class _DepthSensor:
    def __init__(self):
        self.options = []

    def supports(self, option):
        return True

    def set_option(self, option, value):
        self.options.append((option, value))


class _Config:
    def __init__(self):
        self.streams = []

    def enable_stream(self, stream, *args):
        # depth comes without an index: (stream, index, w, h, format, fps)
        self.streams.append((stream, 0) + args if stream == "depth" else (stream,) + args)


def _sdk(metadata="full"):
    rs = types.ModuleType("pyrealsense2")
    rs.metadata = metadata
    rs.pipelines, rs.aligned = [], []
    rs.stream = types.SimpleNamespace(infrared="infrared", gyro="gyro", accel="accel",
                                      depth="depth")
    rs.format = types.SimpleNamespace(y8="y8", motion_xyz32f="motion_xyz32f", z16="z16")
    rs.option = types.SimpleNamespace(emitter_enabled="emitter_enabled",
                                      emitter_on_off="emitter_on_off",
                                      global_time_enabled="global_time_enabled")
    rs.frame_metadata_value = types.SimpleNamespace(frame_timestamp="frame_timestamp",
                                                    frame_counter="frame_counter",
                                                    frame_emitter_mode="frame_emitter_mode")
    rs.config = _Config
    rs.pipeline = lambda: _Pipeline(rs)

    class align:
        def __init__(self, stream):
            rs.aligned.append(stream)

        def process(self, frames):
            return frames

    rs.align = align
    return rs


class _Recorder:
    """The callbacks' calls, with copies of what they were given."""

    def __init__(self):
        self.calls = []

    def images(self, t, imgs):
        self.calls.append(("images", t, [np.array(i) for i in imgs]))

    def imu(self, t, acc, gyr):
        self.calls.append(("imu", t, np.array(acc), np.array(gyr)))

    def depth(self, t, d):
        self.calls.append(("depth", t, np.array(d)))


def _same_calls(a, b):
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        assert x[0] == y[0] and x[1] == y[1], (x[:2], y[:2])
        for p, q in zip(x[2:], y[2:]):
            for u, v in zip(p if isinstance(p, list) else [p], q if isinstance(q, list) else [q]):
                assert u.dtype == v.dtype and u.shape == v.shape and np.array_equal(u, v)


def _drive(monkeypatch, mod, rgbd, metadata):
    rs = _sdk(metadata)
    monkeypatch.setitem(sys.modules, "pyrealsense2", rs)
    rec = _Recorder()
    sensor = mod.RealsenseRgbdSensor() if rgbd else mod.RealsenseSensor()
    sensor.set_images_callback(rec.images)
    sensor.set_imu_callback(rec.imu)
    if rgbd:
        sensor.set_depth_callback(rec.depth)
    assert sensor.start_streaming()
    assert rs.pipelines[0].exhausted.wait(30)
    assert sensor.stop_streaming() and rs.pipelines[0].stopped
    return rec.calls, rs


@pytest.mark.parametrize("rgbd,metadata", [(False, "full"), (False, "none"), (True, "full"),
                                           (True, "no_emitter")])
def test_sensor_threads(monkeypatch, caplog, rgbd, metadata):
    out = {}
    with caplog.at_level(logging.WARNING):
        for name, (mod, _) in PACKAGES.items():
            out[name] = _drive(monkeypatch, mod, rgbd, metadata)
    (calls_t, rs_t), (calls_j, rs_j) = out["port"], out["jax"]
    _same_calls(calls_t, calls_j)
    assert rs_t.pipelines[0].cfg.streams == rs_j.pipelines[0].cfg.streams
    assert rs_t.pipelines[0].device_sensor.options == rs_j.pipelines[0].device_sensor.options
    assert rs_t.aligned == rs_j.aligned == (["infrared"] if rgbd else [])
    kinds = collections.Counter(c[0] for c in calls_t)
    # the IR pairs served at the SDK's default 848x480, float32 / 255
    imgs = [c for c in calls_t if c[0] == "images"]
    assert imgs[0][2][0].shape == (480, 848) and imgs[0][2][0].dtype == np.float32
    if rgbd:  # half the framesets feed tracking, the other half depth
        assert kinds["images"] == kinds["depth"] == N_FRAMESETS // 2
        d = [c for c in calls_t if c[0] == "depth"][0][2]
        assert d.dtype == np.float32 and d.max() < 6.0
    else:
        assert kinds["images"] == N_FRAMESETS and "depth" not in kinds
    # gyro samples after the first accel sample, accel interpolated to them
    assert kinds["imu"] == sum(1 for k in range(1, 80) if k * 5000 >= 4000
                               and k * 5000 <= round((N_FRAMESETS - 1) * 1e6 / 30))
    messages = collections.Counter((r.name, r.getMessage().split(" (")[0]) for r in caplog.records)
    for _, logger in PACKAGES.values():
        dropped = messages[(logger, "Realsense dropped 1 frame(s)")]
        assert dropped == (0 if metadata == "none" else 1), messages
        assert messages[(logger, "Device timestamps not available. Switching to host "
                         "timestamps")] == (metadata == "none")


def test_interpolated_accel(monkeypatch):
    """The port's accel at each gyro stamp is np.interp over the last 64
    accel samples received before it, against the script's own values."""
    calls, rs = _drive(monkeypatch, tsens, False, "none")
    expect, buf = [], []
    for fs in rs.pipelines[0].script:
        for f in fs:
            t = f.get_timestamp() * 1e-3  # host timestamps: no metadata
            if f.kind == "accel":
                buf = (buf + [(t, f.get_motion_data())])[-64:]
            elif f.kind == "gyro":
                ts = np.asarray([a[0] for a in buf])
                vs = np.asarray([[a[1].x, a[1].y, a[1].z] for a in buf])
                expect.append((t, [np.interp(t, ts, vs[:, i]) for i in range(3)]))
    gyro = [c for c in calls if c[0] == "imu"]
    assert len(gyro) == len(expect) > 64
    for c, (t, acc) in zip(gyro, expect):
        assert c[1] == t and np.array_equal(c[2], acc)


# -- the apps ----------------------------------------------------------------------

class _FakeTime:
    """The apps' clock: ``sleep`` waits for the SDK script to run out, and
    the clock moves past any duration on the second ``sleep`` after that
    (so that every frame queued before the end has been taken)."""

    def __init__(self, rs):
        self.rs, self.now, self.seen = rs, 0.0, False

    def time(self):
        return self.now

    def sleep(self, seconds):
        done = self.rs.pipelines[-1].exhausted
        if done.is_set():
            if self.seen:
                self.now += 1e6
            self.seen = True
        else:
            done.wait(30)


@pytest.mark.parametrize("rgbd", [False, True])
def test_recorder_app(monkeypatch, tmp_path, rgbd):
    pytest.importorskip("cv2")  # the JAX package's DatasetWriter encodes with OpenCV
    for name, app in (("jax", jrec), ("port", trec)):
        rs = _sdk()
        monkeypatch.setitem(sys.modules, "pyrealsense2", rs)
        monkeypatch.setattr(app, "time", _FakeTime(rs))
        app.main([str(tmp_path / name), "--duration", "5"] + (["--rgbd"] if rgbd else []))
    files = {name: sorted(os.path.relpath(os.path.join(d, f), tmp_path / name)
                          for d, _, fs in os.walk(tmp_path / name) for f in fs)
             for name in ("jax", "port")}
    assert files["jax"] == files["port"]
    assert sum(f.endswith(".png") for f in files["port"]) == 2 * (
        N_FRAMESETS // 2 if rgbd else N_FRAMESETS)
    for rel in files["port"]:
        if rel.endswith(".csv"):
            with open(tmp_path / "jax" / rel, "rb") as a, open(tmp_path / "port" / rel, "rb") as b:
                assert a.read() == b.read(), rel
    assert chip_smoke.app_folder_digest(str(tmp_path / "jax")) == \
        chip_smoke.app_folder_digest(str(tmp_path / "port"))


class _StandIn:
    """``SlamSystem``'s place: records what the app gives it and makes one
    state per frame (its pose a function of the frame's time)."""

    def __init__(self, cameras, extrinsics, imu_params, est_cfg, fe_cfg, **kw):
        self.extrinsics = np.stack([_np(T.r) for T in extrinsics])
        self.args = dict(
            cameras=len(cameras),
            estimator={f: getattr(est_cfg, f) for f in (
                "num_keyframes", "num_imu_frames", "realtime_iterations", "enforce_realtime",
                "realtime_time_limit", "num_loop_closure_frames", "realtime_min_iterations")},
            frontend={"max_keypoints": fe_cfg.detection.max_keypoints,
                      "octaves": fe_cfg.detection.octaves,
                      "matching_threshold": fe_cfg.matching_threshold},
            do_loop_closures=kw.get("do_loop_closures"), pipelined=kw.get("pipelined", False))
        self.calls, self._queue = [], collections.deque()
        self.estimator = types.SimpleNamespace(states={}, state_order=[], landmarks={})
        self.tracking = types.SimpleNamespace(tracking_quality="good")
        _StandIn.instances.append(self)

    def add_images(self, t, imgs):
        self.calls.append(("images", t, [np.array(i) for i in imgs]))
        self._queue.append(t)
        return True

    def add_imu_measurement(self, t, acc, gyr):
        self.calls.append(("imu", t, np.array(acc), np.array(gyr)))
        return True

    def add_depth_image(self, t, depth, cam_idx=0):
        self.calls.append(("depth", t, np.array(depth)))
        return True

    def process_frame(self):
        if not self._queue:
            return False
        t = self._queue.popleft()
        sid = len(self.estimator.state_order)
        q = np.array([np.sin(t), 0.25, -0.5, np.cos(t)])
        self.estimator.states[sid] = types.SimpleNamespace(
            t=t, pose=np.concatenate([[t % 1.0, 2 * t % 1.0, -t % 1.0], q / np.linalg.norm(q)]))
        self.estimator.state_order.append(sid)
        return True


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("rgbd", [False, True])
def test_realsense_app(monkeypatch, tmp_path, rgbd):
    systems = {}
    for name, app, slam_mod in (("jax", japp, jslam), ("port", tapp, tslam)):
        rs = _sdk()
        monkeypatch.setitem(sys.modules, "pyrealsense2", rs)
        monkeypatch.setattr(app, "time", _FakeTime(rs))
        _StandIn.instances = []
        monkeypatch.setattr(slam_mod, "SlamSystem", _StandIn)
        argv = [D455, "--duration", "5", "--output", str(tmp_path / f"{name}.csv")]
        argv += ["--rgbd"] if rgbd else []
        if name == "jax":
            app.main(argv)
        else:
            app.main(argv, device="cpu")
        (systems[name],) = _StandIn.instances
    j, t = systems["jax"], systems["port"]
    assert t.args == j.args
    assert np.allclose(t.extrinsics, j.extrinsics, rtol=0, atol=1e-7)
    assert t.args["cameras"] >= 2 and t.args["frontend"]["max_keypoints"] > 0
    _same_calls(t.calls, j.calls)
    kinds = collections.Counter(c[0] for c in t.calls)
    assert kinds["depth"] == (N_FRAMESETS // 2 if rgbd else 0) and kinds["imu"] > 0
    assert len(t.estimator.state_order) == kinds["images"] > 0
    with open(tmp_path / "jax.csv", "rb") as a, open(tmp_path / "port.csv", "rb") as b:
        assert a.read() == b.read()
