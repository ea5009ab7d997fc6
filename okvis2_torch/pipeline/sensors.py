"""Live sensor abstraction and the Realsense adapter.

Port of ``okvis2_tpu/pipeline/sensors.py``: ViSensorBase (reference:
okvis_multisensor_processing/include/okvis/ViSensorBase.hpp:56-123:
registered image/IMU callbacks, start/stop streaming) and the librealsense
adapter (okvis_multisensor_processing/src/Realsense.cpp: stereo IR with
the emitter off, metadata timestamps, the IMU streams interpolated;
RealsenseRgbd.cpp adds aligned depth).

The Realsense adapter is gated on pyrealsense2: without the SDK the
classes raise a ``RuntimeError`` naming it at construction. The same
callbacks drive ``SlamSystem`` or ``DatasetWriter``. Images reach them as
float32 / 255, as from the dataset readers; everything here runs on the
host, and the system moves the images to its device.
"""

from __future__ import annotations

import logging
import threading
from typing import Callable, List, Optional

import numpy as np

_log = logging.getLogger("okvis2_torch")


class ViSensorBase:
    """Sensor interface: register callbacks, start/stop streaming."""

    def __init__(self):
        self.images_callback: Optional[Callable] = None  # (t, [img...])
        self.imu_callback: Optional[Callable] = None  # (t, acc, gyr)

    def set_images_callback(self, cb: Callable):
        self.images_callback = cb

    def set_imu_callback(self, cb: Callable):
        self.imu_callback = cb

    def start_streaming(self) -> bool:
        raise NotImplementedError

    def stop_streaming(self) -> bool:
        raise NotImplementedError


class RealsenseSensor(ViSensorBase):
    """Intel Realsense D435i/D455 stereo-IR + IMU sensor.

    The reference's configuration: the IR emitter off for the stereo pair
    (structured light would corrupt feature matching), global time on, the
    accel stream interpolated to the gyro stamps (Realsense.cpp's IMU
    handling).

    Timestamps follow Realsense.cpp:106-158: where the device gives frame
    metadata, the sensor clock's RS2_FRAME_METADATA_FRAME_TIMESTAMP
    (microseconds) plus a running mean of the host offset (saturating at
    1000 samples, ``checkFrameAndUpdate``), so that image times keep the
    sensor clock's spacing on the host epoch the IMU stream uses; without
    metadata the sensor falls back to host timestamps once, with a
    warning. Frame-counter gaps (RS2_FRAME_METADATA_FRAME_COUNTER) are
    logged as dropped frames.
    """

    def __init__(self, width=848, height=480, fps=30, imu_rate=200, rgbd=False):
        super().__init__()
        try:
            import pyrealsense2 as rs  # noqa: F401
        except ImportError as e:
            raise RuntimeError(
                "pyrealsense2 is not available in this environment; "
                "RealsenseSensor requires the librealsense SDK"
            ) from e
        self._rs = __import__("pyrealsense2")
        self.width, self.height, self.fps = width, height, fps
        self.imu_rate = imu_rate
        self.rgbd = rgbd
        self._pipeline = None
        self._thread: Optional[threading.Thread] = None
        self._stop = False
        self._accel_buffer: List = []
        # metadata timestamping state (Realsense.cpp:138-142)
        self._has_device_ts = True
        self._host_offset_us = 0.0
        self._ts_samples = 0
        self._last_frame_counter = None

    # -- metadata-based timestamps (Realsense.cpp:106-158) -------------
    def _frame_time(self, frame) -> float:
        """Frame time in seconds: the sensor's metadata clock plus the
        running-mean host offset where available, the host clock else."""
        rs = self._rs
        host_ts_ms = frame.get_timestamp()
        md = rs.frame_metadata_value.frame_timestamp
        if self._has_device_ts and not frame.supports_frame_metadata(md):
            _log.warning("Device timestamps not available. Switching to host timestamps")
            self._has_device_ts = False
        if not self._has_device_ts:
            return host_ts_ms * 1e-3
        sensor_ts_us = float(frame.get_frame_metadata(md))
        offset = host_ts_ms * 1e3 - sensor_ts_us
        n = self._ts_samples
        self._host_offset_us = (n * self._host_offset_us + offset) / (n + 1)
        self._ts_samples = min(n + 1, 1000)  # saturates as the reference's
        return (sensor_ts_us + self._host_offset_us) * 1e-6

    def _check_frame_counter(self, frame):
        """Warn on RS2_FRAME_METADATA_FRAME_COUNTER gaps (dropped frames
        corrupt the IMU/image interleaving downstream)."""
        rs = self._rs
        md = rs.frame_metadata_value.frame_counter
        if not frame.supports_frame_metadata(md):
            return
        c = int(frame.get_frame_metadata(md))
        last = self._last_frame_counter
        self._last_frame_counter = c
        if last is not None and c > last + 1:
            _log.warning("Realsense dropped %d frame(s) (counter %d -> %d)", c - last - 1, last, c)

    def start_streaming(self) -> bool:
        rs = self._rs
        cfg = rs.config()
        cfg.enable_stream(rs.stream.infrared, 1, self.width, self.height, rs.format.y8, self.fps)
        cfg.enable_stream(rs.stream.infrared, 2, self.width, self.height, rs.format.y8, self.fps)
        cfg.enable_stream(rs.stream.gyro, rs.format.motion_xyz32f, 200)
        cfg.enable_stream(rs.stream.accel, rs.format.motion_xyz32f, 250)
        if self.rgbd:
            cfg.enable_stream(rs.stream.depth, self.width, self.height, rs.format.z16, self.fps)
        self._pipeline = rs.pipeline()
        profile = self._pipeline.start(cfg)
        # emitter off for clean IR stereo, and global time (the SDK's
        # host<->sensor clock fusion; Realsense.cpp:290-296)
        depth_sensor = profile.get_device().first_depth_sensor()
        if depth_sensor.supports(rs.option.emitter_enabled):
            depth_sensor.set_option(rs.option.emitter_enabled, 0)
        if depth_sensor.supports(rs.option.emitter_on_off):
            depth_sensor.set_option(rs.option.emitter_on_off, 0)
        if depth_sensor.supports(rs.option.global_time_enabled):
            depth_sensor.set_option(rs.option.global_time_enabled, 1)
        self._stop = False
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()
        return True

    def _process_motion(self, f):
        rs = self._rs
        m = f.as_motion_frame()
        t = self._frame_time(m)
        d = m.get_motion_data()
        v = np.asarray([d.x, d.y, d.z])
        if f.profile.stream_type() == rs.stream.accel:
            self._accel_buffer.append((t, v))
            self._accel_buffer = self._accel_buffer[-64:]
        elif self.imu_callback and self._accel_buffer:
            # accel interpolated to the gyro stamp (the two streams run at
            # different rates; Realsense.cpp's processImu_)
            ts = np.asarray([a[0] for a in self._accel_buffer])
            vs = np.stack([a[1] for a in self._accel_buffer])
            acc = np.stack([np.interp(t, ts, vs[:, i]) for i in range(3)])
            self.imu_callback(t, acc, v)

    def _loop(self):
        while not self._stop:
            frames = self._pipeline.wait_for_frames()
            for f in frames:
                if f.is_motion_frame():
                    self._process_motion(f)
            ir1 = frames.get_infrared_frame(1)
            ir2 = frames.get_infrared_frame(2)
            if ir1 and ir2 and self.images_callback:
                self._check_frame_counter(ir1)
                t = self._frame_time(ir1)
                imgs = [np.asanyarray(ir1.get_data()).astype(np.float32) / 255.0,
                        np.asanyarray(ir2.get_data()).astype(np.float32) / 255.0]
                self.images_callback(t, imgs)

    def stop_streaming(self) -> bool:
        self._stop = True
        if self._thread:
            self._thread.join()
        if self._pipeline:
            self._pipeline.stop()
        return True


class RealsenseRgbdSensor(RealsenseSensor):
    """RGBD variant (reference RealsenseRgbd.cpp:235): the aligned depth
    stream next to the IR stereo pair, delivered through its own callback
    (``SlamSystem.add_depth_image``).

    Emitter handling follows RealsenseRgbd.cpp:80-160: the projector
    alternates per frame (RS2_OPTION_EMITTER_ON_OFF); IR framesets whose
    RS2_FRAME_METADATA_FRAME_EMITTER_MODE reads off feed feature tracking
    (no dot pattern), framesets with the emitter on feed the depth callback.
    Where the device cannot report the emitter mode, the reference's
    fallback applies: alternate by frame count (even -> IR, odd -> depth)."""

    def __init__(self, width=848, height=480, fps=30, imu_rate=200):
        super().__init__(width, height, fps, imu_rate, rgbd=True)
        self.depth_callback = None
        self._align = None
        self._supports_emitter_md = True
        self._alt_ctr = 0

    def set_depth_callback(self, cb):
        self.depth_callback = cb

    def start_streaming(self) -> bool:
        ok = super().start_streaming()
        rs = self._rs
        # alternating emitter: every other frame is projector-lit (depth),
        # the dark ones go to feature tracking
        depth_sensor = self._pipeline.get_active_profile().get_device().first_depth_sensor()
        if depth_sensor.supports(rs.option.emitter_enabled):
            depth_sensor.set_option(rs.option.emitter_enabled, 1)
        if depth_sensor.supports(rs.option.emitter_on_off):
            depth_sensor.set_option(rs.option.emitter_on_off, 1)
        self._align = rs.align(rs.stream.infrared)
        return ok

    def _emitter_on(self, frame) -> Optional[bool]:
        """The emitter mode from frame metadata, or None where unsupported
        (the frame-counter fallback, RealsenseRgbd.cpp:96-104, 120-127)."""
        rs = self._rs
        md = rs.frame_metadata_value.frame_emitter_mode
        if self._supports_emitter_md and frame.supports_frame_metadata(md):
            return bool(int(frame.get_frame_metadata(md)))
        if self._supports_emitter_md:
            _log.warning("reading the emitter mode is not supported, "
                         "falling back to frame-counter alternation")
            self._supports_emitter_md = False
        return None

    def _loop(self):
        while not self._stop:
            frames = self._pipeline.wait_for_frames()
            if self._align is not None:
                frames = self._align.process(frames)
            for f in frames:
                if f.is_motion_frame():
                    self._process_motion(f)
            ir1 = frames.get_infrared_frame(1)
            ir2 = frames.get_infrared_frame(2)
            depth = frames.get_depth_frame()
            if not (ir1 and ir2):
                continue
            self._check_frame_counter(ir1)
            t = self._frame_time(ir1)
            em = self._emitter_on(ir1)
            if em is None:  # no metadata: alternate by count
                em = self._alt_ctr % 2 == 1
                self._alt_ctr += 1
            if not em and self.images_callback:
                # projector dark: clean IR for feature tracking
                imgs = [np.asanyarray(ir1.get_data()).astype(np.float32) / 255.0,
                        np.asanyarray(ir2.get_data()).astype(np.float32) / 255.0]
                self.images_callback(t, imgs)
            if em and depth and self.depth_callback:
                # projector lit: depth is trustworthy
                self.depth_callback(self._frame_time(depth),
                                    np.asanyarray(depth.get_data()).astype(np.float32)
                                    * 1e-3)  # z16 [mm] -> metres
