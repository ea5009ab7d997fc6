"""rosbag2 (sqlite3 .db3 and mcap) dataset reader; needs no ROS2.

Port of ``okvis2_tpu/ros2/rosbag_reader.py`` (a module without JAX, kept
here as the port's own copy): the reference's RosbagReader
(okvis_ros2/src/RosbagReader.cpp:341) replays sensor_msgs Image/Imu topics
from rosbag2, whose API reads both sqlite3 and mcap storage. rosbag2's
sqlite3 storage is a ``messages`` table of CDR-serialised blobs; its mcap
storage is the mcap v1 container (magic + op/length records, with
Channel/Message records optionally nested inside Chunk records).
sensor_msgs/msg/Imu and Image have fixed, simple layouts, so this reader
parses both storages directly with a small CDR decoder instead of
requiring rclpy/rosbag2_py. Chunk compression "" is always supported;
"zstd"/"lz4" when the respective modules exist.

The event stream is ``pipeline.dataset.EurocDatasetReader``'s: it yields
("imu", t, accel, gyro) and ("images", t, [img, ...]) in time order, the
cameras grouped by timestamp tolerance, images float32 in [0, 1].
"""

from __future__ import annotations

import sqlite3
import struct
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np


class CdrReader:
    """Minimal XCDR1 little-endian reader (ROS2's default RMW encoding).

    Handles the 4-byte encapsulation header and the alignment rules
    needed by sensor_msgs/msg/{Imu, Image}: primitives align to their
    size relative to the start of the payload (after the header)."""

    def __init__(self, buf: bytes):
        # encapsulation: {0x00, 0x01} = CDR_LE
        if len(buf) < 4:
            raise ValueError("CDR payload too short")
        self.le = buf[1] in (0x01, 0x03)
        self.buf = buf
        self.pos = 4

    def _align(self, n: int):
        rel = self.pos - 4
        pad = (-rel) % n
        self.pos += pad

    def _unpack(self, fmt: str, size: int):
        self._align(size)
        (v,) = struct.unpack_from(
            ("<" if self.le else ">") + fmt, self.buf, self.pos
        )
        self.pos += size
        return v

    def uint8(self):
        return self._unpack("B", 1)

    def int32(self):
        return self._unpack("i", 4)

    def uint32(self):
        return self._unpack("I", 4)

    def float64(self):
        return self._unpack("d", 8)

    def string(self) -> str:
        n = self.uint32()
        s = self.buf[self.pos:self.pos + n]
        self.pos += n
        return s[:-1].decode("utf-8", "replace") if n else ""

    def float64_array(self, n: int) -> np.ndarray:
        self._align(8)
        out = np.frombuffer(
            self.buf, dtype="<f8" if self.le else ">f8",
            count=n, offset=self.pos,
        )
        self.pos += 8 * n
        return np.asarray(out)

    def bytes_seq(self) -> bytes:
        n = self.uint32()
        b = self.buf[self.pos:self.pos + n]
        self.pos += n
        return b

    def header(self) -> float:
        """std_msgs/Header -> timestamp [s] (frame_id consumed)."""
        sec = self.int32()
        nanosec = self.uint32()
        self.string()
        return sec + nanosec * 1e-9


def parse_imu(buf: bytes) -> Tuple[float, np.ndarray, np.ndarray]:
    """sensor_msgs/msg/Imu -> (t, accel [3], gyro [3])."""
    r = CdrReader(buf)
    t = r.header()
    r.float64_array(4)  # orientation quaternion
    r.float64_array(9)  # orientation covariance
    gyro = r.float64_array(3).copy()
    r.float64_array(9)
    accel = r.float64_array(3).copy()
    r.float64_array(9)
    return t, accel, gyro


def parse_image(buf: bytes) -> Tuple[float, np.ndarray]:
    """sensor_msgs/msg/Image -> (t, gray float32 [H,W] in [0,1])."""
    r = CdrReader(buf)
    t = r.header()
    height = r.uint32()
    width = r.uint32()
    encoding = r.string()
    r.uint8()  # is_bigendian
    step = r.uint32()
    data = r.bytes_seq()
    a = np.frombuffer(data, np.uint8)
    if encoding in ("mono8", "8UC1"):
        img = a.reshape(height, step)[:, :width]
    elif encoding in ("rgb8", "bgr8"):
        img = a.reshape(height, step // 3, 3)[:, :width, :]
        img = img.mean(axis=-1).astype(np.uint8)
    else:
        raise ValueError(f"unsupported image encoding {encoding!r}")
    return t, img.astype(np.float32) / 255.0


MCAP_MAGIC = b"\x89MCAP0\r\n"

# mcap v1 opcodes (mcap.dev/spec)
_OP_CHANNEL = 0x04
_OP_MESSAGE = 0x05
_OP_CHUNK = 0x06
_OP_FOOTER = 0x02
_OP_DATA_END = 0x0F


def _mcap_str(b, pos: int) -> Tuple[str, int]:
    (n,) = struct.unpack_from("<I", b, pos)
    s = bytes(b[pos + 4:pos + 4 + n]).decode("utf-8", "replace")
    return s, pos + 4 + n


def _mcap_records(b, start: int, end: int):
    """Iterate (opcode, body memoryview) over an mcap record sequence."""
    pos = start
    view = memoryview(b)
    while pos + 9 <= end:
        op = b[pos]
        (ln,) = struct.unpack_from("<Q", b, pos + 1)
        yield op, view[pos + 9:pos + 9 + ln]
        pos += 9 + ln
        if op == _OP_FOOTER:
            break


class _McapStorage:
    """mcap v1 container parser: channels + time-sorted messages.

    Reads the whole data section (top-level records and records nested
    in Chunk records); message payloads stay as zero-copy memoryview
    slices until decoded."""

    def __init__(self, path: str):
        with open(path, "rb") as f:
            self.buf = f.read()
        if self.buf[:8] != MCAP_MAGIC:
            raise ValueError(f"{path}: not an mcap file")
        self.topics: Dict[str, int] = {}  # topic -> channel id
        self.messages: List[Tuple[int, int, object]] = []
        for op, body in _mcap_records(self.buf, 8, len(self.buf)):
            self._handle(op, body)
            if op == _OP_DATA_END:
                break
        self.messages.sort(key=lambda m: m[0])

    def _handle(self, op: int, body):
        if op == _OP_CHANNEL:
            (cid,) = struct.unpack_from("<H", body, 0)
            topic, _ = _mcap_str(body, 4)  # skips schema_id (u16 at 2)
            self.topics[topic] = cid
        elif op == _OP_MESSAGE:
            (cid,) = struct.unpack_from("<H", body, 0)
            (log_time,) = struct.unpack_from("<Q", body, 6)
            self.messages.append((log_time, cid, body[22:]))
        elif op == _OP_CHUNK:
            # u64 start, u64 end, u64 uncompressed_size, u32 crc,
            # string compression, u64 records_size, records
            comp, pos = _mcap_str(body, 28)
            (rs,) = struct.unpack_from("<Q", body, pos)
            pos += 8
            blob = body[pos:pos + rs]
            if comp == "":
                raw = blob
            elif comp == "zstd":
                import zstandard  # gated: not in every image

                raw = zstandard.ZstdDecompressor().decompress(
                    bytes(blob)
                )
            elif comp == "lz4":
                import lz4.frame  # gated

                raw = lz4.frame.decompress(bytes(blob))
            else:
                raise ValueError(f"unsupported chunk compression {comp!r}")
            for op2, b2 in _mcap_records(raw, 0, len(raw)):
                self._handle(op2, b2)


class RosbagReader:
    """Replay Image/Imu topics from a rosbag2 file (.db3 or .mcap —
    the reference's rosbag2 API reads both, RosbagReader.cpp:341).

    imu_topic / image_topics select the streams (image_topics order
    defines the camera index)."""

    def __init__(
        self,
        path: str,
        image_topics: List[str],
        imu_topic: str,
        sync_tolerance: float = 0.005,
    ):
        self.image_topics = list(image_topics)
        self.imu_topic = imu_topic
        self.sync_tolerance = sync_tolerance
        with open(path, "rb") as f:
            magic = f.read(8)
        if magic == MCAP_MAGIC or path.endswith(".mcap"):
            self.conn = None
            self._mcap = _McapStorage(path)
            names = {t: (cid, "") for t, cid in self._mcap.topics.items()}
        else:
            self._mcap = None
            self.conn = sqlite3.connect(path)
            cur = self.conn.execute("SELECT id, name, type FROM topics")
            names = {}
            for tid, name, typ in cur.fetchall():
                names[name] = (tid, typ)
        missing = [
            t for t in [imu_topic] + image_topics if t not in names
        ]
        if missing:
            raise KeyError(
                f"topics {missing} not in bag (has {sorted(names)})"
            )
        self._imu_tid = names[imu_topic][0]
        self._img_tids = {
            names[t][0]: ci for ci, t in enumerate(image_topics)
        }

    def _raw_messages(self) -> Iterator[Tuple[int, bytes]]:
        """(topic_id, blob) in time order, selected topics only."""
        tids = [self._imu_tid] + list(self._img_tids)
        if self._mcap is not None:
            want = set(tids)
            for _lt, cid, blob in self._mcap.messages:
                if cid in want:
                    yield cid, bytes(blob)  # CdrReader slices/decodes
            return
        q = (
            "SELECT topic_id, timestamp, data FROM messages "
            f"WHERE topic_id IN ({','.join('?' * len(tids))}) "
            "ORDER BY timestamp"
        )
        for tid, _ts, blob in self.conn.execute(q, tids):
            yield tid, blob

    def stream(self) -> Iterator[tuple]:
        """Yields ("imu", t, accel, gyro) / ("images", t, [img...])."""
        pending: Dict[int, Tuple[float, np.ndarray]] = {}
        n_cams = len(self._img_tids)
        for tid, blob in self._raw_messages():
            if tid == self._imu_tid:
                t, accel, gyro = parse_imu(blob)
                yield ("imu", t, accel, gyro)
                continue
            ci = self._img_tids[tid]
            t, img = parse_image(blob)
            pending[ci] = (t, img)
            if len(pending) == n_cams:
                ts = [pending[c][0] for c in range(n_cams)]
                if max(ts) - min(ts) <= self.sync_tolerance:
                    yield (
                        "images", float(np.mean(ts)),
                        [pending[c][1] for c in range(n_cams)],
                    )
                    pending = {}
                else:
                    # drop the oldest frame of the unsynced group
                    oldest = min(pending, key=lambda c: pending[c][0])
                    del pending[oldest]

    def close(self):
        if self.conn is not None:
            self.conn.close()
