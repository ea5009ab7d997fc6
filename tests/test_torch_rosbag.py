"""The port's rosbag2 reader and ROS2 bag replay (``okvis2_torch.ros2``)
against the JAX package's on the CPU.

The CDR decoders on the same bytes (every image encoding, the error for
any other, big- and little-endian payloads, the stamps), then both
packages' ``RosbagReader.stream()`` on the bags of chip_smoke.py's
``write_rosbag`` (sqlite3, and mcap with one uncompressed Chunk) and of
``tests/test_rosbag_reader.py``'s layout (sqlite3, plain and chunked mcap),
a zstd chunk, a bag with a camera late beyond the tolerance (the oldest
image of the group is dropped), and a missing topic: event for event
equal, images bit for bit.

The whole slice: ``nodes.main_synchronous`` of both packages on a .db3 bag
of ``tests/test_torch_app.py``'s EuRoC folder (320x240 stereo, 8 frames at
4 Hz) at its config, float64 on the CPU, the port with the JAX frame
program's RANSAC draws injected and the JAX frame program run with float64
standing for its float32, as in ``test_torch_app.py``: the same printed
line, the same keyframes, each state's position within 1e-3 m and the
landmark counts within 3 (``test_torch_app.py``'s bars).
"""

import sqlite3
import struct
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from okvis2_torch.graph import estimator as est_t
from okvis2_torch.pipeline import slam as tslam
from okvis2_torch.ros2 import nodes as tnodes
from okvis2_torch.ros2 import rosbag_reader as trb
from okvis2_tpu.graph import estimator as est_j
from okvis2_tpu.pipeline import frontend_pipeline as jfp
from okvis2_tpu.pipeline import slam as jslam
from okvis2_tpu.ros2 import nodes as jnodes
from okvis2_tpu.ros2 import rosbag_reader as jrb

from test_rosbag_reader import _make_bag, _make_mcap, encode_image, encode_imu
from test_torch_app import folder  # noqa: F401  (the module-scoped EuRoC folder)
from test_torch_slam import _jax_indices

POSE_TOL, LM_TOL = 1e-3, 3
TOPICS = (list(chip_smoke.BAG_IMAGE_TOPICS), chip_smoke.BAG_IMU_TOPIC)


class _BigEndianCdr(chip_smoke.CdrWriter):
    def __init__(self):
        self.buf = bytearray(b"\x00\x00\x00\x00")  # CDR_BE encapsulation

    def put(self, fmt, v):
        size = struct.calcsize(fmt)
        self.buf += b"\x00" * ((-(len(self.buf) - 4)) % size)
        self.buf += struct.pack(">" + fmt, v)


def _image_msg(ns, data, h, w, step, encoding, writer=chip_smoke.CdrWriter):
    cdr = writer()
    cdr.header(ns, "cam")
    cdr.put("I", h)
    cdr.put("I", w)
    cdr.string(encoding)
    cdr.put("B", 0)
    cdr.put("I", step)
    cdr.put("I", len(data))
    cdr.buf += data
    return bytes(cdr.buf)


def _same_image(a, b):
    assert a[0] == b[0]
    assert a[1].dtype == b[1].dtype == np.float32 and np.array_equal(a[1], b[1])


@pytest.mark.parametrize("encoding,channels,pad", [
    ("mono8", 1, 0), ("8UC1", 1, 0), ("mono8", 1, 5), ("rgb8", 3, 0), ("bgr8", 3, 0),
    ("rgb8", 3, 6),
])
def test_parse_image_both_packages(encoding, channels, pad):
    rng = np.random.default_rng(3)
    h, w = 7, 11
    step = w * channels + pad
    data = rng.integers(0, 256, (h, step), dtype=np.uint8).tobytes()
    ns = 1_403_636_579_763_555_584
    msg = _image_msg(ns, data, h, w, step, encoding)
    got, want = trb.parse_image(msg), jrb.parse_image(msg)
    _same_image(got, want)
    assert got[1].shape == (h, w) and got[0] == ns // 10**9 + (ns % 10**9) * 1e-9
    if channels == 1:
        expect = np.frombuffer(data, np.uint8).reshape(h, step)[:, :w]
        assert np.array_equal(got[1], expect.astype(np.float32) / 255.0)


def test_parse_image_rejects_other_encodings():
    msg = _image_msg(10**9, bytes(2 * 4 * 3), 3, 4, 8, "16UC1")
    for mod in (trb, jrb):
        with pytest.raises(ValueError, match="16UC1"):
            mod.parse_image(msg)
    for mod in (trb, jrb):
        with pytest.raises(ValueError, match="too short"):
            mod.CdrReader(b"\x00\x01")


@pytest.mark.parametrize("writer", [chip_smoke.CdrWriter, _BigEndianCdr])
def test_parse_imu_and_header_both_packages(writer):
    acc, gyr = [0.25, -9.80665, 1e-7], [1.5e-3, -2.25, 3.0]
    for ns in (0, 999_999_999, 1_403_636_579_763_555_584, 12 * 10**9 + 345_678_901):
        w = writer()
        w.header(ns, "imu_frame_with_a_longer_id")
        for v in [0.0, 0.0, 0.0, 1.0] + [0.0] * 9 + gyr + [0.0] * 9 + acc + [0.0] * 9:
            w.put("d", v)
        msg = bytes(w.buf)
        t_t, a_t, g_t = trb.parse_imu(msg)
        t_j, a_j, g_j = jrb.parse_imu(msg)
        assert t_t == t_j == ns // 10**9 + (ns % 10**9) * 1e-9
        assert np.array_equal(a_t, a_j) and np.array_equal(g_t, g_j)
        assert a_t.tolist() == acc and g_t.tolist() == gyr
    # the JAX test's own encoder
    msg = encode_imu(12.345678901, [1.0, -2.0, 9.81], [0.1, 0.2, -0.3])
    assert [np.asarray(x).tolist() for x in trb.parse_imu(msg)] == \
        [np.asarray(x).tolist() for x in jrb.parse_imu(msg)]
    _same_image(trb.parse_image(encode_image(3.5, np.eye(4, 6, dtype=np.uint8))),
                jrb.parse_image(encode_image(3.5, np.eye(4, 6, dtype=np.uint8))))


def _streams_equal(path, image_topics=TOPICS[0], imu_topic=TOPICS[1], tol=0.005):
    """Both packages' streams of ``path``, event for event; returns the
    port's events."""
    rt = trb.RosbagReader(path, list(image_topics), imu_topic, tol)
    rj = jrb.RosbagReader(path, list(image_topics), imu_topic, tol)
    et, ej = list(rt.stream()), list(rj.stream())
    rt.close()
    rj.close()
    assert len(et) == len(ej) > 0
    for a, b in zip(et, ej):
        assert a[0] == b[0] and a[1] == b[1]
        if a[0] == "imu":
            assert np.array_equal(a[2], b[2]) and np.array_equal(a[3], b[3])
        else:
            assert len(a[2]) == len(b[2])
            for x, y in zip(a[2], b[2]):
                assert x.dtype == y.dtype == np.float32 and np.array_equal(x, y)
    return et


@pytest.fixture(scope="module")
def bags(folder):  # noqa: F811
    root, config, dataset, gt = folder
    out = {}
    for storage, ext in (("sqlite3", "db3"), ("mcap", "mcap")):
        out[storage] = str(root / f"session.{ext}")
        chip_smoke.write_rosbag(dataset, out[storage], storage)
    return out


@pytest.mark.parametrize("storage", ["sqlite3", "mcap"])
def test_write_rosbag_streams(bags, folder, storage):  # noqa: F811
    """``write_rosbag``'s bags: both packages' streams equal, and equal to
    the EuRoC reader's stream of the folder (the check phase 15 makes)."""
    events = _streams_equal(bags[storage])
    assert sum(e[0] == "images" for e in events) == 8
    counts, d_t, d_v = chip_smoke.check_bag_streams(folder[2], [bags[storage]], 0.005)
    assert counts == {"imu": sum(e[0] == "imu" for e in events), "images": 8}
    assert d_t < 1e-9 and d_v == 0.0


@pytest.mark.parametrize("layout", ["db3", "mcap", "mcap_chunked"])
def test_reader_bag_layouts(tmp_path, layout):
    """The bags of ``tests/test_rosbag_reader.py``'s layout."""
    path = str(tmp_path / ("session.db3" if layout == "db3" else "session.mcap"))
    imgs = _make_bag(path) if layout == "db3" else _make_mcap(path, layout == "mcap_chunked")
    events = _streams_equal(path)
    frames = [e for e in events if e[0] == "images"]
    assert len(frames) == 3 and sum(e[0] == "imu" for e in events) == 20
    for k, (_, _, pair) in enumerate(frames):
        assert np.array_equal(pair[0], imgs[k][0].astype(np.float32) / 255.0)


def _mcap_with_chunk(path, compression, compress):
    """An mcap file whose records sit in one Chunk compressed by
    ``compress`` (``compression`` its name in the record)."""
    def rec(op, body):
        return bytes([op]) + struct.pack("<Q", len(body)) + body

    def mstr(s):
        return struct.pack("<I", len(s.encode())) + s.encode()

    records = b"".join(rec(0x04, struct.pack("<HH", cid, 0) + mstr(t) + mstr("cdr")
                           + struct.pack("<I", 0))
                       for cid, t in ((1, TOPICS[1]), (2, TOPICS[0][0]), (3, TOPICS[0][1])))
    rng = np.random.default_rng(5)
    for k in range(12):
        ns = 10**9 + k * 10_000_000
        records += rec(0x05, struct.pack("<HIQQ", 1, k, ns, ns)
                       + encode_imu(ns * 1e-9, rng.normal(size=3), rng.normal(size=3)))
        if k % 4 == 1:
            for cid in (2, 3):
                img = rng.integers(0, 256, (6, 9), dtype=np.uint8)
                records += rec(0x05, struct.pack("<HIQQ", cid, k, ns + cid, ns + cid)
                               + encode_image(ns * 1e-9, img))
    blob = compress(records)
    chunk = (struct.pack("<QQQI", 0, 0, len(records), 0) + mstr(compression)
             + struct.pack("<Q", len(blob)) + blob)
    with open(path, "wb") as f:
        f.write(trb.MCAP_MAGIC + rec(0x01, mstr("ros2") + mstr("")) + rec(0x06, chunk)
                + rec(0x0F, struct.pack("<I", 0)) + rec(0x02, struct.pack("<QQI", 0, 0, 0))
                + trb.MCAP_MAGIC)


def test_reader_compressed_chunks(tmp_path):
    """A zstd chunk reads alike where ``zstandard`` exists; a chunk of an
    unknown compression raises in both packages."""
    zstandard = pytest.importorskip("zstandard")
    path = str(tmp_path / "zstd.mcap")
    _mcap_with_chunk(path, "zstd", zstandard.ZstdCompressor().compress)
    events = _streams_equal(path)
    assert sum(e[0] == "images" for e in events) == 3
    _mcap_with_chunk(path, "brotli", lambda b: b)
    for mod in (trb, jrb):
        with pytest.raises(ValueError, match="brotli"):
            mod.RosbagReader(path, *TOPICS)


def test_reader_sync_drop(tmp_path):
    """cam1's images of the second and fourth frames arrive 12 and 30 ms
    after cam0's (over the 5 ms tolerance): each such group is out of sync
    and its oldest image is dropped, until a later image completes a group
    in sync; three of the five frames come out."""
    path = str(tmp_path / "late.db3")
    conn = sqlite3.connect(path)
    conn.execute("CREATE TABLE topics (id INTEGER PRIMARY KEY, name TEXT, type TEXT, "
                 "serialization_format TEXT, offered_qos_profiles TEXT)")
    conn.execute("CREATE TABLE messages (id INTEGER PRIMARY KEY, topic_id INTEGER, "
                 "timestamp INTEGER, data BLOB)")
    for tid, name in ((1, TOPICS[1]), (2, TOPICS[0][0]), (3, TOPICS[0][1])):
        conn.execute("INSERT INTO topics VALUES (?,?,?,?,?)", (tid, name, "x", "cdr", ""))
    rng = np.random.default_rng(7)
    rows = [(1, k * 5_000_000, encode_imu(k * 5e-3, [0.0, 0.0, 9.8], [0.1, 0.0, 0.0]))
            for k in range(40)]
    for k, (d0, d1) in enumerate([(0, 1), (0, 12), (0, 2), (0, 30), (0, 1)]):
        t = 0.04 * k + 0.001
        for tid, d in ((2, d0), (3, d1)):
            img = rng.integers(0, 256, (5, 7), dtype=np.uint8)
            ts = t + d * 1e-3
            rows.append((tid, int(round(ts * 1e9)), encode_image(ts, img)))
    rows.sort(key=lambda r: r[1])
    conn.executemany("INSERT INTO messages VALUES (?,?,?,?)",
                     [(i + 1, tid, ts, data) for i, (tid, ts, data) in enumerate(rows)])
    conn.commit()
    conn.close()
    events = _streams_equal(path)
    frames = [e for e in events if e[0] == "images"]
    assert len(frames) == 3, [round(f[1], 4) for f in frames]
    assert sum(e[0] == "imu" for e in events) == 40


def test_reader_missing_topic(bags):
    for path in (bags["sqlite3"], bags["mcap"]):
        for mod in (trb, jrb):
            with pytest.raises(KeyError, match="/okvis/cam2/image_raw"):
                mod.RosbagReader(path, TOPICS[0] + ["/okvis/cam2/image_raw"], TOPICS[1])


# -- the whole slice: both nodes on one bag -------------------------------

def _port_replay(argv):
    """The port's node on ``argv`` in float64 on the CPU with the JAX frame
    program's RANSAC draws (a spawned process: JAX's float64 as the parent's
    test configuration sets it, two torch threads beside the parent's JAX
    compiles); returns what the tests read of its system."""
    import jax

    jax.config.update("jax_enable_x64", True)
    torch.set_num_threads(2)
    printed = []

    class Sampled(tslam.SlamSystem):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw, ransac_sampler=_jax_indices)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tslam, "SlamSystem", Sampled)
        mp.setattr(tnodes, "print", lambda *a: printed.append(" ".join(a)), raising=False)
        with chip_smoke.recorded_app_system(tslam, est_t) as rec:
            rc = tnodes.main_synchronous(argv, device="cpu", dtype=torch.float64)
    return _replay_record(rc, printed, rec)


def _replay_record(rc, printed, rec):
    slam = rec["systems"][0]
    est = slam.estimator
    return dict(
        rc=rc, printed=printed, device=str(getattr(slam, "device", "")),
        pipelined=slam.pipelined, landmarks=len(est.landmarks),
        keyframes=[est.state_order.index(s) for s in rec["kf_sids"]],
        poses=[(est.states[s].t, np.asarray(est.states[s].pose)) for s in est.state_order],
        estimator_cfg={f: getattr(est.cfg, f) for f in NODE_ESTIMATOR_FIELDS},
        frontend_cfg={f: getattr(slam.frontend.cfg, f) for f in NODE_FRONTEND_FIELDS},
        detection_cfg={f: getattr(slam.frontend.cfg.detection, f) for f in ("max_keypoints",
                                                                           "octaves")},
        loop_closure=slam.loop_backend is not None)


NODE_ESTIMATOR_FIELDS = ("num_keyframes", "num_imu_frames", "num_loop_closure_frames",
                         "realtime_iterations", "realtime_min_iterations", "enforce_realtime",
                         "realtime_time_limit", "online_extrinsics")
NODE_FRONTEND_FIELDS = ("matching_threshold", "keyframe_overlap_threshold")


@pytest.fixture(scope="module")
def replays(folder, bags):  # noqa: F811
    """Both nodes' replays: the port's in a spawned process while the JAX
    package compiles and runs in this one."""
    import multiprocessing

    _, config, _, gt = folder
    argv = [config, bags["sqlite3"], "--max-frames", "8"]
    printed = []
    with multiprocessing.get_context("spawn").Pool(1) as pool:
        port = pool.apply_async(_port_replay, (argv,))
        shim = types.SimpleNamespace(**{k: getattr(np, k) for k in dir(np)
                                        if not k.startswith("__")})
        shim.float32 = np.float64
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jnp, "float32", jnp.float64)
            mp.setattr(jfp, "np", shim)
            mp.setattr(jslam, "np", shim)
            mp.setattr(jnodes, "print", lambda *a: printed.append(" ".join(a)), raising=False)
            with chip_smoke.recorded_app_system(jslam, est_j) as rec:
                rc = jnodes.main_synchronous(argv)
        return {"jax": _replay_record(rc, printed, rec), "port": port.get(timeout=300)}


def test_node_replay_matches(replays):
    j, t = replays["jax"], replays["port"]
    assert t["rc"] == j["rc"] == 0
    assert t["device"] == "cpu" and not t["pipelined"] and not j["pipelined"]
    assert t["keyframes"] == j["keyframes"] and len(t["keyframes"]) >= 1
    assert len(t["poses"]) == len(j["poses"]) == 8
    for (ta, pa), (tb, pb) in zip(t["poses"], j["poses"]):
        assert ta == tb
        assert np.abs(pa[:3] - pb[:3]).max() < POSE_TOL, (pa, pb)
    assert abs(t["landmarks"] - j["landmarks"]) <= LM_TOL and t["landmarks"] > 50
    assert t["printed"] == [f"processed 8 frames, {t['landmarks']} landmarks"]
    assert j["printed"] == [f"processed 8 frames, {j['landmarks']} landmarks"]


def test_node_config_mapping(replays):
    """The node maps the config as the JAX node does: the estimator's and
    frontend's fields, the realtime budget at its defaults, no loop
    closure configuration."""
    j, t = replays["jax"], replays["port"]
    for k in ("estimator_cfg", "frontend_cfg", "detection_cfg", "loop_closure"):
        assert t[k] == j[k], k
