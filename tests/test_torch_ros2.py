"""The port's rclpy side (``okvis2_torch.ros2``: bridge, republisher, launch
files, the nodes' command line) against the JAX package's on the CPU.

Neither package can reach ROS2 here, so the same stub modules stand in for
``rclpy``, ``sensor_msgs.msg``, ``nav_msgs.msg``, ``geometry_msgs.msg``,
``launch``, ``launch.actions``, ``launch.substitutions`` and
``launch_ros.actions`` (installed with ``monkeypatch.setitem(sys.modules,
...)``), and both packages run on them: the publisher's Odometry and Path
(its 1000-pose tail), the subscriber's calls into a recording system
(images grouped by stamp, a late camera), the republisher's restamping
under a stub clock, the launch descriptions' nodes, ``nodes.main``'s usage
line and exit code, ``main_republisher``; and without the stubs, the
``RuntimeError`` that names rclpy.
"""

import copy
import importlib.util
import os
import sys
import types

import numpy as np
import pytest

from okvis2_torch.ros2 import bridge as tbridge
from okvis2_torch.ros2 import nodes as tnodes
from okvis2_torch.ros2 import republisher as trepub
from okvis2_tpu.ros2 import bridge as jbridge
from okvis2_tpu.ros2 import nodes as jnodes
from okvis2_tpu.ros2 import republisher as jrepub

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGES = {"jax": (jbridge, jrepub, jnodes, "okvis2_tpu"),
            "port": (tbridge, trepub, tnodes, "okvis2_torch")}


# -- the stubs --------------------------------------------------------------

class _Msg:
    """A message: attributes set freely, compared by value."""

    def __eq__(self, other):
        return type(self) is type(other) and vars(self) == vars(other)

    def __repr__(self):
        return f"{type(self).__name__}({vars(self)})"


def _msg_type(name, **fields):
    def init(self):
        for k, make in fields.items():
            setattr(self, k, make())

    return type(name, (_Msg,), {"__init__": init})


Time = _msg_type("Time", sec=int, nanosec=int)
Header = _msg_type("Header", stamp=Time, frame_id=str)
Vector3 = _msg_type("Vector3", x=float, y=float, z=float)
Point = _msg_type("Point", x=float, y=float, z=float)
Quaternion = _msg_type("Quaternion", x=float, y=float, z=float, w=lambda: 1.0)
Pose = _msg_type("Pose", position=Point, orientation=Quaternion)
PoseWithCovariance = _msg_type("PoseWithCovariance", pose=Pose, covariance=lambda: [0.0] * 36)
Odometry = _msg_type("Odometry", header=Header, child_frame_id=str, pose=PoseWithCovariance)
PoseStamped = _msg_type("PoseStamped", header=Header, pose=Pose)
Path = _msg_type("Path", header=Header, poses=list)
Image = _msg_type("Image", header=Header, height=int, width=int, encoding=str,
                  is_bigendian=int, step=int, data=bytes)
Imu = _msg_type("Imu", header=Header, orientation=Quaternion, angular_velocity=Vector3,
                linear_acceleration=Vector3)
PointCloud2 = _msg_type("PointCloud2", header=Header)


class _Publisher:
    def __init__(self, msg_type, topic, depth):
        self.msg_type, self.topic, self.depth = msg_type, topic, depth
        self.sent = []

    def publish(self, msg):
        self.sent.append(msg)


class _Node:
    def __init__(self, name, clock):
        self.name = name
        self.publishers, self.subscriptions = [], []
        self._clock = clock

    def create_publisher(self, msg_type, topic, depth):
        self.publishers.append(_Publisher(msg_type, topic, depth))
        return self.publishers[-1]

    def create_subscription(self, msg_type, topic, callback, depth):
        self.subscriptions.append((msg_type, topic, callback, depth))
        return self.subscriptions[-1]

    def get_clock(self):
        return self._clock

    def publisher(self, topic):
        return next(p for p in self.publishers if p.topic == topic)


class _Clock:
    """The node clock: each ``now()`` moves it on by ``step_ns``."""

    def __init__(self, start_ns, step_ns):
        self.ns, self.step = start_ns, step_ns

    def now(self):
        self.ns += self.step
        return types.SimpleNamespace(nanoseconds=self.ns)


def _rclpy_stub(clock):
    rclpy = types.ModuleType("rclpy")
    rclpy.nodes = []
    rclpy.calls = []

    def create_node(name):
        rclpy.nodes.append(_Node(name, clock))
        return rclpy.nodes[-1]

    rclpy.create_node = create_node
    rclpy.init = lambda: rclpy.calls.append("init")
    rclpy.shutdown = lambda: rclpy.calls.append("shutdown")
    rclpy.ok = lambda: False
    rclpy.spin = lambda node: rclpy.calls.append(("spin", node.name))
    rclpy.spin_once = lambda node, timeout_sec=None: rclpy.calls.append(("spin_once", node.name))
    return rclpy


def _launch_stubs():
    def recorder(kind):
        def make(*args, **kwargs):
            return (kind, args, kwargs)

        return make

    mods = {}
    for name, attrs in (("launch", {"LaunchDescription": recorder("LaunchDescription")}),
                        ("launch.actions", {"DeclareLaunchArgument": recorder("Declare")}),
                        ("launch.substitutions",
                         {"LaunchConfiguration": recorder("LaunchConfiguration")}),
                        ("launch_ros", {}),
                        ("launch_ros.actions", {"Node": recorder("Node")})):
        mod = types.ModuleType(name)
        for k, v in attrs.items():
            setattr(mod, k, v)
        mods[name] = mod
    return mods


@pytest.fixture
def ros(monkeypatch):
    """The stubs in ``sys.modules``; returns (rclpy stub, clock)."""
    clock = _Clock(1_700_000_000_123_456_789, 1_000_000)
    rclpy = _rclpy_stub(clock)
    msgs = {"sensor_msgs.msg": dict(Image=Image, Imu=Imu, PointCloud2=PointCloud2),
            "nav_msgs.msg": dict(Odometry=Odometry, Path=Path),
            "geometry_msgs.msg": dict(PoseStamped=PoseStamped)}
    monkeypatch.setitem(sys.modules, "rclpy", rclpy)
    for name, attrs in msgs.items():
        pkg = types.ModuleType(name.split(".")[0])
        mod = types.ModuleType(name)
        for k, v in attrs.items():
            setattr(mod, k, v)
        pkg.msg = mod
        monkeypatch.setitem(sys.modules, name.split(".")[0], pkg)
        monkeypatch.setitem(sys.modules, name, mod)
    for name, mod in _launch_stubs().items():
        monkeypatch.setitem(sys.modules, name, mod)
    return rclpy, clock


# -- the publisher ------------------------------------------------------------

N_UPDATES = 1005


def _updates():
    rng = np.random.default_rng(2)
    for k in range(N_UPDATES):
        q = rng.normal(size=4)
        pose = np.concatenate([rng.normal(size=3) * 5, q / np.linalg.norm(q)])
        yield 1_403_636_579.0 + 0.05 * k + rng.uniform(0, 1e-3), k, pose, None


def test_publisher(ros):
    out = {}
    for name, (bridge, _, _, _) in PACKAGES.items():
        pub = bridge.OkvisPublisher()
        for u in _updates():
            pub.publish_estimator_update(*u)
        out[name] = pub
    jp, tp = out["jax"], out["port"]
    assert [(p.msg_type, p.topic, p.depth) for p in tp.node.publishers] == \
        [(p.msg_type, p.topic, p.depth) for p in jp.node.publishers]
    odo_t = tp.node.publisher("okvis/odometry").sent
    odo_j = jp.node.publisher("okvis/odometry").sent
    assert len(odo_t) == len(odo_j) == N_UPDATES and odo_t == odo_j
    (t, _, pose, _) = next(_updates())
    first = odo_t[0]
    assert first.header.stamp.sec == int(t) and first.header.stamp.nanosec == int((t % 1.0) * 1e9)
    assert first.header.frame_id == "world" and first.child_frame_id == "imu"
    assert [first.pose.pose.position.x, first.pose.pose.orientation.w] == [pose[0], pose[6]]
    path_t, path_j = tp.node.publisher("okvis/path").sent, jp.node.publisher("okvis/path").sent
    assert [len(p.poses) for p in path_t] == [len(p.poses) for p in path_j] == \
        [min(k + 1, 1000) for k in range(N_UPDATES)]
    for k in (0, 1, 998, 999, 1000, N_UPDATES - 1):
        assert path_t[k] == path_j[k], k
    # the tail: the last 1000 poses, oldest first
    assert path_t[-1].poses[0].header == odo_t[N_UPDATES - 1000].header
    assert path_t[-1].poses[-1].pose == odo_t[-1].pose.pose


# -- the subscriber ----------------------------------------------------------

class _RecordingSystem:
    def __init__(self):
        self.calls = []

    def add_images(self, t, imgs):
        self.calls.append(("images", t, [np.array(i) for i in imgs]))
        return True

    def add_imu_measurement(self, t, acc, gyr):
        self.calls.append(("imu", t, np.array(acc), np.array(gyr)))
        return True


def _stamp(msg, ns):
    msg.header.stamp.sec, msg.header.stamp.nanosec = ns // 10**9, ns % 10**9
    return msg


def _messages():
    """(topic index, message): IMU at 200 Hz, stereo images at 20 Hz, cam1's
    image of the third frame after the next IMU sample, cam1's image of the
    fourth stamped 0.3 ms after cam0's, and a cam0 image whose partner never
    comes."""
    rng = np.random.default_rng(4)
    out = []
    t0 = 1_403_636_579_763_555_584
    late = []
    for k in range(40):
        ns = t0 + k * 5_000_000
        imu = _stamp(Imu(), ns)
        for v, vals in ((imu.angular_velocity, rng.normal(size=3)),
                        (imu.linear_acceleration, rng.normal(size=3) + [0, 0, 9.81])):
            v.x, v.y, v.z = map(float, vals)
        out.append((2, imu))
        out += late
        late = []
        if k % 10 == 0:
            for ci in (0, 1):
                img = _stamp(Image(), ns + (1 if ci else 0) * 300_000 * (k == 30))
                img.height, img.width = 6, 9
                img.data = rng.integers(0, 256, 54, dtype=np.uint8).tobytes()
                (late if (ci, k) == (1, 20) else out).append((ci, img))
    orphan = _stamp(Image(), t0 + 41 * 5_000_000)
    orphan.height, orphan.width, orphan.data = 6, 9, bytes(54)
    return out + [(0, orphan)]


def test_subscriber(ros):
    topics = ["/okvis/cam0/image_raw", "/okvis/cam1/image_raw"]
    out = {}
    for name, (bridge, _, _, _) in PACKAGES.items():
        system = _RecordingSystem()
        sub = bridge.OkvisSubscriber(system, topics, imu_topic="/okvis/imu")
        subs = sub.node.subscriptions
        assert [(s[0], s[1], s[3]) for s in subs] == \
            [(Image, topics[0], 10), (Image, topics[1], 10), (Imu, "/okvis/imu", 200)]
        for ti, msg in _messages():
            subs[ti][2](copy.deepcopy(msg))
        out[name] = system.calls
    ct, cj = out["port"], out["jax"]
    assert len(ct) == len(cj) == 40 + 4
    for a, b in zip(ct, cj):
        assert a[0] == b[0] and a[1] == b[1]
        for x, y in zip(a[2:], b[2:]):
            if isinstance(x, list):
                assert all(p.dtype == q.dtype == np.float32 and np.array_equal(p, q)
                           for p, q in zip(x, y))
            else:
                assert np.array_equal(x, y)
    images = [c for c in ct if c[0] == "images"]
    # the late image completes its frame after the next IMU sample; the
    # 0.3 ms offset of the fourth frame still rounds to its millisecond
    assert [round(c[1], 3) for c in images] == [round(1_403_636_579.763555584 + 0.05 * k, 3)
                                                for k in range(4)]


# -- the republisher -----------------------------------------------------------

def test_republisher(ros):
    rclpy, clock = ros
    topics = ["/camera/infra1/image_rect_raw", "/camera/infra2/image_rect_raw"]
    stamps = [1_000_000_123, 1_000_000_123, 1_005_000_000, 1_033_333_333, 1_033_333_333,
              2_000_000_001]
    out = {}
    for name, (_, repub, _, _) in PACKAGES.items():
        clock.ns = 1_700_000_000_123_456_789
        rp = repub.RePublisher(topics, "/camera/imu")
        subs = rp.node.subscriptions
        assert [(s[0], s[1], s[3]) for s in subs] == \
            [(Image, topics[0], 10), (Image, topics[1], 10), (Imu, "/camera/imu", 100)]
        for k, ns in enumerate(stamps):
            subs[(0, 1, 2, 0, 1, 2)[k]][2](_stamp(Image() if k % 3 < 2 else Imu(), ns))
        out[name] = [(p.topic, [(m.header.stamp.sec, m.header.stamp.nanosec) for m in p.sent])
                     for p in rp.node.publishers]
    assert out["port"] == out["jax"]
    assert [t for t, _ in out["port"]] == ["/okvis/cam0/image_raw", "/okvis/cam1/image_raw",
                                           "/okvis/imu"]
    # the offset is set once, by the first message against the first clock read
    t = 1 + 123 * 1e-9
    t2 = t + ((1_700_000_000_123_456_789 + 1_000_000) * 1e-9 - t)
    assert out["port"][0][1][0] == (int(t2), int((t2 - int(t2)) * 1e9))
    assert len(out["port"][2][1]) == 2


# -- launch files, the command line ---------------------------------------------

def _launch_file(package, name):
    path = os.path.join(ROOT, package, "ros2", "launch", f"{package}_{name}.launch.py")
    spec = importlib.util.spec_from_file_location(f"_{package}_{name}_launch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.generate_launch_description()


@pytest.mark.parametrize("name", ["realsense", "subscriber"])
def test_launch_descriptions(ros, name):
    jd, td = _launch_file("okvis2_tpu", name), _launch_file("okvis2_torch", name)
    assert td[0] == jd[0] == "LaunchDescription"
    as_port = repr(jd).replace("okvis2_tpu", "okvis2_torch")
    assert repr(td) == as_port
    nodes = [e[2] for e in td[1][0] if e[0] == "Node"]
    assert {n["package"] for n in nodes} == {"okvis2_torch"}
    assert len(nodes) == {"realsense": 1, "subscriber": 2}[name]


def test_launch_files_need_launch():
    for package in ("okvis2_tpu", "okvis2_torch"):
        with pytest.raises(ImportError):
            _launch_file(package, "subscriber")


@pytest.mark.parametrize("argv", [["nodes"], ["nodes", "bogus"]])
def test_nodes_usage(monkeypatch, capsys, argv):
    for name, (_, _, nodes, package) in PACKAGES.items():
        monkeypatch.setattr(sys, "argv", argv)
        assert nodes.main() == 2
        err = capsys.readouterr().err
        assert err == (f"usage: python -m {package}.ros2.nodes "
                       "{synchronous|subscriber|realsense|republisher} ...\n")


def test_main_republisher(ros):
    rclpy, _ = ros
    for name, (_, _, nodes, package) in PACKAGES.items():
        del rclpy.calls[:]
        assert nodes.main_republisher(["--imu-topic", "/imu0"]) == 0
        node = rclpy.nodes[-1]
        assert node.name == f"{package}_republisher"
        assert [s[1] for s in node.subscriptions] == [
            "/camera/infra1/image_rect_raw", "/camera/infra2/image_rect_raw", "/imu0"]
        assert rclpy.calls == ["init", ("spin", node.name), "shutdown"]


def test_rclpy_missing(monkeypatch):
    monkeypatch.setitem(sys.modules, "rclpy", None)  # import rclpy raises ImportError
    for name, (bridge, repub, _, _) in PACKAGES.items():
        for make in (bridge.OkvisPublisher, lambda: bridge.OkvisSubscriber(None, ["/a"]),
                     lambda: repub.RePublisher(["/a"], "/b")):
            with pytest.raises(RuntimeError, match="rclpy"):
                make()
