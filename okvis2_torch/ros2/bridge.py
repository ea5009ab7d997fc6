"""ROS2 integration (gated on rclpy).

Port of ``okvis2_tpu/ros2/bridge.py``: the reference's okvis_ros2 wrapper
(Publisher: odometry / path publishing, okvis_ros2/src/Publisher.cpp;
Subscriber: image + IMU topics -> estimator, Subscriber.cpp).

The classes implement the topic contract against rclpy's API and raise a
``RuntimeError`` naming rclpy when it is missing. The subscriber feeds
``SlamSystem.add_images`` / ``add_imu_measurement``; the publisher is the
callback that ``SlamSystem.set_optimised_graph_callback`` takes.
"""

from __future__ import annotations

from typing import List

import numpy as np


def _require_rclpy():
    try:
        import rclpy  # noqa: F401

        return __import__("rclpy")
    except ImportError as e:
        raise RuntimeError(
            "rclpy not available — ROS2 integration requires a ROS2 "
            "environment (reference: okvis_ros2)"
        ) from e


class OkvisPublisher:
    """Publishes odometry and the path (its last 1000 poses) from the
    estimator's updates."""

    def __init__(self, node_name: str = "okvis2_torch_publisher",
                 frame_id: str = "world", child_frame_id: str = "imu"):
        rclpy = _require_rclpy()
        from nav_msgs.msg import Odometry, Path
        from sensor_msgs.msg import PointCloud2

        self._rclpy = rclpy
        self.node = rclpy.create_node(node_name)
        self.frame_id = frame_id
        self.child_frame_id = child_frame_id
        self.pub_odom = self.node.create_publisher(Odometry, "okvis/odometry", 10)
        self.pub_path = self.node.create_publisher(Path, "okvis/path", 10)
        self.pub_landmarks = self.node.create_publisher(PointCloud2, "okvis/landmarks", 5)
        self._path_poses: List = []

    def publish_estimator_update(self, t: float, sid: int, pose: np.ndarray, tracking) -> None:
        from geometry_msgs.msg import PoseStamped
        from nav_msgs.msg import Odometry, Path

        msg = Odometry()
        msg.header.frame_id = self.frame_id
        msg.header.stamp.sec = int(t)
        msg.header.stamp.nanosec = int((t % 1.0) * 1e9)
        msg.child_frame_id = self.child_frame_id
        msg.pose.pose.position.x = float(pose[0])
        msg.pose.pose.position.y = float(pose[1])
        msg.pose.pose.position.z = float(pose[2])
        msg.pose.pose.orientation.x = float(pose[3])
        msg.pose.pose.orientation.y = float(pose[4])
        msg.pose.pose.orientation.z = float(pose[5])
        msg.pose.pose.orientation.w = float(pose[6])
        self.pub_odom.publish(msg)

        ps = PoseStamped()
        ps.header = msg.header
        ps.pose = msg.pose.pose
        self._path_poses.append(ps)
        path = Path()
        path.header = msg.header
        path.poses = self._path_poses[-1000:]
        self.pub_path.publish(path)


class OkvisSubscriber:
    """Subscribes to image + IMU topics and feeds a SlamSystem; a frame's
    images are grouped by their stamp rounded to the millisecond."""

    def __init__(self, slam, image_topics: List[str], imu_topic: str = "/imu0",
                 node_name: str = "okvis2_torch_subscriber"):
        rclpy = _require_rclpy()
        from sensor_msgs.msg import Image, Imu

        self._rclpy = rclpy
        self.node = rclpy.create_node(node_name)
        self.slam = slam
        self._pending: dict = {}
        self.n_cams = len(image_topics)
        for ci, topic in enumerate(image_topics):
            self.node.create_subscription(Image, topic,
                                          lambda msg, ci=ci: self._on_image(ci, msg), 10)
        self.node.create_subscription(Imu, imu_topic, self._on_imu, 200)

    @staticmethod
    def _stamp(msg) -> float:
        return msg.header.stamp.sec + msg.header.stamp.nanosec * 1e-9

    def _on_imu(self, msg):
        acc = np.asarray([msg.linear_acceleration.x, msg.linear_acceleration.y,
                          msg.linear_acceleration.z])
        gyr = np.asarray([msg.angular_velocity.x, msg.angular_velocity.y,
                          msg.angular_velocity.z])
        self.slam.add_imu_measurement(self._stamp(msg), acc, gyr)

    def _on_image(self, ci: int, msg):
        img = np.frombuffer(msg.data, np.uint8).reshape(
            msg.height, msg.width).astype(np.float32) / 255.0
        t = self._stamp(msg)
        key = round(t, 3)
        self._pending.setdefault(key, {})[ci] = img
        if len(self._pending[key]) == self.n_cams:
            imgs = [self._pending[key][c] for c in range(self.n_cams)]
            del self._pending[key]
            self.slam.add_images(t, imgs)

    def spin(self):
        self._rclpy.spin(self.node)
