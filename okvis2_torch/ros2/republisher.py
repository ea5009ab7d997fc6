"""RePublisher: restamp and forward Realsense topics (gated on rclpy).

Port of ``okvis2_tpu/ros2/republisher.py`` (okvis_ros2/src/RePublisher.cpp:128):
subscribes to the camera node's image/IMU topics, moves their stamps
onto the node's clock by the first offset seen between the two clocks,
and republishes them under the okvis namespace, so that the subscriber
node (and rosbag recording) see one consistent stream.
"""

from __future__ import annotations

from typing import List


class RePublisher:
    def __init__(self, image_topics_in: List[str], imu_topic_in: str,
                 namespace: str = "okvis", node_name: str = "okvis2_torch_republisher"):
        try:
            import rclpy  # noqa: F401
        except ImportError as e:
            raise RuntimeError(
                "rclpy not available — RePublisher requires a ROS2 "
                "environment (reference: okvis_ros2 RePublisher.cpp)"
            ) from e
        import rclpy
        from sensor_msgs.msg import Image, Imu

        self.node = rclpy.create_node(node_name)
        self._pub_images = [
            self.node.create_publisher(Image, f"/{namespace}/cam{ci}/image_raw", 10)
            for ci in range(len(image_topics_in))
        ]
        self._pub_imu = self.node.create_publisher(Imu, f"/{namespace}/imu", 100)
        self._offset = None  # camera clock -> node clock offset

        def _restamp(stamp):
            t = stamp.sec + stamp.nanosec * 1e-9
            now = self.node.get_clock().now().nanoseconds * 1e-9
            if self._offset is None:
                self._offset = now - t
            t2 = t + self._offset
            stamp.sec = int(t2)
            stamp.nanosec = int((t2 - int(t2)) * 1e9)
            return stamp

        def make_img_cb(ci):
            def cb(msg):
                msg.header.stamp = _restamp(msg.header.stamp)
                self._pub_images[ci].publish(msg)

            return cb

        self._subs = [
            self.node.create_subscription(Image, topic, make_img_cb(ci), 10)
            for ci, topic in enumerate(image_topics_in)
        ]

        def imu_cb(msg):
            msg.header.stamp = _restamp(msg.header.stamp)
            self._pub_imu.publish(msg)

        self._subs.append(self.node.create_subscription(Imu, imu_topic_in, imu_cb, 100))

    def spin(self):
        import rclpy

        rclpy.spin(self.node)
