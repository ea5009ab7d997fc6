"""ROS2 entry points of the port: the rosbag2 replay (no ROS2 needed) and the rclpy nodes."""
