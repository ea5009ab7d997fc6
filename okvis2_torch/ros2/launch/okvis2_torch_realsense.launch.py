"""Launch the live Realsense node (reference okvis_node_realsense)."""

from launch import LaunchDescription
from launch.actions import DeclareLaunchArgument
from launch.substitutions import LaunchConfiguration
from launch_ros.actions import Node


def generate_launch_description():
    config = LaunchConfiguration("config")
    return LaunchDescription([
        DeclareLaunchArgument("config"),
        Node(
            package="okvis2_torch",
            executable="okvis2_torch_realsense",
            name="okvis2_torch_realsense",
            arguments=[config],
            output="screen",
        ),
    ])
