"""Launch the okvis2_torch subscriber node alongside the republisher
(reference: okvis_ros2/launch/*.launch.xml)."""

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
            executable="okvis2_torch_republisher",
            name="okvis2_torch_republisher",
            output="screen",
        ),
        Node(
            package="okvis2_torch",
            executable="okvis2_torch_subscriber",
            name="okvis2_torch_subscriber",
            arguments=[config],
            output="screen",
        ),
    ])
