"""ROS2 node executables.

Port of ``okvis2_tpu/ros2/nodes.py``: the reference's four node mains
(okvis_ros2/src/okvis_node_synchronous.cpp:65-219, okvis_node_subscriber,
okvis_node_realsense, okvis_node_realsense_publisher):

  python -m okvis2_torch.ros2.nodes synchronous <config.yaml> <bag.db3|bag.mcap>
  python -m okvis2_torch.ros2.nodes subscriber  <config.yaml>
  python -m okvis2_torch.ros2.nodes realsense   <config.yaml> [--rgbd]
  python -m okvis2_torch.ros2.nodes republisher

`synchronous` replays a rosbag2 bag through the synchronous SLAM loop and
needs no ROS2 install (the bag reader parses CDR directly); `subscriber`
and `republisher` need rclpy, `realsense` needs pyrealsense2. The mains
that run the system take ``device`` (None: the CUDA card; raises without
one) and ``dtype``, as ``apps/app_synchronous.py`` does; from the command
line they run on the card in float32.
"""

from __future__ import annotations

import argparse
import sys

import torch


def _build_slam(config_path: str, device=None, dtype=torch.float32):
    """The system as the JAX node builds it: the config's estimator and
    frontend fields, but not the realtime budget (``realtime_min_iterations``,
    ``enforce_realtime``, ``realtime_time_limit`` stay at their defaults) and
    no ``LoopClosureConfig``; the synchronous loop."""
    from okvis2_torch import resolve_device
    from okvis2_torch.config import read_config_file
    from okvis2_torch.frontend.detection import DetectionConfig
    from okvis2_torch.graph.estimator import EstimatorConfig
    from okvis2_torch.pipeline.frontend_pipeline import FrontendConfig
    from okvis2_torch.pipeline.slam import SlamSystem

    dev = resolve_device(device)
    params = read_config_file(config_path, dtype=dtype, device=dev)
    est_cfg = EstimatorConfig(
        num_keyframes=params.estimator.num_keyframes,
        num_imu_frames=params.estimator.num_imu_frames,
        num_loop_closure_frames=params.estimator.num_loop_closure_frames,
        realtime_iterations=params.estimator.realtime_max_iterations,
        online_extrinsics=params.camera_rig.online_extrinsics,
        ext_sigma_r=params.camera_rig.sigma_r,
        ext_sigma_alpha=params.camera_rig.sigma_alpha,
    )
    fe_cfg = FrontendConfig(
        detection=DetectionConfig(max_keypoints=params.frontend.max_num_keypoints,
                                  octaves=max(params.frontend.octaves, 1)),
        matching_threshold=int(params.frontend.matching_threshold),
        keyframe_overlap_threshold=params.frontend.keyframe_overlap,
    )
    slam = SlamSystem(params.camera_tuple, params.extrinsics_list, params.imu.params,
                      est_cfg, fe_cfg, do_loop_closures=params.estimator.do_loop_closures,
                      device=dev)
    return slam, params


def main_synchronous(argv, device=None, dtype=torch.float32):
    p = argparse.ArgumentParser(prog="nodes synchronous")
    p.add_argument("config")
    p.add_argument("bag")
    p.add_argument("--imu-topic", default="/okvis/imu")
    p.add_argument("--image-topics", nargs="+",
                   default=["/okvis/cam0/image_raw", "/okvis/cam1/image_raw"])
    p.add_argument("--max-frames", type=int, default=0)
    args = p.parse_args(argv)

    from okvis2_torch.ros2.rosbag_reader import RosbagReader

    slam, params = _build_slam(args.config, device, dtype)
    reader = RosbagReader(args.bag, args.image_topics, args.imu_topic,
                          params.camera_rig.timestamp_tolerance)
    n = 0
    for ev in reader.stream():
        if ev[0] == "imu":
            slam.add_imu_measurement(ev[1], ev[2], ev[3])
        else:
            slam.add_images(ev[1], ev[2])
            slam.process_frame()
            n += 1
            if args.max_frames and n >= args.max_frames:
                break
    print(f"processed {n} frames, {len(slam.estimator.landmarks)} landmarks")
    return 0


def main_subscriber(argv, device=None, dtype=torch.float32):
    p = argparse.ArgumentParser(prog="nodes subscriber")
    p.add_argument("config")
    args = p.parse_args(argv)
    import rclpy

    from okvis2_torch.ros2.bridge import OkvisPublisher, OkvisSubscriber

    rclpy.init()
    slam, params = _build_slam(args.config, device, dtype)
    image_topics = [f"/okvis/cam{ci}/image_raw" for ci in range(len(params.camera_tuple))]
    sub = OkvisSubscriber(slam, image_topics, imu_topic="/okvis/imu")
    pub = OkvisPublisher()
    slam.set_optimised_graph_callback(pub.publish_estimator_update)
    try:
        while rclpy.ok():
            rclpy.spin_once(sub.node, timeout_sec=0.005)
            slam.process_frame()
    finally:
        rclpy.shutdown()
    return 0


def main_realsense(argv, device=None, dtype=torch.float32):
    p = argparse.ArgumentParser(prog="nodes realsense")
    p.add_argument("config")
    p.add_argument("--rgbd", action="store_true",
                   help="aligned-depth stream + depth-aided landmarks")
    args = p.parse_args(argv)
    from okvis2_torch.pipeline.sensors import RealsenseRgbdSensor, RealsenseSensor

    slam, params = _build_slam(args.config, device, dtype)
    if args.rgbd:
        sensor = RealsenseRgbdSensor()
        sensor.set_depth_callback(slam.add_depth_image)
    else:
        sensor = RealsenseSensor()
    sensor.set_images_callback(lambda t, imgs: slam.add_images(t, imgs))
    sensor.set_imu_callback(lambda t, a, g: slam.add_imu_measurement(t, a, g))
    sensor.start_streaming()
    try:
        while True:
            slam.process_frame()
    finally:
        sensor.stop_streaming()
    return 0


def main_republisher(argv):
    p = argparse.ArgumentParser(prog="nodes republisher")
    p.add_argument("--image-topics", nargs="+",
                   default=["/camera/infra1/image_rect_raw", "/camera/infra2/image_rect_raw"])
    p.add_argument("--imu-topic", default="/camera/imu")
    args = p.parse_args(argv)
    import rclpy

    from okvis2_torch.ros2.republisher import RePublisher

    rclpy.init()
    rp = RePublisher(args.image_topics, args.imu_topic)
    try:
        rp.spin()
    finally:
        rclpy.shutdown()
    return 0


MAINS = {
    "synchronous": main_synchronous,
    "subscriber": main_subscriber,
    "realsense": main_realsense,
    "republisher": main_republisher,
}


def main():
    if len(sys.argv) < 2 or sys.argv[1] not in MAINS:
        print(f"usage: python -m okvis2_torch.ros2.nodes {{{'|'.join(MAINS)}}} ...",
              file=sys.stderr)
        return 2
    return MAINS[sys.argv[1]](sys.argv[2:])


if __name__ == "__main__":
    sys.exit(main())
