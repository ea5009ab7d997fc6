"""Live Realsense SLAM app (no ROS needed).

Port of ``okvis2_tpu/apps/app_realsense.py`` (okvis_app_realsense,
okvis_apps/src/okvis_app_realsense.cpp:198): stream a D435i/D455 straight
into the synchronous loop, print the tracking state, and write the final
trajectory. Needs pyrealsense2 (the librealsense SDK).

    python -m okvis2_torch.apps.app_realsense <config.yaml> \\
        [--rgbd] [--duration SECONDS] [--output trajectory.csv]

runs on the CUDA card; ``main(argv, device="cpu")`` runs on the CPU.
"""

from __future__ import annotations

import argparse
import time

import torch


def main(argv=None, device=None, dtype=torch.float32):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("config")
    p.add_argument("--rgbd", action="store_true")
    p.add_argument("--duration", type=float, default=0.0)
    p.add_argument("--output", default="okvis2-realsense-trajectory.csv")
    args = p.parse_args(argv)

    from okvis2_torch import resolve_device
    from okvis2_torch.config import read_config_file
    from okvis2_torch.frontend.detection import DetectionConfig
    from okvis2_torch.graph.estimator import EstimatorConfig
    from okvis2_torch.pipeline.frontend_pipeline import FrontendConfig
    from okvis2_torch.pipeline.sensors import RealsenseRgbdSensor, RealsenseSensor
    from okvis2_torch.pipeline.slam import SlamSystem
    from okvis2_torch.pipeline.trajectory import write_euroc_csv

    dev = resolve_device(device)
    params = read_config_file(args.config, dtype=dtype, device=dev)
    slam = SlamSystem(
        params.camera_tuple, params.extrinsics_list, params.imu.params,
        EstimatorConfig(
            num_keyframes=params.estimator.num_keyframes,
            num_imu_frames=params.estimator.num_imu_frames,
            realtime_iterations=params.estimator.realtime_max_iterations,
            enforce_realtime=params.estimator.enforce_realtime,
            realtime_time_limit=params.estimator.realtime_time_limit,
        ),
        FrontendConfig(
            detection=DetectionConfig(max_keypoints=params.frontend.max_num_keypoints),
            matching_threshold=int(params.frontend.matching_threshold),
        ),
        do_loop_closures=params.estimator.do_loop_closures,
        device=dev,
    )
    # the SDK's default 848x480, whatever size the config calibrates (as in
    # the JAX app; ROADMAP C)
    sensor = RealsenseRgbdSensor() if args.rgbd else RealsenseSensor()
    sensor.set_images_callback(slam.add_images)
    sensor.set_imu_callback(slam.add_imu_measurement)
    if args.rgbd:
        sensor.set_depth_callback(slam.add_depth_image)
    sensor.start_streaming()
    t0 = time.time()
    n = 0
    try:
        while not args.duration or time.time() - t0 < args.duration:
            if slam.process_frame():
                n += 1
                if n % 30 == 0:
                    print(f"[{n} frames] tracking={slam.tracking.tracking_quality} "
                          f"landmarks={len(slam.estimator.landmarks)}", flush=True)
            else:
                time.sleep(0.002)
    except KeyboardInterrupt:
        pass
    finally:
        sensor.stop_streaming()
    final = [(slam.estimator.states[s].t, slam.estimator.states[s].pose)
             for s in slam.estimator.state_order]
    write_euroc_csv(args.output, final)
    print(f"wrote {args.output} ({n} frames)")


if __name__ == "__main__":
    main()
