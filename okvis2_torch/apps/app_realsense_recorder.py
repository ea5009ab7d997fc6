"""Record a live Realsense stream into EuRoC folder format.

Port of ``okvis2_tpu/apps/app_realsense_recorder.py``
(okvis_app_realsense_recorder, okvis_apps/src/okvis_app_realsense_recorder.cpp:163):
stream the sensor's IR stereo pair and IMU into the port's
``DatasetWriter``, so that the session can be replayed later through
``app_synchronous``. Needs pyrealsense2 (the librealsense SDK); runs on
the host only.

    python -m okvis2_torch.apps.app_realsense_recorder <out_dir> \\
        [--rgbd] [--duration SECONDS]
"""

from __future__ import annotations

import argparse
import time


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("out_dir")
    p.add_argument("--rgbd", action="store_true")
    p.add_argument("--duration", type=float, default=0.0,
                   help="stop after this many seconds (0 = until Ctrl-C)")
    args = p.parse_args(argv)

    from okvis2_torch.pipeline.dataset import DatasetWriter
    from okvis2_torch.pipeline.sensors import RealsenseRgbdSensor, RealsenseSensor

    writer = DatasetWriter(args.out_dir, num_cameras=2)
    sensor = RealsenseRgbdSensor() if args.rgbd else RealsenseSensor()
    sensor.set_images_callback(writer.add_images)
    sensor.set_imu_callback(writer.add_imu_measurement)
    sensor.start_streaming()
    t0 = time.time()
    try:
        while not args.duration or time.time() - t0 < args.duration:
            time.sleep(0.2)
    except KeyboardInterrupt:
        pass
    finally:
        sensor.stop_streaming()
        writer.close()
    print(f"recorded {time.time() - t0:.1f}s into {args.out_dir}")


if __name__ == "__main__":
    main()
