"""Dataset SLAM app: a reference-format config and an EuRoC folder in, the
final trajectory CSV out.

Port of ``okvis2_tpu/apps/app_synchronous.py`` (okvis_app_synchronous,
okvis_apps/src/okvis_app_synchronous.cpp:67-204): read the YAML config,
stream the dataset through ``SlamSystem`` (the pipelined loop, or the
synchronous one with ``--sync``), drain it, optionally run the final BA
and save the map, and write ``okvis2-final_trajectory.csv`` (EuRoC format,
or RPG with ``--rpg-format``) from the estimator's whole history.

    python -m okvis2_torch.apps.app_synchronous <config.yaml> <dataset_dir> \\
        [--output-dir .] [--max-frames N] [--rpg-format] [--final-ba] \\
        [--save-map PATH] [--sync] [--vocabulary PATH]

runs on the CUDA card; ``main(argv, device="cpu")`` runs on the CPU.
"""

from __future__ import annotations

import argparse
import os
import time

import torch


def main(argv=None, device=None, dtype=torch.float32) -> dict:
    """Run the app on ``device`` (None: the CUDA card; raises without one)
    in ``dtype``. Returns the system (``slam``), the frames processed, each
    frame's ``process_frame`` seconds (``frame_s``) and the CSV's path
    (``output``)."""
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("config")
    p.add_argument("dataset")
    p.add_argument("--output-dir", default=".")
    p.add_argument("--max-frames", type=int, default=0)
    p.add_argument("--rpg-format", action="store_true")
    p.add_argument("--final-ba", action="store_true")
    p.add_argument("--save-map", default="")
    p.add_argument("--sync", action="store_true",
                   help="synchronous frame loop (one blocking readback per frame) instead of "
                        "the default pipelined loop")
    p.add_argument("--vocabulary", default="",
                   help="place-recognition vocabulary: an .npz or the reference's DBoW2 "
                        ".yml.gz (e.g. small_voc.yml.gz); default: the committed general "
                        "vocabulary")
    args = p.parse_args(argv)

    from okvis2_torch import resolve_device
    from okvis2_torch.config import read_config_file
    from okvis2_torch.frontend.detection import DetectionConfig
    from okvis2_torch.graph.estimator import EstimatorConfig
    from okvis2_torch.pipeline.dataset import EurocDatasetReader
    from okvis2_torch.pipeline.frontend_pipeline import FrontendConfig
    from okvis2_torch.pipeline.full_graph import LoopClosureConfig
    from okvis2_torch.pipeline.slam import SlamSystem
    from okvis2_torch.pipeline.trajectory import write_euroc_csv, write_rpg_csv

    dev = resolve_device(device)
    params = read_config_file(args.config, dtype=dtype, device=dev)
    cams = params.camera_tuple
    exts = params.extrinsics_list

    est_cfg = EstimatorConfig(
        num_keyframes=params.estimator.num_keyframes,
        num_imu_frames=params.estimator.num_imu_frames,
        num_loop_closure_frames=params.estimator.num_loop_closure_frames,
        realtime_iterations=params.estimator.realtime_max_iterations,
        realtime_min_iterations=params.estimator.realtime_min_iterations,
        enforce_realtime=params.estimator.enforce_realtime,
        realtime_time_limit=params.estimator.realtime_time_limit,
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
    lc_cfg = LoopClosureConfig(vocabulary_path=args.vocabulary) if args.vocabulary else None
    slam = SlamSystem(cams, exts, params.imu.params, est_cfg, fe_cfg,
                      do_loop_closures=params.estimator.do_loop_closures,
                      pipelined=not args.sync, loop_closure_config=lc_cfg, device=dev)

    reader = EurocDatasetReader(args.dataset, num_cameras=len(cams))
    n, frame_s = 0, []
    t0 = time.time()
    for ev in reader.stream(params.camera_rig.timestamp_tolerance):
        if ev[0] == "imu":
            slam.add_imu_measurement(ev[1], ev[2], ev[3])
            continue
        slam.add_images(ev[1], ev[2])
        ta = time.perf_counter()
        slam.process_frame()
        frame_s.append(time.perf_counter() - ta)
        n += 1
        if n % 50 == 0:
            dt = time.time() - t0
            print(f"[{n} frames, {n / dt:.1f} fps] tracking={slam.tracking.tracking_quality} "
                  f"landmarks={len(slam.estimator.landmarks)}", flush=True)
        if args.max_frames and n >= args.max_frames:
            break

    slam.finish()  # drain the pipelined loop's frames in flight

    if args.final_ba:
        # the offline final bundle adjustment (doFinalBa,
        # okvis_ceres/src/ViSlamBackend.cpp:1759-1892)
        info = slam.do_final_ba()
        print("final BA: " + ", ".join(f"{k} {v}" for k, v in info.items()
                                       if isinstance(v, (int, float))))

    # the final trajectory from the estimator's whole history (non-causal)
    est = slam.estimator
    final = [(est.states[s].t, est.states[s].pose) for s in est.state_order]
    os.makedirs(args.output_dir, exist_ok=True)
    out = os.path.join(args.output_dir, "okvis2-final_trajectory.csv")
    (write_rpg_csv if args.rpg_format else write_euroc_csv)(out, final)
    print(f"wrote {out} ({len(final)} states, {n} frames, {time.time() - t0:.1f}s)")

    if args.save_map:
        # with the landmarks' descriptors, for multi-session relocalisation
        # (Component::save)
        slam.save_map(args.save_map)
        print(f"saved map to {args.save_map}")
    return {"slam": slam, "frames": n, "frame_s": frame_s, "output": out}


if __name__ == "__main__":
    main()
