"""The JAX package's side of chip_smoke.py's phases 8 and 9, on the CPU in
float32: the SlamSystem (synchronous, or pipelined) at the bench's EuRoC
configuration (bench.py:136-160: 752x480 radtan stereo rig, f = 460,
0.11 m baseline, 512 keypoints, map capacity 1024, a 12-slot window with
512 landmark and 4096 observation slots, IMU segments of 64, the realtime
iteration budget at 1/200 s) on the bench's frames (SyntheticDataset, 2500
stars, seed 0, 20 Hz frames, 200 Hz IMU, uint8 images), fed as
bench.py:163-196 feeds them. Prints per-frame progress, then one JSON line
with the aligned ATE, keyframes, landmarks, pose-graph edges, the largest
window and the wall time: the numbers that set phase 8's bars.

    env JAX_PLATFORMS=cpu python tools/e2e_reference_jax.py \
        [n_frames] [frame_rate] [trajectory] [num_keyframes] [pipelined] \
        [force_min_pending] [obs_slots]

Defaults: 60 frames at 20 Hz on the default trajectory with 5 window
keyframes, synchronous: the bench's system and frames (phase 8's first
drive). Phase 8's pose-graph drive is ``40 8 circle 2``: one circle in 5 s
at 8 Hz, 2 window keyframes. Phase 9's drives are the bench's pipelined
loop (bench.py:160) on the bench's frames: ``60 20 default 5 1 1``, one
frame kept in flight (``_force_min_pending``), the schedule the port's
loop runs at on the card, where a solve takes longer than a frame's host
work; and ``30 20 default 5 1 2 8192``, two frames kept in flight, so
that every solve from the third frame on appends three sets, with 8192
observation slots (at 4096 the appended rows overflow). ``60 20 default 5
1`` is the loop with its own lag, which on this CPU is mostly one frame.
The pipelined loop's keyframes are read from its (lagged) callbacks; the
JSON line also gives the frames in flight after each dispatch.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv):
    n_frames = int(argv[1]) if len(argv) > 1 else 60
    rate = float(argv[2]) if len(argv) > 2 else 20.0
    trajectory = argv[3] if len(argv) > 3 else "default"
    num_keyframes = int(argv[4]) if len(argv) > 4 else 5
    pipelined = bool(int(argv[5])) if len(argv) > 5 else False
    force_min_pending = int(argv[6]) if len(argv) > 6 else 0
    obs_slots = int(argv[7]) if len(argv) > 7 else 4096
    import numpy as np

    from okvis2_tpu.cameras.distortion import RadialTangentialDistortion
    from okvis2_tpu.cameras.pinhole import PinholeCamera
    from okvis2_tpu.core.se3 import Transformation
    from okvis2_tpu.frontend.detection import DetectionConfig
    from okvis2_tpu.graph.estimator import EstimatorConfig
    from okvis2_tpu.imu.preintegration import ImuParameters
    from okvis2_tpu.pipeline.dataset import SyntheticDataset
    from okvis2_tpu.pipeline.frontend_pipeline import FrontendConfig
    from okvis2_tpu.pipeline.slam import SlamSystem
    from okvis2_tpu.pipeline.trajectory import ate_rmse
    import jax.numpy as jnp

    t_start = time.perf_counter()
    W, H, F = 752, 480, 460.0
    cam = PinholeCamera.create(W, H, F, F, W / 2.0, H / 2.0,
                               RadialTangentialDistortion.from_params([-0.05, 0.01, 0.0, 0.0]))
    cams = (cam, cam)
    exts = [Transformation(r=jnp.asarray(r, jnp.float32), q=jnp.asarray([0, 0, 0, 1.0], jnp.float32))
            for r in ([0.0, 0.0, 0.0], [0.11, 0.0, 0.0])]
    imu = ImuParameters.create(g=9.81)
    ds = SyntheticDataset(cams, exts, imu, n_stars=2500, duration=n_frames / rate,
                          frame_rate=rate, imu_rate=200.0, seed=0, trajectory=trajectory)
    est_cfg = EstimatorConfig(window_slots=12, landmark_slots=512, obs_slots=obs_slots,
                              imu_seg_capacity=64, enforce_realtime=True,
                              realtime_time_limit=1.0 / 200.0, num_keyframes=num_keyframes)
    fe_cfg = FrontendConfig(detection=DetectionConfig(max_keypoints=512),
                            map_match_capacity=1024)
    slam = SlamSystem(cams, exts, imu, est_cfg, fe_cfg, pipelined=pipelined)
    if force_min_pending:
        slam._force_min_pending = force_min_pending
    kf_sids = []
    slam.set_optimised_graph_callback(
        lambda t, sid, pose, tr: kf_sids.append(sid) if tr.is_keyframe else None)
    gt, max_window, in_flight = [], 0, []
    for ev in ds.stream():
        if ev[0] == "imu":
            slam.add_imu_measurement(ev[1], ev[2], ev[3])
            continue
        _, t, images, pose = ev
        gt.append((t, pose))
        slam.add_images(t, [(np.clip(im, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
                            for im in images])
        t0 = time.perf_counter()
        slam.process_frame()
        in_flight.append(len(slam._pending_frames))
        est = slam.estimator
        max_window = max(max_window, len(est.window))
        sid = slam.tracking.id  # the pipelined loop's bookkeeping lags
        err = (float(np.linalg.norm(est.states[sid].pose[:3]
                                    - gt[est.state_order.index(sid)][1][:3]))
               if sid in est.states else float("nan"))
        print(f"frame {len(gt):2d}: {time.perf_counter() - t0:7.2f} s, keyframe "
              f"{slam.tracking.is_keyframe}, landmarks {len(est.landmarks)}, window "
              f"{len(est.window)}, edges {len(est.pose_graph_edges)}, error {err:.4f} m",
              flush=True)
    est = slam.estimator
    traj = slam.trajectory()  # drains the pipelined loop first
    kf_frames = [est.state_order.index(s) for s in kf_sids]
    print(json.dumps({
        "frames": len(gt), "frame_rate": rate, "trajectory": trajectory,
        "num_keyframes": num_keyframes, "pipelined": pipelined,
        "force_min_pending": force_min_pending, "obs_slots": obs_slots,
        "in_flight": {str(k): in_flight.count(k) for k in sorted(set(in_flight))},
        "ate_rmse_m": ate_rmse(traj, gt, align=True),
        "keyframes": len(kf_frames), "keyframe_frames": kf_frames, "landmarks": len(est.landmarks),
        "pose_graph_edges": len(est.pose_graph_edges),
        "edges": [[e.id_i, e.id_j] for e in est.pose_graph_edges], "max_window": max_window,
        "wall_s": time.perf_counter() - t_start,
    }))


if __name__ == "__main__":
    main(sys.argv)
