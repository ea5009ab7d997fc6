"""The JAX package's side of chip_smoke.py's phases 8-13, on the CPU in
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
        [force_min_pending] [obs_slots] [loop_closures] [exclude_recent] \
        [final_ba] [second_start] [second_modes] [second_min_pending] \
        [dataset] [final_ba_shards]

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

``loop_closures`` 1 turns loop closure on, with
``LoopClosureConfig(exclude_recent=...)`` (default 5, the config's own);
the JSON line then gives the closures, the frames whose host work closed
one, the loop edges, the keyframes that ran place recognition, the
closures rejected by the drift budget and the last verification's
outcome. Phase 10's drives: ``40 8 circle 2 0 0 4096 1 2`` (synchronous)
and ``40 8 circle 2 1 1 4096 1 2`` (pipelined, one frame kept in flight).

``final_ba`` 1 runs ``SlamSystem.do_final_ba()`` at its defaults after the
session has drained (``trajectory()``, which calls ``finish()``, as the
app does) and gives the final trajectory's aligned ATE, the restored
observations, the packed counts and the reprojection RMS. ``second_start``
> 0 then saves the map (``save_map``) and runs a second session: a fresh
``SlamSystem`` with loop closure on (the same ``LoopClosureConfig``)
loads it (``load_map``) and is fed the same stream from ``second_start``
seconds on (IMU samples and frames at t >= second_start), once per entry
of ``second_modes`` ("sync", "pipelined"; comma-separated; the pipelined
session keeps ``second_min_pending`` frames in flight). For each the JSON
line gives the frames whose host work relocalised (the frame index counts
from the session's first frame), each relocalisation's correction, the
relocalised keyframe's position error against ground truth right after it
(no alignment: the map's frame is the first session's), the final
trajectory's unaligned position errors from the first relocalising frame
on, the landmarks loaded and those with descriptors. Phase 11's drive:
``40 8 circle 2 0 0 4096 1 2 1 2.5 sync,pipelined 1`` (~4.5 min on the
CPU: the session ~100 s, its final BA ~40 s, the second sessions ~15 s and
~115 s, most of it compiling).

``dataset`` "textured" renders ``TexturedWorldDataset`` (its float images
in [0, 1] go to the system as they are) and turns CNN suppression on with
the committed weights (``okvis2_tpu/models/weights/fast_scnn_synthetic.npz``);
the JSON line then gives the landmarks suppressed at each keyframe (by
frame), and for each keyframe's images (both cameras) the segmentation's
pixel accuracy on the sky and person pixels of ``render_with_labels``
(rendered with the stream's own exposure clock). Phase 12's drives:
``30 20 default 5 0 0 4096 0 5 0 0 sync 1 textured`` (synchronous) and
``30 20 default 5 1 1 4096 0 5 0 0 sync 1 textured`` (pipelined, one frame
kept in flight).

``final_ba_shards`` n > 0 runs the final BA landmark-sharded on an
n-device virtual CPU mesh (``do_final_ba(mesh=make_mesh(n))``; the tool
sets ``--xla_force_host_platform_device_count`` before JAX starts) and
gives its ATE (no reprojection RMS: the sharded path computes no
diagnostics). Phase 13's reference: ``40 8 circle 2 0 0 4096 1 2 1 0 sync 1
stars 2``.

Bag mode, phase 15's reference (the ROS2 node's bag replay):

    env JAX_PLATFORMS=cpu python tools/e2e_reference_jax.py bag [n_frames]

writes phase 14's synchronous folder (the circle, with
``write_app_folder``) and a rosbag2 .db3 bag of it with chip_smoke.py's
``write_rosbag``, and runs ``okvis2_tpu.ros2.nodes.main_synchronous`` on
the bag with ``--max-frames`` ``n_frames`` (default 13, chip_smoke.py's
``BAG_FRAMES``), recorded by
``recorded_app_system``. The JSON line gives the folder's digest, the
node's printed line and return code, the keyframes (by frame), landmarks,
the estimator's states' aligned ATE against the ground truth, loop
closures and capacity truncations.

Train mode, phase 17's reference (Fast-SCNN training on the sky/person
scenes):

    env JAX_PLATFORMS=cpu python tools/e2e_reference_jax.py train [steps] [seed]

runs ``okvis2_tpu.models.train_synthetic.train(steps, batch=4, seed=seed,
textured_frac=0.5)`` (defaults 200 and 0) in float32, saving nothing. It
prints the loss every 25 steps and the pixel accuracy on 8 fresh 2-D
scenes and on the held-out textured views; the JSON line repeats both
accuracies with the wall time.

App mode, phase 14's reference (the dataset app at ``configs/euroc.yaml``):

    env JAX_PLATFORMS=cpu python tools/e2e_reference_jax.py app \
        [n_frames] [pipelined_frames] [pipelined_min_pending]

writes phase 14's two EuRoC folders with chip_smoke.py's
``write_app_folder`` (the port's ``SyntheticDataset`` with the config's two
752x480 radtan cameras, ``T_SC`` and IMU parameters, 2500 stars, seed 0,
``n_frames`` frames (default 40) at 20 Hz, 200 Hz IMU; uint8 images, the
port's ``DatasetWriter``; rendered on the CPU in float64, as the smoke run
renders them): the first of a circle of ``chip_smoke.APP_PERIOD`` s, and
the first of the default trajectory. It runs
``okvis2_tpu.apps.app_synchronous.main`` on each, recorded by
chip_smoke.py's ``recorded_app_system``: ``--sync --final-ba --save-map``
on the circle, and the default pipelined loop on the default trajectory
with ``--max-frames`` ``pipelined_frames`` (default 20, chip_smoke.py's
``APP_PIPELINED_FRAMES``),
``pipelined_min_pending`` frames kept in flight (default 1: the card's
schedule). The JSON line gives the folders' digests (``app_folder_digest``:
phase 14 checks that it reads the same pixels), and for each run the final CSV's rows and aligned ATE against the ground truth,
the keyframes (by frame), landmarks, loop closures and the capacity
truncations (``_warn_counts``); for the synchronous run the final BA's
record and the map's landmark count; for the pipelined one the frames in
flight after each dispatch.
"""

import json
import os
import sys
import threading
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
WEIGHTS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "okvis2_tpu", "models", "weights", "fast_scnn_synthetic.npz")
EUROC_YAML = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                          "configs", "euroc.yaml")


def main(argv):
    if len(argv) > 1 and argv[1] == "app":
        return app_main(argv[1:])
    if len(argv) > 1 and argv[1] == "bag":
        return bag_main(argv[1:])
    if len(argv) > 1 and argv[1] == "train":
        return train_main(argv[1:])
    n_frames = int(argv[1]) if len(argv) > 1 else 60
    rate = float(argv[2]) if len(argv) > 2 else 20.0
    trajectory = argv[3] if len(argv) > 3 else "default"
    num_keyframes = int(argv[4]) if len(argv) > 4 else 5
    pipelined = bool(int(argv[5])) if len(argv) > 5 else False
    force_min_pending = int(argv[6]) if len(argv) > 6 else 0
    obs_slots = int(argv[7]) if len(argv) > 7 else 4096
    loop_closures = bool(int(argv[8])) if len(argv) > 8 else False
    exclude_recent = int(argv[9]) if len(argv) > 9 else 5
    final_ba = bool(int(argv[10])) if len(argv) > 10 else False
    second_start = float(argv[11]) if len(argv) > 11 else 0.0
    second_modes = argv[12].split(",") if len(argv) > 12 else ["sync"]
    second_min_pending = int(argv[13]) if len(argv) > 13 else 1
    dataset = argv[14] if len(argv) > 14 else "stars"
    final_ba_shards = int(argv[15]) if len(argv) > 15 else 0
    if final_ba_shards:
        os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") + " --xla_force_host_"
                                   f"platform_device_count={final_ba_shards}").strip()
    import numpy as np

    from okvis2_tpu.cameras.distortion import RadialTangentialDistortion
    from okvis2_tpu.cameras.pinhole import PinholeCamera
    from okvis2_tpu.core.se3 import Transformation
    from okvis2_tpu.frontend.detection import DetectionConfig
    from okvis2_tpu.graph.estimator import EstimatorConfig
    from okvis2_tpu.imu.preintegration import ImuParameters
    from okvis2_tpu.pipeline.dataset import SyntheticDataset, TexturedWorldDataset
    from okvis2_tpu.pipeline.frontend_pipeline import FrontendConfig
    from okvis2_tpu.pipeline.full_graph import LoopClosureConfig
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
    textured = dataset == "textured"
    if textured:
        ds = TexturedWorldDataset(cams, exts, imu, duration=n_frames / rate, frame_rate=rate,
                                  imu_rate=200.0, seed=0, trajectory=trajectory)
        labels = []  # each frame's class maps, rendered with the stream's clock
        render_labelled = ds.render_with_labels

        def render(T_WS):
            pairs = render_labelled(T_WS)
            labels.append([lab for _, lab in pairs])
            return [im for im, _ in pairs]

        ds.render = render
    else:
        ds = SyntheticDataset(cams, exts, imu, n_stars=2500, duration=n_frames / rate,
                              frame_rate=rate, imu_rate=200.0, seed=0, trajectory=trajectory)
    est_cfg = EstimatorConfig(window_slots=12, landmark_slots=512, obs_slots=obs_slots,
                              imu_seg_capacity=64, enforce_realtime=True,
                              realtime_time_limit=1.0 / 200.0, num_keyframes=num_keyframes)
    fe_cfg = FrontendConfig(detection=DetectionConfig(max_keypoints=512),
                            map_match_capacity=1024)
    slam = SlamSystem(cams, exts, imu, est_cfg, fe_cfg, pipelined=pipelined,
                      do_loop_closures=loop_closures,
                      loop_closure_config=LoopClosureConfig(exclude_recent=exclude_recent),
                      cnn_params=WEIGHTS if textured else None)
    lb = slam.loop_backend
    suppressed = []  # (sid, landmarks suppressed), per keyframe
    kf_images = {}
    if textured:
        suppress = slam.cnn.suppress

        def recorded(est_, frames, sid, images):
            n = suppress(est_, frames, sid, images)
            suppressed.append((sid, n))
            kf_images[sid] = [np.asarray(im) for im in images]
            return n

        slam.cnn.suppress = recorded
    n_queries = [0]
    if lb is not None:
        detect = lb.detect_loop

        def counted(*a, **kw):
            n_queries[0] += 1
            return detect(*a, **kw)

        lb.detect_loop = counted
    if force_min_pending:
        slam._force_min_pending = force_min_pending
    kf_sids = []
    slam.set_optimised_graph_callback(
        lambda t, sid, pose, tr: kf_sids.append(sid) if tr.is_keyframe else None)
    gt, max_window, in_flight, lc_frames = [], 0, [], []
    for ev in ds.stream():
        if ev[0] == "imu":
            slam.add_imu_measurement(ev[1], ev[2], ev[3])
            continue
        _, t, images, pose = ev
        gt.append((t, pose))
        slam.add_images(t, images if textured else
                        [(np.clip(im, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
                         for im in images])
        t0 = time.perf_counter()
        lc0 = lb.num_loop_closures if lb is not None else 0
        slam.process_frame()
        if lb is not None and lb.num_loop_closures > lc0:
            lc_frames.append(len(gt) - 1)
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
    lc_end = lb.num_loop_closures if lb is not None else 0
    traj = slam.trajectory()  # drains the pipelined loop first
    if lb is not None and lb.num_loop_closures > lc_end:
        lc_frames.append("finish")
    kf_frames = [est.state_order.index(s) for s in kf_sids]
    loop = {} if lb is None else {
        "exclude_recent": exclude_recent, "loop_closures": lb.num_loop_closures,
        "loop_closure_frames": lc_frames,
        "loop_edges": [[e.id_i, e.id_j] for e in est.pose_graph_edges if e.kind == "loop"],
        "place_recognition_queries": n_queries[0],
        "rejected_by_budget": lb.num_rejected_by_budget,
        "last_verify_info": lb.last_verify_info,
    }
    extra = {}
    if textured:
        extra["cnn"] = cnn_record(slam, est, suppressed, kf_images, labels)
    if final_ba:
        t0 = time.perf_counter()
        mesh = None
        if final_ba_shards:
            from okvis2_tpu.parallel.sharded_ba import make_mesh

            mesh = make_mesh(final_ba_shards)
        info = slam.do_final_ba(mesh=mesh)
        extra["final_ba"] = {
            "shards": final_ba_shards,
            "ate_rmse_m": ate_rmse(est.trajectory(), gt, align=True),
            "restored_observations": info["restored_observations"], "states": info["states"],
            "landmarks": info["landmarks"], "reproj_rms_px": info.get("reproj_rms_px"),
            "loop_edges": [[e.id_i, e.id_j] for e in est.pose_graph_edges if e.kind == "loop"],
            "wall_s": time.perf_counter() - t0}
        print(json.dumps({"final_ba": extra["final_ba"]}), flush=True)
    if second_start > 0:
        import tempfile

        path = os.path.join(tempfile.mkdtemp(), "session1.map")
        slam.save_map(path)
        for mode in second_modes:
            s2 = SlamSystem(cams, exts, imu, est_cfg, fe_cfg, pipelined=mode == "pipelined",
                            do_loop_closures=True,
                            loop_closure_config=LoopClosureConfig(exclude_recent=exclude_recent))
            if mode == "pipelined":
                s2._force_min_pending = second_min_pending
            ds2 = SyntheticDataset(cams, exts, imu, n_stars=2500, duration=n_frames / rate,
                                   frame_rate=rate, imu_rate=200.0, seed=0, trajectory=trajectory)
            extra["second_" + mode] = second_session(s2, ds2, path, second_start)
            print(json.dumps({"second_" + mode: extra["second_" + mode]}), flush=True)
    print(json.dumps({
        "frames": len(gt), "frame_rate": rate, "trajectory": trajectory,
        "num_keyframes": num_keyframes, "pipelined": pipelined,
        "force_min_pending": force_min_pending, "obs_slots": obs_slots,
        "in_flight": {str(k): in_flight.count(k) for k in sorted(set(in_flight))},
        "ate_rmse_m": ate_rmse(traj, gt, align=True),
        "keyframes": len(kf_frames), "keyframe_frames": kf_frames, "landmarks": len(est.landmarks),
        "pose_graph_edges": len(est.pose_graph_edges),
        "edges": [[e.id_i, e.id_j] for e in est.pose_graph_edges], "max_window": max_window,
        **loop, **extra, "wall_s": time.perf_counter() - t_start,
    }))


def app_run(argv, min_pending=0):
    """``okvis2_tpu.apps.app_synchronous.main(argv)`` with its system
    recorded by chip_smoke.py's ``recorded_app_system``: keyframes (by
    frame), frames in flight after each dispatch, loop closures, capacity
    truncations; returns (system, record)."""
    from chip_smoke import recorded_app_system
    from okvis2_tpu.apps import app_synchronous
    from okvis2_tpu.graph import estimator as est_mod
    from okvis2_tpu.pipeline import slam as slam_mod

    t0 = time.perf_counter()
    with recorded_app_system(slam_mod, est_mod, min_pending=min_pending) as rec:
        app_synchronous.main(argv)
    slam = rec["systems"][0]
    est = slam.estimator
    lb = slam.loop_backend
    info = rec["final_ba"]
    return slam, {
        "keyframe_frames": [est.state_order.index(s) for s in rec["kf_sids"]],
        "landmarks": len(est.landmarks),
        "loop_closures": lb.num_loop_closures if lb is not None else None,
        "truncations": rec["truncations"],
        "in_flight": {str(k): rec["in_flight"].count(k) for k in sorted(set(rec["in_flight"]))},
        "final_ba": None if info is None else {
            **{k: info.get(k) for k in ("restored_observations", "states", "landmarks",
                                        "reproj_rms_px")},
            "wall_s": rec["final_ba_ms"] * 1e-3},
        "wall_s": time.perf_counter() - t0,
    }


def csv_ate(path, gt):
    """Rows of an EuRoC trajectory CSV and their aligned ATE against ``gt``."""
    import numpy as np

    from okvis2_tpu.pipeline.trajectory import ate_rmse

    rows = np.loadtxt(path, delimiter=",", skiprows=1, ndmin=2)
    est = [(r[0] * 1e-9, np.concatenate([r[1:4], r[5:8], r[4:5]])) for r in rows]
    return len(rows), ate_rmse(est, gt, align=True)


def app_main(argv):
    """Phase 14's reference: the JAX app on phase 14's folders, both loops."""
    import shutil
    import tempfile

    n_frames = int(argv[1]) if len(argv) > 1 else 40
    pipelined_frames = int(argv[2]) if len(argv) > 2 else 20
    min_pending = int(argv[3]) if len(argv) > 3 else 1
    from chip_smoke import APP_PERIOD, app_folder_digest, write_app_folder
    from okvis2_torch.pipeline.component_io import load_component

    root = tempfile.mkdtemp()
    try:
        t0 = time.perf_counter()
        out = {"frames": n_frames, "config": "configs/euroc.yaml", "period_s": APP_PERIOD}
        folders, truth = {}, {}
        for name, period in (("sync", APP_PERIOD), ("pipelined", None)):
            folders[name] = os.path.join(root, f"euroc_{name}")
            truth[name], _, _ = write_app_folder(folders[name], n_frames, period)
            out[f"{name}_folder_digest"] = app_folder_digest(folders[name])
        print(f"wrote 2 x {n_frames} frames in {time.perf_counter() - t0:.1f} s", flush=True)
        map_path = os.path.join(root, "session.map")
        slam, rec = app_run([EUROC_YAML, folders["sync"], "--output-dir",
                             os.path.join(root, "sync"), "--sync", "--final-ba", "--save-map",
                             map_path])
        rows, ate = csv_ate(os.path.join(root, "sync", "okvis2-final_trajectory.csv"),
                            truth["sync"])
        rec.update(rows=rows, ate_rmse_m=ate,
                   map_landmarks=len(load_component(map_path)["landmarks"]))
        out["sync"] = rec
        print(json.dumps({"sync": rec}), flush=True)
        slam, rec = app_run([EUROC_YAML, folders["pipelined"], "--output-dir",
                             os.path.join(root, "pipelined"), "--max-frames",
                             str(pipelined_frames)], min_pending)
        rows, ate = csv_ate(os.path.join(root, "pipelined", "okvis2-final_trajectory.csv"),
                            truth["pipelined"][:pipelined_frames])
        rec.update(rows=rows, ate_rmse_m=ate, min_pending=min_pending)
        out["pipelined"] = rec
        out["wall_s"] = time.perf_counter() - t0
        print(json.dumps(out), flush=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    # the JAX loop-closure backend compiles full-graph solves ahead on daemon
    # threads (okvis2_tpu/pipeline/full_graph.py:1140): the interpreter's
    # teardown aborts one still inside XLA, so wait for them
    for th in threading.enumerate():
        if th is not threading.current_thread():
            th.join()


def bag_main(argv):
    """Phase 15's reference: the JAX node's bag replay on phase 14's
    synchronous folder written as a .db3 bag."""
    import contextlib
    import io
    import shutil
    import tempfile

    import numpy as np

    n_frames = int(argv[1]) if len(argv) > 1 else 13
    from chip_smoke import (APP_FRAMES, APP_PERIOD, app_folder_digest, recorded_app_system,
                            write_app_folder, write_rosbag)
    from okvis2_tpu.graph import estimator as est_mod
    from okvis2_tpu.pipeline import slam as slam_mod
    from okvis2_tpu.pipeline.trajectory import ate_rmse
    from okvis2_tpu.ros2 import nodes

    root = tempfile.mkdtemp()
    try:
        t0 = time.perf_counter()
        folder, bag = os.path.join(root, "euroc"), os.path.join(root, "circle.db3")
        gt, _, _ = write_app_folder(folder, APP_FRAMES, APP_PERIOD)
        out = {"frames": n_frames, "config": "configs/euroc.yaml", "period_s": APP_PERIOD,
               "folder_digest": app_folder_digest(folder),
               "messages": write_rosbag(folder, bag, "sqlite3")}
        printed = io.StringIO()
        with recorded_app_system(slam_mod, est_mod) as rec, contextlib.redirect_stdout(printed):
            out["rc"] = nodes.main_synchronous([EUROC_YAML, bag, "--max-frames", str(n_frames)])
        slam = rec["systems"][0]
        est = slam.estimator
        traj = [(est.states[s].t, np.asarray(est.states[s].pose)) for s in est.state_order]
        out.update(printed=printed.getvalue().strip(),
                   keyframe_frames=[est.state_order.index(s) for s in rec["kf_sids"]],
                   landmarks=len(est.landmarks), states=len(est.state_order),
                   ate_rmse_m=ate_rmse(traj, gt[:n_frames], align=True),
                   loop_closures=slam.loop_backend.num_loop_closures,
                   truncations=rec["truncations"], wall_s=time.perf_counter() - t0)
        print(json.dumps(out), flush=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    for th in threading.enumerate():  # as in app_main
        if th is not threading.current_thread():
            th.join()


def train_main(argv):
    """Phase 17's reference: the JAX trainer at the smoke run's settings."""
    from okvis2_tpu.models.train_synthetic import train

    steps = int(argv[1]) if len(argv) > 1 else 200
    seed = int(argv[2]) if len(argv) > 2 else 0
    t0 = time.perf_counter()
    # train() returns the 2-D accuracy; the textured one is in its printout
    _, acc = train(steps, None, batch=4, seed=seed, textured_frac=0.5)
    print(json.dumps({"steps": steps, "seed": seed, "batch": 4, "textured_frac": 0.5,
                      "acc_2d": acc, "wall_s": time.perf_counter() - t0}), flush=True)


def cnn_record(slam, est, suppressed, kf_images, labels):
    """The suppression per keyframe and the segmentation's pixel accuracy on
    the keyframes' sky and person pixels."""
    import jax.numpy as jnp
    import numpy as np

    from okvis2_tpu.models.fast_scnn import PERSON_CLASS, SKY_CLASS, segment_image

    hits = {SKY_CLASS: [0, 0], PERSON_CLASS: [0, 0]}
    for sid, images in kf_images.items():
        for img, lab in zip(images, labels[est.state_order.index(sid)]):
            seg = np.asarray(segment_image(slam.cnn.params, jnp.asarray(img)))
            for c, h in hits.items():
                h[0] += int((seg[lab == c] == c).sum())
                h[1] += int((lab == c).sum())
    return {"suppressed_per_keyframe": [[est.state_order.index(s), n] for s, n in suppressed],
            "num_suppressed": slam.cnn.num_suppressed,
            "pixel_accuracy": {"sky": hits[SKY_CLASS][0] / max(hits[SKY_CLASS][1], 1),
                               "person": hits[PERSON_CLASS][0] / max(hits[PERSON_CLASS][1], 1)},
            "labelled_pixels": {"sky": hits[SKY_CLASS][1], "person": hits[PERSON_CLASS][1]}}


def second_session(slam, ds, path, start):
    """Load the map at ``path`` into ``slam`` and feed ``ds``'s stream from
    ``start`` seconds on; returns the relocalisation record."""
    import numpy as np

    from okvis2_tpu.core import se3_np

    t0 = time.perf_counter()
    n_loaded = slam.load_map(path)
    n_desc = len(slam.frontend.lm_descriptors)
    est = slam.estimator
    corrections = []
    apply_reloc = slam._apply_relocalisation

    def recorded(est_, sid, frames, v):
        before = est_.states[sid].pose.copy()
        apply_reloc(est_, sid, frames, v)
        after = est_.states[sid].pose
        dq = se3_np.quat_mul(se3_np.quat_conj(before[3:7]), after[3:7])
        corrections.append({"sid": sid, "frame": est_.state_order.index(sid),
                            "d_pos_m": float(np.linalg.norm(after[:3] - before[:3])),
                            "d_rot_deg": float(np.degrees(np.linalg.norm(se3_np.log_so3(dq)))),
                            "error_after_m": float(np.linalg.norm(
                                after[:3] - gt[est_.state_order.index(sid)][1][:3])),
                            "num_inliers": int(v["num_inliers"])})

    slam._apply_relocalisation = recorded
    gt, reloc_frames = [], []
    for ev in ds.stream():
        if ev[1] < start - 1e-9:
            continue
        if ev[0] == "imu":
            slam.add_imu_measurement(ev[1], ev[2], ev[3])
            continue
        _, t, images, pose = ev
        gt.append((t, pose))
        slam.add_images(t, [(np.clip(im, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
                            for im in images])
        n0 = getattr(slam, "_relocalisations", 0)
        slam.process_frame()
        if getattr(slam, "_relocalisations", 0) > n0:
            reloc_frames.append(len(gt) - 1)
        print(f"second session frame {len(gt):2d}: relocalisations "
              f"{getattr(slam, '_relocalisations', 0)}, landmarks {len(est.landmarks)}",
              flush=True)
    n0 = getattr(slam, "_relocalisations", 0)
    traj = slam.trajectory()
    if getattr(slam, "_relocalisations", 0) > n0:
        reloc_frames.append("finish")
    err = [float(np.linalg.norm(p[:3] - g[1][:3])) for (_, p), g in zip(traj, gt)]
    first = corrections[0]["frame"] if corrections else len(gt)
    after = err[first:]
    return {"start_s": start, "frames": len(gt), "loaded": n_loaded,
            "loaded_with_descriptors": n_desc, "relocalisations": getattr(slam, "_relocalisations", 0),
            "relocalising_frames": reloc_frames, "corrections": corrections,
            "final_error_from_first_m": {"rms": float(np.sqrt(np.mean(np.square(after))))
                                         if after else None,
                                         "max": max(after) if after else None,
                                         "last": err[-1]},
            "errors_m": err, "landmarks": len(est.landmarks),
            "wall_s": time.perf_counter() - t0}


if __name__ == "__main__":
    main(sys.argv)
