#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (okvis2_torch) on one NVIDIA card.

    python3 chip_smoke.py

Drives the port's per-frame hot path at EuRoC scale (752x480 stereo, 512
keypoints per image, a 12-state window) on the card and holds every
hand-written kernel against its plain PyTorch version:

  1. device    the card's name and power limit (nvidia-smi)
  2. build     the CUDA source okvis2_torch/csrc/harris_nms.cu, with nvcc,
               and what ptxas reports for it (registers, spills)
  3. kernels   each kernel against its plain version on the same inputs
               (bit for bit, at the main path's shape and its octaves),
               and both timed with CUDA events, with the L2 flushed before
               each call and without
  4. frontend  detect -> describe -> stereo match at full width, with the
               keypoints held against the plain-Harris chain
  5. solve     a disturbed 12-state / 484-landmark window in float32,
               checked against ground truth; and a rig of a radtan and an
               equidistant camera (the solver evaluates each camera on its
               own rows) solved in float64 on the card and on the CPU
               (MIXED_RIG_RTOL)
  6. hot path  10 frames of (frontend + 3-iteration solve), as the JAX
               package's bench.py::bench_hotpath (50 frames before the
               synchronous loop's phase 8 took the time); the kernels'
               launch counts are zeroed just before and read just after
  7. tracking  the per-frame tracking program (frame_associate: detect,
               describe, back-project, map match + rig P3P RANSAC,
               frame-to-frame, motion stereo) on 21 synthetic frames of the JAX bench's
               rig and data (752x480 stereo, 512 keypoints, map capacity
               1024, 128 hypotheses): frame 0 seeds the map by static
               stereo, frames 1-20 are tracked from the IMU-predicted pose
               and checked against ground truth; launch counts zeroed
               just before and read just after, as in phase 6
  8. slam      the synchronous SLAM loop (SlamSystem, pipelined=False) at
               the JAX bench's EuRoC configuration (752x480, 512
               keypoints, map capacity 1024, a 12-slot window, the
               realtime budget at 1/200 s), fed through
               add_imu_measurement / add_images / process_frame, in two
               drives (SLAM_DRIVES): 40 of the bench's 60 frames at 20 Hz, and
               one circle of 40 frames at 8 Hz with 2 window keyframes,
               where keyframes become pose-graph factors. Each checks the
               ATE against ground truth and the JAX package's own ATE on
               the same frames (tools/e2e_reference_jax.py), the map, the
               marginalisation (window bound, states eliminated, edges),
               one Harris launch per frame, and the second every two-pose
               factor against float64 on the CPU; frames/s, the loop's
               stage split, LM iterations per solve, and for the first a
               profiled steady frame. Launch counts are zeroed just before
               each drive and read just after
  9. slam pipelined  the bench's own loop, SlamSystem(pipelined=True): the
               solve of each frame runs on a worker thread and stream and
               appends, on the card, the match rows of every frame still in
               flight; bookkeeping runs one or two frames behind
               (PIPELINED_DRIVES): 40 of the bench's 60 frames with the loop's own
               lag, and 30 of them with two frames kept in flight. Each
               checks what phase 8 checks, and that the appended rows never
               exceed the observation slots; the second that every solve
               from the third frame on appended three sets. Each prints the
               frames/s of process_frame (which does not wait for the
               card), the stage split, the lag histogram; the first a
               profiled frame with two frames in flight
 10. slam loop closure  both loops with loop closure on
               (do_loop_closures, LoopClosureConfig(exclude_recent=2)) on
               phase 8's pose-graph drive (LOOP_DRIVES): the synchronous
               loop must close the JAX run's loop, on its frame and with its
               edge, at phase 8's ATE bar and with phase 8's map, window and
               marginalisation checks, and prints the closure frame's stage
               split and the full-graph solve (ms, LM iterations, device
               kernels, capacities S/L/O/R); at that closure the full-graph
               solve queued on the solve worker is held against the inline
               one (QUEUED_FG_TOL_M, QUEUED_FG_TOL_HP, QUEUED_FG_F32_TOL). The
               pipelined loop (its own lag) must make as many
               closures and drift-budget rejections as the JAX run at the
               same schedule, at phase 9's ATE rule. Launch counts are zeroed
               just before each drive and read just after
 11. multi-session  phase 10's synchronous session ended as the app ends
               it (finish, the final BA, save_map), its pack solved again
               in float32 (bit for bit) and its overhead image drawn, then
               a second session in each loop that loads the map and
               relocalises (MULTI_SESSION)
 12. slam cnn  CNN suppression (SlamSystem(cnn_params=...), the committed
               Fast-SCNN weights) on the textured world at phase 8's
               configuration, in both loops (CNN_DRIVES): keyframes and
               landmarks suppressed per keyframe against the JAX run, the
               ATE, the keyframes' class maps on the card against the CPU
               port and against the renderer's labels, the network's ms
               per image; launch counts zeroed just before each drive
 13. sharded final BA  phase 11's final-BA pack solved landmark-sharded
               (parallel/sharded_ba.py) at world size 1 over NCCL and 2
               over gloo (two spawned ranks on the one card), against the
               unsharded solve in float64; ms, kernels and collectives per
               LM iteration
 14. app       the dataset app (okvis2_torch.apps.app_synchronous.main) at
               configs/euroc.yaml on two EuRoC folders that the port's
               DatasetWriter writes and its reader reads back bit for bit:
               the synchronous app with the final BA and the map, held to
               the JAX app on the same folder (ATE, keyframes, final BA)
               and the map reloaded; the default pipelined app at phase
               9's rule; launch counts zeroed just before each app run
 15. ros2 bag replay  the ROS2 node's replay (okvis2_torch.ros2.nodes
               main_synchronous) at configs/euroc.yaml: phase 14's
               synchronous folder written as rosbag2 bags (write_rosbag:
               sqlite3 and chunked mcap), their streams held to the folder's
               and to each other, then BAG_FRAMES frames of the .db3 bag
               replayed on the card against the JAX node on the same bag
               (keyframes, landmarks, ATE, the printed frame count); launch
               counts zeroed just before the replay
 16. native loader  the EuRoC prefetcher (okvis2_torch.pipeline.native_loader:
               threads N frames ahead, zlib and okvis2_torch/native/
               dataloader.cpp, built with the host compiler) on phase 14's
               folders and a Paeth-filtered copy: open_euroc gives the
               native reader, its streams equal the Python reader's bit
               for bit; decode ms per pair of both readers, the main
               thread's wait per frame
 17. fast-scnn  the .pth importer (the checkpoint layout's mirror with
               random weights, converted and loaded; logits on the card
               against the mirror's), one float64 training step card
               against CPU at full width, and train() on the card at full
               width in float32 against the JAX trainer's accuracies; the
               trained weights saved, reloaded and segmenting as trained
 18. device-loop replay  phase 9's first drive ran with the frame capture
               set (SlamSystem._bench_record); its last REPLAY_FRAMES records
               are replayed by okvis2_torch.pipeline.device_replay with every
               input staged on the card, in modes full, frontend and solve
               (one warm and REPLAY_PASSES timed passes each): the first full
               pass equal to the live [solve | diag] bit for bit, every pass
               to the first, the frontend's diagnostics to the live ones, the
               solve mode to the full one, one Harris launch per replayed
               frame in modes full and frontend and none in solve, the
               system unchanged; frames/s per mode beside phase 9's live
               rate, and one profiled pass's host<->device copies and
               synchronisations per frame by cause (none of 1 KB or more);
               launch counts zeroed just before the replays

Every check raises on failure, so any failing phase exits non-zero. The
line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}. Without a CUDA card it exits non-zero
before printing any result.
"""

import collections
import contextlib
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

# the card's published peaks (H100 SXM data sheet): HBM bytes/s, f32 FLOP/s
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
# Harris + NMS arithmetic per pixel, as the plain version does it: Sobel
# gradients 10, products 3, three 3x3 boxes 15, response 7, NMS 8 maxima
# and a select 9
HARRIS_OPS_PER_PX = 44

H, W, N_KP = 480, 752, 512
N_FRAMES = 10
DEVICE = "cuda"
# phase 7: frames tracked after frame 0, the bench's map capacity and
# RANSAC hypotheses (bench.py:155-158), and the bars each tracked frame
# must meet. The RANSAC pose is a minimal-sample (P3P) pose against
# static-stereo landmarks, not refined: the JAX package's own pose on the
# same frames is off by up to 0.140 m and 0.88 deg
# (tools/tracking_reference_jax.py), so the position bar is 1.5x that
# error, not the 0.10 m first chosen; the rotation bar stays 1 deg.
N_TRACK, TRACK_CAP, TRACK_HYP = 20, 1024, 128
TRACK_MIN_INLIERS = 30
TRACK_MAX_POS_M, TRACK_MAX_ROT_DEG = 0.21, 1.0
# phase 8: two drives of the bench's system, each with the JAX package's
# aligned ATE, keyframe frames and pose-graph edges on the same frames and
# configuration (tools/e2e_reference_jax.py, CPU, float32). The ATE bars:
# below 0.10 m (tests/test_e2e_vio.py:21) and at most 1.5x the JAX ATE
# plus 5 mm.
# - "slam": the first 40 of the bench's 60 frames (bench.py:55; 60 until
#   the phases' time grew with phases 16-17), its warm-up (:194), on the
#   default trajectory. The JAX run ("40 20 default 5") makes 1 keyframe in
#   these frames (4 in 400, where the star field ends) and so no pose-graph
#   edge: marginalisation shows here as IMU-frame elimination under the
#   window bound. ATE 3.039 mm (3.414 mm on 60 frames).
# - "slam pose graph": one circle (5 s at 8 Hz) with 2 window keyframes in
#   place of 5, so that keyframes leave the window as pose-graph factors
#   (the JAX run: keyframes at frames 0, 8, 18, 26 and 37; edges between
#   states 8-0, 18-8 and 26-18).
SLAM_DRIVES = {
    "slam": dict(frames=40, rate=20.0, trajectory="default", num_keyframes=5, warmup=12,
                 jax_ate_m=0.0030394149898460895, min_edges=0, profile=True),
    "slam pose graph": dict(frames=40, rate=8.0, trajectory="circle", num_keyframes=2,
                            warmup=4, jax_ate_m=0.004132954691568989, min_edges=1, profile=False),
}
# the two-pose factors of the pose-graph drive (computed in float64 on the
# card), each computed again on the CPU on the same inputs: relative pose
# within 1e-12; the information (sqrt_info^T sqrt_info, all the solve
# sees) within 10x the CPU factor's own change when its landmarks change
# by 1e-15 of their size, and at least 1e-10, relative to its norm. A
# factor whose sub-problem holds a landmark seen along one ray (a rank-2
# block, regularised by 1e-9) moves by up to ~2e-5 under that change, the
# others by ~1e-13 (tools/two_pose_precision.py); a wrong factor is off by
# 1e-5 to 4e-2 or more (the same factors computed in float32)
TWO_POSE_T_TOL, TWO_POSE_INFO_TIMES, TWO_POSE_INFO_FLOOR = 1e-12, 10.0, 1e-10
SLAM_MIN_LANDMARKS = 50
# phase 9: the bench's pipelined loop (bench.py:160, run_e2e :163-196) on
# the system and frames of phase 8's first drive, with the JAX package's
# pipelined loop on the same frames and schedule (tools/e2e_reference_jax.py,
# CPU, float32) setting the ATE bar by phase 8's rule (1.5x the JAX ATE plus
# 5 mm, and below 0.10 m where the JAX ATE is). How far behind the host's
# bookkeeping runs changes the result: the JAX loop on the bench's 60
# frames reaches ATE 5.737 mm with one frame in flight at every dispatch
# (its own lag on the CPU, "60 20 default 5 1"), 0.347 m with two ("... 1
# 1"), and 0.119 m on the first 30 frames with three ("30 20 default 5 1 2
# 8192").
# - "slam pipelined": the first 40 of the bench's 60 frames (60 until the
#   phases' time grew with phases 16-17), warm-up 12 (bench.py:189), the
#   loop's own lag. On the card a solve takes longer than a frame's host
#   work, so from the second frame on two frames are in flight at each
#   dispatch: the schedule of the JAX run with one frame kept in flight
#   ("40 20 default 5 1 1": ATE 0.166904 m in 3 of 3 runs, keyframes at
#   frames 0, 1, 2; on 60 frames 0.347 m, keyframes 0, 1, 2, 47). The drive
#   checks that it ran so.
# - "slam pipelined deep lag": the first 30 of those frames with two frames
#   kept in flight (_force_min_pending=2), so that every solve from the
#   third frame on appends three sets of match rows on the card; with 8192
#   observation slots in place of 4096, where the appended rows overflow
#   in both packages (4251 rows in the JAX run; keyframes at frames 0-3).
# The first drive runs with the frame capture set (``capture``: the JAX
# bench's hook, SlamSystem._bench_record), whose records phase 18 replays.
PIPELINED_DRIVES = {
    "slam pipelined": dict(frames=40, rate=20.0, trajectory="default", num_keyframes=5,
                           warmup=12, min_pending=0, in_flight=2, obs_slots=4096,
                           jax_ate_m=0.1669036232354134, min_edges=0, profile=True,
                           capture=True),
    "slam pipelined deep lag": dict(frames=30, rate=20.0, trajectory="default",
                                    num_keyframes=5, warmup=6, min_pending=2, in_flight=3,
                                    obs_slots=8192, jax_ate_m=0.11948972192121458, min_edges=0,
                                    profile=False),
}
# the share of a pipelined drive's frames, from the third on, that must run
# at the drive's schedule (frames in flight after the dispatch)
MIN_SCHEDULE_SHARE = 0.9
# phase 10: loop closure on phase 8's pose-graph drive (one circle, 40
# frames at 8 Hz, 2 window keyframes), with LoopClosureConfig(
# exclude_recent=2) in place of the default 5: one circle makes 5 keyframes
# and place recognition queries only once its database holds
# exclude_recent + 2 frames, so at 5 the circle never queries. The JAX
# package on the same frames (tools/e2e_reference_jax.py, CPU, float32):
# - synchronous ("40 8 circle 2 0 0 4096 1 2"): one closure, at frame 37,
#   loop edge between states 0 and 37; ATE 4.607 mm (4.133 mm without loop
#   closure); keyframes at frames 0, 8, 18, 26, 37; edges after it
#   [[0, 37], [26, 18]];
# - pipelined, one frame kept in flight, the card's schedule ("40 8 circle
#   2 1 1 4096 1 2"): no closure and no drift-budget rejection (the last
#   verification: "ransac inliers 4/78"), ATE 2.718 m: the JAX pipelined
#   loop diverges on this drive at this lag (ROADMAP C), so the drive
#   checks its mechanics: the same decisions, phase 9's ATE rule.
LOOP_DRIVES = {
    "slam loop closure": dict(
        frames=40, rate=8.0, trajectory="circle", num_keyframes=2, warmup=4, exclude_recent=2,
        jax_ate_m=0.0046071292372885176, min_edges=1, profile=False,
        jax_closure_frames=[37], jax_loop_edges=[[0, 37]], pipelined=False),
    "slam loop closure pipelined": dict(
        frames=40, rate=8.0, trajectory="circle", num_keyframes=2, warmup=4, exclude_recent=2,
        jax_ate_m=2.718218399296934, jax_closures=0, jax_rejected=0, min_pending=0,
        pipelined=True),
}
# the full-graph solve queued on the solve worker against the inline one on
# the same state, in float64: poses within 1e-6 m, landmarks as unit
# homogeneous vectors within 1e-6 (a landmark near infinity, w ~ 1e-6,
# turns a last-bit difference into metres in its point); in float32 (as
# the loop runs it) within QUEUED_FG_F32_TOL: bit for bit, since the dense
# path reduces per landmark in an order it fixes (before, its scatter-adds
# summed in another order on every run: 4.8e-7-2.3e-5 m in poses)
QUEUED_FG_TOL_M, QUEUED_FG_TOL_HP = 1e-6, 1e-6
QUEUED_FG_F32_TOL = 0.0
QUEUED_FG_F64_ITERATIONS = 5
# phase 11: multi-session, in the app's order (app_synchronous.py:115-141)
# on phase 10's synchronous session: finish(), the final BA at its defaults
# (30 LM iterations, 8192 landmark and 65536 observation slots, states from
# 32), save_map; then a second session that loads the map and joins the
# same circle at t = 2.5 s (frames 20-39), 3 m from where it starts its own
# frame, in each loop. The JAX package on the same frames
# (tools/e2e_reference_jax.py 40 8 circle 2 0 0 4096 1 2 1 2.5
# sync,pipelined 1; CPU, float32):
# - final BA: aligned ATE 4.765 mm (online 4.607 mm), 178 observations
#   restored, 7 states, 924 landmarks, reprojection RMS 9.730 px. The RMS
#   bar of tests/test_final_ba.py (3 px, on another drive) does not hold
#   for the reference on this session, so the port is held at 1.5x the
#   JAX RMS (ROADMAP C);
# - second session, synchronous: 1848 landmarks loaded, 774 with
#   descriptors; one relocalisation, on keyframe 18 (2.992 m, 0.037 deg),
#   its pose then 11.578 mm from the truth (no alignment: the map's frame
#   is the first session's); the trajectory 14.438 mm RMS from it on;
# - second session, pipelined (one frame kept in flight, the card's
#   schedule): relocalisations on keyframes 7 (3.046 m, 4.430 deg; then
#   26.157 mm from the truth) and 19 (at finish()): after the first the
#   loop drifts off again by metres, as the JAX pipelined loop diverges on
#   this circle at this lag without a map (ROADMAP C), so the drive holds
#   the first relocalisation and logs the rest. Its keyframe is held to the
#   JAX run's (keyframe_slack 0). Before the full-graph solve and the final
#   BA reduced in a fixed order, the map varied by ~1e-5 m from run to run
#   (index_add_ in float32) and this diverging loop carried that into its
#   decisions: two card runs of one tree relocalised first on keyframes 7
#   and 6, and the slack was 2.
# The pose bars: 1.5x the JAX error plus 5 mm (phase 8's rule).
MULTI_SESSION = dict(
    session="slam loop closure", start_s=2.5, jax_fba_ate_m=0.004765339874524123,
    jax_fba_rms_px=9.730219841003418, jax_fba_restored=178, jax_loop_edges=[[0, 37]],
    drives={
        "multi-session": dict(pipelined=False, jax_reloc_keyframes=[18], keyframe_slack=0,
                              jax_first_error_m=0.01157757889056699,
                              jax_rms_from_first_m=0.014438015471071016),
        "multi-session pipelined": dict(pipelined=True, jax_reloc_keyframes=[7, 19],
                                        keyframe_slack=0,
                                        jax_first_error_m=0.02615715336374289,
                                        jax_rms_from_first_m=None),
    })
# the final BA's pack solved again in float64 on the card and on the CPU
# from identical inputs, at QUEUED_FG_F64_ITERATIONS: poses within 1e-6 m,
# landmarks as unit homogeneous vectors within 1e-6 (phase 10's rule); and
# again in float32 on the card, equal to the final BA's solve bit for bit
FBA_F64_TOL_M, FBA_F64_TOL_HP = 1e-6, 1e-6


# phase 12: CNN suppression (SlamSystem(cnn_params=CNN_WEIGHTS), the
# committed Fast-SCNN weights, read by path) at the bench's configuration
# (phase 8's rig, 512 keypoints, EstimatorConfig, float32) on the textured
# world (TexturedWorldDataset, seed 0; its float images in [0, 1] go to the
# system as they are), the bench's default trajectory, 30 frames at 20 Hz:
# the camera sees the sky ceiling (2-6 % of the pixels) and the person
# occluder (2.5 %) on every frame; the network runs on 768x512 (padded to
# multiples of 64). The JAX package on the same frames (CPU, float32):
# - synchronous (tools/e2e_reference_jax.py 30 20 default 5 0 0 4096 0 5
#   0 0 sync 1 textured): keyframes at frames 0 and 24, 14 and 11
#   landmarks suppressed there, ATE 15.157 mm; on the keyframes' images the
#   segmentation gets 0.5379 of the sky pixels and 0.1319 of the person
#   pixels of render_with_labels;
# - pipelined, one frame kept in flight, the card's schedule (... 30 20
#   default 5 1 1 4096 0 5 0 0 sync 1 textured): keyframes at frames 0, 1,
#   2 and 24, suppressing 14, 4, 3 and 9; ATE 0.116929 m.
# Held: the synchronous keyframes; the landmarks suppressed per keyframe
# within max(2, 5 %) of the JAX run's; phase 8's ATE rule in both loops
# (1.5x the JAX ATE + 5 mm); on the synchronous keyframes' images the
# card's class maps against the CPU port's (CNN_CLASS_AGREE of the pixels,
# logits within CNN_LOGIT_TOL of their largest magnitude) and the pixel
# accuracy on sky and person at least the JAX package's - CNN_ACC_SLACK.
CNN_WEIGHTS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "okvis2_tpu", "models",
                           "weights", "fast_scnn_synthetic.npz")
CNN_DRIVES = {
    "slam cnn": dict(
        pipelined=False, jax_ate_m=0.015156986374843336, jax_keyframes=[0, 24],
        jax_suppressed=[[0, 14], [24, 11]],
        jax_accuracy={"sky": 0.5379370278761949, "person": 0.13185895536459877}),
    "slam cnn pipelined": dict(
        pipelined=True, jax_ate_m=0.1169292557985385, jax_keyframes=[0, 1, 2, 24],
        jax_suppressed=[[0, 14], [1, 4], [2, 3], [24, 9]]),
}
CNN_FRAMES, CNN_RATE, CNN_WARMUP = 30, 20.0, 5
CNN_CLASS_AGREE, CNN_LOGIT_TOL, CNN_ACC_SLACK = 0.999, 1e-3, 0.01
# phase 13: phase 11's final-BA pack (S/L/O/R 32/8192/65536/256) solved
# landmark-sharded (parallel/sharded_ba.py): at world size 1 over NCCL in
# this process, and at world size 2 over gloo in two spawned ranks on the
# one card (NCCL refuses two ranks on one device), each held in float64 at
# QUEUED_FG_F64_ITERATIONS against phase 11's unsharded float64 solve on
# the card and against each other (the same LM iterations; poses and
# landmarks at FBA_F64_TOL_M / FBA_F64_TOL_HP); the float32 solve at the
# final BA's 30 iterations, world size 1, must be finite and is logged
# against phase 11's float32 solve. The JAX package's sharded final BA on
# this session (tools/e2e_reference_jax.py 40 8 circle 2 0 0 4096 1 2 1 0
# sync 1 stars 2; 2-device virtual CPU mesh, float32): ATE 4.764 mm (its
# unsharded final BA: 4.765 mm).
FBA_ITERATIONS = 30
# phase 14: the dataset app (okvis2_torch.apps.app_synchronous, the user's
# entry point: YAML config -> EuRoC folder -> SlamSystem -> trajectory CSV)
# at configs/euroc.yaml: two 752x480 radtan cameras (k1 -0.28) with the
# ASL extrinsics, 700 keypoints, loop closure on, enforce_realtime off (up
# to 10 LM iterations per frame), the app's EstimatorConfig defaults
# (512 landmark slots: the frontend keeps up to 700 keypoints per camera,
# so the window's landmarks are truncated to the best 512 as in the JAX
# app; the truncations are logged). Two folders (write_app_folder):
# SyntheticDataset with the config's cameras, T_SC and IMU parameters, 2500
# stars, seed 0, APP_FRAMES frames at 20 Hz and 200 Hz IMU as uint8 images,
# written by DatasetWriter to a temporary directory and rendered on the
# host in float64, so that the smoke run and the JAX reference write the
# same pixels (their digests are held equal). The synchronous app reads
# the first APP_FRAMES frames of an APP_PERIOD s circle (0.19 m a frame:
# the window keyframes four times; on the default trajectory it keyframes
# only frame 0); the pipelined app the default trajectory (on the circle
# the JAX pipelined loop at the card's schedule drifted 1.7 m). The JAX app
# on the same folders (tools/e2e_reference_jax.py app, CPU, float32):
APP_CONFIG = os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs", "euroc.yaml")
APP_FRAMES, APP_PIPELINED_FRAMES, APP_RATE, APP_WARMUP = 40, 20, 20.0, 5
APP_PERIOD = 2.5
# - synchronous (--sync --final-ba --save-map): ATE 19.828 mm, keyframes at
#   frames 0, 12, 24, 37, 1775 landmarks, no loop closure (place
#   recognition excludes the 5 most recent keyframes); truncated: the
#   window's landmarks 28 times, frame-to-frame rows 2; the final BA on 6
#   states and 1563 landmarks, reprojection RMS 3.515 px; the map holds 1775
#   landmarks;
# - pipelined, one frame kept in flight (the card's schedule), the first
#   APP_PIPELINED_FRAMES frames (20; 30 until the phases' time grew with
#   phases 16-17; tools/e2e_reference_jax.py app 40 20 1): ATE 1.423 mm,
#   keyframes at frames 0, 1, 2, in 3 of 3 runs (on the first 30 frames:
#   16.422 mm in 3 of 5 runs; the other two, run beside other work on the
#   CPU, kept other frames, 82.059 and 182.579 mm: the JAX loop's lagged
#   decisions follow its threads' timing).
# Held: the folders' digests, the CSV's rows (one per state), the ATE at
# phase 8's rule (phase 9's for the pipelined app), the synchronous
# keyframes, the final BA's states and its RMS at 1.5x the JAX app's (phase
# 11's rule), one Harris launch per frame per octave, the map loaded into a
# fresh SlamSystem with the session's landmark count, and the pipelined
# app's schedule.
APP_JAX = {
    "sync": dict(ate_m=0.01982753423110339, keyframes=[0, 12, 24, 37], final_ba_states=6,
                 final_ba_rms_px=3.5146372318267822,
                 folder_digest="7162b6adfbc6a6308eb42be65d63a88dd095731b0a688c83c410f16897cb2aea"),
    "pipelined": dict(ate_m=0.001422952393799762, keyframes=[0, 1, 2], min_pending=1,
                      folder_digest="a39a610a32bcf6ada31a301527ee12f5fb089aecd45d7125fad732d212f99d46"),
}
# the pipelined app runs at the loop's own lag: on the card two frames in
# flight after each dispatch from the third frame on (phase 9's schedule)
APP_IN_FLIGHT = 2
# the stages each app run's split prints (utils/timing.py names)
APP_STAGES = {
    "sync": ("1 frontend (fused)", "0 apply previous solve", "2.05 keyframe extras",
             "2.06 place recognition", "3 optimise dispatch", "3.1 pack_np", "3.15 upload",
             "3.2 solve", "5 marginalise"),
    "pipelined": ("0 consume finished frames", "0.1 lagged [solve|diag] fetch",
                  "0.2 finish bookkeeping", "0.3 epilogue", "1 prep",
                  "2 upload + dispatches", "2.06 place recognition", "5 marginalise",
                  "3.2 fused solve (worker)"),
}


def log(msg):
    print(msg, flush=True)


def cuda_ms(fn, l2_flush=None, batches=10, per_batch=20):
    """Device time of one call of ``fn``, over ``batches`` x ``per_batch``
    calls after a warm-up. Each batch is queued behind a spin of the device,
    so the host's enqueue time stays out of the measurement.

    Without ``l2_flush`` the calls run back to back and the time is the
    median batch's CUDA-event time over ``per_batch``: the inputs stay in
    the card's L2 (a warm L2). With ``l2_flush``, a callable that evicts the
    L2 (``buf.zero_`` of a device buffer larger than the L2), every call is
    timed alone between its own events after it, so it reads its inputs
    from HBM as a new frame's image would be read (a cold L2); the time is
    the median call."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(batches):
        n_ev = per_batch if l2_flush is not None else 1
        evs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
               for _ in range(n_ev)]
        torch.cuda._sleep(50_000_000)  # ~25 ms at 2 GHz: the host runs ahead
        if l2_flush is None:
            evs[0][0].record()
            for _ in range(per_batch):
                fn()
            evs[0][1].record()
        else:
            for a, b in evs:
                l2_flush()
                a.record()
                fn()
                b.record()
        torch.cuda.synchronize()
        if l2_flush is None:
            times.append(evs[0][0].elapsed_time(evs[0][1]) / per_batch)
        else:
            times += [a.elapsed_time(b) for a, b in evs]
    return statistics.median(times)


def phase_device():
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(card)
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    return card


def phase_build():
    from okvis2_torch.ops import _build

    secs = _build.build("harris_nms")
    _build.load_library("harris_nms")
    log(f"[build] okvis2_torch/csrc/harris_nms.cu built with nvcc in {secs:.2f} s")
    for line in _build.ptxas_report("harris_nms").splitlines():
        log(f"[build] {line}")


def octaves(imgs, n=3):
    """``imgs`` and its ``n`` 2x2 average-pooled octaves, as detection makes them."""
    out = [imgs]
    for _ in range(n):
        C, h, w = out[-1].shape
        out.append(out[-1][:, : h // 2 * 2, : w // 2 * 2]
                   .reshape(C, h // 2, 2, w // 2, 2).mean(dim=(2, 4)))
    return out


def phase_kernels(imgs):
    """Harris + NMS kernel against its plain version at [2,480,752] and at
    its octaves [2,240,376], [2,120,188], [2,60,94]. The kernel rounds
    every operation as the plain version does, so both maps are held bit
    for bit (tolerance 0); the bar of the JAX package's kernel test
    (response atol 1e-6 / rtol 1e-4, NMS agreement > 0.9999) would be
    loose here, where |resp| is mostly far below 1e-6."""
    from okvis2_torch.ops.harris_cuda import harris_nms_cuda, harris_nms_reference

    for x in octaves(imgs)[1:]:
        rk, nk = harris_nms_cuda(x)
        rp, np_ = harris_nms_reference(x)
        torch.cuda.synchronize()
        assert torch.equal(rk, rp) and torch.equal(nk, np_), (
            f"harris_nms: maps differ from the plain version at {tuple(x.shape)}, max_abs_err "
            f"{(rk - rp).abs().max().item():.3e}")
        log(f"[kernels] harris_nms {list(x.shape)}: resp and NMS equal the plain version")
    resp_k, nms_k = harris_nms_cuda(imgs)
    torch.cuda.synchronize()
    resp_p, nms_p = harris_nms_reference(imgs)
    assert torch.isfinite(resp_k).all(), "harris_nms: non-finite response"
    max_abs_err = (resp_k - resp_p).abs().max().item()
    median_resp = resp_p.abs().median().item()
    agree = (torch.isfinite(nms_k) == torch.isfinite(nms_p)).double().mean().item()
    assert torch.equal(resp_k, resp_p), (
        f"harris_nms: response differs from the plain version: max_abs_err {max_abs_err:.3e}, "
        f"median |resp| {median_resp:.3e}")
    assert torch.equal(nms_k, nms_p), f"harris_nms: NMS map differs, agreement {agree}"

    # > 2x the H100's 50 MB L2: overwritten before each cold-L2 call
    l2_flush = torch.empty(128 << 20, dtype=torch.uint8, device=imgs.device).zero_
    ms = cuda_ms(lambda: harris_nms_cuda(imgs), l2_flush)
    plain_ms = cuda_ms(lambda: harris_nms_reference(imgs), l2_flush)
    ms_warm = cuda_ms(lambda: harris_nms_cuda(imgs))
    plain_ms_warm = cuda_ms(lambda: harris_nms_reference(imgs))
    del l2_flush
    px = imgs.numel()
    bytes_moved = 3 * px * imgs.element_size()  # image in, resp and nms out
    t_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
    t_ops = px * HARRIS_OPS_PER_PX / PEAK_F32_FLOPS * 1e3
    rec = {
        "name": "harris_nms", "route": "cuda",
        "source": "okvis2_torch/csrc/harris_nms.cu",
        "replaces": "okvis2_tpu/ops/harris_pallas.py:110",
        "launches": None, "max_abs_err": max_abs_err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": None,  # no single PyTorch call computes Harris + NMS
        "ms_warm_l2": ms_warm, "plain_ms_warm_l2": plain_ms_warm,
        "median_abs_resp": median_resp, "nms_agreement": agree,
    }
    rec["bound_share"] = rec["bound_ms"] / ms  # of the cold-L2 time
    rec["bytes_per_s"] = bytes_moved / (ms * 1e-3)  # achieved, cold L2
    log(f"[kernels] harris_nms [2,{H},{W}]: max_abs_err {max_abs_err:.3e} (median |resp| "
        f"{median_resp:.3e}), NMS agreement {agree:.6f}; cold L2: kernel {ms * 1e3:.2f} us, "
        f"plain {plain_ms * 1e3:.1f} us; warm L2: kernel {ms_warm * 1e3:.2f} us, plain "
        f"{plain_ms_warm * 1e3:.1f} us; bound {rec['bound_ms'] * 1e3:.2f} us ({rec['bound_by']}), "
        f"bound share {rec['bound_share']:.3f}, {rec['bytes_per_s'] / 1e12:.3f} TB/s")
    return [rec]


def frontend_step(imgs, det_cfg):
    from okvis2_torch.frontend import describe_keypoints, detect_keypoints_batch, match_descriptors

    det = detect_keypoints_batch(imgs, det_cfg)
    desc = [describe_keypoints(imgs[c], det["xy"][c], det["size"][c], det["mask"][c])
            for c in range(2)]
    m = match_descriptors(desc[0]["signs"], det["mask"][0], desc[1]["signs"], det["mask"][1])
    return det, desc, m


def phase_frontend(imgs):
    from okvis2_torch.frontend import DetectionConfig
    from okvis2_torch.frontend.detection import _detect_batch
    from okvis2_torch.ops.harris_cuda import harris_nms_cuda, harris_nms_reference

    cfg = DetectionConfig(max_keypoints=N_KP)
    for frame in range(3):
        n0 = harris_nms_cuda.launches
        det, desc, m = frontend_step(imgs, cfg)
        torch.cuda.synchronize()
        assert harris_nms_cuda.launches > n0, f"frame {frame}: the Harris kernel did not launch"
    assert det["xy"].shape == (2, N_KP, 2) and desc[0]["packed"].shape == (N_KP, 16)
    assert torch.isfinite(det["xy"]).all()
    n_valid = det["mask"].sum(1).tolist()
    n_match = int(m["valid"].sum())
    assert min(n_valid) > N_KP // 2 and n_match > 50, (n_valid, n_match)

    det_p = _detect_batch(imgs, cfg, harris_nms_reference)
    overlaps = []
    for c in range(2):
        sets = [{tuple(p) for p in torch.round(d["xy"][c][d["mask"][c]]).int().tolist()}
                for d in (det, det_p)]
        overlaps.append(len(sets[0] & sets[1]) / max(len(sets[1]), 1))
    assert min(overlaps) >= 0.99, f"keypoints vs plain-Harris chain: overlap {overlaps}"
    log(f"[frontend] {W}x{H} stereo: valid keypoints {n_valid}, matches {n_match}, "
        f"keypoint overlap with the plain-Harris chain {[round(o, 6) for o in overlaps]}")
    return cfg


def build_window(num_states=12, n_side=22):
    from okvis2_torch.utils import synthetic

    problem, cams, imu_params, gt = synthetic.build_problem(
        num_states=num_states, n_landmarks_side=n_side, device=DEVICE)
    frozen = torch.zeros(problem.S, dtype=torch.bool, device=DEVICE)
    frozen[0] = True
    problem = problem.replace(pose_frozen=frozen)
    per_state = torch.bincount(problem.obs_state[problem.obs_cam == 0], minlength=problem.S)
    assert int(per_state.min()) >= 20, f"states with < 20 visible landmarks: {per_state.tolist()}"
    disturbed = synthetic.disturb_problem(problem)
    f32 = torch.float32
    return (disturbed.to(dtype=f32), tuple(c.to(dtype=f32) for c in cams),
            imu_params.to(dtype=f32), gt)


def phase_solve():
    from okvis2_torch.solver import SolverConfig, solve_window

    problem, cams, imu_params, gt = build_window()
    S, L, O, NC = problem.S, problem.L, problem.O, problem.NC
    log(f"[solve] window S={S} L={L} O={O} NC={NC} D=15S+6NC={15 * S + 6 * NC} (float32)")
    t0 = time.perf_counter()
    solved, stats = solve_window(problem, cams, imu_params, SolverConfig(max_iterations=15))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    c0, c1 = float(stats["initial_cost"]), float(stats["final_cost"])
    assert torch.isfinite(solved.pose).all(), "solve: non-finite poses"
    assert c1 <= 1e-3 * c0, f"solve: cost {c0} -> {c1}"
    err = torch.linalg.norm(solved.pose[:, :3].double() - gt["pose"][:, :3], dim=-1)
    assert float(err.max()) < 5e-3, f"solve: position error {err.tolist()}"
    log(f"[solve] {stats['iterations']} iterations, cost {c0:.6e} -> {c1:.6e}, max position "
        f"error {float(err.max()):.3e} m, {secs:.3f} s")
    return problem, cams, imu_params


# phase 5's mixed rig: the window problem of tests/test_torch_mixed_rig.py
# (build_problem(num_states=4, n_landmarks_side=5), first pose frozen,
# disturbed) with camera 1 equidistant, a radtan + equidistant rig, solved
# in float64 for MIXED_RIG_ITERATIONS LM iterations on the card and on the
# CPU (cost 2.30e9 -> 155.26 on the CPU); poses, landmarks and the final cost
# held at MIXED_RIG_RTOL of each array's largest entry, the LM iterations
# equal
MIXED_RIG_EQUIDISTANT = [0.01, -0.005, 0.001, 0.0]
MIXED_RIG_RTOL = 1e-9
MIXED_RIG_ITERATIONS = 5


def phase_mixed_rig():
    """Phase 5's second part: a rig whose cameras differ in distortion class
    (the solver evaluates each camera on its own rows), card against CPU."""
    import dataclasses as dc

    from okvis2_torch.cameras.distortion import EquidistantDistortion
    from okvis2_torch.solver import SolverConfig, gauss_newton, solve_window
    from okvis2_torch.utils import synthetic

    problem, cams, imu_params, _ = synthetic.build_problem(num_states=4, n_landmarks_side=5,
                                                           device="cpu")
    frozen = torch.zeros(problem.S, dtype=torch.bool)
    frozen[0] = True
    problem = synthetic.disturb_problem(problem.replace(pose_frozen=frozen))
    cams = (cams[0], dc.replace(cams[1], distortion=EquidistantDistortion.from_params(
        MIXED_RIG_EQUIDISTANT)))
    assert not gauss_newton._homogeneous(cams)
    cfg = SolverConfig(max_iterations=MIXED_RIG_ITERATIONS)
    t0 = time.perf_counter()
    card, card_stats = solve_window(problem.to(device=DEVICE), tuple(c.to(device=DEVICE)
                                                                      for c in cams),
                                    imu_params.to(device=DEVICE), cfg)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    cpu, cpu_stats = solve_window(problem, cams, imu_params, cfg)
    assert card_stats["iterations"] == cpu_stats["iterations"], (card_stats["iterations"],
                                                                 cpu_stats["iterations"])
    errs = {}
    for name, a, b in (("pose", card.pose, cpu.pose), ("landmarks", card.landmarks,
                                                        cpu.landmarks),
                       ("final cost", card_stats["final_cost"], cpu_stats["final_cost"])):
        a, b = a.double().cpu(), b.double()
        errs[name] = float((a - b).abs().max() / b.abs().max().clamp(min=1e-300))
        assert errs[name] <= MIXED_RIG_RTOL, f"mixed rig: {name} card vs CPU {errs[name]:.3e}"
    c0, c1 = float(cpu_stats["initial_cost"]), float(cpu_stats["final_cost"])
    assert c1 <= 1e-3 * c0, f"mixed rig: cost {c0} -> {c1}"
    log(f"[solve] mixed rig (radtan + equidistant, float64) S={problem.S} L={problem.L} "
        f"O={problem.O}: {card_stats['iterations']} iterations on the card in {secs:.3f} s, cost "
        f"{c0:.6e} -> {float(card_stats['final_cost']):.6e}; card vs CPU relative to each "
        f"array's largest entry " + json.dumps({k: f"{v:.3e}" for k, v in errs.items()}))


def phase_hotpath(imgs, det_cfg, window, card):
    """Returns the kernels' launch counts over the timed frames."""
    from okvis2_torch.ops.harris_cuda import harris_nms_cuda
    from okvis2_torch.solver import SolverConfig, solve_window

    problem, cams, imu_params = window
    cfg3 = SolverConfig(max_iterations=3)

    def frame():
        det, desc, m = frontend_step(imgs, det_cfg)
        solved, _ = solve_window(problem, cams, imu_params, cfg3)
        return m["idx_b"], solved.pose

    frame()
    torch.cuda.synchronize()
    harris_nms_cuda.launches = 0
    t0 = time.perf_counter()
    for _ in range(N_FRAMES):
        idx, pose = frame()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = harris_nms_cuda.launches
    assert launches >= N_FRAMES, f"harris_nms launched {launches} times in {N_FRAMES} frames"
    assert torch.isfinite(pose).all()

    # stage split: each stage alone, synchronised
    from okvis2_torch.frontend import describe_keypoints, detect_keypoints_batch, match_descriptors

    det, desc, _ = frontend_step(imgs, det_cfg)
    split = time_stages({
        "detect": lambda: detect_keypoints_batch(imgs, det_cfg),
        "describe": lambda: [describe_keypoints(imgs[c], det["xy"][c], det["size"][c],
                                                det["mask"][c]) for c in range(2)],
        "match": lambda: match_descriptors(desc[0]["signs"], det["mask"][0],
                                           desc[1]["signs"], det["mask"][1]),
        "solve3": lambda: solve_window(problem, cams, imu_params, cfg3),
    })
    log(f"[hotpath] {N_FRAMES} frames in {secs:.3f} s: {N_FRAMES / secs:.2f} frames/s, "
        f"harris_nms launches {launches} ({card})")
    log("[hotpath] stage ms " + json.dumps({k: round(v, 3) for k, v in split.items()}))
    profile_frame(frame)
    return {"harris_nms": launches}


def tracking_rig(device, dtype=torch.float32):
    """The JAX bench's rig (bench.py:70-88): 752x480, f = 460, radtan
    [-0.05, 0.01, 0, 0], stereo baseline 0.11 m. Returns (cameras, T_SC
    [2,7] numpy, imu parameters)."""
    from okvis2_torch.cameras.distortion import RadialTangentialDistortion
    from okvis2_torch.cameras.pinhole import PinholeCamera
    from okvis2_torch.imu.preintegration import ImuParameters

    cam = PinholeCamera.create(W, H, 460.0, 460.0, W / 2.0, H / 2.0,
                               RadialTangentialDistortion.from_params([-0.05, 0.01, 0.0, 0.0]),
                               dtype=dtype, device=device)
    T_SC = np.array([[0, 0, 0, 0, 0, 0, 1.0], [0.11, 0, 0, 0, 0, 0, 1.0]])
    return (cam, cam), T_SC, ImuParameters.create(g=9.81, device=device)


class Tracking:
    """The host glue around ``frame_associate`` that phase 7 needs, kept to
    what the JAX package's Frontend does for these frames: the landmark
    map (id -> homogeneous point, initialised), which keypoints host which
    landmarks, static-stereo insertion with the sequential-pair dedup
    (frontend_pipeline.py:1880-1919), descriptor staging for matched
    landmarks, frame-to-frame resolution and motion-stereo landmarks
    (:1418-1522). Frame 0 stays the one keyframe."""

    def __init__(self, cams, T_SC, cfg, device):
        from okvis2_torch.pipeline.frontend_pipeline import DeviceLandmarkTable

        self.cams, self.T_SC, self.cfg, self.device = cams, T_SC, cfg, device
        self.table = DeviceLandmarkTable(cfg.map_match_capacity, cfg.n_desc_per_lm, device=device)
        self.table.ensure(512, torch.float32)
        self.lms = {}  # lid -> (hp_W [4], initialised)
        self.kf = None  # frame 0's keypoints, pose and hosted keypoints
        self.prev = None  # the previous frame's keypoints, pose and hosts
        self.staged = None

    def landmarks(self):
        cap = self.table.capacity
        hp = np.tile([0.0, 0.0, 0.0, 1.0], (cap, 1))
        mask, init = np.zeros(cap, bool), np.zeros(cap, bool)
        for lid, s in self.table.slot_of.items():
            hp[s], mask[s], init[s] = self.lms[lid][0], True, self.lms[lid][1]
        return {"hp": hp, "mask": mask, "init": init}

    def new_landmark(self, hp, initialised, cam, kp):
        lid = len(self.lms)
        self.lms[lid] = (np.asarray(hp, np.float64), bool(initialised))
        self.table.stage_descriptor(lid, cam, kp)
        return lid

    def seed(self, out, pose):
        """Frame 0: static stereo at ``pose``; good pairs become landmarks."""
        from okvis2_torch.core import se3_np
        from okvis2_torch.pipeline.frontend_pipeline import _stereo_pairs

        cfg = self.cfg
        T7 = np.stack([se3_np.compose7(pose, T) for T in self.T_SC])
        gate = cfg.stereo_epipolar_gate / float(self.cams[0].focal[0])
        idx_b, hp_W, good, parallel = (x[0].cpu().numpy() for x in _stereo_pairs(
            self.cams, T7[:1], T7[1:], [gate], cfg.min_depth, cfg.max_depth, out["mask"][:1],
            out["mask"][1:], out["xy"], out["signs"], ((0, 1),), cfg.matching_threshold, True))
        hosts = {}
        for a in np.nonzero(good)[0]:
            a, b = int(a), int(idx_b[a])
            if (0, a) in hosts or (1, b) in hosts:
                continue
            lid = self.new_landmark(hp_W[a], not parallel[a], 0, a)
            hosts[(0, a)] = hosts[(1, b)] = lid
        self.table.flush(out["signs"])
        self.kf = {"out": out, "pose": pose, "hosts": hosts}
        self.prev = {"out": out, "pose": pose, "hosts": hosts}
        return len(hosts) // 2

    def inputs(self):
        """frame_associate's keyword inputs for the next frame. Motion
        stereo gets the one keyframe there is: unlike the JAX program, the
        port needs no fixed count of keyframe slots."""
        kf, prev = self.kf["out"], self.prev["out"]
        free = kf["mask"].cpu().numpy().copy()
        for (c, k) in self.kf["hosts"]:
            free[c, k] = False
        upd = self.table.drain(512)
        return {
            "staged": None if self.staged is None else {"signs": self.staged, "upd": upd},
            "keyframes": {"xy": kf["xy"][None], "signs": kf["signs"][None], "free": free[None],
                          "valid": [True], "T_WS7": self.kf["pose"][None]},
            "prev": {"xy": prev["xy"], "signs": prev["signs"], "mask": prev["mask"],
                     "T_WS7": self.prev["pose"]},
        }

    def finish(self, out, slot_lid):
        """Host bookkeeping of one tracked frame; returns (n_matched, n_ff,
        n_motion_stereo)."""
        NC = len(self.cams)
        idx, keep, ms_rows, ff_rows = (out[k].cpu().numpy() for k in
                                       ("idx", "keep", "ms_rows", "ff_rows"))
        hosts = {}
        for ci in range(NC):
            for s in np.nonzero(keep[ci])[0]:
                lid, kp = int(slot_lid[s]), int(idx[ci, s])
                if lid >= 0 and (ci, kp) not in hosts:
                    hosts[(ci, kp)] = lid
                    self.table.stage_descriptor(lid, ci, kp)
        n_matched = len(hosts)
        seen = set(hosts.values())
        for ci, a, b, _ in ff_rows[ff_rows[:, 3] > 0.5].astype(int):
            lid = self.prev["hosts"].get((ci, a))
            if lid is not None and (ci, b) not in hosts and lid not in seen:
                hosts[(ci, b)] = lid
                seen.add(lid)
                self.table.stage_descriptor(lid, ci, b)
        n_ff = len(hosts) - n_matched
        n_ms = 0
        if float(out["rot_frac"]) < self.cfg.rotation_only_veto:
            for r in ms_rows[ms_rows[:, 7] > 0.5]:
                k, ci = divmod(int(r[0]), NC)
                a, b = int(r[1]), int(r[2])
                if k != 0 or (ci, a) in self.kf["hosts"] or (ci, b) in hosts:
                    continue
                lid = self.new_landmark(r[3:7], True, ci, b)
                self.kf["hosts"][(ci, a)] = hosts[(ci, b)] = lid
                n_ms += 1
        self.prev = {"out": out, "pose": out["T_WS7"].double().cpu().numpy(), "hosts": hosts}
        self.staged = out["signs"]
        return n_matched, n_ff, n_ms


def pose_error(T7, T_gt7):
    """(position error m, rotation error degrees)."""
    dq = abs(float(np.dot(T7[3:] / np.linalg.norm(T7[3:]), T_gt7[3:])))
    return float(np.linalg.norm(T7[:3] - T_gt7[:3])), float(np.degrees(2 * np.arccos(min(dq, 1.0))))


def phase_tracking(card):
    """Phase 7; returns the kernels' launch counts over its frames."""
    from okvis2_torch.frontend import DetectionConfig, describe_keypoints, detect_keypoints_batch
    from okvis2_torch.imu.preintegration import propagate_state_np
    from okvis2_torch.ops.harris_cuda import harris_nms_cuda
    from okvis2_torch.pipeline import frontend_pipeline as fp
    from okvis2_torch.pipeline.dataset import SyntheticDataset
    from okvis2_torch.utils.synthetic import true_state

    cams, T_SC, imu = tracking_rig(DEVICE)
    t0 = time.perf_counter()
    ds = SyntheticDataset(cams, [fp._T(torch.tensor(T, device=DEVICE)) for T in T_SC], imu,
                          n_stars=2500, duration=(N_TRACK + 1) / 20.0, frame_rate=20.0,
                          imu_rate=200.0, seed=0, device=DEVICE)
    frames, imu_t, imu_a, imu_w = [], [], [], []
    for ev in ds.stream():
        if ev[0] == "imu":
            imu_t.append(ev[1]); imu_a.append(ev[2]); imu_w.append(ev[3])
        else:  # uint8, as the camera delivers and the JAX bench uploads
            frames.append((ev[1], np.stack([(np.clip(im, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
                                            for im in ev[2]]), ev[3]))
    imu_t, imu_a, imu_w = (np.asarray(x) for x in (imu_t, imu_a, imu_w))
    log(f"[tracking] rendered {len(frames)} {W}x{H} stereo frames of 2500 stars in "
        f"{time.perf_counter() - t0:.2f} s")
    assert len(frames) == N_TRACK + 1

    cfg = fp.FrontendConfig(detection=DetectionConfig(max_keypoints=N_KP),
                            map_match_capacity=TRACK_CAP, ransac_hypotheses=TRACK_HYP)
    trk = Tracking(cams, T_SC, cfg, DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    g = float(imu.g)

    def associate(imgs, T_pred, landmarks, **kw):
        return fp.frame_associate(cams, T_SC, imgs, T_pred, landmarks, trk.table.signs,
                                  trk.table.valid, cfg, generator=gen, device=DEVICE, **kw)

    harris_nms_cuda.launches = 0
    out0 = associate(frames[0][1], frames[0][2], trk.landmarks())
    n_seed = trk.seed(out0, frames[0][2])
    _, v0 = true_state(frames[0][0], device=DEVICE)
    sb = np.concatenate([v0.cpu().numpy(), np.zeros(6)])
    T_est = frames[0][2]
    fa_s, rows = [], []
    for i in range(1, N_TRACK + 1):
        t_prev, t_i = frames[i - 1][0], frames[i][0]
        sel = (imu_t >= t_prev - 1e-9) & (imu_t < t_i - 1e-9)
        T_pred, sb = propagate_state_np(g, T_est, sb, imu_w[sel], imu_a[sel],
                                        np.full(int(sel.sum()), 1.0 / 200.0))
        kw, lm_last = trk.inputs(), trk.landmarks()
        slot_lid = trk.table.slot_lid.copy()
        torch.cuda.synchronize()
        ta = time.perf_counter()
        out = associate(frames[i][1], T_pred, lm_last, **kw)
        torch.cuda.synchronize()
        fa_s.append(time.perf_counter() - ta)
        trk.table.signs, trk.table.valid = out["tab_signs"], out["tab_valid"]
        n_match, n_ff, n_ms = trk.finish(out, slot_lid)
        T_est = trk.prev["pose"]
        err = pose_error(T_est, ds.ground_truth(t_i))
        ok, n_inl = bool(out["ransac_ok"]), int(out["n_inl"])
        rows.append((i, ok, n_inl, n_match, n_ff, n_ms, len(trk.table.slot_of)) + err
                    + (pose_error(T_pred, ds.ground_truth(t_i))[0],))
        log("[tracking] frame {:2d}: ransac_ok {} inliers {:3d} matched {:3d} ff {:3d} "
            "motion-stereo {:3d} map {:4d}, pose error {:.4f} m {:.4f} deg (predicted "
            "{:.4f} m)".format(*rows[-1]))
        assert ok, f"tracking frame {i}: RANSAC failed ({n_inl} inliers)"
        assert n_inl >= TRACK_MIN_INLIERS, f"tracking frame {i}: {n_inl} inliers"
        assert err[0] < TRACK_MAX_POS_M and err[1] < TRACK_MAX_ROT_DEG, (
            f"tracking frame {i}: pose error {err[0]:.4f} m, {err[1]:.4f} deg")
    torch.cuda.synchronize()
    launches = harris_nms_cuda.launches
    n_calls = N_TRACK + 1
    assert launches == n_calls * cfg.detection.octaves, (
        f"harris_nms launched {launches} times in {n_calls} frame_associate calls")
    pos, rot = max(r[7] for r in rows), max(r[8] for r in rows)
    secs = sum(fa_s)
    log(f"[tracking] frame 0 seeded {n_seed} landmarks; {N_TRACK} tracked frames: RANSAC ok on "
        f"all, max pose error {pos:.4f} m / {rot:.4f} deg (bars {TRACK_MAX_POS_M} m, "
        f"{TRACK_MAX_ROT_DEG} deg), min inliers {min(r[2] for r in rows)}, harris_nms launches "
        f"{launches} ({n_calls} calls x {cfg.detection.octaves} octave)")
    log(f"[tracking] frame_associate {N_TRACK / secs:.2f} frames/s (median "
        f"{statistics.median(fa_s) * 1e3:.3f} ms, synchronised per call) ({card})")

    # stage split on the last frame's inputs (its keypoints, the map and
    # table it was matched against): each stage alone, synchronised
    imgs = torch.as_tensor(frames[-1][1], device=DEVICE).float() * (1.0 / 255.0)
    f32 = lambda x: torch.as_tensor(x, dtype=torch.float32, device=DEVICE)  # noqa: E731
    T_SC_t, T_pred_t = f32(T_SC), f32(T_pred)
    lm = {k: torch.as_tensor(v, device=DEVICE) for k, v in lm_last.items()}
    xy, mask, kp_signs = out["xy"], out["mask"], out["signs"]
    rays = torch.stack([cams[c].back_project(xy[c]) for c in range(2)])
    kf = {k: torch.as_tensor(v, device=DEVICE) for k, v in kw["keyframes"].items()}
    kf["T_WS7"] = kf["T_WS7"].float()
    prev = dict(kw["prev"], T_WS7=f32(kw["prev"]["T_WS7"]))

    def sampler(m, cam_idx, n_hyp, nc):
        return fp.sample_hypotheses(gen, m, cam_idx, n_hyp, nc)

    split = time_stages({
        "detect": lambda: detect_keypoints_batch(imgs, cfg.detection),
        "describe": lambda: [describe_keypoints(imgs[c], xy[c], out["size"][c], mask[c])
                             for c in range(2)],
        "back-project": lambda: [cams[c].back_project(xy[c]) for c in range(2)],
        "map match + RANSAC": lambda: fp._associate_core(
            cams, T_pred_t, T_SC_t, lm["hp"].float(), lm["mask"], lm["init"], out["tab_signs"],
            out["tab_valid"], xy, rays, mask, kp_signs, cfg.map_match_radius,
            cfg.ransac_threshold_deg, cfg.matching_threshold, cfg.ransac_hypotheses,
            cfg.ransac_min_inliers, True, sampler),
        "frame-to-frame": lambda: fp._ff_match(cams, T_pred_t, T_SC_t, prev, rays, kp_signs, mask,
                                               cfg.ff_match_angle_deg, cfg.matching_threshold),
        "motion stereo": lambda: fp._stereo_motion_device(
            cams, T_pred_t, T_SC_t, kf, rays, kp_signs, mask, cfg.stereo_epipolar_gate,
            cfg.min_depth, cfg.max_depth, cfg.matching_threshold),
    })
    log("[tracking] stage ms " + json.dumps({k: round(v, 3) for k, v in split.items()}))
    profile_frame(lambda: associate(frames[-1][1], T_pred, lm_last, **kw))
    return {"harris_nms": launches}


def slam_drive(name, d, pipelined):
    """The bench's system (bench.py:136-160) and the frames of one drive
    (``d``: a SLAM_DRIVES or PIPELINED_DRIVES entry), with the solves' LM
    iterations and row counts and every two-pose factor's inputs recorded.
    Returns a namespace: slam, est, est_cfg, fe_cfg, feed_frame() (IMU up
    to the next frame, then the frame; returns its time and ground-truth
    pose), solves [(iterations, rows)], factors, restore()."""
    from types import SimpleNamespace

    from okvis2_torch.core.se3 import Transformation
    from okvis2_torch.frontend import DetectionConfig
    from okvis2_torch.graph import estimator as est_mod
    from okvis2_torch.pipeline.dataset import SyntheticDataset
    from okvis2_torch.pipeline.frontend_pipeline import FrontendConfig
    from okvis2_torch.pipeline.full_graph import LoopClosureConfig
    from okvis2_torch.pipeline.slam import SlamSystem

    n_frames, rate, tag = d["frames"], d["rate"], f"[{name}]"
    start = d.get("start_s", 0.0)  # a later session joins the stream here
    cams, T_SC, imu = tracking_rig(DEVICE)
    exts = [Transformation(r=torch.tensor(T[:3], dtype=torch.float32, device=DEVICE),
                           q=torch.tensor(T[3:], dtype=torch.float32, device=DEVICE))
            for T in T_SC]
    t0 = time.perf_counter()
    # one frame more than the measured run: the profiled frame (a circle
    # drive renders exactly its frames: its period is the duration)
    extra = 1 if d["trajectory"] == "default" else 0
    n_render = d.get("render_frames", n_frames)
    ds = SyntheticDataset(cams, exts, imu, n_stars=2500, duration=(n_render + extra) / rate,
                          frame_rate=rate, imu_rate=200.0, seed=0, trajectory=d["trajectory"],
                          device=DEVICE)
    events = [ev if ev[0] == "imu" else
              (ev[0], ev[1], [(np.clip(im, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
                              for im in ev[2]], ev[3])
              for ev in ds.stream() if ev[1] >= start - 1e-9]
    n_rendered = sum(ev[0] == "images" for ev in events)
    log(f"{tag} rendered {n_rendered} {W}x{H} stereo frames of 2500 stars on the "
        f"{d['trajectory']} trajectory at {rate:g} Hz from t = {start:g} s in "
        f"{time.perf_counter() - t0:.2f} s")
    assert n_rendered == n_frames + extra, n_rendered

    est_cfg = est_mod.EstimatorConfig(window_slots=12, landmark_slots=512,
                                      obs_slots=d.get("obs_slots", 4096),
                                      imu_seg_capacity=64, enforce_realtime=True,
                                      realtime_time_limit=1.0 / 200.0,
                                      num_keyframes=d["num_keyframes"])
    fe_cfg = FrontendConfig(detection=DetectionConfig(max_keypoints=N_KP),
                            map_match_capacity=TRACK_CAP)
    lc = d.get("exclude_recent")
    slam = SlamSystem(cams, exts, imu, est_cfg, fe_cfg, pipelined=pipelined, device=DEVICE,
                      do_loop_closures=lc is not None,
                      loop_closure_config=None if lc is None else LoopClosureConfig(
                          exclude_recent=lc))
    est = slam.estimator
    solves = []
    apply_solved = est.apply_solved_flat

    def apply_and_count(*a, **kw):
        stats = apply_solved(*a, **kw)
        solves.append((int(stats["iterations"]), int(stats["n_obs"])))
        return stats

    est.apply_solved_flat = apply_and_count
    # each two-pose factor's inputs and output, for check_two_pose
    factors, two_pose = [], est_mod.compute_two_pose_factor

    def two_pose_and_keep(*a, **kw):
        out = two_pose(*a, **kw)
        factors.append(([x.cpu() for x in a[:7]], {k: out[k].cpu() for k in ("T_ij", "sqrt_info")}))
        return out

    est_mod.compute_two_pose_factor = two_pose_and_keep
    gen = iter(events)

    def feed_frame():
        """IMU up to the next frame, then the frame (bench.py:183-189)."""
        for ev in gen:
            if ev[0] == "imu":
                slam.add_imu_measurement(ev[1], ev[2], ev[3])
                continue
            slam.add_images(ev[1], ev[2])
            return ev[1], ev[3]
        raise AssertionError(f"{name}: the dataset ran out of frames")

    def restore():
        est_mod.compute_two_pose_factor = two_pose

    return SimpleNamespace(slam=slam, est=est, est_cfg=est_cfg, fe_cfg=fe_cfg,
                           feed_frame=feed_frame, solves=solves, factors=factors,
                           restore=restore, tag=tag, cams=cams, imu=imu)


def check_drive(name, d, run, gt, windows, kf, launches):
    """The checks shared by phases 8 and 9: ATE against the bar, the map,
    the window bound, marginalisation, pose-graph edges and their factors,
    one Harris launch per frame. Returns the ATE."""
    from okvis2_torch.pipeline.trajectory import ate_rmse

    est, n_frames, tag = run.est, d["frames"], run.tag
    traj = est.trajectory()
    ate = ate_rmse(traj, gt, align=True)
    poses = np.stack([p for _, p in traj])
    assert np.isfinite(poses).all() and poses.shape == (n_frames, 7), poses.shape
    jax_ate = d["jax_ate_m"]
    bar = 1.5 * jax_ate + 0.005
    if jax_ate <= 0.10:
        bar = min(bar, 0.10)
    edges = [(e.id_i, e.id_j) for e in est.pose_graph_edges]
    n_left = sum(1 for s in est.state_order if not est.states[s].in_window)
    log(f"{tag} {n_frames} frames: ATE {ate:.6f} m (bar {bar:.6f} m; the JAX package on the "
        f"same frames {jax_ate:.6f} m), keyframes {sum(kf)} at frames "
        f"{[i for i, k in enumerate(kf) if k]}, landmarks {len(est.landmarks)}, pose-graph "
        f"edges {len(edges)} {edges}, window max {max(windows)} of {run.est_cfg.window_slots}, "
        f"states marginalised {n_left}")
    assert ate < bar, f"{name}: ATE {ate:.6f} m against a bar of {bar:.6f} m"
    assert len(est.landmarks) > SLAM_MIN_LANDMARKS, f"{name}: {len(est.landmarks)} landmarks"
    assert max(windows) <= run.est_cfg.window_slots, f"{name}: window sizes {windows}"
    assert n_left >= 1, f"{name}: no state left the window (no marginalisation)"
    assert len(edges) >= d["min_edges"], f"{name}: {len(edges)} pose-graph edges"
    n_marg = sum(e.kind == "marg" for e in est.pose_graph_edges)
    if est.pose_graph_edges and "exclude_recent" in d:
        # a closure gives the marginalisation edges of its span back
        assert len(run.factors) >= n_marg, (len(run.factors), n_marg)
    else:
        assert len(run.factors) == len(edges) == n_marg, (len(run.factors), len(edges))
    n_oct = run.fe_cfg.detection.octaves
    assert launches == n_frames * n_oct, (
        f"harris_nms launched {launches} times in {n_frames} frames x {n_oct} octave")
    if run.factors:
        check_two_pose(tag, run.factors)
    return ate


def log_split(tag, names, n_steady):
    """The named stages' ms per steady frame and call counts."""
    from okvis2_torch.utils.timing import Timing

    split = {}
    for k in names:
        s = Timing.get(k)
        split[k] = {"ms_per_frame": round(s.total / n_steady * 1e3, 3) if s else 0.0,
                    "calls": s.n if s else 0}
    log(f"{tag} stage split over the steady frames " + json.dumps(split))


def phase_slam(card, name, d):
    """Phase 8, one drive (``d``: a SLAM_DRIVES entry); returns the
    kernels' launch counts over its frames."""
    from okvis2_torch.ops.harris_cuda import harris_nms_cuda
    from okvis2_torch.utils.timing import Timing

    n_frames, run = d["frames"], slam_drive(name, d, pipelined=False)
    slam, est, tag = run.slam, run.est, run.tag
    gt, frame_s, windows, kf = [], [], [], []
    try:
        torch.cuda.synchronize()
        harris_nms_cuda.launches = 0
        for i in range(n_frames):
            if i == d["warmup"]:
                Timing.reset()  # the stage split covers the steady frames
            t_i, pose = run.feed_frame()
            ta = time.perf_counter()
            slam.process_frame()
            torch.cuda.synchronize()
            frame_s.append(time.perf_counter() - ta)
            gt.append((t_i, pose))
            windows.append(len(est.window))
            kf.append(bool(slam.tracking.is_keyframe))
        launches = harris_nms_cuda.launches
    finally:
        run.restore()
    check_drive(name, d, run, gt, windows, kf, launches)

    steady = frame_s[d["warmup"]:]
    n_steady = len(steady)
    iterations = [it for it, _ in run.solves]
    log(f"{tag} process_frame {n_steady / sum(steady):.3f} frames/s over frames "
        f"{d['warmup'] + 1}-{n_frames} (median {statistics.median(steady) * 1e3:.3f} ms; "
        f"first frame {frame_s[0] * 1e3:.1f} ms), harris_nms launches {launches} "
        f"({n_frames} frames x {run.fe_cfg.detection.octaves} octave) ({card})")
    log_split(tag, ("1 frontend (fused)", "0 apply previous solve", "2.05 keyframe extras",
                    "3 optimise dispatch", "3.1 pack_np", "3.15 upload", "3.2 solve",
                    "5 marginalise"), n_steady)
    log(f"{tag} LM iterations per applied solve: first {iterations[:3]}, steady "
        f"{sorted(set(iterations[d['warmup']:]))}, mean {statistics.mean(iterations):.2f} over "
        f"{len(iterations)} solves")

    if d["profile"]:
        def steady_frame():
            run.feed_frame()
            slam.process_frame()

        profile_frame(steady_frame)
    return {"harris_nms": launches}


def phase_pipelined(card, name, d):
    """Phase 9, one drive (``d``: a PIPELINED_DRIVES entry) of the
    pipelined loop; returns the kernels' launch counts over its frames and,
    where ``d["capture"]``, the system with its frame records and the
    loop's frames/s (else None). The loop is timed as its user sees it:
    ``process_frame`` returns without waiting for the device (nothing here
    synchronises between frames), and ``finish()`` drains the frames still
    in flight."""
    from okvis2_torch.ops.harris_cuda import harris_nms_cuda
    from okvis2_torch.solver.packed_solve import MAX_APPEND_SETS
    from okvis2_torch.utils.timing import Timing

    n_frames, run = d["frames"], slam_drive(name, d, pipelined=True)
    slam, est, tag = run.slam, run.est, run.tag
    slam._force_min_pending = d["min_pending"]
    if d.get("capture"):
        slam._bench_record = []
    kf_of = {}
    slam.set_optimised_graph_callback(
        lambda t, sid, pose, tr: kf_of.__setitem__(sid, bool(tr.is_keyframe)))
    gt, frame_s, windows, in_flight, n_sets = [], [], [], [], []
    # the last frame is profiled (with 1-2 frames in flight) and left out of
    # the timing
    n_timed = n_frames - 1 if d["profile"] else n_frames
    try:
        torch.cuda.synchronize()
        harris_nms_cuda.launches = 0
        for i in range(n_frames):
            if i == d["warmup"]:
                Timing.reset()  # the stage split covers the steady frames
            t_i, pose = run.feed_frame()
            if i == n_timed:
                profile_frame(slam.process_frame)
            else:
                ta = time.perf_counter()
                slam.process_frame()
                frame_s.append(time.perf_counter() - ta)
            gt.append((t_i, pose))
            windows.append(len(est.window))
            in_flight.append(len(slam._pending_frames))
            n_sets.append(slam._pending_frames[-1]["n_sets"])
        ta = time.perf_counter()
        slam.finish()
        drain_s = time.perf_counter() - ta
        torch.cuda.synchronize()
        launches = harris_nms_cuda.launches
    finally:
        run.restore()
    kf = [kf_of[s] for s in est.state_order]
    check_drive(name, d, run, gt, windows, kf, launches)
    rows = [r for _, r in run.solves]
    assert len(run.solves) == n_frames, (len(run.solves), n_frames)
    assert max(rows) <= run.est_cfg.obs_slots, f"{name}: device-appended rows {max(rows)}"
    # the schedule the JAX reference ran at
    share = float(np.mean([n == d["in_flight"] for n in in_flight[2:]]))
    assert share >= MIN_SCHEDULE_SHARE, (
        f"{name}: {share:.3f} of the frames ran with {d['in_flight']} in flight: {in_flight}")
    if d["min_pending"]:
        # from the third frame on, two frames are in flight at every
        # dispatch: every solve appends its own and their match rows
        assert all(n == MAX_APPEND_SETS for n in n_sets[d["min_pending"]:]), n_sets
    lag = {str(k): in_flight.count(k) for k in sorted(set(in_flight))}
    sets = {str(k): n_sets.count(k) for k in sorted(set(n_sets))}

    steady = frame_s[d["warmup"]:]
    n_steady = len(steady)
    iterations = [it for it, _ in run.solves]
    log(f"{tag} process_frame {n_steady / sum(steady):.3f} frames/s over frames "
        f"{d['warmup'] + 1}-{n_timed} (median {statistics.median(steady) * 1e3:.3f} ms; "
        f"first frame {frame_s[0] * 1e3:.1f} ms), finish() drained the last "
        f"{in_flight[-1]} frames in {drain_s * 1e3:.1f} ms; harris_nms launches {launches} "
        f"({card})")
    log(f"{tag} frames in flight after each dispatch (lag histogram) {json.dumps(lag)}; sets "
        f"appended per solve {json.dumps(sets)}; device rows per solve: max {max(rows)} of "
        f"{run.est_cfg.obs_slots}")
    log_split(tag, ("0 consume finished frames", "0.1 lagged [solve|diag] fetch",
                    "0.2 finish bookkeeping", "0.3 epilogue", "0.5 imu + predict", "1 prep",
                    "3.1 pack_np", "2 upload + dispatches", "3.15 upload",
                    "2.05 keyframe extras dispatch", "2.05 keyframe extras finish",
                    "5 marginalise", "3.2 fused solve (worker)"), n_steady)
    log(f"{tag} LM iterations per applied solve: first {iterations[:3]}, steady "
        f"{sorted(set(iterations[d['warmup']:]))}, mean {statistics.mean(iterations):.2f} over "
        f"{len(iterations)} solves")
    capture = None
    if d.get("capture"):
        assert len(slam._bench_record) == n_frames, (len(slam._bench_record), n_frames)
        capture = {"slam": slam, "records": slam._bench_record, "tag": tag,
                   "fps": n_steady / sum(steady), "in_flight": in_flight}
    return {"harris_nms": launches}, capture


LOOP_STAGES = ("2.06 place recognition", "2.08 loop closure", "2.081 loop verify",
               "2.082 full-graph pack", "2.083 full-graph solve")


def stage_totals(names):
    from okvis2_torch.utils.timing import Timing

    return {k: (Timing.get(k).total if Timing.get(k) else 0.0) for k in names}


def queued_against_inline(tag, lb, fg_log):
    """Wrap ``lb.optimise_full_graph`` so that each closure's full-graph
    solve runs inline (the call the loop made, whose result stays) and, on
    the state before it, again queued on the estimator's solve worker and
    applied by ``apply_pending_full_graph``: in float32 as the loop runs it,
    where the two must agree within QUEUED_FG_F32_TOL, and both ways again
    in float64 at QUEUED_FG_F64_ITERATIONS LM iterations (the queue, the
    worker's stream and the apply are the same at any count; a float64
    solve takes far longer on the card), where the queued solve must give
    the inline one's poses within QUEUED_FG_TOL_M and its landmarks (unit
    homogeneous vectors) within QUEUED_FG_TOL_HP.
    The wall time of each run, the inline solve's capacities and iterations, and the device
    kernels of one more float32 solve of the same pack under the profiler
    go to ``fg_log``; the extra runs are left out of the stage timers and
    their wall time is logged as "extra_ms"."""
    from okvis2_torch.pipeline import full_graph as fg_mod
    from okvis2_torch.utils.timing import Timing

    inline = lb.optimise_full_graph

    def snapshot(est):
        """What a full-graph solve reads and writes: poses, speed/biases,
        landmarks, and the IMU preintegration cache (linearised at earlier
        biases until the apply clears it)."""
        return ({s: (r.pose.copy(), r.speed_bias.copy()) for s, r in est.states.items()},
                {lid: lm.hp_W.copy() for lid, lm in est.landmarks.items()},
                dict(est._pre_cache))

    def restore(est, snap):
        for s, (pose, sb) in snap[0].items():
            est.states[s].pose, est.states[s].speed_bias = pose.copy(), sb.copy()
        for lid, hp in snap[1].items():
            est.landmarks[lid].hp_W = hp.copy()
        est._pre_cache.clear()
        est._pre_cache.update(snap[2])

    def queued(est, before):
        restore(est, before)
        torch.cuda.synchronize()
        t = time.perf_counter()
        lb.dispatch_full_graph(est, async_solve=True)
        lb.apply_pending_full_graph(est)
        ms = (time.perf_counter() - t) * 1e3
        est.close_solve_worker()
        return snapshot(est), ms

    def gaps(a, b):
        unit = lambda hp: hp / np.linalg.norm(hp)  # noqa: E731
        d_pose = max(float(np.abs(a[0][s][0][:3] - b[0][s][0][:3]).max()) for s in a[0])
        d_hp = max((float(np.abs(unit(a[1][k]) - unit(b[1][k])).max()) for k in a[1]),
                   default=0.0)
        return d_pose, d_hp

    def compare(est):
        before = snapshot(est)
        torch.cuda.synchronize()
        t = time.perf_counter()
        stats = inline(est)
        inline_ms = (time.perf_counter() - t) * 1e3
        info = dict(lb.last_full_graph)
        got = snapshot(est)
        t_extra = time.perf_counter()
        Timing.enabled = False
        saved = (est.dtype, est.imu_params, lb.cameras, lb.cfg)
        try:
            q32, queued_ms = queued(est, before)
            f64 = torch.float64
            est.dtype, est.imu_params = f64, est.imu_params.to(dtype=f64)
            lb.cameras = tuple(c.to(dtype=f64) for c in lb.cameras)
            lb.cfg = dataclasses.replace(lb.cfg, full_graph_iterations=QUEUED_FG_F64_ITERATIONS)
            restore(est, before)
            torch.cuda.synchronize()
            t = time.perf_counter()
            inline(est)
            inline64_ms = (time.perf_counter() - t) * 1e3
            i64 = snapshot(est)
            q64, queued64_ms = queued(est, before)
            est.dtype, est.imu_params, lb.cameras, lb.cfg = saved
            # the device kernels of one full-graph solve: the same pack once
            # more under the profiler (its time is not used)
            restore(est, before)
            prob, *_ = lb.pack_full_problem(est)
            n_kernels = profile_kernels(lambda: fg_mod._solve_full_graph(
                prob, lb.cameras, est.imu_params,
                fg_mod.SolverConfig(max_iterations=lb.cfg.full_graph_iterations)).cpu())
            restore(est, got)
        finally:
            est.dtype, est.imu_params, lb.cameras, lb.cfg = saved
            Timing.enabled = True
        extra_ms = (time.perf_counter() - t_extra) * 1e3
        d32, d64 = gaps(got, q32), gaps(i64, q64)
        fg_log.append(dict(inline_ms=inline_ms, queued_ms=queued_ms, extra_ms=extra_ms,
                           d32=d32, d64=d64, kernels=n_kernels, **info))
        log(f"{tag} full-graph solve at the closure: inline {inline_ms:.3f} ms, queued on the "
            f"solve worker and applied {queued_ms:.3f} ms; {info['iterations']} LM iterations, "
            f"capacities S/L/O/R {info['S']}/{info['L']}/{info['O']}/{info['R']} (used "
            f"{list(info['used'])}), {n_kernels} device kernels per solve; queued vs inline "
            f"(poses m, landmarks as unit homogeneous vectors): float32 {d32[0]:.3e} "
            f"{d32[1]:.3e} (bar {QUEUED_FG_F32_TOL:g}), float64 at {QUEUED_FG_F64_ITERATIONS} "
            f"iterations {d64[0]:.3e} "
            f"{d64[1]:.3e} (bars {QUEUED_FG_TOL_M:g}, {QUEUED_FG_TOL_HP:g}; inline "
            f"{inline64_ms:.3f} ms, queued {queued64_ms:.3f} ms)")
        assert d64[0] < QUEUED_FG_TOL_M and d64[1] < QUEUED_FG_TOL_HP, d64
        assert d32[0] <= QUEUED_FG_F32_TOL and d32[1] <= QUEUED_FG_F32_TOL, d32
        return stats

    lb.optimise_full_graph = compare


def profile_kernels(fn):
    """The number of device kernels ``fn`` launches (torch.profiler), or
    None when the profiler sees no device kernels. Only device activity is
    traced: tracing every host op as well costs ~1.5 ms per device kernel,
    most of it summing the trace (tools/profiler_overhead.py)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    n = sum(e.count for e in prof.key_averages() if e.device_type == DeviceType.CUDA)
    return n or None


def phase_loop_sync(card, name, d):
    """Phase 10, the synchronous drive: phase 8's loop with loop closure;
    returns the kernels' launch counts over its frames, and the session
    (run, ground truth, ATE) that phase 11 takes on."""
    from okvis2_torch.ops.harris_cuda import harris_nms_cuda
    from okvis2_torch.utils.timing import Timing

    n_frames, run = d["frames"], slam_drive(name, d, pipelined=False)
    slam, est, tag = run.slam, run.est, run.tag
    lb = slam.loop_backend
    fg_log = []
    queued_against_inline(tag, lb, fg_log)
    gt, frame_s, windows, kf, closures, split_of = [], [], [], [], [], {}
    try:
        torch.cuda.synchronize()
        harris_nms_cuda.launches = 0
        for i in range(n_frames):
            if i == d["warmup"]:
                Timing.reset()
            t_i, pose = run.feed_frame()
            n0, before = lb.num_loop_closures, stage_totals(LOOP_STAGES)
            ta = time.perf_counter()
            slam.process_frame()
            torch.cuda.synchronize()
            frame_s.append(time.perf_counter() - ta)
            if lb.num_loop_closures > n0:
                closures.append(i)
                after = stage_totals(LOOP_STAGES)
                split_of[i] = {k: round((after[k] - before[k]) * 1e3, 3) for k in LOOP_STAGES}
            gt.append((t_i, pose))
            windows.append(len(est.window))
            kf.append(bool(slam.tracking.is_keyframe))
        launches = harris_nms_cuda.launches
    finally:
        run.restore()
    loop_edges = [[e.id_i, e.id_j] for e in est.pose_graph_edges if e.kind == "loop"]
    log(f"{tag} closures at frames {closures} (the JAX run: {d['jax_closure_frames']}), loop "
        f"edges {loop_edges} (JAX {d['jax_loop_edges']}), rejected by the drift budget "
        f"{lb.num_rejected_by_budget}, verify margins {[round(m, 3) for m in lb.verify_margins]}")
    assert closures == d["jax_closure_frames"], closures
    assert loop_edges == d["jax_loop_edges"], loop_edges
    assert len(fg_log) == len(closures), fg_log
    ate = check_drive(name, d, run, gt, windows, kf, launches)

    steady = [s for i, s in enumerate(frame_s) if i >= d["warmup"] and i not in closures]
    log(f"{tag} process_frame {len(steady) / sum(steady):.3f} frames/s over frames "
        f"{d['warmup'] + 1}-{n_frames} without the closure frames (median "
        f"{statistics.median(steady) * 1e3:.3f} ms), harris_nms launches {launches} ({card})")
    for i, fg in zip(closures, fg_log):
        # the closure frame's own time: without the queued solve and the
        # profiled solve run for the comparison above
        split_of[i]["2.08 loop closure"] = round(split_of[i]["2.08 loop closure"]
                                                 - fg["extra_ms"], 3)
        log(f"{tag} closure frame {i}: {frame_s[i] * 1e3 - fg['extra_ms']:.3f} ms (the "
            f"comparison's extra {fg['extra_ms']:.3f} ms left out), of it "
            + json.dumps(split_of[i]))
    lb.optimise_full_graph = type(lb).optimise_full_graph.__get__(lb)  # the comparison ends
    return {"harris_nms": launches}, (run, gt, ate)


def phase_loop_pipelined(card, name, d):
    """Phase 10, the pipelined drive: phase 9's loop with loop closure, at
    its own lag; returns the kernels' launch counts over its frames."""
    from okvis2_torch.ops.harris_cuda import harris_nms_cuda
    from okvis2_torch.pipeline.trajectory import ate_rmse
    from okvis2_torch.utils.timing import Timing

    n_frames, run = d["frames"], slam_drive(name, d, pipelined=True)
    slam, est, tag = run.slam, run.est, run.tag
    slam._force_min_pending = d["min_pending"]
    lb = slam.loop_backend
    gt, frame_s, closures = [], [], []
    try:
        torch.cuda.synchronize()
        harris_nms_cuda.launches = 0
        for i in range(n_frames):
            if i == d["warmup"]:
                Timing.reset()
            t_i, pose = run.feed_frame()
            n0 = lb.num_loop_closures
            ta = time.perf_counter()
            slam.process_frame()
            frame_s.append(time.perf_counter() - ta)
            closures += [i] * (lb.num_loop_closures - n0)
            gt.append((t_i, pose))
        n0 = lb.num_loop_closures
        slam.finish()
        closures += ["finish"] * (lb.num_loop_closures - n0)
        torch.cuda.synchronize()
        launches = harris_nms_cuda.launches
    finally:
        run.restore()
    traj = est.trajectory()
    ate = ate_rmse(traj, gt, align=True)
    assert np.isfinite(np.stack([p for _, p in traj])).all() and len(traj) == n_frames
    jax_ate = d["jax_ate_m"]
    bar = 1.5 * jax_ate + 0.005
    if jax_ate <= 0.10:
        bar = min(bar, 0.10)
    steady = frame_s[d["warmup"]:]
    pr = Timing.get("2.06 place recognition")
    log(f"{tag} {n_frames} frames: ATE {ate:.6f} m (bar {bar:.6f} m; the JAX package at the "
        f"same schedule {jax_ate:.6f} m), closures {lb.num_loop_closures} at {closures} (JAX "
        f"{d['jax_closures']}), rejected by the drift budget {lb.num_rejected_by_budget} (JAX "
        f"{d['jax_rejected']}), last verification {lb.last_verify_info!r}, landmarks "
        f"{len(est.landmarks)}")
    log(f"{tag} process_frame {len(steady) / sum(steady):.3f} frames/s over frames "
        f"{d['warmup'] + 1}-{n_frames} (median {statistics.median(steady) * 1e3:.3f} ms), "
        f"\"2.06 place recognition\" {pr.n if pr else 0} calls, "
        f"{(pr.total / pr.n * 1e3) if pr else 0.0:.3f} ms each, harris_nms launches "
        f"{launches} ({card})")
    assert ate < bar, f"{name}: ATE {ate:.6f} m against a bar of {bar:.6f} m"
    assert lb.num_loop_closures == d["jax_closures"], lb.num_loop_closures
    assert lb.num_rejected_by_budget == d["jax_rejected"], lb.num_rejected_by_budget
    n_oct = run.fe_cfg.detection.octaves
    assert launches == n_frames * n_oct, launches
    return {"harris_nms": launches}


def phase_multi_session(card, run, gt, online_ate):
    """Phase 11 on phase 10's synchronous session (``run``, its ground
    truth and ATE): finish(), the final BA with its checks and its pack
    solved again in float64 on the card and on the CPU, save_map and the
    file read back, then the second sessions (MULTI_SESSION["drives"]).
    Returns the kernels' launch counts over each second session, and the
    final BA's pack with its unsharded solves (for phase 13)."""
    import tempfile

    from okvis2_torch.pipeline import final_ba as fba
    from okvis2_torch.pipeline.component_io import load_component
    from okvis2_torch.pipeline.trajectory import ate_rmse

    ms, tag = MULTI_SESSION, "[final BA]"
    slam, est = run.slam, run.est
    slam.finish()
    captured, solve = [], fba.solve_window

    def solve_and_keep(prob, cameras, imu_params, config):
        out = solve(prob, cameras, imu_params, config)
        captured.append((prob, out[1], out[0]))
        return out

    fba.solve_window = solve_and_keep
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        info = slam.do_final_ba()
        torch.cuda.synchronize()
        fba_ms = (time.perf_counter() - t0) * 1e3
    finally:
        fba.solve_window = solve
    prob, stats, first = captured[0]
    ate = ate_rmse(est.trajectory(), gt, align=True)
    loop_edges = [[e.id_i, e.id_j] for e in est.pose_graph_edges if e.kind == "loop"]
    bar_ate = min(1.5 * ms["jax_fba_ate_m"] + 0.005, 1.5 * online_ate + 0.001)
    bar_rms = 1.5 * ms["jax_fba_rms_px"]
    rms = info["reproj_rms_px"]
    # the device kernels of one more solve of the same pack (its time is not
    # used), and the spread of its reprojection errors
    again = []
    n_kernels = profile_kernels(lambda: again.append(solve(
        prob, est.cameras, est.imu_params, fba.SolverConfig(max_iterations=30))[0]))
    r, m = fba._reproj_residuals(again[0], est.cameras)
    solved = again[0]
    # the dense path reduces in a fixed order: the second solve of the pack
    # repeats the first bit for bit
    repeats = all(torch.equal(getattr(first, k), getattr(solved, k))
                  for k in ("pose", "speed_bias", "extrinsics", "landmarks"))
    err_px = (torch.linalg.norm(r, dim=-1) / solved.obs_sqrt_info)[m].double().cpu().numpy()
    log(f"{tag} {fba_ms:.3f} ms, {stats['iterations']} LM iterations, capacities S/L/O/R "
        f"{prob.S}/{prob.L}/{prob.O}/{prob.rel_mask.shape[0]} (used {info['states']}/"
        f"{info['landmarks']}/{int(prob.obs_mask.sum())}/{int(prob.rel_mask.sum())}), "
        f"{n_kernels} device kernels per solve, {info['restored_observations']} observations "
        f"restored (JAX {ms['jax_fba_restored']}), reprojection RMS {rms:.3f} px (bar "
        f"{bar_rms:.3f}; the JAX package {ms['jax_fba_rms_px']:.3f}; median "
        f"{np.median(err_px):.3f}, p90 {np.percentile(err_px, 90):.3f}, max {err_px.max():.3f}, "
        f"{np.mean(err_px > 3.0):.4f} of the observations above 3 px), ATE {ate:.6f} m (bar "
        f"{bar_ate:.6f}; online {online_ate:.6f}, the JAX final BA {ms['jax_fba_ate_m']:.6f}), "
        f"loop edges {loop_edges} ({card})")
    log(f"{tag} the pack solved again in float32 (30 LM iterations, under the profiler): "
        f"poses, speed/biases, extrinsics and landmarks equal to the final BA's bit for bit: "
        f"{repeats}")
    assert repeats, "final BA: a second float32 solve of the pack differs from the first"
    check_overhead_image(est)
    assert info["restored_observations"] > 0, info["restored_observations"]
    assert loop_edges == ms["jax_loop_edges"], loop_edges
    assert info["states"] > 4 and info["landmarks"] > SLAM_MIN_LANDMARKS, info
    assert rms < bar_rms, f"final BA: reprojection RMS {rms:.3f} px against {bar_rms:.3f}"
    for k in ("bias_gyro_mean", "bias_gyro_std", "bias_accel_mean", "bias_accel_std",
              "reproj_heatmaps"):
        assert np.isfinite(info[k]).all(), k
    assert info["reproj_heatmaps"].shape[0] == len(est.cameras), info["reproj_heatmaps"].shape
    assert ate < bar_ate, f"final BA: ATE {ate:.6f} m against {bar_ate:.6f} m"
    # the same pack in float64, card against CPU on identical inputs
    f64, cfg64 = torch.float64, fba.SolverConfig(max_iterations=QUEUED_FG_F64_ITERATIONS)
    p64 = prob.to(device="cpu", dtype=f64)
    out = {}
    for dev in ("cpu", DEVICE):
        t0 = time.perf_counter()
        sol, st = solve(p64.to(device=dev), tuple(c.to(device=dev, dtype=f64) for c in est.cameras),
                        est.imu_params.to(device=dev, dtype=f64), cfg64)
        out[dev] = (sol.pose.cpu().numpy(), sol.landmarks.cpu().numpy(), st["iterations"],
                    (time.perf_counter() - t0) * 1e3)
    unit = lambda hp: hp / np.linalg.norm(hp, axis=-1, keepdims=True)  # noqa: E731
    n_s, n_l = info["states"], info["landmarks"]
    d_pose = float(np.abs(out[DEVICE][0][:n_s, :3] - out["cpu"][0][:n_s, :3]).max())
    d_hp = float(np.abs(unit(out[DEVICE][1][:n_l]) - unit(out["cpu"][1][:n_l])).max())
    log(f"{tag} the pack in float64 at {QUEUED_FG_F64_ITERATIONS} iterations, card against CPU: "
        f"poses within {d_pose:.3e} m, landmarks within {d_hp:.3e} (bars {FBA_F64_TOL_M:g}, "
        f"{FBA_F64_TOL_HP:g}); iterations {out[DEVICE][2]} / {out['cpu'][2]}; card "
        f"{out[DEVICE][3]:.3f} ms, CPU {out['cpu'][3]:.3f} ms")
    assert d_pose < FBA_F64_TOL_M and d_hp < FBA_F64_TOL_HP, (d_pose, d_hp)
    assert out[DEVICE][2] == out["cpu"][2], (out[DEVICE][2], out["cpu"][2])

    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/session1.map"
        t0 = time.perf_counter()
        slam.save_map(path)
        save_ms = (time.perf_counter() - t0) * 1e3
        data = load_component(path)
        d_pose = max(float(np.abs(data["states"][s]["pose"] - est.states[s].pose).max())
                     for s in est.state_order)
        d_lm = max(float(np.abs(data["landmarks"][lid] - lm.hp_W).max())
                   for lid, lm in est.landmarks.items())
        # written to 9 decimals: within half a unit of the 9th, and the parse
        assert data["states"].keys() == set(est.state_order) and d_pose < 1e-9, d_pose
        assert data["landmarks"].keys() == est.landmarks.keys() and d_lm < 1e-9, d_lm
        words = {o["lid"]: o["descriptor"] for o in data["observations"] if "descriptor" in o}
        for lid, w in words.items():
            bits = (np.asarray(slam.frontend.lm_descriptors[lid]) > 0).astype(np.uint32)
            packed = (bits.reshape(-1, 32) << np.arange(32, dtype=np.uint32)).sum(
                axis=-1, dtype=np.uint32)
            assert np.array_equal(w, packed), lid
        log(f"[save map] {len(data['states'])} states, {len(data['landmarks'])} landmarks, "
            f"{len(words)} with descriptors, {len(data['observations'])} observations, "
            f"{len(data['rel_edges'])} relative edges in {save_ms:.3f} ms; read back: poses "
            f"within {d_pose:.1e}, landmarks within {d_lm:.1e} (the file's 9 decimals), "
            f"descriptors bit for bit")
        launches = {name: second_session(card, name, d, path, data)
                    for name, d in ms["drives"].items()}
    # what phase 13 solves again, sharded: the pack, in float64 on the CPU,
    # and its unsharded solves (float64 at QUEUED_FG_F64_ITERATIONS on the
    # card, float32 at the final BA's 30 iterations)
    pack = {"prob": prob, "p64": p64, "ref64": out[DEVICE], "pose32": again[0].pose.cpu().numpy(),
            "cams": est.cameras, "imu": est.imu_params, "states": n_s, "landmarks": n_l}
    return launches, pack


def check_overhead_image(est):
    """``visualizer.draw_overhead_image`` of the session after its final BA:
    [512, 512], the current pose marked at 1.0, and the same image from the
    same records held as tensors on the card."""
    import types

    from okvis2_torch.pipeline.visualizer import draw_overhead_image

    t0 = time.perf_counter()
    img = draw_overhead_image(est)
    ms = (time.perf_counter() - t0) * 1e3
    on_card = types.SimpleNamespace(
        state_order=list(est.state_order),
        states={s: types.SimpleNamespace(pose=torch.as_tensor(r.pose, device=DEVICE),
                                         is_keyframe=r.is_keyframe)
                for s, r in est.states.items()},
        landmarks={k: types.SimpleNamespace(hp_W=torch.as_tensor(lm.hp_W, device=DEVICE),
                                            initialised=lm.initialised)
                   for k, lm in est.landmarks.items()})
    same = np.array_equal(draw_overhead_image(on_card), img)
    log(f"[overhead image] {img.shape} in {ms:.1f} ms (host): max {img.max():.2f}, "
        f"{int((img == 0.25).sum())} landmark pixels, {int((img == 0.7).sum())} trajectory "
        f"pixels; from the records as tensors on the card: equal {same}")
    assert img.shape == (512, 512) and img.max() == 1.0 and same


def second_session(card, name, dd, path, data):
    """Phase 11, one second session: load the map, drive the circle from
    MULTI_SESSION["start_s"] on, check the relocalisation."""
    from okvis2_torch.core import se3_np
    from okvis2_torch.ops.harris_cuda import harris_nms_cuda
    from okvis2_torch.utils.timing import Timing

    d = dict(LOOP_DRIVES[MULTI_SESSION["session"]], frames=20, render_frames=40,
             start_s=MULTI_SESSION["start_s"])
    run = slam_drive(name, d, pipelined=dd["pipelined"])
    slam, est, tag = run.slam, run.est, run.tag
    n_loaded = slam.load_map(path)
    table = slam.frontend.table
    n_desc = len(slam.frontend.lm_descriptors)
    file_lid = list(data["landmarks"])  # loaded in the file's order, ids from 0
    words = {o["lid"]: o["descriptor"] for o in data["observations"] if "descriptor" in o}
    signs = table.signs[:, 0].cpu().numpy()
    for lid, s in table.slot_of.items():
        bits = (words[file_lid[lid]][:, None] >> np.arange(32, dtype=np.uint32)) & 1
        assert np.array_equal(signs[s] > 0, bits.reshape(-1) > 0), lid
    assert len(table.slot_of) >= n_desc == len(words), (len(table.slot_of), n_desc, len(words))
    assert slam.loop_backend.has_components()
    log(f"{tag} loaded {n_loaded} landmarks, {n_desc} with descriptors, in {len(table.slot_of)} "
        f"table slots whose device signs equal the file's bits")
    relocs, apply_reloc, gt = [], slam._apply_relocalisation, []

    def recorded(est_, sid, frames, v):
        before = est_.states[sid].pose.copy()
        apply_reloc(est_, sid, frames, v)
        after = est_.states[sid].pose
        dq = se3_np.quat_mul(se3_np.quat_conj(before[3:7]), after[3:7])
        k = est_.state_order.index(sid)
        relocs.append({"keyframe": k, "d_pos_m": float(np.linalg.norm(after[:3] - before[:3])),
                       "d_rot_deg": float(np.degrees(np.linalg.norm(se3_np.log_so3(dq)))),
                       "error_after_m": float(np.linalg.norm(after[:3] - gt[k][1][:3])),
                       "inliers": int(v["num_inliers"]), "frame": len(gt) - 1})

    slam._apply_relocalisation = recorded
    kf_of = {}
    slam.set_optimised_graph_callback(
        lambda t, sid, pose, tr: kf_of.__setitem__(sid, bool(tr.is_keyframe)))
    frame_s, in_flight = [], []
    Timing.reset()
    try:
        torch.cuda.synchronize()
        harris_nms_cuda.launches = 0
        for _ in range(d["frames"]):
            gt.append(run.feed_frame())
            ta = time.perf_counter()
            slam.process_frame()
            torch.cuda.synchronize()
            frame_s.append(time.perf_counter() - ta)
            in_flight.append(len(slam._pending_frames))
        slam.finish()
        torch.cuda.synchronize()
        launches = harris_nms_cuda.launches
    finally:
        run.restore()
    traj = est.trajectory()
    err = [float(np.linalg.norm(p[:3] - g[1][:3])) for (_, p), g in zip(traj, gt)]
    assert len(traj) == d["frames"] and np.isfinite(err).all(), len(traj)
    keyframes = [r["keyframe"] for r in relocs]
    assert relocs, f"{name}: no relocalisation (last verification {slam.loop_backend.last_verify_info!r})"
    first = relocs[0]
    bar_first = 1.5 * dd["jax_first_error_m"] + 0.005
    rms = float(np.sqrt(np.mean(np.square(err[first["keyframe"]:]))))
    reloc = Timing.get("2.09 relocalisation")
    lag = {str(k): in_flight.count(k) for k in sorted(set(in_flight))}
    rec = json.dumps([{k: (round(v, 6) if isinstance(v, float) else v) for k, v in r.items()}
                      for r in relocs])
    log(f"{tag} relocalised on keyframes {keyframes} (the JAX run: {dd['jax_reloc_keyframes']}), "
        f"in the process_frame of frames {[r['frame'] for r in relocs]}: {rec}; the relocalised "
        f"pose {first['error_after_m']:.6f} m from the truth without alignment "
        f"(bar {bar_first:.6f}; JAX {dd['jax_first_error_m']:.6f}); the trajectory from it on "
        f"{rms:.6f} m RMS, last frame {err[-1]:.6f} m; frames in flight {json.dumps(lag)}; "
        f"'2.09 relocalisation' {reloc.n if reloc else 0} calls, "
        f"{(reloc.total / max(reloc.n, 1) * 1e3) if reloc else 0.0:.3f} ms each; keyframes at "
        f"frames {[est.state_order.index(s) for s, k in kf_of.items() if k]}; landmarks "
        f"{len(est.landmarks)}; harris_nms launches {launches}")
    log(f"{tag} process_frame of the relocalising frame {first['frame']}: "
        f"{frame_s[first['frame']] * 1e3:.3f} ms (median of the drive "
        f"{statistics.median(frame_s) * 1e3:.3f} ms), correction {first['d_pos_m']:.6f} m, "
        f"{first['d_rot_deg']:.4f} deg ({card})")
    assert abs(keyframes[0] - dd["jax_reloc_keyframes"][0]) <= dd["keyframe_slack"], keyframes
    assert first["error_after_m"] < bar_first, first
    if dd["jax_rms_from_first_m"] is not None:
        bar_rms = 1.5 * dd["jax_rms_from_first_m"] + 0.005
        assert rms < bar_rms, f"{name}: {rms:.6f} m RMS from the relocalisation on, bar {bar_rms}"
        assert keyframes == dd["jax_reloc_keyframes"], keyframes
    n_oct = run.fe_cfg.detection.octaves
    assert launches == d["frames"] * n_oct, launches
    return {"harris_nms": launches}


def check_two_pose(tag, factors):
    """Each two-pose factor the card made, against the same function on the
    CPU on the same inputs."""
    from okvis2_torch.factors.two_pose import compute_two_pose_factor

    cams32, _, _ = tracking_rig("cpu")
    info = lambda s: s.double().T @ s.double()  # noqa: E731
    rel = lambda a, b: float(torch.linalg.norm(a - b) / torch.linalg.norm(b))  # noqa: E731
    gen = torch.Generator().manual_seed(0)
    worst_t = worst_i = worst_r = 0.0
    for args, got in factors:
        ref = compute_two_pose_factor(*args, cams32)
        d_t = float((got["T_ij"].double() - ref["T_ij"]).abs().max())
        d_i = rel(info(got["sqrt_info"]), info(ref["sqrt_info"]))
        hp = args[3].double()
        moved = compute_two_pose_factor(
            *args[:3], hp * (1 + 1e-15 * torch.randn(hp.shape, generator=gen, dtype=hp.dtype)),
            *args[4:], cams32)
        bar = max(TWO_POSE_INFO_FLOOR,
                  TWO_POSE_INFO_TIMES * rel(info(moved["sqrt_info"]), info(ref["sqrt_info"])))
        worst_t, worst_i, worst_r = max(worst_t, d_t), max(worst_i, d_i), max(worst_r, d_i / bar)
        assert d_t < TWO_POSE_T_TOL and d_i < bar, (
            f"two-pose factor: T_ij off by {d_t:.3e}, information by {d_i:.3e} (relative; "
            f"bar {bar:.3e})")
    log(f"{tag} {len(factors)} two-pose factors against the CPU: T_ij within "
        f"{worst_t:.3e} (bar {TWO_POSE_T_TOL:g}), information within {worst_i:.3e} of its norm, "
        f"at most {worst_r:.3f} of its bar ({TWO_POSE_INFO_TIMES:g}x the CPU factor's change "
        f"when its landmarks move by 1e-15, at least {TWO_POSE_INFO_FLOOR:g})")


def time_stages(stages):
    """{name: ms of one call}, each stage alone and synchronised: one
    warm-up call, then the mean of 10."""
    split = {}
    for name, fn in stages.items():
        fn()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(10):
            fn()
        torch.cuda.synchronize()
        split[name] = (time.perf_counter() - t) / 10 * 1e3
    return split


def profile_frame(frame):
    """One frame under torch.profiler, device activity only (see
    ``profile_kernels``; tracing host ops also stretched the frame's wall
    time, and so its idle share): device kernels launched, device-busy
    time against the frame's wall time, the top kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        frame()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kern = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kern)
    if not kern or busy_us <= 0:
        log("[profile] device time: not measured (the profiler saw no device kernels)")
        return
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:6]
    log(f"[profile] one frame: {sum(e.count for e in kern)} device kernels, device busy "
        f"{busy_us / 1e3:.3f} ms of {wall_us / 1e3:.3f} ms wall (idle share "
        f"{1 - busy_us / wall_us:.4f})")
    log("[profile] top kernels (us): " + json.dumps(
        {e.key[:60]: round(e.self_device_time_total, 1) for e in top}))


def phase_cnn(card, name):
    """Phase 12, one drive (CNN_DRIVES[name]): the textured world through
    SlamSystem with CNN suppression; returns the kernels' launch counts
    over its frames."""
    from okvis2_torch.core.se3 import Transformation
    from okvis2_torch.frontend import DetectionConfig
    from okvis2_torch.graph.estimator import EstimatorConfig
    from okvis2_torch.models.fast_scnn import PERSON_CLASS, SKY_CLASS, image_logits
    from okvis2_torch.models.suppression import CnnSuppressor
    from okvis2_torch.ops.harris_cuda import harris_nms_cuda
    from okvis2_torch.pipeline.dataset import TexturedWorldDataset
    from okvis2_torch.pipeline.frontend_pipeline import FrontendConfig
    from okvis2_torch.pipeline.slam import SlamSystem
    from okvis2_torch.pipeline.trajectory import ate_rmse
    from okvis2_torch.utils.timing import Timing

    d, tag = CNN_DRIVES[name], f"[{name}]"
    cams, T_SC, imu = tracking_rig(DEVICE)
    exts = [Transformation(r=torch.tensor(T[:3], dtype=torch.float32, device=DEVICE),
                           q=torch.tensor(T[3:], dtype=torch.float32, device=DEVICE))
            for T in T_SC]
    t0 = time.perf_counter()
    ds = TexturedWorldDataset(cams, exts, imu, duration=CNN_FRAMES / CNN_RATE,
                              frame_rate=CNN_RATE, imu_rate=200.0, seed=0, trajectory="default",
                              device=DEVICE)
    labels, render_labelled = [], ds.render_with_labels

    def render(T_WS):  # the stream's frames, with their class maps kept
        pairs = render_labelled(T_WS)
        labels.append([lab for _, lab in pairs])
        return [im for im, _ in pairs]

    ds.render = render
    events = list(ds.stream())
    log(f"{tag} rendered {len(labels)} {W}x{H} stereo frames of the textured world on the card "
        f"in {time.perf_counter() - t0:.2f} s")
    est_cfg = EstimatorConfig(window_slots=12, landmark_slots=512, obs_slots=4096,
                              imu_seg_capacity=64, enforce_realtime=True,
                              realtime_time_limit=1.0 / 200.0, num_keyframes=5)
    fe_cfg = FrontendConfig(detection=DetectionConfig(max_keypoints=N_KP),
                            map_match_capacity=TRACK_CAP)
    slam = SlamSystem(cams, exts, imu, est_cfg, fe_cfg, pipelined=d["pipelined"], device=DEVICE,
                      cnn_params=CNN_WEIGHTS)
    slam._force_min_pending = 1 if d["pipelined"] else 0  # the JAX run's schedule
    est = slam.estimator
    kf_of, records, suppress = {}, [], slam.cnn.suppress
    slam.set_optimised_graph_callback(
        lambda t, sid, pose, tr: kf_of.__setitem__(sid, bool(tr.is_keyframe)))

    def recorded(est_, frames, sid, images):
        ta = time.perf_counter()
        n = suppress(est_, frames, sid, images)  # ends in the classes' fetch
        records.append((sid, n, (time.perf_counter() - ta) * 1e3, images))
        return n

    slam.cnn.suppress = recorded
    gt, frame_s, in_flight = [], [], []
    Timing.reset()
    torch.cuda.synchronize()
    harris_nms_cuda.launches = 0
    for ev in events:
        if ev[0] == "imu":
            slam.add_imu_measurement(ev[1], ev[2], ev[3])
            continue
        gt.append((ev[1], ev[3]))
        slam.add_images(ev[1], ev[2])
        ta = time.perf_counter()
        slam.process_frame()
        if not d["pipelined"]:
            torch.cuda.synchronize()
        frame_s.append(time.perf_counter() - ta)
        in_flight.append(len(slam._pending_frames))
    slam.finish()
    torch.cuda.synchronize()
    launches = harris_nms_cuda.launches
    ate = ate_rmse(est.trajectory(), gt, align=True)
    frame_of = est.state_order.index
    keyframes = [frame_of(s) for s in est.state_order if kf_of.get(s)]
    suppressed = [[frame_of(sid), n] for sid, n, _, _ in records]
    stage = Timing.get("2.07 cnn suppression")
    steady = frame_s[CNN_WARMUP:]
    bar = 1.5 * d["jax_ate_m"] + 0.005
    log(f"{tag} {CNN_FRAMES} frames: ATE {ate:.6f} m (bar {bar:.6f} m; the JAX package "
        f"{d['jax_ate_m']:.6f} m), keyframes at frames {keyframes} (JAX {d['jax_keyframes']}), "
        f"landmarks suppressed per keyframe {suppressed} (JAX {d['jax_suppressed']}), "
        f"{slam.cnn.num_suppressed} in all, landmarks {len(est.landmarks)}; frames in flight "
        f"after each dispatch {json.dumps({str(k): in_flight.count(k) for k in set(in_flight)})}")
    log(f"{tag} process_frame {len(steady) / sum(steady):.3f} frames/s over frames "
        f"{CNN_WARMUP + 1}-{CNN_FRAMES} (median {statistics.median(steady) * 1e3:.3f} ms), "
        f"\"2.07 cnn suppression\" {stage.total / stage.n * 1e3:.3f} ms per keyframe over "
        f"{stage.n} keyframes (each: {[round(r[2], 3) for r in records]} ms; the first builds "
        f"the convolutions' plans), harris_nms launches {launches} ({card})")
    assert np.isfinite(np.stack([p for _, p in est.trajectory()])).all()
    assert ate < bar, f"{name}: ATE {ate:.6f} m against a bar of {bar:.6f} m"
    assert launches == CNN_FRAMES * fe_cfg.detection.octaves, launches
    assert stage.n == len(records) >= 1 and slam.cnn.num_suppressed >= 1
    if d["pipelined"]:
        return {"harris_nms": launches}
    assert keyframes == d["jax_keyframes"], keyframes
    assert [k for k, _ in suppressed] == [k for k, _ in d["jax_suppressed"]], suppressed
    for (_, n), (_, n_jax) in zip(suppressed, d["jax_suppressed"]):
        assert abs(n - n_jax) <= max(2, 0.05 * n_jax), (suppressed, d["jax_suppressed"])

    # the keyframes' class maps: the card against the CPU port, and against
    # the renderer's labels
    model, host = slam.cnn.model(), CnnSuppressor(CNN_WEIGHTS, device="cpu").model()
    worst_agree, worst_logit = 1.0, 0.0
    hits = {SKY_CLASS: [0, 0], PERSON_CLASS: [0, 0]}
    for sid, _, _, images in records:
        for img, lab in zip(images, labels[frame_of(sid)]):
            x = torch.from_numpy(np.asarray(img))
            got = image_logits(model, x.to(DEVICE)).cpu()
            want = image_logits(host, x)
            seg = got.argmax(0).numpy()
            worst_agree = min(worst_agree, float((seg == want.argmax(0).numpy()).mean()))
            worst_logit = max(worst_logit, float((got - want).abs().max() / want.abs().max()))
            for c, h in hits.items():
                h[0] += int((seg[lab == c] == c).sum())
                h[1] += int((lab == c).sum())
    acc = {"sky": hits[SKY_CLASS][0] / hits[SKY_CLASS][1],
           "person": hits[PERSON_CLASS][0] / hits[PERSON_CLASS][1]}
    x = torch.as_tensor(np.asarray(records[0][3][0]), device=DEVICE)
    net_ms = cuda_ms(lambda: image_logits(model, x))
    log(f"{tag} class maps of the {2 * len(records)} keyframe images, card against the CPU "
        f"port: at least {worst_agree:.6f} of the pixels equal (bar {CNN_CLASS_AGREE}), logits "
        f"within {worst_logit:.3e} of their largest magnitude (bar {CNN_LOGIT_TOL:g}); pixel "
        f"accuracy against render_with_labels: sky {acc['sky']:.4f}, person {acc['person']:.4f} "
        f"(the JAX package {d['jax_accuracy']['sky']:.4f}, {d['jax_accuracy']['person']:.4f}); "
        f"the network {net_ms:.3f} ms per 768x512 image (CUDA events, warm L2) ({card})")
    assert worst_agree >= CNN_CLASS_AGREE and worst_logit <= CNN_LOGIT_TOL, (worst_agree,
                                                                             worst_logit)
    for k, a in acc.items():
        assert a >= d["jax_accuracy"][k] - CNN_ACC_SLACK, (k, a)
    return {"harris_nms": launches}


def phase_sharded_final_ba(card, pack):
    """Phase 13 on phase 11's final-BA pack (``pack``, from
    ``phase_multi_session``): the landmark-sharded solve at world sizes 1
    (NCCL, this process) and 2 (gloo, two spawned ranks on this card)."""
    import datetime
    import tempfile

    import torch.distributed as dist

    from okvis2_torch.parallel import dryrun
    from okvis2_torch.parallel import make_mesh, shard_problem_by_landmark
    from okvis2_torch.parallel import solve_full_graph_sharded
    from okvis2_torch.solver.window_problem import SolverConfig

    tag, f64, it64 = "[sharded final BA]", torch.float64, QUEUED_FG_F64_ITERATIONS
    n_s, n_l = pack["states"], pack["landmarks"]
    cams64 = tuple(c.to(device="cpu", dtype=f64) for c in pack["cams"])
    imu64 = pack["imu"].to(device="cpu", dtype=f64)
    unit = lambda hp: hp / np.linalg.norm(hp, axis=-1, keepdims=True)  # noqa: E731

    def gaps(pose, lms, ref_pose, ref_lms):
        return (float(np.abs(pose[:n_s, :3] - ref_pose[:n_s, :3]).max()),
                float(np.abs(unit(lms[:n_l]) - unit(ref_lms[:n_l])).max()))

    ref_pose, ref_lms, ref_it, ref_ms = pack["ref64"]
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        torch.cuda.set_device(0)
        dist.init_process_group("nccl", init_method=f"file://{tmp}/rendezvous", world_size=1,
                                rank=0, timeout=datetime.timedelta(seconds=60))
        try:
            mesh = make_mesh(1)
            for dtype, iters in ((f64, it64), (torch.float32, FBA_ITERATIONS)):
                prob = pack["p64"] if dtype == f64 else pack["prob"]
                cams = cams64 if dtype == f64 else pack["cams"]
                imu = imu64 if dtype == f64 else pack["imu"]
                sharded = shard_problem_by_landmark(prob, 1)

                def solve():
                    return solve_full_graph_sharded(sharded, cams, imu, mesh, SolverConfig(),
                                                    iters)

                # the float64 solve once under the profiler first, which also
                # warms its new shapes, as the spawned ranks' first solve
                # does (the float32 solve's kernels are phase 11's 130.6k)
                kernels = profile_kernels(lambda: solve()[0].pose.cpu()) if dtype == f64 else None
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                solved, st = solve()
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3
                runs[dtype] = (solved.pose.cpu().numpy(), solved.landmarks.cpu().numpy(), st, ms,
                               kernels)
        finally:
            dist.destroy_process_group()
        path = f"{tmp}/pack64.npz"
        dryrun.save_pack(path, pack["p64"], cams64, imu64)
        ranks = dryrun.run_spmd(dryrun.solve_saved_pack, 2,
                                args=(path, it64, SolverConfig(), True),
                                backend="gloo", device="cuda", init_dir=tmp)
    sh2 = shard_problem_by_landmark(pack["p64"], 2)
    per = [(int(sh2.lm_mask[k * sh2.L // 2:(k + 1) * sh2.L // 2].sum()),
            int(sh2.obs_mask[k * sh2.O // 2:(k + 1) * sh2.O // 2].sum())) for k in range(2)]
    p1, l1, st1, ms1, k1 = runs[f64]
    p32, l32, st32, ms32, _ = runs[torch.float32]
    d1 = gaps(p1, l1, ref_pose, ref_lms)
    d2 = gaps(ranks[0]["pose"], ranks[0]["landmarks"], ref_pose, ref_lms)
    d12 = gaps(ranks[0]["pose"], ranks[0]["landmarks"], p1, l1)
    d32 = float(np.abs(p32[:n_s, :3] - pack["pose32"][:n_s, :3]).max())
    per_it = lambda st: (st["collectives"] - 2) / st["iterations"]  # noqa: E731
    log(f"{tag} float64, {it64} LM iterations: world size 1 (NCCL) {ms1:.3f} ms, {k1} device "
        f"kernels, {st1['iterations']} iterations, {per_it(st1):g} collectives per LM iteration "
        f"(3 all-reduces, 1 broadcast; 1 all-reduce before, 1 after); world size 2 (gloo, one "
        f"card) {ranks[0]['ms']:.3f} / {ranks[1]['ms']:.3f} ms per rank, "
        f"{ranks[0]['kernels']} / {ranks[1]['kernels']} device kernels per rank, "
        f"{ranks[0]['iterations']} iterations, {(ranks[0]['collectives'] - 2) / ranks[0]['iterations']:g} "
        f"collectives per LM iteration; unsharded (phase 11) {ref_ms:.3f} ms, {ref_it} iterations")
    log(f"{tag} shards at world size 2: S/L/O {sh2.S}/{sh2.L // 2}/{sh2.O // 2} per rank, used "
        f"landmarks / observations {per}; against the unsharded solve (poses m, landmarks as unit "
        f"homogeneous vectors): world size 1 {d1[0]:.3e} {d1[1]:.3e}, world size 2 {d2[0]:.3e} "
        f"{d2[1]:.3e}, world size 2 against 1 {d12[0]:.3e} {d12[1]:.3e} (bars {FBA_F64_TOL_M:g}, "
        f"{FBA_F64_TOL_HP:g})")
    log(f"{tag} float32, {FBA_ITERATIONS} LM iterations, world size 1: {ms32:.3f} ms, "
        f"{st32['iterations']} iterations, {per_it(st32):g} collectives per LM iteration; poses "
        f"within {d32:.3e} m of phase 11's unsharded float32 solve ({card})")
    assert st1["iterations"] == ref_it == ranks[0]["iterations"] == ranks[1]["iterations"]
    for d in (d1, d2, d12):
        assert d[0] < FBA_F64_TOL_M and d[1] < FBA_F64_TOL_HP, (d1, d2, d12)
    for k in ("pose", "landmarks"):
        assert np.array_equal(ranks[0][k], ranks[1][k]), k
    assert np.isfinite(p32).all() and np.isfinite(l32).all()


@contextlib.contextmanager
def recorded_app_system(slam_mod, est_mod, sync=lambda: None, min_pending=None):
    """While open, ``slam_mod.SlamSystem`` (the port's, or the JAX package's
    in tools/e2e_reference_jax.py) is a subclass that records its keyframes
    (by state id), the frames in flight after and the host seconds of each
    ``process_frame`` (``frame_s``), the final BA's info and ms (``sync``
    waits for the device around it), and the capacity truncations
    (``est_mod._warn_counts``) of the run;
    ``min_pending`` sets the pipelined loop's ``_force_min_pending``."""
    base = slam_mod.SlamSystem
    rec = {"systems": [], "kf_sids": [], "in_flight": [], "frame_s": [], "final_ba": None,
           "final_ba_ms": None}

    class Recorded(base):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            if min_pending is not None:
                self._force_min_pending = min_pending
            self.set_optimised_graph_callback(
                lambda t, sid, pose, tr: rec["kf_sids"].append(sid) if tr.is_keyframe else None)
            rec["systems"].append(self)

        def process_frame(self):
            t0 = time.perf_counter()
            out = super().process_frame()
            rec["frame_s"].append(time.perf_counter() - t0)
            rec["in_flight"].append(len(self._pending_frames))
            return out

        def do_final_ba(self, *a, **kw):
            sync()
            t0 = time.perf_counter()
            rec["final_ba"] = super().do_final_ba(*a, **kw)
            sync()
            rec["final_ba_ms"] = (time.perf_counter() - t0) * 1e3
            return rec["final_ba"]

    warn0 = dict(est_mod._warn_counts)
    slam_mod.SlamSystem = Recorded
    try:
        yield rec
    finally:
        slam_mod.SlamSystem = base
        rec["truncations"] = {k: v - warn0.get(k, 0) for k, v in est_mod._warn_counts.items()
                              if v != warn0.get(k, 0)}


def write_app_folder(folder, n_frames=APP_FRAMES, period=APP_PERIOD):
    """A phase-14 EuRoC folder (see APP_CONFIG): the first ``n_frames``
    frames of a circle of ``period`` s (None: of the default trajectory),
    rendered on the host in float64 so that every machine writes the same
    pixels (``app_folder_digest``). Returns the ground truth [(t, pose7)],
    the uint8 images given to the writer and the IMU samples [(t, acc,
    gyr)]."""
    from okvis2_torch.config import read_config_file
    from okvis2_torch.pipeline.dataset import DatasetWriter, SyntheticDataset

    params = read_config_file(APP_CONFIG, dtype=torch.float64, device="cpu")
    ds = SyntheticDataset(params.camera_tuple, params.extrinsics_list, params.imu.params,
                          n_stars=2500, duration=period or n_frames / APP_RATE,
                          frame_rate=APP_RATE, imu_rate=200.0, seed=0,
                          trajectory="default" if period is None else "circle", device="cpu")
    writer = DatasetWriter(folder, num_cameras=2)
    gt, images, imu = [], [], []
    for ev in ds.stream():
        if ev[0] == "imu":
            writer.add_imu_measurement(ev[1], ev[2], ev[3])
            imu.append((ev[1], np.asarray(ev[2]), np.asarray(ev[3])))
            continue
        u8 = [(np.clip(im, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8) for im in ev[2]]
        writer.add_images(ev[1], u8)
        gt.append((ev[1], ev[3]))
        images.append(u8)
        if len(images) == n_frames:
            break
    writer.close()
    return gt, images, imu


def app_folder_digest(folder):
    """SHA-256 over the folder's files in path order: each PNG's decoded
    pixels (its compressed bytes depend on the zlib build), every other
    file's bytes."""
    import hashlib

    from okvis2_torch.pipeline import png

    h = hashlib.sha256()
    paths = sorted(os.path.relpath(os.path.join(d, f), folder)
                   for d, _, fs in os.walk(folder) for f in fs)
    for rel in paths:
        path = os.path.join(folder, rel)
        h.update(rel.encode())
        if rel.endswith(".png"):
            h.update(png.read_png(path).tobytes())
        else:
            with open(path, "rb") as f:
                h.update(f.read())
    return h.hexdigest()


def check_round_trip(folder, images, imu, tol):
    """Every image the EuRoC reader gives back equals, bit for bit, the
    uint8 image the writer was given (as float32 / 255), and the IMU rows
    agree to the CSV's 9 decimals. Returns the PNG decode ms per image
    pair."""
    from okvis2_torch.pipeline import png
    from okvis2_torch.pipeline.dataset import EurocDatasetReader

    events = list(EurocDatasetReader(folder, 2).stream(tol))
    frames = [e for e in events if e[0] == "images"]
    samples = [e for e in events if e[0] == "imu"]
    assert len(frames) == len(images) == APP_FRAMES, (len(frames), len(images))
    assert len(samples) == len(imu), (len(samples), len(imu))
    for (_, _, got), want in zip(frames, images):
        for g, w in zip(got, want):
            assert g.dtype == np.float32 and np.array_equal(g, w.astype(np.float32) / 255.0)
    d_t = max(abs(a[1] - b[0]) for a, b in zip(samples, imu))
    d_v = max(float(np.abs(np.concatenate([a[2] - b[1], a[3] - b[2]])).max())
              for a, b in zip(samples, imu))
    assert d_t < 1e-9 and d_v <= 5e-10 * (1 + 1e-6), (d_t, d_v)
    files = [[os.path.join(folder, "mav0", f"cam{c}", "data", n) for c in range(2)]
             for n in sorted(os.listdir(os.path.join(folder, "mav0", "cam0", "data")),
                             key=lambda n: int(n.split(".")[0]))]
    t0 = time.perf_counter()
    decoded = [[png.read_png(f) for f in pair] for pair in files]
    decode_ms = (time.perf_counter() - t0) * 1e3 / len(files)
    assert all(np.array_equal(d, w) for pair, want in zip(decoded, images)
               for d, w in zip(pair, want))
    log(f"[app] round trip: {len(frames)} image pairs bit for bit, {len(samples)} IMU rows "
        f"within {d_v:.1e} (the CSV's 9 decimals), timestamps within {d_t:.1e} s; PNG decode "
        f"{decode_ms:.3f} ms per 752x480 pair (host)")
    return decode_ms


def app_csv_ate(path, gt):
    """The trajectory CSV's rows and their aligned ATE against ``gt``."""
    from okvis2_torch.pipeline.trajectory import ate_rmse

    rows = np.loadtxt(path, delimiter=",", skiprows=1, ndmin=2)
    est = [(r[0] * 1e-9, np.concatenate([r[1:4], r[5:8], r[4:5]])) for r in rows]
    return len(rows), ate_rmse(est, gt, align=True)


def phase_app(card):
    """Phase 14: the dataset app on the card at configs/euroc.yaml (see
    APP_CONFIG): the two folders (their digests the JAX app's) and the
    circle folder's round trip, the synchronous app on the circle with the
    final BA and the map (checked against the JAX app on the same folder,
    and the map loaded into a fresh system), then the default pipelined app
    on APP_PIPELINED_FRAMES frames of the default trajectory. Returns the
    kernels' launch counts over each app run and the synchronous app's
    trajectory CSV rows."""
    import shutil
    import tempfile

    from okvis2_torch.apps import app_synchronous
    from okvis2_torch.config import read_config_file
    from okvis2_torch.graph import estimator as est_mod
    from okvis2_torch.ops.harris_cuda import harris_nms_cuda
    from okvis2_torch.pipeline import slam as slam_mod
    from okvis2_torch.pipeline.component_io import load_component
    from okvis2_torch.pipeline.slam import SlamSystem
    from okvis2_torch.utils.timing import Timing

    root = tempfile.mkdtemp(prefix="okvis2_app_")
    launches = {}
    try:
        params = read_config_file(APP_CONFIG, device=DEVICE)
        folders, truth = {}, {}
        for name, period in (("sync", APP_PERIOD), ("pipelined", None)):
            folders[name] = os.path.join(root, f"euroc_{name}")
            t0 = time.perf_counter()
            truth[name], images, imu = write_app_folder(folders[name], APP_FRAMES, period)
            digest = app_folder_digest(folders[name])
            path = f"a {period:g} s circle" if period else "the default trajectory"
            log(f"[app {name}] wrote {len(truth[name])} frames ({W}x{H} stereo, "
                f"configs/euroc.yaml's rig, {path}) and {len(imu)} IMU rows in {time.perf_counter() - t0:.2f} s; folder digest "
                f"{digest} (the JAX app's folder: {APP_JAX[name]['folder_digest']})")
            assert digest == APP_JAX[name]["folder_digest"], f"{name}: not the JAX app's folder"
            if name == "sync":
                decode_ms = check_round_trip(folders[name], images, imu,
                                             params.camera_rig.timestamp_tolerance)

        for name in ("sync", "pipelined"):
            tag, jax, folder, gt = f"[app {name}]", APP_JAX[name], folders[name], truth[name]
            out = os.path.join(root, name)
            argv = [APP_CONFIG, folder, "--output-dir", out]
            if name == "sync":
                map_path = os.path.join(root, "session.map")
                argv += ["--sync", "--final-ba", "--save-map", map_path]
            else:
                argv += ["--max-frames", str(APP_PIPELINED_FRAMES)]
            n_frames = APP_FRAMES if name == "sync" else APP_PIPELINED_FRAMES
            with recorded_app_system(slam_mod, est_mod, sync=torch.cuda.synchronize) as rec:
                torch.cuda.synchronize()
                harris_nms_cuda.launches = 0
                Timing.reset()
                t0 = time.perf_counter()
                res = app_synchronous.main(argv, device=DEVICE)
                torch.cuda.synchronize()
                wall_s = time.perf_counter() - t0
                launches[f"app {name}"] = {"harris_nms": harris_nms_cuda.launches}
            slam = res["slam"]
            est = slam.estimator
            assert rec["systems"] == [slam] and slam.pipelined == (name == "pipelined")
            rows, ate = app_csv_ate(res["output"], gt[:n_frames])
            kf = [est.state_order.index(s) for s in rec["kf_sids"]]
            n_oct = slam.frontend.cfg.detection.octaves
            steady = res["frame_s"][APP_WARMUP:]
            bar = 1.5 * jax["ate_m"] + 0.005
            if name == "pipelined" and jax["ate_m"] <= 0.10:
                bar = min(bar, 0.10)
            lag = {str(k): rec["in_flight"].count(k) for k in sorted(set(rec["in_flight"]))}
            lb = slam.loop_backend
            log(f"{tag} {res['frames']} frames in {wall_s:.2f} s: process_frame "
                f"{len(steady) / sum(steady):.3f} frames/s over frames {APP_WARMUP + 1}-"
                f"{res['frames']} (median {statistics.median(steady) * 1e3:.3f} ms; first "
                f"{res['frame_s'][0] * 1e3:.1f} ms{'; it does not wait for the card' if name == 'pipelined' else ''}), "
                f"harris_nms launches {harris_nms_cuda.launches} ({res['frames']} frames x "
                f"{n_oct} octave) ({card})")
            log(f"{tag} CSV rows {rows} (states {len(est.state_order)}), ATE {ate:.6f} m (bar "
                f"{bar:.6f}; the JAX app on the same folder {jax['ate_m']:.6f}), keyframes at "
                f"frames {kf} (JAX {jax['keyframes']}), landmarks {len(est.landmarks)}, loop "
                f"closures {lb.num_loop_closures}, capacity truncations "
                f"{json.dumps(rec['truncations'])}, frames in flight after each dispatch (lag "
                f"histogram) {json.dumps(lag)}")
            log_split(tag + " (all frames)", APP_STAGES[name], res["frames"])
            assert res["frames"] == n_frames and rows == n_frames == len(est.state_order), rows
            assert ate < bar, f"app {name}: ATE {ate:.6f} m against a bar of {bar:.6f} m"
            assert launches[f"app {name}"]["harris_nms"] == n_frames * n_oct, launches
            if name == "sync":
                app_rows = np.loadtxt(res["output"], delimiter=",", skiprows=1, ndmin=2)
                assert kf == jax["keyframes"], (kf, jax["keyframes"])
                info = rec["final_ba"]
                log(f"{tag} final BA {rec['final_ba_ms']:.3f} ms: {info['states']} states "
                    f"(JAX {jax['final_ba_states']}), {info['landmarks']} landmarks, "
                    f"{info['restored_observations']} observations restored, reprojection RMS "
                    f"{info['reproj_rms_px']:.3f} px (bar {1.5 * jax['final_ba_rms_px']:.3f}: 1.5x "
                    f"the JAX app's) ({card})")
                assert info["states"] == jax["final_ba_states"], (info, jax)
                assert info["reproj_rms_px"] < 1.5 * jax["final_ba_rms_px"], (info, jax)
                data = load_component(map_path)
                fresh = SlamSystem(params.camera_tuple, params.extrinsics_list,
                                   params.imu.params, device=DEVICE)
                n_loaded = fresh.load_map(map_path)
                log(f"{tag} the map ({os.path.getsize(map_path)} bytes) loads into a fresh "
                    f"SlamSystem: {n_loaded} landmarks (the session's {len(est.landmarks)})")
                assert n_loaded == len(data["landmarks"]) == len(est.landmarks), n_loaded
            else:
                share = float(np.mean([n == APP_IN_FLIGHT for n in rec["in_flight"][2:]]))
                assert share >= MIN_SCHEDULE_SHARE, (
                    f"app pipelined: {share:.3f} of the frames ran with {APP_IN_FLIGHT} in "
                    f"flight: {rec['in_flight']}")
        log(f"[app] PNG decode {decode_ms:.3f} ms per image pair ({card})")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return launches, app_rows


# Phase 15: the ROS2 bag replay, okvis2_torch.ros2.nodes.main_synchronous
# (the reference's okvis_node_synchronous, the way ROS users run OKVIS2 on
# a recorded dataset), at configs/euroc.yaml on phase 14's synchronous
# folder (the APP_PERIOD s circle) written as rosbag2 bags by write_rosbag:
# sqlite3 (.db3), and mcap with the messages in one uncompressed Chunk. The
# node maps the config as the JAX node does (without the realtime budget's
# fields and without a LoopClosureConfig; at euroc.yaml those fields are
# the EstimatorConfig defaults anyway) and replays the first BAG_FRAMES
# frames of the .db3 bag: 13, through the second keyframe (20 until the
# phases' time grew with phases 16-17). The JAX node on the same bag
# (tools/e2e_reference_jax.py bag 13, CPU, float32): "processed 13 frames,
# 812 landmarks", keyframes at frames 0 and 12, the estimator's 13 states
# at an aligned ATE of 44.420 mm, no loop closure; truncated: the window's
# landmarks once, frame-to-frame rows once (at 20 frames: 906 landmarks,
# keyframes 0 and 12, 24.611 mm). Held: the streams, the printed line, the
# keyframes, the landmarks within max(3, 1 %) of the JAX node's, the ATE at
# phase 8's rule, one Harris launch per frame per octave.
BAG_FRAMES = 13
BAG_IMU_TOPIC = "/okvis/imu"
BAG_IMAGE_TOPICS = ("/okvis/cam0/image_raw", "/okvis/cam1/image_raw")
BAG_JAX = dict(ate_m=0.04441952167387646, keyframes=[0, 12], landmarks=812)


class CdrWriter:
    """Little-endian XCDR1 (ROS2's default encoding) with the alignment
    that ``rosbag_reader.CdrReader`` reads: each primitive aligned to its
    size from the start of the payload."""

    def __init__(self):
        self.buf = bytearray(b"\x00\x01\x00\x00")  # CDR_LE encapsulation

    def put(self, fmt, v):
        import struct

        size = struct.calcsize(fmt)
        self.buf += b"\x00" * ((-(len(self.buf) - 4)) % size)
        self.buf += struct.pack("<" + fmt, v)

    def string(self, s):
        b = s.encode() + b"\x00"
        self.put("I", len(b))
        self.buf += b

    def header(self, ns, frame_id):
        """std_msgs/Header from integer nanoseconds."""
        self.put("i", ns // 10**9)
        self.put("I", ns % 10**9)
        self.string(frame_id)


def cdr_imu(ns, acc, gyr):
    """sensor_msgs/msg/Imu: header, orientation (unknown: identity, zero
    covariances), angular velocity, linear acceleration."""
    w = CdrWriter()
    w.header(ns, "imu")
    for v in [0.0, 0.0, 0.0, 1.0] + [0.0] * 9 + list(gyr) + [0.0] * 9 + list(acc) + [0.0] * 9:
        w.put("d", float(v))
    return bytes(w.buf)


def cdr_image(ns, img, frame_id):
    """sensor_msgs/msg/Image, mono8, from a uint8 [H,W] image."""
    w = CdrWriter()
    w.header(ns, frame_id)
    w.put("I", img.shape[0])
    w.put("I", img.shape[1])
    w.string("mono8")
    w.put("B", 0)
    w.put("I", img.shape[1])
    w.put("I", img.size)
    w.buf += np.ascontiguousarray(img, np.uint8).tobytes()
    return bytes(w.buf)


def write_rosbag(folder, path, storage):
    """A rosbag2 bag of an EuRoC folder (``write_app_folder``'s): the IMU on
    BAG_IMU_TOPIC as sensor_msgs/msg/Imu, each camera on BAG_IMAGE_TOPICS as
    sensor_msgs/msg/Image in mono8, header stamps from the folder's integer
    nanoseconds. ``storage`` "sqlite3" writes rosbag2's .db3 tables, "mcap"
    an mcap v1 file with every schema, channel and message record in one
    uncompressed Chunk. The messages go in the order EurocDatasetReader
    streams the folder (its 5 ms IMU look-ahead, in the same float
    arithmetic), each received at its stamp or 1 ns after the message
    before it, whichever is later, so that replay by receive time gives
    the reader's stream. Returns the number of messages."""
    import struct
    import zlib

    from okvis2_torch.pipeline import png

    with open(os.path.join(folder, "mav0", "imu0", "data.csv")) as f:
        imu = [(int(v[0]), [float(x) for x in v[4:7]], [float(x) for x in v[1:4]])
               for v in (ln.strip().split(",") for ln in f if not ln.startswith("#"))]
    cams = []
    for c in range(len(BAG_IMAGE_TOPICS)):
        with open(os.path.join(folder, "mav0", f"cam{c}", "data.csv")) as f:
            cams.append([(int(v[0]), os.path.join(folder, "mav0", f"cam{c}", "data", v[1].strip()))
                         for v in (ln.strip().split(",") for ln in f if not ln.startswith("#"))])
    assert all([r[0] for r in rows] == [r[0] for r in cams[0]] for rows in cams), "cameras unsynced"
    msgs, ii = [], 0  # (topic index, receive ns, payload)
    for k, (ns, _) in enumerate(cams[0]):
        while ii < len(imu) and imu[ii][0] * 1e-9 <= ns * 1e-9 + 0.005:
            msgs.append((0, imu[ii][0], cdr_imu(*imu[ii])))
            ii += 1
        for c in range(len(cams)):
            msgs.append((1 + c, ns, cdr_image(ns, png.read_png(cams[c][k][1]), f"cam{c}")))
    msgs += [(0, r[0], cdr_imu(*r)) for r in imu[ii:]]
    prev = -1
    for i, (ti, ns, data) in enumerate(msgs):
        prev = max(ns, prev + 1)
        msgs[i] = (ti, prev, data)
    topics = [(BAG_IMU_TOPIC, "sensor_msgs/msg/Imu")] + [
        (t, "sensor_msgs/msg/Image") for t in BAG_IMAGE_TOPICS]
    if os.path.exists(path):
        os.remove(path)
    if storage == "sqlite3":
        import sqlite3

        conn = sqlite3.connect(path)
        conn.execute("CREATE TABLE topics (id INTEGER PRIMARY KEY, name TEXT NOT NULL, type TEXT "
                     "NOT NULL, serialization_format TEXT NOT NULL, offered_qos_profiles TEXT "
                     "NOT NULL)")
        conn.execute("CREATE TABLE messages (id INTEGER PRIMARY KEY, topic_id INTEGER NOT NULL, "
                     "timestamp INTEGER NOT NULL, data BLOB NOT NULL)")
        conn.execute("CREATE INDEX timestamp_idx ON messages (timestamp ASC)")
        conn.executemany("INSERT INTO topics VALUES (?, ?, ?, 'cdr', '')",
                         [(i + 1, name, typ) for i, (name, typ) in enumerate(topics)])
        conn.executemany("INSERT INTO messages VALUES (?, ?, ?, ?)",
                         [(i + 1, ti + 1, ns, data) for i, (ti, ns, data) in enumerate(msgs)])
        conn.commit()
        conn.close()
        return len(msgs)
    assert storage == "mcap", storage
    from okvis2_torch.ros2.rosbag_reader import MCAP_MAGIC

    def record(op, body):
        return bytes([op]) + struct.pack("<Q", len(body)) + body

    def mstr(s):
        b = s.encode()
        return struct.pack("<I", len(b)) + b

    records = b"".join(
        record(0x03, struct.pack("<H", i + 1) + mstr(typ) + mstr("ros2msg") + struct.pack("<I", 0))
        + record(0x04, struct.pack("<HH", i + 1, i + 1) + mstr(name) + mstr("cdr")
                 + struct.pack("<I", 0))
        for i, (name, typ) in enumerate(topics))
    records += b"".join(record(0x05, struct.pack("<HIQQ", ti + 1, seq, ns, ns) + data)
                        for seq, (ti, ns, data) in enumerate(msgs))
    chunk = (struct.pack("<QQQI", msgs[0][1], msgs[-1][1], len(records), zlib.crc32(records))
             + mstr("") + struct.pack("<Q", len(records)) + records)
    with open(path, "wb") as f:
        f.write(MCAP_MAGIC)
        f.write(record(0x01, mstr("ros2") + mstr("okvis2_torch")))
        f.write(record(0x06, chunk))
        f.write(record(0x0F, struct.pack("<I", 0)))  # DataEnd
        f.write(record(0x02, struct.pack("<QQI", 0, 0, 0)))  # Footer
        f.write(MCAP_MAGIC)
    return len(msgs)


def check_bag_streams(folder, bags, tol):
    """Each bag's RosbagReader stream against EurocDatasetReader's stream
    of ``folder``: the same events in the same order, images bit for bit,
    times within 1e-9 s, IMU values within 5e-10 (phase 14's round-trip
    bar); the bags' streams equal to each other exactly. Returns the
    event counts and the largest time and IMU differences."""
    import itertools

    from okvis2_torch.pipeline.dataset import EurocDatasetReader
    from okvis2_torch.ros2.rosbag_reader import RosbagReader

    readers = [RosbagReader(b, list(BAG_IMAGE_TOPICS), BAG_IMU_TOPIC, tol) for b in bags]
    streams = [EurocDatasetReader(folder, len(BAG_IMAGE_TOPICS)).stream(tol)]
    streams += [r.stream() for r in readers]
    counts, d_t, d_v = {"imu": 0, "images": 0}, 0.0, 0.0
    for evs in itertools.zip_longest(*streams):
        assert None not in evs, f"the streams part after {counts}"
        ref, kind = evs[0], evs[0][0]
        assert all(e[0] == kind for e in evs), ([e[0] for e in evs], counts)
        counts[kind] += 1
        for e in evs[1:]:
            d_t = max(d_t, abs(e[1] - ref[1]))
            if kind == "imu":
                d_v = max(d_v, float(np.abs(np.concatenate([e[2] - ref[2], e[3] - ref[3]])).max()))
            else:
                assert len(e[2]) == len(ref[2]) and all(
                    g.dtype == w.dtype == np.float32 and np.array_equal(g, w)
                    for g, w in zip(e[2], ref[2])), counts
        for e in evs[2:]:
            assert e[1] == evs[1][1] and all(np.array_equal(a, b) for a, b in
                                             zip(e[2:], evs[1][2:])), counts
    for r in readers:
        r.close()
    assert d_t < 1e-9 and d_v <= 5e-10 * (1 + 1e-6), (d_t, d_v)
    return counts, d_t, d_v


def phase_bag(card, app_rows):
    """Phase 15: phase 14's synchronous folder written as .db3 and .mcap
    bags, their streams held to the folder's and to each other, then the
    node's bag replay on the card (``nodes.main_synchronous``, the first
    BAG_FRAMES frames of the .db3 bag) against the JAX node on the same bag
    (BAG_JAX): the printed frame count, keyframes, landmarks, ATE, one
    Harris launch per frame per octave; frames/s, the stage split and the
    gap to phase 14's app poses (``app_rows``) at the same stamps printed.
    Returns the kernels' launch counts over the replay."""
    import io
    import shutil
    import tempfile

    from okvis2_torch.config import read_config_file
    from okvis2_torch.graph import estimator as est_mod
    from okvis2_torch.ops.harris_cuda import harris_nms_cuda
    from okvis2_torch.pipeline import slam as slam_mod
    from okvis2_torch.pipeline.trajectory import ate_rmse
    from okvis2_torch.ros2 import nodes
    from okvis2_torch.utils.timing import Timing

    tag, jax = "[ros2 bag]", BAG_JAX
    root = tempfile.mkdtemp(prefix="okvis2_bag_")
    try:
        tol = read_config_file(APP_CONFIG, device="cpu").camera_rig.timestamp_tolerance
        folder = os.path.join(root, "euroc")
        t0 = time.perf_counter()
        gt, _, _ = write_app_folder(folder, APP_FRAMES, APP_PERIOD)
        digest = app_folder_digest(folder)
        assert digest == APP_JAX["sync"]["folder_digest"], "not phase 14's folder"
        bags, n_msgs = {}, {}
        for storage, ext in (("sqlite3", "db3"), ("mcap", "mcap")):
            bags[storage] = os.path.join(root, f"circle.{ext}")
            n_msgs[storage] = write_rosbag(folder, bags[storage], storage)
        log(f"{tag} phase 14's folder ({len(gt)} frames, a {APP_PERIOD:g} s circle) as bags: "
            + ", ".join(f"{s} {n_msgs[s]} messages {os.path.getsize(b)} bytes"
                        for s, b in bags.items())
            + f" ({time.perf_counter() - t0:.2f} s with the folder)")
        t0 = time.perf_counter()
        counts, d_t, d_v = check_bag_streams(folder, [bags["sqlite3"], bags["mcap"]], tol)
        log(f"{tag} the .db3 and .mcap streams equal each other and the EuRoC reader's: "
            f"{counts['images']} image pairs bit for bit, {counts['imu']} IMU samples within "
            f"{d_v:.1e}, times within {d_t:.1e} s ({time.perf_counter() - t0:.2f} s, host)")
        assert counts["images"] == APP_FRAMES, counts

        argv = [APP_CONFIG, bags["sqlite3"], "--max-frames", str(BAG_FRAMES)]
        out = io.StringIO()
        with recorded_app_system(slam_mod, est_mod, sync=torch.cuda.synchronize) as rec:
            torch.cuda.synchronize()
            harris_nms_cuda.launches = 0
            Timing.reset()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out):
                rc = nodes.main_synchronous(argv, device=DEVICE)
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
            launches = {"ros2 bag": {"harris_nms": harris_nms_cuda.launches}}
        printed = out.getvalue().strip()
        slam = rec["systems"][0]
        est = slam.estimator
        n_oct = slam.frontend.cfg.detection.octaves
        traj = [(est.states[s].t, np.asarray(est.states[s].pose)) for s in est.state_order]
        ate = ate_rmse(traj, gt[:BAG_FRAMES], align=True)
        kf = [est.state_order.index(s) for s in rec["kf_sids"]]
        steady = rec["frame_s"][APP_WARMUP:]
        app_at = {int(r[0]): r[1:4] for r in app_rows}
        gaps = [np.linalg.norm(p[:3] - app_at[int(round(t * 1e9))]) for t, p in traj
                if int(round(t * 1e9)) in app_at]
        bar = 1.5 * jax["ate_m"] + 0.005
        lm_slack = max(3, 0.01 * jax["landmarks"])
        log(f"{tag} the node printed {printed!r} and returned {rc} in {wall_s:.2f} s; "
            f"process_frame {len(steady) / sum(steady):.3f} frames/s over frames "
            f"{APP_WARMUP + 1}-{len(rec['frame_s'])} (median {statistics.median(steady) * 1e3:.3f} "
            f"ms; first {rec['frame_s'][0] * 1e3:.1f} ms), harris_nms launches "
            f"{harris_nms_cuda.launches} ({len(rec['frame_s'])} frames x {n_oct} octave) ({card})")
        log(f"{tag} ATE {ate:.6f} m (bar {bar:.6f}; the JAX node on the same bag "
            f"{jax['ate_m']:.6f}), keyframes at frames {kf} (JAX {jax['keyframes']}), landmarks "
            f"{len(est.landmarks)} (JAX {jax['landmarks']}, slack {lm_slack:g}), loop closures "
            f"{slam.loop_backend.num_loop_closures}, capacity truncations "
            f"{json.dumps(rec['truncations'])}; position gap to phase 14's app poses (after its "
            f"final BA) at the {len(gaps)} shared stamps: median "
            f"{statistics.median(gaps) * 1e3:.3f} mm, largest {max(gaps) * 1e3:.3f} mm")
        log_split(tag + " (all frames)", APP_STAGES["sync"], len(rec["frame_s"]))
        assert rc == 0 and printed == (f"processed {BAG_FRAMES} frames, "
                                       f"{len(est.landmarks)} landmarks"), (rc, printed)
        assert len(rec["frame_s"]) == BAG_FRAMES == len(est.state_order), rec["frame_s"]
        assert kf == jax["keyframes"], (kf, jax["keyframes"])
        assert abs(len(est.landmarks) - jax["landmarks"]) <= lm_slack, len(est.landmarks)
        assert ate < bar, f"ros2 bag: ATE {ate:.6f} m against a bar of {bar:.6f} m"
        assert launches["ros2 bag"]["harris_nms"] == BAG_FRAMES * n_oct, launches
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return launches


# Phase 16: the native EuRoC prefetcher (okvis2_torch/pipeline/native_loader.py:
# worker threads decode NATIVE_PREFETCH frames ahead, inflating with zlib and
# undoing the PNG row filters in okvis2_torch/native/dataloader.cpp, built
# on first use with the host compiler) on phase 14's two 40-frame folders,
# and on a copy of the circle folder whose PNGs are re-encoded with the
# Paeth filter on every row (encode_png_rows): writers that pick a filter
# per row (libpng's adaptive heuristic) write such rows, which the Python
# codec decodes with a loop per pixel (~0.3 s a 752x480 image), so the
# Python reader reads only NATIVE_PY_PAETH_PAIRS pairs of the copy. Held:
# open_euroc returns the native reader; its streams equal
# EurocDatasetReader's (events, order, times, IMU values and images bit for
# bit), on the Paeth copy against the circle folder's Python stream (the
# same pixels), and the Python reader's first pairs of the copy agree.
# Printed: the decode ms per pair of both readers on one thread, and the
# main thread's wait per frame once the prefetch is primed.
NATIVE_PREFETCH = 8
NATIVE_PY_PAETH_PAIRS = 2


def encode_png_rows(img, filters):
    """PNG bytes of a uint8 [H, W] image whose row y is written with the
    filter ``filters[y % len(filters)]`` (0 None, 1 Sub, 2 Up, 3 Average,
    4 Paeth), each predicted from the image's own pixels as the PNG
    specification defines it."""
    import struct
    import zlib

    from okvis2_torch.pipeline import png

    img = np.asarray(img, np.uint8)
    h, w = img.shape
    x = img.astype(np.int32)
    a, b, c = (np.zeros_like(x) for _ in range(3))  # left, up, up-left
    a[:, 1:], b[1:], c[1:, 1:] = x[:, :-1], x[:-1], x[:-1, :-1]
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    preds = (np.zeros_like(x), a, b, (a + b) >> 1, paeth)
    kinds = np.asarray([filters[y % len(filters)] for y in range(h)], np.uint8)
    rows = np.empty((h, w + 1), np.uint8)
    rows[:, 0] = kinds
    for k in np.unique(kinds):
        sel = kinds == k
        rows[sel, 1:] = ((x - preds[k]) & 0xFF)[sel]
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0)
    return (png.SIGNATURE + png._chunk(b"IHDR", ihdr)
            + png._chunk(b"IDAT", zlib.compress(rows.tobytes())) + png._chunk(b"IEND", b""))


def filtered_copy(src, dst, filters):
    """A copy of the EuRoC folder ``src`` at ``dst`` with every PNG
    re-encoded by ``encode_png_rows`` (the same pixels, other row filters).
    Returns the number of images."""
    import shutil

    from okvis2_torch.pipeline import png

    n = 0
    for root, _, files in os.walk(src):
        out = os.path.join(dst, os.path.relpath(root, src))
        os.makedirs(out, exist_ok=True)
        for name in files:
            if name.endswith(".png"):
                with open(os.path.join(out, name), "wb") as f:
                    f.write(encode_png_rows(png.read_png(os.path.join(root, name)), filters))
                n += 1
            else:
                shutil.copyfile(os.path.join(root, name), os.path.join(out, name))
    return n


def compare_streams(got, want):
    """Two readers' event streams: the same events in the same order, times
    equal, IMU values and float32 images bit for bit. Returns the counts."""
    import itertools

    counts = {"imu": 0, "images": 0}
    for g, w in itertools.zip_longest(got, want):
        assert g is not None and w is not None, f"the streams part after {counts}"
        assert g[0] == w[0] and g[1] == w[1], (g[:2], w[:2], counts)
        if g[0] == "imu":
            assert all(np.array_equal(u, v) for u, v in zip(g[2:], w[2:])), counts
        else:
            assert len(g[2]) == len(w[2]) and all(
                u.dtype == v.dtype == np.float32 and np.array_equal(u, v)
                for u, v in zip(g[2], w[2])), counts
        counts[g[0]] += 1
    return counts


def primed_wait_ms(reader, tol):
    """The main thread's wait for each frame of ``reader``'s stream (ms),
    the stream started and left 0.5 s to fill its prefetch first."""
    stream = reader.stream(tol)
    waits, ev = [], next(stream)
    time.sleep(0.5)
    t = time.perf_counter()
    for ev in stream:
        if ev[0] == "images":
            waits.append((time.perf_counter() - t) * 1e3)
        t = time.perf_counter()
    return waits


def decode_ms_per_pair(decode, frames):
    """Mean ms to decode one frame's images on the calling thread."""
    t = time.perf_counter()
    for _, paths in frames:
        for p in paths:
            decode(p)
    return (time.perf_counter() - t) * 1e3 / max(len(frames), 1)


def phase_native_loader(card):
    """Phase 16 (see NATIVE_PREFETCH)."""
    import shutil
    import tempfile

    from okvis2_torch.config import read_config_file
    from okvis2_torch.pipeline import native_loader
    from okvis2_torch.pipeline.dataset import EurocDatasetReader, load_image

    tag = "[native loader]"
    tol = read_config_file(APP_CONFIG, device="cpu").camera_rig.timestamp_tolerance
    root = tempfile.mkdtemp(prefix="okvis2_native_")
    try:
        t0 = time.perf_counter()
        lib = native_loader.load_native_lib()
        log(f"{tag} okvis2_torch/native/dataloader.cpp built and loaded in "
            f"{time.perf_counter() - t0:.2f} s")
        folders = {}
        for name, period in (("circle", APP_PERIOD), ("default", None)):
            folders[name] = os.path.join(root, name)
            write_app_folder(folders[name], APP_FRAMES, period)
            digest = app_folder_digest(folders[name])
            assert digest == APP_JAX["sync" if period else "pipelined"]["folder_digest"], name
        folders["paeth"] = os.path.join(root, "paeth")
        t0 = time.perf_counter()
        n_png = filtered_copy(folders["circle"], folders["paeth"], [4])
        log(f"{tag} phase 14's folders written again; the circle folder's {n_png} PNGs "
            f"re-encoded with Paeth rows in {time.perf_counter() - t0:.2f} s")
        for name in ("circle", "default", "paeth"):
            reader = native_loader.open_euroc(folders[name], 2, tol)
            assert isinstance(reader, native_loader.NativeEurocReader), type(reader)
            assert (reader.width, reader.height, reader.num_frames) == (W, H, APP_FRAMES)
            # the Paeth copy holds the circle folder's pixels
            ref = EurocDatasetReader(folders["circle" if name == "paeth" else name], 2)
            t0 = time.perf_counter()
            counts = compare_streams(reader.stream(tol), ref.stream(tol))
            both_s = time.perf_counter() - t0
            waits = primed_wait_ms(reader, tol)
            frames = EurocDatasetReader(folders[name], 2).synced_frames(tol)
            nat_ms = decode_ms_per_pair(lambda p: native_loader.decode_image(lib, p), frames)
            py_frames = frames[:NATIVE_PY_PAETH_PAIRS] if name == "paeth" else frames
            t0 = time.perf_counter()
            py_imgs = [[load_image(p) for p in paths] for _, paths in py_frames]
            py_ms = (time.perf_counter() - t0) * 1e3 / len(py_frames)
            if name == "paeth":  # the Python reader's first pairs of the copy
                circle = EurocDatasetReader(folders["circle"], 2).synced_frames(tol)
                for k, imgs in enumerate(py_imgs):
                    assert all(np.array_equal(u, load_image(p))
                               for u, p in zip(imgs, circle[k][1])), k
            reader.close()
            on_circle = " on the circle folder" if name == "paeth" else ""
            log(f"{tag} {name}: open_euroc gave NativeEurocReader ({reader.width}x"
                f"{reader.height}, {reader.num_frames} frames, {NATIVE_PREFETCH} ahead); its "
                f"stream equals EurocDatasetReader's{on_circle}: "
                f"{counts['images']} image pairs bit for bit, {counts['imu']} IMU samples "
                f"exactly ({both_s:.2f} s for both streams); decode per pair on one thread: "
                f"native {nat_ms:.3f} ms, Python {py_ms:.3f} ms (over {len(py_frames)} pairs); "
                f"main thread's wait per frame once primed: mean {np.mean(waits):.3f} ms, "
                f"median {np.median(waits):.3f} ms, max {np.max(waits):.3f} ms (host; {card})")
            assert counts["images"] == APP_FRAMES, counts
    finally:
        shutil.rmtree(root, ignore_errors=True)


# Phase 17: Fast-SCNN's importer and trainer on the card.
# (a) the public checkpoint's layout (models/torch_fast_scnn.py) with seeded
#     random weights and BatchNorm statistics, saved as .pth, converted by
#     import_torch_fast_scnn.main and loaded into the port's FastSCNN
#     (load_params -> interop.fast_scnn_state_dict_from_flax): its logits
#     at 192x320 on the card within SCNN_IMPORT_TOL of the mirror's on the
#     card, at least SCNN_IMPORT_AGREE of the argmax equal (the JAX
#     importer test's bars, tests/test_torch_import.py);
# (b) one training step (train_synthetic.train_step) in float64 at full
#     width, batch 4 at 192x320, from the same variables and batch on the
#     card and on the CPU: the loss, every gradient (weights and BatchNorm
#     statistics) and every updated leaf within SCNN_STEP_TOL of each
#     leaf's largest magnitude;
# (c) train(**SCNN_TRAIN) in float32 on the card: the mean loss over the
#     last 25 steps below that over the first 25; the pixel accuracy on the
#     2-D scenes and on the textured views at least the JAX run's minus
#     SCNN_ACC_SLACK (the port starts from its own seeded initialisation).
#     The JAX trainer on the CPU in float32
#     (tools/e2e_reference_jax.py train 200 0): losses at steps 0, 25, ...,
#     175 of 2.9442, 0.5072, 0.6506, 0.3976, 0.3713, 0.1166, 0.1202,
#     0.1485 (logged beside the port's); "pixel accuracy: 2d 0.974
#     textured 0.931". The trained model saved with save_params, reloaded
#     and run on 4 fresh scenes must give the trained model's classes; the
#     JAX package's committed weights stay untouched.
SCNN_IMPORT_TOL, SCNN_IMPORT_AGREE, SCNN_STEP_TOL, SCNN_ACC_SLACK = 2e-3, 0.999, 1e-8, 0.05
SCNN_TRAIN = dict(steps=200, batch=4, textured_frac=0.5, seed=0)
SCNN_JAX = dict(acc_2d=0.9738789876302083, acc_textured=0.931,
                losses=[2.9442, 0.5072, 0.6506, 0.3976, 0.3713, 0.1166, 0.1202, 0.1485])


def phase_scnn(card):
    """Phase 17 (see SCNN_TRAIN)."""
    import hashlib
    import tempfile

    from okvis2_torch import interop
    from okvis2_torch.models import fast_scnn as tfs
    from okvis2_torch.models import import_torch_fast_scnn as timp
    from okvis2_torch.models import train_synthetic as ttr
    from okvis2_torch.models.torch_fast_scnn import build_torch_fast_scnn

    with open(CNN_WEIGHTS, "rb") as f:
        weights_digest = hashlib.sha256(f.read()).hexdigest()
    with tempfile.TemporaryDirectory(prefix="okvis2_scnn_") as tmp:
        # (a) the importer
        tag = "[scnn import]"
        gen = torch.Generator().manual_seed(0)
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(0)
            mirror = build_torch_fast_scnn().eval()
        with torch.no_grad():
            for m in mirror.modules():
                if isinstance(m, torch.nn.BatchNorm2d):
                    m.running_mean.copy_(torch.randn(m.running_mean.shape, generator=gen) * 0.05)
                    m.running_var.copy_(torch.rand(m.running_var.shape, generator=gen) + 0.5)
        pth, npz = os.path.join(tmp, "fast_scnn_random.pth"), os.path.join(tmp, "imported.npz")
        torch.save(mirror.state_dict(), pth)
        t0 = time.perf_counter()
        assert timp.main([pth, npz]) == 0
        import_ms = (time.perf_counter() - t0) * 1e3
        model = tfs.FastSCNN()
        model.load_state_dict(interop.fast_scnn_state_dict_from_flax(tfs.load_params(npz)))
        model = model.to(DEVICE).eval()
        img = torch.rand((192, 320, 3), generator=gen) * 2 - 1
        with torch.no_grad():
            want = mirror.to(DEVICE)(img.permute(2, 0, 1)[None].to(DEVICE))[0]
        got = tfs.image_logits(model, img.to(DEVICE))
        err = float((got - want).abs().max())
        agree = float((got.argmax(0) == want.argmax(0)).double().mean())
        log(f"{tag} mirror .pth -> import_torch_fast_scnn.main -> load_params in "
            f"{import_ms:.1f} ms; logits on the card at 192x320 within {err:.3e} of the "
            f"mirror's (bar {SCNN_IMPORT_TOL:g}), argmax agreement {agree:.5f} (bar "
            f"{SCNN_IMPORT_AGREE}) ({card})")
        assert got.shape == (19, 192, 320) and err < SCNN_IMPORT_TOL, err
        assert agree >= SCNN_IMPORT_AGREE, agree

        # (b) one float64 step at full width, card against CPU
        tag = "[scnn step]"
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(1)
            base = tfs.FastSCNN().double()
        imgs, labs = ttr.draw_batch(np.random.default_rng(0), SCNN_TRAIN["batch"], [], 0.0)
        out = {}
        for dev in ("cpu", DEVICE):
            trained = ttr.trainable_model(base).to(dev)
            opt = torch.optim.Adam(trained.parameters(), lr=1e-3, eps=1e-8)
            x = torch.from_numpy(imgs).permute(0, 3, 1, 2).contiguous().to(dev, torch.float64)
            t0 = time.perf_counter()
            loss = float(ttr.train_step(trained, opt, x, torch.from_numpy(labs).to(dev)))
            ms = (time.perf_counter() - t0) * 1e3
            grads = {n: p.grad.cpu() for n, p in trained.named_parameters()}
            new = {n: p.detach().cpu() for n, p in trained.named_parameters()}
            out[dev] = (loss, grads, new, ms)
        (lc, gc, nc, msc), (lg, gg, ng, msg) = out["cpu"], out[DEVICE]

        def worst(a, b):
            return max(float((a[k] - b[k]).abs().max()) / max(float(b[k].abs().max()), 1e-300)
                       for k in b)

        d_grad, d_new = worst(gg, gc), worst(ng, nc)
        n_stats = sum(1 for k in gc if k.endswith(("running_mean", "running_var")))
        log(f"{tag} float64, batch {SCNN_TRAIN['batch']} at 192x320, card against CPU: loss "
            f"{lg:.12f} / {lc:.12f}, gradients within {d_grad:.3e} and updated leaves within "
            f"{d_new:.3e} of each leaf's largest ({len(gc)} leaves, {n_stats} of them BatchNorm "
            f"statistics; bar {SCNN_STEP_TOL:g}); card {msg:.1f} ms, CPU {msc:.1f} ms")
        assert abs(lg - lc) <= SCNN_STEP_TOL * abs(lc), (lg, lc)
        assert d_grad <= SCNN_STEP_TOL and d_new <= SCNN_STEP_TOL, (d_grad, d_new)
        assert n_stats > 0 and all(float(gc[k].abs().max()) > 0 for k in gc
                                   if k.endswith("running_mean"))

        # (c) train on the card, save, reload
        tag = "[scnn train]"
        t0 = time.perf_counter()
        served, rec = ttr.train(**SCNN_TRAIN, device=DEVICE)
        wall_s = time.perf_counter() - t0
        losses = rec["losses"]
        first, last = float(np.mean(losses[:25])), float(np.mean(losses[-25:]))
        log(f"{tag} train({', '.join(f'{k}={v}' for k, v in SCNN_TRAIN.items())}) on the card in "
            f"{wall_s:.1f} s: {rec['step_ms']:.3f} ms per step (batch drawing included); loss "
            f"at steps 0, 25, ...: {[round(float(v), 4) for v in losses[::25]]} (the JAX run on "
            f"the CPU: {SCNN_JAX['losses']}); mean over the first 25 steps {first:.4f}, over "
            f"the last 25 {last:.4f}; pixel accuracy 2d {rec['acc_2d']:.4f}, textured "
            f"{rec['acc_textured']:.4f} (JAX {SCNN_JAX['acc_2d']:.4f}, "
            f"{SCNN_JAX['acc_textured']:.3f}; bars - {SCNN_ACC_SLACK}) ({card})")
        assert len(losses) == SCNN_TRAIN["steps"] and np.isfinite(losses).all()
        assert last < first, (first, last)
        assert rec["acc_2d"] >= SCNN_JAX["acc_2d"] - SCNN_ACC_SLACK, rec["acc_2d"]
        assert rec["acc_textured"] >= SCNN_JAX["acc_textured"] - SCNN_ACC_SLACK, rec
        path = os.path.join(tmp, "trained.npz")
        tfs.save_params(path, served)
        back = tfs.FastSCNN()
        back.load_state_dict(interop.fast_scnn_state_dict_from_flax(tfs.load_params(path)))
        back = back.to(DEVICE).eval()
        rng = np.random.default_rng(123)
        same = []
        for _ in range(4):
            im = torch.as_tensor(ttr.make_scene(rng)[0], device=DEVICE)
            same.append(bool(torch.equal(tfs.segment_image(back, im),
                                         tfs.segment_image(served, im))))
        log(f"{tag} saved with save_params ({os.path.getsize(path)} bytes), reloaded: the "
            f"classes of 4 fresh scenes equal the trained model's: {same}")
        assert all(same), same
    with open(CNN_WEIGHTS, "rb") as f:
        assert hashlib.sha256(f.read()).hexdigest() == weights_digest, "weights changed"


# phase 18: the device-loop replay (okvis2_torch.pipeline.device_replay)
# of phase 9's first drive, cut from the JAX bench's 60 frames x 3 timed
# passes (bench.py:198-275) to its last 10 records (frames 31-40, steady)
# x one warm and 2 timed passes per mode, to keep the phase near a minute
# (the solve, ~0.8 s a frame on the card, is most of it); the transfer
# census profiles one more full pass over the last REPLAY_CENSUS records.
# No copy of REPLAY_COPY_LIMIT bytes or more may happen there.
REPLAY_FRAMES, REPLAY_PASSES, REPLAY_CENSUS = 10, 2, 1
REPLAY_COPY_LIMIT = 1024


def system_state(slam):
    """What a replay must leave as it found it: the trajectory, the
    landmarks, the descriptor table (the tensors and their values), the
    RANSAC generator's state and the frames in flight."""
    est, tab = slam.estimator, slam.frontend.table
    return {"traj": [(t, p.copy()) for t, p in est.trajectory()],
            "landmarks": {lid: lm.hp_W.copy() for lid, lm in est.landmarks.items()},
            "table": (tab.signs, tab.valid, tab.signs.clone(), tab.valid.clone(),
                      dict(tab.slot_of)),
            "gen": slam.frontend._gen.get_state().clone(), "pending": len(slam._pending_frames)}


def assert_same_state(a, b):
    assert a["traj"] and len(a["traj"]) == len(b["traj"]) and all(
        ta == tb and np.array_equal(pa, pb) for (ta, pa), (tb, pb) in zip(a["traj"], b["traj"]))
    assert a["landmarks"].keys() == b["landmarks"].keys() and all(
        np.array_equal(a["landmarks"][k], b["landmarks"][k]) for k in a["landmarks"])
    assert a["table"][0] is b["table"][0] and a["table"][1] is b["table"][1]
    assert torch.equal(b["table"][0], a["table"][2]) and torch.equal(b["table"][1], a["table"][3])
    assert a["table"][4] == b["table"][4] and torch.equal(a["gen"], b["gen"])
    assert a["pending"] == b["pending"]


def phase_replay(card, cap):
    """Phase 18: phase 9's last REPLAY_FRAMES records replayed on the card
    in the three modes, with every input staged on the device; the first
    full pass equal to the live [solve output | diag] bit for bit, every
    pass equal to the first, the frontend's diagnostics equal to the live
    ones, the solve mode equal to the full one, one Harris launch per
    replayed frame and octave in the timed passes of modes full and
    frontend and none in mode solve, the system unchanged, and no copy of
    REPLAY_COPY_LIMIT bytes or more in the profiled pass. Returns the
    kernels' launch counts over the phase."""
    from okvis2_torch.ops.harris_cuda import harris_nms_cuda
    from okvis2_torch.pipeline import device_replay as dr

    tag = "[device-loop replay]"
    slam = cap["slam"]
    records = cap["records"][-REPLAY_FRAMES:]
    n = len(records)
    assert n == REPLAY_FRAMES, n
    n_oct = slam.frontend.cfg.detection.octaves
    sets = collections.Counter(len(set(r["set_sids"])) for r in records)
    before = system_state(slam)
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    harris_nms_cuda.launches = 0
    res = {mode: dr.replay_device_loop(slam, records, n_pass=REPLAY_PASSES, mode=mode,
                                       census=REPLAY_CENSUS if mode == "full" else 0)
           for mode in dr.MODES}
    torch.cuda.synchronize()
    launches = harris_nms_cuda.launches
    secs = time.perf_counter() - t0
    assert_same_state(before, system_state(slam))

    full, fe, so = res["full"], res["frontend"], res["solve"]
    for i, r in enumerate(records):
        live = dr.live_output(r)
        got = full["first"][i].cpu().numpy()
        assert got.dtype == live.dtype and np.array_equal(got, live), (
            f"replay frame {i} (state {r['sid']}): [solve | diag] differs from the live run, "
            f"max abs {np.abs(got.astype(np.float64) - live).max():.3e}")
        for mode in dr.MODES:
            assert torch.equal(res[mode]["outputs"][i], res[mode]["first"][i]), (mode, i)
        assert torch.equal(fe["first"][i], r["diag"]), f"frontend mode, frame {i}"
        assert torch.equal(so["first"][i], full["first"][i]), f"solve mode, frame {i}"
    timed = REPLAY_PASSES * n * n_oct
    assert full["harris_launches"] == fe["harris_launches"] == timed, (
        full["harris_launches"], fe["harris_launches"], timed)
    assert so["harris_launches"] == 0, so["harris_launches"]
    # warm + timed passes of two modes, the solve mode's fixing pass, the census
    assert launches == n_oct * (2 * (1 + REPLAY_PASSES) * n + n + REPLAY_CENSUS), launches
    tr = full["transfers"]
    assert tr["max_copy_bytes"] < REPLAY_COPY_LIMIT, (
        "a copy of >= 1 KB in the replay, or one the device recorded no size for: "
        + json.dumps(tr["copies"] + tr["unsized"]))

    log(f"{tag} {n} records of {cap['tag']} (states {records[0]['sid']}-{records[-1]['sid']}; "
        f"distinct sets appended per solve {json.dumps(dict(sets))}), {REPLAY_PASSES} timed passes "
        f"per mode after a warm one, every input staged on the card: first full pass equal to "
        f"the live [solve | diag] bit for bit on every frame, every pass equal to the first, "
        f"frontend diagnostics equal to the live ones, solve mode equal to full; harris_nms "
        f"launches per replayed frame in the timed passes: full "
        f"{full['harris_launches'] / (REPLAY_PASSES * n):g}, frontend "
        f"{fe['harris_launches'] / (REPLAY_PASSES * n):g}, solve "
        f"{so['harris_launches'] / (REPLAY_PASSES * n):g}; the system unchanged; "
        f"{secs:.1f} s in all ({card})")
    log(f"{tag} frames/s: full {full['fps']:.3f}, frontend {fe['fps']:.3f}, solve "
        f"{so['fps']:.3f}; the live pipelined loop (phase 9, process_frame over the steady "
        f"frames) {cap['fps']:.3f} ({card})")
    log(f"{tag} transfers in one profiled full pass over the last {REPLAY_CENSUS} record(s): "
        f"{tr['copies_per_frame']:g} copies and {tr['syncs_per_frame']:g} host "
        f"synchronisations per frame, largest copy {tr['max_copy_bytes']} bytes")
    per = REPLAY_CENSUS
    log(f"{tag} copies per frame by cause " + json.dumps(
        [dict(c, count=c["count"] / per) for c in tr["copies"] + tr["unsized"]]))
    log(f"{tag} synchronisations per frame by cause " + json.dumps(
        [dict(c, count=c["count"] / per) for c in tr["syncs"]]))
    return {"harris_nms": launches}


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs an NVIDIA card", file=sys.stderr)
        return 1
    import okvis2_torch  # noqa: F401  (fails outside a checkout of the repo)
    from okvis2_torch.utils.synthetic import textured_stereo_pair

    t_start = time.perf_counter()

    def done(phase):
        log(f"[time] phases up to {phase}: {time.perf_counter() - t_start:.1f} s")

    card = phase_device()
    phase_build()
    imgs = torch.tensor(textured_stereo_pair(H, W, seed=0), dtype=torch.float32, device=DEVICE)
    kernels = phase_kernels(imgs)
    det_cfg = phase_frontend(imgs)
    window = phase_solve()
    phase_mixed_rig()
    launches = phase_hotpath(imgs, det_cfg, window, card)
    done("6 hot path")
    launches_tracking = phase_tracking(card)
    done("7 tracking")
    launches_slam = {name: phase_slam(card, name, d) for name, d in SLAM_DRIVES.items()}
    done("8 slam")
    captured = None
    for name, d in PIPELINED_DRIVES.items():
        launches_slam[name], cap = phase_pipelined(card, name, d)
        captured = cap or captured
    done("9 slam pipelined")
    sessions = {}
    for name, d in LOOP_DRIVES.items():
        if d["pipelined"]:
            launches_slam[name] = phase_loop_pipelined(card, name, d)
        else:
            launches_slam[name], sessions[name] = phase_loop_sync(card, name, d)
    done("10 slam loop closure")
    launches_ms, fba_pack = phase_multi_session(card, *sessions[MULTI_SESSION["session"]])
    launches_slam.update(launches_ms)
    done("11 multi-session")
    launches_slam.update({name: phase_cnn(card, name) for name in CNN_DRIVES})
    done("12 slam cnn")
    phase_sharded_final_ba(card, fba_pack)
    done("13 sharded final BA")
    launches_app, app_rows = phase_app(card)
    launches_slam.update(launches_app)
    done("14 app")
    launches_slam.update(phase_bag(card, app_rows))
    done("15 ros2 bag replay")
    phase_native_loader(card)
    done("16 native loader")
    phase_scnn(card)
    done("17 fast-scnn")
    launches_slam["device-loop replay"] = phase_replay(card, captured)
    done("18 device-loop replay")
    for k in kernels:
        by_phase = {"hot path": launches[k["name"]], "tracking": launches_tracking[k["name"]]}
        by_phase.update({name: n[k["name"]] for name, n in launches_slam.items()})
        k["launches"] = sum(by_phase.values())
        k["launches_by_phase"] = by_phase
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
