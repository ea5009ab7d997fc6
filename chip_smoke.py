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
               checked against ground truth
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
               drives (SLAM_DRIVES): the bench's 60 frames at 20 Hz, and
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
               (PIPELINED_DRIVES): the bench's 60 frames with the loop's own
               lag, and 30 of them with two frames kept in flight. Each
               checks what phase 8 checks, and that the appended rows never
               exceed the observation slots; the second that every solve
               from the third frame on appended three sets. Each prints the
               frames/s of process_frame (which does not wait for the
               card), the stage split, the lag histogram; the first a
               profiled frame with two frames in flight

Every check raises on failure, so any failing phase exits non-zero. The
line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}. Without a CUDA card it exits non-zero
before printing any result.
"""

import json
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
# - "slam": the bench's frame count and warm-up (bench.py:55, :194) on the
#   default trajectory. The JAX run makes 1 keyframe in these 60 frames (4
#   in 400, where the star field ends) and so no pose-graph edge:
#   marginalisation shows here as IMU-frame elimination under the window
#   bound.
# - "slam pose graph": one circle (5 s at 8 Hz) with 2 window keyframes in
#   place of 5, so that keyframes leave the window as pose-graph factors
#   (the JAX run: keyframes at frames 0, 8, 18, 26 and 37; edges between
#   states 8-0, 18-8 and 26-18).
SLAM_DRIVES = {
    "slam": dict(frames=60, rate=20.0, trajectory="default", num_keyframes=5, warmup=12,
                 jax_ate_m=0.0034135940286723417, min_edges=0, profile=True),
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
# bookkeeping runs changes the result: the JAX loop on these 60 frames
# reaches ATE 5.737 mm with one frame in flight at every dispatch (its own
# lag on the CPU, "60 20 default 5 1"), 0.347 m with two ("... 1 1"), and
# 0.119 m on the first 30 frames with three ("30 20 default 5 1 2 8192").
# - "slam pipelined": the bench's 60 frames, warm-up 12 (bench.py:189), the
#   loop's own lag. On the card a solve takes longer than a frame's host
#   work, so from the second frame on two frames are in flight at each
#   dispatch: the schedule of the JAX run with one frame kept in flight
#   (keyframes at frames 0, 1, 2, 47). The drive checks that it ran so.
# - "slam pipelined deep lag": the first 30 of those frames with two frames
#   kept in flight (_force_min_pending=2), so that every solve from the
#   third frame on appends three sets of match rows on the card; with 8192
#   observation slots in place of 4096, where the appended rows overflow
#   in both packages (4251 rows in the JAX run; keyframes at frames 0-3).
PIPELINED_DRIVES = {
    "slam pipelined": dict(frames=60, rate=20.0, trajectory="default", num_keyframes=5,
                           warmup=12, min_pending=0, in_flight=2, obs_slots=4096,
                           jax_ate_m=0.34743515642534833, min_edges=0, profile=True),
    "slam pipelined deep lag": dict(frames=30, rate=20.0, trajectory="default",
                                    num_keyframes=5, warmup=6, min_pending=2, in_flight=3,
                                    obs_slots=8192, jax_ate_m=0.11948972192121458, min_edges=0,
                                    profile=False),
}
# the share of a pipelined drive's frames, from the third on, that must run
# at the drive's schedule (frames in flight after the dispatch)
MIN_SCHEDULE_SHARE = 0.9


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
    from okvis2_torch.pipeline.slam import SlamSystem

    n_frames, rate, tag = d["frames"], d["rate"], f"[{name}]"
    cams, T_SC, imu = tracking_rig(DEVICE)
    exts = [Transformation(r=torch.tensor(T[:3], dtype=torch.float32, device=DEVICE),
                           q=torch.tensor(T[3:], dtype=torch.float32, device=DEVICE))
            for T in T_SC]
    t0 = time.perf_counter()
    # one frame more than the measured run: the profiled frame (a circle
    # drive renders exactly its frames: its period is the duration)
    extra = 1 if d["trajectory"] == "default" else 0
    ds = SyntheticDataset(cams, exts, imu, n_stars=2500, duration=(n_frames + extra) / rate,
                          frame_rate=rate, imu_rate=200.0, seed=0, trajectory=d["trajectory"],
                          device=DEVICE)
    events = [ev if ev[0] == "imu" else
              (ev[0], ev[1], [(np.clip(im, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
                              for im in ev[2]], ev[3])
              for ev in ds.stream()]
    n_rendered = sum(ev[0] == "images" for ev in events)
    log(f"{tag} rendered {n_rendered} {W}x{H} stereo frames of 2500 stars on the "
        f"{d['trajectory']} trajectory at {rate:g} Hz in {time.perf_counter() - t0:.2f} s")
    assert n_rendered == n_frames + extra, n_rendered

    est_cfg = est_mod.EstimatorConfig(window_slots=12, landmark_slots=512,
                                      obs_slots=d.get("obs_slots", 4096),
                                      imu_seg_capacity=64, enforce_realtime=True,
                                      realtime_time_limit=1.0 / 200.0,
                                      num_keyframes=d["num_keyframes"])
    fe_cfg = FrontendConfig(detection=DetectionConfig(max_keypoints=N_KP),
                            map_match_capacity=TRACK_CAP)
    slam = SlamSystem(cams, exts, imu, est_cfg, fe_cfg, pipelined=pipelined, device=DEVICE)
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
                           restore=restore, tag=tag)


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
    assert len(run.factors) == len(edges), (len(run.factors), len(edges))
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
    pipelined loop; returns the kernels' launch counts over its frames.
    The loop is timed as its user sees it: ``process_frame`` returns
    without waiting for the device (nothing here synchronises between
    frames), and ``finish()`` drains the frames still in flight."""
    from okvis2_torch.ops.harris_cuda import harris_nms_cuda
    from okvis2_torch.solver.packed_solve import MAX_APPEND_SETS
    from okvis2_torch.utils.timing import Timing

    n_frames, run = d["frames"], slam_drive(name, d, pipelined=True)
    slam, est, tag = run.slam, run.est, run.tag
    slam._force_min_pending = d["min_pending"]
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
    """One frame under torch.profiler: device kernels launched,
    device-busy time against the frame's wall time, the top kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
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


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs an NVIDIA card", file=sys.stderr)
        return 1
    import okvis2_torch  # noqa: F401  (fails outside a checkout of the repo)
    from okvis2_torch.utils.synthetic import textured_stereo_pair

    card = phase_device()
    phase_build()
    imgs = torch.tensor(textured_stereo_pair(H, W, seed=0), dtype=torch.float32, device=DEVICE)
    kernels = phase_kernels(imgs)
    det_cfg = phase_frontend(imgs)
    window = phase_solve()
    launches = phase_hotpath(imgs, det_cfg, window, card)
    launches_tracking = phase_tracking(card)
    launches_slam = {name: phase_slam(card, name, d) for name, d in SLAM_DRIVES.items()}
    launches_slam.update({name: phase_pipelined(card, name, d)
                          for name, d in PIPELINED_DRIVES.items()})
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
