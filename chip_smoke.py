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
  6. hot path  50 frames of (frontend + 3-iteration solve), as the JAX
               package's bench.py::bench_hotpath; the kernels' launch
               counts are zeroed just before and read just after

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

import torch

# the card's published peaks (H100 SXM data sheet): HBM bytes/s, f32 FLOP/s
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
# Harris + NMS arithmetic per pixel, as the plain version does it: Sobel
# gradients 10, products 3, three 3x3 boxes 15, response 7, NMS 8 maxima
# and a select 9
HARRIS_OPS_PER_PX = 44

H, W, N_KP = 480, 752, 512
N_FRAMES = 50
DEVICE = "cuda"


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
    stages = {
        "detect": lambda: detect_keypoints_batch(imgs, det_cfg),
        "describe": lambda: [describe_keypoints(imgs[c], det["xy"][c], det["size"][c],
                                                det["mask"][c]) for c in range(2)],
        "match": lambda: match_descriptors(desc[0]["signs"], det["mask"][0],
                                           desc[1]["signs"], det["mask"][1]),
        "solve3": lambda: solve_window(problem, cams, imu_params, cfg3),
    }
    split = {}
    for name, fn in stages.items():
        fn()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(10):
            fn()
        torch.cuda.synchronize()
        split[name] = (time.perf_counter() - t) / 10 * 1e3
    log(f"[hotpath] {N_FRAMES} frames in {secs:.3f} s: {N_FRAMES / secs:.2f} frames/s, "
        f"harris_nms launches {launches} ({card})")
    log("[hotpath] stage ms " + json.dumps({k: round(v, 3) for k, v in split.items()}))
    profile_frame(frame)
    return {"harris_nms": launches}


def profile_frame(frame):
    """One hot-path frame under torch.profiler: device kernels launched,
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
    for k in kernels:
        k["launches"] = launches[k["name"]]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
