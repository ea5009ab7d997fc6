"""The port's CUDA kernels against their plain PyTorch versions, on the card,
and the tracking program and the synchronous and pipelined SLAM loops
(whose detection runs the Harris kernel) on the card against the same on
the CPU; Fast-SCNN and the textured world on the card against the CPU; the
sharded solve over NCCL at world size 1 against the unsharded one; the
dataset app's config reader, PNG round trip and a 5-frame app run on the
card at configs/euroc.yaml; the ROS2 node's 5-frame bag replay there, on
the card against the CPU; the solver's dense path repeating bit for bit in
float32; one float64 Fast-SCNN training step on the card against the CPU;
the native EuRoC prefetcher built and read on the card's machine; the
pipelined loop's frame capture replayed on the card equal to the live run.

A hand-written CUDA kernel has no CPU mode, so every test here is marked
``cuda`` and skips without a card. This file imports no JAX, so it also
runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_kernels_cuda.py

Tolerance 0: the kernel rounds each float32 operation as the plain version
does, so the response and NMS maps are held bit for bit over the whole map.
(An absolute bar such as 1e-6 would hold nothing on the textured images,
where most of |resp| lies far below it.)
"""

import os

import numpy as np
import pytest
import torch

from okvis2_torch.frontend import detection as tdet
from okvis2_torch.ops import harris_cuda
from okvis2_torch.utils.synthetic import textured_stereo_pair

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _check(imgs, k=0.04):
    n0 = harris_cuda.harris_nms_cuda.launches
    resp_k, nms_k = tdet.harris_nms(imgs, k)
    torch.cuda.synchronize()
    assert harris_cuda.harris_nms_cuda.launches == n0 + 1
    resp_p, nms_p = harris_cuda.harris_nms_reference(imgs, k)
    err = (resp_k - resp_p).abs().max().item()
    assert torch.equal(resp_k, resp_p), (err, resp_p.abs().median().item())
    assert torch.equal(nms_k, nms_p)


@pytest.mark.parametrize("shape", [
    (2, 480, 752),   # the main path
    (2, 240, 376),   # its octaves; W = 94 has W*4 not a multiple of 16
    (2, 120, 188),
    (2, 60, 94),
    (2, 14, 360),    # an exact multiple of the 120-column x 7-row tile
    (1, 37, 53),     # ragged in both axes
    (1, 4, 115),     # smaller than one tile in both axes
    (1, 2, 40),      # H, W <= 3: the 3-px halo wraps onto itself
    (2, 20, 3),
    (1, 3, 2),
    (1, 1, 1),
    (3, 33, 71),     # C = 3
], ids=str)
def test_harris_kernel_matches_plain(cuda, shape):
    imgs = torch.tensor(np.random.default_rng(0).random(shape), dtype=torch.float32, device=cuda)
    _check(imgs)


def test_harris_kernel_non_default_k(cuda):
    imgs = torch.tensor(np.random.default_rng(1).random((2, 64, 96)), dtype=torch.float32,
                        device=cuda)
    _check(imgs, k=0.06)


@pytest.mark.parametrize("shape", [(2, 60, 94), (2, 48, 64)])
def test_harris_kernel_misaligned_input(cuda, shape):
    """A contiguous view whose data pointer is 4 bytes off 16-byte
    alignment takes the scalar path and still agrees bit for bit."""
    n = int(np.prod(shape))
    buf = torch.tensor(np.random.default_rng(2).random(n + 1), dtype=torch.float32, device=cuda)
    imgs = buf[1:].view(shape)
    assert imgs.data_ptr() % 16 == 4 and imgs.is_contiguous()
    _check(imgs)


def test_harris_kernel_detection_keypoints(cuda):
    """The frontend's keypoints through the kernel equal those through the
    plain version at the main path's size, and so do the maps."""
    imgs = torch.tensor(textured_stereo_pair(480, 752, seed=0), dtype=torch.float32, device=cuda)
    _check(imgs)
    cfg = tdet.DetectionConfig(max_keypoints=512)
    a = tdet.detect_keypoints_batch(imgs, cfg)
    b = tdet._detect_batch(imgs, cfg, harris_cuda.harris_nms_reference)
    for c in range(2):
        sa = {tuple(p) for p in torch.round(a["xy"][c][a["mask"][c]]).int().tolist()}
        sb = {tuple(p) for p in torch.round(b["xy"][c][b["mask"][c]]).int().tolist()}
        assert len(sa & sb) >= 0.99 * len(sb)


@pytest.mark.parametrize("bad", ["float64", "non_contiguous", "two_dims", "no_rows", "no_cameras",
                                 "too_many_cameras"])
def test_harris_kernel_rejects(cuda, bad):
    """What the kernel does not take raises ValueError and counts no launch:
    other types, layouts and ranks, empty shapes (no task to launch), and
    more cameras than the grid's z extent (65535) holds."""
    x = torch.rand(2, 16, 64, device=cuda)
    x = {"float64": x.double(), "non_contiguous": x.transpose(1, 2), "two_dims": x[0],
         "no_rows": x[:, :0], "no_cameras": x[:0],
         "too_many_cameras": torch.zeros(65536, 1, 1, device=cuda)}[bad]
    n0 = harris_cuda.harris_nms_cuda.launches
    with pytest.raises(ValueError):
        harris_cuda.harris_nms_cuda(x)
    assert harris_cuda.harris_nms_cuda.launches == n0


def _track_two_frames(device, imgs, poses):
    """frame_associate on frame A (empty map), static stereo on A at its
    true pose into the landmark table, then frame_associate on frame B
    with A as keyframe and previous frame, float32 at 2x128x192, 128
    keypoints, capacity 64, 16 hypotheses drawn by one CPU generator."""
    from okvis2_torch.cameras.pinhole import PinholeCamera
    from okvis2_torch.core import se3_np
    from okvis2_torch.pipeline import frontend_pipeline as fp

    cam = PinholeCamera.create(192, 128, 120.0, 120.0, 96.0, 64.0, dtype=torch.float32,
                               device=device)
    cams, cap = (cam, cam), 64
    T_SC = np.array([[0, 0, 0, 0, 0, 0, 1.0], [0.11, 0, 0, 0, 0, 0, 1.0]])
    cfg = fp.FrontendConfig(detection=tdet.DetectionConfig(max_keypoints=128),
                            map_match_capacity=cap, ransac_hypotheses=16)

    def sampler(mask, cam_idx, n_hyp, nc):
        gen = torch.Generator().manual_seed(3)
        return fp.sample_hypotheses(gen, mask.cpu(), cam_idx.cpu(), n_hyp, nc).to(mask.device)

    table = fp.DeviceLandmarkTable(cap, 3, device=device)
    table.ensure(512)
    lm = {"hp": np.tile([0, 0, 0, 1.0], (cap, 1)), "mask": np.zeros(cap, bool),
          "init": np.zeros(cap, bool)}
    a = fp.frame_associate(cams, T_SC, imgs[0], poses[0], lm, table.signs, table.valid, cfg,
                           sampler=sampler, device=device)
    T7 = np.stack([se3_np.compose7(poses[0], T) for T in T_SC])
    idx_b, hp_W, good, parallel = (x[0].cpu().numpy() for x in fp._stereo_pairs(
        cams, T7[:1], T7[1:], [3.0 / 120.0], 0.1, 60.0, a["mask"][:1], a["mask"][1:], a["xy"],
        a["signs"], ((0, 1),), 60, True))
    hosted, lms = set(), []
    for k in np.nonzero(good)[0]:
        if (1, int(idx_b[k])) in hosted:
            continue
        hosted |= {(0, int(k)), (1, int(idx_b[k]))}
        lms.append((hp_W[k], not parallel[k]))
        table.stage_descriptor(len(lms) - 1, 0, int(k))
    table.flush(a["signs"])
    for lid, s in table.slot_of.items():
        lm["hp"][s], lm["mask"][s], lm["init"][s] = lms[lid][0], True, lms[lid][1]
    free = a["mask"].clone()
    for c, k in hosted:
        free[c, k] = False
    b = fp.frame_associate(
        cams, T_SC, imgs[1], poses[1], lm, table.signs, table.valid, cfg, sampler=sampler,
        keyframes={"xy": a["xy"][None], "signs": a["signs"][None], "free": free[None],
                   "valid": [True], "T_WS7": poses[0][None]},
        prev={"xy": a["xy"], "signs": a["signs"], "mask": a["mask"], "T_WS7": poses[0]},
        device=device)
    # map match + RANSAC of frame B again, on given inputs (a device's own
    # frame-B outputs), for comparing devices on identical inputs
    def match_and_ransac(dev, out):
        cams_d = tuple(c.to(device=dev) for c in cams)
        t = lambda x: torch.as_tensor(x, device=dev)  # noqa: E731
        f = lambda x: torch.as_tensor(x, dtype=torch.float32, device=dev)  # noqa: E731
        rays = torch.stack([c.back_project(t(out["xy"][i])) for i, c in enumerate(cams_d)])
        return fp._associate_core(
            cams_d, f(poses[1]), f(T_SC), f(lm["hp"]), t(lm["mask"]), t(lm["init"]),
            t(out["tab_signs"]), t(out["tab_valid"]), t(out["xy"]), rays, t(out["mask"]),
            t(out["signs"]), cfg.map_match_radius, cfg.ransac_threshold_deg,
            cfg.matching_threshold, cfg.ransac_hypotheses, cfg.ransac_min_inliers, True, sampler)

    return a, b, match_and_ransac


def test_frame_associate_card_matches_cpu(cuda):
    """Tolerances: keypoints 1e-3 px (float32 reductions such as the
    response's std run in another order on the card), matches and RANSAC
    outcome equal. RANSAC pose: 1e-4 when map match + RANSAC run on
    identical inputs; 1e-3 m end to end, where the keypoints' last-bit
    differences pass through static-stereo depths (disparities of a few px)
    and a minimal P3P solve in float32 (2.6e-4 m measured on the H100)."""
    from okvis2_torch.cameras.pinhole import PinholeCamera
    from okvis2_torch.core.se3 import Transformation
    from okvis2_torch.imu.preintegration import ImuParameters
    from okvis2_torch.pipeline.dataset import SyntheticDataset

    cam = PinholeCamera.create(192, 128, 120.0, 120.0, 96.0, 64.0, device="cpu")
    ext = [Transformation(r=torch.tensor([x, 0.0, 0.0], dtype=torch.float64),
                          q=torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=torch.float64))
           for x in (0.0, 0.11)]
    ds = SyntheticDataset((cam, cam), ext, ImuParameters.create(g=9.81, device="cpu"),
                          n_stars=2500, duration=1.0, frame_rate=10.0, device="cpu")
    poses = np.stack([ds.ground_truth(t) for t in (0.0, 0.1)])
    imgs = [np.stack(ds.render(p)) for p in poses]
    n0 = harris_cuda.harris_nms_cuda.launches
    *card, redo = _track_two_frames(cuda, imgs, poses)
    torch.cuda.synchronize()
    assert harris_cuda.harris_nms_cuda.launches == n0 + 2
    *host, _ = _track_two_frames("cpu", imgs, poses)
    for g, c in zip(card, host):
        mask = c["mask"]
        assert torch.equal(g["mask"].cpu(), mask) and mask.sum(1).min() > 20
        assert (g["xy"].cpu()[mask] - c["xy"][mask]).abs().max() < 1e-3
    (_, gb), (_, cb) = card, host
    assert torch.equal(gb["keep"].cpu(), cb["keep"]) and int(cb["keep"].sum()) >= 20
    assert torch.equal(gb["idx"].cpu()[cb["keep"]], cb["idx"][cb["keep"]])
    assert bool(gb["ransac_ok"]) and bool(cb["ransac_ok"])
    assert int(gb["n_inl"]) == int(cb["n_inl"])
    assert int(gb["ms_total"]) == int(cb["ms_total"])
    assert int(gb["ff_total"]) == int(cb["ff_total"])
    assert (gb["T_WS7"].cpu() - cb["T_WS7"]).abs().max() < 1e-3
    # identical inputs: the card's frame-B outputs, copied to the CPU
    same = {k: gb[k].cpu() for k in ("xy", "mask", "signs", "tab_signs", "tab_valid")}
    rg, rc = redo(cuda, same), redo("cpu", same)
    for x, y in zip(rg[:3], rc[:3]):  # idx, ok, keep
        assert torch.equal(x.cpu(), y)
    assert int(rg[3]) == int(rc[3]) and bool(rg[4]) and bool(rc[4])
    assert (rg[5].cpu() - rc[5]).abs().max() < 1e-4


def _slam_system(device, pipelined=False, min_pending=0):
    """The SlamSystem on ``device`` (synchronous, or pipelined with
    ``min_pending`` frames kept in flight): float32 cameras of the small
    radtan rig at 192x128, 128 keypoints, an 8-state window, RANSAC
    hypotheses drawn per frame by a CPU generator seeded with the frame
    counter. ``slam.last_frames`` keeps each frame's frontend records."""
    from okvis2_torch.frontend.detection import DetectionConfig
    from okvis2_torch.graph.estimator import EstimatorConfig
    from okvis2_torch.imu.preintegration import ImuParameters
    from okvis2_torch.pipeline import frontend_pipeline as fp
    from okvis2_torch.pipeline.slam import SlamSystem
    from okvis2_torch.pipeline.synthetic_run import small_rig

    def sampler_for(counter):
        def sampler(mask, cam_idx, n_hyp, nc):
            gen = torch.Generator().manual_seed(counter)
            return fp.sample_hypotheses(gen, mask.cpu(), cam_idx.cpu(), n_hyp,
                                        nc).to(mask.device)
        return sampler

    cams, exts = small_rig(192, 128, dtype=torch.float32, device=device)
    slam = SlamSystem(
        cams, exts, ImuParameters.create(g=9.81, device=device),
        EstimatorConfig(window_slots=8, landmark_slots=192, obs_slots=1024,
                        imu_seg_capacity=64),
        fp.FrontendConfig(detection=DetectionConfig(max_keypoints=128)), pipelined=pipelined,
        device=device, ransac_sampler=sampler_for)
    slam._force_min_pending = min_pending
    finish = slam.frontend.finish_frame

    def finish_and_keep(*a, **kw):
        frames, m = finish(*a, **kw)
        slam.last_frames = frames
        return frames, m

    slam.frontend.finish_frame = finish_and_keep
    return slam


def _perturbed(problem, rel, gen):
    """``problem`` with every float leaf scaled by 1 + ``rel`` * N(0, 1)."""
    from okvis2_torch.solver.window_problem import WindowProblem

    def pert(x):
        if not x.is_floating_point():
            return x
        return x * (1 + rel * torch.randn(x.shape, generator=gen, dtype=x.dtype))

    return WindowProblem(**{f: getattr(problem, f).map(pert) if f == "imu_pre"
                            else pert(getattr(problem, f)) for f in WindowProblem._FIELDS})


def _landmarks_by_obs(est):
    """{sorted observation keys (state, cam, keypoint): landmark id}: the
    same landmark in two runs, whatever id each gave it."""
    return {tuple(sorted(tuple(int(x) for x in o) for o in lm.obs)): lid
            for lid, lm in est.landmarks.items()}


def _describe_split(card, host, keys):
    """Where the runs' maps part: each landmark only one run has, with its
    keypoints in both runs' current frame and their descriptor bits.
    ``keys``: {"card": {observation keys: landmark id}, "CPU": {...}}."""
    lines = []
    for side, slam, other in (("card", card, host), ("CPU", host, card)):
        for k in keys[side]:
            lm = slam.estimator.landmarks[keys[side][k]]
            parts = [f"{side}-only landmark {keys[side][k]} (hp {np.round(lm.hp_W, 4)}, "
                     f"initialised {lm.initialised}) observed at {list(k)}"]
            for (sid, c, kp) in k:
                if sid != slam.tracking.id:
                    continue
                fa, fb = slam.last_frames[c], other.last_frames[c]
                sa, sb = (torch.as_tensor(f["stacked"]["signs"][c][kp]).cpu() for f in (fa, fb))
                parts.append(
                    f"cam {c} kp {kp}: xy {fa['xy'][kp].tolist()} here, "
                    f"{fb['xy'][kp].tolist()} in the other run (mask {bool(fb['mask'][kp])}), "
                    f"{int((sa != sb).sum())} descriptor bits differ")
            lines.append("; ".join(parts))
    return "\n".join(lines)


def _small_drive_frames():
    """The 10 frames (uint8) and IMU samples of the small drive: the star
    dataset at 192x128, 4 Hz, 2.5 s."""
    from okvis2_torch.imu.preintegration import ImuParameters
    from okvis2_torch.pipeline.dataset import SyntheticDataset
    from okvis2_torch.pipeline.synthetic_run import small_rig

    cams, exts = small_rig(192, 128, dtype=torch.float64, device="cpu")
    ds = SyntheticDataset(cams, exts, ImuParameters.create(g=9.81, device="cpu"),
                          n_stars=1500, duration=2.5, frame_rate=4.0, device="cpu")
    frames, imu = [], []
    for ev in ds.stream():
        if ev[0] == "imu":
            imu.append(ev[1:])
        else:
            frames.append((ev[1], np.stack([(np.clip(im, 0.0, 1.0) * 255.0 + 0.5)
                                            .astype(np.uint8) for im in ev[2]])))
    return frames, imu


def _drive(slam, frames, imu):
    """Feed ``frames`` and ``imu`` through ``slam`` as the bench does; drain
    a pipelined loop. Returns {sid: (pose, keyframe flag)} from the
    (lagged, in the pipelined loop) callbacks."""
    recs = {}
    slam.set_optimised_graph_callback(
        lambda t, sid, pose, tr: recs.__setitem__(sid, (pose, tr.is_keyframe)))
    ii = 0
    for t, imgs in frames:
        while ii < len(imu) and imu[ii][0] <= t + 1e-9:
            slam.add_imu_measurement(*imu[ii])
            ii += 1
        slam.add_images(t, list(imgs))
        slam.process_frame()
    slam.finish()
    return recs


def _spread(a, b):
    """Largest position difference between two runs' per-frame poses."""
    assert a.keys() == b.keys()
    return max(float(np.abs(a[s][0][:3] - b[s][0][:3]).max()) for s in a)


def test_pipelined_loop_on_card(cuda, monkeypatch):
    """The pipelined loop on the card, two frames kept in flight (every
    solve from the third frame on appends three sets), on the small drive.

    Its fused solves on identical inputs: each solve the card ran, with
    its inputs, is solved again in float64 on the card and on the CPU:
    poses within 1e-8, landmark points within 1e-6 m, equal LM iterations
    (test_slam_loop_card_matches_cpu's bars). Run to run: the drive run twice on the
    card gives equal keyframe flags and poses within the run-to-run spread
    that the synchronous loop shows on the same card (two runs of it, here;
    0 when both loops are deterministic)."""
    from okvis2_torch.graph import estimator as est_mod
    from okvis2_torch.solver.packed_solve import decode_solved, solve_packed_fused

    frames, imu = _small_drive_frames()
    solves = []

    def fused_and_keep(problem, aux, sets, diag, cameras, imu_params, config):
        out = solve_packed_fused(problem, aux, sets, diag, cameras, imu_params, config)
        if out.is_cuda:
            solves.append(((problem.to(device="cpu"), {k: v.cpu() for k, v in aux.items()},
                            tuple(tuple(x.cpu() for x in m) for m in sets), diag.cpu()),
                           config, out.cpu()))
        return out

    monkeypatch.setattr(est_mod, "solve_packed_fused", fused_and_keep)
    n0 = harris_cuda.harris_nms_cuda.launches
    pipe = [_slam_system(cuda, pipelined=True, min_pending=2) for _ in range(2)]
    runs = [_drive(s, frames, imu) for s in pipe]
    assert harris_cuda.harris_nms_cuda.launches - n0 == 2 * len(frames) == 20
    assert len(solves) == 2 * len(frames)
    monkeypatch.setattr(est_mod, "solve_packed_fused", solve_packed_fused)
    sync = [_drive(_slam_system(cuda), frames, imu) for _ in range(2)]
    for r in runs + sync:
        assert len(r) == len(frames)
    assert [runs[0][s][1] for s in sorted(runs[0])] == [runs[1][s][1] for s in sorted(runs[1])]
    spread_pipe, spread_sync = _spread(*runs), _spread(*sync)
    print(f"run-to-run spread on the card: pipelined {spread_pipe:.3e} m, synchronous "
          f"{spread_sync:.3e} m")
    assert spread_pipe <= max(spread_sync, 1e-12), (spread_pipe, spread_sync)

    est = pipe[0].estimator
    S, L = est.cfg.window_slots, est.cfg.landmark_slots
    f64 = torch.float64
    cams_cpu = tuple(c.to(device="cpu", dtype=f64) for c in est.cameras)
    imu_cpu = est.imu_params.to(device="cpu", dtype=f64)
    pts = lambda hp: hp[:, :3] / np.where(np.abs(hp[:, 3:]) > 1e-9, hp[:, 3:], 1.0)  # noqa: E731
    worst = [0.0, 0.0]
    n_three = 0
    for (problem, aux, sets, diag), config, _ in solves[:len(frames)]:
        n_three += int((aux["maps"] >= 0).any(dim=1).sum()) == 3
        to64 = lambda x: x.to(f64) if x.is_floating_point() else x  # noqa: E731
        args64 = (problem.to(dtype=f64), {k: to64(v) for k, v in aux.items()},
                  tuple(tuple(to64(x) for x in m) for m in sets), diag.to(f64))
        ref = solve_packed_fused(*args64, cams_cpu, imu_cpu, config)
        got = solve_packed_fused(
            args64[0].to(device=cuda), {k: v.to(cuda) for k, v in args64[1].items()},
            tuple(tuple(x.to(cuda) for x in m) for m in args64[2]), args64[3].to(cuda),
            tuple(c.to(dtype=f64) for c in est.cameras), est.imu_params.to(dtype=f64), config)
        (pa, _, la, _, sa), (pb, _, lb, _, sb) = (decode_solved(x[:est.solve_out_size()], S, L, 2)
                                                  for x in (got, ref))
        assert sa["iterations"] == sb["iterations"] and sa["n_obs"] == sb["n_obs"]
        worst = [max(worst[0], float(np.abs(pa - pb).max())),
                 max(worst[1], float(np.abs(pts(la) - pts(lb)).max()))]
    print(f"fused solves on identical inputs, card vs CPU in float64: poses {worst[0]:.3e}, "
          f"landmark points {worst[1]:.3e} m; {n_three} of {len(frames)} appended three "
          "non-empty sets")
    assert worst[0] < 1e-8 and worst[1] < 1e-6, worst
    # the first frames are dispatched before any frame is finished, against
    # an empty map; later solves append three frames' matches
    assert n_three >= 3, n_three


@pytest.mark.parametrize("min_pending", [0, 2])
def test_device_replay_equals_live_on_card(cuda, min_pending):
    """The frame capture and its device-loop replay on the card
    (``pipeline/device_replay.py``): the small drive through the pipelined
    loop at its own lag and with two frames kept in flight, RANSAC drawing
    from the frontend's generator on the card, then every record replayed
    inline on the current stream in the three modes. The first full pass
    equals the live [solve output | diag] (solved on the solve worker's
    stream) bit for bit, the second pass the first, the frontend mode's
    diagnostics the live ones, the solve mode the full mode; one Harris
    launch per frame in the timed pass of modes full and frontend, none in
    mode solve; the system unchanged; no host<->device copy of 1 KB or more
    in a profiled pass."""
    import chip_smoke
    from okvis2_torch.pipeline import device_replay as dr

    frames, imu = _small_drive_frames()
    slam = _slam_system(cuda, pipelined=True, min_pending=min_pending)
    slam.frontend.ransac_sampler = None
    slam._bench_record = []
    _drive(slam, frames, imu)
    records = slam._bench_record
    assert len(records) == len(frames)
    before = chip_smoke.system_state(slam)
    res = {mode: dr.replay_device_loop(slam, records, n_pass=1, mode=mode,
                                       census=2 if mode == "full" else 0)
           for mode in dr.MODES}
    chip_smoke.assert_same_state(before, chip_smoke.system_state(slam))
    for i, r in enumerate(records):
        live = dr.live_output(r)
        got = res["full"]["first"][i].cpu().numpy()
        assert np.array_equal(got, live), (i, np.abs(got - live).max())
        for mode in dr.MODES:
            assert torch.equal(res[mode]["outputs"][i], res[mode]["first"][i]), (mode, i)
        assert torch.equal(res["frontend"]["first"][i], r["diag"]), i
        assert torch.equal(res["solve"]["first"][i], res["full"]["first"][i]), i
    assert res["full"]["harris_launches"] == res["frontend"]["harris_launches"] == len(frames)
    assert res["solve"]["harris_launches"] == 0
    tr = res["full"]["transfers"]
    print(f"replay on the card, {min_pending} kept in flight: frames/s " + ", ".join(
        f"{m} {res[m]['fps']:.3f}" for m in dr.MODES) + f"; per frame {tr['copies_per_frame']:g} "
        f"copies, {tr['syncs_per_frame']:g} synchronisations: {tr['copies']} {tr['syncs']}")
    assert tr["max_copy_bytes"] < 1024, tr


def test_pipelined_solve_error_reaches_caller(cuda, monkeypatch):
    """A failing fused solve on the card raises in the loop's thread (at the
    frame's finish); nothing runs the solve another way."""
    from okvis2_torch.graph import estimator as est_mod
    from okvis2_torch.solver.packed_solve import solve_packed_fused

    calls = []

    def fail_third(*a):
        calls.append(1)
        if len(calls) == 3:
            raise RuntimeError("fused solve failed")
        return solve_packed_fused(*a)

    monkeypatch.setattr(est_mod, "solve_packed_fused", fail_third)
    frames, imu = _small_drive_frames()
    with pytest.raises(RuntimeError, match="fused solve failed"):
        _drive(_slam_system(cuda, pipelined=True), frames[:5], imu)


def test_slam_loop_card_matches_cpu(cuda, monkeypatch):
    """Ten frames of the synchronous loop on the card and on the CPU in
    lockstep, on the same uint8 frames, IMU and RANSAC draws; the drive
    converts keyframes into pose-graph factors. Both runs are float32.

    End to end: the same keyframe flags on every frame; frames 0-1, before
    a landmark can part the maps, poses within 1e-4 m and equal landmark
    counts. After that the runs part where a descriptor bit ties to
    rounding and goes the other way on the card (the test prints the first
    landmark that parts the maps, with the keypoints and bits behind it),
    and a float32 window solve of these frames (10 LM iterations, not
    converged) moves by millimetres in poses and centimetres in landmarks
    when its inputs change by 1e-7 of their size, on the CPU alone. So every
    window solve of the card run is held on identical inputs in float64:
    its packed problem solved on the card and on the CPU gives poses within
    1e-8 and landmark points within 1e-6 m, with the same LM iteration
    count; a 1e-15 relative change of the inputs moves these float64 solves
    by ~1e-11 on the CPU. The test prints both sensitivities beside the
    card-CPU differences in float32 and float64."""
    from okvis2_torch.graph import estimator as est_mod
    from okvis2_torch.solver.packed_solve import decode_solved

    frames, imu = _small_drive_frames()
    solves, solve = [], est_mod.solve_packed

    def solve_and_keep(problem, cameras, imu_params, config):
        out = solve(problem, cameras, imu_params, config)
        if out.is_cuda:
            solves.append((problem.to(device="cpu"), config, out.cpu()))
        return out

    monkeypatch.setattr(est_mod, "solve_packed", solve_and_keep)
    card, host = _slam_system(cuda), _slam_system("cpu")
    n0 = harris_cuda.harris_nms_cuda.launches
    ii, split = 0, None
    d_pos, d_lms = [], []
    for f, (t, imgs) in enumerate(frames):
        while ii < len(imu) and imu[ii][0] <= t + 1e-9:
            for s in (card, host):
                s.add_imu_measurement(*imu[ii])
            ii += 1
        for s in (card, host):
            s.add_images(t, list(imgs))
            s.process_frame()
        assert card.tracking.is_keyframe == host.tracking.is_keyframe, f"frame {f}"
        pc, ph = (s.estimator.states[s.tracking.id].pose for s in (card, host))
        d_pos.append(float(np.abs(pc[:3] - ph[:3]).max()))
        d_lms.append(len(card.estimator.landmarks) - len(host.estimator.landmarks))
        kc, kh = _landmarks_by_obs(card.estimator), _landmarks_by_obs(host.estimator)
        if split is None and kc.keys() != kh.keys():
            split = f"frame {f}:\n" + _describe_split(
                card, host, {"card": {k: v for k, v in kc.items() if k not in kh},
                             "CPU": {k: v for k, v in kh.items() if k not in kc}})
    print(f"card vs CPU, per frame: pose difference {d_pos} m, landmark count difference "
          f"{d_lms}; first landmark that parts the maps: {split}")
    assert harris_cuda.harris_nms_cuda.launches - n0 == len(frames) == 10
    assert max(d_pos[:2]) < 1e-4 and d_lms[:2] == [0, 0], (d_pos, d_lms)

    S, L = card.estimator.cfg.window_slots, card.estimator.cfg.landmark_slots
    assert len(solves) == len(frames)
    pts = lambda hp: hp[:, :3] / np.where(np.abs(hp[:, 3:]) > 1e-9, hp[:, 3:], 1.0)  # noqa: E731
    f64, gen = torch.float64, torch.Generator().manual_seed(0)
    h_cams = host.estimator.cameras
    h_cams64 = tuple(c.to(dtype=f64) for c in h_cams)
    h_imu = host.estimator.imu_params
    h_imu64 = h_imu.to(dtype=f64)
    # (poses, landmark points): card vs CPU in float32 and in float64, and
    # the CPU solve's change when its inputs change by 1e-7 and 1e-15
    worst = {k: [0.0, 0.0] for k in ("f32", "f64", "f32 sens", "f64 sens")}
    for problem, config, out in solves:
        p64 = problem.to(dtype=f64)
        ref64 = solve(p64, h_cams64, h_imu64, config)
        got64 = solve(p64.to(device=cuda), tuple(c.to(dtype=f64) for c in card.estimator.cameras),
                      card.estimator.imu_params.to(dtype=f64), config)
        ref32 = solve(problem, h_cams, h_imu, config)
        pairs = {"f32": (out, ref32), "f64": (got64, ref64),
                 "f32 sens": (solve(_perturbed(problem, 1e-7, gen), h_cams, h_imu, config), ref32),
                 "f64 sens": (solve(_perturbed(p64, 1e-15, gen), h_cams64, h_imu64, config),
                              ref64)}
        for k, (a, b) in pairs.items():
            (pa, _, la, _, sa), (pb, _, lb, _, sb) = (decode_solved(x, S, L, 2) for x in (a, b))
            worst[k][0] = max(worst[k][0], float(np.abs(pa - pb).max()))
            worst[k][1] = max(worst[k][1], float(np.abs(pts(la) - pts(lb)).max()))
            if k == "f64":
                assert sa["iterations"] == sb["iterations"]
    print("window solves on identical inputs, card vs CPU, and the CPU's sensitivity to its "
          "inputs (largest pose, landmark point difference): "
          + ", ".join(f"{k} {v[0]:.3e} {v[1]:.3e}" for k, v in worst.items()))
    assert worst["f64"][0] < 1e-8 and worst["f64"][1] < 1e-6, worst
    est = card.estimator
    assert len(est.landmarks) > 50
    assert len(est.window) <= 8
    # at 4 Hz keyframes come often: the marginalisation makes pose-graph
    # factors on the card (2 in this drive on the CPU)
    assert len(est.pose_graph_edges) >= 1


def _loop_closure_drive(device, n_frames=9):
    """tests/test_torch_closure_drive_sync.py's drive (one circle at 6 Hz
    at 192x128, f = 120, its first 9 frames, place recognition with
    exclude_recent=2 and no drift budget), float32 cameras on ``device``
    (the Harris kernel takes float32), RANSAC hypotheses from a CPU
    generator seeded with the frame or verification counter (the JAX draws
    of the CPU test need JAX). Returns (closure frames, loop
    edges, {sid: pose}, the system)."""
    from okvis2_torch.frontend.detection import DetectionConfig
    from okvis2_torch.graph.estimator import EstimatorConfig
    from okvis2_torch.imu.preintegration import ImuParameters
    from okvis2_torch.pipeline import frontend_pipeline as fp
    from okvis2_torch.pipeline.dataset import SyntheticDataset
    from okvis2_torch.pipeline.full_graph import LoopClosureConfig
    from okvis2_torch.pipeline.slam import SlamSystem
    from okvis2_torch.pipeline.synthetic_run import small_rig

    def sampler_for(counter):
        def sampler(mask, cam_idx, n_hyp, nc):
            gen = torch.Generator().manual_seed(counter)
            return fp.sample_hypotheses(gen, mask.cpu(), cam_idx.cpu(), n_hyp,
                                        nc).to(mask.device)
        return sampler

    cams, exts = small_rig(192, 128, f=120.0, dtype=torch.float32, device=device)
    imu = ImuParameters.create(g=9.81, device=device)
    slam = SlamSystem(cams, exts, imu,
                      EstimatorConfig(window_slots=8, landmark_slots=192, obs_slots=1024,
                                      imu_seg_capacity=64, num_keyframes=2),
                      fp.FrontendConfig(detection=DetectionConfig(max_keypoints=128)),
                      do_loop_closures=True,
                      loop_closure_config=LoopClosureConfig(exclude_recent=2,
                                                            check_drift_budget=False),
                      device=device, ransac_sampler=sampler_for, loop_ransac_sampler=sampler_for)
    ds = SyntheticDataset(cams, exts, imu, n_stars=1500, duration=5.0, frame_rate=6.0,
                          trajectory="circle", device=device)
    poses, closures, n = {}, [], 0
    slam.set_optimised_graph_callback(lambda t, sid, pose, tr: poses.__setitem__(sid, pose))
    lb = slam.loop_backend
    for ev in ds.stream():
        if ev[0] == "imu":
            slam.add_imu_measurement(ev[1], ev[2], ev[3])
            continue
        if n == n_frames:
            break
        slam.add_images(ev[1], ev[2])
        n0 = lb.num_loop_closures
        slam.process_frame()
        closures += [n] * (lb.num_loop_closures - n0)
        n += 1
    slam.finish()
    edges = [(e.id_i, e.id_j) for e in slam.estimator.pose_graph_edges if e.kind == "loop"]
    return closures, edges, poses, slam


def test_loop_closure_drive_on_card(cuda, monkeypatch):
    """The synchronous closure drive on the card, run twice: the same
    closures on the same frames with the same loop edges, and the same
    poses (spread 0 m: the solves have no atomics). Then the first
    closure's full-graph pack, in float64, solved on the card and on the
    CPU gives poses within 1e-8 and the same LM iterations."""
    from okvis2_torch.pipeline import full_graph as fg

    packs, solve = [], fg._solve_full_graph

    def solve_and_keep(prob, cameras, imu_params, config):
        packs.append((prob.to(device="cpu"), config))
        return solve(prob, cameras, imu_params, config)

    monkeypatch.setattr(fg, "_solve_full_graph", solve_and_keep)
    c1, e1, p1, slam = _loop_closure_drive(cuda)
    c2, e2, p2, _ = _loop_closure_drive(cuda)
    print(f"card runs: closures {c1} / {c2}, loop edges {e1} / {e2}, spread {_spread_poses(p1, p2)}")
    assert c1 == c2 and len(c1) >= 1 and e1 == e2
    assert _spread_poses(p1, p2) == 0.0
    assert len(packs) == 2 * len(c1)
    f64 = torch.float64
    prob, config = packs[0]
    prob = prob.to(dtype=f64)
    cams, imu = slam.loop_backend.cameras, slam.estimator.imu_params
    ref = solve(prob, tuple(c.to(device="cpu", dtype=f64) for c in cams),
                imu.to(device="cpu", dtype=f64), config).numpy()
    got = solve(prob.to(device=cuda), tuple(c.to(dtype=f64) for c in cams), imu.to(dtype=f64),
                config).cpu().numpy()
    S = prob.S
    d_pose = float(np.abs(got[:S * 7] - ref[:S * 7]).max())
    print(f"full-graph solve, float64, card vs CPU: poses within {d_pose:.3e}")
    assert d_pose < 1e-8 and got[-1] == ref[-1]


def _spread_poses(a, b):
    assert a.keys() == b.keys()
    return max(float(np.abs(a[s][:3] - b[s][:3]).max()) for s in a)


def test_refine_pose_hessian_card_matches_cpu(cuda):
    """The loop verification's pose refine on identical float64 inputs (40
    noisy bearings in two cameras): the card against the CPU, pose within
    1e-8, H and the sqrt information within 1e-8 of their largest entries."""
    from okvis2_torch.frontend.pose_refine import refine_pose_hessian

    rng = np.random.default_rng(0)
    pts = rng.uniform(-2, 2, (40, 3)) + [0, 0, 6]
    T_SC = np.array([[0, 0, 0, 0, 0, 0, 1.0], [0.11, 0, 0, 0, 0, 0, 1.0]])
    cam = rng.integers(0, 2, 40)
    rays = pts - T_SC[cam, :3] + rng.normal(0, 2e-3, (40, 3))
    rays /= np.linalg.norm(rays, axis=1, keepdims=True)
    T_SW = np.array([0.05, -0.02, 0.01, 0.01, 0.02, -0.01, 1.0])
    T_SW[3:] /= np.linalg.norm(T_SW[3:])
    args = [torch.tensor(x) for x in (T_SW, pts, rays, cam, rng.random(40) > 0.2, T_SC)]
    ref = [x.numpy() for x in refine_pose_hessian(*args)]
    got = [x.cpu().numpy() for x in refine_pose_hessian(*(a.to(cuda) for a in args))]
    assert np.abs(got[0] - ref[0]).max() < 1e-8
    for a, b in zip(got[1:], ref[1:]):
        assert np.abs(a - b).max() < 1e-8 * np.abs(b).max()


@pytest.fixture(scope="module")
def closed_drive():
    """The synchronous closure drive on the card, finished (its loop closed
    at frame 8), for the multi-session tests below."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    closures, edges, _, slam = _loop_closure_drive(torch.device("cuda"))
    assert len(closures) >= 1 and edges
    return slam


def test_final_ba_card_matches_cpu(cuda, closed_drive, monkeypatch):
    """The closure drive's final BA on the card (``do_final_ba``, float32,
    10 LM iterations at 1024 landmark and 8192 observation slots): the
    marginalisation edges give their observations back, the loop edge
    stays, finite diagnostics, one heatmap per camera. Its pack, in
    float64, solved on the card and on the CPU from identical inputs:
    poses within 1e-8 m, landmarks (unit homogeneous vectors) within 1e-8,
    the same iterations."""
    from okvis2_torch.pipeline import final_ba as fba

    packs, solve = [], fba.solve_window

    def solve_and_keep(prob, *a):
        packs.append(prob.to(device="cpu"))
        return solve(prob, *a)

    monkeypatch.setattr(fba, "solve_window", solve_and_keep)
    est = closed_drive.estimator
    info = fba.do_final_ba(est, iterations=10, max_landmarks=1024, max_obs=8192)
    assert info["restored_observations"] > 0 and info["states"] > 4 and len(packs) == 1
    assert [e.kind for e in est.pose_graph_edges] == ["loop"]
    assert np.isfinite(info["reproj_rms_px"]) and info["reproj_heatmaps"].shape[0] == 2
    assert all(np.isfinite(info[k]).all() for k in ("bias_gyro_mean", "bias_accel_std"))
    f64, cfg = torch.float64, fba.SolverConfig(max_iterations=10)
    p64 = packs[0].to(dtype=f64)
    out = {}
    for dev in ("cpu", cuda):
        sol, st = solve(p64.to(device=dev), tuple(c.to(device=dev, dtype=f64) for c in est.cameras),
                        est.imu_params.to(device=dev, dtype=f64), cfg)
        out[str(dev)] = (sol.pose.cpu().numpy(), sol.landmarks.cpu().numpy(), st["iterations"])
    (pc, lc, ic), (pg, lg, ig) = out["cpu"], out[str(cuda)]
    unit = lambda hp: hp / np.linalg.norm(hp, axis=-1, keepdims=True)  # noqa: E731
    n_s, n_l = info["states"], info["landmarks"]
    d_pose = float(np.abs(pg[:n_s, :3] - pc[:n_s, :3]).max())
    d_hp = float(np.abs(unit(lg[:n_l]) - unit(lc[:n_l])).max())
    print(f"final BA, float64, card vs CPU: poses within {d_pose:.3e} m, landmarks {d_hp:.3e}; "
          f"iterations {ig} / {ic}; {n_s} states, {n_l} landmarks")
    assert d_pose < 1e-8 and d_hp < 1e-8 and ig == ic


def test_map_save_and_load_on_card(cuda, closed_drive, tmp_path):
    """The drive's map saved and loaded into a new system on the card: the
    table's device signs equal the file's descriptor bits, one slot per
    landmark with a descriptor, and the map registered for relocalisation."""
    from okvis2_torch.pipeline.component_io import load_component
    from okvis2_torch.pipeline.full_graph import LoopClosureBackend

    path = str(tmp_path / "drive.map")
    closed_drive.save_map(path)
    slam = _slam_system(cuda)
    slam.loop_backend = LoopClosureBackend(slam.frontend.cameras, slam.frontend.extrinsics,
                                           device=cuda)
    n = slam.load_map(path)
    data = load_component(path)
    assert n == len(data["landmarks"]) > 50
    words = {o["lid"]: o["descriptor"] for o in data["observations"] if "descriptor" in o}
    file_lid = list(data["landmarks"])
    table = slam.frontend.table
    assert len(table.slot_of) == len(words) > 10 and table.staged_count() == 0
    signs, valid = table.signs[:, 0].cpu().numpy(), table.valid[:, 0].cpu().numpy()
    for lid, s in table.slot_of.items():
        bits = (words[file_lid[lid]][:, None] >> np.arange(32, dtype=np.uint32)) & 1
        assert valid[s] and np.array_equal(signs[s] > 0, bits.reshape(-1) > 0), lid
    assert slam.loop_backend.has_components()


def test_depth_init_card_matches_cpu(cuda):
    """Depth-aided landmark initialisation on identical frames (the CPU
    frontend's keypoints and descriptors) on the card and on the CPU: the
    same landmarks within 1e-5 m (float32 back-projection), the same table
    slots and device signs."""
    from okvis2_torch.pipeline.dataset import SyntheticDataset

    pose0 = np.array([0.0, 0, 0, 0, 0, 0, 1.0])
    out = []
    frames_cpu = None
    for dev in ("cpu", cuda):
        slam = _slam_system(dev)
        est = slam.estimator
        sid = est.add_state(0.0, np.zeros((0, 3)), np.zeros((0, 3)), np.zeros(0))
        est.states[sid].pose = pose0
        if frames_cpu is None:
            ds = SyntheticDataset(slam.frontend.cameras, slam.frontend.extrinsics,
                                  est.imu_params, n_stars=1500, seed=11, device="cpu")
            imgs = ds.render(pose0)
        frames, _ = slam.frontend.associate_frame(est, imgs, sid, pose0)
        if frames_cpu is None:
            frames_cpu = frames
        else:  # the CPU frontend's keypoints and descriptors, on this device
            stacked = {k: v.to(dev) for k, v in frames_cpu[0]["stacked"].items()}
            frames = [dict(f, stacked=stacked) for f in frames_cpu]
        H, W = imgs[0].shape
        slam.add_depth_image(0.0, np.full((H, W), 4.0))
        n = slam._init_landmarks_from_depth(frames, sid)
        out.append((n, {lid: lm.hp_W.copy() for lid, lm in est.landmarks.items()},
                    dict(slam.frontend.table.slot_of), slam.frontend.table.signs.cpu().numpy()))
    (nc, lc, sc, gc), (ng, lg, sg, gg) = out
    assert ng == nc > 10 and lg.keys() == lc.keys() and sg == sc
    d = max(float(np.abs(lg[k] - lc[k]).max()) for k in lc)
    print(f"depth-aided init, card vs CPU: {ng} landmarks within {d:.3e} m")
    assert d < 1e-5
    np.testing.assert_array_equal(gg, gc)


WEIGHTS = "okvis2_tpu/models/weights/fast_scnn_synthetic.npz"


def test_fast_scnn_card_matches_cpu(cuda):
    """Fast-SCNN at 480x752 (padded to 512x768) on the card against the CPU
    port, float32 with TF32 off: logits within 1e-3 of their largest
    magnitude, class maps at least 99.9 % equal."""
    from okvis2_torch.models import fast_scnn as tfs
    from okvis2_torch.models.scenes import make_scene
    from okvis2_torch.models.suppression import CnnSuppressor

    img, _ = make_scene(np.random.default_rng(3), 480, 752)
    x = torch.from_numpy(img[..., 0])
    got = tfs.image_logits(CnnSuppressor(WEIGHTS, device=cuda).model(), x.to(cuda)).cpu()
    want = tfs.image_logits(CnnSuppressor(WEIGHTS, device="cpu").model(), x)
    assert got.shape == want.shape == (19, 480, 752)
    assert (got - want).abs().max() <= 1e-3 * want.abs().max()
    assert (got.argmax(0) == want.argmax(0)).double().mean() >= 0.999


def test_textured_world_card_matches_cpu(cuda):
    """The textured world rendered on the card against the CPU, at the
    bench's 752x480 rig: images within 1e-5, labels equal on at least
    99.9 % of the pixels."""
    from okvis2_torch.imu.preintegration import ImuParameters
    from okvis2_torch.pipeline import dataset as tds
    from okvis2_torch.pipeline.synthetic_run import small_rig

    out = {}
    for dev in (cuda, "cpu"):
        cams, exts = small_rig(752, 480, f=460.0, device=dev)
        ds = tds.TexturedWorldDataset(cams, exts, ImuParameters.create(g=9.81, device=dev),
                                      duration=1.0, frame_rate=4.0, device=dev)
        ds._frame_i = 2
        out[str(dev)] = ds.render_with_labels(ds.ground_truth(0.5))
    for (im_c, lab_c), (im_h, lab_h) in zip(out[str(cuda)], out["cpu"]):
        np.testing.assert_allclose(im_c, im_h, rtol=0, atol=1e-5)
        assert (lab_c == lab_h).mean() >= 0.999
        assert (lab_h == 10).any() and (lab_h == 11).any()


def test_sharded_solve_nccl_world_size_one(cuda, tmp_path):
    """solve_full_graph_sharded over NCCL at world size 1 against
    solve_window on the card, float64: poses within 1e-8 m, the same LM
    iterations, 4 collectives per iteration."""
    import datetime

    import torch.distributed as dist

    from okvis2_torch.parallel import make_mesh, shard_problem_by_landmark
    from okvis2_torch.parallel import solve_full_graph_sharded
    from okvis2_torch.solver.gauss_newton import solve_window
    from okvis2_torch.solver.window_problem import SolverConfig
    from okvis2_torch.utils import synthetic

    problem, cams, imu, _ = synthetic.build_problem(num_states=4, n_landmarks_side=5, device=cuda)
    problem = synthetic.disturb_problem(problem.replace(
        pose_frozen=torch.arange(problem.S, device=cuda) == 0))
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/rendezvous", world_size=1,
                            rank=0, timeout=datetime.timedelta(seconds=60))
    try:
        solved, stats = solve_full_graph_sharded(shard_problem_by_landmark(problem, 1), cams, imu,
                                                 make_mesh(1), SolverConfig(), n_iterations=5)
    finally:
        dist.destroy_process_group()
    ref, ref_stats = solve_window(problem, cams, imu, SolverConfig(max_iterations=5))
    assert stats["iterations"] == ref_stats["iterations"]
    assert stats["collectives"] == 4 * stats["iterations"] + 2
    assert (solved.pose[:, :3] - ref.pose[:, :3]).abs().max() < 1e-8


EUROC_YAML = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "configs",
                          "euroc.yaml")


def _euroc_folder(folder, n_frames):
    """The first ``n_frames`` of chip_smoke.py's phase-14 EuRoC folder
    (configs/euroc.yaml's rig); returns the uint8 images."""
    from chip_smoke import write_app_folder

    return write_app_folder(folder, n_frames)[1]


def test_config_reader_on_card(cuda):
    from okvis2_torch.config import read_config_file

    card, host = read_config_file(EUROC_YAML), read_config_file(EUROC_YAML, device="cpu")
    for a, b in zip(card.cameras, host.cameras):
        assert a.camera.focal.device.type == "cuda" and a.camera.focal.dtype == torch.float32
        assert a.camera.image_size == b.camera.image_size == (752, 480)
        assert torch.equal(a.camera.focal.cpu(), b.camera.focal)
        assert torch.equal(a.camera.distortion.params().cpu(), b.camera.distortion.params())
        assert torch.equal(a.T_SC.r.cpu(), b.T_SC.r)
        assert torch.allclose(a.T_SC.q.cpu(), b.T_SC.q, rtol=0, atol=1e-7)
    assert card.imu.params.g.device.type == "cuda"


def test_png_round_trip_at_euroc_size(cuda, tmp_path):
    from okvis2_torch.pipeline import png
    from okvis2_torch.pipeline.dataset import EurocDatasetReader

    images = _euroc_folder(str(tmp_path), 2)
    frames = [e for e in EurocDatasetReader(str(tmp_path), 2).stream() if e[0] == "images"]
    assert len(frames) == 2
    for (_, _, got), want in zip(frames, images):
        for g, w in zip(got, want):
            assert g.shape == (480, 752) and np.array_equal(g, w.astype(np.float32) / 255.0)
    name = sorted(os.listdir(tmp_path / "mav0" / "cam0" / "data"))[0]
    assert png.read_png(str(tmp_path / "mav0" / "cam0" / "data" / name)).dtype == np.uint8


def test_app_five_frames_on_card(cuda, tmp_path):
    """``app_synchronous.main`` on the card (``device`` left at None): one
    Harris launch per frame per octave, a CSV row per state."""
    from okvis2_torch.apps import app_synchronous

    _euroc_folder(str(tmp_path / "euroc"), 5)
    n0 = harris_cuda.harris_nms_cuda.launches
    res = app_synchronous.main([EUROC_YAML, str(tmp_path / "euroc"), "--output-dir",
                                str(tmp_path / "out"), "--sync", "--max-frames", "5"])
    torch.cuda.synchronize()
    slam = res["slam"]
    assert slam.device.type == "cuda" and res["frames"] == 5
    n_oct = slam.frontend.cfg.detection.octaves
    assert harris_cuda.harris_nms_cuda.launches - n0 == 5 * n_oct
    rows = np.loadtxt(res["output"], delimiter=",", skiprows=1, ndmin=2)
    assert rows.shape == (5, 8) and np.isfinite(rows).all()


def test_bag_replay_card_matches_cpu(cuda, tmp_path, monkeypatch, capsys):
    """``nodes.main_synchronous`` (the ROS2 node's bag replay, ``device``
    left at None) on a rosbag2 .db3 bag of the first 5 frames of phase 14's
    folder at configs/euroc.yaml, and the same run on the CPU in float32:
    the printed line, one Harris launch per frame per octave on the card and
    none on the CPU, the same keyframe flags on every frame, frames 0-1
    (before a descriptor bit that ties to rounding can part the maps, see
    ``test_slam_loop_card_matches_cpu``) within 1e-4 m with equal landmark
    counts, every frame within 0.05 m."""
    from chip_smoke import write_rosbag
    from okvis2_torch.pipeline import slam as slam_mod
    from okvis2_torch.ros2 import nodes

    _euroc_folder(str(tmp_path / "euroc"), 5)
    bag = str(tmp_path / "euroc.db3")
    write_rosbag(str(tmp_path / "euroc"), bag, "sqlite3")
    runs = {}

    class Tracked(slam_mod.SlamSystem):
        def process_frame(self):
            out = super().process_frame()
            est = self.estimator
            runs[self.device.type].append((self.tracking.is_keyframe,
                                           np.array(est.states[self.tracking.id].pose),
                                           len(est.landmarks)))
            return out

    monkeypatch.setattr(slam_mod, "SlamSystem", Tracked)
    printed, launches = {}, {}
    for device in (None, "cpu"):
        name = "cpu" if device else "cuda"
        runs[name] = []
        n0 = harris_cuda.harris_nms_cuda.launches
        assert nodes.main_synchronous([EUROC_YAML, bag, "--max-frames", "5"], device=device) == 0
        torch.cuda.synchronize()
        launches[name] = harris_cuda.harris_nms_cuda.launches - n0
        printed[name] = capsys.readouterr().out.strip().splitlines()[-1]
    card, host = runs["cuda"], runs["cpu"]
    d_pos = [float(np.abs(a[1][:3] - b[1][:3]).max()) for a, b in zip(card, host)]
    print(f"card vs CPU per frame: pose difference {d_pos} m, landmarks "
          f"{[a[2] for a in card]} / {[b[2] for b in host]}")
    assert len(card) == len(host) == 5
    assert printed["cuda"] == f"processed 5 frames, {card[-1][2]} landmarks"
    assert printed["cpu"] == f"processed 5 frames, {host[-1][2]} landmarks"
    assert launches == {"cuda": 5, "cpu": 0}, launches  # configs/euroc.yaml: one octave
    assert [a[0] for a in card] == [b[0] for b in host]
    assert max(d_pos[:2]) < 1e-4 and [a[2] for a in card[:2]] == [b[2] for b in host[:2]]
    assert max(d_pos) < 0.05


def test_dense_path_solve_repeats_on_card(cuda, monkeypatch):
    """A float32 solve on the dense path (the full graph's and the final
    BA's), run twice on the card and once more on a side stream: poses and
    landmarks equal bit for bit (the per-landmark sums run in an order the
    code fixes; ``index_add_``'s atomics did not)."""
    from okvis2_torch.solver import gauss_newton as tgn
    from okvis2_torch.solver.window_problem import SolverConfig
    from okvis2_torch.utils import synthetic as tsyn

    problem, cams, imu, _ = tsyn.build_problem(num_states=8, n_landmarks_side=14, device=cuda)
    frozen = torch.zeros(problem.S, dtype=torch.bool, device=cuda)
    frozen[0] = True
    f32 = torch.float32
    prob = tsyn.disturb_problem(problem.replace(pose_frozen=frozen)).to(dtype=f32)
    cams = tuple(c.to(dtype=f32) for c in cams)
    imu = imu.to(dtype=f32)
    monkeypatch.setattr(tgn, "TABLE_MAX_ENTRIES", 0)
    cfg = SolverConfig(max_iterations=10)
    runs = [tgn.solve_window(prob, cams, imu, cfg) for _ in range(2)]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        runs.append(tgn.solve_window(prob, cams, imu, cfg))
    torch.cuda.synchronize()
    (a, sa), *rest = runs
    for b, sb in rest:
        assert sb["iterations"] == sa["iterations"]
        assert torch.equal(a.pose, b.pose) and torch.equal(a.landmarks, b.landmarks)


def test_fast_scnn_training_step_card_matches_cpu(cuda):
    """One float64 training step (``train_synthetic.train_step``: loss,
    gradients of the weights and BatchNorm statistics, Adam) on the card
    and on the CPU from the same variables and batch (2 x 64 x 128): each
    within 1e-8 of its largest magnitude."""
    from okvis2_torch.models import fast_scnn as tfs
    from okvis2_torch.models import train_synthetic as ttr

    torch.manual_seed(0)
    base = tfs.FastSCNN().double()
    rng = np.random.default_rng(0)
    imgs = torch.from_numpy(rng.uniform(0, 1, (2, 3, 64, 128)))
    labs = torch.from_numpy(rng.choice(np.array([2, 10, 11]), (2, 64, 128)))
    out = {}
    for dev in ("cpu", cuda):
        model = ttr.trainable_model(base).to(dev)
        opt = torch.optim.Adam(model.parameters(), lr=1e-3, eps=1e-8)
        loss = float(ttr.train_step(model, opt, imgs.to(dev), labs.to(dev)))
        out[str(dev)] = (loss, {n: (p.grad.cpu(), p.detach().cpu())
                                for n, p in model.named_parameters()})
    (lc, c), (lg, g) = out["cpu"], out[str(cuda)]
    assert abs(lg - lc) <= 1e-8 * abs(lc)
    for n in c:
        for a, b in zip(g[n], c[n]):
            assert float((a - b).abs().max()) <= 1e-8 * max(float(b.abs().max()), 1e-300), n


def test_native_loader_on_card_machine(cuda, tmp_path):
    """The EuRoC prefetcher built with this machine's host compiler and
    read on 3 frames of phase 14's folder: ``open_euroc`` gives the native
    reader, its stream equals the Python reader's bit for bit."""
    from chip_smoke import compare_streams
    from okvis2_torch.pipeline import native_loader
    from okvis2_torch.pipeline.dataset import EurocDatasetReader

    _euroc_folder(str(tmp_path), 3)
    reader = native_loader.open_euroc(str(tmp_path), 2)
    assert isinstance(reader, native_loader.NativeEurocReader)
    counts = compare_streams(reader.stream(), EurocDatasetReader(str(tmp_path), 2).stream())
    assert counts["images"] == 3 and (reader.width, reader.height) == (752, 480)
