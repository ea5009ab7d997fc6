"""The JAX package's side of chip_smoke.py's phase 7, on the CPU: the same
21 synthetic frames (the bench's rig, SyntheticDataset with 2500 stars,
seed 0, 20 Hz, IMU at 200 Hz), tracked by the JAX package's fused frame
program with the same host glue (frame 0 seeds the map by static stereo
at its true pose; frames 1-20 are predicted from the previous RANSAC pose
with propagate_state_np and tracked against frame 0 as the keyframe), at
the bench's width: 752x480, 512 keypoints, map capacity 1024, 128
hypotheses, float32. Prints each frame's RANSAC outcome and pose error
against ground truth, then the largest errors as JSON.

    env JAX_PLATFORMS=cpu python tools/tracking_reference_jax.py [n_tracked]

The JAX program does not return its RANSAC pose; this script recomputes it
with the program's own key (frontend_pipeline.py:241) from the same
correspondences, through _associate_device and ransac_rig_pose.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv):
    n_track = int(argv[1]) if len(argv) > 1 else 20
    import jax
    import jax.numpy as jnp
    import numpy as np

    from okvis2_tpu.cameras.distortion import RadialTangentialDistortion
    from okvis2_tpu.cameras.pinhole import PinholeCamera
    from okvis2_tpu.core import se3_np
    from okvis2_tpu.core.se3 import Transformation
    from okvis2_tpu.frontend.detection import DetectionConfig
    from okvis2_tpu.frontend.p3p import ransac_rig_pose
    from okvis2_tpu.imu.preintegration import ImuParameters, propagate_state_np
    from okvis2_tpu.pipeline import frontend_pipeline as fp
    from okvis2_tpu.pipeline.dataset import SyntheticDataset
    from okvis2_tpu.utils.synthetic import true_state

    W, H = 752, 480
    cam = PinholeCamera.create(W, H, 460.0, 460.0, W / 2.0, H / 2.0,
                               RadialTangentialDistortion.from_params([-0.05, 0.01, 0.0, 0.0]))
    cams = (cam, cam)
    T_SC = np.array([[0, 0, 0, 0, 0, 0, 1.0], [0.11, 0, 0, 0, 0, 0, 1.0]], np.float32)
    exts = [Transformation(r=jnp.asarray(T[:3]), q=jnp.asarray(T[3:])) for T in T_SC]
    imu = ImuParameters.create(g=9.81)
    ds = SyntheticDataset(cams, exts, imu, n_stars=2500, duration=(n_track + 1) / 20.0,
                          frame_rate=20.0, imu_rate=200.0, seed=0)
    frames, imu_t, imu_a, imu_w = [], [], [], []
    for ev in ds.stream():
        if ev[0] == "imu":
            imu_t.append(ev[1]); imu_a.append(ev[2]); imu_w.append(ev[3])
        else:
            frames.append((ev[1], np.stack([(np.clip(im, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
                                            for im in ev[2]]), np.asarray(ev[3], np.float64)))
    imu_t, imu_a, imu_w = (np.asarray(x, np.float64) for x in (imu_t, imu_a, imu_w))

    cfg = fp.FrontendConfig(detection=DetectionConfig(max_keypoints=512), map_match_capacity=1024,
                            ransac_hypotheses=128)
    NC, N, B, KF, cap = 2, 512, 512, cfg.motion_stereo_keyframes, cfg.map_match_capacity
    table = fp.DeviceLandmarkTable(cap, cfg.n_desc_per_lm)
    table.ensure(B, jnp.float32)
    lms = {}
    ident = np.array([0, 0, 0, 0, 0, 0, 1.0])

    def new_landmark(hp, init, c, kp):
        lms[len(lms)] = (np.asarray(hp, np.float64), bool(init))
        table.stage_descriptor(len(lms) - 1, c, kp)
        return len(lms) - 1

    def landmark_arrays():
        hp = np.tile([0.0, 0.0, 0.0, 1.0], (cap, 1))
        mask, init = np.zeros(cap, bool), np.zeros(cap, bool)
        for lid, s in table.slot_of.items():
            hp[s], mask[s], init[s] = lms[lid][0], True, lms[lid][1]
        return hp, mask, init

    def run(counter, imgs, T_pred, prev, kf, staged):
        hp, mask, init = landmark_arrays()
        kf_T = np.tile(ident, (KF, 1))
        kf_free = np.zeros((KF, NC, N), bool)
        kf_valid = np.zeros(KF, bool)
        zeros_xy, zeros_s = np.zeros((KF, NC, N, 2), np.float32), np.zeros((KF, NC, N, B), np.float32)
        if kf is not None:
            kf_T[0], kf_valid[0] = kf["pose"], True
            kf_free[0] = kf["st"]["mask"]
            for (c, k) in kf["hosts"]:
                kf_free[0, c, k] = False
            zeros_xy[0], zeros_s[0] = kf["st"]["xy"], kf["st"]["signs"]
        upd = table.drain(fp._FLUSH_U)
        aux = np.concatenate([
            T_pred, prev["pose"] if prev else ident, T_SC.ravel(), hp.ravel(), kf_T.ravel(),
            [cfg.map_match_radius, cfg.ransac_threshold_deg, cfg.stereo_epipolar_gate,
             cfg.min_depth, cfg.max_depth, cfg.ff_match_angle_deg],
            mask, init, kf_free.ravel(), kf_valid, [counter], upd]).astype(np.float32)
        prev_st = prev["st"] if prev else {"xy": np.zeros((NC, N, 2), np.float32),
                                           "signs": np.zeros((NC, N, B), np.float32),
                                           "mask": np.zeros((NC, N), bool)}
        diag, stacked, _, table.signs, table.valid = fp._frame_associate_device(
            cams, jnp.asarray(imgs), jnp.asarray(aux), table.signs, table.valid,
            jnp.asarray(staged if staged is not None else np.zeros((NC, N, B), np.float32)),
            jnp.asarray(zeros_xy), jnp.asarray(zeros_s), jnp.asarray(prev_st["xy"]),
            jnp.asarray(prev_st["signs"]), jnp.asarray(prev_st["mask"]), jnp.zeros(0),
            cfg.detection, cfg.matching_threshold, cfg.ransac_hypotheses,
            cfg.ransac_min_inliers, True, True, True, False)
        st = {k: np.asarray(stacked[k]) for k in ("xy", "signs", "mask")}
        # the program's RANSAC pose, recomputed with its key (frontend_pipeline.py:241)
        key = jax.random.fold_in(jax.random.PRNGKey(42), counter)
        f32 = lambda x: jnp.asarray(x, jnp.float32)  # noqa: E731
        idx, ok, _, _, _ = fp._associate_device(
            cams, key, f32(T_pred), f32(T_SC), f32(hp), jnp.asarray(mask), jnp.asarray(init),
            table.signs, table.valid, stacked["xy"], stacked["mask"], stacked["signs"],
            f32(cfg.map_match_radius), f32(cfg.ransac_threshold_deg), cfg.matching_threshold,
            cfg.ransac_hypotheses, cfg.ransac_min_inliers, True)
        rays = jnp.stack([cams[c].back_project(stacked["xy"][c][idx[c]]) for c in range(NC)])
        w = f32(hp)[:, 3:4]
        pts = f32(hp)[:, :3] / jnp.where(jnp.abs(w) > 1e-12, w, 1e-12)
        res = ransac_rig_pose(key, jnp.tile(pts, (NC, 1)), rays.reshape(NC * cap, 3),
                              jnp.repeat(jnp.arange(NC, dtype=jnp.int32), cap),
                              (ok & jnp.asarray(init)[None]).reshape(NC * cap), f32(T_SC),
                              threshold_deg=cfg.ransac_threshold_deg,
                              n_hyp=cfg.ransac_hypotheses, min_inliers=cfg.ransac_min_inliers)
        T_ws = np.concatenate([np.asarray(res["T_WS"].r), np.asarray(res["T_WS"].q)])
        return decode(np.asarray(diag), NC, N, cap, KF), st, T_ws

    def decode(diag, NC, N, cap, KF):
        o = 0

        def take(n, shape):
            nonlocal o
            o += n
            return diag[o - n:o].reshape(shape)

        ms_n, ff_n = min(fp._MS_ROWS, KF * NC * N), min(fp._FF_ROWS, NC * N)
        out = {"xy": take(NC * N * 2, (NC, N, 2)), "size": take(NC * N, (NC, N)),
               "mask": take(NC * N, (NC, N)) > 0.5, "idx": take(NC * cap, (NC, cap)).astype(int),
               "keep": take(NC * cap, (NC, cap)) > 0.5, "ms_rows": take(ms_n * 8, (ms_n, 8)),
               "ff_rows": take(ff_n * 4, (ff_n, 4))}
        out.update(n_inl=int(diag[o]), ransac_ok=bool(diag[o + 1] > 0.5),
                   rot_frac=float(diag[o + 2]))
        return out

    def pose_error(T7, T_gt7):
        dq = abs(float(np.dot(T7[3:] / np.linalg.norm(T7[3:]), T_gt7[3:])))
        return (float(np.linalg.norm(T7[:3] - T_gt7[:3])),
                float(np.degrees(2 * np.arccos(min(dq, 1.0)))))

    t0 = time.perf_counter()
    _, st0, _ = run(1, frames[0][1], frames[0][2], None, None, None)
    # frame 0: static stereo at the true pose, sequential-pair dedup
    pose0 = frames[0][2]
    T7 = [se3_np.compose7(pose0, T.astype(np.float64)) for T in T_SC]
    s_aux = np.concatenate([T7[0], T7[1], [cfg.stereo_epipolar_gate / 460.0],
                            [cfg.min_depth, cfg.max_depth], st0["mask"][0], st0["mask"][1]])
    idx_b, hp_W, good, parallel = fp._decode_stereo_flat(np.asarray(fp._stereo_pairs_device(
        cams, jnp.asarray(s_aux, jnp.float32), jnp.asarray(st0["xy"]), jnp.asarray(st0["signs"]),
        ((0, 1),), cfg.matching_threshold, True)), 1, N)
    hosts = {}
    for a in np.nonzero(good[0])[0]:
        a, b = int(a), int(idx_b[0][a])
        if (0, a) in hosts or (1, b) in hosts:
            continue
        hosts[(0, a)] = hosts[(1, b)] = new_landmark(hp_W[0][a], not parallel[0][a], 0, a)
    table.flush(jnp.asarray(st0["signs"]))
    kf = {"st": st0, "pose": pose0, "hosts": hosts}
    prev = {"st": st0, "pose": pose0, "hosts": hosts}
    print(f"frame 0: {len(hosts) // 2} landmarks seeded", flush=True)

    _, v0 = true_state(frames[0][0])
    sb = np.concatenate([np.asarray(v0, np.float64), np.zeros(6)])
    T_est, staged, rows = pose0, None, []
    for i in range(1, n_track + 1):
        t_prev, t_i = frames[i - 1][0], frames[i][0]
        sel = (imu_t >= t_prev - 1e-9) & (imu_t < t_i - 1e-9)
        T_pred, sb = propagate_state_np(9.81, T_est, sb, imu_w[sel], imu_a[sel],
                                        np.full(int(sel.sum()), 1.0 / 200.0))
        slot_lid = table.slot_lid.copy()
        out, st, T_ws = run(i + 1, frames[i][1], T_pred, prev, kf, staged)
        # host bookkeeping, as chip_smoke.Tracking.finish
        cur = {}
        for ci in range(NC):
            for s in np.nonzero(out["keep"][ci])[0]:
                lid, kp = int(slot_lid[s]), int(out["idx"][ci, s])
                if lid >= 0 and (ci, kp) not in cur:
                    cur[(ci, kp)] = lid
                    table.stage_descriptor(lid, ci, kp)
        seen = set(cur.values())
        ff = out["ff_rows"]
        for ci, a, b, _ in ff[ff[:, 3] > 0.5].astype(int):
            lid = prev["hosts"].get((ci, a))
            if lid is not None and (ci, b) not in cur and lid not in seen:
                cur[(ci, b)] = lid
                seen.add(lid)
                table.stage_descriptor(lid, ci, b)
        ms = out["ms_rows"]
        if out["rot_frac"] < cfg.rotation_only_veto:
            for r in ms[ms[:, 7] > 0.5]:
                k, ci = divmod(int(r[0]), NC)
                a, b = int(r[1]), int(r[2])
                if k != 0 or (ci, a) in kf["hosts"] or (ci, b) in cur:
                    continue
                kf["hosts"][(ci, a)] = cur[(ci, b)] = new_landmark(r[3:7], True, ci, b)
        prev = {"st": st, "pose": T_ws.astype(np.float64), "hosts": cur}
        staged = st["signs"]
        T_est = prev["pose"]
        err = pose_error(T_est, ds.ground_truth(t_i).astype(np.float64))
        rows.append((i, out["ransac_ok"], out["n_inl"]) + err)
        print(f"frame {i:2d}: ransac_ok {out['ransac_ok']} inliers {out['n_inl']:3d} map "
              f"{len(table.slot_of):4d}, pose error {err[0]:.4f} m {err[1]:.4f} deg", flush=True)
    print(json.dumps({"frames": n_track, "all_ransac_ok": all(r[1] for r in rows),
                      "min_inliers": min(r[2] for r in rows),
                      "max_pos_err_m": max(r[3] for r in rows),
                      "max_rot_err_deg": max(r[4] for r in rows),
                      "seconds": time.perf_counter() - t0}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
