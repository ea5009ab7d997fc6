"""The per-frame tracking program and the device landmark table.

Port of the device half of ``okvis2_tpu/pipeline/frontend_pipeline.py``
(reference: okvis_frontend/src/Frontend.cpp, detectAndDescribe :221-269
and dataAssociationAndInitialization :558-1015). ``frame_associate`` is
the body of the JAX package's fused ``_frame_associate_body``: detection
and description of every camera, match-to-map (project the map's
landmarks, 40 px gate, Hamming distance as the minimum over <= 3 stored
descriptors, mutual best), rig-joint Lambda-Twist P3P RANSAC,
frame-to-frame matching against the previous frame, motion stereo against
the top-K keyframes with a rotation-only (Wahba) check, and the
good-rows-first compaction the host reads. The staged descriptor-table
updates of the previous frame are applied first, clears before writes.

What the JAX package packs into one flat upload and one flat readback (to
save round trips on the TPU link) arrives here as named tensors and leaves
as a dict; the outputs and their order are the same, plus the RANSAC pose.
Randomness comes from a ``torch.Generator`` or from a ``sampler`` callable
that replaces ``p3p.sample_hypotheses``.

``DeviceLandmarkTable`` keeps its host bookkeeping (slots, LRU eviction,
staged updates) in numpy as the JAX package does; the descriptor table
itself (``signs``/``valid``) lives on the device as torch tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from okvis2_torch import resolve_device
from okvis2_torch.core.se3 import Transformation
from okvis2_torch.frontend.descriptor import describe_keypoints
from okvis2_torch.frontend.detection import DetectionConfig, detect_keypoints_batch
from okvis2_torch.frontend.matching import hamming_distance_matrix, match_descriptors
from okvis2_torch.frontend.p3p import _det3, ransac_rig_pose_from_samples, sample_hypotheses
from okvis2_torch.frontend.triangulation import triangulate_in_frames
from okvis2_torch.ops.linalg import inv3x3


@dataclasses.dataclass(frozen=True)
class FrontendConfig:
    detection: DetectionConfig = DetectionConfig()
    matching_threshold: int = 60  # Hamming (config/euroc.yaml:65)
    map_match_radius: float = 40.0  # px gate around predicted projection
    # fixed landmark-slot count per match call; a full table LRU-evicts
    map_match_capacity: int = 2048
    n_desc_per_lm: int = 3  # <=3 best descriptors (Frontend.cpp:1224-1359)
    stereo_epipolar_gate: float = 3.0  # px distance to epipolar line
    keyframe_overlap_threshold: float = 0.6  # euroc.yaml:68
    # matched/detected keypoint ratio (doWeNeedANewKeyframe, Frontend.cpp:1057-1167)
    keyframe_matching_ratio: float = 0.2
    keyframe_grid: int = 8  # coverage grid (grid cells per axis)
    ransac_min_inliers: int = 10
    ransac_hypotheses: int = 128
    ransac_threshold_deg: float = 0.6  # ~4px at f=460 (thresh 16 px^2)
    use_ransac: bool = True
    # rotation-only veto on motion-stereo matches (runRansac2d2d
    # rotation-only, Frontend.cpp:2311-2334)
    rotation_only_veto: float = 0.95
    # motion stereo against the top-K overlap-ranked window keyframes
    # (Frontend.cpp:1742-1768)
    motion_stereo_keyframes: int = 3
    # BRISK-2 gravity-aligned extraction direction (Frontend.cpp:231-251)
    gravity_aligned_description: bool = False
    min_depth: float = 0.1
    max_depth: float = 60.0
    # frame-to-frame matching against the previous frame's keypoints
    # (rotation-compensated angular gate, degrees; Frontend.cpp:1399-1504)
    ff_match_angle_deg: float = 5.0


_FLUSH_U = 512  # staged table updates folded into each frame's program
_FF_ROWS = 512  # per-frame frame-to-frame match row budget
_MS_ROWS = 256  # per-frame motion-stereo row budget


def _T(T7: torch.Tensor) -> Transformation:
    return Transformation(r=T7[..., :3], q=T7[..., 3:7])


def _unit(v: torch.Tensor) -> torch.Tensor:
    return v / (torch.linalg.norm(v, dim=-1, keepdim=True) + 1e-12)


def _min3_gated_match(
    tab_signs: torch.Tensor,  # [Lc,K,B] ±1 (0 rows invalid)
    tab_valid: torch.Tensor,  # [Lc,K]
    kp_signs: torch.Tensor,  # [N,B]
    kp_mask: torch.Tensor,  # [N]
    gate: torch.Tensor,  # [Lc,N]
    max_distance: int,
):
    """Mutual-best Hamming match, landmark distance = min over its <=K
    stored descriptors. Returns (idx [Lc] int32, valid [Lc])."""
    Lc, K, B = tab_signs.shape
    d_all = hamming_distance_matrix(tab_signs.reshape(Lc * K, B), kp_signs).reshape(Lc, K, -1)
    big = torch.full((), 1e9, dtype=d_all.dtype, device=d_all.device)
    d_all = torch.where(tab_valid[:, :, None], d_all, big)
    d = torch.amin(d_all, dim=1)  # [Lc,N]
    lm_has = torch.any(tab_valid, dim=1)
    m = lm_has[:, None] & kp_mask[None, :] & gate
    d = torch.where(m, d, big)
    best_b = torch.argmin(d, dim=1)
    best_d = torch.amin(d, dim=1)
    best_a_of_b = torch.argmin(d, dim=0)
    mutual = best_a_of_b[best_b] == torch.arange(Lc, device=d.device)
    valid = mutual & (best_d <= max_distance) & lm_has
    return torch.where(valid, best_b, 0).to(torch.int32), valid


def _associate_core(
    cameras, T_WS7, T_SC7, hp, lm_mask, lm_init,
    tab_signs, tab_valid, xy, rays, kp_mask, kp_signs,
    radius, threshold_deg, max_distance, n_hyp, min_inliers, use_ransac, sampler,
):
    """Project-gate-match per camera + rig-joint P3P RANSAC; ``rays``
    [NC,N,3] are the keypoints' unit bearings.

    Returns (idx [NC,Lc], ok [NC,Lc], keep [NC,Lc], n_inl, ransac_ok,
    T_WS7 of the RANSAC pose). Reference: matchToMap + runRansac3d2d,
    Frontend.cpp:1171-1719, 2208-2278."""
    NC = len(cameras)
    Lc = hp.shape[0]
    T_WS = _T(T_WS7)
    idx_c, ok_c, rays_c = [], [], []
    for ci, cam in enumerate(cameras):
        T_CW = (T_WS @ _T(T_SC7[ci])).inverse()
        uv_pred, valid = cam.project_homogeneous(T_CW.apply_homogeneous(hp))
        valid = valid & lm_mask
        d2 = torch.sum((uv_pred[:, None, :] - xy[ci][None, :, :]) ** 2, dim=-1)
        gate = (d2 < radius * radius) & valid[:, None]
        idx, ok = _min3_gated_match(tab_signs, tab_valid, kp_signs[ci], kp_mask[ci], gate,
                                    max_distance)
        idx_c.append(idx)
        ok_c.append(ok)
        rays_c.append(rays[ci][idx.long()])
    idx = torch.stack(idx_c)
    ok = torch.stack(ok_c)
    rays = torch.stack(rays_c)

    if not use_ransac:
        z = torch.zeros((), dtype=torch.long, device=hp.device)
        return idx, ok, ok, z, torch.zeros((), dtype=torch.bool, device=hp.device), T_WS7

    w = hp[:, 3:4]
    pts = hp[:, :3] / torch.where(w.abs() > 1e-12, w, torch.full_like(w, 1e-12))
    pts_all = pts.repeat(NC, 1)
    rays_all = rays.reshape(NC * Lc, 3)
    cam_idx = torch.arange(NC, device=hp.device).repeat_interleave(Lc)
    corr_mask = (ok & lm_init[None, :]).reshape(NC * Lc)
    hyp = sampler(corr_mask, cam_idx, n_hyp, NC)
    res = ransac_rig_pose_from_samples(hyp, pts_all, rays_all, cam_idx, corr_mask, T_SC7,
                                       threshold_deg, min_inliers)
    inlier = res["inliers"].reshape(NC, Lc)
    keep = torch.where(res["ok"], inlier, ok)
    T = res["T_WS"]
    return idx, ok, keep & ok, res["num_inliers"], res["ok"], torch.cat([T.r, T.q])


def _stereo_pair(
    cam_a, cam_b, T_WA, T_WB,
    rays_a, signs_a, free_a, rays_b, signs_b, free_b,
    epi_gate, min_depth, max_depth, max_distance, allow_parallel,
):
    """Epipolar-gated match + triangulation between two views (shared by
    motion stereo and static stereo), from the keypoints' unit bearings.
    Returns (idx_b [N], hp_W [N,4], good [N], parallel [N])."""
    T_AB = T_WA.inverse() @ T_WB
    rays_b_in_a = (T_AB.C @ rays_b.T).T
    n_plane = _unit(torch.linalg.cross(T_AB.r.expand(rays_a.shape), rays_a, dim=-1))
    epi = torch.abs(n_plane @ rays_b_in_a.T)
    m = match_descriptors(signs_a, free_a, signs_b, free_b, max_distance=max_distance,
                          gate=epi < epi_gate)
    bi_full = torch.where(m["valid"], m["idx_b"], 0).long()
    hp_W, valid_t, parallel = triangulate_in_frames(T_WA, T_WB, rays_a, rays_b[bi_full])
    p_A = T_WA.inverse().apply_homogeneous(hp_W)
    safe_w = torch.where(p_A[:, 3] != 0, p_A[:, 3], torch.full_like(p_A[:, 3], 1e-12))
    depth = p_A[:, 2] / safe_w
    depth_ok = (depth > min_depth) & (depth < max_depth)
    good = m["valid"] & valid_t & ((parallel & allow_parallel) | (~parallel & depth_ok))
    return m["idx_b"], hp_W, good, parallel


def _stereo_motion_device(cameras, T_WS7, T_SC7, kf, rays, kp_signs, avail_b,
                          epi_px, min_depth, max_depth, max_distance):
    """Motion stereo against the top-K keyframes (same camera across time),
    keyframe by keyframe so a keypoint triangulated against an earlier
    (higher-overlap) keyframe is not offered to a later one, plus the
    rotation-only fraction: the share of keyframe-0 matches that a pure
    rotation (Wahba fit) explains within 0.3 degrees. ``rays`` [NC,N,3]
    are the current keypoints' unit bearings.

    Returns (ms_idx [KF,NC,N], ms_hp [KF,NC,N,4], ms_good [KF,NC,N],
    rot_frac)."""
    KF = kf["xy"].shape[0]
    NC, N = rays.shape[0], rays.shape[1]
    dtype, dev = rays.dtype, rays.device
    T_WS = _T(T_WS7)
    ms_idx, ms_hp, ms_good = [], [], []
    pair_d1, pair_d2, pair_m = [], [], []
    avail_b = avail_b.clone()
    for k in range(KF):
        T_WS_kf = _T(kf["T_WS7"][k])
        for ci, cam in enumerate(cameras):
            T_sc = _T(T_SC7[ci])
            T_WA = T_WS_kf @ T_sc
            T_WB = T_WS @ T_sc
            baseline = torch.linalg.norm(T_WB.r - T_WA.r)
            rays_kf = cam.back_project(kf["xy"][k, ci])
            i_b, hp_W, good, _ = _stereo_pair(
                cam, cam, T_WA, T_WB,
                rays_kf, kf["signs"][k, ci], kf["free"][k, ci],
                rays[ci], kp_signs[ci], avail_b[ci],
                epi_px / cam.focal.reshape(-1)[0], min_depth, max_depth, max_distance, False,
            )
            good = good & (baseline > 0.02) & kf["valid"][k]
            ms_idx.append(i_b)
            ms_hp.append(hp_W.to(dtype))
            ms_good.append(good)
            taken = torch.zeros(N + 1, dtype=torch.bool, device=dev)
            taken[torch.where(good, i_b.long(), N)] = True
            avail_b[ci] = avail_b[ci] & ~taken[:N]
            if k == 0:
                # bearings of matched pairs (old vs new, matched even when
                # not good) for the rotation-only model
                pair_d1.append(rays_kf)
                pair_d2.append(rays[ci][torch.where(i_b >= 0, i_b, 0).long()])
                pair_m.append((i_b >= 0) & kf["free"][0, ci])
    d1 = torch.cat(pair_d1)
    d2 = torch.cat(pair_d2)
    pm = torch.cat(pair_m).to(dtype)
    # Wahba fit: orthogonal polar factor of B = sum m * d2 d1^T
    B = torch.einsum("n,ni,nj->ij", pm, d2, d1)
    detB = _det3(B)
    sgn = torch.where(detB < 0, -1.0, 1.0).to(dtype)
    nB = detB.abs() ** (1.0 / 3.0)
    X = B * sgn / torch.clamp(nB, min=1e-12)
    for _ in range(6):
        X = 0.5 * (X + inv3x3(X).T)
    cosang = torch.sum((d1 @ X.T) * d2, dim=-1)
    thr = torch.cos(torch.deg2rad(torch.tensor(0.3, dtype=dtype, device=dev)))
    n_pairs = torch.clamp(torch.sum(pm), min=1.0)
    rot_frac = torch.sum((cosang > thr).to(dtype) * pm) / n_pairs
    shape = (KF, NC, N)
    return (torch.stack(ms_idx).reshape(shape), torch.stack(ms_hp).reshape(shape + (4,)),
            torch.stack(ms_good).reshape(shape), rot_frac)


def _ff_match(cameras, T_WS7, T_SC7, prev, rays, kp_signs, avail, angle_deg, max_distance):
    """Frame-to-frame matching: the still-unmatched keypoints (``avail``)
    against the previous frame's (``prev``: xy, signs, mask, T_WS7),
    behind a rotation-compensated angular gate of ``angle_deg``; the host
    resolves them to that frame's landmarks (the sequential
    keyframe-to-frame match's role, Frontend.cpp:1399-1504). ``rays``
    [NC,N,3] are the current keypoints' unit bearings.
    Returns (ff_idx [NC,N] int32, -1 where none; ff_good [NC,N])."""
    T_WS_prev = _T(prev["T_WS7"])
    cos_thr = torch.cos(torch.deg2rad(torch.tensor(float(angle_deg), dtype=rays.dtype,
                                                   device=rays.device)))
    ff_idx, ff_good = [], []
    for ci, cam in enumerate(cameras):
        T_sc = _T(T_SC7[ci])
        dp = _unit(((T_WS_prev @ T_sc).C @ cam.back_project(prev["xy"][ci]).T).T)
        dc = _unit(((_T(T_WS7) @ T_sc).C @ rays[ci].T).T)
        m = match_descriptors(prev["signs"][ci], prev["mask"][ci], kp_signs[ci], avail[ci],
                              max_distance=max_distance, gate=dp @ dc.T > cos_thr)
        ff_idx.append(m["idx_b"])
        ff_good.append(m["valid"])
    return torch.stack(ff_idx), torch.stack(ff_good)


def _table_update_body(tab_signs, tab_valid, kp_signs, upd):
    """Scatter staged landmark descriptors into the resident table and
    clear freed slots. ``upd`` [4U] int is (tgt | cam | kp | clear) as
    ``DeviceLandmarkTable.drain`` makes it; targets Lc*K and clears Lc are
    dropped. Clears apply BEFORE the descriptor writes: a slot freed and
    re-allocated in the same batch keeps its freshly staged descriptor."""
    Lc, K, B = tab_signs.shape
    upd = upd.long()
    U = upd.shape[0] // 4
    tgt, cam, kp, clear = upd[0:U], upd[U:2 * U], upd[2 * U:3 * U], upd[3 * U:4 * U]
    src = kp_signs[cam, kp].to(tab_signs.dtype)  # [U,B]
    # one spare row takes the dropped indices
    valid = torch.cat([tab_valid, tab_valid.new_zeros(1, K)])
    valid[torch.clamp(clear, max=Lc)] = False
    flat_v = torch.cat([valid[:Lc].reshape(Lc * K), valid.new_zeros(1)])
    flat_s = torch.cat([tab_signs.reshape(Lc * K, B), tab_signs.new_zeros(1, B)])
    tgt = torch.clamp(tgt, max=Lc * K)
    flat_s[tgt] = src
    flat_v[tgt] = True
    return flat_s[:Lc * K].reshape(Lc, K, B), flat_v[:Lc * K].reshape(Lc, K)


def _stereo_pairs(cameras, T_WA7s, T_WB7s, gates, min_depth, max_depth, free_a, free_b,
                  xy, signs, pairs, max_distance, allow_parallel):
    """Static stereo across all overlapping camera pairs of one frame
    (matchStereo, Frontend.cpp:1981-2150): pair p matches camera pairs[p][0]
    (pose T_WA7s[p], free keypoints free_a[p]) against pairs[p][1].
    Returns (idx_b [P,N], hp_W [P,N,4], good [P,N], parallel [P,N])."""
    T_WA7s, T_WB7s = (torch.as_tensor(x, dtype=xy.dtype, device=xy.device)
                      for x in (T_WA7s, T_WB7s))
    free_a, free_b = (torch.as_tensor(x, dtype=torch.bool, device=xy.device)
                      for x in (free_a, free_b))
    rays = [cam.back_project(xy[c]) for c, cam in enumerate(cameras)]
    outs = []
    for p, (ci, cj) in enumerate(pairs):
        outs.append(_stereo_pair(
            cameras[ci], cameras[cj], _T(T_WA7s[p]), _T(T_WB7s[p]),
            rays[ci], signs[ci], free_a[p], rays[cj], signs[cj], free_b[p],
            gates[p], min_depth, max_depth, max_distance, allow_parallel,
        ))
    return tuple(torch.stack(x) for x in zip(*outs))


def _compact(good: torch.Tensor, cols, budget: int) -> torch.Tensor:
    """Good rows first (stable), at most ``budget`` rows, as one float
    tensor [R, sum of column widths]; ``cols`` are per-row tensors over
    the flattened good mask."""
    sel = torch.argsort((~good).to(torch.uint8), stable=True)[:budget]
    return torch.cat([c[sel] if c.dim() == 2 else c[sel][:, None] for c in cols], dim=1)


def frame_associate(cameras, T_SC7, images, T_WS7, landmarks, tab_signs, tab_valid,
                    cfg: FrontendConfig = FrontendConfig(), *, staged=None, keyframes=None,
                    prev=None, generator: Optional[torch.Generator] = None, sampler=None,
                    device=None):
    """The per-frame tracking program (``_frame_associate_body``).

    cameras: one PinholeCamera per camera; T_SC7 [NC,7] extrinsics;
    images [NC,H,W] float in [0,1] (uint8 widens to float32); T_WS7 [7]
    the predicted body pose. ``landmarks``: {"hp" [Lc,4], "mask" [Lc],
    "init" [Lc] (RANSAC-eligible)}; tab_signs [Lc,K,B], tab_valid [Lc,K]
    the descriptor table. Optional, keyword-only:
      staged     {"signs" [NC,N,B], "upd" [4U] int}: table updates staged
                 by the previous frame's bookkeeping (DeviceLandmarkTable.
                 drain) and the signs they index, applied first;
      keyframes  {"xy" [KF,NC,N,2], "signs" [KF,NC,N,B], "free" [KF,NC,N],
                 "valid" [KF], "T_WS7" [KF,7]}: motion stereo;
      prev       {"xy" [NC,N,2], "signs" [NC,N,B], "mask" [NC,N],
                 "T_WS7" [7]}: frame-to-frame matching;
      generator  RANSAC's random stream (default: seeded 42); ``sampler``
                 (mask, cam_idx, n_hyp, NC) -> [n_hyp,3] replaces
                 ``p3p.sample_hypotheses``.
    Runs on ``device`` (None: the CUDA card; raises without one).

    Returns a dict: xy [NC,N,2], size, mask, signs, signs_packed (the
    detection and descriptors); idx / keep [NC,Lc] (match to map, RANSAC
    survivors); n_inl, ransac_ok, T_WS7 (the RANSAC pose); ms_rows
    [R,8] (k*NC+ci, keyframe kp a, current kp b, hp_W[4], good) and
    ff_rows [R,4] (ci, previous kp a, current kp b, good), good rows first
    (no ms_rows without keyframes);
    ms_total, ff_total (good rows before the budget); rot_frac; tab_signs,
    tab_valid (the table after the staged updates).
    """
    dev = resolve_device(device)
    images = torch.as_tensor(images, device=dev)
    if images.dtype == torch.uint8:
        images = images.to(torch.float32) * (1.0 / 255.0)
    dtype = images.dtype

    def t(x, dt=dtype):
        return torch.as_tensor(x, dtype=dt, device=dev)

    def tb(x):
        return torch.as_tensor(x, dtype=torch.bool, device=dev)

    NC = len(cameras)
    T_WS7, T_SC7 = t(T_WS7), t(T_SC7)
    hp, lm_mask, lm_init = t(landmarks["hp"]), tb(landmarks["mask"]), tb(landmarks["init"])
    tab_signs, tab_valid = t(tab_signs), tb(tab_valid)
    if staged is not None:
        tab_signs, tab_valid = _table_update_body(
            tab_signs, tab_valid, t(staged["signs"]), t(staged["upd"], torch.long))
    if sampler is None:
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(42)

        def sampler(mask, cam_idx, n_hyp, nc):
            return sample_hypotheses(generator, mask, cam_idx, n_hyp, nc)

    det = detect_keypoints_batch(images, cfg.detection)
    xy, kp_mask = det["xy"], det["mask"]
    # the keypoints' unit bearings, once: every stage below reads them
    rays = torch.stack([cam.back_project(xy[ci]) for ci, cam in enumerate(cameras)])
    ext_dir = [None] * NC
    if cfg.gravity_aligned_description:
        # BRISK-2 gravity-aligned extraction direction (Frontend.cpp:231-251):
        # per keypoint, the image direction of world gravity under the
        # predicted pose
        g_S = _T(T_WS7).C.T @ t([0.0, 0.0, -1.0])
        for ci, cam in enumerate(cameras):
            g_C = _T(T_SC7[ci]).C.T @ g_S
            p0 = rays[ci] * 2.0
            d = cam.project(p0 + 0.02 * g_C)[0] - cam.project(p0)[0]
            ext_dir[ci] = torch.atan2(d[:, 1], d[:, 0])
    desc = [describe_keypoints(images[ci], xy[ci], det["size"][ci], kp_mask[ci],
                               extraction_direction=ext_dir[ci]) for ci in range(NC)]
    kp_signs = torch.stack([d["signs"] for d in desc])
    N = xy.shape[1]

    idx, ok, keep, n_inl, ransac_ok, T_WS_ransac = _associate_core(
        cameras, T_WS7, T_SC7, hp, lm_mask, lm_init, tab_signs, tab_valid, xy, rays, kp_mask,
        kp_signs, cfg.map_match_radius, cfg.ransac_threshold_deg, cfg.matching_threshold,
        cfg.ransac_hypotheses, cfg.ransac_min_inliers, cfg.use_ransac, sampler,
    )

    # keypoints matched to the map this frame (per camera)
    matched = torch.zeros((NC, N + 1), dtype=torch.bool, device=dev)
    matched.scatter_(1, torch.where(keep, idx, N).long(), True)
    matched = matched[:, :N]

    if prev is not None:
        prev = {"xy": t(prev["xy"]), "signs": t(prev["signs"]), "mask": tb(prev["mask"]),
                "T_WS7": t(prev["T_WS7"])}
        ff_idx, ff_good = _ff_match(cameras, T_WS7, T_SC7, prev, rays, kp_signs,
                                    kp_mask & ~matched, cfg.ff_match_angle_deg,
                                    cfg.matching_threshold)
    else:
        ff_idx = torch.full((NC, N), -1, dtype=torch.int32, device=dev)
        ff_good = torch.zeros((NC, N), dtype=torch.bool, device=dev)

    if keyframes is not None:
        kf = {"xy": t(keyframes["xy"]), "signs": t(keyframes["signs"]),
              "free": tb(keyframes["free"]), "valid": tb(keyframes["valid"]),
              "T_WS7": t(keyframes["T_WS7"])}
        ms_idx, ms_hp, ms_good, rot_frac = _stereo_motion_device(
            cameras, T_WS7, T_SC7, kf, rays, kp_signs, kp_mask & ~matched,
            cfg.stereo_epipolar_gate, cfg.min_depth, cfg.max_depth, cfg.matching_threshold)
    else:  # no keyframe: no motion-stereo rows
        ms_idx = torch.zeros((0, NC, N), dtype=torch.int32, device=dev)
        ms_hp = torch.zeros((0, NC, N, 4), dtype=dtype, device=dev)
        ms_good = torch.zeros((0, NC, N), dtype=torch.bool, device=dev)
        rot_frac = torch.zeros((), dtype=dtype, device=dev)

    # the good rows first: typically tens per frame of the dense blocks
    flat_good = ms_good.reshape(-1)
    r = torch.arange(flat_good.shape[0], device=dev)
    ms_rows = _compact(flat_good, [(r // N).to(dtype), (r % N).to(dtype),
                                   ms_idx.reshape(-1).to(dtype), ms_hp.reshape(-1, 4),
                                   flat_good.to(dtype)], _MS_ROWS)
    ff_flat = ff_good.reshape(-1)
    r = torch.arange(ff_flat.shape[0], device=dev)
    ff_rows = _compact(ff_flat, [(r // N).to(dtype), (r % N).to(dtype),
                                 ff_idx.reshape(-1).to(dtype), ff_flat.to(dtype)], _FF_ROWS)
    return {
        "xy": xy, "size": det["size"], "mask": kp_mask, "signs": kp_signs,
        "signs_packed": torch.stack([d["packed"] for d in desc]),
        "idx": idx, "keep": keep, "n_inl": n_inl, "ransac_ok": ransac_ok, "T_WS7": T_WS_ransac,
        "ms_rows": ms_rows, "ff_rows": ff_rows,
        "ms_total": flat_good.sum(), "ff_total": ff_flat.sum(), "rot_frac": rot_frac,
        "tab_signs": tab_signs, "tab_valid": tab_valid,
    }


class DeviceLandmarkTable:
    """Host bookkeeping for the device-resident landmark descriptor map:
    ``capacity`` slots of ``n_desc`` descriptors each, LRU-evicted when
    full, with per-frame updates staged on the host and applied on the
    device (``drain`` for the frame program, ``flush`` standalone)."""

    def __init__(self, capacity: int, n_desc: int, device=None):
        self.device = resolve_device(device)
        self.capacity = capacity
        self.n_desc = n_desc
        self.slot_of: Dict[int, int] = {}
        self.lid_of: Dict[int, int] = {}
        # slot -> lid as an array twin of lid_of
        self.slot_lid = np.full(capacity, -1, np.int64)
        self.free = list(range(capacity - 1, -1, -1))
        self.ring_next = np.zeros(capacity, np.int32)
        # LRU: a full table evicts the least-recently-staged landmark
        # instead of refusing new ones (the reference's analogue is matching
        # against the bounded covisible local map, Frontend.cpp:1362-1432)
        self.last_seen = np.zeros(capacity, np.int64)
        self.tick = 0
        self.num_evictions = 0
        self.signs: Optional[torch.Tensor] = None  # device [cap,K,B]
        self.valid: Optional[torch.Tensor] = None  # device [cap,K]
        self._upd: List[tuple] = []  # (slot, ring, cam, kp)
        self._clear: List[int] = []

    def ensure(self, B: int, dtype=torch.float32):
        if self.signs is None:
            self.signs = torch.zeros((self.capacity, self.n_desc, B), dtype=dtype,
                                     device=self.device)
            self.valid = torch.zeros((self.capacity, self.n_desc), dtype=torch.bool,
                                     device=self.device)

    def alloc(self, lid: int) -> Optional[int]:
        s = self.slot_of.get(lid)
        if s is not None:
            return s
        if not self.free:
            # evict the least-recently-staged tenant
            ev = int(np.argmin(self.last_seen))
            old_lid = self.lid_of.get(ev)
            if old_lid is None:
                return None
            self.release(old_lid)
            # staged updates of the evicted tenant must not land in the new
            # tenant's slot (clears apply before updates per batch)
            if self._upd:
                self._upd = [u for u in self._upd if u[0] != ev]
            self.num_evictions += 1
        s = self.free.pop()
        self.slot_of[lid] = s
        self.lid_of[s] = lid
        self.slot_lid[s] = lid
        self.ring_next[s] = 0
        self.tick += 1
        self.last_seen[s] = self.tick
        return s

    def release(self, lid: int):
        s = self.slot_of.pop(lid, None)
        if s is not None:
            del self.lid_of[s]
            self.slot_lid[s] = -1
            self.free.append(s)
            self._clear.append(s)

    def stage_descriptor(self, lid: int, cam: int, kp: int):
        s = self.slot_of.get(lid)
        if s is None:
            s = self.alloc(lid)
            if s is None:
                return
        self.tick += 1
        self.last_seen[s] = self.tick
        ring = int(self.ring_next[s])
        self.ring_next[s] = (ring + 1) % self.n_desc
        self._upd.append((s, ring, cam, kp))

    def drain(self, U: int) -> np.ndarray:
        """Consume up to U staged updates + clears into one flat [4U] int32
        block (tgt | cam | kp | clear) for ``_table_update_body``; leftovers
        stay staged. When the clear backlog spills over one batch, only
        clears go, so a later batch's clear can never wipe a slot whose new
        tenant's descriptor went out in an earlier batch."""
        K = self.n_desc
        upd = np.empty(4 * U, np.int32)
        tgt, cam, kp, clear = upd[0:U], upd[U:2 * U], upd[2 * U:3 * U], upd[3 * U:4 * U]
        tgt[:] = self.capacity * K  # drop
        cam[:] = 0
        kp[:] = 0
        batch = [] if len(self._clear) > U else self._upd[:U]
        self._upd = self._upd[len(batch):]
        for i, (sl, ring, c, k) in enumerate(batch):
            tgt[i] = sl * K + ring
            cam[i] = c
            kp[i] = k
        clear[:] = self.capacity
        clr = self._clear[:U]
        self._clear = self._clear[U:]
        clear[: len(clr)] = clr
        return upd

    def flush(self, kp_signs_device: torch.Tensor, upd_capacity: int = _FLUSH_U):
        """Apply every staged update now, ``upd_capacity`` per batch."""
        if self.signs is None:
            return
        while self._upd or self._clear:
            upd = torch.as_tensor(self.drain(upd_capacity), device=self.device)
            self.signs, self.valid = _table_update_body(self.signs, self.valid,
                                                        kp_signs_device, upd)
