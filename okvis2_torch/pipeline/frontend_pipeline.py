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

The host reads the program's outputs as one flat tensor, ``frame_diag``
(the JAX program's ``diag`` layout, in the program's dtype): in the
synchronous loop it is copied back at once, in the pipelined loop it rides
back with the frame's solve output.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from okvis2_torch import resolve_device
from okvis2_torch.core import se3_np
from okvis2_torch.core.se3 import Transformation
from okvis2_torch.frontend.descriptor import describe_keypoints
from okvis2_torch.frontend.detection import DetectionConfig, detect_keypoints_batch
from okvis2_torch.frontend.matching import hamming_distance_matrix, match_descriptors
from okvis2_torch.frontend.p3p import _det3, ransac_rig_pose_from_samples, sample_hypotheses
from okvis2_torch.frontend.triangulation import triangulate_in_frames
from okvis2_torch.graph.estimator import _warn_capacity
from okvis2_torch.ops.linalg import inv3x3
from okvis2_torch.utils.timing import SwitchableTimer


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
    images [NC,H,W] float in [0,1] (uint8 widens to the cameras' dtype:
    float32 on the card); T_WS7 [7]
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
        images = images.to(cameras[0].focal.dtype) * (1.0 / 255.0)
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


def frame_diag(out, extra=None) -> torch.Tensor:
    """``frame_associate``'s outputs that the host reads, as ONE flat tensor
    in the program's dtype (indices and flags are exact there): xy | size |
    mask | idx | keep | ms_rows | ff_rows | n_inl, ransac_ok, rot_frac,
    ms_total, ff_total | ``extra`` (appended as it is, e.g. the previous
    frame's solve output riding the same readback). Decode with
    ``Frontend.finish_frame``."""
    dtype = out["xy"].dtype
    parts = [out[k].to(dtype).reshape(-1)
             for k in ("xy", "size", "mask", "idx", "keep", "ms_rows", "ff_rows")]
    parts.append(torch.stack([out[k].to(dtype) for k in
                              ("n_inl", "ransac_ok", "rot_frac", "ms_total", "ff_total")]))
    if extra is not None:
        parts.append(torch.as_tensor(extra, device=out["xy"].device).to(dtype).reshape(-1))
    return torch.cat(parts)


def _stereo_flat(out) -> torch.Tensor:
    """``_stereo_pairs``'s outputs as one flat tensor in hp_W's dtype:
    idx_b (keypoint indices, exact) | hp_W | good | parallel."""
    idx_b, hp_W, good, parallel = out
    f = hp_W.dtype
    return torch.cat([idx_b.to(f).reshape(-1), hp_W.reshape(-1), good.to(f).reshape(-1),
                      parallel.to(f).reshape(-1)])


def _decode_stereo_flat(flat: np.ndarray, P: int, N: int):
    """Host decode of ``_stereo_flat``: (idx_b, hp_W, good, parallel)."""
    o = P * N
    idx_b = np.round(flat[:o]).astype(np.int32).reshape(P, N)
    hp_W = flat[o:o + P * N * 4].reshape(P, N, 4)
    o += P * N * 4
    good = flat[o:o + P * N].reshape(P, N) > 0.5
    parallel = flat[o + P * N:o + 2 * P * N].reshape(P, N) > 0.5
    return idx_b, hp_W, good, parallel


def _to_host_async(tensors):
    """Start copies of ``tensors`` to the host on the current stream,
    without waiting: on the card into pinned memory, with an event
    recorded after them; on the CPU the tensors themselves. Returns (host
    tensors, event or None); wait with ``_host_arrays``."""
    if tensors[0].device.type != "cuda":
        return list(tensors), None
    host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in tensors]
    for h, t in zip(host, tensors):
        h.copy_(t, non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    return host, done


def _host_arrays(fetch):
    """The numpy arrays of a ``_to_host_async`` fetch, once it has landed."""
    host, done = fetch
    if done is not None:
        done.synchronize()
    return [h.numpy() for h in host]


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


class Frontend:
    """The frontend's host half around ``frame_associate`` (port of the
    synchronous parts of the JAX package's ``Frontend``): per frame,
    ``prepare_frame`` builds the program's inputs from the estimator's
    records (predicted pose, the landmark table's points, the top-K
    overlap-ranked keyframes, the previous frame's keypoints, the staged
    descriptor updates), ``frame_associate`` runs on the device, and
    ``finish_frame`` inserts observations and landmarks. Keyframes add
    static stereo, the descriptor fetch and the keyframe store
    (``dispatch_keyframe_extras`` / ``finish_keyframe_extras``).

    The synchronous loop runs the three steps in one call
    (``associate_frame``) and a keyframe's extras at once. The pipelined
    loop runs ``prepare_frame`` and ``dispatch_prepared`` for a frame
    before the previous frames are finished, and ``finish_frame`` on the
    host copy of the frame's diagnostics that came back with its solve; a
    keyframe's extras start at its finish and are consumed at the next
    one.

    The program and its per-frame inputs run at the cameras' precision:
    float32 on the card, as the JAX package's frame program and its
    float32 carrier.
    ``ransac_sampler(frame_counter)`` may return the frame's RANSAC
    sampler (see ``frame_associate``); without one, or when it returns
    None, hypotheses come from the frontend's generator (seeded 42).
    Runs on ``device`` (None: the CUDA card; raises without one)."""

    def __init__(self, cameras, extrinsics, config: FrontendConfig = FrontendConfig(),
                 device=None, ransac_sampler=None):
        self.device = resolve_device(device)
        self.cameras = tuple(c.to(device=self.device) for c in cameras)
        self.extrinsics = list(extrinsics)
        # numpy copies for host-side composition
        self.T_SC_np = [torch.cat([T.r, T.q]).detach().cpu().numpy().astype(np.float64)
                        for T in extrinsics]
        self.cfg = config
        # landmark id -> latest descriptor signs (numpy; map export and
        # loop-closure verification), and up to 3 distinct bit-packed
        # variants per landmark; matching uses the device table below
        self.lm_descriptors: Dict[int, np.ndarray] = {}
        self.lm_desc_sets: Dict[int, list] = {}
        self.table = DeviceLandmarkTable(config.map_match_capacity, config.n_desc_per_lm,
                                         device=self.device)
        self.ransac_sampler = ransac_sampler
        self._gen = torch.Generator(device=self.device).manual_seed(42)
        self.last_keyframe_id: Optional[int] = None
        self.last_ransac = {"num_inliers": 0, "ok": False}
        self._desc_stage: List[tuple] = []
        self._kf_store: Dict[int, list] = {}
        self._frame_counter = 0
        self._ff_prev = None  # the previous dispatch's device keypoints
        self._staged_signs_dev = None  # the signs the staged updates index
        self._overlap_pairs = None
        self._disk_offs_cache: Dict[int, np.ndarray] = {}
        # host copies of the focal lengths (no device read per frame)
        self._fx = [float(c.focal.reshape(-1)[0]) for c in self.cameras]

    # ------------------------------------------------------------------
    def associate_frame(self, estimator, images, sid: int, T_WS_pred7: np.ndarray,
                        extra_flat=None):
        """THE per-frame frontend entry: prepare -> ``frame_associate`` ->
        ``finish_frame`` (the detectAndDescribe -> matchToMap ->
        runRansac3d2d -> matchMotionStereo sequence, Frontend.cpp:221-269,
        558-1015). ``extra_flat``, the previous frame's solve output, is
        read back with the frame's outputs at their precision (float32 on
        the card), as the JAX package's loop reads it through the frame's
        one readback; it comes back as ``info["extra"]``. Returns (frames,
        info)."""
        prep = self.prepare_frame(estimator, images, sid, T_WS_pred7)
        ctx = self.dispatch_prepared(prep, extra_flat)
        return self.finish_frame(estimator, ctx, ctx["diag"].cpu().numpy())

    def prepare_frame(self, estimator, images, sid: int, T_WS_pred7: np.ndarray):
        """``frame_associate``'s inputs from the host records: the images
        quantised to uint8 (the program widens them), the landmark table's
        points, masks and initialised flags, the top-K
        overlap-ranked keyframes with their free keypoints, the previous
        dispatch's keypoints, the descriptor updates staged by the
        previous frame's bookkeeping, and this frame's RANSAC sampler."""
        from okvis2_torch.frontend.descriptor import DESCRIPTOR_BITS

        cfg = self.cfg
        with SwitchableTimer("1.1 prep: sync table"):
            self._sync_table(estimator)
        # host descriptor copies resolve only when this frame's signs are
        # fetched (keyframes): reset per frame
        self._desc_stage = []
        table = self.table
        NC = len(self.cameras)
        N = cfg.detection.max_keypoints
        with SwitchableTimer("1.2 prep: stack+quantise imgs"):
            imgs = np.stack(images)
            if imgs.dtype != np.uint8:
                imgs = (np.clip(imgs, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
        fdtype = self.cameras[0].focal.dtype  # the program's precision
        table.ensure(DESCRIPTOR_BITS, fdtype)

        cap = table.capacity
        KF = cfg.motion_stereo_keyframes
        _t_tbl = SwitchableTimer("1.3 prep: landmark table fill")
        _t_tbl.__enter__()
        hp = np.zeros((cap, 4))
        hp[:, 3] = 1.0
        lm_mask = np.zeros(cap, bool)
        lm_init = np.zeros(cap, bool)
        for lid, s in table.slot_of.items():
            lm = estimator.landmarks.get(lid)
            if lm is None:
                continue
            hp[s] = lm.hp_W
            lm_mask[s] = True
            lm_init[s] = lm.initialised
        _t_tbl.__exit__(None, None, None)

        # top-K overlap-ranked keyframes for motion stereo (Frontend.cpp:
        # 1742-1768); only the keyframes that exist go to the program
        with SwitchableTimer("1.4 prep: rank keyframes"):
            top_ids = self._rank_keyframes_by_overlap(estimator, T_WS_pred7, sid, hp, lm_mask,
                                                      KF)
        keyframes = None
        with SwitchableTimer("1.5 prep: kf stacks"):
            if top_ids:
                free = np.zeros((len(top_ids), NC, N), bool)
                T_kf = np.zeros((len(top_ids), 7))
                for k, kid in enumerate(top_ids):
                    kfr = self._kf_store[kid]
                    f = np.stack([fr["mask"] for fr in kfr]).copy()
                    for (_l, c, kp) in estimator.obs_of_state(kid):
                        if kp < N:
                            f[c, kp] = False
                    free[k] = f
                    T_kf[k] = estimator.states[kid].pose
                keyframes = {
                    "xy": torch.stack([self._kf_store[k][0]["stacked"]["xy"] for k in top_ids]),
                    "signs": torch.stack([self._kf_store[k][0]["stacked"]["signs"]
                                          for k in top_ids]),
                    "free": free, "valid": np.ones(len(top_ids), bool), "T_WS7": T_kf,
                }
        self._frame_counter += 1
        # descriptor-table updates staged by the previous frame's
        # bookkeeping fold into this frame's program
        upd = table.drain(_FLUSH_U)
        src = self._staged_signs_dev
        if src is None:
            src = torch.zeros((NC, N, DESCRIPTOR_BITS), dtype=fdtype, device=self.device)
        ffp = self._ff_prev
        do_ff = ffp is not None and ffp["sid"] in estimator.states
        prev = None
        if do_ff:
            prev = {"xy": ffp["xy"], "signs": ffp["signs"], "mask": ffp["mask"],
                    "T_WS7": estimator.states[ffp["sid"]].pose}
        sampler = None if self.ransac_sampler is None else self.ransac_sampler(self._frame_counter)
        return {
            "sid": sid, "imgs_u8": imgs, "T_WS7": np.array(T_WS_pred7),
            "landmarks": {"hp": hp, "mask": lm_mask, "init": lm_init},
            "keyframes": keyframes, "top_ids": top_ids, "do_ms": bool(top_ids),
            "staged": {"signs": src, "upd": upd}, "prev": prev,
            "ff_prev_sid": ffp["sid"] if do_ff else None, "sampler": sampler,
            "NC": NC, "N": N, "cap": cap,
            # the match rows reference table slots as of this prep; later
            # bookkeeping may release and reallocate slots, so consumers
            # map through these snapshots
            "slot_of": dict(table.slot_of), "slot_lid": table.slot_lid.copy(),
        }

    def dispatch_prepared(self, prep, extra_flat=None):
        """Run the tracking program on ``prepare_frame``'s inputs, adopt its
        descriptor table, and return the frame's ctx without reading
        anything back: the device-resident outputs ("stacked": keypoints
        and descriptors; "match": idx, keep, xy, size for the pipelined
        solve's device-side append; "diag": ``frame_diag``, with
        ``extra_flat`` appended) and the host context ``finish_frame``
        decodes them with."""
        out = frame_associate(
            self.cameras, np.stack(self.T_SC_np), prep["imgs_u8"], prep["T_WS7"],
            prep["landmarks"], self.table.signs, self.table.valid, self.cfg,
            staged=prep["staged"], keyframes=prep["keyframes"], prev=prep["prev"],
            generator=self._gen, sampler=prep["sampler"], device=self.device)
        ctx = self._adopt_dispatch(prep, out)
        ctx["match"] = {k: out[k] for k in ("idx", "keep", "xy", "size")}
        ctx["diag"] = frame_diag(out, extra_flat)
        ctx["ms_n"], ctx["ff_n"] = out["ms_rows"].shape[0], out["ff_rows"].shape[0]
        return ctx

    def _adopt_dispatch(self, prep, out):
        """Adopt the program's folded descriptor table; this dispatch's
        keypoints become the next one's frame-to-frame source."""
        table = self.table
        table.signs = out["tab_signs"]
        table.valid = out["tab_valid"]
        if not table._upd:
            # all descriptor writes consumed
            self._staged_signs_dev = None
        stacked = {"xy": out["xy"], "mask": out["mask"], "signs": out["signs"],
                   "signs_packed": out["signs_packed"]}
        self._ff_prev = {"sid": prep["sid"], "xy": out["xy"], "signs": out["signs"],
                         "mask": out["mask"]}
        return {"sid": prep["sid"], "stacked": stacked, "do_ms": prep["do_ms"],
                "top_ids": prep["top_ids"], "ff_prev_sid": prep["ff_prev_sid"],
                "NC": prep["NC"], "N": prep["N"], "cap": prep["cap"],
                "slot_of": prep["slot_of"], "slot_lid": prep["slot_lid"]}

    def finish_frame(self, estimator, ctx, diag: np.ndarray):
        """Decode the host copy of the frame's ``frame_diag`` and do the host
        bookkeeping: observations of the RANSAC survivors, frame-to-frame
        continuity, motion-stereo landmarks, descriptor staging
        (Frontend.cpp:558-1015). ``diag`` was read back at once
        (``associate_frame``) or came back with the frame's solve, frames
        later (the pipelined loop). Returns (frames, info)."""
        cfg = self.cfg
        table = self.table
        # leftovers the last fold could not take index an older frame's
        # signs: flush them before this frame's staging starts
        if table._upd:
            self._flush_staged()
        # per-finish staging: several frames can finish back to back; the
        # stage list only ever holds this frame's entries
        self._desc_stage = []
        sid = ctx["sid"]
        stacked = ctx["stacked"]
        top_ids = ctx["top_ids"]
        NC, N, cap = ctx["NC"], ctx["N"], ctx["cap"]

        off = 0

        def take(n, shape):
            nonlocal off
            v = diag[off:off + n]
            off += n
            return v.reshape(shape)

        xy = take(NC * N * 2, (NC, N, 2))
        size = take(NC * N, (NC, N))
        kp_mask = take(NC * N, (NC, N)) > 0.5
        idx = take(NC * cap, (NC, cap)).astype(np.int32)
        keep = take(NC * cap, (NC, cap)) > 0.5
        ms_rows = take(ctx["ms_n"] * 8, (ctx["ms_n"], 8))
        ff_rows = take(ctx["ff_n"] * 4, (ctx["ff_n"], 4))
        n_inl, ransac_ok = int(diag[off]), bool(diag[off + 1] > 0.5)
        rot_frac = float(diag[off + 2])
        ms_total, ff_total = int(diag[off + 3]), int(diag[off + 4])
        extra = diag[off + 5:]
        if ms_total > len(ms_rows):
            _warn_capacity("ms_rows", f"motion-stereo rows truncated ({ms_total} good > "
                           f"{len(ms_rows)} budget) — raise _MS_ROWS")
        if ff_total > len(ff_rows):
            _warn_capacity("ff_rows", f"frame-to-frame match rows truncated ({ff_total} good > "
                           f"{len(ff_rows)} budget) — raise _FF_ROWS")

        frames = [{"xy": xy[ci], "size": size[ci], "mask": kp_mask[ci], "stacked": stacked,
                   "cam": ci} for ci in range(NC)]
        self.last_ransac = {"num_inliers": n_inl, "ok": ransac_ok}

        # ---- observation insertion (RANSAC survivors only), resolved
        # through the table's slots as of the dispatch ----
        lid_of_dispatch = {s: lid for lid, s in ctx["slot_of"].items()}
        n_matched = 0
        for ci in range(NC):
            fr = frames[ci]
            for s in np.nonzero(keep[ci])[0]:
                lid = lid_of_dispatch.get(int(s))
                if lid is None or lid not in estimator.landmarks:
                    continue
                kp = int(idx[ci][s])
                estimator.add_observation(lid, sid, ci, kp, fr["xy"][kp], fr["size"][kp])
                table.stage_descriptor(lid, ci, kp)
                self._desc_stage.append((lid, ci, kp))
                n_matched += 1

        # ---- frame-to-frame continuity: a current keypoint the map match
        # missed, matched to a previous-frame keypoint that hosts a
        # landmark, observes that landmark (Frontend.cpp:1399-1504) ----
        n_ff = 0
        prev_sid = ctx.get("ff_prev_sid")
        if prev_sid is not None and prev_sid in estimator.states:
            host_of = {(c2, k2): l2 for (l2, c2, k2) in estimator.obs_of_state(prev_sid)}
            if host_of:
                cur_obs = estimator.obs_of_state(sid)
                cur_used = {(c2, k2) for (_l, c2, k2) in cur_obs}
                cur_lids = {l2 for (l2, _c, _k) in cur_obs}
                for r in ff_rows[ff_rows[:, 3] > 0.5]:
                    ci, a, b = int(r[0]), int(r[1]), int(r[2])
                    if b < 0 or ci >= NC:
                        continue
                    lid = host_of.get((ci, a))
                    if lid is None or lid not in estimator.landmarks:
                        continue
                    if (ci, b) in cur_used or lid in cur_lids:
                        continue
                    fr = frames[ci]
                    if not fr["mask"][b]:
                        continue
                    estimator.add_observation(lid, sid, ci, b, fr["xy"][b], fr["size"][b])
                    table.stage_descriptor(lid, ci, b)
                    self._desc_stage.append((lid, ci, b))
                    cur_used.add((ci, b))
                    cur_lids.add(lid)
                    n_ff += 1
        n_matched += n_ff

        # ---- motion-stereo landmark initialisation, vetoed when a pure
        # rotation explains nearly all keyframe<->current matches ----
        n_ms = 0
        if ctx["do_ms"] and rot_frac < cfg.rotation_only_veto:
            used_of = {s2: {(c2, k2) for (_l, c2, k2) in estimator.obs_of_state(s2)}
                       for s2 in set(top_ids) | {sid}}
            for r in ms_rows[ms_rows[:, 7] > 0.5]:
                k, ci = divmod(int(r[0]), NC)
                if k >= len(top_ids):
                    continue
                kid = top_ids[k]
                kfr = self._kf_store.get(kid)
                if kfr is None:
                    continue
                a, b = int(r[1]), int(r[2])
                if (ci, a) in used_of[kid] or (ci, b) in used_of[sid]:
                    continue
                used_of[kid].add((ci, a))
                used_of[sid].add((ci, b))
                fa = kfr[ci]
                fr = frames[ci]
                lid = estimator.add_landmark(r[3:7], initialised=True)
                estimator.add_observation(lid, kid, ci, a, fa["xy"][a], fa["size"][a])
                estimator.add_observation(lid, sid, ci, b, fr["xy"][b], fr["size"][b])
                table.stage_descriptor(lid, ci, b)
                self._desc_stage.append((lid, ci, b))
                n_ms += 1
        # no flush here: the staged updates fold into the next frame's
        # program; remember which frame's signs they index
        self._staged_signs_dev = stacked["signs"]
        return frames, {
            "num_matched": n_matched, "num_motion_stereo": n_ms, "num_ff": n_ff,
            "ransac_inliers": n_inl, "ransac_ok": ransac_ok, "rotation_only_frac": rot_frac,
            "extra": extra,
        }

    def _apply_fetched_signs(self, frames, packed, desc_stage):
        """Unpack the bit-packed uint32 descriptors and resolve staged
        ``lm_descriptors`` host copies."""
        NC, N = packed.shape[0], packed.shape[1]
        bits = ((packed[..., None] >> np.arange(32, dtype=np.uint32)) & 1).reshape(NC, N, -1)
        signs_np = np.where(bits > 0, 1.0, -1.0).astype(np.float32)
        # masked-out keypoints have all-zero sign rows in the float form
        for ci, fr in enumerate(frames):
            signs_np[ci] *= np.asarray(fr["mask"], np.float32)[:, None]
            fr["signs_np"] = signs_np[ci]
        for (lid, ci, kp) in desc_stage:
            if kp < signs_np.shape[1]:
                self._remember_descriptor(lid, signs_np[ci, kp])
        return signs_np

    def dispatch_keyframe_extras(self, estimator, frames, sid: int):
        """Start a keyframe's device work without waiting: the all-pairs
        static-stereo program (matchStereo, Frontend.cpp:1981-2150), then
        the copies of the bit-packed descriptors and of the stereo results
        to the host, two copies on one stream. ``finish_keyframe_extras``
        consumes them: at once in the synchronous loop, at the next finish
        in the pipelined loop. Returns the pending dict."""
        stacked = frames[0]["stacked"]
        stereo = self._dispatch_static_stereo(estimator, frames, sid)
        srcs = [stacked["signs_packed"]]
        if stereo is not None:
            srcs.append(_stereo_flat(stereo["out"]))
        pend = {"sid": sid, "frames": frames, "stereo": stereo, "fetch": _to_host_async(srcs),
                # the entries staged by this frame's finish_frame; the list
                # resets at the next finish, so keep them now
                "desc_stage": self._desc_stage}
        self._desc_stage = []
        return pend

    def finish_keyframe_extras(self, estimator, pend):
        """Consume a keyframe's extras: the descriptors (unpacked to the ±1
        convention; host copies of the staged landmarks' descriptors),
        static-stereo landmark insertion with the host-side dedup that
        reproduces the sequential pair order's keypoint consumption, the
        keyframe store. Returns the number of stereo-initialised
        landmarks."""
        host = _host_arrays(pend["fetch"])
        frames, sid = pend["frames"], pend["sid"]
        self._apply_fetched_signs(frames, host[0].view(np.uint32), pend["desc_stage"])
        n_new = 0
        if pend["stereo"] is not None:
            fetched = _decode_stereo_flat(host[1], len(pend["stereo"]["pairs"]),
                                          pend["stereo"]["N"])
            n_new = self._insert_static_stereo(estimator, frames, sid, pend["stereo"], fetched)
        self.remember_keyframe_frames(sid, frames)
        return n_new

    # ------------------------------------------------------------------
    def _flush_staged(self):
        """Apply descriptor updates still staged for the next frame's fold
        (call before any direct read of the device table)."""
        t = self.table
        src = self._staged_signs_dev
        if t._upd and src is not None:
            t.flush(src)
            self._staged_signs_dev = None

    def _remember_descriptor(self, lid: int, signs: np.ndarray):
        """Record a landmark's descriptor: the latest view in
        ``lm_descriptors`` and up to 3 distinct variants (bit-packed) in
        ``lm_desc_sets``; near-duplicates (< 16 of 512 bits apart) do not
        displace an existing variant."""
        signs = np.asarray(signs)
        self.lm_descriptors[lid] = signs
        packed = np.packbits(signs > 0)
        sets = self.lm_desc_sets.get(lid)
        if sets is None:
            self.lm_desc_sets[lid] = [packed]
            return
        for p in sets:
            if int(np.unpackbits(p ^ packed).sum()) < 16:
                return
        if len(sets) < 3:
            sets.append(packed)
        else:
            # keep the oldest (first-seen view) + the two newest variants
            sets[1] = sets[2]
            sets[2] = packed

    def _sync_table(self, estimator):
        """Free table slots of landmarks that no longer exist."""
        dead = [lid for lid in self.table.slot_of if lid not in estimator.landmarks]
        for lid in dead:
            self.table.release(lid)
            self.lm_descriptors.pop(lid, None)
            self.lm_desc_sets.pop(lid, None)

    # ------------------------------------------------------------------
    def _overlapping_pairs(self):
        """Camera pairs with FoV overlap (NCameraSystem::computeOverlaps
        role; all-pairs generalisation of matchStereo, Frontend.cpp:
        1981-2150)."""
        if self._overlap_pairs is None:
            from okvis2_torch.cameras.ncamera import NCameraSystem

            nc = len(self.cameras)
            if nc == 2:
                pairs = [(0, 1)]
            else:
                rig = NCameraSystem(list(self.cameras), list(self.extrinsics))
                pairs = [(i, j) for i in range(nc) for j in range(i + 1, nc)
                         if rig.has_overlap(i, j)]
            self._overlap_pairs = pairs
        return self._overlap_pairs

    def _dispatch_static_stereo(self, estimator, frames, sid: int):
        """The all-pairs static-stereo program on the device; returns
        {"out": (idx_b, hp_W, good, parallel) tensors, "pairs", "N"} or
        None when the rig has no overlapping pairs."""
        cfg = self.cfg
        if len(self.cameras) < 2:
            return None
        pairs = tuple(self._overlapping_pairs())
        if not pairs:
            return None
        rec = estimator.states[sid]
        stacked = frames[0]["stacked"]
        free = np.stack([np.asarray(f["mask"], bool) for f in frames])
        N = free.shape[1]
        for (_l, c, kp) in estimator.obs_of_state(sid):
            if kp < N:
                free[c, kp] = False
        T_WA7s = np.stack([se3_np.compose7(rec.pose, self.T_SC_np[ci]) for ci, _ in pairs])
        T_WB7s = np.stack([se3_np.compose7(rec.pose, self.T_SC_np[cj]) for _, cj in pairs])
        gates = [cfg.stereo_epipolar_gate / self._fx[ci] for ci, _ in pairs]
        out = _stereo_pairs(
            self.cameras, T_WA7s, T_WB7s, gates, cfg.min_depth, cfg.max_depth,
            free[[ci for ci, _ in pairs]], free[[cj for _, cj in pairs]],
            stacked["xy"], stacked["signs"], pairs, cfg.matching_threshold, True)
        return {"out": out, "pairs": pairs, "N": N}

    def _insert_static_stereo(self, estimator, frames, sid: int, pend, fetched):
        """Insert the fetched pair matches as new landmarks and
        observations; a keypoint consumed by an earlier pair (or already
        observed) cannot seed another landmark."""
        stacked = frames[0]["stacked"]
        idx_b, hp_W, good, parallel = fetched
        pairs = pend["pairs"]
        used = {(c, kp) for (_l, c, kp) in estimator.obs_of_state(sid)}
        n_new = 0
        for p, (ci, cj) in enumerate(pairs):
            fa, fb = frames[ci], frames[cj]
            for a in np.nonzero(good[p])[0]:
                a = int(a)
                b = int(idx_b[p][a])
                if (ci, a) in used or (cj, b) in used:
                    continue
                used.add((ci, a))
                used.add((cj, b))
                lid = estimator.add_landmark(hp_W[p][a], initialised=not parallel[p][a])
                estimator.add_observation(lid, sid, ci, a, fa["xy"][a], fa["size"][a])
                estimator.add_observation(lid, sid, cj, b, fb["xy"][b], fb["size"][b])
                if "signs_np" in fa:
                    self._remember_descriptor(lid, fa["signs_np"][a])
                self.table.stage_descriptor(lid, ci, a)
                n_new += 1
        self.table.flush(stacked["signs"])
        return n_new

    # ------------------------------------------------------------------
    def remember_keyframe_frames(self, sid: int, frames):
        """Store a keyframe's detection output (host xy/size/mask and the
        device-resident stacked tensors) for motion stereo; the store
        keeps up to max(2 K, 8) keyframes, evicting the oldest."""
        store = self._kf_store
        store[sid] = frames
        cap = max(2 * self.cfg.motion_stereo_keyframes, 8)
        for old in sorted(store)[:-cap]:
            del store[old]

    def _rank_keyframes_by_overlap(self, estimator, T_WS_pred7, sid: int, hp: np.ndarray,
                                   lm_mask: np.ndarray, top_k: int):
        """Rank stored keyframes by predicted view overlap with the current
        frame: the count of map landmarks inside both cam0 frusta (proxy of
        the reference's overlapFraction, ViSlamBackend.cpp:2341+). Returns
        up to top_k keyframe ids, best first."""
        cand = [s for s in self._kf_store if s != sid and s in estimator.states]
        if not cand:
            return []
        pts = hp[:, :3][lm_mask]
        if len(pts) < 8:
            # too few map points to rank: the most recent first
            return sorted(cand)[-top_k:][::-1]
        cam0 = self.cameras[0]
        fx = self._fx[0]
        half_w = (cam0.width * 0.5) / fx * 1.2
        half_h = (cam0.height * 0.5) / fx * 1.2

        def visible(pose7):
            T_WC = se3_np.compose7(pose7, self.T_SC_np[0])
            R = se3_np.quat_to_mat(T_WC[3:7])
            pc = (pts - T_WC[:3]) @ R  # world -> camera
            z = pc[:, 2]
            return (z > 0.2) & (np.abs(pc[:, 0]) < half_w * z) & (np.abs(pc[:, 1]) < half_h * z)

        cur = visible(np.asarray(T_WS_pred7))
        scored = sorted(((int((visible(estimator.states[s].pose) & cur).sum()), s)
                         for s in cand), reverse=True)
        top = [s for n, s in scored[:top_k] if n > 0]
        if not top:
            top = [max(cand)]
        return top

    # ------------------------------------------------------------------
    def _disk_offsets(self, r: int) -> np.ndarray:
        offs = self._disk_offs_cache.get(r)
        if offs is None:
            g = np.arange(-r, r + 1)
            dx, dy = np.meshgrid(g, g)
            m = dx * dx + dy * dy <= r * r
            offs = np.stack([dx[m], dy[m]], axis=-1)  # [(dx,dy)]
            self._disk_offs_cache[r] = offs
        return offs

    def _coverage_iou(self, ci: int, xy: np.ndarray, det_idx, match_idx):
        """Painted-disk coverage on a 1/10-scale mask: disks of radius
        0.09*min(rows,cols) at keypoint/10 positions; returns the
        (intersection, union) pixel counts of the matched disks vs all
        detection disks (doWeNeedANewKeyframe, Frontend.cpp:1072-1103)."""
        cam = self.cameras[ci]
        rows, cols = max(cam.height // 10, 1), max(cam.width // 10, 1)
        offs = self._disk_offsets(max(int(min(rows, cols) * 0.09), 1))

        def paint(idx):
            mask = np.zeros((rows, cols), bool)
            idx = np.asarray(list(idx), np.int64)
            if len(idx) == 0:
                return mask
            c = (np.asarray(xy)[idx] * 0.1).astype(np.int64)  # [n,2] x,y
            pix = c[:, None, :] + offs[None]  # [n,D,2]
            x = np.clip(pix[..., 0], 0, cols - 1).ravel()
            y = np.clip(pix[..., 1], 0, rows - 1).ravel()
            mask[y, x] = True
            return mask

        det = paint(det_idx)
        mat = paint(match_idx)
        return int((mat & det).sum()), int((mat | det).sum())

    def need_new_keyframe(self, estimator, frames, sid: int) -> bool:
        """Keyframe heuristic (doWeNeedANewKeyframe, Frontend.cpp:
        1057-1167): painted-disk coverage IoU of the matched keypoints vs
        all detections, for the current frame and for every stored
        keyframe (its keypoints hosting landmarks co-observed now), decided
        on the min of the two; the matched/detected count ratio is a
        second trigger."""
        cfg = self.cfg
        if self.last_keyframe_id is None:
            return True
        obs_sid = list(estimator.obs_of_state(sid))
        cur_lids = {lid for (lid, _c, _k) in obs_sid}
        best_ratio = 0.0
        inter = union = 0
        n_kp_total = 0
        for ci, fr in enumerate(frames):
            det_idx = np.nonzero(np.asarray(fr["mask"], bool))[0]
            n_kp_total += len(det_idx)
            match_idx = [kp for (_l, c, kp) in obs_sid if c == ci]
            if len(det_idx):
                best_ratio = max(best_ratio, len(match_idx) / len(det_idx))
            i, u = self._coverage_iou(ci, fr["xy"], det_idx, match_idx)
            inter += i
            union += u
        overlap = inter / union if union else 0.0
        # ... and seen from the stored keyframes (Frontend.cpp:1106-1156)
        overlap_others = 0.0
        for s, kf_frames in self._kf_store.items():
            if s == sid or s not in estimator.states:
                continue
            obs_k = list(estimator.obs_of_state(s))
            i_k = u_k = 0
            for ci, fr in enumerate(kf_frames):
                det_idx = np.nonzero(np.asarray(fr["mask"], bool))[0]
                match_idx = [kp for (lid, c, kp) in obs_k if c == ci and lid in cur_lids]
                i, u = self._coverage_iou(ci, fr["xy"], det_idx, match_idx)
                i_k += i
                u_k += u
            if u_k:
                overlap_others = max(overlap_others, i_k / u_k)
        overlap = min(overlap, overlap_others)
        if n_kp_total < 7 * len(frames):
            return False  # a respectable keyframe needs detections
        return overlap < cfg.keyframe_overlap_threshold or best_ratio < cfg.keyframe_matching_ratio

    def tracking_quality(self, estimator, frames, sid: int) -> float:
        """Fraction of grid cells with matches (trackingQuality analogue,
        ViSlamBackend.cpp:157-197)."""
        g = self.cfg.keyframe_grid
        total = 0
        matched_cells = set()
        obs_sid = estimator.obs_of_state(sid)
        for ci, fr in enumerate(frames):
            W, H = self.cameras[ci].width, self.cameras[ci].height
            matched = {kp for (_l, c, kp) in obs_sid if c == ci}
            for kp in matched:
                x, y = fr["xy"][kp]
                matched_cells.add((ci, int(x * g / W), int(y * g / H)))
            total += g * g
        return len(matched_cells) / max(total, 1)

