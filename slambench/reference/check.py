"""The numbers that decide ``correct``: what the timed path produced, held
to the plain references and to the generator's ground truth.

Each function returns {name: value}; the harness sets each beside its
limit from the cell's limits file. Everything here runs after the window
has closed and the device's peak memory has been read. It imports
nothing of the port.
"""

from __future__ import annotations

import numpy as np
import torch

from slambench.reference import fast_scnn, harris, lm


def detection(records, max_keypoints: int) -> dict:
    """Keypoints the frontend detected on the timed frames against the plain
    detector on the same images: the most keypoints (positions and validity)
    that differ on any camera of any compared frame. Exact."""
    worst = 0
    for images, out in records:
        ref = harris.detect(images.to(torch.float32), max_keypoints)
        xy, m = out["xy"].to(torch.float32), out["mask"]
        if xy.shape != ref["xy"].shape:
            return {"kp_mismatch": float(xy.shape[1] + ref["xy"].shape[1])}
        same = (m == ref["mask"]) & (~m | torch.all(xy == ref["xy"], dim=-1))
        worst = max(worst, int((~same).sum(-1).max()))
    return {"kp_mismatch": float(worst)}


def _gaps(prog, ref: dict, P) -> dict:
    """Largest gaps between the program's solved state and the reference's:
    positions of the states in use (m), rotations (rad), velocities (m/s),
    gyro and accelerometer biases, landmarks in use (relative to their
    distance from the first state in use); and ``step_gap``, the gap of
    the worst leaf against the reference's own step from the pack's start
    (below)."""
    used = torch.nonzero(P.state_mask)[:, 0]
    pp = prog["pose"][used].to(lm.F64)
    rp, sp = ref["pose"][used], P.pose[used]
    pos = torch.linalg.norm(pp[:, :3] - rp[:, :3], dim=-1)
    unit = lambda q: q / torch.linalg.norm(q, dim=-1, keepdim=True)  # noqa: E731
    rot_gap = lm.qlog(lm.qmul(unit(pp[:, 3:]), lm.qconj(rp[:, 3:])))
    rot_step = lm.qlog(lm.qmul(rp[:, 3:], lm.qconj(unit(sp[:, 3:]))))
    rot = torch.linalg.norm(rot_gap, dim=-1)
    hl = prog["landmarks"][P.lm_sel].to(lm.F64)
    pl, rl = hl[:, :3] / hl[:, 3:4], ref["landmarks"][:, :3] / ref["landmarks"][:, 3:4]
    sl = P.lm[:, :3] / P.lm[:, 3:4]
    dl = torch.linalg.norm(pl - rl, dim=-1)
    dist = torch.linalg.norm(rl - rp[:1, :3], dim=-1).clamp(min=0.1)
    psb, rsb, ssb = prog["speed_bias"][used].to(lm.F64), ref["speed_bias"][used], P.sb[used]
    sb = (psb - rsb).abs()
    leaves = {"pos": (pp[:, :3] - rp[:, :3], rp[:, :3] - sp[:, :3]), "rot": (rot_gap, rot_step),
              "vel": (psb[:, :3] - rsb[:, :3], rsb[:, :3] - ssb[:, :3]),
              "bias_g": (psb[:, 3:6] - rsb[:, 3:6], rsb[:, 3:6] - ssb[:, 3:6]),
              "bias_a": (psb[:, 6:9] - rsb[:, 6:9], rsb[:, 6:9] - ssb[:, 6:9]),
              "lm": (pl - rl, rl - sl)}
    return {"pose_m": float(pos.max()), "rot_rad": float(rot.max()),
            "vel_mps": float(sb[:, :3].max()), "bias_g": float(sb[:, 3:6].max()),
            "bias_a": float(sb[:, 6:9].max()),
            "lm_rel": float((dl / dist).max()) if len(dl) else 0.0,
            "lm_rel_median": float((dl / dist).median()) if len(dl) else 0.0,
            **step_gaps(leaves)}


def step_gaps(leaves: dict) -> dict:
    """The solve's gap to the reference as a share of the reference's own
    step, leaf by leaf: ||program - reference|| over ||reference - start||
    of each leaf (every state or landmark in use), the step floored at the
    median leaf's step, since a leaf that hardly moves in the reference
    would read its round-off. ``step_gap`` is the worst leaf's (a solve
    that returns its start reads 1 on the leaves that move most),
    ``step_gap_median_leaf`` the median leaf's."""
    norm = {k: (float(torch.linalg.norm(g)), float(torch.linalg.norm(s)))
            for k, (g, s) in leaves.items()}
    floor = float(np.median([s for _g, s in norm.values()]))
    share = {k: g / max(s, floor, 1e-300) for k, (g, s) in norm.items()}
    worst = max(share, key=share.get)
    return {"step_gap": share[worst], "step_gap_leaf": worst,
            "step_gap_median_leaf": float(np.median(list(share.values()))),
            "step_gap_leaves": share}


def solve(problem, prog: dict, rig: dict, settings: dict, device) -> dict:
    """One solve followed by the float64 reference from the same pack, with
    the configuration's LM settings (``settings``: those of
    ``reference.lm.solve``): the gaps, the iteration counts (the
    program's, the reference's), and the program's answer on the
    reference's cost: ``cost_gap`` is its excess over the reference's
    final cost as a share of the reference's own decrease (a solve that
    returns its start reads 1)."""
    ref = lm.solve(problem, rig, settings, device)
    P, R = ref["problem"], ref["rig"]
    out = _gaps(prog, ref, P)
    x = (prog["pose"].to(lm.F64), prog["speed_bias"].to(lm.F64), prog["extrinsics"].to(lm.F64),
         prog["landmarks"][P.lm_sel].to(lm.F64))
    c_prog = float(lm.cost(P, R, x, settings["cauchy_scale"]))
    c0, c1 = ref["initial_cost"], ref["final_cost"]
    out["cost_excess"] = (c_prog - c1) / max(c1, 1e-12)
    out["cost_gap"] = (c_prog - c1) / max(c0 - c1, 1e-12 * max(c0, 1e-12))
    out["iterations"] = (int(prog["iterations"]), ref["iterations"])
    return out


def cnn(records, weights_path: str, device) -> dict:
    """Logits of the CNN gate on the timed keyframes against the plain
    network on the same images: the largest gap as a share of the
    reference's largest logit magnitude, and the share of pixels whose
    class differs."""
    W = fast_scnn.Weights(weights_path, device)
    gap, differ, total = 0.0, 0, 0
    for img, logits in records:
        ref = fast_scnn.image_logits(W, img.to(device=device, dtype=torch.float32))
        got = logits.to(torch.float32)
        gap = max(gap, float((got - ref).abs().max() / ref.abs().max()))
        differ += int((got.argmax(0) != ref.argmax(0)).sum())
        total += ref[0].numel()
    return {"cnn_logit_gap": gap, "cnn_class_differ": differ / max(total, 1)}


def umeyama_ate(est: np.ndarray, gt: np.ndarray) -> float:
    """RMS position error after the rigid alignment (rotation and
    translation) of the estimate onto the ground truth."""
    mu_e, mu_g = est.mean(0), gt.mean(0)
    E, G = est - mu_e, gt - mu_g
    U, _, Vt = np.linalg.svd(G.T @ E)
    Dg = np.eye(3)
    Dg[2, 2] = np.sign(np.linalg.det(U @ Vt))
    R = U @ Dg @ Vt
    err = (R @ E.T).T - G
    return float(np.sqrt((err ** 2).sum(-1).mean()))
