"""How far the two-pose marginalisation factor moves with its precision.

Runs the port's synchronous loop on the CPU with the bench's system on
chip_smoke.py's pose-graph drive (SLAM_DRIVES["slam pose graph"]: one 5 s
circle at 8 Hz, 2 window keyframes) at a reduced image size, keeps each
two-pose factor's inputs, and prints per factor the distance of its
information (sqrt_info^T sqrt_info) from the float64 one, relative to its
norm: computed in float32 (as the JAX package computes it on the TPU), and
in float64 with the landmarks changed by 1e-15 of their size.

    python tools/two_pose_precision.py [width height keypoints]

(defaults 376 240 256; about a minute on a CPU).
"""

import contextlib
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


@contextlib.contextmanager
def float32_standing_for_float64(torch):
    """``compute_two_pose_factor`` casts to ``torch.float64``: make that
    float32 for the block."""
    f64 = torch.float64
    torch.float64 = torch.float32
    try:
        yield
    finally:
        torch.float64 = f64


def main(argv):
    import numpy as np
    import torch

    import chip_smoke as cs
    from okvis2_torch.core.se3 import Transformation
    from okvis2_torch.frontend import DetectionConfig
    from okvis2_torch.graph import estimator as est_mod
    from okvis2_torch.pipeline.dataset import SyntheticDataset
    from okvis2_torch.pipeline.frontend_pipeline import FrontendConfig
    from okvis2_torch.pipeline.slam import SlamSystem

    cs.W, cs.H = (int(argv[1]), int(argv[2])) if len(argv) > 2 else (376, 240)
    n_kp = int(argv[3]) if len(argv) > 3 else 256
    d = cs.SLAM_DRIVES["slam pose graph"]
    cams, T_SC, imu = cs.tracking_rig("cpu")
    exts = [Transformation(r=torch.tensor(T[:3], dtype=torch.float32),
                           q=torch.tensor(T[3:], dtype=torch.float32)) for T in T_SC]
    ds = SyntheticDataset(cams, exts, imu, n_stars=2500, duration=d["frames"] / d["rate"],
                          frame_rate=d["rate"], imu_rate=200.0, seed=0,
                          trajectory=d["trajectory"], device="cpu")
    est_cfg = est_mod.EstimatorConfig(window_slots=12, landmark_slots=512, obs_slots=4096,
                                      imu_seg_capacity=64, enforce_realtime=True,
                                      realtime_time_limit=1.0 / 200.0,
                                      num_keyframes=d["num_keyframes"])
    fe_cfg = FrontendConfig(detection=DetectionConfig(max_keypoints=n_kp),
                            map_match_capacity=cs.TRACK_CAP)
    slam = SlamSystem(cams, exts, imu, est_cfg, fe_cfg, device="cpu")
    factor, kept = est_mod.compute_two_pose_factor, []

    def keep(*a, **kw):
        kept.append(a)
        return factor(*a, **kw)

    est_mod.compute_two_pose_factor = keep
    try:
        for ev in ds.stream():
            if ev[0] == "imu":
                slam.add_imu_measurement(ev[1], ev[2], ev[3])
                continue
            slam.add_images(ev[1], [(np.clip(im, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
                                    for im in ev[2]])
            slam.process_frame()
    finally:
        est_mod.compute_two_pose_factor = factor

    def info(a):
        s = factor(*a)["sqrt_info"].double()
        return s.T @ s

    gen = torch.Generator().manual_seed(0)
    rows = []
    for a in kept:
        ref = info(a)
        with float32_standing_for_float64(torch):
            i32 = info(a)
        hp = a[3].double()
        moved = info((*a[:3], hp * (1 + 1e-15 * torch.randn(hp.shape, generator=gen,
                                                            dtype=hp.dtype)), *a[4:]))
        rel = lambda x: float(torch.linalg.norm(x - ref) / torch.linalg.norm(ref))  # noqa: E731
        rows.append({"float32": rel(i32), "float64, landmarks moved by 1e-15": rel(moved)})
        print(json.dumps(rows[-1]), flush=True)
    print(json.dumps({
        "image": [cs.W, cs.H], "keypoints": n_kp, "factors": len(rows),
        "float32 max": max(r["float32"] for r in rows),
        "float32 min": min(r["float32"] for r in rows),
        "float64 sensitivity max": max(r["float64, landmarks moved by 1e-15"] for r in rows),
    }))


if __name__ == "__main__":
    main(sys.argv)
