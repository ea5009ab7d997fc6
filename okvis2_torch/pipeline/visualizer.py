"""Debug visualisation.

Port of ``okvis2_tpu/pipeline/visualizer.py``: ViVisualizer (the
reference's okvis_multisensor_processing/src/ViVisualizer.cpp
drawMatches), TrajectoryOutput::drawTopView and
ViSlamBackend::drawOverheadImage (ViSlamBackend.cpp:951-1223) as simple
renderers that return images (callers decide whether to show or write
them). ``draw_keypoints``, ``draw_matches`` and ``draw_top_view`` draw
with cv2, imported when they are called; ``draw_overhead_image`` needs
only numpy. Inputs may be numpy arrays or tensors on any device.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch


def _host(a):
    """A tensor (any device) or array-like as a numpy array; None stays."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return None if a is None else np.asarray(a)


def draw_keypoints(image: np.ndarray, xy: np.ndarray, mask=None,
                   matched=None) -> np.ndarray:
    """Keypoint overlay: green = matched to a landmark, red = unmatched."""
    import cv2

    image, xy, mask = _host(image), _host(xy), _host(mask)
    if isinstance(matched, torch.Tensor):
        matched = set(matched.tolist())
    img = (np.clip(image, 0, 1) * 255).astype(np.uint8)
    vis = cv2.cvtColor(img, cv2.COLOR_GRAY2BGR)
    n = len(xy)
    for i in range(n):
        if mask is not None and not mask[i]:
            continue
        c = (0, 255, 0) if (matched is not None and i in matched) else (0, 0, 255)
        cv2.circle(vis, (int(xy[i, 0]), int(xy[i, 1])), 3, c, 1)
    return vis


def draw_matches(img_a: np.ndarray, xy_a: np.ndarray,
                 img_b: np.ndarray, xy_b: np.ndarray,
                 pairs: List[Tuple[int, int]]) -> np.ndarray:
    """Side-by-side match visualisation."""
    import cv2

    img_a, xy_a, img_b, xy_b = _host(img_a), _host(xy_a), _host(img_b), _host(xy_b)
    a = cv2.cvtColor((np.clip(img_a, 0, 1) * 255).astype(np.uint8),
                     cv2.COLOR_GRAY2BGR)
    b = cv2.cvtColor((np.clip(img_b, 0, 1) * 255).astype(np.uint8),
                     cv2.COLOR_GRAY2BGR)
    h = max(a.shape[0], b.shape[0])
    canvas = np.zeros((h, a.shape[1] + b.shape[1], 3), np.uint8)
    canvas[: a.shape[0], : a.shape[1]] = a
    canvas[: b.shape[0], a.shape[1]:] = b
    off = a.shape[1]
    for i, j in pairs:
        pa = (int(xy_a[i, 0]), int(xy_a[i, 1]))
        pb = (int(xy_b[j, 0]) + off, int(xy_b[j, 1]))
        cv2.line(canvas, pa, pb, (0, 200, 255), 1)
        cv2.circle(canvas, pa, 3, (0, 255, 0), 1)
        cv2.circle(canvas, pb, 3, (0, 255, 0), 1)
    return canvas


def draw_top_view(
    trajectory: List[Tuple[float, np.ndarray]],
    landmarks: Optional[np.ndarray] = None,
    size: int = 600,
) -> np.ndarray:
    """Overhead (x-y) trajectory + landmark map image."""
    import cv2

    canvas = np.full((size, size, 3), 255, np.uint8)
    if not trajectory:
        return canvas
    pts = np.stack([_host(p)[:2] for _, p in trajectory])
    landmarks = _host(landmarks)
    all_pts = pts
    if landmarks is not None and len(landmarks):
        all_pts = np.concatenate([pts, landmarks[:, :2]])
    lo = all_pts.min(axis=0) - 0.5
    hi = all_pts.max(axis=0) + 0.5
    scale = (size - 40) / max(float((hi - lo).max()), 1e-6)

    def to_px(p):
        q = (p - lo) * scale + 20
        return int(q[0]), size - int(q[1])

    if landmarks is not None:
        for lm in landmarks:
            cv2.circle(canvas, to_px(lm[:2]), 1, (180, 180, 180), -1)
    for i in range(1, len(pts)):
        cv2.line(canvas, to_px(pts[i - 1]), to_px(pts[i]), (200, 80, 0), 2)
    cv2.circle(canvas, to_px(pts[-1]), 5, (0, 0, 255), -1)
    return canvas


def draw_overhead_image(
    estimator,
    size: int = 512,
    margin: float = 1.0,
) -> np.ndarray:
    """Debug overhead map (ViSlamBackend::drawOverheadImage,
    okvis_ceres/src/ViSlamBackend.cpp:951-1223): trajectory (bright),
    keyframes (brighter dots), landmarks (dim), current pose marked.
    Returns a grayscale float image [size, size]."""
    img = np.zeros((size, size), np.float32)
    ids = estimator.state_order
    if not ids:
        return img
    traj = np.stack([_host(estimator.states[s].pose)[:3] for s in ids])
    hps = [(_host(lm.hp_W), lm.initialised) for lm in estimator.landmarks.values()]
    pts = [hp[:3] / hp[3] for hp, ok in hps if abs(hp[3]) > 1e-6 and ok]
    allxy = traj[:, :2]
    lo = allxy.min(axis=0) - margin
    hi = allxy.max(axis=0) + margin
    span = max(float((hi - lo).max()), 1e-6)

    def to_px(p):
        q = (np.asarray(p[:2]) - lo) / span * (size - 1)
        return int(q[0]), size - 1 - int(q[1])

    for p in pts:
        x, y = to_px(p)
        if 0 <= x < size and 0 <= y < size:
            img[y, x] = max(img[y, x], 0.25)
    for k in range(len(traj) - 1):
        a = np.asarray(to_px(traj[k]))
        b = np.asarray(to_px(traj[k + 1]))
        n = int(np.abs(b - a).max()) + 1
        for t in np.linspace(0, 1, n):
            x, y = (a + t * (b - a)).astype(int)
            if 0 <= x < size and 0 <= y < size:
                img[y, x] = 0.7
    for s in ids:
        if estimator.states[s].is_keyframe:
            x, y = to_px(_host(estimator.states[s].pose)[:3])
            if 1 <= x < size - 1 and 1 <= y < size - 1:
                img[y - 1:y + 2, x - 1:x + 2] = 0.9
    x, y = to_px(traj[-1])
    if 2 <= x < size - 2 and 2 <= y < size - 2:
        img[y - 2:y + 3, x - 2:x + 3] = 1.0
    return img
