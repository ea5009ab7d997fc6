"""The textured drive with CNN suppression, on the CPU: the port's
``run_synthetic_vio(dataset="textured")`` with ``SlamSystem(cnn_params=
<committed weights>)``, 6 frames at 4 Hz on the default trajectory at
256x384 (f = 240, so that the sky ceiling and the person occluder are in
view; 256 keypoints; float64 cameras), in the synchronous loop and in the
pipelined one (one frame kept in flight, suppression one frame deferred).
At 128x192 (f = 120, 128 keypoints) the drive suppresses nothing: over 12
frames and 8 keyframes no keypoint with a landmark lands on a pixel the
network calls sky or person; at 256x384 the first keyframes suppress 3
and 5 landmarks.

Each keyframe's suppression is recorded with its inputs (the images, the
keyframe's keypoints, its observations and the landmarks' information
scales before it) and the JAX package's ``CnnSuppressor`` runs on the same
inputs: it must suppress the same landmarks, so the count per keyframe is
the JAX package's. The JAX package's own SLAM loop is not driven here:
compiling its frame program alone takes longer than this file's minute
(``tests/test_torch_slam.py``: ~106 s for 6 frames); phase 12 of
``chip_smoke.py`` holds the port's drive on the card against the JAX
loop's (``tools/e2e_reference_jax.py``).
"""

import functools

import numpy as np
import pytest
import torch

from okvis2_torch.graph.estimator import EstimatorConfig as TEst
from okvis2_torch.pipeline import slam as tslam
from okvis2_torch.pipeline import synthetic_run as tsr
from okvis2_tpu.models import suppression as jsup
from test_torch_cnn_suppression import WEIGHTS, _Records

DRIVE = dict(duration=1.5, frame_rate=4.0, width=384, height=256, max_keypoints=256)
EST = dict(window_slots=8, landmark_slots=384, obs_slots=2048, imu_seg_capacity=64)


def _recording(records):
    """SlamSystem with CNN suppression on, each suppression recorded."""

    class Recording(tslam.SlamSystem):
        def __init__(self, *a, **kw):
            super().__init__(*a, cnn_params=WEIGHTS, **kw)
            suppress = self.cnn.suppress

            def recorded(est, frames, sid, images):
                obs = list(est.obs_of_state(sid))
                scales = {lid: est.landmarks[lid].info_scale for lid, _, _ in obs
                          if lid in est.landmarks}
                n = suppress(est, frames, sid, images)
                records.append({
                    "sid": sid, "n": n, "xy": [np.array(f["xy"]) for f in frames],
                    "images": [np.array(im) for im in images], "obs": obs, "scales": scales,
                    "set": {lid: est.landmarks[lid].info_scale for lid in scales
                            if est.landmarks[lid].info_scale != scales[lid]}})
                return n

            self.cnn.suppress = recorded

    return Recording


@pytest.fixture(scope="module")
def drives():
    out = {}
    for name, pipelined in (("sync", False), ("pipelined", True)):
        records = []
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(tsr, "SlamSystem", _recording(records))
            mp.setattr(tsr, "small_rig", functools.partial(tsr.small_rig, f=240.0))
            res = tsr.run_synthetic_vio(estimator_config=TEst(**EST), dtype=torch.float64,
                                        device="cpu", dataset="textured", pipelined=pipelined,
                                        force_min_pending=1 if pipelined else 0, **DRIVE)
        out[name] = (res, records)
    return out


@pytest.mark.parametrize("loop", ["sync", "pipelined"])
def test_suppression_per_keyframe_matches_jax(drives, loop):
    res, records = drives[loop]
    slam = res["slam"]
    jsupp = jsup.CnnSuppressor(WEIGHTS)
    counts = []
    for rec in records:
        stand_in = _Records(rec["obs"], rec["scales"])
        n = jsupp.suppress(stand_in, [{"xy": xy} for xy in rec["xy"]], rec["sid"], rec["images"])
        assert stand_in.set == rec["set"], rec["sid"]
        counts.append((rec["sid"], rec["n"], n))
    print(f"{loop}: ATE {res['ate_rmse']:.4f} m, (keyframe, suppressed, JAX) {counts}")
    assert [c[1] for c in counts] == [c[2] for c in counts]
    est = slam.estimator
    assert all(est.states[r["sid"]].is_keyframe for r in records if r["sid"] in est.states)
    assert len(records) >= 2 and sum(c[1] for c in counts) >= 1
    assert slam.cnn.num_suppressed == sum(c[1] for c in counts)
    assert res["frames"] == 6 and np.isfinite(res["ate_rmse"]) and res["ate_rmse"] < 0.10
