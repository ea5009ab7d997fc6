"""Runs with the timed path broken underneath, on the CPU at a small scale:
each fault must turn ``correct`` false. The harness's look for a card is
skipped (``run_cell`` is called directly); everything else of a run is
driven."""

import time

import pytest

from slambench import faults, harness

SMALL = {"scale": 0.3, "max_keypoints": 128, "warmup_frames": 3, "check_solves": 2}


def _run(workload, seconds=0.1, **extra):
    res, numbers = harness.run_cell(workload, 2 ** 35 + 11, seconds, False, time.time(),
                                    device="cpu", overrides=dict(SMALL, **extra),
                                    log=lambda m: None)
    return res, numbers


@pytest.mark.parametrize("workload", ["euroc-flight", "d455-walk"])
@pytest.mark.parametrize("fault", sorted(faults.SOLVE_FAULTS))
def test_broken_window_solve_is_refused(workload, fault):
    undo = faults.plant(fault)
    try:
        res, numbers = _run(workload)
    finally:
        undo()
    assert not res["correct"], numbers
    if fault == "unchanged":
        assert numbers["solve_step_gap_worst"] == pytest.approx(1.0, abs=1e-6)
        assert numbers["solve_cost_gap"] == pytest.approx(1.0, abs=1e-6)


def test_altered_keypoints_are_refused(monkeypatch):
    from okvis2_torch.pipeline import frontend_pipeline

    orig = frontend_pipeline.detect_keypoints_batch

    def shifted(images, cfg):
        out = dict(orig(images, cfg))
        out["xy"] = out["xy"].clone()
        out["xy"][:, :3, 0] += 1.0
        return out

    monkeypatch.setattr(frontend_pipeline, "detect_keypoints_batch", shifted)
    res, numbers = _run("euroc-flight")
    assert not res["correct"] and numbers["kp_mismatch"] >= 3


def test_altered_cnn_logits_are_refused(monkeypatch):
    from okvis2_torch.models import fast_scnn

    orig = fast_scnn.image_logits

    def altered(model, img):
        out = orig(model, img).clone()
        out[10, : out.shape[1] // 4] += 5.0  # sky over the top quarter
        return out

    monkeypatch.setattr(fast_scnn, "image_logits", altered)
    res, numbers = _run("d455-walk")
    assert not res["correct"] and numbers["cnn_class_differ"] > 0
