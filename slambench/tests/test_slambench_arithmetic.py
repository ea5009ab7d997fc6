"""The metric arithmetic on hand cases."""

import math

import numpy as np
import pytest

from slambench import harness, trace
from slambench.reference import check


def _read(name, ctx):
    return harness.reader(name)(ctx)


def test_whole_window_rates():
    ctx = {"frame_s": [1.0, 2.0, 3.0, 4.0], "inside_s": 10.0}
    assert _read("frames_per_s", ctx) == pytest.approx(0.4)
    assert _read("frames_per_s", dict(ctx, frame_s=[])) is None


def test_stage_totals_per_frame_and_keyframe():
    ctx = {"frame_s": [1.0] * 4, "keyframes": 2,
           "timing": {"1 frontend (fused)": (0.8, 4), "3.2 solve": (2.0, 4),
                      "2.05 keyframe extras": (0.3, 2), "2.06 place recognition": (0.1, 2)}}
    assert _read("frontend_ms_per_frame", ctx) == pytest.approx(200.0)
    assert _read("window_solve_ms_per_frame", ctx) == pytest.approx(500.0)
    assert _read("keyframe_tail_ms_per_keyframe", ctx) == pytest.approx(200.0)
    assert _read("keyframe_tail_ms_per_keyframe", dict(ctx, keyframes=0)) is None


def test_union_idle_share():
    assert trace.union([(0, 2), (1, 3), (5, 6), (5.5, 5.7)]) == [(0, 3), (5, 6)]
    tr = {"busy_s": 4.0, "window_s": 16.0, "kernels": 30, "ops": {}, "idle_by_stage": {}}
    ctx = {"trace": tr, "traced_frames": 3}
    assert _read("device_idle_share.loop", ctx) == pytest.approx(75.0)
    assert _read("kernels_per_frame", ctx) == pytest.approx(10.0)
    assert _read("device_idle_share.loop", {}) is None


def test_harris_roofline_bytes():
    rig = {"cameras": [{"size": [752, 480]}, {"size": [752, 480]}]}
    # 12 bytes per pixel of the stack: 8.66 MB, 2.585 us at 3.35 TB/s
    t_bound = 12 * 2 * 480 * 752 / 3.35e12
    tr = {"ops": {"harris_nms_kernel(...)": (4, 4 * 2 * t_bound), "other": (9, 1.0)}}
    ctx = {"trace": tr, "rig": rig}
    assert _read("harris_nms_roofline", ctx) == pytest.approx(50.0)
    assert _read("harris_nms_roofline", dict(ctx, trace={"ops": {"x": (1, 1.0)}})) is None


def test_aligned_ate():
    rng = np.random.default_rng(0)
    gt = rng.normal(size=(20, 3))
    a = 0.3
    R = np.array([[math.cos(a), -math.sin(a), 0], [math.sin(a), math.cos(a), 0], [0, 0, 1]])
    est = gt @ R.T + np.array([1.0, -2.0, 0.5])
    assert check.umeyama_ate(est, gt) < 1e-12
    est[0] += np.array([0.0, 0.0, 1.0])
    assert 0.1 < check.umeyama_ate(est, gt) < 0.3


def test_breakdown_keeps_ten_of_each():
    s = {"ops": {f"k{i}": (1, float(i)) for i in range(15)},
         "idle_by_stage": {f"s{i}": float(i) for i in range(12)}}
    b = trace.breakdown(s)
    assert len(b["device_ops"]) == 10 and b["device_ops"][0] == ["k14", 14.0]
    assert len(b["idle_gaps"]) == 10 and b["idle_gaps"][0] == ["s11", 11.0]


def test_trace_reduction_charges_idle_to_the_innermost_stage():
    # host s; the marker starts on the device 5 us after its launch
    t_mark, t_end = 1.0, 1.0 + 100e-6
    off = 5.0

    def dev(t_host_us):
        return t_mark * 1e6 + t_host_us + off

    ev = [("marker", dev(0), 1.0), ("harris_nms_kernel", dev(10), 10.0),
          ("gemm", dev(15), 10.0), ("Memcpy HtoD", dev(60), 5.0)]
    spans = [("3 optimise dispatch", t_mark + 40e-6, t_mark + 90e-6),
             ("3.1 pack_np", t_mark + 42e-6, t_mark + 58e-6)]
    s = trace.reduce(ev, t_mark, t_end, spans)
    # busy: [10, 25] and [60, 65] us after the marker's launch + offset
    assert s["busy_s"] == pytest.approx(20e-6)
    assert s["window_s"] == pytest.approx(100e-6)
    assert s["kernels"] == 2
    idle = s["idle_by_stage"]
    # gaps [0, 10], [25, 60], [65, 100] us after the marker's launch,
    # charged by their midpoints 5, 42.5 and 82.5
    assert idle["outside the port's timers"] == pytest.approx(10e-6)
    assert idle["3.1 pack_np"] == pytest.approx(35e-6)
    assert idle["3 optimise dispatch"] == pytest.approx(35e-6)


def test_reference_lm_settings_come_from_the_configuration():
    """The reference's iteration budget is the configuration's, whatever the
    program did: the maximum, or under a realtime budget the program's
    count held to [min, max]."""
    from slambench.generator import load_json

    euroc, d455 = load_json("configs", "euroc"), load_json("configs", "d455")
    for n in (1, 2, 3, 10, 30):
        s = harness.lm_settings(euroc, n)
        assert s["max_iterations"] == 10 and "about" not in s
        assert s["min_cost_decrease"] == 1e-6 and s["step_tolerance"] == 1e-5
    assert [harness.lm_settings(d455, n)["max_iterations"] for n in (1, 2, 3, 7, 10, 12)] == \
        [3, 3, 3, 7, 10, 10]


def test_reservoir_keeps_a_seeded_uniform_sample():
    from slambench.drive import Reservoir

    def draw(seed, n=50, k=3):
        r = Reservoir(k, seed, 1)
        for i in range(n):
            r.offer(i)
        return r.items()

    assert draw(2 ** 34 + 1) == draw(2 ** 34 + 1)
    assert [i for i, _ in draw(5, n=2)] == [0, 1]
    counts = np.zeros(50)
    for s in range(3000):
        kept = draw(s)
        assert len(kept) == 3 and [i for i, it in kept] == [it for _, it in kept]
        counts[[i for i, _ in kept]] += 1
    assert counts.min() > 0.6 * counts.mean() and counts.max() < 1.4 * counts.mean()


def test_step_gap_is_the_worst_leafs_share_of_the_reference_step():
    import torch

    t = lambda *v: torch.tensor(v, dtype=torch.float64)  # noqa: E731
    leaves = {"pos": (t(3.0, 4.0), t(0.0, 10.0)),  # 5 of 10
              "vel": (t(1.0), t(4.0)),  # 1 of 4
              "bias": (t(1e-6), t(1e-9))}  # barely moves: floored at the median step, 4
    g = check.step_gaps(leaves)
    assert g["step_gap"] == pytest.approx(0.5) and g["step_gap_leaf"] == "pos"
    assert g["step_gap_leaves"]["bias"] == pytest.approx(2.5e-7)
    same = {k: (s, s) for k, (_g, s) in leaves.items()}  # a solve that returns its start
    assert check.step_gaps(same)["step_gap"] == pytest.approx(1.0)


def test_lm_iterations_per_solve():
    assert _read("lm_iterations_per_solve", {"lm_iterations": [3, 3, 10, 8]}) == pytest.approx(6.0)
    assert _read("lm_iterations_per_solve", {"lm_iterations": []}) is None
