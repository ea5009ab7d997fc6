"""The pipelined loop's frame capture and its device-loop replay
(``okvis2_torch.pipeline.device_replay``), the port alone, on the CPU in
float64.

``tests/test_torch_slam.py``'s drive (192x128 stereo, 128 keypoints, 6
frames at 4 Hz, 1500 stars) through ``run_synthetic_vio(pipelined=True)``
with ``_bench_record`` set, at the loop's own lag (on the CPU mostly no
frame in flight at a dispatch) and with two frames kept in flight
(``force_min_pending=2``: three match sets per solve from the third frame
on). RANSAC draws from the frontend's generator, so the replay's
generator state is exercised. Held:
- one record per frame, with the live order of the appended sets;
- the replay's first pass in mode "full" equal to every live [solve
  output | diag] bit for bit, and its second pass equal to its first;
- with two frames in flight, mode "frontend"'s diagnostics equal to the
  live frame's, mode "solve" equal to mode "full";
- a replay of the last 3 records only equal to their live outputs;
- the system unchanged by a replay (trajectory, landmarks, the descriptor
  table, the generator's state, the frames in flight);
- on the CPU the transfer census counts no copy and no synchronisation.
No record is kept when the hook is unset, and the trajectory is the same
bit for bit with it and without (``tests/test_torch_pipelined.py``,
``test_capture_changes_nothing``, on its deep-lag runs).
"""

import numpy as np
import pytest
import torch

import chip_smoke
from okvis2_torch.graph.estimator import EstimatorConfig
from okvis2_torch.pipeline import device_replay as dr
from okvis2_torch.pipeline import slam as tslam
from okvis2_torch.pipeline import synthetic_run as tsr
from okvis2_torch.solver.packed_solve import MAX_APPEND_SETS

# tests/test_torch_slam.py's drive and capacities
DRIVE = dict(duration=1.5, frame_rate=4.0, width=192, height=128, max_keypoints=128,
             n_stars=1500)
EST = dict(window_slots=8, landmark_slots=192, obs_slots=1024, imu_seg_capacity=64)
LAGS = {"own": 0, "deep": 2}


class Recorded(tslam.SlamSystem):
    """The system with the frame capture set."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self._bench_record = []


def _run(hook: bool, min_pending: int):
    with pytest.MonkeyPatch.context() as mp:
        if hook:
            mp.setattr(tsr, "SlamSystem", Recorded)
        return tsr.run_synthetic_vio(estimator_config=EstimatorConfig(**EST),
                                     dtype=torch.float64, device="cpu", pipelined=True,
                                     force_min_pending=min_pending, **DRIVE)


@pytest.fixture(scope="module")
def drives():
    return {lag: _run(True, n) for lag, n in LAGS.items()}


@pytest.fixture(scope="module")
def full_replays(drives):
    return {lag: dr.replay_device_loop(res["slam"], res["slam"]._bench_record, n_pass=1)
            for lag, res in drives.items()}


@pytest.mark.parametrize("lag", sorted(LAGS))
def test_one_record_per_frame(drives, lag):
    res = drives[lag]
    records = res["slam"]._bench_record
    assert res["frames"] == len(records) == 6
    sids = [r["sid"] for r in records]
    assert sids == list(res["slam"].estimator.state_order)
    for r in records:
        s = r["set_sids"]
        assert len(s) == len(r["live_sets"]) == MAX_APPEND_SETS
        n_pending = s.index(r["sid"])
        # the frames in flight, oldest first, then the frame, padded with it
        assert s[:n_pending] == sids[sids.index(r["sid"]) - n_pending:sids.index(r["sid"])]
        assert s[n_pending:] == [r["sid"]] * (MAX_APPEND_SETS - n_pending)
        assert r["scfg"].max_iterations >= 1
    if LAGS[lag]:
        assert all(len(set(r["set_sids"])) == MAX_APPEND_SETS for r in records[2:])


@pytest.mark.parametrize("lag", sorted(LAGS))
def test_full_replay_equals_live(drives, full_replays, lag):
    records = drives[lag]["slam"]._bench_record
    rep = full_replays[lag]
    assert rep["frames"] == len(records) and rep["fps"] > 0
    for i, r in enumerate(records):
        live = dr.live_output(r)
        first = rep["first"][i].numpy()
        assert first.dtype == live.dtype and np.array_equal(first, live), (
            lag, i, np.abs(first - live).max())
        assert torch.equal(rep["outputs"][i], rep["first"][i]), (lag, i)


def test_frontend_and_solve_modes(drives, full_replays):
    lag = "deep"
    slam = drives[lag]["slam"]
    records = slam._bench_record
    fe = dr.replay_device_loop(slam, records, n_pass=1, mode="frontend")
    for i, r in enumerate(records):
        assert torch.equal(fe["first"][i], r["diag"]), (lag, i)
        assert torch.equal(fe["outputs"][i], r["diag"]), (lag, i)
    so = dr.replay_device_loop(slam, records, n_pass=1, mode="solve")
    for i in range(len(records)):
        assert torch.equal(so["first"][i], full_replays[lag]["first"][i]), (lag, i)
        assert torch.equal(so["outputs"][i], full_replays[lag]["first"][i]), (lag, i)


def test_replay_of_the_last_records_leaves_the_system_unchanged(drives):
    slam = drives["deep"]["slam"]
    records = slam._bench_record
    before = chip_smoke.system_state(slam)
    rep = dr.replay_device_loop(slam, records[-3:], n_pass=1, census=2)
    for i, r in enumerate(records[-3:]):
        assert np.array_equal(rep["first"][i].numpy(), dr.live_output(r)), i
    t = rep["transfers"]
    assert t["copies"] == t["unsized"] == t["syncs"] == [] and t["max_copy_bytes"] == 0
    chip_smoke.assert_same_state(before, chip_smoke.system_state(slam))


def test_replay_needs_the_card_of_a_card_system(drives, monkeypatch):
    """A system on the card replays on the card or fails: no CPU fallback."""
    slam = drives["own"]["slam"]
    monkeypatch.setattr(slam, "device", torch.device("cuda"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        dr.replay_device_loop(slam, slam._bench_record[-1:], n_pass=1)
