"""Rehearsals of whole runs on the CPU at a small scale: the result line's
keys, discovery of a cell added as files only, the exits without a card
or with JAX loaded."""

import json
import os
import shutil
import subprocess
import sys
import time

import pytest

from slambench import harness

ROOT = harness.ROOT
SMALL = {"scale": 0.3, "max_keypoints": 128, "warmup_frames": 2, "check_solves": 1}


def test_rehearsal_prints_the_contracts_keys():
    res, numbers = harness.run_cell("euroc-flight", 2 ** 33 + 5, 0.1, False, time.time(),
                                    device="cpu", overrides=SMALL, log=lambda m: None)
    assert list(res) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert set(res["metrics"]) == {"setup_s", "frames_per_s"}
    for m in res["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert set(res["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert set(res["checks"]) == set(json.load(open(os.path.join(
        ROOT, "slambench", "limits", "euroc-flight.json"))))
    for c in res["checks"].values():
        assert set(c) == {"value", "limit"}
    assert numbers["kp_mismatch"] == 0
    assert harness.forbidden_modules() == []
    json.dumps(res)


def test_a_cell_added_as_files_only_is_found(tmp_path):
    """A configuration, a traffic mix, a metric reader and a limits file
    added as new files, and entries added to BENCHMARK.json: the harness
    runs the new cell and reports the new metric, with no file edited."""
    shutil.copytree(os.path.join(ROOT, "slambench"), tmp_path / "slambench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    sb = tmp_path / "slambench"
    cfg = json.load(open(sb / "configs" / "euroc.json"))
    cfg["name"] = "euroc_copy"
    json.dump(cfg, open(sb / "configs" / "euroc_copy.json", "w"))
    tr = json.load(open(sb / "traffic" / "flight.json"))
    tr["trajectory"]["position"][0]["v"] = 0.25
    json.dump(tr, open(sb / "traffic" / "slow_flight.json", "w"))
    (sb / "metrics" / "frames_seen.py").write_text(
        "def read(ctx):\n    return float(len(ctx['frame_s']))\n")
    json.dump({"kp_mismatch": 0}, open(sb / "limits" / "euroc_copy-slow_flight.json", "w"))
    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    bench["configs"].append(dict(bench["configs"][0], name="euroc_copy",
                                 file="slambench/configs/euroc_copy.json"))
    bench["workloads"].append({"name": "euroc_copy-slow_flight", "config": "euroc_copy",
                               "traffic": "slow_flight", "chips": 1, "why": "a test"})
    bench["end_to_end"].append({"name": "frames_seen", "unit": "frames", "better": "higher",
                                "bound": 0.1, "source": "host_clock",
                                "workloads": ["euroc_copy-slow_flight"]})
    json.dump(bench, open(tmp_path / "BENCHMARK.json", "w"))
    code = (
        "import sys, time, json; sys.path.insert(1, %r)\n"
        "from slambench import harness\n"
        "assert harness.ROOT == %r, harness.ROOT\n"
        "res, _ = harness.run_cell('euroc_copy-slow_flight', 7, 0.1, False, time.time(),"
        " device='cpu', overrides=%r, log=lambda m: None)\n"
        "print(json.dumps(res))\n" % (ROOT, str(tmp_path), SMALL))
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                         text=True, timeout=600, env=dict(os.environ, OMP_NUM_THREADS="2"))
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["metrics"]["frames_seen"]["value"] >= 1
    assert res["checks"] == {"kp_mismatch": {"value": 0.0, "limit": 0}}


def test_no_card_no_result():
    """Without a card the command exits non-zero and prints no result."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, "slambench/run.py", "--workload", "euroc-flight",
                          "--seed", str(2 ** 40), "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_jax_modules_are_found_by_top_level_name(monkeypatch):
    monkeypatch.setitem(sys.modules, "okvis2_tpu.pipeline", object())
    monkeypatch.setitem(sys.modules, "jaxlib_something_else", object())
    assert harness.forbidden_modules() == ["okvis2_tpu"]
    monkeypatch.setitem(sys.modules, "jax", object())
    assert harness.forbidden_modules() == ["jax", "okvis2_tpu"]
