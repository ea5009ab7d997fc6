"""The port's dataset app in its default, pipelined loop on the CPU, on
``test_torch_app.py``'s EuRoC folder (8 frames): the RPG-format CSV with a
row per state, and the entry point's device rule (no card: it raises unless
the caller passes ``device="cpu"``)."""

import numpy as np
import pytest
import torch

from okvis2_torch.apps import app_synchronous as tapp

from test_torch_app import OUT, folder  # noqa: F401  (the module's fixture)


def test_pipelined_app(folder, tmp_path):
    _, config, dataset, gt = folder
    res = tapp.main([config, dataset, "--output-dir", str(tmp_path), "--rpg-format"],
                    device="cpu", dtype=torch.float64)
    with open(tmp_path / OUT) as f:
        lines = f.read().splitlines()
    assert lines[0] == "# timestamp tx ty tz qx qy qz qw"
    assert len(lines) >= 7
    assert res["slam"].pipelined and res["frames"] == len(gt)
    poses = np.array([[float(x) for x in ln.split()] for ln in lines[1:]])
    assert np.isfinite(poses).all()


def test_app_needs_a_card_unless_told(folder):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    _, config, dataset, _ = folder
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tapp.main([config, dataset, "--max-frames", "1"])
