"""The port's config reader against the JAX package's, and its YAML subset
reader against PyYAML, on the CPU.

- ``read_config_file`` on all five ``configs/*.yaml`` in both packages
  (float64): camera sizes, focal lengths, centres and distortion
  parameters equal, ``T_SC`` and ``T_BS`` within 1e-12, the IMU,
  estimator, frontend, rig and output fields equal.
- ``yaml_subset.loads`` against ``yaml.safe_load`` on those files (header
  stripped for PyYAML, as the JAX reader strips it), on
  ``tests/test_app_synchronous.py``'s config template and on scalars that
  PyYAML 1.1 types in its own way; every construct outside the subset
  (quoted scalars among them) raises with its line number.
"""

import dataclasses
import glob
import os

import numpy as np
import pytest
import torch
import yaml

from okvis2_torch.config import read_config_file as t_read
from okvis2_torch.config import yaml_subset
from okvis2_tpu.config import read_config_file as j_read
from okvis2_tpu.pipeline import synthetic_run as jsr

from test_app_synchronous import _write_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(REPO, "configs", "*.yaml")))
IDS = [os.path.basename(p) for p in CONFIGS]


def _pyyaml(text):
    if text.startswith("%YAML"):
        text = text.split("\n", 1)[1]
    return yaml.safe_load(text.replace("!!opencv-matrix", ""))


def _C(T):
    return np.asarray(T.C)


@pytest.mark.parametrize("path", CONFIGS, ids=IDS)
def test_read_config_file_matches(path):
    j = j_read(path)
    t = t_read(path, dtype=torch.float64, device="cpu")
    assert len(t.cameras) == len(j.cameras) >= 2
    for cj, ct in zip(j.cameras, t.cameras):
        a, b = cj.camera, ct.camera
        assert (b.width, b.height) == (int(a.width), int(a.height))
        assert b.focal.dtype == torch.float64
        np.testing.assert_array_equal(b.focal.numpy(), np.asarray(a.focal))
        np.testing.assert_array_equal(b.center.numpy(), np.asarray(a.center))
        assert type(b.distortion).__name__ == type(a.distortion).__name__
        np.testing.assert_array_equal(b.distortion.params().numpy(),
                                      np.asarray(a.distortion.params()))
        np.testing.assert_allclose(ct.T_SC.r.numpy(), np.asarray(cj.T_SC.r), rtol=0, atol=1e-12)
        np.testing.assert_allclose(ct.T_SC.C.numpy(), _C(cj.T_SC), rtol=0, atol=1e-12)
        assert (ct.camera_type, ct.slam_use) == (cj.camera_type, cj.slam_use)
    assert len(t.camera_tuple) == len(j.camera_tuple)
    assert len(t.extrinsics_list) == len(j.extrinsics_list)
    for f in ("sigma_g_c", "sigma_a_c", "sigma_gw_c", "sigma_aw_c", "g"):
        assert float(getattr(t.imu.params, f)) == float(getattr(j.imu.params, f)), f
    for f in ("use", "a_max", "g_max", "sigma_bg", "sigma_ba", "g0", "a0"):
        assert getattr(t.imu, f) == getattr(j.imu, f), f
    assert (t.imu.T_BS is None) == (j.imu.T_BS is None)
    if t.imu.T_BS is not None:
        np.testing.assert_allclose(t.imu.T_BS.C.numpy(), _C(j.imu.T_BS), rtol=0, atol=1e-12)
        np.testing.assert_allclose(t.imu.T_BS.r.numpy(), np.asarray(j.imu.T_BS.r), rtol=0,
                                   atol=1e-12)
    for f in ("camera_rig", "frontend", "estimator", "output"):
        assert dataclasses.asdict(getattr(t, f)) == dataclasses.asdict(getattr(j, f)), f


def test_read_config_file_float32_and_device_rule():
    path = os.path.join(REPO, "configs", "euroc.yaml")
    p = t_read(path, device="cpu")
    assert p.cameras[0].camera.focal.dtype == torch.float32
    assert p.imu.params.g.dtype == torch.float32
    assert p.frontend.max_num_keypoints == 700 and p.estimator.do_loop_closures is True
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            t_read(path)


@pytest.mark.parametrize("path", CONFIGS, ids=IDS)
def test_yaml_subset_matches_pyyaml(path):
    with open(path) as f:
        text = f.read()
    assert yaml_subset.loads(text) == _pyyaml(text)


def test_yaml_subset_on_the_app_template(tmp_path):
    path = str(tmp_path / "rig.yaml")
    _write_config(path, *jsr.small_rig(width=320, height=240))
    with open(path) as f:
        text = f.read()
    doc = yaml_subset.loads(text)
    assert doc == _pyyaml(text)
    assert doc["frontend_parameters"]["max_num_keypoints"] == 128


SCALARS = [
    "a: 1", "a: -0x1F", "a: 0o17", "a: 017", "a: 0b101", "a: 1_000",
    "a: 1.5", "a: 20.0e-4", "a: 1.0e+5", "a: 1e5", "a: 1.0e5", "a: .5", "a: -.inf",
    "a: .nan", "a: yes", "a: Off", "a: TRUE", "a: y", "a: ~", "a: null", "a:",
    "a: plain text here", "a: it's", "a: [1, [2, 3], {b: c}]",
    "a: {b: 1, c}", "a: x # comment", "a:#not a comment", "on: 1", "1: one",
    "a:\n- 1\n- 2", "a:\n  - b: 1\n    c: 2\n  - 3", "- - 1\n  - 2\n- 3", "---\na: 1",
    "a: [1,\n  2,\n  3]", "a: {b: [1,\n   2], c: 3}",
]


@pytest.mark.parametrize("text", SCALARS)
def test_yaml_subset_types_as_pyyaml(text):
    got, want = yaml_subset.loads(text + "\n"), yaml.safe_load(text + "\n")
    if text == "a: .nan":
        assert np.isnan(got["a"]) and np.isnan(want["a"])
        return
    assert got == want
    assert [type(v) for v in _leaves(got)] == [type(v) for v in _leaves(want)]


def _leaves(x):
    if isinstance(x, dict):
        return [k for k in x] + [v for val in x.values() for v in _leaves(val)]
    if isinstance(x, list):
        return [v for item in x for v in _leaves(item)]
    return [x]


UNSUPPORTED = [
    ("a: 1\nb: &anchor 2\n", 2), ("a: *alias\n", 1), ("a: !!str 1\n", 1),
    ("a: !custom 1\n", 1), ("a: |\n  text\n", 1), ("a: >\n  text\n", 1),
    ("a: 1\n---\nb: 2\n", 2), ("a: 1\n...\n", 2), ("a: b\n  continued\n", 2),
    ("a: 2001-12-14\n", 1), ("<<: {b: 1}\n", 1), ('a: "x"\n', 1), ("a: 'x'\n", 1),
    ("a: [1, 'x']\n", 1), ('"a": 1\n', 1), ("a: 1:30\n", 1), ("a:\n  - 1:30.5\n", 2),
    ("a: [1, 2\n", 1), ("a: 1\n\tb: 2\n", 2), ("%TAG ! tag:x\na: 1\n", 1),
    ("a:\n  b: 1\n   c: 2\n", 3),
]


@pytest.mark.parametrize("text,line", UNSUPPORTED)
def test_yaml_subset_refuses(text, line):
    with pytest.raises(yaml_subset.YamlSubsetError) as e:
        yaml_subset.loads(text)
    assert e.value.line == line
    assert str(e.value).startswith(f"line {line}: ")


def test_opencv_matrix_tag_is_ignored():
    text = "%YAML:1.0\nT: !!opencv-matrix\n  [1.0, 2.0]\nU: !!opencv-matrix [3]\n"
    assert yaml_subset.loads(text) == {"T": [1.0, 2.0], "U": [3]}
