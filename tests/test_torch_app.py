"""The port's dataset app (``okvis2_torch.apps.app_synchronous``) against the
JAX package's on the CPU.

One EuRoC folder (the port's star dataset on ``small_rig``, 320x240
stereo, 2000 stars, seed 11, 2 s at 4 Hz, IMU at 100 Hz, written by the
port's ``DatasetWriter``) and the config of ``tests/test_app_synchronous.py``
go through both apps with ``--sync --final-ba --save-map``: the same
number of CSV rows, each pose within 1e-3 m (the bar of
``test_torch_slam.py``: a descriptor bit that ties to rounding parts the
runs by ~1e-4 m, ROADMAP C), the maps' landmark counts within 3, and the
CSV taps (IMU, tracks) with the JAX package's headers and row counts. The
port runs in float64 with the JAX frame program's RANSAC draws injected;
the JAX frame program runs with float64 standing for its float32, as in
``test_torch_slam.py`` (here also in the JAX loop's zero solve buffer,
which spares a second compile of the frame program). Both final BAs run at 512 landmark and 2048
observation slots in place of 8192 / 65536 (the session has 200 and 965),
which changes nothing but the padding, and at 5 iterations in place of the
app's 30: the bar is on the poses both packages reach, not on how far
the BA converges. The default pipelined port app runs
on the same folder in ``test_torch_app_pipelined.py``.
"""

import os
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from okvis2_torch.apps import app_synchronous as tapp
from okvis2_torch.imu.preintegration import ImuParameters as TImu
from okvis2_torch.pipeline import component_io
from okvis2_torch.pipeline import final_ba as tfba
from okvis2_torch.pipeline import slam as tslam
from okvis2_torch.pipeline import synthetic_run as tsr
from okvis2_torch.pipeline.dataset import DatasetWriter, SyntheticDataset
from okvis2_tpu.apps import app_synchronous as japp
from okvis2_tpu.pipeline import final_ba as jfba
from okvis2_tpu.pipeline import frontend_pipeline as jfp
from okvis2_tpu.pipeline import slam as jslam
from okvis2_tpu.pipeline import synthetic_run as jsr

from test_app_synchronous import _write_config
from test_torch_slam import _jax_indices

POSE_TOL, LM_TOL = 1e-3, 3
OUT = "okvis2-final_trajectory.csv"
# the final BA's landmark and observation capacities here (the defaults,
# 8192 / 65536, are sized for long sessions; this one uses 200 / 965)
FBA_CAPACITY = dict(max_landmarks=512, max_obs=2048)
FBA_ITERATIONS = 5


def _tapped(cls, fba, tap_dir, systems, **extra):
    """``cls`` with both CSV taps into ``tap_dir``, its final BA at
    FBA_CAPACITY and FBA_ITERATIONS (``fba``: the package's final_ba
    module), and every instance kept."""

    class Tapped(cls):
        def __init__(self, *a, **kw):
            super().__init__(*a, **{**kw, **extra})
            self.set_imu_csv_file(os.path.join(tap_dir, "imu.csv"))
            self.set_tracks_csv_file(os.path.join(tap_dir, "tracks.csv"))
            systems.append(self)

        def do_final_ba(self, iterations=30, mesh=None):
            return fba.do_final_ba(self.estimator, FBA_ITERATIONS, mesh, **FBA_CAPACITY)

    return Tapped


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    root = tmp_path_factory.mktemp("app")
    cams, exts = tsr.small_rig(320, 240, dtype=torch.float64, device="cpu")
    ds = SyntheticDataset(cams, exts, TImu.create(g=9.81, device="cpu"), n_stars=2000, seed=11,
                          duration=2.0, frame_rate=4.0, imu_rate=100.0, device="cpu")
    writer = DatasetWriter(str(root / "dataset"), num_cameras=2)
    gt = []
    for ev in ds.stream():
        if ev[0] == "imu":
            writer.add_imu_measurement(ev[1], ev[2], ev[3])
        else:
            writer.add_images(ev[1], ev[2])
            gt.append((ev[1], ev[3]))
    writer.close()
    config = str(root / "rig.yaml")
    _write_config(config, *jsr.small_rig(width=320, height=240))
    return root, config, str(root / "dataset"), gt


@pytest.fixture(scope="module")
def runs(folder):
    root, config, dataset, _ = folder
    out = {}
    for name in ("jax", "port"):
        d = root / name
        (d / "taps").mkdir(parents=True)
        systems = []
        argv = [config, dataset, "--output-dir", str(d), "--sync", "--final-ba",
                "--save-map", str(d / "session.map")]
        with pytest.MonkeyPatch.context() as mp:
            if name == "jax":
                shim = types.SimpleNamespace(**{k: getattr(np, k) for k in dir(np)
                                                if not k.startswith("__")})
                shim.float32 = np.float64
                mp.setattr(jnp, "float32", jnp.float64)
                mp.setattr(jfp, "np", shim)
                # and in the loop's zero solve buffer of the first frames:
                # one compile of the frame program, not two
                mp.setattr(jslam, "np", shim)
                mp.setattr(jslam, "SlamSystem",
                           _tapped(jslam.SlamSystem, jfba, str(d / "taps"), systems))
                japp.main(argv)
            else:
                mp.setattr(tslam, "SlamSystem",
                           _tapped(tslam.SlamSystem, tfba, str(d / "taps"), systems,
                                   ransac_sampler=_jax_indices))
                res = tapp.main(argv, device="cpu", dtype=torch.float64)
                assert res["slam"] is systems[0] and res["frames"] == 8
        for f in ("_imu_csv", "_tracks_csv"):
            getattr(systems[0], f).close()
        out[name] = d
    return out


def _rows(path):
    with open(path) as f:
        lines = f.read().splitlines()
    return lines[0], [np.array([float(x) for x in ln.split(",")]) for ln in lines[1:]]


def test_synchronous_app_matches(runs, folder):
    hj, rj = _rows(runs["jax"] / OUT)
    ht, rt = _rows(runs["port"] / OUT)
    assert ht == hj == "#timestamp,p_x,p_y,p_z,q_w,q_x,q_y,q_z"
    assert len(rt) == len(rj) >= 6
    for a, b in zip(rt, rj):
        assert a[0] == b[0]
        assert np.abs(a[1:4] - b[1:4]).max() < POSE_TOL, (a, b)
    mj = component_io.load_component(str(runs["jax"] / "session.map"))
    mt = component_io.load_component(str(runs["port"] / "session.map"))
    assert abs(len(mt["landmarks"]) - len(mj["landmarks"])) <= LM_TOL
    assert len(mt["landmarks"]) > 50


def test_csv_taps_match(runs):
    for name in ("imu.csv", "tracks.csv"):
        hj, rj = _rows(runs["jax"] / "taps" / name)
        ht, rt = _rows(runs["port"] / "taps" / name)
        assert ht == hj
        assert len(rt) == len(rj) > 0
    # the IMU tap writes what it is fed: the same rows
    with open(runs["jax"] / "taps" / "imu.csv") as a, open(runs["port"] / "taps" / "imu.csv") as b:
        assert a.read() == b.read()
    _, tj = _rows(runs["jax"] / "taps" / "tracks.csv")
    _, tt = _rows(runs["port"] / "taps" / "tracks.csv")
    assert [r[:3].tolist() for r in tt] == [r[:3].tolist() for r in tj]  # time, state, keyframe
