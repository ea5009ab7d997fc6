"""The port's slice as a whole: the per-frame chain (detect -> describe ->
stereo match -> window solve) against the JAX package's on the CPU in
float64, and the package rules (no JAX import anywhere in the port, no
silent drop to the CPU, no fallback around the kernel).

Chain tolerances: the frontend on a 2x128x192 stereo pair with 128
keypoints gives the same keypoint set (xy within 1e-9), the same packed
descriptors for each keypoint, and the same matched pairs; the solve of a
disturbed 3-state window takes the same number of iterations and gives
poses within 1e-8.
"""

import ast
import dataclasses
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import okvis2_torch
from okvis2_torch import interop
from okvis2_torch.cameras.pinhole import PinholeCamera
from okvis2_torch.frontend import descriptor as tdesc
from okvis2_torch.frontend import detection as tdet
from okvis2_torch.frontend import matching as tmatch
from okvis2_torch.pipeline import dataset as tds
from okvis2_torch.graph import estimator as test_
from okvis2_torch.pipeline import frontend_pipeline as tfp
from okvis2_torch.pipeline import slam as tslam
from okvis2_torch.pipeline import synthetic_run as tsr
from okvis2_torch.solver import gauss_newton as tgn
from okvis2_torch.solver.window_problem import SolverConfig as TCfg
from okvis2_torch.solver.window_problem import WindowProblem as TWP
from okvis2_torch.utils import synthetic as tsyn
from okvis2_tpu.frontend import descriptor as jdesc
from okvis2_tpu.frontend import detection as jdet
from okvis2_tpu.frontend import matching as jmatch
from okvis2_tpu.solver import gauss_newton as jgn
from okvis2_tpu.solver.window_problem import SolverConfig as JCfg
from okvis2_tpu.utils import synthetic as jsyn

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "okvis2_tpu")


# ---------------------------------------------------------------------------
# the chain
# ---------------------------------------------------------------------------

def _frontend(det_fn, desc_fn, match_fn, imgs):
    det = det_fn(imgs)
    desc = [desc_fn(imgs[c], det["xy"][c], det["size"][c], det["mask"][c]) for c in range(2)]
    m = match_fn(desc[0]["signs"], det["mask"][0], desc[1]["signs"], det["mask"][1])
    as_np = lambda x: x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)  # noqa: E731
    return ({k: as_np(v) for k, v in det.items()},
            [as_np(d["packed"]).view(np.uint32) for d in desc],
            as_np(m["idx_b"]))


@pytest.fixture(scope="module")
def frontends():
    imgs = tsyn.textured_stereo_pair(128, 192, seed=11)
    kw = dict(max_keypoints=128)
    j = _frontend(lambda x: jdet.detect_keypoints_batch(x, jdet.DetectionConfig(**kw)),
                  jdesc.describe_keypoints, jmatch.match_descriptors, jnp.asarray(imgs))
    t = _frontend(lambda x: tdet.detect_keypoints_batch(x, tdet.DetectionConfig(**kw)),
                  tdesc.describe_keypoints, tmatch.match_descriptors, torch.tensor(imgs))
    return j, t


def _keyed(det, packed, c):
    """{rounded xy of each valid keypoint: its row} for camera c."""
    rows = np.nonzero(det["mask"][c])[0]
    return {tuple(np.round(det["xy"][c][r], 6)): r for r in rows}


def test_chain_keypoints_and_descriptors(frontends):
    (jd, jp, _), (td, tp, _) = frontends
    for c in range(2):
        kj, kt = _keyed(jd, jp, c), _keyed(td, tp, c)
        assert kj.keys() == kt.keys() and len(kj) > 20
        for key, rj in kj.items():
            rt = kt[key]
            np.testing.assert_allclose(td["xy"][c][rt], jd["xy"][c][rj], rtol=0, atol=1e-9)
            np.testing.assert_array_equal(tp[c][rt], jp[c][rj])


def test_chain_matches(frontends):
    def pairs(det, idx):
        return {(tuple(np.round(det["xy"][0][a], 6)), tuple(np.round(det["xy"][1][b], 6)))
                for a, b in enumerate(idx) if b >= 0}

    (jd, _, jm), (td, _, tm) = frontends
    pj, pt = pairs(jd, jm), pairs(td, tm)
    assert pj == pt and len(pj) > 5


def test_chain_window_solve():
    jp, jcams, jip, _ = jsyn.build_problem(num_states=3, n_landmarks_side=4)
    jp = dataclasses.replace(jp, pose_frozen=jnp.zeros(jp.S, bool).at[0].set(True))
    jd = jsyn.disturb_problem(jp)
    cfg = dict(max_iterations=10)
    jsolved, jstats = jgn.solve_window(jd, jcams, jip, JCfg(**cfg))

    tp, tcams, tip, _ = tsyn.build_problem(num_states=3, n_landmarks_side=4, device="cpu")
    frozen = torch.zeros(tp.S, dtype=torch.bool)
    frozen[0] = True
    td = tsyn.disturb_problem(tp.replace(pose_frozen=frozen))
    tsolved, tstats = tgn.solve_window(td, tcams, tip, TCfg(**cfg))

    np.testing.assert_allclose(td.pose.numpy(), np.asarray(jd.pose), rtol=0, atol=1e-12)
    assert tstats["iterations"] == int(jstats["iterations"])
    np.testing.assert_allclose(tsolved.pose.numpy(), np.asarray(jsolved.pose), rtol=0, atol=1e-8)
    assert float(tstats["final_cost"]) < 1e-3 * float(tstats["initial_cost"])


# ---------------------------------------------------------------------------
# package rules
# ---------------------------------------------------------------------------

def test_import_leaves_jax_out():
    code = ("import sys, okvis2_torch, okvis2_torch.frontend, okvis2_torch.solver, "
            "okvis2_torch.utils.synthetic, okvis2_torch.interop, okvis2_torch.ops.harris_cuda, "
            "okvis2_torch.frontend.p3p, okvis2_torch.frontend.triangulation, "
            "okvis2_torch.core.se3_np, okvis2_torch.pipeline.frontend_pipeline, "
            "okvis2_torch.pipeline.dataset, okvis2_torch.graph.estimator, "
            "okvis2_torch.graph.mst, okvis2_torch.factors.two_pose, okvis2_torch.utils.timing, "
            "okvis2_torch.solver.packed_solve, okvis2_torch.cameras.ncamera, "
            "okvis2_torch.pipeline.trajectory, okvis2_torch.pipeline.slam, "
            "okvis2_torch.pipeline.synthetic_run; "
            f"print(sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, check=True)
    assert out.stdout.strip() == "[]"


def _port_sources():
    pkg = os.path.join(REPO, "okvis2_torch")
    for root, dirs, files in os.walk(pkg):
        dirs[:] = [d for d in dirs if d != "_build"]  # build outputs, not sources
        yield from (os.path.join(root, f) for f in files if f.endswith(".py"))
    yield os.path.join(REPO, "chip_smoke.py")
    yield os.path.join(REPO, "harris_bench.py")


@pytest.mark.parametrize("path", sorted(os.path.relpath(p, REPO) for p in _port_sources()))
def test_no_jax_import_in_source(path):
    tree = ast.parse(open(os.path.join(REPO, path)).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for n in names:
            assert n.split(".")[0] not in FORBIDDEN, f"{path}:{node.lineno} imports {n}"


DEVICE_NONE_ENTRY_POINTS = {
    "resolve_device": lambda: okvis2_torch.resolve_device(None),
    "build_problem": lambda: tsyn.build_problem(num_states=2, n_landmarks_side=2),
    "PinholeCamera.create": lambda: PinholeCamera.create(752, 480, 460.0, 460.0, 376.0, 240.0),
    "WindowProblem.empty": lambda: TWP.empty(2, 3, 4, 2, 8),
    "imu_params_from_numpy": lambda: interop.imu_params_from_numpy(
        {"sigma_g_c": 1.0, "sigma_a_c": 1.0, "sigma_gw_c": 1.0, "sigma_aw_c": 1.0, "g": 9.81}),
    "SyntheticDataset": lambda: tds.SyntheticDataset((), (), None),
    "DeviceLandmarkTable": lambda: tfp.DeviceLandmarkTable(8, 3),
    "frame_associate": lambda: tfp.frame_associate(*_frame_associate_args()),
    "Estimator": lambda: test_.Estimator(*_rig_args()),
    "SlamSystem": lambda: tslam.SlamSystem(*_rig_args()),
    "SlamSystem pipelined": lambda: tslam.SlamSystem(*_rig_args(), pipelined=True),
    "run_synthetic_vio": lambda: tsr.run_synthetic_vio(duration=0.5),
}


@pytest.mark.parametrize("name", sorted(DEVICE_NONE_ENTRY_POINTS))
def test_device_none_raises_without_cuda(name):
    """``device=None`` means the card: without one it raises, never
    drops to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: device=None resolves to it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DEVICE_NONE_ENTRY_POINTS[name]()


def _rig_args():
    """(cameras, extrinsics, imu parameters) of a tiny CPU rig."""
    cams, exts = tsr.small_rig(32, 24, device="cpu")
    return cams, exts, interop.imu_params_from_numpy(
        {"sigma_g_c": 1.0, "sigma_a_c": 1.0, "sigma_gw_c": 1.0, "sigma_aw_c": 1.0, "g": 9.81},
        device="cpu")


@pytest.mark.parametrize("option", ["loop_closure_config", "do_loop_closures", "cnn_params",
                                    "add_depth_image"])
def test_unported_options_raise(option):
    """Loop closure (and its config), CNN suppression and depth-aided
    initialisation are not ported: asking for them raises, naming the
    ROADMAP item, instead of being ignored."""
    kw = {"loop_closure_config": {"loop_closure_config": object()},
          "do_loop_closures": {"do_loop_closures": True},
          "cnn_params": {"cnn_params": {}}, "add_depth_image": {}}[option]
    with pytest.raises(NotImplementedError, match="ROADMAP A"):
        s = tslam.SlamSystem(*_rig_args(), device="cpu", **kw)
        s.add_depth_image(0.0, np.zeros((24, 32)))


def _frame_associate_args():
    """frame_associate's positional inputs at a tiny size: 2 cameras of
    24x32 px, 4 landmarks, an empty table."""
    cam = PinholeCamera.create(32, 24, 20.0, 20.0, 16.0, 12.0, device="cpu")
    T_SC = np.tile([0, 0, 0, 0, 0, 0, 1.0], (2, 1))
    lms = {"hp": np.tile([0, 0, 1.0, 1.0], (4, 1)), "mask": np.ones(4, bool),
           "init": np.ones(4, bool)}
    return ((cam, cam), T_SC, np.zeros((2, 24, 32)), T_SC[0], lms, np.zeros((4, 3, 512)),
            np.zeros((4, 3), bool))


def test_harris_nms_has_no_fallback():
    """Only a CPU tensor takes the plain version; any other device goes to
    the kernel's wrapper or raises, also inside frame_associate (no
    try/except around its detection)."""
    with pytest.raises(ValueError):
        tdet.harris_nms(torch.zeros(1, 8, 8, device="meta"))
    with pytest.raises(ValueError, match="harris_nms"):
        tfp.frame_associate(*_frame_associate_args(), device="meta", sampler=lambda *a: None)
