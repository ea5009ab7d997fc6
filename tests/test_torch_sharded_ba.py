"""The port's landmark-sharded bundle adjustment against the JAX package's,
on the CPU, float64.

- ``shard_problem_by_landmark`` at 2 and 4 shards: the same arrays as the
  JAX package's function, and the same cost as the unsharded problem
  (1e-9 relative);
- ``solve_full_graph_sharded`` on 2 spawned gloo ranks
  (``parallel.dryrun.run_spmd`` over a float64 pack saved to a file)
  against the port's unsharded ``solve_window``: poses within 1e-8 m,
  costs within 1e-8 relative, the same LM iterations, 4 collectives per
  iteration; every rank returns the same result (against the JAX
  package's sharded solve: ``tests/test_torch_sharded_solve_jax.py``, a
  file of its own because compiling that solve takes the JAX package
  ~2 min on the CPU);
- ``do_final_ba(mesh=...)`` at world size 2 on the scripted session of
  ``tests/test_torch_final_ba.py`` (each rank unpickles the port's
  estimator from a file the test wrote: spawned ranks import no test
  module and no JAX) against the port's unsharded ``do_final_ba`` on the
  same session: poses and landmark points within 1e-8 m;
- ``dryrun_multichip(2)``.
"""

import copy
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from okvis2_torch import interop
from okvis2_torch.parallel import dryrun as tdry
from okvis2_torch.parallel import sharded_ba as tsh
from okvis2_torch.pipeline import final_ba as tfba
from okvis2_torch.solver import gauss_newton as tgn
from okvis2_torch.solver.window_problem import SolverConfig as TCfg
from okvis2_torch.utils import synthetic as tsyn
from okvis2_tpu.imu.preintegration import Preintegrated as JPre
from okvis2_tpu.parallel import sharded_ba as jsh
from okvis2_tpu.solver.window_problem import WindowProblem as JWP
from test_torch_final_ba import FBA_CAPS, FBA_ITERATIONS, _session

POSE_TOL_M, COST_RTOL, SHARD_COST_RTOL = 1e-8, 1e-8, 1e-9
N_ITER = 5


def _jax_problem(tp):
    """The port's problem as the JAX package's WindowProblem (numpy leaves
    under the same names, for its numpy-only sharding)."""
    d = interop.problem_to_numpy(tp)
    d["imu_pre"] = JPre(**{k: jnp.asarray(v) for k, v in d["imu_pre"].items()})
    return JWP(**{k: v if k == "imu_pre" else jnp.asarray(v) for k, v in d.items()})


@pytest.fixture(scope="module")
def problem():
    """A noisy 4-state window, first pose frozen, the rest disturbed
    (``tests/test_torch_solver.py``'s "noisy" scene), in both packages (the
    JAX package's from the port's arrays)."""
    tp, tcams, timu, _ = tsyn.build_problem(num_states=4, n_landmarks_side=5, device="cpu")
    tp = tsyn.disturb_problem(tp.replace(pose_frozen=torch.arange(tp.S) == 0))
    noise = np.random.default_rng(7).normal(0.0, 0.5, tuple(tp.obs_uv.shape))
    tp = tp.replace(obs_uv=tp.obs_uv + torch.from_numpy(noise))
    return {"port": (tp, tcams, timu), "jax": _jax_problem(tp)}


@pytest.mark.parametrize("n", [2, 4])
def test_shard_problem_by_landmark(problem, n):
    jp = problem["jax"]
    tp, tcams, timu = problem["port"]
    js = jsh.shard_problem_by_landmark(jp, n)
    ts = tsh.shard_problem_by_landmark(tp, n)
    for f in ("landmarks", "lm_mask", "lm_prior", "lm_prior_sqrt", "lm_prior_mask", "obs_state",
              "obs_cam", "obs_lm", "obs_uv", "obs_sqrt_info", "obs_mask"):
        np.testing.assert_array_equal(getattr(ts, f).numpy(), np.asarray(getattr(js, f)),
                                      err_msg=f)
    assert ts.L % n == 0 and ts.O % (8 * n) == 0
    c0 = float(tgn.problem_cost(tp, tcams, timu))
    c1 = float(tgn.problem_cost(ts, tcams, timu))
    assert abs(c1 - c0) <= SHARD_COST_RTOL * c0, (c0, c1)


def solve_two_ranks(tp, tcams, timu, tmp):
    """The port's sharded solve of ``tp`` on 2 spawned gloo ranks, from a
    float64 pack written under ``tmp``; each rank's result."""
    path = str(tmp / "pack.npz")
    tdry.save_pack(path, tp, tcams, timu)
    return tdry.run_spmd(tdry.solve_saved_pack, 2, args=(path, N_ITER, TCfg()), device="cpu",
                         init_dir=str(tmp))


def test_two_rank_solve_matches_unsharded(problem, tmp_path):
    tp, tcams, timu = problem["port"]
    r0, r1 = solve_two_ranks(tp, tcams, timu, tmp_path)
    unsharded, stats = tgn.solve_window(tp, tcams, timu, TCfg(max_iterations=N_ITER))
    ucost = float(stats["final_cost"])
    for k in ("pose", "landmarks"):
        np.testing.assert_array_equal(r1[k], r0[k], err_msg=k)
    assert r0["iterations"] == stats["iterations"]
    # per LM iteration: the cost, the normal equations, the Schur complement
    # (all-reduces) and the flags (a broadcast); one cost before, one gather
    assert r0["collectives"] == 4 * r0["iterations"] + 2, r0["collectives"]
    np.testing.assert_allclose(r0["pose"][:, :3], unsharded.pose.numpy()[:, :3], rtol=0,
                               atol=POSE_TOL_M)
    assert abs(r0["cost"] - ucost) <= COST_RTOL * ucost, (r0["cost"], ucost)
    assert r0["cost"] < r0["cost0"]


def test_do_final_ba_with_mesh(tmp_path):
    """World size 2 against the unsharded final BA on the same session."""
    _, t = _session()
    path = str(tmp_path / "session.pkl")
    with open(path, "wb") as f:
        pickle.dump(t, f)
    ranks = tdry.run_spmd(tdry.final_ba_saved_session, 2, args=(path, FBA_ITERATIONS, FBA_CAPS),
                          device="cpu", init_dir=str(tmp_path))
    ref = copy.deepcopy(t)
    info = tfba.do_final_ba(ref, FBA_ITERATIONS, **FBA_CAPS)
    for r in ranks:
        got = r["info"]
        assert {k: got[k] for k in ("restored_observations", "states", "landmarks")} == \
            {k: info[k] for k in ("restored_observations", "states", "landmarks")}
        assert "reproj_rms_px" not in got  # no diagnostics with a mesh, as in JAX
        for sid, rec in ref.states.items():
            np.testing.assert_allclose(r["poses"][sid][:3], rec.pose[:3], rtol=0,
                                       atol=POSE_TOL_M)
        for lid, lm in ref.landmarks.items():
            hp = r["landmarks"][lid]
            np.testing.assert_allclose(hp[:3] / hp[3], lm.hp_W[:3] / lm.hp_W[3], rtol=0,
                                       atol=POSE_TOL_M)
    assert info["states"] > 4 and info["restored_observations"] > 0


def test_dryrun_multichip(tmp_path):
    out = tdry.dryrun_multichip(2, device="cpu", init_dir=str(tmp_path))
    assert len(out) == 2 and out[0]["iterations"] == 2
    np.testing.assert_array_equal(out[0]["pose"], out[1]["pose"])
    assert out[0]["c1"] <= out[0]["c0"] * 1.5 + 1e-6
    assert torch.isfinite(torch.as_tensor(out[0]["pose"])).all()
