"""The port's landmark-sharded solve against the JAX package's, on the CPU,
float64: ``solve_full_graph_sharded`` on 2 spawned gloo ranks against the
JAX package's on a 2-device slice of the virtual CPU mesh (conftest's 8
devices), on ``tests/test_torch_sharded_ba.py``'s noisy window (the port's
arrays in both packages): poses
within 1e-8 m, final costs within 1e-8 relative. A file of its own: the
JAX package compiles its sharded LM loop for ~2 min on the CPU.
"""

import numpy as np

from okvis2_tpu.imu.preintegration import ImuParameters as JImu
from okvis2_tpu.parallel import sharded_ba as jsh
from okvis2_tpu.solver import gauss_newton as jgn
from okvis2_tpu.solver.window_problem import SolverConfig as JCfg
from okvis2_tpu.utils import synthetic as jsyn
from test_torch_sharded_ba import COST_RTOL, N_ITER, POSE_TOL_M, problem, solve_two_ranks  # noqa: F401


def test_two_rank_solve_matches_jax(problem, tmp_path):  # noqa: F811
    jp = problem["jax"]
    jcams, _ = jsyn.stereo_rig()  # the rig and IMU of build_problem, as the port's
    jimu = JImu.create(g=9.81)
    jsolved = jsh.solve_full_graph_sharded(jsh.shard_problem_by_landmark(jp, 2), jcams, jimu,
                                           jsh.make_mesh(2), JCfg(), n_iterations=N_ITER)
    jcost = float(jgn.problem_cost(jsolved, jcams, jimu))
    r0, _ = solve_two_ranks(*problem["port"], tmp_path)
    np.testing.assert_allclose(r0["pose"][:, :3], np.asarray(jsolved.pose)[:, :3], rtol=0,
                               atol=POSE_TOL_M)
    assert abs(r0["cost"] - jcost) <= COST_RTOL * jcost, (r0["cost"], jcost)
