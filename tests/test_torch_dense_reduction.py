"""The solver's dense path reduces per landmark in an order it fixes
(``gauss_newton._build_lm_rows`` / ``_landmark_terms``), in float64 on
the CPU:

- on a random dense pack (duplicate (camera, landmark, state) cells and
  masked rows included) Hll, bl and W equal the scatter-adds
  (``index_add_``) they replace within 1e-12 of each array's largest entry;
- on a disturbed window problem the dense path's normal equations equal
  the table path's within 1e-12 (the table path gathers in a fixed order
  too), W against the table path's Wp / We blocks;
- a solve on the dense path repeats bit for bit and lands within 1e-9 m
  of the table path's.

The dense path against the JAX package's is held in
``tests/test_torch_solver.py`` (``test_linearize_and_schur_solve``), the
final BA in ``tests/test_torch_final_ba.py`` and the full-graph solve in
``tests/test_torch_loop_closure.py``; on the card, the float32 solve run
twice is held bit for bit in ``tests/test_torch_kernels_cuda.py``.
"""

import types

import numpy as np
import torch

from okvis2_torch.solver import gauss_newton as tgn
from okvis2_torch.solver.window_problem import SolverConfig
from okvis2_torch.utils import synthetic as tsyn

F64 = torch.float64


def _rel(a, b, tol):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    scale = max(float(np.abs(b).max()), 1e-300)
    assert float(np.abs(a - b).max()) <= tol * scale, float(np.abs(a - b).max()) / scale


def test_landmark_terms_match_index_add():
    g = torch.Generator().manual_seed(3)
    O, L, S, NC = 400, 37, 9, 2
    D = 15 * S + 6 * NC
    obs_lm = torch.randint(0, L, (O,), generator=g)
    obs_state = torch.randint(0, S, (O,), generator=g)
    obs_cam = torch.randint(0, NC, (O,), generator=g)
    obs_mask = torch.rand(O, generator=g) > 0.1
    # duplicate cells: rows 1-20 repeat rows 21-40's (camera, landmark, state)
    for t in (obs_lm, obs_state, obs_cam):
        t[1:21] = t[21:41]
    f = obs_mask[:, None, None].to(F64)
    Jp, Je, Jl = (torch.randn(O, 2, n, generator=g, dtype=F64) * f for n in (6, 6, 3))
    r0 = torch.randn(O, 2, generator=g, dtype=F64) * obs_mask[:, None].to(F64)
    prob = types.SimpleNamespace(L=L, O=O, obs_lm=obs_lm, obs_mask=obs_mask)
    rows = tgn._build_lm_rows(prob)
    assert rows.shape[0] == L and int(rows.max()) == O  # padded with the zero row
    Hll, bl, W = tgn._landmark_terms(rows, Jp, Je, Jl, r0, obs_state, obs_cam, S, NC)

    oh_s = torch.nn.functional.one_hot(obs_state, S).to(F64)
    oh_c = torch.nn.functional.one_hot(obs_cam, NC).to(F64)
    Jx = torch.cat([torch.einsum("oij,os->oisj", Jp, oh_s).reshape(O, 2, S * 6),
                    torch.zeros((O, 2, S * 9), dtype=F64),
                    torch.einsum("oij,oc->oicj", Je, oh_c).reshape(O, 2, NC * 6)], dim=-1)
    Hll_ref = torch.zeros((L, 3, 3), dtype=F64).index_add_(
        0, obs_lm, torch.einsum("oid,oie->ode", Jl, Jl))
    bl_ref = torch.zeros((L, 3), dtype=F64).index_add_(
        0, obs_lm, -torch.einsum("oid,oi->od", Jl, r0))
    W_ref = torch.zeros((L, D, 3), dtype=F64).index_add_(
        0, obs_lm, torch.einsum("oid,oie->ode", Jx, Jl))
    for a, b in ((Hll, Hll_ref), (bl, bl_ref), (W, W_ref)):
        _rel(a, b, 1e-12)


def _window():
    problem, cams, imu, _ = tsyn.build_problem(num_states=4, n_landmarks_side=5, device="cpu")
    frozen = torch.zeros(problem.S, dtype=torch.bool)
    frozen[0] = True
    return tsyn.disturb_problem(problem.replace(pose_frozen=frozen)), cams, imu


def test_dense_path_matches_table_path():
    prob, cams, imu = _window()
    cfg = SolverConfig()
    tbl = tgn._build_obs_table(prob)
    Hxx_t, bx_t, Hll_t, bl_t, (kind_t, Wp, We), _ = tgn._linearize(prob, cams, imu, cfg, tbl)
    Hxx_d, bx_d, Hll_d, bl_d, (kind_d, W), _ = tgn._linearize(prob, cams, imu, cfg, None)
    assert (kind_t, kind_d) == ("blocks", "dense")
    S, NC, L = prob.S, prob.NC, prob.L
    W_t = torch.cat([Wp.reshape(L, S * 6, 3), torch.zeros((L, S * 9, 3), dtype=F64),
                     We.reshape(L, NC * 6, 3)], dim=1)
    for a, b in ((Hxx_d, Hxx_t), (bx_d, bx_t), (Hll_d, Hll_t), (bl_d, bl_t), (W, W_t)):
        _rel(a, b, 1e-12)


def test_dense_solve_repeats(monkeypatch):
    prob, cams, imu = _window()
    cfg = SolverConfig(max_iterations=8)
    table, _ = tgn.solve_window(prob, cams, imu, cfg)
    monkeypatch.setattr(tgn, "TABLE_MAX_ENTRIES", 0)
    (a, sa), (b, sb) = (tgn.solve_window(prob, cams, imu, cfg) for _ in range(2))
    assert sa["iterations"] == sb["iterations"]
    assert torch.equal(a.pose, b.pose) and torch.equal(a.landmarks, b.landmarks)
    assert float((a.pose[:, :3] - table.pose[:, :3]).abs().max()) < 1e-9
