"""Parity of the port's IMU preintegration, factors and window solver
(okvis2_torch.imu / factors / solver / utils.synthetic) with the JAX
package on the CPU in float64, plus the port's own solver behaviour.

The reference problem (``synthetic.build_problem(num_states=4,
n_landmarks_side=5)``, first pose frozen, disturbed) is built and solved
ONCE per module and handed to the port leaf by leaf through
``okvis2_torch.interop``, so both sides compute on identical inputs.
Tolerances: preintegration and factor residuals 1e-10 relative; the
per-iteration ``_linearize`` / ``_schur_solve`` outputs 1e-9 relative
(to each array's largest entry); ``solve_window`` the same iteration
count, poses within 1e-8 and final cost within 1e-8 relative.

The final cost is held at 1e-8 relative on the scene with 0.5 px pixel
noise, whose minimum is a non-zero chi-square, and on the noise-free scene
after the hot path's 3 iterations (cost 2.3e9 -> 26). Solved further, the
noise-free cost falls towards zero (8.7e-3 after 15 iterations, 9.4e-11 at
the step-tolerance exit), while the two packages' costs keep an absolute
difference of 1e-10 to 4e-10 from the first iteration on, about 1e-19 of
the initial cost: within 1.4e-11 relative up to 11 iterations (cost 7.5),
4.6e-8 at 15. That floor is float64 rounding carried through the damped
Schur steps (lambda ~ 1e-8), so there the final cost is held at 1e-7.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from okvis2_torch import interop
from okvis2_torch.factors import imu_factor as tfi
from okvis2_torch.factors import priors as tpri
from okvis2_torch.factors import reprojection as trep
from okvis2_torch.core.se3 import Transformation as TT
from okvis2_torch.imu import preintegration as tpre
from okvis2_torch.solver import gauss_newton as tgn
from okvis2_torch.solver.window_problem import SolverConfig as TCfg
from okvis2_torch.solver.window_problem import WindowProblem as TWP
from okvis2_torch.utils import synthetic as tsyn
from okvis2_tpu.core.se3 import Transformation as JT
from okvis2_tpu.factors import imu_factor as jfi
from okvis2_tpu.factors import priors as jpri
from okvis2_tpu.factors import reprojection as jrep
from okvis2_tpu.imu import preintegration as jpre
from okvis2_tpu.solver import gauss_newton as jgn
from okvis2_tpu.solver.window_problem import SolverConfig as JCfg
from okvis2_tpu.solver.window_problem import WindowProblem as JWP
from okvis2_tpu.utils import synthetic as jsyn

# the default config, one that ends early on the step tolerance, and the
# hot path's 3 iterations
SOLVES = {
    "max_iterations": dict(max_iterations=15),
    "step_tolerance": dict(max_iterations=30, step_tolerance=1e-5),
    "three_iterations": dict(max_iterations=3),
}
# scene -> pixel noise (px) added to the disturbed problem's measurements
SCENES = {"exact": 0.0, "noisy": 0.5}


def _final_cost_rtol(scene, name):
    """1e-8, but 1e-7 where the noise-free cost has fallen to the rounding
    floor (see the module docstring)."""
    return 1e-7 if scene == "exact" and name != "three_iterations" else 1e-8


def _np(x):
    return np.asarray(x)


def _problem_np(p: JWP) -> dict:
    out = {f: _np(getattr(p, f)) for f in p._FIELDS if f != "imu_pre"}
    out["imu_pre"] = {f.name: _np(getattr(p.imu_pre, f.name))
                      for f in dataclasses.fields(p.imu_pre)}
    return out


def _camera_np(c) -> dict:
    return {"focal": _np(c.focal), "center": _np(c.center), "image_size": c.image_size,
            "distortion": type(c.distortion).__name__, "k": _np(c.distortion.params())}


def _imu_np(ip) -> dict:
    return {f.name: _np(getattr(ip, f.name)) for f in dataclasses.fields(ip)}


def _rel(t, j, rtol):
    """|t - j| <= rtol * max|j| elementwise (relative to the array scale)."""
    t = t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    j = np.asarray(j)
    assert t.shape == j.shape
    np.testing.assert_allclose(t, j, rtol=0, atol=rtol * max(np.abs(j).max(), 1e-300))


def _with_noise(p: JWP, sigma: float, seed: int = 7) -> JWP:
    noise = np.random.default_rng(seed).normal(0.0, sigma, p.obs_uv.shape)
    return dataclasses.replace(p, obs_uv=p.obs_uv + jnp.asarray(noise))


def _masked_last(p):
    """The problem with its last state slot masked out (either package)."""
    if isinstance(p, JWP):
        return dataclasses.replace(p, state_mask=p.state_mask.at[p.S - 1].set(False))
    mask = p.state_mask.clone()
    mask[p.S - 1] = False
    return p.replace(state_mask=mask)


@pytest.fixture(scope="module")
def ref():
    """Reference problem, its port twin, and the reference's solves (each
    config compiles once and serves every scene: the shapes are equal)."""
    jp, jcams, jip, gt = jsyn.build_problem(num_states=4, n_landmarks_side=5)
    jp = dataclasses.replace(jp, pose_frozen=jnp.zeros(jp.S, bool).at[0].set(True))
    jd = jsyn.disturb_problem(jp)
    scenes = {name: _with_noise(jd, sigma) if sigma else jd for name, sigma in SCENES.items()}
    scenes["masked"] = _masked_last(jd)

    def solve(p, kw):
        solved, stats = jgn.solve_window(p, jcams, jip, JCfg(**kw))
        return (_np(solved.pose), _np(solved.landmarks),
                {k: _np(v) for k, v in stats.items()})

    solves = {(scene, name): solve(scenes[scene], kw)
              for scene in SCENES for name, kw in SOLVES.items()}
    solves[("masked", "max_iterations")] = solve(scenes["masked"], SOLVES["max_iterations"])
    tcams = tuple(interop.camera_from_numpy(_camera_np(c), device="cpu") for c in jcams)
    tip = interop.imu_params_from_numpy(_imu_np(jip), device="cpu")
    return dict(jp=jp, jd=jd, jcams=jcams, jip=jip, gt=gt, solves=solves,
                jscenes=scenes,
                tp=interop.problem_from_numpy(_problem_np(jp), device="cpu"),
                td=interop.problem_from_numpy(_problem_np(jd), device="cpu"),
                tscenes={k: interop.problem_from_numpy(_problem_np(v), device="cpu")
                         for k, v in scenes.items()},
                tcams=tcams, tip=tip)


# ---------------------------------------------------------------------------
# synthetic scene, interop
# ---------------------------------------------------------------------------

def test_build_problem_matches_reference(ref):
    tp, _, _, tgt = tsyn.build_problem(num_states=4, n_landmarks_side=5, device="cpu")
    tp = tp.replace(pose_frozen=ref["tp"].pose_frozen)  # the fixture froze pose 0
    ref_np = _problem_np(ref["jp"])
    got = interop.problem_to_numpy(tp)
    for f in JWP._FIELDS:
        pairs = (got[f].items() if f == "imu_pre" else [(f, got[f])])
        for name, g in pairs:
            r = ref_np[f][name] if f == "imu_pre" else ref_np[f]
            assert g.shape == r.shape and g.dtype == r.dtype, name
            if r.dtype == bool or r.dtype.kind == "i":
                np.testing.assert_array_equal(g, r)
            else:
                _rel(g, r, 1e-10)
    _rel(tgt["pose"], ref["gt"]["pose"], 1e-12)


def test_disturb_problem_matches_reference(ref):
    td = tsyn.disturb_problem(ref["tp"])
    for f in ("pose", "speed_bias", "landmarks"):
        _rel(getattr(td, f), getattr(ref["jd"], f), 1e-12)


def test_window_problem_empty_matches_reference():
    jp = _problem_np(JWP.empty(3, 5, 7, 2, 8))
    tp = interop.problem_to_numpy(TWP.empty(3, 5, 7, 2, 8, device="cpu"))
    for f in JWP._FIELDS:
        if f == "imu_pre":
            for k, v in jp[f].items():
                np.testing.assert_array_equal(tp[f][k], v)
        else:
            assert tp[f].dtype == jp[f].dtype, f
            np.testing.assert_array_equal(tp[f], jp[f])


def test_interop_roundtrip(ref):
    x = _problem_np(ref["jd"])
    y = interop.problem_to_numpy(interop.problem_from_numpy(x, device="cpu"))
    for f in JWP._FIELDS:
        for k in (x[f] if f == "imu_pre" else [None]):
            a, b = (x[f][k], y[f][k]) if k else (x[f], y[f])
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# IMU preintegration
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def segment():
    rng = np.random.default_rng(0)
    n = 24
    gyro = rng.normal(0, 0.5, (n, 3))
    accel = rng.normal(0, 2.0, (n, 3)) + [0.0, 0.0, 9.81]
    dt = np.full(n, 0.005)
    dt[-3:] = 0.0  # masked tail, as a fixed-capacity segment carries
    bg = rng.normal(0, 0.01, 3)
    ba = rng.normal(0, 0.05, 3)
    return gyro, accel, dt, bg, ba


def _pre_fields():
    return [f.name for f in dataclasses.fields(jpre.Preintegrated)]


def test_preintegrate(ref, segment):
    jr = jpre.preintegrate(ref["jip"], *(jnp.asarray(x) for x in segment))
    tr = tpre.preintegrate(ref["tip"], *(torch.tensor(x) for x in segment))
    for f in _pre_fields():
        _rel(getattr(tr, f), getattr(jr, f), 1e-10)


def test_preintegrate_batched(ref, segment):
    """Leading segment axes are independent segments."""
    tr1 = tpre.preintegrate(ref["tip"], *(torch.tensor(x) for x in segment))
    trb = tpre.preintegrate(ref["tip"], *(torch.tensor(np.stack([x, x])) for x in segment))
    for f in _pre_fields():
        torch.testing.assert_close(getattr(trb, f)[1], getattr(tr1, f), rtol=1e-12, atol=1e-15)


def test_preintegrate_np(ref, segment):
    jr = jpre.preintegrate_np(ref["jip"], *segment)
    tr = tpre.preintegrate_np(ref["tip"], *segment)
    for f in _pre_fields():
        np.testing.assert_array_equal(getattr(tr, f), getattr(jr, f))


def test_correct_for_bias(ref, segment):
    jr = jpre.preintegrate(ref["jip"], *(jnp.asarray(x) for x in segment))
    tr = tpre.preintegrate(ref["tip"], *(torch.tensor(x) for x in segment))
    bg, ba = np.array([0.02, -0.01, 0.005]), np.array([0.1, 0.0, -0.05])
    for a, b in zip(tpre.correct_for_bias(tr, torch.tensor(bg), torch.tensor(ba)),
                    jpre.correct_for_bias(jr, jnp.asarray(bg), jnp.asarray(ba))):
        _rel(a, b, 1e-10)


# ---------------------------------------------------------------------------
# factors
# ---------------------------------------------------------------------------

def _states(seed):
    rng = np.random.default_rng(seed)
    r = rng.normal(0, 1.0, 3)
    v = rng.normal(0, 0.3, 3)
    q = rng.normal(0, 1.0, 4)
    q /= np.linalg.norm(q)
    sb = np.concatenate([v, rng.normal(0, 0.01, 6)])
    return r, q, sb


@pytest.mark.parametrize("factor", ["imu", "pose_prior", "speed_bias_prior",
                                    "relative_pose", "reprojection", "cauchy"])
def test_factor_residuals(ref, segment, factor):
    (r0, q0, sb0), (r1, q1, sb1) = _states(1), _states(2)
    jT0, jT1 = JT(jnp.asarray(r0), jnp.asarray(q0)), JT(jnp.asarray(r1), jnp.asarray(q1))
    tT0, tT1 = TT(torch.tensor(r0), torch.tensor(q0)), TT(torch.tensor(r1), torch.tensor(q1))
    sq = np.diag(np.arange(1.0, 7.0)) + 0.1
    if factor == "imu":
        jr = jpre.preintegrate(ref["jip"], *(jnp.asarray(x) for x in segment))
        tr = tpre.preintegrate(ref["tip"], *(torch.tensor(x) for x in segment))
        a = tfi.imu_residual(ref["tip"], tr, tT0, torch.tensor(sb0), tT1, torch.tensor(sb1))
        b = jfi.imu_residual(ref["jip"], jr, jT0, jnp.asarray(sb0), jT1, jnp.asarray(sb1))
    elif factor == "pose_prior":
        a = tpri.pose_prior_residual(tT0, tT1, torch.tensor(sq))
        b = jpri.pose_prior_residual(jT0, jT1, jnp.asarray(sq))
    elif factor == "speed_bias_prior":
        w = np.arange(1.0, 10.0)
        a = tpri.speed_bias_prior_residual(torch.tensor(sb0), torch.tensor(sb1), torch.tensor(w))
        b = jpri.speed_bias_prior_residual(jnp.asarray(sb0), jnp.asarray(sb1), jnp.asarray(w))
    elif factor == "relative_pose":
        r2, q2, _ = _states(3)
        a = tpri.relative_pose_residual(tT0, tT1, TT(torch.tensor(r2), torch.tensor(q2)),
                                        torch.tensor(sq))
        b = jpri.relative_pose_residual(jT0, jT1, JT(jnp.asarray(r2), jnp.asarray(q2)),
                                        jnp.asarray(sq))
    elif factor == "reprojection":
        hp = np.array([[0.5, -0.3, 6.0, 1.0], [1.0, 0.2, -4.0, 1.0]])
        uv = np.array([[400.0, 200.0], [300.0, 250.0]])
        w = np.array([8.0 / 9.0, 0.5])
        ext = JT(jnp.asarray([0.11, 0.0, 0.0]), jnp.asarray([0.0, 0.0, 0.0, 1.0]))
        f64 = dict(dtype=torch.float64)
        text = TT(torch.tensor([0.11, 0.0, 0.0], **f64), torch.tensor([0.0, 0.0, 0.0, 1.0], **f64))
        T = JT(jnp.zeros(3), jnp.asarray([0.0, 0.0, 0.0, 1.0]))
        tTi = TT(torch.zeros(3, **f64), torch.tensor([0.0, 0.0, 0.0, 1.0], **f64))
        a, va = trep.reprojection_residual(tTi, text, torch.tensor(hp), torch.tensor(uv),
                                           ref["tcams"][0], torch.tensor(w))
        b, vb = jrep.reprojection_residual(T, ext, jnp.asarray(hp), jnp.asarray(uv),
                                           ref["jcams"][0], jnp.asarray(w))
        np.testing.assert_array_equal(va.numpy(), np.asarray(vb))
    else:
        s = np.array([0.0, 0.5, 3.0, 100.0])
        a = trep.cauchy_weight(torch.tensor(s), 2.0)
        b = jrep.cauchy_weight(jnp.asarray(s), 2.0)
    _rel(a, b, 1e-10)


# ---------------------------------------------------------------------------
# solver: cost, per-iteration linearise / Schur solve, the LM loop
# ---------------------------------------------------------------------------

def test_problem_cost(ref):
    """At the disturbed estimate and at the noisy scene's measurements
    (the noise-free ground truth's cost is pure rounding residue)."""
    jcost = jax.jit(lambda p: jgn.problem_cost(p, ref["jcams"], ref["jip"]))
    for scene in SCENES:
        a = tgn.problem_cost(ref["tscenes"][scene], ref["tcams"], ref["tip"])
        _rel(a, jcost(ref["jscenes"][scene]), 1e-10)
    noisy_gt = _with_noise(ref["jp"], SCENES["noisy"])
    a = tgn.problem_cost(interop.problem_from_numpy(_problem_np(noisy_gt), device="cpu"),
                         ref["tcams"], ref["tip"])
    _rel(a, jcost(noisy_gt), 1e-10)


@pytest.fixture(scope="module")
def lin_ref(ref):
    """The reference's linearisation and Schur solve at the disturbed
    problem (iteration 0) and after its first step (iteration 1), on the
    table path and the dense path."""
    cfg = JCfg()
    jp, cams, ip = ref["jd"], ref["jcams"], ref["jip"]

    def lin(p, tbl):
        Hxx, bx, Hll, bl, W_rep, free_x = jgn._linearize(p, cams, ip, cfg, None, tbl)
        return Hxx, bx, Hll, bl, W_rep[1:], free_x

    def solve(Hxx, bx, Hll, bl, W_arrs, free_x, lm_mask, lam, kind):
        return jgn._schur_solve(Hxx, bx, Hll, bl, (kind,) + W_arrs, free_x,
                                lm_mask, lam, cfg)

    lin_j = jax.jit(lin)
    solve_j = jax.jit(solve, static_argnums=(8,))
    tbl = jgn._build_obs_table(jp)
    lam = jnp.asarray(cfg.initial_lambda)
    out = {}
    for path, t in (("table", tbl), ("dense", None)):
        kind = "blocks" if t is not None else "dense"
        p = jp
        for it in range(2):
            L = lin_j(p, t)
            dx, dl = solve_j(*L, p.lm_mask, lam, kind)
            out[(path, it)] = (interop.problem_from_numpy(_problem_np(p), device="cpu"),
                               [_np(x) for x in L[:4]], [_np(x) for x in L[4]],
                               _np(L[5]), _np(dx), _np(dl))
            p = jgn._apply_deltas(p, dx, dl)
    return out, _np(tbl)


@pytest.mark.parametrize("path", ["table", "dense"])
@pytest.mark.parametrize("it", [0, 1])
def test_linearize_and_schur_solve(ref, lin_ref, path, it):
    out, tbl_ref = lin_ref
    tp, L4, W_arrs, free_x, dx_ref, dl_ref = out[(path, it)]
    tbl = tgn._build_obs_table(tp) if path == "table" else None
    if tbl is not None:
        np.testing.assert_array_equal(tbl.numpy(), tbl_ref)
    Hxx, bx, Hll, bl, W_rep, fx = tgn._linearize(tp, ref["tcams"], ref["tip"], TCfg(), tbl)
    for a, b in zip((Hxx, bx, Hll, bl), L4):
        _rel(a, b, 1e-9)
    assert W_rep[0] == ("blocks" if path == "table" else "dense")
    for a, b in zip(W_rep[1:], W_arrs):
        _rel(a, b, 1e-9)
    np.testing.assert_array_equal(fx.numpy(), free_x)
    lam = torch.tensor(TCfg().initial_lambda, dtype=torch.float64)
    dx, dl = tgn._schur_solve(Hxx, bx, Hll, bl, W_rep, fx, tp.lm_mask, lam, TCfg())
    _rel(dx, dx_ref, 1e-9)
    _rel(dl, dl_ref, 1e-9)


@pytest.mark.parametrize("scene", sorted(SCENES))
@pytest.mark.parametrize("name", sorted(SOLVES))
def test_solve_window_matches_reference(ref, name, scene):
    pose_ref, lm_ref, stats_ref = ref["solves"][(scene, name)]
    solved, stats = tgn.solve_window(ref["tscenes"][scene], ref["tcams"], ref["tip"],
                                     TCfg(**SOLVES[name]))
    assert stats["iterations"] == int(stats_ref["iterations"])
    np.testing.assert_allclose(solved.pose.numpy(), pose_ref, rtol=0, atol=1e-8)
    _rel(stats["final_cost"], stats_ref["final_cost"], _final_cost_rtol(scene, name))
    _rel(stats["initial_cost"], stats_ref["initial_cost"], 1e-12)
    assert abs(float(stats["lambda"]) - float(stats_ref["lambda"])) <= 1e-12 * float(stats_ref["lambda"])
    assert float(stats["final_cost"]) < 1e-3 * float(stats["initial_cost"])
    if scene == "exact" and name != "three_iterations":  # converged: the ground truth
        err = np.linalg.norm(solved.pose[:, :3].numpy() - np.asarray(ref["gt"]["pose"])[:, :3],
                             axis=-1)
        assert err.max() < 5e-3


def test_frozen_blocks_do_not_move(ref):
    p = ref["tp"].replace(sb_frozen=ref["tp"].pose_frozen.clone())
    d = tsyn.disturb_problem(p)
    solved, _ = tgn.solve_window(d, ref["tcams"], ref["tip"], TCfg(max_iterations=5))
    assert torch.equal(solved.pose[0], d.pose[0])
    assert torch.equal(solved.speed_bias[0], d.speed_bias[0])
    assert torch.equal(solved.extrinsics, d.extrinsics)  # frozen by default


def test_masked_slot_is_untouched(ref):
    """A masked state slot keeps its value; the rest solves as the
    reference does."""
    d = ref["tscenes"]["masked"]
    pose_ref, _, stats_ref = ref["solves"][("masked", "max_iterations")]
    solved, stats = tgn.solve_window(d, ref["tcams"], ref["tip"],
                                     TCfg(**SOLVES["max_iterations"]))
    assert torch.equal(solved.pose[d.S - 1], d.pose[d.S - 1])
    assert stats["iterations"] == int(stats_ref["iterations"])
    np.testing.assert_allclose(solved.pose.numpy(), pose_ref, rtol=0, atol=1e-8)


def test_pose_prior_pulls_solution(ref):
    p = TWP.empty(2, 4, 4, 2, 8, device="cpu")
    target = torch.tensor([0.3, -0.2, 0.1, 0.0, 0.0, 0.0, 1.0], dtype=torch.float64)
    pp, pps = p.pose_prior.clone(), p.pose_prior_sqrt.clone()
    pp[0] = target
    pps[0] = torch.eye(6, dtype=torch.float64) * 100.0
    p = p.replace(state_mask=torch.tensor([True, False]), pose_prior=pp, pose_prior_sqrt=pps,
                  pose_prior_mask=torch.tensor([True, False]))
    solved, _ = tgn.solve_window(p, ref["tcams"], ref["tip"], TCfg(max_iterations=5))
    torch.testing.assert_close(solved.pose[0], target, rtol=0, atol=1e-8)


def test_float32_solve_with_radtan_camera():
    """A float32 solve through radtan cameras (the bench's rig model).
    Under ``vmap``, forward-mode AD of a 0-d float32 tensor combined with
    a Python scalar gave float64 tangents in the distortion model, and the
    float64 landmark blocks then stopped the solve at the Cholesky (a dtype
    mismatch); ``distort`` now computes on [..., 1] slices, so the
    Jacobians are float32 and the solve runs."""
    from okvis2_torch.cameras.distortion import RadialTangentialDistortion

    tp, _, timu, _ = tsyn.build_problem(num_states=3, n_landmarks_side=4, device="cpu")
    cams, _ = tsyn.stereo_rig(distortion_cls=RadialTangentialDistortion, device="cpu")
    f32 = torch.float32
    cams = tuple(c.to(dtype=f32) for c in cams)
    frozen = torch.zeros(tp.S, dtype=torch.bool)
    frozen[0] = True
    problem = tsyn.disturb_problem(tp.replace(pose_frozen=frozen)).to(dtype=f32)
    _, _, jp, je, jl = tgn._reproj_val_jac(problem, cams)
    assert jp.dtype == je.dtype == jl.dtype == f32
    solved, stats = tgn.solve_window(problem, cams, timu.to(dtype=f32), TCfg(max_iterations=3))
    assert solved.pose.dtype == f32 and bool(torch.isfinite(solved.pose).all())
    assert stats["iterations"] == 3 and float(stats["final_cost"]) < float(stats["initial_cost"])
