"""Parity of the port's core math (okvis2_torch.core, ops.linalg) with the
JAX package on the CPU in float64.

Inputs are random batches from a numpy seed, with zero and near-zero
rotations mixed in (the reference is gradient-safe at exactly zero and the
solver linearises there). Tolerance: 1e-12 absolute.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import jacfwd

from okvis2_torch.core import se3 as tse3
from okvis2_torch.core import so3 as tso3
from okvis2_torch.ops import linalg as tlin
from okvis2_tpu.core import se3 as jse3
from okvis2_tpu.core import so3 as jso3
from okvis2_tpu.ops import linalg as jlin

ATOL = 1e-12


def _rotvecs(n=64, seed=0):
    rng = np.random.default_rng(seed)
    v = rng.normal(0, 0.8, (n, 3))
    v[0] = 0.0  # exactly zero
    v[1] = 1e-8  # inside the series branch
    v[2] = [1e-4, -2e-4, 5e-5]
    v[3] = [np.pi - 1e-3, 0.0, 0.0]  # near the half-turn
    return v


def _quats(n=64, seed=1):
    v = _rotvecs(n, seed)
    q = np.array(jso3.delta_q(jnp.asarray(v)))
    q[5] = -q[5]  # a negative-w representative of the same rotation
    return q


def _close(a_t, a_j, atol=ATOL):
    np.testing.assert_allclose(a_t.numpy(), np.asarray(a_j), rtol=0, atol=atol)


def _t(x):
    return torch.tensor(np.asarray(x))


UNARY = {
    "cross_mx": _rotvecs,
    "sinc": lambda: _rotvecs()[:, 0],
    "delta_q": _rotvecs,
    "right_jacobian": _rotvecs,
    "quat_normalize": lambda: 1.7 * _quats(),
    "quat_positive": _quats,
    "quat_conjugate": _quats,
    "quat_to_matrix": _quats,
    "quat_log": _quats,
    "quat_plus": _quats,
    "quat_oplus": _quats,
}


@pytest.mark.parametrize("name", sorted(UNARY))
def test_so3_unary(name):
    x = UNARY[name]()
    _close(getattr(tso3, name)(_t(x)), getattr(jso3, name)(jnp.asarray(x)))


def test_matrix_to_quat_roundtrip():
    C = np.asarray(jso3.quat_to_matrix(jnp.asarray(_quats())))
    _close(tso3.matrix_to_quat(_t(C)), jso3.matrix_to_quat(jnp.asarray(C)))


@pytest.mark.parametrize("name", ["quat_multiply", "rotate"])
def test_so3_binary(name):
    q = _quats()
    other = _quats(seed=2) if name == "quat_multiply" else _rotvecs(seed=3) * 3.0
    _close(getattr(tso3, name)(_t(q), _t(other)),
           getattr(jso3, name)(jnp.asarray(q), jnp.asarray(other)))


@pytest.mark.parametrize("name", ["delta_q", "quat_log_at_identity"])
def test_so3_jacobian_at_zero(name):
    """Forward-mode derivatives exactly at zero rotation are finite and
    equal to the reference's (the solver differentiates there)."""
    if name == "delta_q":
        ft, fj = tso3.delta_q, jso3.delta_q
    else:
        def ft(v):
            return tso3.quat_log(tso3.delta_q(v))

        def fj(v):
            return jso3.quat_log(jso3.delta_q(v))
    jt = jacfwd(ft)(torch.zeros(3, dtype=torch.float64))
    jj = jax.jacfwd(fj)(jnp.zeros(3))
    assert torch.isfinite(jt).all()
    _close(jt, jj)


def _poses(seed):
    rng = np.random.default_rng(seed)
    r = rng.normal(0, 2.0, (32, 3))
    q = _quats(32, seed)
    return r, q


@pytest.mark.parametrize(
    "op", ["compose", "inverse", "apply", "apply_homogeneous", "oplus",
           "ominus", "matrix", "se3_log"]
)
def test_transformation(op):
    r1, q1 = _poses(4)
    r2, q2 = _poses(5)
    Tt1, Tt2 = tse3.Transformation(_t(r1), _t(q1)), tse3.Transformation(_t(r2), _t(q2))
    Tj1 = jse3.Transformation(jnp.asarray(r1), jnp.asarray(q1))
    Tj2 = jse3.Transformation(jnp.asarray(r2), jnp.asarray(q2))
    rng = np.random.default_rng(6)
    p = rng.normal(0, 3.0, (32, 3))
    hp = np.concatenate([p, rng.uniform(-1, 1, (32, 1))], -1)
    delta = np.concatenate([rng.normal(0, 0.1, (32, 3)), _rotvecs(32, 7) * 0.1], -1)
    if op == "compose":
        a, b = Tt1 @ Tt2, Tj1 @ Tj2
        _close(a.r, b.r)
        _close(a.q, b.q)
    elif op == "inverse":
        a, b = Tt1.inverse(), Tj1.inverse()
        _close(a.r, b.r)
        _close(a.q, b.q)
    elif op == "apply":
        _close(Tt1.apply(_t(p)), Tj1.apply(jnp.asarray(p)))
    elif op == "apply_homogeneous":
        _close(Tt1.apply_homogeneous(_t(hp)), Tj1.apply_homogeneous(jnp.asarray(hp)))
    elif op == "oplus":
        a, b = Tt1.oplus(_t(delta)), Tj1.oplus(jnp.asarray(delta))
        _close(a.r, b.r)
        _close(a.q, b.q)
    elif op == "ominus":
        _close(Tt1.ominus(Tt2), Tj1.ominus(Tj2))
    elif op == "matrix":
        _close(Tt1.matrix(), Tj1.matrix())
    else:
        _close(tse3.se3_log(Tt1), jse3.se3_log(Tj1))


@pytest.mark.parametrize("name", ["inv3x3", "spd_solve", "spd_inverse_sqrt"])
def test_linalg(name):
    rng = np.random.default_rng(8)
    n = 3 if name == "inv3x3" else 15
    M = rng.normal(0, 1.0, (16, n, n))
    A = M @ np.swapaxes(M, -1, -2) + n * np.eye(n)
    if name == "spd_solve":
        b = rng.normal(0, 1.0, (16, n))
        _close(tlin.spd_solve(_t(A), _t(b)), jlin.spd_solve(jnp.asarray(A), jnp.asarray(b)[..., None])[..., 0])
    else:
        _close(getattr(tlin, name)(_t(A)), getattr(jlin, name)(jnp.asarray(A)))


def test_spd_solve_not_positive_definite_gives_nan():
    """As the reference's Cholesky, a failed factorisation yields NaN (the
    LM loop then rejects the step) instead of raising."""
    A = torch.tensor([[1.0, 2.0], [2.0, 1.0]], dtype=torch.float64)
    x = tlin.spd_solve(A, torch.ones(2, dtype=torch.float64))
    assert torch.isnan(x).all()
    assert np.isnan(np.asarray(jlin.spd_solve(jnp.asarray(A.numpy()), jnp.ones(2)))).all()
