"""The loop-closure drive through the pipelined ``SlamSystem`` of both
packages on the CPU, float64, with one frame kept in flight
(``tests/test_torch_loop_closure.py::_drive``, its first 8 frames): the
same place-recognition decisions at every keyframe (query results, their
scores within 0.02, where descriptor bits that tie to rounding move a
word or two, the verification outcome, drift-budget rejections, closures),
ATE within 1e-3 m; the loop drained and its solve worker ended.
"""

import numpy as np
import pytest

from test_torch_loop_closure import _drive, _f64_jax_frontend

N_PIPE = 8


@pytest.fixture(scope="module")
def drives():
    with pytest.MonkeyPatch.context() as mp:
        _f64_jax_frontend(mp)
        jax_run = _drive(True, N_PIPE, True)
    return {"jax pipelined": jax_run, "port pipelined": _drive(False, N_PIPE, True)}


def test_pipelined_drive_makes_the_jax_decisions(drives):
    aj, cj, ej, dj, _ = drives["jax pipelined"]
    at, ct, et, dt, slam = drives["port pipelined"]
    print(f"pipelined drive: decisions {dt} (JAX {dj}), ATE {at:.6f} m (JAX {aj:.6f} m)")
    assert len(dt) == len(dj) and sum(d[2] != [] for d in dt) >= 2  # queried at least twice
    for a, b in zip(dt, dj):
        assert a[0] == b[0] and a[1] == b[1] and a[3] == b[3] and a[4:] == b[4:], (a, b)
        assert [k for k, _ in a[2]] == [k for k, _ in b[2]], (a, b)
        np.testing.assert_allclose([s for _, s in a[2]], [s for _, s in b[2]], rtol=0, atol=0.02)
    assert ct == cj and et == ej
    assert abs(at - aj) < 1e-3, (at, aj)
    assert not slam._pending_frames and slam.estimator._solve_worker is None
