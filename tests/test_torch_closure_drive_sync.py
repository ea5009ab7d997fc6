"""The loop-closure drive through the synchronous ``SlamSystem`` of both
packages on the CPU, float64 (``tests/test_torch_loop_closure.py::_drive``:
one circle at 6 Hz at 192x128, f = 120, the first 9 frames, place
recognition with exclude_recent=2 and no drift budget, the JAX RANSAC draws
injected): both close at frame 8 with loop edge [5, 8]; the ATE within
1e-2 m (``ATE_TOL_SYNC``: the trajectories part by millimetres before the
closure, where descriptor bits tie to rounding, ROADMAP C); the same
keyframes querying place recognition with the same answers; the solve
worker ended.
"""

import pytest

from test_torch_loop_closure import _drive, _f64_jax_frontend

# the synchronous drive's trajectories part by millimetres before any
# closure: from frame 2 on, keypoints whose descriptors differ by one bit
# that ties to rounding (2-12 per keyframe) change a landmark, and this
# wide-lens, fast drive (ATE ~0.24 m) moves by 3-9 mm under one landmark
# (ROADMAP C). So its ATE is held at 1e-2 m (measured 5.1e-3), not 1e-3
ATE_TOL_SYNC = 1e-2
N_SYNC = 9


@pytest.fixture(scope="module")
def drives():
    with pytest.MonkeyPatch.context() as mp:
        _f64_jax_frontend(mp)
        jax_run = _drive(True, N_SYNC, False)
    return {"jax sync": jax_run, "port sync": _drive(False, N_SYNC, False)}


def test_synchronous_drive_closes_as_the_jax_loop(drives):
    aj, cj, ej, dj, _ = drives["jax sync"]
    at, ct, et, dt, slam = drives["port sync"]
    print(f"synchronous closure drive: closures at {ct} (JAX {cj}), loop edges {et} (JAX {ej}), "
          f"ATE {at:.6f} m (JAX {aj:.6f} m)")
    assert ct == cj and len(ct) >= 1
    assert et == ej
    assert [d[:2] for d in dt] == [d[:2] for d in dj]
    assert abs(at - aj) < ATE_TOL_SYNC, (at, aj)
    assert slam.estimator._solve_worker is None
