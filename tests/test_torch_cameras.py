"""Parity of the port's camera models (okvis2_torch.cameras) with the JAX
package on the CPU in float64, for all four distortion models.

Points are drawn from a numpy seed in front of, beside and behind the
camera. Tolerance: 1e-12 absolute on pixels and rays; validity masks equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from okvis2_torch import cameras as tcam
from okvis2_torch import interop
from okvis2_tpu import cameras as jcam

ATOL = 1e-12
MODELS = ["NoDistortion", "RadialTangentialDistortion",
          "RadialTangentialDistortion8", "EquidistantDistortion"]


def _pair(name):
    jc = jcam.PinholeCamera.create_test_object(getattr(jcam, name))
    tc = tcam.PinholeCamera.create_test_object(getattr(tcam, name), device="cpu")
    return jc, tc


def _points(n=256, seed=0):
    rng = np.random.default_rng(seed)
    p = np.stack([rng.uniform(-4, 4, n), rng.uniform(-3, 3, n), rng.uniform(-2, 8, n)], -1)
    p[0] = [0.0, 0.0, 1.0]  # on the optical axis
    p[1] = [0.3, -0.2, 0.0]  # in the camera plane
    return p


@pytest.mark.parametrize("name", MODELS)
def test_project(name):
    jc, tc = _pair(name)
    p = _points()
    uv_j, ok_j = jc.project(jnp.asarray(p))
    uv_t, ok_t = tc.project(torch.tensor(p))
    assert (ok_t.numpy() == np.asarray(ok_j)).all()
    sel = np.abs(p[:, 2]) > 1e-12
    np.testing.assert_allclose(uv_t.numpy()[sel], np.asarray(uv_j)[sel], rtol=0, atol=ATOL)


@pytest.mark.parametrize("name", MODELS)
def test_project_homogeneous(name):
    jc, tc = _pair(name)
    rng = np.random.default_rng(1)
    hp = np.concatenate([_points(seed=2), rng.uniform(-1, 1, (256, 1))], -1)
    uv_j, ok_j = jc.project_homogeneous(jnp.asarray(hp))
    uv_t, ok_t = tc.project_homogeneous(torch.tensor(hp))
    assert (ok_t.numpy() == np.asarray(ok_j)).all()
    np.testing.assert_allclose(uv_t.numpy(), np.asarray(uv_j), rtol=0, atol=ATOL)


@pytest.mark.parametrize("name", MODELS)
def test_distortion_jacobian_closed_form(name):
    """Each model's closed-form Jacobian (undistort's Newton steps) equals
    forward-mode autodiff of its distort, also at and near the centre."""
    _, tc = _pair(name)
    rng = np.random.default_rng(5)
    xy = torch.tensor(np.concatenate([rng.uniform(-0.9, 0.9, (64, 2)),
                                      [[0.0, 0.0], [1e-9, -2e-9], [1e-4, 3e-4]]]))
    J = tc.distortion.jacobian(xy)
    J_ad = torch.func.vmap(torch.func.jacfwd(tc.distortion.distort))(xy)
    np.testing.assert_allclose(J.numpy(), J_ad.numpy(), rtol=0, atol=1e-12)


@pytest.mark.parametrize("name", MODELS)
def test_back_project(name):
    jc, tc = _pair(name)
    rng = np.random.default_rng(3)
    uv = np.stack([rng.uniform(0, 752, 256), rng.uniform(0, 480, 256)], -1)
    np.testing.assert_allclose(tc.back_project(torch.tensor(uv)).numpy(),
                               np.asarray(jc.back_project(jnp.asarray(uv))),
                               rtol=0, atol=ATOL)
    np.testing.assert_allclose(
        tc.back_project_unnormalized(torch.tensor(uv)).numpy(),
        np.asarray(jc.back_project_unnormalized(jnp.asarray(uv))), rtol=0, atol=ATOL)


@pytest.mark.parametrize("name", MODELS)
def test_camera_from_numpy(name):
    """The interop converter rebuilds the reference's camera exactly."""
    jc, _ = _pair(name)
    d = {"focal": np.asarray(jc.focal), "center": np.asarray(jc.center),
         "image_size": jc.image_size, "distortion": type(jc.distortion).__name__,
         "k": np.asarray(jc.distortion.params())}
    tc = interop.camera_from_numpy(d, device="cpu")
    assert type(tc.distortion).__name__ == name and tc.image_size == jc.image_size
    np.testing.assert_array_equal(tc.intrinsics().numpy(), np.asarray(jc.intrinsics()))
