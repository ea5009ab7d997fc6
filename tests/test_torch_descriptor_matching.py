"""Parity of the port's descriptor and matching (okvis2_torch.frontend.
descriptor / matching) with the JAX package on the CPU in float64.

Both sides describe the SAME keypoints (the reference detector's output)
on the same images. The packed words are compared bit for bit (the port
returns them as int32 with the reference's uint32 bit pattern: map files
and the BoW store keep those words), the sign vectors exactly, and the
matches by index.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from okvis2_torch.frontend import descriptor as tdesc
from okvis2_torch.frontend import matching as tmatch
from okvis2_torch.utils.synthetic import textured_stereo_pair
from okvis2_tpu.frontend import descriptor as jdesc
from okvis2_tpu.frontend import detection as jdet
from okvis2_tpu.frontend import matching as jmatch


@pytest.fixture(scope="module")
def described():
    imgs = textured_stereo_pair(128, 192, seed=5)
    det = jdet.detect_keypoints_batch(jnp.asarray(imgs), jdet.DetectionConfig(max_keypoints=128))
    det = {k: np.asarray(v) for k, v in det.items()}
    out = []
    for c in range(2):
        dj = jdesc.describe_keypoints(jnp.asarray(imgs[c]), jnp.asarray(det["xy"][c]),
                                      jnp.asarray(det["size"][c]), jnp.asarray(det["mask"][c]))
        dt = tdesc.describe_keypoints(torch.tensor(imgs[c]), torch.tensor(det["xy"][c]),
                                      torch.tensor(det["size"][c]), torch.tensor(det["mask"][c]))
        out.append(({k: np.asarray(v) for k, v in dj.items()}, dt))
    return det, out


def test_pattern_is_the_reference_pattern():
    assert np.array_equal(tdesc._PATTERN, jdesc._PATTERN)
    assert np.array_equal(tdesc._PAIRS, jdesc._PAIRS)
    assert np.array_equal(tdesc._RING_ID, jdesc._RING_ID)


@pytest.mark.parametrize("cam", [0, 1])
def test_packed_bit_identical(described, cam):
    _, out = described
    dj, dt = out[cam]
    assert dt["packed"].dtype == torch.int32
    np.testing.assert_array_equal(dt["packed"].numpy().view(np.uint32), dj["packed"])


@pytest.mark.parametrize("cam", [0, 1])
def test_signs_and_angle(described, cam):
    det, out = described
    dj, dt = out[cam]
    np.testing.assert_array_equal(dt["signs"].numpy(), dj["signs"])
    np.testing.assert_allclose(dt["angle"].numpy(), dj["angle"], rtol=0, atol=1e-12)
    assert det["mask"][cam].sum() > 20


def test_pack_bits_high_bit():
    """Bit 31 set: the int32 word carries the uint32 pattern unchanged."""
    bits = torch.zeros(1, 512, dtype=torch.bool)
    bits[0, 31] = True
    bits[0, 32] = True
    words = tdesc.pack_bits(bits).numpy().view(np.uint32)
    assert words[0, 0] == 2**31 and words[0, 1] == 1


def test_hamming_distance_matrix(described):
    _, out = described
    a, b = out[0][0]["signs"], out[1][0]["signs"]
    np.testing.assert_array_equal(
        tmatch.hamming_distance_matrix(torch.tensor(a), torch.tensor(b)).numpy(),
        np.asarray(jmatch.hamming_distance_matrix(jnp.asarray(a), jnp.asarray(b))))


@pytest.mark.parametrize("gated", [False, True])
def test_match_descriptors(described, gated):
    det, out = described
    (dj0, dt0), (dj1, dt1) = out
    gate = None
    if gated:  # epipolar-style gate: rows within 2 px
        dy = det["xy"][0][:, None, 1] - det["xy"][1][None, :, 1]
        gate = np.abs(dy) < 2.0
    mj = jmatch.match_descriptors(
        jnp.asarray(dj0["signs"]), jnp.asarray(det["mask"][0]),
        jnp.asarray(dj1["signs"]), jnp.asarray(det["mask"][1]),
        gate=None if gate is None else jnp.asarray(gate))
    mt = tmatch.match_descriptors(
        dt0["signs"], torch.tensor(det["mask"][0]), dt1["signs"], torch.tensor(det["mask"][1]),
        gate=None if gate is None else torch.tensor(gate))
    np.testing.assert_array_equal(mt["idx_b"].numpy(), np.asarray(mj["idx_b"]))
    np.testing.assert_array_equal(mt["valid"].numpy(), np.asarray(mj["valid"]))
    np.testing.assert_array_equal(mt["dist"].numpy(), np.asarray(mj["dist"]))
    assert mt["valid"].sum() > 5
