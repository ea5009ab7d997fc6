"""The port's Fast-SCNN ``.pth`` importer
(``okvis2_torch/models/import_torch_fast_scnn.py``) against the JAX
package's, on the CPU.

The cityscapes checkpoint is not in the repo, so the checkpoint layout's
mirror (``models/torch_fast_scnn.py``) with random weights and non-trivial
BatchNorm statistics stands in for it, as in ``tests/test_torch_import.py``
(the JAX package's importer test):

- the ``.npz`` the port's ``main`` writes holds the arrays of the JAX
  ``convert_state_dict`` under the JAX ``save_params`` keys, bit for bit,
  and equals the JAX ``main``'s file array for array; the JAX package's
  ``load_params`` reads it;
- the port's ``FastSCNN`` loaded from it (``load_params`` ->
  ``interop.fast_scnn_state_dict_from_flax``) gives the mirror's logits at
  192x320 within 2e-3, with at least 0.999 of the argmax equal (the JAX
  test's bars);
- ``normalize_imagenet`` equals the JAX one; ``save_params`` and
  ``interop.fast_scnn_flax_from_state_dict`` round-trip the model; the
  mirror's keys are the JAX mirror's.
"""

import numpy as np
import pytest
import torch

from okvis2_torch import interop
from okvis2_torch.models import fast_scnn as tfs
from okvis2_torch.models import import_torch_fast_scnn as timp
from okvis2_torch.models.torch_fast_scnn import build_torch_fast_scnn
from okvis2_tpu.models import fast_scnn as jfs
from okvis2_tpu.models import import_torch_fast_scnn as jimp
from okvis2_tpu.models.torch_fast_scnn import build_torch_fast_scnn as jbuild

LOGIT_TOL, ARGMAX_AGREE = 2e-3, 0.999


def _mirror(seed):
    torch.manual_seed(seed)
    m = build_torch_fast_scnn().eval()
    with torch.no_grad():
        for mod in m.modules():
            if isinstance(mod, torch.nn.BatchNorm2d):
                mod.running_mean.normal_(0.0, 0.05)
                mod.running_var.uniform_(0.5, 1.5)
    return m


@pytest.fixture(scope="module")
def converted(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("scnn")
    mirror = _mirror(0)
    pth = str(tmp / "fast_scnn_random.pth")
    torch.save(mirror.state_dict(), pth)
    port_npz, jax_npz = str(tmp / "port.npz"), str(tmp / "jax.npz")
    assert timp.main([pth, port_npz]) == 0
    assert jimp.main([pth, jax_npz]) == 0
    return mirror, pth, port_npz, jax_npz


def test_npz_equals_jax_converter(converted):
    mirror, pth, port_npz, jax_npz = converted
    sd = jimp.load_torch_checkpoint(pth)
    want = timp.flatten_variables(jimp.convert_state_dict(sd))
    got = tfs.load_params(port_npz)
    with np.load(jax_npz) as f:
        jax_file = {k: f[k] for k in f.files}
    assert got.keys() == want.keys() == jax_file.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype == np.float32, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        np.testing.assert_array_equal(got[k], jax_file[k], err_msg=k)
    # the same conversion from the port's own reader and converter
    port_sd = timp.load_torch_checkpoint(pth)
    assert port_sd.keys() == sd.keys()
    for k, v in timp.flatten_variables(timp.convert_state_dict(port_sd)).items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)
    # and the JAX package reads the port's file
    jvars = jfs.load_params(port_npz)
    assert np.array_equal(np.asarray(jvars["params"]["ltd_conv"]["conv"]["kernel"]),
                          want["params/ltd_conv/conv/kernel"])


def test_imported_logits_match_mirror(converted):
    mirror, _, port_npz, _ = converted
    model = tfs.FastSCNN()
    model.load_state_dict(interop.fast_scnn_state_dict_from_flax(tfs.load_params(port_npz)))
    model.eval()
    img = np.random.default_rng(1).uniform(-1, 1, (192, 320, 3)).astype(np.float32)
    x = torch.from_numpy(img).permute(2, 0, 1)[None]
    with torch.no_grad():
        want = mirror(x)[0]
    got = tfs.image_logits(model, torch.from_numpy(img))
    assert got.shape == want.shape == (19, 192, 320)
    err = float((got - want).abs().max())
    agree = float((got.argmax(0) == want.argmax(0)).double().mean())
    print(f"logits within {err:.3e}, argmax agreement {agree:.5f}")
    assert err < LOGIT_TOL and agree >= ARGMAX_AGREE


def test_normalize_imagenet_equals_jax():
    img = np.random.default_rng(2).uniform(0, 1, (7, 9, 3))
    for dtype in (np.float32, np.float64):
        a = timp.normalize_imagenet(img.astype(dtype))
        b = jimp.normalize_imagenet(img.astype(dtype))
        assert a.dtype == b.dtype == dtype and np.array_equal(a, b)


def test_save_params_round_trip(tmp_path):
    """The port's checkpoint holds the JAX model's variables (keys and
    shapes) and loads back into the same model."""
    import flax
    import jax

    torch.manual_seed(4)
    model = tfs.FastSCNN()
    path = str(tmp_path / "m.npz")
    tfs.save_params(path, model)
    flat = tfs.load_params(path)
    shapes = jax.eval_shape(lambda: jfs.init_params(jax.random.PRNGKey(0), 64, 64))
    want = {"/".join(k): v.shape for k, v in flax.traverse_util.flatten_dict(shapes).items()}
    assert {k: v.shape for k, v in flat.items()} == want
    back = interop.fast_scnn_state_dict_from_flax(flat)
    for k, v in model.state_dict().items():
        assert torch.equal(back[k], v) or k.endswith("num_batches_tracked"), k
    with pytest.raises(KeyError):
        interop.fast_scnn_flax_from_state_dict({"nope.weight": torch.zeros(3)})


def test_mirror_keys_equal_jax_mirror():
    a, b = build_torch_fast_scnn().state_dict(), jbuild().state_dict()
    assert list(a) == list(b)
    assert all(a[k].shape == b[k].shape for k in a)
