"""CNN suppression: the port's Fast-SCNN, keypoint classifier, suppressor
and textured world against the JAX package's, on the CPU.

- ``interop.fast_scnn_state_dict_from_flax`` + ``FastSCNN`` against the
  Flax model, with ``init_params`` from a seed at 64x128 and with the
  committed weights at 128x192, on a proxy scene: float64 logits within
  1e-9 of their largest magnitude; float32 within 1e-4, class maps at
  least 99.9 % equal; the conversion is strict. In float64 both models
  hold the variables in float64: Flax keeps batch statistics in float32
  and, given them so, forms each BatchNorm multiplier with XLA's float32
  rsqrt, which is up to one float32 ulp off the rounded value (86 % of
  1e5 draws agree), 5e-7 relative after the network's 30 normalisations;
- ``resize_align_corners`` and ``_adaptive_avg_pool`` against the JAX
  functions at odd sizes (1e-12), ``classify_keypoints`` at half-pixel
  coordinates (equal), ``suppression_weights`` (equal);
- the A/B case of ``tests/test_cnn_suppression.py`` on the port's
  estimator, and its classifier case on the port's ``make_scene`` (the
  scenes equal the JAX package's);
- ``CnnSuppressor.suppress`` of both packages on the same scripted
  estimator and images, float and uint8 (unscaled, as the JAX package
  feeds them): the same landmarks suppressed;
- ``TexturedWorldDataset`` at 96x128 against the JAX renderer: the same
  world, images within 1e-5 and labels equal on at least 99.9 % of the
  pixels, along its stream and through ``render_with_labels``.

The textured drive with ``cnn_params`` is in
``tests/test_torch_cnn_drive.py``.
"""

import os

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from okvis2_torch import interop
from okvis2_torch.core import se3_np
from okvis2_torch.graph import estimator as test_
from okvis2_torch.imu.preintegration import ImuParameters as TImu
from okvis2_torch.models import fast_scnn as tfs
from okvis2_torch.models import scenes as tsc
from okvis2_torch.models import suppression as tsup
from okvis2_torch.pipeline import dataset as tds
from okvis2_torch.pipeline import synthetic_run as tsr
from okvis2_torch.utils import synthetic as tsyn
from okvis2_tpu.graph import estimator as jest
from okvis2_tpu.imu.preintegration import ImuParameters as JImu
from okvis2_tpu.models import fast_scnn as jfs
from okvis2_tpu.models import suppression as jsup
from okvis2_tpu.models import train_synthetic as jtrain
from okvis2_tpu.pipeline import dataset as jds
from okvis2_tpu.pipeline import synthetic_run as jsr

WEIGHTS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "okvis2_tpu", "models", "weights", "fast_scnn_synthetic.npz")
F64_TOL, F32_TOL, F32_CLASS_AGREE = 1e-9, 1e-4, 0.999
RENDER_TOL, LABEL_AGREE = 1e-5, 0.999


def _flat(variables) -> dict:
    return {"/".join(k): np.asarray(v)
            for k, v in flax.traverse_util.flatten_dict(variables).items()}


def _model(flat, dtype):
    m = tfs.FastSCNN()
    m.load_state_dict(interop.fast_scnn_state_dict_from_flax(flat))
    return m.eval().to(dtype)


# the JAX model's apply and segmentation, compiled once per shape and dtype
# (eager Flax takes ~10x longer on the CPU)
_apply = jax.jit(jfs.FastSCNN().apply)
_segment = jax.jit(jfs.segment_image)


def _seeded_init(key, H, W):
    """``fast_scnn.init_params(key, H, W)``, compiled (the same values)."""
    return jax.jit(jfs.FastSCNN().init)(key, jnp.zeros((H, W, 3)))


# case -> (variables, H, W)
CASES = {"seeded init 64x128": (lambda: _seeded_init(jax.random.PRNGKey(3), 64, 128), 64, 128),
         "committed weights 128x192": (lambda: jfs.load_params(WEIGHTS), 128, 192)}


@pytest.fixture(scope="module")
def nets():
    """Per case: the JAX variables, the flat checkpoint and an input
    image (a proxy scene)."""
    out = {}
    for name, (make, H, W) in CASES.items():
        img, _ = tsc.make_scene(np.random.default_rng(11), H, W)
        variables = make()
        out[name] = (variables, _flat(variables), img)
    return out


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("case", list(CASES))
def test_fast_scnn_matches_flax(nets, case, dtype):
    variables, flat, img = nets[case]
    x = img.astype(dtype)
    if dtype == "float64":
        variables = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), variables)
    want = np.asarray(_apply(variables, jnp.asarray(x)))  # [H,W,19]
    got = tfs.image_logits(_model(flat, getattr(torch, dtype)), torch.from_numpy(x))
    got = got.permute(1, 2, 0).numpy()
    assert got.dtype == want.dtype == np.dtype(dtype)
    scale = np.abs(want).max()
    err = np.abs(got - want).max() / scale
    agree = (got.argmax(-1) == want.argmax(-1)).mean()
    print(f"{case} {dtype}: logits within {err:.3e} of |max| {scale:.3e}, class maps {agree:.6f}")
    if dtype == "float64":
        assert err < F64_TOL, err
        assert agree == 1.0
    else:
        assert err < F32_TOL, err
        assert agree >= F32_CLASS_AGREE, agree


def test_state_dict_conversion_is_strict(nets):
    _, flat, _ = nets["committed weights 128x192"]
    sd = interop.fast_scnn_state_dict_from_flax(flat)
    assert sd.keys() == tfs.FastSCNN().state_dict().keys()
    np.testing.assert_array_equal(sd["ltd_dsconv1.dw.weight"].numpy(),
                                  flat["params/ltd_dsconv1/dw/kernel"].transpose(3, 2, 0, 1))
    assert tuple(sd["ltd_dsconv1.dw.weight"].shape) == (32, 1, 3, 3)
    np.testing.assert_array_equal(sd["cls_conv.bias"].numpy(), flat["params/cls_conv/bias"])
    np.testing.assert_array_equal(sd["gfe_ppm.conv3.bn.running_var"].numpy(),
                                  flat["batch_stats/gfe_ppm/conv3/bn/var"])
    missing = dict(flat)
    missing.pop("params/ffm_conv_lower/bias")
    with pytest.raises(KeyError, match="ffm_conv_lower.bias"):
        interop.fast_scnn_state_dict_from_flax(missing)
    with pytest.raises(KeyError, match="unknown key"):
        interop.fast_scnn_state_dict_from_flax({**flat, "params/cls_conv/gamma": np.ones(19)})
    with pytest.raises(KeyError, match="does not fit"):
        interop.fast_scnn_state_dict_from_flax({**flat, "params/cls_conv/bias": np.ones(18)})


@pytest.mark.parametrize("out_hw", [(13, 5), (4, 9), (7, 11)])
def test_resize_align_corners(out_hw):
    x = np.random.default_rng(2).normal(size=(2, 7, 11, 3))
    src = x[:, :1, :1] if out_hw == (7, 11) else x  # 1x1 -> HxW: pyramid pooling's bins=1
    want = np.asarray(jfs.resize_align_corners(jnp.asarray(src), out_hw))
    got = tfs.resize_align_corners(torch.from_numpy(src).permute(0, 3, 1, 2), out_hw)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, rtol=0, atol=1e-12)


@pytest.mark.parametrize("bins", [1, 2, 3, 6])
def test_adaptive_avg_pool(bins):
    x = np.random.default_rng(bins).normal(size=(1, 13, 17, 4))
    want = np.asarray(jfs._adaptive_avg_pool(jnp.asarray(x), bins))
    got = tfs._adaptive_avg_pool(torch.from_numpy(x).permute(0, 3, 1, 2), bins)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, rtol=0, atol=1e-12)


def test_classify_keypoints_and_weights():
    """Half-pixel coordinates round half to even in both packages; out of
    the image they clip."""
    seg = np.random.default_rng(4).integers(0, 19, (9, 13))
    xy = np.array([[0.5, 0.5], [1.5, 2.5], [2.5, 3.5], [11.5, 7.5], [12.5, 8.5], [-0.5, 4.5],
                   [13.4, -0.6], [6.49, 6.51], [3.5000001, 2.4999999]])
    want = np.asarray(jfs.classify_keypoints(jnp.asarray(seg), jnp.asarray(xy)))
    got = tfs.classify_keypoints(torch.from_numpy(seg), torch.from_numpy(xy)).numpy()
    np.testing.assert_array_equal(got, want)
    cls = np.array([0, 10, 11, 2, 10])
    np.testing.assert_array_equal(
        tfs.suppression_weights(torch.from_numpy(cls)).numpy(),
        np.asarray(jfs.suppression_weights(jnp.asarray(cls)), np.float32))


def _ab_build(suppress: bool):
    """tests/test_cnn_suppression.py's A/B case on the port's estimator."""
    cams, exts = tsyn.stereo_rig(device="cpu")
    est = test_.Estimator(cams, list(exts), TImu.create(g=9.81, device="cpu"),
                          test_.EstimatorConfig(), device="cpu")
    rng = np.random.default_rng(1)
    T_SC7 = [np.concatenate([T.r.numpy(), T.q.numpy()]) for T in exts]
    pose0 = np.array([0.0, 0, 0, 0, 0, 0, 1.0])
    pose1_gt = np.array([0.25, 0.1, 0.05, 0, 0, 0, 1.0])
    s0 = est.add_state(0.0, np.zeros((0, 3)), np.zeros((0, 3)), np.zeros(0))
    est.states[s0].pose = pose0
    est.states[s0].frozen = True
    s1 = est.add_state(0.1, np.zeros((0, 3)), np.zeros((0, 3)), np.zeros(0))
    pose1_init = pose1_gt.copy()
    pose1_init[:3] += [0.03, -0.02, 0.01]
    est.states[s1].pose = pose1_init

    def project(cam, pose7, ci, pt):
        T_WC = se3_np.compose7(pose7, T_SC7[ci])
        p_C = se3_np.quat_to_mat(T_WC[3:7]).T @ (pt - T_WC[:3])
        if p_C[2] < 0.1:
            return None
        uv, valid = cam.project(torch.from_numpy(p_C))
        return uv.numpy() if bool(valid) else None

    kp = 0
    for pt in rng.uniform([-2, -2, 4], [2, 2, 8], size=(25, 3)):  # consistent
        lid = est.add_landmark(np.concatenate([pt, [1.0]]), initialised=True)
        for sid, p in ((s0, pose0), (s1, pose1_gt)):
            for ci, cam in enumerate(cams):
                uv = project(cam, p, ci, pt)
                if uv is not None:
                    est.add_observation(lid, sid, ci, kp, uv)
                    kp += 1
    # "person" landmarks moved 0.4 m between the frames: inconsistent
    for pt in rng.uniform([-1, -1, 3], [1, 1, 5], size=(8, 3)):
        lid = est.add_landmark(np.concatenate([pt, [1.0]]), initialised=True)
        if suppress:
            est.landmarks[lid].info_scale = 1e-4
        moved = pt + np.array([0.4, 0.0, 0.0])
        for sid, p, target in ((s0, pose0, pt), (s1, pose1_gt, moved)):
            for ci, cam in enumerate(cams):
                uv = project(cam, p, ci, target)
                if uv is not None:
                    est.add_observation(lid, sid, ci, kp, uv)
                    kp += 1
    est.optimise(iterations=15)
    return np.linalg.norm(est.states[s1].pose[:3] - pose1_gt[:3])


def test_suppressed_landmarks_do_not_drag_the_pose():
    err_plain = _ab_build(suppress=False)
    err_supp = _ab_build(suppress=True)
    assert err_supp < 2e-3, err_supp
    assert err_supp < err_plain * 0.5, (err_plain, err_supp)


@pytest.fixture(scope="module")
def suppressors():
    return {"jax": jsup.CnnSuppressor(WEIGHTS), "port": tsup.CnnSuppressor(WEIGHTS, device="cpu")}


def test_classifier_marks_sky_and_person(suppressors):
    """tests/test_cnn_suppression.py's classifier case with the port's
    make_scene (equal to the JAX package's) and network; its class maps
    against the JAX package's on the same scenes."""
    rj, rt = np.random.default_rng(5), np.random.default_rng(5)
    ok_sky = total_sky = 0
    agree = []
    for _ in range(4):
        img, lab = tsc.make_scene(rt)
        img_j, lab_j = jtrain.make_scene(rj)
        np.testing.assert_array_equal(img, img_j)
        np.testing.assert_array_equal(lab, lab_j)
        seg = tfs.segment_image(suppressors["port"].model(), torch.from_numpy(img)).numpy()
        seg_j = np.asarray(_segment(suppressors["jax"].params, jnp.asarray(img)))
        agree.append((seg == seg_j).mean())
        sky_px = lab == tfs.SKY_CLASS
        ok_sky += (seg[sky_px] == tfs.SKY_CLASS).sum()
        total_sky += sky_px.sum()
    assert total_sky > 0
    assert ok_sky / total_sky > 0.7, ok_sky / total_sky
    assert min(agree) >= F32_CLASS_AGREE, agree


class _Records:
    """The estimator surface ``suppress`` reads: one state's observations
    and the landmarks' information scales."""

    class _Lm:
        def __init__(self, s):
            self.info_scale = s

    def __init__(self, obs, scales):
        self.obs, self.set = obs, {}
        self.landmarks = {lid: self._Lm(s) for lid, s in scales.items()}

    def obs_of_state(self, sid):
        return self.obs

    def set_info_scale(self, lid, s):
        self.landmarks[lid].info_scale = s
        self.set[lid] = s


@pytest.mark.parametrize("images", ["float", "uint8"])
def test_suppressor_matches_jax(suppressors, images):
    """Both packages' ``suppress`` on the same observations of two proxy
    scenes (one per camera), 200 keypoints each; uint8 images reach both
    networks unscaled (0-255), a divergence of the reference kept on
    purpose (ROADMAP C)."""
    rng = np.random.default_rng(8)
    imgs = [tsc.make_scene(rng, 128, 192)[0][..., 0] for _ in range(2)]
    if images == "uint8":
        imgs = [(im * 255.0 + 0.5).astype(np.uint8) for im in imgs]
    xy = [np.stack([rng.uniform(0, 192, 200), rng.uniform(0, 128, 200)], -1) for _ in range(2)]
    obs = [(lid, lid % 2, lid // 2) for lid in range(300)] + [(999, 0, 3)]  # 999: gone
    scales = {lid: (1e-4 if lid % 37 == 0 else 1.0) for lid in range(300)}
    got = {}
    for pkg, supp in suppressors.items():
        rec = _Records(obs, scales)
        n = supp.suppress(rec, [{"xy": x} for x in xy], 0, imgs)
        got[pkg] = (n, rec.set)
    print(f"{images}: suppressed {got['port'][0]} (JAX {got['jax'][0]})")
    assert got["port"] == got["jax"]
    if images == "float":
        assert got["port"][0] > 10


@pytest.fixture(scope="module")
def worlds():
    cj, ej = jsr.small_rig(128, 96, f=60.0)
    ct, et = tsr.small_rig(128, 96, f=60.0, dtype=torch.float64, device="cpu")
    kw = dict(duration=1.0, frame_rate=4.0, tex_size=256)
    return (jds.TexturedWorldDataset(cj, ej, JImu.create(g=9.81), **kw),
            tds.TexturedWorldDataset(ct, et, TImu.create(g=9.81, device="cpu"), device="cpu",
                                     **kw))


def _check_render(got, want, tag):
    (im_t, lab_t), (im_j, lab_j) = got, want
    assert im_t.dtype == np.float32 and im_t.shape == (96, 128)
    np.testing.assert_allclose(im_t, im_j, rtol=0, atol=RENDER_TOL, err_msg=tag)
    agree = (lab_t == lab_j).mean()
    assert agree >= LABEL_AGREE, (tag, agree)
    return agree


def test_textured_world_matches_jax(worlds):
    j, t = worlds
    for f in ("plane_p0", "plane_eu", "plane_ev", "plane_class", "textures"):
        np.testing.assert_array_equal(getattr(t, f), getattr(j, f), err_msg=f)
    # the stream: IMU and poses, and its exposure clock from frame 0
    ev_j = [ev for ev in j.stream()]
    ev_t = [ev for ev in t.stream()]
    assert [e[0] for e in ev_t] == [e[0] for e in ev_j]
    for a, b in zip(ev_t, ev_j):
        if a[0] == "images":
            np.testing.assert_allclose(a[3], b[3], rtol=0, atol=1e-9)
            for k, (im_t, im_j) in enumerate(zip(a[2], b[2])):
                np.testing.assert_allclose(im_t, im_j, rtol=0, atol=RENDER_TOL, err_msg=str(k))
    # labels: a pose that sees the sky and the person, at the clock's frame 3
    pose = t.ground_truth(0.75)
    t._frame_i = j._frame_i = 3
    labelled_t, labelled_j = t.render_with_labels(pose), j.render_with_labels(pose)
    agree = [_check_render(a, b, f"camera {k}")
             for k, (a, b) in enumerate(zip(labelled_t, labelled_j))]
    lab = labelled_t[0][1]
    print(f"labels agree on {min(agree):.6f} of the pixels; sky {np.mean(lab == 10):.3f}, "
          f"person {np.mean(lab == 11):.3f}")
    assert (lab == t.CLASS_SKY).any() and (lab == t.CLASS_PERSON).any()
