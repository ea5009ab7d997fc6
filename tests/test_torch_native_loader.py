"""The port's EuRoC prefetcher (``okvis2_torch/pipeline/native_loader.py``
over ``okvis2_torch/native/dataloader.cpp``, built here with the host
compiler) against the port's Python reader and the JAX package's native
reader, on ``tests/test_native_loader.py``'s mini folder (5 stereo frames
of 64x48 noise written by OpenCV, Sub rows) and on copies of it whose PNGs
are re-encoded with Paeth, Average and mixed row filters
(``chip_smoke.encode_png_rows``):

- the port's native stream equals ``EurocDatasetReader``'s: events, order,
  times, IMU values and float32 images bit for bit;
- it equals the JAX ``NativeEurocReader``'s stream (OpenCV's decode and
  ``convertTo``) within 1e-6, as ``tests/test_native_loader.py`` holds that
  one to the PNGs;
- ``tests/test_native_loader.py``'s IMU case on the port's reader;
- a failed build raises from ``NativeEurocReader`` and ``open_euroc`` falls
  back to the Python reader.
"""

import os

import numpy as np
import pytest

from chip_smoke import compare_streams, filtered_copy
from okvis2_torch.ops import _build
from okvis2_torch.pipeline import native_loader as tnl
from okvis2_torch.pipeline.dataset import EurocDatasetReader
from test_native_loader import make_mini_euroc

FILTERS = {"sub": None, "paeth": [4], "average": [3], "mixed": [0, 1, 2, 3, 4]}


@pytest.fixture(scope="module")
def folders(tmp_path_factory):
    root = tmp_path_factory.mktemp("euroc_native")
    out = {"sub": str(root / "sub")}
    imgs = make_mini_euroc(out["sub"])
    for name, filters in FILTERS.items():
        if filters:
            out[name] = str(root / name)
            assert filtered_copy(out["sub"], out[name], filters) == len(imgs)
    return out, imgs


@pytest.mark.parametrize("name", sorted(FILTERS))
def test_native_stream_equals_python_reader(folders, name):
    paths, imgs = folders
    reader = tnl.open_euroc(paths[name], 2)
    assert isinstance(reader, tnl.NativeEurocReader)
    counts = compare_streams(reader.stream(), EurocDatasetReader(paths[name], 2).stream())
    assert counts == {"imu": 20, "images": 5}
    # and the pixels are the images written
    frames = [e for e in reader.stream() if e[0] == "images"]
    for i, (_, _, got) in enumerate(frames):
        for c in range(2):
            assert np.array_equal(got[c], imgs[(c, i)].astype(np.float32) / 255.0)
    reader.close()


@pytest.mark.parametrize("name", ["sub", "paeth"])
def test_native_stream_matches_jax_native_reader(folders, name):
    from okvis2_tpu.pipeline.native_loader import NativeEurocReader

    paths, _ = folders
    try:
        jax_reader = NativeEurocReader(paths[name], 2)
    except RuntimeError:
        pytest.skip("the JAX package's native loader does not build here")
    got, want = list(tnl.NativeEurocReader(paths[name], 2).stream()), list(jax_reader.stream())
    assert [(e[0], round(e[1], 6)) for e in got] == [(e[0], round(e[1], 6)) for e in want]
    for g, w in zip(got, want):
        if g[0] == "imu":
            np.testing.assert_allclose(np.concatenate(g[2:]), np.concatenate(w[2:]), rtol=1e-12)
        else:
            for a, b in zip(g[2], w[2]):
                np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)


def test_native_loader_imu_values(folders):
    paths, _ = folders
    nat = tnl.NativeEurocReader(paths["sub"], 2)
    assert nat.num_frames == 5
    assert nat.width == 64 and nat.height == 48
    imu = [e for e in nat.stream() if e[0] == "imu"]
    assert len(imu) == 20
    # accel z ~ gravity
    assert abs(np.mean([e[2][2] for e in imu]) - 9.81) < 0.5


def test_failed_build_raises_and_open_euroc_falls_back(folders, tmp_path, monkeypatch):
    paths, _ = folders
    broken = tmp_path / "native"
    broken.mkdir()
    (broken / "dataloader.cpp").write_text("#error a source that does not build\n")
    monkeypatch.setattr(_build, "NATIVE", str(broken))
    monkeypatch.setattr(_build, "BUILD_ROOT", str(tmp_path / "build"))
    _build.load_host_library.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="build failed"):
            tnl.NativeEurocReader(paths["sub"], 2)
        reader = tnl.open_euroc(paths["sub"], 2)
        assert type(reader) is EurocDatasetReader
        assert sum(1 for e in reader.stream() if e[0] == "images") == 5
    finally:
        _build.load_host_library.cache_clear()
    assert not [f for _, _, fs in os.walk(tmp_path / "build") for f in fs if f.endswith(".so")]
