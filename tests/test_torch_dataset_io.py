"""The port's dataset IO against OpenCV and the JAX package, on the CPU.

- PNG: ``png.read_png`` against ``cv2.imread(..., IMREAD_GRAYSCALE)`` on
  files OpenCV wrote and on PNGs built here with each of the five row
  filters (filtered in numpy by the PNG specification, one filter per
  image and all five mixed); ``cv2.imread`` of the port's written files;
  colour and 16-bit files refused.
- The EuRoC and RPG readers' event streams against the JAX readers on
  mini folders (``tests/test_native_loader.py``'s, and an RPG one):
  kinds, timestamps and arrays exact; the threaded ``start_streaming``.
- ``DatasetWriter``: the CSVs byte for byte the JAX writer's, the images
  equal.
- ``Trajectory``, ``Propagator``, ``write_rpg_csv`` / ``write_euroc_csv``
  against the JAX package: 1e-12, and the files byte for byte.
"""

import os
import struct
import threading
import zlib

import cv2
import numpy as np
import pytest

from okvis2_torch.pipeline import dataset as tds
from okvis2_torch.pipeline import png
from okvis2_torch.pipeline import trajectory as ttr
from okvis2_tpu.pipeline import dataset as jds
from okvis2_tpu.pipeline import trajectory as jtr

from test_native_loader import make_mini_euroc

FILTERS = ("none", "sub", "up", "average", "paeth")


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def _filter_row(kind, row, prev):
    """One image row filtered by PNG filter ``kind`` (0-4), as a writer
    would (PNG specification, section 9)."""
    x = row.astype(np.int64)
    up = prev.astype(np.int64)
    left = np.concatenate([[0], x[:-1]])
    upleft = np.concatenate([[0], up[:-1]])
    if kind == 0:
        pred = np.zeros_like(x)
    elif kind == 1:
        pred = left
    elif kind == 2:
        pred = up
    elif kind == 3:
        pred = (left + up) // 2
    else:
        pred = np.array([_paeth(a, b, c) for a, b, c in zip(left, up, upleft)])
    return ((x - pred) % 256).astype(np.uint8)


def _png_bytes(img, kinds):
    """An 8-bit gray PNG of ``img`` whose row y uses filter kinds[y]."""
    H, W = img.shape
    raw = bytearray()
    prev = np.zeros(W, np.uint8)
    for y in range(H):
        raw.append(kinds[y])
        raw += _filter_row(kinds[y], img[y], prev).tobytes()
        prev = img[y]

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    return (png.SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8, 0, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(bytes(raw))) + chunk(b"IEND", b""))


def _image(H, W, seed):
    """Random noise with smooth and flat regions (every filter's branches)."""
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (H, W)).astype(np.uint8)
    img[: H // 3] = np.linspace(0, 255, W).astype(np.uint8)
    img[H // 3: H // 2, : W // 2] = 200
    return img


@pytest.mark.parametrize("shape", [(480, 752), (37, 53), (1, 1), (5, 300)])
def test_read_png_of_opencv_files(tmp_path, shape):
    img = _image(*shape, seed=sum(shape))
    fn = str(tmp_path / "cv.png")
    assert cv2.imwrite(fn, img)
    np.testing.assert_array_equal(png.read_png(fn), cv2.imread(fn, cv2.IMREAD_GRAYSCALE))
    np.testing.assert_array_equal(png.read_png(fn), img)


@pytest.mark.parametrize("kind", list(range(5)) + ["mixed"], ids=list(FILTERS) + ["mixed"])
def test_read_png_each_filter(tmp_path, kind):
    img = _image(41, 67, seed=3)
    kinds = [kind] * 41 if kind != "mixed" else [y % 5 for y in range(41)]
    fn = str(tmp_path / f"f{kind}.png")
    with open(fn, "wb") as f:
        f.write(_png_bytes(img, kinds))
    ours = png.read_png(fn)
    np.testing.assert_array_equal(ours, img)
    np.testing.assert_array_equal(ours, cv2.imread(fn, cv2.IMREAD_GRAYSCALE))


@pytest.mark.parametrize("shape", [(480, 752), (3, 4)])
def test_write_png_read_by_opencv(tmp_path, shape):
    img = _image(*shape, seed=5)
    fn = str(tmp_path / "ours.png")
    png.write_png(fn, img)
    np.testing.assert_array_equal(cv2.imread(fn, cv2.IMREAD_UNCHANGED), img)
    np.testing.assert_array_equal(png.read_png(fn), img)
    with open(fn, "rb") as f:  # every row Sub-filtered
        rows = np.frombuffer(zlib.decompress(
            b"".join(b for k, b in png._chunks(f.read(), fn) if k == b"IDAT")), np.uint8)
    assert (rows.reshape(shape[0], shape[1] + 1)[:, 0] == 1).all()


@pytest.mark.parametrize("what", ["colour", "16-bit", "corrupt"])
def test_read_png_refuses(tmp_path, what):
    fn = str(tmp_path / "x.png")
    img = _image(8, 9, seed=1)
    if what == "colour":
        cv2.imwrite(fn, np.stack([img] * 3, -1))
    elif what == "16-bit":
        cv2.imwrite(fn, img.astype(np.uint16) * 257)
    else:
        data = bytearray(png.encode_png(img))
        data[40] ^= 0xFF
        with open(fn, "wb") as f:
            f.write(bytes(data))
    with pytest.raises(ValueError):
        png.read_png(fn)


def _same_events(ev_t, ev_j):
    assert [e[0] for e in ev_t] == [e[0] for e in ev_j]
    assert len(ev_t) == len(ev_j) > 0
    for a, b in zip(ev_t, ev_j):
        assert a[1] == b[1]
        if a[0] == "imu":
            for x, y in zip(a[2:], b[2:]):
                np.testing.assert_array_equal(x, y)
        else:
            assert len(a[2]) == len(b[2])
            for x, y in zip(a[2], b[2]):
                assert x.dtype == y.dtype == np.float32
                np.testing.assert_array_equal(x, y)


@pytest.fixture(scope="module")
def mini_euroc(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("euroc"))
    return root, make_mini_euroc(root)


@pytest.mark.parametrize("tol", [0.005, 0.0005])
def test_euroc_reader_matches(mini_euroc, tol):
    root, imgs = mini_euroc
    ev_t = list(tds.EurocDatasetReader(root, 2).stream(tol))
    ev_j = list(jds.EurocDatasetReader(root, 2).stream(tol))
    _same_events(ev_t, ev_j)
    n_img = sum(e[0] == "images" for e in ev_t)
    assert n_img == (5 if tol == 0.005 else 0)  # cam1 runs 1 ms behind cam0
    if n_img:
        first = next(e for e in ev_t if e[0] == "images")
        np.testing.assert_array_equal(first[2][1], imgs[(1, 0)].astype(np.float32) / 255.0)


def test_euroc_reader_streams_on_a_thread(mini_euroc):
    root, _ = mini_euroc
    reader = tds.EurocDatasetReader(root, 2)
    got, done = [], threading.Event()
    reader.set_imu_callback(lambda t, a, g: got.append(("imu", t)))

    def on_images(t, images):
        got.append(("images", t))
        if sum(k == "images" for k, _ in got) == 5:
            done.set()

    reader.set_images_callback(on_images)
    reader.start_streaming()
    assert done.wait(30)
    reader.stop_streaming()
    assert not reader._thread.is_alive()
    want = [(e[0], e[1]) for e in reader.stream()]
    assert got == want[:len(got)] and len(got) >= len(want) - 4


def _make_rpg(root, stereo):
    rng = np.random.default_rng(2)
    imgs = []
    lists = ("left_images.txt", "right_images.txt") if stereo else ("images.txt",)
    for li, name in enumerate(lists):
        with open(os.path.join(root, name), "w") as f:
            f.write("# id timestamp image_name\n")
            for i in range(4):
                img = rng.integers(0, 255, (24, 32), np.uint8)
                fn = f"img/{name[0]}{i}.png"
                os.makedirs(os.path.join(root, "img"), exist_ok=True)
                cv2.imwrite(os.path.join(root, fn), img)
                # the right camera's last frame is 20 ms late: dropped
                t = 0.1 * i + (0.02 if (li == 1 and i == 3) else 0.0)
                f.write(f"{i} {t:.6f} {fn}\n")
                imgs.append(img)
    with open(os.path.join(root, "imu.txt"), "w") as f:
        f.write("# id timestamp wx wy wz ax ay az\n")
        for i in range(40):
            v = rng.normal(0, 0.1, 6)
            f.write(f"{i} {0.01 * i:.6f} " + " ".join(f"{x:.6f}" for x in v) + "\n")
        f.write("\n")
    return imgs


@pytest.mark.parametrize("stereo", [False, True], ids=["mono", "stereo"])
def test_rpg_reader_matches(tmp_path, stereo):
    _make_rpg(str(tmp_path), stereo)
    n = 2 if stereo else 1
    ev_t = list(tds.RpgDatasetReader(str(tmp_path), n).stream())
    ev_j = list(jds.RpgDatasetReader(str(tmp_path), n).stream())
    _same_events(ev_t, ev_j)
    assert sum(e[0] == "images" for e in ev_t) == (3 if stereo else 4)


def test_dataset_writer_matches(tmp_path):
    out = {}
    for name, mod in (("jax", jds), ("port", tds)):
        w = mod.DatasetWriter(str(tmp_path / name), num_cameras=2)
        r = np.random.default_rng(4)
        for i in range(6):
            t = 1403636579.0 + 0.05 * i + 1e-10 * i
            for k in range(3):
                w.add_imu_measurement(t + 0.01 * k, r.normal(0, 1, 3), r.normal(0, 0.1, 3))
            imgs = [r.uniform(-0.1, 1.1, (12, 16)).astype(np.float32),
                    r.integers(0, 256, (12, 16)).astype(np.uint8)]
            w.add_images(t, imgs)
        w.close()
        out[name] = tmp_path / name
    for rel in ("mav0/imu0/data.csv", "mav0/cam0/data.csv", "mav0/cam1/data.csv"):
        with open(out["jax"] / rel, "rb") as a, open(out["port"] / rel, "rb") as b:
            assert a.read() == b.read(), rel
    for c in range(2):
        names = sorted(os.listdir(out["jax"] / f"mav0/cam{c}/data"))
        assert names == sorted(os.listdir(out["port"] / f"mav0/cam{c}/data")) and len(names) == 6
        for n in names:
            np.testing.assert_array_equal(
                png.read_png(str(out["port"] / f"mav0/cam{c}/data" / n)),
                cv2.imread(str(out["jax"] / f"mav0/cam{c}/data" / n), cv2.IMREAD_GRAYSCALE))


def _states(seed, n=7):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        q = rng.normal(size=4)
        q /= np.linalg.norm(q)
        if i == 3:
            q = -q  # a hemisphere flip between neighbours
        out.append((0.1 * i + 1e-4 * rng.uniform(), np.concatenate([rng.normal(size=3), q])))
    return out


def test_trajectory_matches():
    tj, tt = jtr.Trajectory(), ttr.Trajectory()
    for sid, (t, p) in enumerate(_states(0)):
        tj.update(sid, t, p)
        tt.update(sid, t, p)
    tj.update(2, 0.21, _states(1)[2][1])  # a rewrite of history
    tt.update(2, 0.21, _states(1)[2][1])
    assert tt.get_state(9) is None and tj.get_state(9) is None
    for t in np.linspace(-0.1, 0.8, 37):
        np.testing.assert_allclose(tt.state_at(t), tj.state_at(t), rtol=0, atol=1e-12)
    assert [s[0] for s in tt.states()] == [s[0] for s in tj.states()]
    assert ttr.Trajectory().state_at(0.3) is None


def test_propagator_matches():
    pj, pt = jtr.Propagator(g=9.81), ttr.Propagator(g=9.81)
    assert pt.add_imu_measurement(0.0, [0, 0, 9.81], [0, 0, 0]) is None
    rng = np.random.default_rng(3)
    pose = np.array([0.1, 0.2, 0.3, 0.0, 0.0, np.sin(0.2), np.cos(0.2)])
    sb = np.concatenate([rng.normal(size=3), rng.normal(0, 0.01, 6)])
    pj.set_state(0.0, pose, sb)
    pt.set_state(0.0, pose, sb)
    ts = np.concatenate([[-0.005, 0.0], np.cumsum(rng.uniform(0.004, 0.006, 60)), [0.1]])
    for t in ts:
        acc, gyr = rng.normal([0, 0, 9.81], 0.5), rng.normal(0, 0.3, 3)
        a, b = pt.add_imu_measurement(t, acc, gyr), pj.add_imu_measurement(t, acc, gyr)
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)
    np.testing.assert_allclose(pt.current_pose(), pj.current_pose(), rtol=0, atol=1e-12)


@pytest.mark.parametrize("writer", ["write_rpg_csv", "write_euroc_csv"])
def test_trajectory_writers_match(tmp_path, writer):
    states = _states(5)
    getattr(jtr, writer)(str(tmp_path / "j.csv"), states)
    getattr(ttr, writer)(str(tmp_path / "t.csv"), states)
    with open(tmp_path / "j.csv", "rb") as a, open(tmp_path / "t.csv", "rb") as b:
        assert a.read() == b.read()
