"""EuRoC reader with image decoding off the interpreter lock, frames ahead.

Port of ``okvis2_tpu/pipeline/native_loader.py``, whose C++ prefetcher
(``okvis2_tpu/native/dataloader.cpp``) decodes PNGs with OpenCV on a thread
of its own, N frames ahead of the caller. The port needs no image library:

- worker threads decode up to ``prefetch`` frames ahead of the stream, each
  image read, checked and inflated with ``zlib.decompress``
  (``png.inflate_png``; the lock is released while it inflates), its row
  filters undone and its pixels scaled to float32 in
  ``okvis2_torch/native/dataloader.cpp`` (through ctypes, which releases
  the lock too). That source is built on first use with the host compiler
  (``ops/_build.py::load_host_library``);
- the CSVs, the camera sync and the event order are
  ``pipeline/dataset.py::EurocDatasetReader``'s own, so the stream is its
  stream: ``('imu', t, acc, gyr)`` / ``('images', t, [img...])`` with the
  5 ms IMU look-ahead, images float32 in [0, 1] equal bit for bit to its
  ``load_image``. All five PNG row filters decode at C speed (the Python
  codec loops per pixel on Average and Paeth rows).

``NativeEurocReader`` raises when the library does not build; it never
decodes in Python instead. ``open_euroc`` keeps the reference's fallback to
the Python reader.
"""

from __future__ import annotations

import collections
import concurrent.futures
import ctypes
from typing import Iterator, Optional

import numpy as np

from okvis2_torch.pipeline import png
from okvis2_torch.pipeline.dataset import EurocDatasetReader, _imu_events

DECODE_THREADS = 4


def load_native_lib() -> ctypes.CDLL:
    """The built ``native/dataloader.cpp`` with its argument types set
    (built on first use; raises on a failed build)."""
    from okvis2_torch.ops._build import load_host_library

    lib = load_host_library("dataloader")
    lib.png_unfilter_gray8.restype = ctypes.c_int
    lib.png_unfilter_gray8.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
                                       np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")]
    return lib


def decode_image(lib: ctypes.CDLL, path: str) -> np.ndarray:
    """The PNG at ``path`` as float32 [H, W] in [0, 1], decoded by the
    native library."""
    with open(path, "rb") as f:
        width, height, rows = png.inflate_png(f.read(), path)
    out = np.empty((height, width), np.float32)
    if lib.png_unfilter_gray8(rows, height, width, out) != 0:
        raise ValueError(f"{path}: unknown row filter")
    return out


class NativeEurocReader:
    """``EurocDatasetReader``'s event stream with the images decoded
    ``prefetch`` frames ahead by DECODE_THREADS threads."""

    def __init__(self, path: str, num_cameras: int = 2, sync_tolerance: float = 0.005,
                 prefetch: int = 8):
        self._lib = load_native_lib()
        self._reader = EurocDatasetReader(path, num_cameras)
        self.num_cameras = num_cameras
        self.sync_tolerance = sync_tolerance
        self._frames = self._reader.synced_frames(sync_tolerance)
        self._imu = self._reader._read_imu()
        self.num_frames = len(self._frames)
        self.width = self.height = 0
        if self._frames:
            with open(self._frames[0][1][0], "rb") as f:
                self.width, self.height, _ = png.inflate_png(f.read(), self._frames[0][1][0])
        self._prefetch = max(int(prefetch), 1)
        self._pool: Optional[concurrent.futures.ThreadPoolExecutor] = None

    def _decode_frame(self, paths):
        return [decode_image(self._lib, p) for p in paths]

    def close(self):
        if self._pool is not None:
            self._pool.shutdown(wait=True, cancel_futures=True)
            self._pool = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def stream(self, sync_tolerance: Optional[float] = None) -> Iterator[tuple]:
        """Yield ('imu', t, acc, gyr) / ('images', t, [img...]) in time order
        (``sync_tolerance`` None: the constructor's), the images decoded
        ahead by the worker threads."""
        frames = self._frames if sync_tolerance in (None, self.sync_tolerance) \
            else self._reader.synced_frames(sync_tolerance)
        self.close()
        self._pool = pool = concurrent.futures.ThreadPoolExecutor(
            DECODE_THREADS, thread_name_prefix="euroc-decode")
        ahead = collections.deque()
        nxt = 0

        def fill():
            nonlocal nxt
            while nxt < len(frames) and len(ahead) < self._prefetch:
                ahead.append(pool.submit(self._decode_frame, frames[nxt][1]))
                nxt += 1

        def decoded(_paths):  # frames come in order: the oldest decode is this one
            fill()
            out = ahead.popleft().result()
            fill()
            return out

        fill()
        try:
            yield from _imu_events(self._imu, frames, decoded)
        finally:
            if self._pool is pool:
                self.close()


def open_euroc(path: str, num_cameras: int = 2, sync_tolerance: float = 0.005):
    """The native reader, or the Python one where it does not build."""
    try:
        return NativeEurocReader(path, num_cameras, sync_tolerance)
    except Exception:
        return EurocDatasetReader(path, num_cameras)
