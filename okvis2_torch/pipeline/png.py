"""8-bit grayscale PNG read and write, over ``zlib`` and numpy.

The dataset readers and writer need only what EuRoC folders hold: 8-bit
grayscale images. This codec replaces ``cv2.imread(fn,
cv2.IMREAD_GRAYSCALE)`` and ``cv2.imwrite`` for them, so the port needs no
image library.

- ``read_png`` decodes non-interlaced 8-bit grayscale PNGs (colour type 0,
  bit depth 8) with any of the five row filters: None, Sub and Up are
  vectorised in numpy (Sub is a uint8 ``cumsum`` along the row, which wraps
  modulo 256 as the filter does), Average and Paeth are row loops. Every
  other PNG (colour, palette, alpha, 16-bit, 1-4 bit, interlaced) is
  refused with a ``ValueError`` that names its header: OpenCV's grayscale
  conversion of colour images is libpng's, which this codec does not
  reproduce. Chunk CRCs are checked.
- ``write_png`` writes uint8 [H, W] images with the Sub filter on every row
  (as OpenCV writes grayscale images).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _chunks(data: bytes, path: str):
    if data[:8] != SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos = 8
    while pos + 12 <= len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        if len(body) != n or zlib.crc32(kind + body) != crc:
            raise ValueError(f"{path}: corrupt {kind!r} chunk")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + n
    raise ValueError(f"{path}: truncated PNG (no IEND chunk)")


def _average_row(f: np.ndarray, up: np.ndarray) -> np.ndarray:
    out = np.empty_like(f)
    left = 0
    for x in range(f.shape[0]):
        left = (int(f[x]) + ((left + int(up[x])) >> 1)) & 0xFF
        out[x] = left
    return out


def _paeth_row(f: np.ndarray, up: np.ndarray) -> np.ndarray:
    out = np.empty_like(f)
    a = c = 0
    for x in range(f.shape[0]):
        b = int(up[x])
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        a = (int(f[x]) + pred) & 0xFF
        out[x] = a
        c = b
    return out


def inflate_png(data: bytes, path: str = "<bytes>"):
    """(width, height, rows) of an 8-bit grayscale PNG's bytes: ``rows``
    the inflated image data, per row one filter byte and ``width`` filtered
    bytes (``zlib.decompress`` releases the interpreter lock)."""
    header, idat = None, []
    for kind, body in _chunks(data, path):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    width, height, depth, colour, compression, filt, interlace = header
    if (depth, colour, compression, filt, interlace) != (8, 0, 0, 0, 0):
        raise ValueError(
            f"{path}: only non-interlaced 8-bit grayscale PNGs are supported (bit depth "
            f"{depth}, colour type {colour}, interlace {interlace})")
    raw = zlib.decompress(b"".join(idat))
    if len(raw) != height * (width + 1):
        raise ValueError(f"{path}: {len(raw)} bytes of image data for {width}x{height}")
    return width, height, raw


def decode_png(data: bytes, path: str = "<bytes>") -> np.ndarray:
    """uint8 [H, W] pixels of an 8-bit grayscale PNG's bytes."""
    width, height, raw = inflate_png(data, path)
    rows = np.frombuffer(raw, np.uint8).reshape(height, width + 1)
    kinds, filtered = rows[:, 0], rows[:, 1:]
    if kinds.max(initial=0) > 4:
        raise ValueError(f"{path}: unknown row filter {int(kinds.max())}")
    if not kinds.any():
        return filtered.copy()
    if (kinds == 1).all():
        return np.cumsum(filtered, axis=1, dtype=np.uint8)
    out = np.empty((height, width), np.uint8)
    prev = np.zeros(width, np.uint8)
    for y in range(height):
        f, k = filtered[y], int(kinds[y])
        if k == 0:
            row = f.copy()
        elif k == 1:
            row = np.cumsum(f, dtype=np.uint8)
        elif k == 2:
            row = f + prev  # uint8: wraps modulo 256
        elif k == 3:
            row = _average_row(f, prev)
        else:
            row = _paeth_row(f, prev)
        out[y] = row
        prev = row
    return out


def read_png(path: str) -> np.ndarray:
    """uint8 [H, W] pixels of the 8-bit grayscale PNG at ``path``."""
    with open(path, "rb") as f:
        return decode_png(f.read(), path)


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def encode_png(img: np.ndarray) -> bytes:
    """PNG bytes of a uint8 [H, W] image, the Sub filter on every row."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim != 2:
        raise ValueError(f"write_png takes uint8 [H, W] images, got {img.dtype} {img.shape}")
    height, width = img.shape
    sub = np.empty((height, width + 1), np.uint8)
    sub[:, 0] = 1
    sub[:, 1] = img[:, 0]
    np.subtract(img[:, 1:], img[:, :-1], out=sub[:, 2:])  # uint8: wraps modulo 256
    ihdr = struct.pack(">IIBBBBB", width, height, 8, 0, 0, 0, 0)
    return (SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(sub.tobytes())) + _chunk(b"IEND", b""))


def write_png(path: str, img: np.ndarray) -> None:
    """Write a uint8 [H, W] image to ``path`` as an 8-bit grayscale PNG."""
    data = encode_png(img)
    with open(path, "wb") as f:
        f.write(data)
