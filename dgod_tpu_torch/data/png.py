"""A small PNG reader and writer (stdlib zlib + numpy + the C++ unfilter),
for hosts without OpenCV.

`read_png` decodes 8-bit RGB and RGBA, non-interlaced PNGs into an RGB
uint8 array (alpha dropped, as `cv2.imread` with its default flag drops
it); any other PNG raises, naming cv2 as the decoder that reads it. zlib
inflates the image data (it releases the GIL) and
`csrc/host/image_decode.cpp` undoes the five row filters in one pass
(`data/native.py` builds it; a failed build raises). `decode_png_plain`
undoes them in numpy and Python, byte by byte for Average and Paeth: the
plain version the tests hold the C++ one to. `write_png` writes an RGB
uint8 array with filter None on every row.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from . import native

SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {2: 3, 6: 4}  # colour type -> channels (RGB, RGBA)


def _unsupported(path, what: str) -> ValueError:
    return ValueError(f"{path}: {what}; this reader takes 8-bit RGB/RGBA "
                      "non-interlaced PNG only, install opencv-python "
                      "(cv2) to read other images")


def _chunks(data: bytes, path):
    pos = len(SIGNATURE)
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        crc = data[pos + 8 + length:pos + 12 + length]
        if len(body) != length or len(crc) != 4:
            raise ValueError(f"{path}: truncated PNG chunk {kind!r}")
        if struct.unpack(">I", crc)[0] != zlib.crc32(kind + body):
            raise ValueError(f"{path}: bad CRC in PNG chunk {kind!r}")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + length
    raise ValueError(f"{path}: PNG without IEND")


def _unfilter_row_sequential(kind: int, row: bytearray, prev: bytes,
                             bpp: int) -> None:
    """Undo the Average (3) or Paeth (4) filter of one row in place."""
    for i in range(len(row)):
        a = row[i - bpp] if i >= bpp else 0
        b = prev[i]
        if kind == 3:
            pred = (a + b) >> 1
        else:
            c = prev[i - bpp] if i >= bpp else 0
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        row[i] = (row[i] + pred) & 0xFF


def _inflate(data: bytes, path):
    """PNG bytes -> (height, width, bytes per pixel, the inflated rows:
    `height` rows of 1 + width * bpp bytes, filter type first)."""
    if data[:len(SIGNATURE)] != SIGNATURE:
        raise _unsupported(path, "not a PNG file")
    header, idat = None, []
    for kind, body in _chunks(data, path):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError(f"{path}: PNG without IHDR")
    width, height, depth, colour, _, _, interlace = header
    if depth != 8 or colour not in _CHANNELS or interlace != 0:
        raise _unsupported(path, f"bit depth {depth}, colour type {colour}, "
                                 f"interlace {interlace}")
    bpp = _CHANNELS[colour]
    stride = width * bpp
    try:  # one output buffer of the known size: no growth, no join
        raw = zlib.decompress(b"".join(idat), bufsize=height * (stride + 1))
    except zlib.error as e:
        raise ValueError(f"{path}: corrupt PNG image data ({e})") from e
    if len(raw) != height * (stride + 1):
        raise ValueError(f"{path}: PNG image data has {len(raw)} bytes, "
                         f"expected {height * (stride + 1)}")
    return height, width, bpp, raw


def decode_png(data: bytes, path="<bytes>") -> np.ndarray:
    """PNG bytes -> RGB uint8 [H, W, 3], unfiltered by the C++ library."""
    height, width, bpp, raw = _inflate(data, path)
    out = np.empty((height, width, 3), np.uint8)
    bad = native.IMAGE_DECODE.get().dgod_png_unfilter(
        raw, height, width, bpp, out.ctypes.data)
    if bad:
        raise ValueError(f"{path}: unknown PNG filter type "
                         f"{raw[(bad - 1) * (width * bpp + 1)]}")
    return out


def decode_png_plain(data: bytes, path="<bytes>") -> np.ndarray:
    """`decode_png` with the filters undone in numpy and Python."""
    height, width, bpp, raw = _inflate(data, path)
    stride = width * bpp
    rows = np.frombuffer(raw, np.uint8).reshape(height, stride + 1)
    out = np.empty((height, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(height):
        kind = int(rows[y, 0])
        row = rows[y, 1:]
        if kind == 0:
            out[y] = row
        elif kind == 1:  # Sub: a running sum along the row, per channel
            out[y] = np.cumsum(row.reshape(width, bpp), axis=0,
                               dtype=np.uint8).reshape(stride)
        elif kind == 2:  # Up
            out[y] = row + prev
        elif kind in (3, 4):
            buf = bytearray(row.tobytes())
            _unfilter_row_sequential(kind, buf, prev.tobytes(), bpp)
            out[y] = np.frombuffer(bytes(buf), np.uint8)
        else:
            raise ValueError(f"{path}: unknown PNG filter type {kind}")
        prev = out[y]
    return out.reshape(height, width, bpp)[:, :, :3].copy()


def read_png(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_png(f.read(), path)


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def encode_png(img: np.ndarray) -> bytes:
    """RGB uint8 [H, W, 3] -> PNG bytes, filter None on every row."""
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"encode_png takes [H, W, 3] uint8, got {img.shape}")
    h, w, _ = img.shape
    rows = np.zeros((h, 1 + 3 * w), np.uint8)
    rows[:, 1:] = img.reshape(h, 3 * w)
    return (SIGNATURE
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 1))  # fast
            + _chunk(b"IEND", b""))


def write_png(path: str, img: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(img))
