"""A baseline JPEG reader for hosts without OpenCV (`read_jpeg`).

`csrc/host/image_decode.cpp` decodes the file (`data/native.py` builds it;
a failed build raises): sequential Huffman coding, 8-bit samples, 1 or 3
components, chroma at 4:4:4, 4:2:2, 4:2:0 or 4:4:0, restart intervals,
with libjpeg's default arithmetic (islow IDCT, fancy upsampling, its
YCbCr->RGB tables), so the RGB it gives equals what `cv2.imread` and a
BGR->RGB swap give, bit for bit. Anything else (progressive or
arithmetic-coded files, 12-bit samples, CMYK) raises ValueError naming
what the reader takes; so does a truncated file.
"""

from __future__ import annotations

import ctypes

import numpy as np

from . import native

SIGNATURE = b"\xff\xd8"


def decode_jpeg(data: bytes, path="<bytes>") -> np.ndarray:
    """JPEG bytes -> RGB uint8 [H, W, 3]."""
    lib = native.IMAGE_DECODE.get()
    err = ctypes.create_string_buffer(256)
    h, w = ctypes.c_int(), ctypes.c_int()
    if lib.dgod_jpeg_size(data, len(data), ctypes.byref(h), ctypes.byref(w),
                          err, len(err)):
        raise _error(path, err)
    out = np.empty((h.value, w.value, 3), np.uint8)
    if lib.dgod_jpeg_decode(data, len(data), out.ctypes.data, h.value,
                            w.value, err, len(err)):
        raise _error(path, err)
    return out


def _error(path, err) -> ValueError:
    return ValueError(f"{path}: {err.value.decode(errors='replace')}; this "
                      "reader takes baseline (sequential Huffman) 8-bit "
                      "JPEGs with 1 or 3 components, chroma 4:4:4, 4:2:2, "
                      "4:2:0 or 4:4:0")


def read_jpeg(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_jpeg(f.read(), path)
