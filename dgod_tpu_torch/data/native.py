"""The host libraries of the data path, in C++ (the port's own copy of
dgod_tpu/data/native.py's image prep, and its image decode).

- `csrc/host/image_prep.cpp`: the fused resize + flip + pad of one image
  onto the static canvas. It and OpenCV's resize agree to +/-1 LSB
  (tests/test_torch_data.py); OpenCV runs where cv2 imports (faster: SIMD),
  the C++ prep otherwise.
- `csrc/host/image_decode.cpp`: the PNG row unfilter and a baseline JPEG
  decoder (data/png.py, data/jpeg.py), used where cv2 does not import.

Each is compiled with g++ at first use into the gitignored `_build/`
directory (keyed by a hash of the source and flags) and bound with ctypes,
which releases the GIL during a call. A failed build raises: nothing falls
back to a slower path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Callable, Optional

import numpy as np

PKG = Path(__file__).resolve().parents[1]
BUILD_DIR = PKG / "_build"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")


class HostLibrary:
    """One C++ source of `csrc/host/`, built at first use and loaded once;
    `declare` sets the ctypes signatures of its functions."""

    def __init__(self, name: str, declare: Callable[[ctypes.CDLL], None]):
        self.src = PKG / "csrc" / "host" / f"{name}.cpp"
        self.name = name
        self._declare = declare
        self._lock = threading.Lock()
        self._lib: Optional[ctypes.CDLL] = None

    def path(self) -> Path:
        digest = hashlib.sha256(self.src.read_bytes()
                                + " ".join(GXX_FLAGS).encode())
        return BUILD_DIR / f"{self.name}-{digest.hexdigest()[:16]}.so"

    def _build(self, lib: Path) -> None:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        proc = subprocess.run(["g++", *GXX_FLAGS, str(self.src), "-o", tmp],
                              capture_output=True, text=True, timeout=240)
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"g++ failed for {self.src}:\n{proc.stderr}")
        os.replace(tmp, lib)  # atomic: a reader never sees half a file

    def get(self) -> ctypes.CDLL:
        """The loaded library, building it if needed (raises on failure)."""
        with self._lock:
            if self._lib is None:
                path = self.path()
                if not path.exists():
                    self._build(path)
                lib = ctypes.CDLL(str(path))
                self._declare(lib)
                self._lib = lib
            return self._lib


def _declare_prep(lib: ctypes.CDLL) -> None:
    lib.dgod_prepare_image.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.dgod_prepare_image.restype = None


def _declare_decode(lib: ctypes.CDLL) -> None:
    lib.dgod_png_unfilter.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
        ctypes.c_void_p]
    lib.dgod_png_unfilter.restype = ctypes.c_int64
    lib.dgod_jpeg_size.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int), ctypes.c_char_p, ctypes.c_int]
    lib.dgod_jpeg_size.restype = ctypes.c_int
    lib.dgod_jpeg_decode.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_char_p, ctypes.c_int]
    lib.dgod_jpeg_decode.restype = ctypes.c_int


IMAGE_PREP = HostLibrary("image_prep", _declare_prep)
IMAGE_DECODE = HostLibrary("image_decode", _declare_decode)


def _check(src: np.ndarray, canvas_hw, resized_hw) -> None:
    ch, cw = canvas_hw
    rh, rw = resized_hw
    if src.ndim != 3 or src.shape[2] != 3 or min(src.shape[:2]) < 1:
        raise ValueError(f"prepare_image takes [H, W, 3] images, got "
                         f"{src.shape}")
    if not (1 <= rh <= ch and 1 <= rw <= cw):
        raise ValueError(f"resized size {resized_hw} does not fit the "
                         f"canvas {canvas_hw}")


def prepare_image_native(src: np.ndarray, canvas_hw, resized_hw,
                         flip: bool) -> np.ndarray:
    """The C++ prep: uint8 [H, W, 3] -> uint8 canvas [ch, cw, 3]."""
    _check(src, canvas_hw, resized_hw)
    src = np.ascontiguousarray(src, np.uint8)
    ch, cw = canvas_hw
    rh, rw = resized_hw
    out = np.empty((ch, cw, 3), np.uint8)
    IMAGE_PREP.get().dgod_prepare_image(
        src.ctypes.data, src.shape[0], src.shape[1], out.ctypes.data, ch, cw,
        rh, rw, int(flip))
    return out


def prepare_image_cv2(src: np.ndarray, canvas_hw, resized_hw,
                      flip: bool) -> np.ndarray:
    """OpenCV's resize (INTER_LINEAR) and flip into the canvas."""
    import cv2

    _check(src, canvas_hw, resized_hw)
    ch, cw = canvas_hw
    rh, rw = resized_hw
    out = np.zeros((ch, cw, 3), np.uint8)
    # resize straight into the canvas view (cv2 accepts a row-strided dst
    # as long as pixels are contiguous); cv2 may return a fresh array
    # instead of writing the view, so copy when it does
    region = out[:rh, :rw]
    ret = cv2.resize(src, (rw, rh), dst=region, interpolation=cv2.INTER_LINEAR)
    if ret is not region:
        region[...] = ret
    if flip:
        ret = cv2.flip(region, 1, dst=region)
        if ret is not region:
            region[...] = ret
    return out


def prepare_image(src: np.ndarray, canvas_hw, resized_hw,
                  flip: bool) -> np.ndarray:
    """Fused resize + flip + pad to a uint8 canvas: OpenCV where it
    imports, the C++ prep otherwise (reference: albumentations Resize +
    HorizontalFlip + collate-time stack, train_driving_dg.py:125-133,
    DGcommon.py:14-31)."""
    try:
        import cv2  # noqa: F401
    except ImportError:
        return prepare_image_native(src, canvas_hw, resized_hw, flip)
    return prepare_image_cv2(src, canvas_hw, resized_hw, flip)
