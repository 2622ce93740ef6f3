"""ctypes binding to the port's host image library (PyTorch port of the
JAX package's `runtime/native.py`).

The library (`csrc/host/`: libjpeg / libpng decode, BMP and PPM readers,
the cv2-semantics letterbox and a multithreaded decode + letterbox batch
loader) is the port's own copy of the JAX package's host sources, built by
`_build.build_host` with the host C++ compiler into `_build/` at first
use, never at import.  JPEG and PNG decode are compiled in only where
libjpeg and libpng (headers and libraries) are found; without them the
library decodes BMP and PPM and `decode_image` returns None on JPEG and
PNG files.  Where the library does not build or load `load_native`
returns None.  `native_status` says which formats it decodes, or why it
is absent; `serve/batch_runner.py` decodes what it does not through
`serve/imageio.py`, as the JAX runner falls back to PIL.
"""
from __future__ import annotations

import ctypes
import os
import threading
from typing import Sequence

import numpy as np

from yolov8_vit_tpu_torch import _build

_lib = None
_error: str | None = None       # why the library did not build
# the runner decodes on a thread pool: its first calls build and load once
_load_lock = threading.Lock()


def build_native(quiet: bool = True) -> bool:
    """Compile the host library (if missing); returns success.  With
    `quiet=False` the compiler's output is printed."""
    global _error
    try:
        path = _build.build_host()
    except (RuntimeError, OSError) as e:
        _error = str(e)
        if not quiet:
            print(_error)
        return False
    if not quiet:
        with open(path + ".log") as fh:
            print(fh.read())
    return True


def load_native(auto_build: bool = True):
    """Load (and memoize) the library; None if it is unavailable.  A
    failed build or load is not retried in this process.  Thread-safe."""
    if _lib is not None:
        return _lib
    with _load_lock:
        return _load(auto_build)


def _load(auto_build: bool):
    global _lib, _error
    if _lib is not None:
        return _lib
    if _error is None and auto_build:
        build_native()
    if _error is not None:
        return None
    try:
        path = _build.host_lib_path()
        if not os.path.exists(path):
            return None
        lib = ctypes.CDLL(path)
    except (RuntimeError, OSError) as e:   # no compiler; a foreign build
        _error = str(e)
        return None
    lib.mt_formats.restype = ctypes.c_int
    lib.mt_formats.argtypes = []
    lib.mt_decode.restype = ctypes.c_void_p
    lib.mt_decode.argtypes = [ctypes.c_char_p,
                              ctypes.POINTER(ctypes.c_int),
                              ctypes.POINTER(ctypes.c_int)]
    lib.mt_copy_pixels.restype = None
    lib.mt_copy_pixels.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.mt_free.restype = None
    lib.mt_free.argtypes = [ctypes.c_void_p]
    lib.mt_load_letterbox_batch.restype = ctypes.c_int
    lib.mt_load_letterbox_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_ubyte, ctypes.c_int, ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_float), ctypes.c_char_p]
    lib.mt_crop_resize_nearest.restype = None
    lib.mt_crop_resize_nearest.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_char_p]
    _lib = lib
    return lib


def native_available() -> bool:
    return load_native() is not None


FORMATS = {"jpeg": 1, "png": 2, "bmp": 4, "ppm": 8}


def decoded_formats() -> list[str]:
    """The formats `decode_image` reads (none without the library)."""
    lib = load_native()
    bits = lib.mt_formats() if lib is not None else 0
    return [name for name, bit in FORMATS.items() if bits & bit]


def native_status() -> str:
    """Whether the library is loaded, from where and for which formats
    (and why a format is left out), or why it is absent."""
    lib = load_native()
    if lib is None:
        return f"not built: {_error or 'library missing'}"
    missing = {k: v for k, v in _build.host_features().items()
               if v is not None}
    return (f"built: {_build.host_lib_path()}; decodes "
            f"{', '.join(decoded_formats())}"
            + "".join(f"; no {k}: {v}" for k, v in missing.items()))


def decode_image(path: str) -> np.ndarray | None:
    """Decode JPEG / PNG / PPM / BMP -> HWC uint8 RGB, or None (no
    library, or the file does not decode)."""
    lib = load_native()
    if lib is None:
        return None
    w = ctypes.c_int()
    h = ctypes.c_int()
    handle = lib.mt_decode(path.encode(), ctypes.byref(w), ctypes.byref(h))
    if not handle:
        return None
    out = np.empty((h.value, w.value, 3), np.uint8)
    lib.mt_copy_pixels(ctypes.c_void_p(handle),
                       out.ctypes.data_as(ctypes.c_char_p))
    lib.mt_free(ctypes.c_void_p(handle))
    return out


def _require():
    lib = load_native()
    if lib is None:
        raise RuntimeError(f"host image library unavailable "
                           f"({native_status()})")
    return lib


def load_letterbox_batch(paths: Sequence[str], out_hw: tuple[int, int],
                         pad_value: int = 114, num_threads: int = 8):
    """Parallel decode + letterbox -> (batch (N, H, W, 3) uint8 RGB,
    geom (N, 3) [ratio, dw, dh] f32, ok (N,) bool); a frame that does not
    decode is all zeros with ok False."""
    lib = _require()
    n = len(paths)
    out_h, out_w = out_hw
    batch = np.zeros((n, out_h, out_w, 3), np.uint8)
    geom = np.zeros((n, 3), np.float32)
    ok = np.zeros((n,), np.uint8)
    arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    lib.mt_load_letterbox_batch(
        arr, n, out_w, out_h, pad_value, num_threads,
        batch.ctypes.data_as(ctypes.c_char_p),
        geom.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ok.ctypes.data_as(ctypes.c_char_p))
    return batch, geom, ok.astype(bool)


def crop_resize_nearest(img: np.ndarray, box, out_hw=(224, 224)) -> np.ndarray:
    """Crop integer xyxy `box` from HWC uint8 `img`, nearest-resized to
    out_hw with ops/crop.py's source mapping."""
    lib = _require()
    out_h, out_w = out_hw
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"expected an (H, W, 3) image, got {img.shape}")
    dst = np.empty((out_h, out_w, 3), np.uint8)
    x1, y1, x2, y2 = (int(v) for v in box)
    lib.mt_crop_resize_nearest(
        img.ctypes.data_as(ctypes.c_char_p), img.shape[1], img.shape[0],
        x1, y1, x2, y2, out_w, out_h, dst.ctypes.data_as(ctypes.c_char_p))
    return dst
