"""ctypes bindings for the native C++ batch image IO (counterpart of the JAX
``data/native_loader.py``; source ``csrc/tss_io.cpp``).

One call decodes a whole batch of PNG/JPEG files on a C++ thread pool with
the GIL released: 16-bit IR frames come back window-normalised float32, RGB
frames uint8. Encoding writes batches of 8-bit images (an optional
PIL-BICUBIC-equivalent resize, then PNG or JPEG by suffix) and palette PNGs.
This is host IO: no device work and no CUDA kernel.

The library is compiled at first use by ``data/gxx.py`` (``g++ ... -lpng
-ljpeg -lz``). When it cannot be built or loaded (no ``g++``, or no
libpng/libjpeg headers), ``available()`` is false, the reason is logged
once, and the callers read sample by sample through ``data/image.py``.

The native decode resizes bilinearly; ``data/image.py``'s BICUBIC (PIL's)
stays the parity path (``data/freiburg.py``), as in the JAX package.
"""

from __future__ import annotations

import ctypes
import logging
import os
import threading
from typing import Optional, Sequence

import numpy as np

from . import gxx

SOURCE = gxx.CSRC_DIR / "tss_io.cpp"
BUILD_DIR = gxx.BUILD_DIR
LIBS = ("-lpng", "-ljpeg", "-lz")

_lock = threading.Lock()
_state: dict = {}          # "lib": the loaded CDLL or None, "why": reason


def library_path():
    return gxx.library_path(SOURCE, LIBS)


def build():
    """Compile ``csrc/tss_io.cpp`` unless its library exists; returns the
    library's path. Raises ``RuntimeError`` with the compiler's output when
    the build fails."""
    return gxx.build(SOURCE, LIBS)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    c_int, c_float, c_u8 = ctypes.c_int, ctypes.c_float, ctypes.c_uint8
    paths = ctypes.POINTER(ctypes.c_char_p)
    lib.tss_decode_ir_batch.restype = c_int
    lib.tss_decode_ir_batch.argtypes = [
        paths, c_int, c_int, c_int, c_int, c_int, c_float, c_float,
        ctypes.POINTER(c_float), c_int]
    lib.tss_decode_rgb_batch.restype = c_int
    lib.tss_decode_rgb_batch.argtypes = [
        paths, c_int, c_int, c_int, c_int, c_int, ctypes.POINTER(c_u8),
        c_int]
    lib.tss_decode_raw.restype = c_int
    lib.tss_decode_raw.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint16), ctypes.c_long,
        ctypes.POINTER(c_int), ctypes.POINTER(c_int)]
    lib.tss_encode_batch.restype = c_int
    lib.tss_encode_batch.argtypes = [
        paths, ctypes.POINTER(c_u8), c_int, c_int, c_int, c_int, c_int,
        c_int, c_int, c_int]
    lib.tss_encode_pal8_batch.restype = c_int
    lib.tss_encode_pal8_batch.argtypes = [
        paths, ctypes.POINTER(c_u8), c_int, c_int, c_int,
        ctypes.POINTER(c_u8), c_int, c_int]
    return lib


def _load() -> Optional[ctypes.CDLL]:
    """The loaded library, built at the first call; None (the reason logged
    once) when it cannot be built or loaded."""
    with _lock:
        if "lib" not in _state:
            try:
                _state["lib"] = _bind(ctypes.CDLL(str(build())))
            except (RuntimeError, OSError) as e:
                _state["lib"], _state["why"] = None, str(e)
                logging.getLogger(__name__).warning(
                    "native C++ IO unavailable, reading sample by sample: %s", e)
        return _state["lib"]


def available() -> bool:
    return _load() is not None


def unavailable_reason() -> str:
    """Why ``available()`` is false ('' when it is true)."""
    _load()
    return _state.get("why", "")


def _lib() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native C++ IO unavailable: {_state['why']}")
    return lib


def _paths_array(paths: Sequence[str]):
    arr = (ctypes.c_char_p * len(paths))()
    arr[:] = [os.fsencode(p) for p in paths]
    return arr


def decode_ir_batch(paths: Sequence[str], *, resize_wh=(960, 320),
                    crop=(150, 850), window=(21800.0, 25000.0),
                    n_threads: int = 8) -> np.ndarray:
    """16-bit IR files -> float32 (N, H, crop_w, 1) in [0, 1]: a bilinear
    resize to ``resize_wh``, the column crop, then the window."""
    lib = _lib()
    n = len(paths)
    w, h = resize_wh
    out = np.empty((n, h, crop[1] - crop[0]), np.float32)
    ok = lib.tss_decode_ir_batch(
        _paths_array(paths), n, w, h, crop[0], crop[1],
        ctypes.c_float(window[0]), ctypes.c_float(window[1]),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n_threads)
    if ok != n:
        raise IOError(f"native decoder failed on {n - ok}/{n} images")
    return out[..., None]


def decode_rgb_batch(paths: Sequence[str], *, resize_wh=(960, 320),
                     crop=(150, 850), n_threads: int = 8) -> np.ndarray:
    """8-bit RGB (or gray, replicated) files -> uint8 (N, H, crop_w, 3)."""
    lib = _lib()
    n = len(paths)
    w, h = resize_wh
    out = np.empty((n, h, crop[1] - crop[0], 3), np.uint8)
    ok = lib.tss_decode_rgb_batch(
        _paths_array(paths), n, w, h, crop[0], crop[1],
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), n_threads)
    if ok != n:
        raise IOError(f"native decoder failed on {n - ok}/{n} images")
    return out


def encode_batch(paths: Sequence[str], images: np.ndarray, *,
                 resize_wh: Optional[tuple] = None, quality: int = 75,
                 n_threads: int = 8) -> None:
    """Write uint8 ``images`` ((N, H, W, C) with C 1 or 3, or (N, H, W)) to
    ``paths``: an optional PIL-BICUBIC-equivalent resize to ``resize_wh``
    (w, h), then JPEG (.jpg/.jpeg, at ``quality``, PIL's default 75) or PNG
    by each path's suffix."""
    if images.ndim == 3:
        images = images[..., None]
    images = np.ascontiguousarray(images, np.uint8)
    n, h, w, c = images.shape
    if n != len(paths) or c not in (1, 3):
        raise ValueError(f"images {images.shape} for {len(paths)} paths: "
                         f"want (N, H, W, 1 or 3)")
    lib = _lib()
    out_w, out_h = resize_wh if resize_wh is not None else (0, 0)
    ok = lib.tss_encode_batch(
        _paths_array(paths),
        images.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        n, h, w, c, out_w, out_h, quality, n_threads)
    if ok != n:
        raise IOError(f"native encoder failed on {n - ok}/{n} images")


def encode_pal8_batch(paths: Sequence[str], indices: np.ndarray,
                      palette: np.ndarray, *, n_threads: int = 8) -> None:
    """Write uint8 index maps (N, H, W) as palette PNGs with ``palette``
    ((n_colors, 3) uint8 RGB): the coloured pseudo-label files."""
    indices = np.ascontiguousarray(indices, np.uint8)
    palette = np.ascontiguousarray(palette, np.uint8)
    n, h, w = indices.shape
    if n != len(paths) or palette.ndim != 2 or palette.shape[1] != 3:
        raise ValueError(f"indices {indices.shape} for {len(paths)} paths, "
                         f"palette {palette.shape}: want (N, H, W) and "
                         f"(n_colors, 3)")
    lib = _lib()
    ok = lib.tss_encode_pal8_batch(
        _paths_array(paths),
        indices.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), n, h, w,
        palette.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        palette.shape[0], n_threads)
    if ok != n:
        raise IOError(f"native encoder failed on {n - ok}/{n} images")


def decode_raw(path: str, max_pixels: int = 64 << 20) -> np.ndarray:
    """One image at its own size as uint16 (H, W, C): the exact-decode
    check."""
    lib = _lib()
    buf = np.empty(max_pixels, np.uint16)
    w, h = ctypes.c_int(), ctypes.c_int()
    c = lib.tss_decode_raw(os.fsencode(path),
                           buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
                           buf.size, ctypes.byref(w), ctypes.byref(h))
    if c <= 0:
        raise IOError(f"native decode failed: {path}")
    return buf[: w.value * h.value * c].reshape(h.value, w.value, c).copy()
