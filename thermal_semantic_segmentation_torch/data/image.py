"""The PIL image operations the port uses, on numpy arrays, without PIL.

An image is a numpy array whose dtype and shape carry PIL's mode: '1'
(H, W) bool, 'L' (H, W) uint8, 'LA' (H, W, 2), 'RGB' (H, W, 3) and 'RGBA'
(H, W, 4) uint8, 'I;16' (H, W) uint16, 'I' (H, W) int32, 'F' (H, W)
float32. A 'P' image is its (H, W) uint8 indices, with its (n, 3) palette
passed beside it where ``convert`` needs it. Sizes are PIL's (width,
height).

Each operation is written from Pillow's own algorithm (``Resample.c``,
``Geometry.c``, ``Convert.c``, ``Blend.c``, ``ImageEnhance``) and gives
PIL's pixels bit for bit (tests/test_torch_image_ops.py holds them to
Pillow):

- ``resize``: BICUBIC (a = -0.5) and BILINEAR with the support widened by
  the scale when reducing, the coefficients computed in float64 and
  normalised as ``precompute_coeffs`` does; horizontal pass first, an
  unchanged axis skipped; each pass in ``csrc/resample.cpp`` (built with
  g++ at first use, like the PNG unfilter; a failed build raises). 8-bit
  modes sum in 22-bit fixed point and clip to 8 bits after each pass; 'F'
  and 'I' sum in float64 over the taps in order; 'I;16' rounds the float64
  sum and stores its low byte and its high byte each clipped to 0..255 (a
  sum over 65535 keeps its low byte). NEAREST samples PIL's pixel
  centres;
- ``convert`` (RGB -> L by ITU-R 601-2 luma in 16-bit fixed point,
  P -> RGB/L through the palette, '1'/LA/RGBA -> L/RGB), ``crop`` (zeros
  outside the image), ``flip_left_right``, and the ``ImageEnhance``
  brightness, contrast and colour blends.

``open_image`` reads PNG with ``data/png.py``. Other formats (JPEG) go to
PIL, imported there; on a host without PIL they raise ``ImageReadError``
naming the file.
"""

from __future__ import annotations

import ctypes
import functools
import io
from typing import Optional, Tuple

import numpy as np

from . import gxx
from .png import PngImage, _source_bytes, is_png, read_png

NEAREST, BILINEAR, BICUBIC = "nearest", "bilinear", "bicubic"
_PRECISION_BITS = 22            # Resample.c: 32 - 8 - 2
RESAMPLE_SOURCE = gxx.CSRC_DIR / "resample.cpp"


class ImageReadError(ValueError):
    """A file this host cannot decode (a format that needs PIL, without
    PIL)."""


def read_image(src, name: Optional[str] = None) -> PngImage:
    """Decode a path, file object or bytes: (pixels, palette). PNG by the
    port's own reader; any other format by PIL."""
    data, default_name = _source_bytes(src)
    name = name or default_name
    if is_png(data):
        return read_png(data, name)
    kind = "JPEG" if data[:3] == b"\xff\xd8\xff" else "this image format"
    try:
        from PIL import Image, ImageFile
    except ImportError:
        raise ImageReadError(
            f"{name}: {kind} is not decoded on this host: it needs PIL, "
            f"which is not installed (PNG is read without it)") from None
    ImageFile.LOAD_TRUNCATED_IMAGES = True
    img = Image.open(io.BytesIO(data))
    palette = None
    if img.mode == "P":
        palette = np.asarray(img.getpalette("RGB"), np.uint8).reshape(-1, 3)
    return PngImage(np.asarray(img), palette)


def open_image(src, mode: Optional[str] = None, name: Optional[str] = None
               ) -> np.ndarray:
    """``Image.open(src)``'s pixels, or ``.convert(mode)``'s with ``mode``
    ('L' or 'RGB')."""
    pixels, palette = read_image(src, name)
    return pixels if mode is None else convert(pixels, mode, palette)


def size(image: np.ndarray) -> Tuple[int, int]:
    """PIL's ``Image.size``: (width, height)."""
    return image.shape[1], image.shape[0]


def mode_of(image: np.ndarray, palette=None) -> str:
    """PIL's mode of an array (and palette)."""
    dt, nd = image.dtype, image.ndim
    if dt == bool and nd == 2:
        return "1"
    if dt == np.uint8 and nd == 2:
        return "L" if palette is None else "P"
    if dt == np.uint8 and nd == 3 and image.shape[2] in (2, 3, 4):
        return {2: "LA", 3: "RGB", 4: "RGBA"}[image.shape[2]]
    if dt == np.uint16 and nd == 2:
        return "I;16"
    if dt == np.int32 and nd == 2:
        return "I"
    if dt == np.float32 and nd == 2:
        return "F"
    raise ValueError(f"no PIL mode holds a {dt} array of shape "
                     f"{image.shape}")


def _luma(rgb: np.ndarray) -> np.ndarray:
    """PIL's RGB -> L: (R * 19595 + G * 38470 + B * 7471 + 0x8000) >> 16."""
    c = rgb.astype(np.uint32)
    return ((c[..., 0] * 19595 + c[..., 1] * 38470 + c[..., 2] * 7471
             + 0x8000) >> 16).astype(np.uint8)


def convert(image, mode: str, palette=None) -> np.ndarray:
    """PIL's ``convert`` to 'L' or 'RGB' from '1', 'L', 'P' (with its
    ``palette``), 'LA', 'RGB' and 'RGBA'. An image already in ``mode`` is
    returned as it is."""
    image = np.asarray(image)
    src = mode_of(image, palette)
    if src == mode:
        return image
    if src == "P":
        pal = np.zeros((256, 3), np.uint8)
        pal[: len(palette)] = np.asarray(palette, np.uint8)[:256]
        image, src = pal[image], "RGB"
    elif src == "1":
        image, src = np.where(image, np.uint8(255), np.uint8(0)), "L"
    elif src in ("LA", "RGBA"):
        image, src = image[..., :-1], src[:-1]
        if src == "L":
            image = image[..., 0]
    if src == mode:
        return np.ascontiguousarray(image)
    if (src, mode) == ("RGB", "L"):
        return _luma(image)
    if (src, mode) == ("L", "RGB"):
        return np.repeat(image[..., None], 3, axis=2)
    raise ValueError(f"convert from {mode_of(np.asarray(image))} to {mode} "
                     f"is not supported")


# --- resampling --------------------------------------------------------------


def _bicubic(x: np.ndarray) -> np.ndarray:
    a, x = -0.5, np.abs(x)
    return np.where(x < 1.0, ((a + 2.0) * x - (a + 3.0)) * x * x + 1,
                    np.where(x < 2.0, (((x - 5) * x + 8) * x - 4) * a, 0.0))


def _bilinear(x: np.ndarray) -> np.ndarray:
    x = np.abs(x)
    return np.where(x < 1.0, 1.0 - x, 0.0)


_FILTERS = {BICUBIC: (_bicubic, 2.0), BILINEAR: (_bilinear, 1.0)}


@functools.lru_cache(maxsize=64)
def coefficients(in_size: int, out_size: int, resample: str = BICUBIC
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pillow's ``precompute_coeffs`` along one axis: (first source index
    (out,), taps in bounds (out,), float64 weights (out, ksize)), each row
    normalised by its sum taken tap by tap, the taps past a row's bound
    zero."""
    fn, support = _FILTERS[resample]
    scale = float(in_size) / out_size
    filterscale = max(scale, 1.0)
    support = support * filterscale
    ksize = int(np.ceil(support)) * 2 + 1
    center = (np.arange(out_size) + 0.5) * scale
    xmin = np.maximum(np.trunc(center - support + 0.5), 0).astype(np.int64)
    count = np.minimum(np.trunc(center + support + 0.5),
                       in_size).astype(np.int64) - xmin
    taps = np.arange(ksize)
    w = fn((taps[None, :] + xmin[:, None] - center[:, None] + 0.5)
           * (1.0 / filterscale))
    w = np.where(taps[None, :] < count[:, None], w, 0.0)
    total = np.zeros(out_size)
    for t in range(ksize):                  # PIL sums tap by tap
        total += w[:, t]
    nonzero = total != 0.0
    w[nonzero] /= total[nonzero, None]
    for a in (xmin, count, w):
        a.setflags(write=False)
    return xmin, count, w


def weight_matrix(in_size: int, out_size: int, resample: str = BICUBIC
                  ) -> np.ndarray:
    """The (out, in) float64 weights of one axis of ``resize``
    (``coefficients`` laid out dense): the float result of a pass is
    ``weight_matrix @ x``."""
    xmin, count, w = coefficients(in_size, out_size, resample)
    m = np.zeros((out_size, in_size))
    rows = np.arange(out_size)
    for t in range(w.shape[1]):
        ok = t < count
        m[rows[ok], xmin[ok] + t] = w[ok, t]
    return m


def _fixed_point(w: np.ndarray) -> np.ndarray:
    """``normalize_coeffs_8bpc``: weights in 22-bit fixed point, rounded
    half away from zero."""
    scaled = w * (1 << _PRECISION_BITS)
    return np.trunc(np.where(w < 0, scaled - 0.5, scaled + 0.5)).astype(
        np.int64)


# the C++ pass of each mode: (function, pixel dtype, weight dtype)
_PASSES = {"L": ("tss_resample_u8", np.uint8, np.int32),
           "RGB": ("tss_resample_u8", np.uint8, np.int32),
           "F": ("tss_resample_f32", np.float32, np.float64),
           "I": ("tss_resample_i32", np.int32, np.float64),
           "I;16": ("tss_resample_u16", np.uint16, np.float64)}


def _bind(lib: ctypes.CDLL) -> None:
    for name in {fn for fn, _, _ in _PASSES.values()}:
        fn = getattr(lib, name)
        fn.restype = None
        fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_long] * 4 + [
            ctypes.c_void_p] * 3 + [ctypes.c_long]


def _resample_lib() -> ctypes.CDLL:
    """The resample library, built with g++ at the first call; a build or
    load failure raises."""
    return gxx.load(RESAMPLE_SOURCE, _bind)


def _pass(image: np.ndarray, axis: int, in_size: int, out_size: int,
          resample: str, mode: str, offset: int = 0) -> np.ndarray:
    """One resampling pass along ``axis`` (1: horizontal, 0: vertical) of
    an ``in_size`` axis, in ``mode``'s arithmetic, by ``csrc/resample.cpp``
    with the GIL released; ``image`` holds that axis from source index
    ``offset`` on."""
    xmin, count, w = coefficients(in_size, out_size, resample)
    name, dtype, kdtype = _PASSES[mode]
    k = np.ascontiguousarray(_fixed_point(w) if kdtype == np.int32 else w,
                             kdtype)
    src = np.ascontiguousarray(image, dtype)
    outer = src.shape[0] if axis else 1
    inner = int(np.prod(src.shape[axis + 1:], dtype=np.int64))
    out = np.empty(src.shape[:axis] + (out_size,) + src.shape[axis + 1:],
                   dtype)
    first = np.ascontiguousarray(xmin - offset, np.int64)
    getattr(_resample_lib(), name)(
        src.ctypes.data, out.ctypes.data, outer, src.shape[axis], out_size,
        inner, first.ctypes.data, count.ctypes.data, k.ctypes.data,
        k.shape[1])
    return out


def _nearest_index(in_size: int, out_size: int, stepped: bool
                   ) -> np.ndarray:
    """The source index PIL's NEAREST takes for each output pixel, the
    floor of its centre (x + 0.5) * in / out: for 8-bit, 'I' and 'F'
    images (``ImagingScaleAffine``) the centre is stepped, the half scale
    plus the scale added once a pixel; for 'I;16' (the generic affine
    transform) it is computed for each pixel."""
    scale = float(in_size) / out_size
    if stepped:
        centre = np.add.accumulate(np.r_[scale * 0.5,
                                         np.full(out_size - 1, scale)])
    else:
        centre = scale * (np.arange(out_size) + 0.5)
    return np.minimum(centre.astype(np.int64), in_size - 1)


def resize(image, out_size: Tuple[int, int], resample: str = BICUBIC
           ) -> np.ndarray:
    """PIL's ``Image.resize(out_size, resample)``; ``out_size`` is (width,
    height). A '1' image, and NEAREST, take the nearest source pixel (a 'P'
    image passes as its indices: ask for NEAREST, as PIL forces)."""
    image = np.asarray(image)
    w, h = out_size
    in_w, in_h = size(image)
    if (w, h) == (in_w, in_h):
        return image.copy()
    if resample == NEAREST or image.dtype == bool:
        stepped = image.dtype != np.uint16
        return image[_nearest_index(in_h, h, stepped)][
            :, _nearest_index(in_w, w, stepped)]
    mode = mode_of(image)
    if mode not in ("L", "RGB", "I;16", "I", "F"):
        raise ValueError(f"resize of a {mode} image is not supported")
    if resample not in _FILTERS:
        raise ValueError(f"unknown resample {resample!r}")
    top = 0
    if w != in_w:
        if h != in_h:       # only the source rows the vertical pass reads
            ymin, count, _ = coefficients(in_h, h, resample)
            top = int(ymin[0])
            image = image[top:int(ymin[-1] + count[-1])]
        image = _pass(image, 1, in_w, w, resample, mode)
    if h != in_h:
        image = _pass(image, 0, in_h, h, resample, mode, offset=top)
    return image


def crop(image, box) -> np.ndarray:
    """PIL's ``crop(box)``, box (left, upper, right, lower): the pixels
    outside the image are zero."""
    image = np.asarray(image)
    x0, y0, x1, y1 = (int(v) for v in box)
    out = np.zeros((max(y1 - y0, 0), max(x1 - x0, 0)) + image.shape[2:],
                   image.dtype)
    in_w, in_h = size(image)
    sx0, sy0 = max(x0, 0), max(y0, 0)
    sx1, sy1 = min(x1, in_w), min(y1, in_h)
    if sx1 > sx0 and sy1 > sy0:
        out[sy0 - y0:sy1 - y0, sx0 - x0:sx1 - x0] = image[sy0:sy1, sx0:sx1]
    return out


def flip_left_right(image) -> np.ndarray:
    """PIL's ``transpose(FLIP_LEFT_RIGHT)``."""
    return np.ascontiguousarray(np.asarray(image)[:, ::-1])


# --- ImageEnhance --------------------------------------------------------------


def _blend(degenerate: np.ndarray, image: np.ndarray, factor: float
           ) -> np.ndarray:
    """``Image.blend(degenerate, image, factor)`` of 8-bit images: in
    float32, ``degenerate + factor * (image - degenerate)``, truncated and
    clipped to 0..255."""
    if image.dtype != np.uint8 or mode_of(image) not in ("L", "RGB"):
        raise ValueError(f"image has wrong mode: blend takes L or RGB, "
                         f"not {mode_of(image)}")
    alpha = np.float32(factor)
    d = degenerate.astype(np.float32)
    t = d + alpha * (image.astype(np.int32)
                     - degenerate.astype(np.int32)).astype(np.float32)
    return np.clip(t, 0, 255).astype(np.uint8)


def enhance_brightness(image, factor: float) -> np.ndarray:
    """``ImageEnhance.Brightness(image).enhance(factor)``: a blend with
    black."""
    image = np.asarray(image)
    return _blend(np.zeros_like(image), image, factor)


def enhance_contrast(image, factor: float) -> np.ndarray:
    """``ImageEnhance.Contrast(image).enhance(factor)``: a blend with the
    grey of the L image's mean, rounded."""
    image = np.asarray(image)
    gray = convert(image, "L")
    mean = int(int(gray.sum(dtype=np.int64)) / gray.size + 0.5)
    degenerate = convert(np.full(gray.shape, mean, np.uint8), mode_of(image))
    return _blend(degenerate, image, factor)


def enhance_color(image, factor: float) -> np.ndarray:
    """``ImageEnhance.Color(image).enhance(factor)``: a blend with the
    image's own greyscale."""
    image = np.asarray(image)
    degenerate = convert(convert(image, "L"), mode_of(image))
    return _blend(degenerate, image, factor)
