"""PNG reading and PNG writing on ``zlib`` and ``struct``, without PIL.

``read_png`` decodes a PNG file, file object or bytes to the array
``np.asarray(PIL.Image.open(...))`` gives (the mode PIL opens it in) and the
palette of a 'P' image; the rows are unfiltered by ``csrc/png_unfilter.cpp``
(below). The writers:

The pseudo-label files are an 8-bit grayscale PNG of class ids and an 8-bit
palette ('P') PNG of the same ids under the Freiburg palette; the validation
dumps are palette PNGs of the prediction and the ground truth and a gray or
RGB PNG of the input image; the translation server answers with a gray or
RGB PNG; the synthetic Freiburg trees (``recipes/synthetic_trees.py``)
are 16-bit grayscale IR frames, RGB frames and grayscale labels. The JAX
package writes them all with PIL. The port writes them here: one IHDR, a
PLTE for the palette image, one IDAT of filter-0 rows, IEND. PIL decodes
them to the same pixels (and palette) as its own files.
"""

from __future__ import annotations

import ctypes
import os
import struct
import zlib
from typing import NamedTuple, Optional

import numpy as np

from . import gxx

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_GRAY, _RGB, _PALETTE = 0, 2, 3   # PNG colour types


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data)))


def _png_bytes(pixels: np.ndarray, colour_type: int,
               palette: bytes = b"", depth: int = 8) -> bytes:
    pixels = np.asarray(pixels)
    want = 3 if colour_type == _RGB else 2
    if pixels.ndim != want or 0 in pixels.shape or (
            want == 3 and pixels.shape[2] != 3):
        raise ValueError(f"expected a non-empty "
                         f"{'(H, W, 3)' if want == 3 else '2-D'} image, got "
                         f"shape {pixels.shape}")
    dtype = np.dtype(">u2") if depth == 16 else np.dtype(np.uint8)
    if pixels.dtype != dtype:
        top = 2 ** depth - 1
        if pixels.size and (pixels.min() < 0 or pixels.max() > top):
            raise ValueError(f"pixel values outside 0..{top}")
        pixels = pixels.astype(dtype)
    h, w = pixels.shape[:2]
    row = pixels[0].size * dtype.itemsize
    rows = np.zeros((h, row + 1), np.uint8)     # filter 0 (none)
    rows[:, 1:] = pixels.reshape(h, -1).view(np.uint8)
    header = struct.pack(">IIBBBBB", w, h, depth, colour_type, 0, 0, 0)
    parts = [_SIGNATURE, _chunk(b"IHDR", header)]
    if palette:
        parts.append(_chunk(b"PLTE", palette))
    parts += [_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)),
              _chunk(b"IEND", b"")]
    return b"".join(parts)


def gray_png_bytes(pixels: np.ndarray) -> bytes:
    """(H, W) values in 0..255 -> the bytes of an 8-bit grayscale PNG."""
    return _png_bytes(pixels, _GRAY)


def write_gray_png(path: str, pixels: np.ndarray) -> None:
    """``gray_png_bytes`` written to ``path``."""
    data = gray_png_bytes(pixels)
    with open(path, "wb") as f:
        f.write(data)


def gray16_png_bytes(pixels: np.ndarray) -> bytes:
    """(H, W) values in 0..65535 -> the bytes of a 16-bit grayscale PNG
    (PIL's 'I;16' file; a Freiburg IR frame)."""
    return _png_bytes(pixels, _GRAY, depth=16)


def write_gray16_png(path: str, pixels: np.ndarray) -> None:
    """``gray16_png_bytes`` written to ``path``."""
    data = gray16_png_bytes(pixels)
    with open(path, "wb") as f:
        f.write(data)


def rgb_png_bytes(pixels: np.ndarray) -> bytes:
    """(H, W, 3) values in 0..255 -> the bytes of an 8-bit RGB PNG."""
    return _png_bytes(pixels, _RGB)


def write_rgb_png(path: str, pixels: np.ndarray) -> None:
    """``rgb_png_bytes`` written to ``path``."""
    data = rgb_png_bytes(pixels)
    with open(path, "wb") as f:
        f.write(data)


def palette_png_bytes(indices: np.ndarray, palette) -> bytes:
    """(H, W) indices in 0..255 -> the bytes of an 8-bit palette PNG;
    ``palette`` is a flat [r, g, b, r, g, b, ...] list of up to 256
    colours (PIL's ``putpalette`` layout)."""
    pal = bytes(np.asarray(palette, np.uint8))
    if not pal or len(pal) % 3 or len(pal) > 768:
        raise ValueError(f"a palette holds 1-256 RGB triples, got "
                         f"{len(pal)} values")
    return _png_bytes(indices, _PALETTE, pal)


def write_palette_png(path: str, indices: np.ndarray, palette) -> None:
    """``palette_png_bytes`` written to ``path``."""
    data = palette_png_bytes(indices, palette)
    with open(path, "wb") as f:
        f.write(data)


# --- reading ---------------------------------------------------------------

UNFILTER_SOURCE = gxx.CSRC_DIR / "png_unfilter.cpp"
# samples a pixel for each colour type (grey, RGB, palette, grey+alpha, RGBA)
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
# the bit depths each colour type allows (the PNG specification, 11.2.2)
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16),
           6: (8, 16)}
# Adam7: (x0, y0, dx, dy) of the seven passes
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
# PIL's ``Image.MAX_IMAGE_PIXELS``: ``Image.open`` refuses an image of more
# than twice as many pixels (``DecompressionBombError``), and so does
# ``read_png``, before it allocates or inflates anything
MAX_IMAGE_PIXELS = 1024 * 1024 * 1024 // 4 // 3


class PngError(ValueError):
    """A PNG the reader does not decode: names the file and its IHDR."""


class PngImage(NamedTuple):
    """The decoded pixels as PIL's mode holds them -- '1' (H, W) bool,
    'L'/'P' (H, W) uint8, 'I;16' (H, W) uint16, 'LA' (H, W, 2), 'RGB'
    (H, W, 3), 'RGBA' (H, W, 4) uint8 -- and, for a 'P' image, its PLTE as
    (n, 3) uint8 (else None)."""
    pixels: np.ndarray
    palette: Optional[np.ndarray]


def _bind(lib: ctypes.CDLL) -> None:
    lib.tss_png_unfilter.restype = ctypes.c_long
    lib.tss_png_unfilter.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                     ctypes.c_long, ctypes.c_long,
                                     ctypes.c_int]


def _unfilter_lib() -> ctypes.CDLL:
    """The unfilter library, built with g++ at the first call; a build or
    load failure raises."""
    return gxx.load(UNFILTER_SOURCE, _bind)


def unfilter(filtered: np.ndarray, rows: int, row_bytes: int,
             bpp: int) -> np.ndarray:
    """``rows`` filtered scanlines (each its filter type byte, then
    ``row_bytes`` bytes) -> (rows, row_bytes) uint8, by the C++ loop with
    the GIL released. ``bpp``: bytes a complete pixel, at least 1. Raises
    ``PngError`` at a filter type outside 0..4."""
    src = np.ascontiguousarray(filtered[: rows * (row_bytes + 1)], np.uint8)
    if src.size != rows * (row_bytes + 1) or bpp < 1:
        raise ValueError(f"{src.size} filtered bytes for {rows} rows of "
                         f"{row_bytes} bytes at {bpp} bytes a pixel")
    out = np.empty((rows, row_bytes), np.uint8)
    done = _unfilter_lib().tss_png_unfilter(
        src.ctypes.data, out.ctypes.data, rows, row_bytes, bpp)
    if done != rows:
        r = -done - 1
        raise PngError(f"row {r} has filter type {src[r * (row_bytes + 1)]}")
    return out


def unfilter_reference(filtered: np.ndarray, rows: int, row_bytes: int,
                       bpp: int) -> np.ndarray:
    """``unfilter`` in numpy and Python loops (the specification's
    definitions, byte by byte): the C++ loop's twin for the tests."""
    src = np.asarray(filtered, np.uint8)[: rows * (row_bytes + 1)].reshape(
        rows, row_bytes + 1).astype(np.int64)
    out = np.zeros((rows, row_bytes), np.int64)
    prior = np.zeros(row_bytes, np.int64)
    for r in range(rows):
        kind, line = src[r, 0], src[r, 1:]
        cur = out[r]
        if kind in (0, 2):
            cur[:] = (line + (prior if kind == 2 else 0)) % 256
        elif kind in (1, 3, 4):
            for i in range(row_bytes):
                a = cur[i - bpp] if i >= bpp else 0
                b = prior[i]
                c = prior[i - bpp] if i >= bpp else 0
                if kind == 1:
                    pred = a
                elif kind == 3:
                    pred = (a + b) // 2
                else:
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else (
                        b if pb <= pc else c)
                cur[i] = (line[i] + pred) % 256
        else:
            raise PngError(f"row {r} has filter type {kind}")
        prior = cur
    return out.astype(np.uint8)


def _samples(rows: np.ndarray, width: int, depth: int, colour: int
             ) -> np.ndarray:
    """Unfiltered rows (n, row_bytes) -> pixels in PIL's mode for (depth,
    colour): sub-byte grey scaled to 0..255 ('L'), 1-bit grey as bool
    ('1'), sub-byte palette as indices, 16-bit grey as uint16 ('I;16'),
    16-bit colour as the high byte of each sample ('RGB'/'RGBA'; 16-bit
    grey+alpha opens as 'RGBA')."""
    n, channels = len(rows), _CHANNELS[colour]
    if depth < 8:
        bits = np.unpackbits(rows, axis=1)
        per = bits.shape[1] // depth
        weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
        values = (bits[:, : per * depth].reshape(n, per, depth)
                  * weights).sum(-1, dtype=np.uint8)[:, :width]
        if colour == 3:
            return values
        if depth == 1:
            return values.astype(bool)
        return values * np.uint8(255 // ((1 << depth) - 1))
    if depth == 8:
        pixels = rows[:, : width * channels].reshape(n, width, channels)
        return pixels[..., 0] if channels == 1 else pixels
    if colour == 0:
        return rows[:, : 2 * width].view(">u2").astype(np.uint16)
    high = rows[:, : 2 * width * channels:2].reshape(n, width, channels)
    if colour == 4:         # PIL's 'LA;16B' rawmode fills an RGBA image
        high = high[..., [0, 0, 0, 1]]
    return np.ascontiguousarray(high)


def _source_bytes(src) -> tuple:
    """(bytes, name) of a path, a file object or bytes."""
    if isinstance(src, (bytes, bytearray, memoryview)):
        return bytes(src), f"<{len(src)} bytes>"
    if isinstance(src, (str, os.PathLike)):
        with open(src, "rb") as f:
            return f.read(), os.fspath(src)
    data = src.read()
    return data, getattr(src, "name", f"<{len(data)} bytes>")


def is_png(data: bytes) -> bool:
    return data[:8] == _SIGNATURE


def read_png(src, name: Optional[str] = None) -> PngImage:
    """Decode a PNG (a path, a file object or bytes) as PIL does; ``name``
    names it in errors (default: its path, or its size in bytes).

    Colour types 0, 2, 3, 4 and 6 at every bit depth the specification
    allows, Adam7 included; ancillary and unknown chunks are skipped. A
    file cut short decodes, as PIL with ``LOAD_TRUNCATED_IMAGES``, to the
    rows its data holds and zeros below. An image of more than
    ``2 * MAX_IMAGE_PIXELS`` pixels is refused, as PIL refuses it, and the
    image data is inflated only as far as its rows need (a small body
    cannot claim a huge image or inflate to gigabytes). Anything else
    raises ``PngError`` naming the file and its IHDR fields."""
    data, default_name = _source_bytes(src)
    name = name or default_name
    if not is_png(data):
        raise PngError(f"{name}: not a PNG file")
    header, palette, idat, pos = None, None, [], 8
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        if kind in (b"IHDR", b"PLTE") and (
                len(data) < pos + 12 + length or zlib.crc32(kind + body)
                != struct.unpack(">I", data[pos + 8 + length:
                                            pos + 12 + length])[0]):
            raise PngError(f"{name}: {kind.decode()} chunk cut short or "
                           f"its CRC wrong")
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body[:13])
        elif kind == b"PLTE":
            palette = np.frombuffer(body[: len(body) // 3 * 3],
                                    np.uint8).reshape(-1, 3).copy()
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        pos += 12 + length
    if header is None:
        raise PngError(f"{name}: no IHDR chunk")
    width, height, depth, colour, compression, filt, interlace = header
    ihdr = (f"IHDR {width}x{height}, bit depth {depth}, colour type "
            f"{colour}, compression {compression}, filter {filt}, "
            f"interlace {interlace}")

    def error(why):
        return PngError(f"{name}: cannot decode this PNG ({ihdr}): {why}")

    if depth not in _DEPTHS.get(colour, ()):
        raise error("no such colour type and bit depth")
    if compression or filt or interlace not in (0, 1) or not (
            width and height):
        raise error("unknown compression, filter or interlace method, or "
                    "an empty image")
    if colour == 3 and palette is None:
        raise error("a palette image without a PLTE chunk")
    if width * height > 2 * MAX_IMAGE_PIXELS:
        raise error(f"{width * height} pixels, more than twice "
                    f"MAX_IMAGE_PIXELS ({MAX_IMAGE_PIXELS}): a possible "
                    f"decompression bomb")
    if not idat:
        raise error("no IDAT chunk")
    channels = _CHANNELS[colour]
    bpp = max(1, channels * depth // 8)
    passes = _ADAM7 if interlace else ((0, 0, 1, 1),)
    sizes = [((width - x0 + dx - 1) // dx if width > x0 else 0,
              (height - y0 + dy - 1) // dy if height > y0 else 0)
             for x0, y0, dx, dy in passes]
    needed = sum(ph * ((pw * channels * depth + 7) // 8 + 1)
                 for pw, ph in sizes if pw and ph)
    try:
        stream = np.frombuffer(zlib.decompressobj().decompress(
            b"".join(idat), needed), np.uint8)
    except zlib.error as e:
        raise error(f"zlib: {e}") from None
    shape = (height, width) if channels == 1 else (height, width, channels)
    dtype = np.uint16 if depth == 16 and colour == 0 else (
        bool if depth == 1 and colour == 0 else np.uint8)
    if depth == 16 and colour == 4:
        shape = (height, width, 4)
    pixels = np.zeros(shape, dtype)
    at = 0
    for (x0, y0, dx, dy), (pw, ph) in zip(passes, sizes):
        if not (pw and ph):
            continue
        row_bytes = (pw * channels * depth + 7) // 8
        rows = min(ph, (len(stream) - at) // (row_bytes + 1))
        if rows <= 0:
            break
        try:
            raw = unfilter(stream[at:], rows, row_bytes, bpp)
        except PngError as e:
            raise error(e) from None
        pixels[y0:y0 + rows * dy:dy, x0::dx] = _samples(raw, pw, depth,
                                                         colour)
        at += ph * (row_bytes + 1)
        if rows < ph:
            break
    return PngImage(pixels, palette if colour == 3 else None)
