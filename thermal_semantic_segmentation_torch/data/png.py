"""8-bit PNG writers on ``zlib`` and ``struct`` alone.

The pseudo-label files are an 8-bit grayscale PNG of class ids and an 8-bit
palette ('P') PNG of the same ids under the Freiburg palette; the validation
dumps are palette PNGs of the prediction and the ground truth and a gray or
RGB PNG of the input image; the translation server answers with a gray or
RGB PNG. The JAX package writes them all with PIL. The
card's machine has no PIL, so the port writes them here: one IHDR, a PLTE
for the palette image, one IDAT of filter-0 rows, IEND. PIL decodes them to
the same pixels (and palette) as its own files.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_GRAY, _RGB, _PALETTE = 0, 2, 3   # PNG colour types


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data)))


def _png_bytes(pixels: np.ndarray, colour_type: int,
               palette: bytes = b"") -> bytes:
    pixels = np.asarray(pixels)
    want = 3 if colour_type == _RGB else 2
    if pixels.ndim != want or 0 in pixels.shape or (
            want == 3 and pixels.shape[2] != 3):
        raise ValueError(f"expected a non-empty "
                         f"{'(H, W, 3)' if want == 3 else '2-D'} image, got "
                         f"shape {pixels.shape}")
    if pixels.dtype != np.uint8:
        if pixels.size and (pixels.min() < 0 or pixels.max() > 255):
            raise ValueError("pixel values outside 0..255")
        pixels = pixels.astype(np.uint8)
    h, w = pixels.shape[:2]
    rows = np.zeros((h, pixels[0].size + 1), np.uint8)  # filter 0 (none)
    rows[:, 1:] = pixels.reshape(h, -1)
    header = struct.pack(">IIBBBBB", w, h, 8, colour_type, 0, 0, 0)
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
