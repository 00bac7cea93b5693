"""8-bit PNG writers on ``zlib`` and ``struct`` alone.

The pseudo-label files are an 8-bit grayscale PNG of class ids and an 8-bit
palette ('P') PNG of the same ids under the Freiburg palette; the JAX
package writes them with PIL (``Image.fromarray(ids).save`` and
``colorize_prediction``). The card's machine has no PIL, so the port writes
them here: one IHDR, a PLTE for the palette image, one IDAT of filter-0 rows,
IEND. PIL decodes both to the same pixels (and palette) as its own files.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_GRAY, _PALETTE = 0, 3          # PNG colour types


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data)))


def _png_bytes(pixels: np.ndarray, colour_type: int,
               palette: bytes = b"") -> bytes:
    pixels = np.asarray(pixels)
    if pixels.ndim != 2 or 0 in pixels.shape:
        raise ValueError(f"expected a non-empty 2-D image, got shape "
                         f"{pixels.shape}")
    if pixels.dtype != np.uint8:
        if pixels.size and (pixels.min() < 0 or pixels.max() > 255):
            raise ValueError("pixel values outside 0..255")
        pixels = pixels.astype(np.uint8)
    h, w = pixels.shape
    rows = np.zeros((h, w + 1), np.uint8)   # filter byte 0 (none) per row
    rows[:, 1:] = pixels
    header = struct.pack(">IIBBBBB", w, h, 8, colour_type, 0, 0, 0)
    parts = [_SIGNATURE, _chunk(b"IHDR", header)]
    if palette:
        parts.append(_chunk(b"PLTE", palette))
    parts += [_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)),
              _chunk(b"IEND", b"")]
    return b"".join(parts)


def write_gray_png(path: str, pixels: np.ndarray) -> None:
    """(H, W) values in 0..255 -> an 8-bit grayscale PNG at ``path``."""
    with open(path, "wb") as f:
        f.write(_png_bytes(pixels, _GRAY))


def write_palette_png(path: str, indices: np.ndarray, palette) -> None:
    """(H, W) indices in 0..255 -> an 8-bit palette PNG at ``path``;
    ``palette`` is a flat [r, g, b, r, g, b, ...] list of up to 256
    colours (PIL's ``putpalette`` layout)."""
    pal = bytes(np.asarray(palette, np.uint8))
    if not pal or len(pal) % 3 or len(pal) > 768:
        raise ValueError(f"a palette holds 1-256 RGB triples, got "
                         f"{len(pal)} values")
    with open(path, "wb") as f:
        f.write(_png_bytes(indices, _PALETTE, pal))
