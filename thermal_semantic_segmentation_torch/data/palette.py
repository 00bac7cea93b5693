"""Freiburg 13-class palette and prediction colouring (counterpart of the JAX
``data/palette.py``)."""

from __future__ import annotations

import numpy as np

# id | class                       id | class
# 0  road,parking (128,64,128)     1  ground,sidewalk (244,35,232)
# 2  building (70,70,70)           3  curb (102,102,156)
# 4  fence (190,153,153)           5  pole,traffic light (250,170,30)
# 6  vegetation (107,142,35)       7  terrain (152,251,152)
# 8  sky (70,130,180)              9  person,rider (220,20,60)
# 10 vehicles (0,0,142)            11 motor-,bicycle (119,11,32)
# *  unlabeled (0,0,0)
FREIBURG_COLORS = [
    (128, 64, 128), (244, 35, 232), (70, 70, 70), (102, 102, 156),
    (190, 153, 153), (250, 170, 30), (107, 142, 35), (152, 251, 152),
    (70, 130, 180), (220, 20, 60), (0, 0, 142), (119, 11, 32),
]


def freiburg_palette() -> list:
    palette = [c for color in FREIBURG_COLORS for c in color]
    palette.extend([0] * (256 * 3 - len(palette)))
    return palette


def colorize_prediction(prediction: np.ndarray, palette=None) -> bytes:
    """Class-id map -> the bytes of an 8-bit palette PNG (the JAX package's
    palettised PIL image, written without PIL by ``data/png.py``); ids are
    taken modulo 256, as ``astype(uint8)`` takes them."""
    from .png import palette_png_bytes

    return palette_png_bytes(np.asarray(prediction).astype(np.uint8),
                             palette or freiburg_palette())
