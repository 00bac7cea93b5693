"""Freiburg thermal IR decoding for the 16-bit request path (counterpart of
``load_ir_image`` in the JAX ``data/freiburg.py``; the datasets come later).

IR radiometric normalisation: resize the 16-bit frame to RAW_SIZE BICUBIC,
crop columns COL_CROP, clamp to [IR_MIN, IR_MAX] and scale to [0, 1].
"""

from __future__ import annotations

import numpy as np

IR_MIN, IR_MAX = 21800.0, 25000.0
RAW_SIZE = (960, 320)          # PIL (w, h)
COL_CROP = (150, 850)


def load_ir_image(path_or_file):
    """16-bit IR PNG (path or file object) -> float [0, 1] PIL 'F' image,
    windowed and column-cropped."""
    from PIL import Image

    image = np.array(Image.open(path_or_file).resize(RAW_SIZE, Image.BICUBIC),
                     dtype=np.float32)
    image = image[:, COL_CROP[0]:COL_CROP[1]]
    image = np.clip(image, IR_MIN, IR_MAX)
    return Image.fromarray((image - IR_MIN) / (IR_MAX - IR_MIN))
