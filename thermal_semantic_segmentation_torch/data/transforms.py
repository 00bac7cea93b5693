"""Paired (image, label) transforms on the host (counterpart of the JAX
``data/transforms.py``; the eval chain so far, the random transforms come
with training).

A transform is a callable ``t(rng, image, label) -> (image, label)`` where
``rng`` is a ``numpy.random.Generator``; ``label`` may be ``None``. Images
resample BICUBIC and labels NEAREST, as in the reference. PIL is imported
where it is used, so the package imports on a host without it.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np


class Compose:
    def __init__(self, transforms: Sequence):
        self.transforms = list(transforms)

    def __call__(self, rng: np.random.Generator, image, label=None):
        for t in self.transforms:
            image, label = t(rng, image, label)
        return image, label


class Resize:
    """Resize to ``image_size`` (PIL (width, height) order, like the
    reference)."""

    def __init__(self, image_size: Tuple[int, int],
                 label_size: Optional[Tuple[int, int]] = None):
        self.image_size = tuple(image_size)
        self.label_size = (tuple(label_size) if label_size is not None
                           else self.image_size)

    def __call__(self, rng, image, label=None):
        from PIL import Image

        image = image.resize(self.image_size, Image.BICUBIC)
        if label is not None:
            label = label.resize(self.label_size, Image.NEAREST)
        return image, label


class ToArray:
    """PIL -> float32 HWC numpy. uint8 scales to [0, 1]; float passes
    through. Grayscale and 'F' images come out (H, W, 1); labels, if given,
    come out int64 (H, W)."""

    def __call__(self, rng, image, label=None):
        arr = np.asarray(image)
        if arr.dtype == np.uint8:
            arr = arr.astype(np.float32) / 255.0
        else:
            arr = arr.astype(np.float32)
        if arr.ndim == 2:
            arr = arr[..., None]
        if label is not None and not isinstance(label, np.ndarray):
            label = np.asarray(label, dtype=np.int64)
        return arr, label
