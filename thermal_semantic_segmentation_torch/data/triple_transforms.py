"""Joint transforms for (image, label, contour) triples (counterpart of the
JAX ``data/triple_transforms.py``; reference utils/triple_transforms.py).

The geometric pipeline of ``data/transforms.py`` applied to three aligned
images: the contour resamples as the image does (BICUBIC), the label
NEAREST. Each paired transform is lifted: the (image, label) pair and the
(contour, None) pair each get a child generator seeded with the same draw
from ``rng``, so all three stay aligned. ``GeneralNormalize`` reproduces
the reference's use of a 3-channel mean's first element on a 1-channel
array (triple_transforms.py:65-89).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from . import transforms as T


class TripleCompose:
    def __init__(self, transforms: Sequence):
        self.transforms = list(transforms)

    def __call__(self, rng: np.random.Generator, image, label=None, contour=None):
        for t in self.transforms:
            image, label, contour = t(rng, image, label, contour)
        return image, label, contour


class _Lift:
    """Lift a paired transform to triples with a shared random draw."""

    def __init__(self, paired):
        self.paired = paired

    def __call__(self, rng, image, label=None, contour=None):
        seed = int(rng.integers(0, 2 ** 63 - 1))
        image, label = self.paired(np.random.default_rng(seed), image, label)
        if contour is not None:
            # contour rides the image path (BICUBIC) with identical randomness
            contour, _ = self.paired(np.random.default_rng(seed), contour, None)
        return image, label, contour


def Resize(image_size, label_size=None):
    return _Lift(T.Resize(image_size, label_size))


def RandomCrop(size):
    return _Lift(T.RandomCrop(size))


def RandomHorizontalFlip(p: float = 0.5):
    return _Lift(T.RandomHorizontalFlip(p))


def RandomResizedCrop(size, scale=(0.5, 1.0), ratio=(3 / 4, 4 / 3)):
    return _Lift(T.RandomResizedCrop(size, scale, ratio))


def ToArray():
    return _Lift(T.ToArray())


class GeneralNormalize:
    """Normalize image and contour; mean/std tuples degrade to their first
    element when the tensor is single-channel (triple_transforms.py:65-89)."""

    def __init__(self, mean, std):
        self.mean = np.asarray(mean, dtype=np.float32)
        self.std = np.asarray(std, dtype=np.float32)

    def _norm(self, arr):
        c = arr.shape[-1]
        mean = self.mean if self.mean.size == c else self.mean[:1]
        std = self.std if self.std.size == c else self.std[:1]
        return (arr - mean) / std

    def __call__(self, rng, image, label=None, contour=None):
        image = self._norm(image)
        if contour is not None:
            contour = self._norm(contour)
        return image, label, contour


Normalize = GeneralNormalize
