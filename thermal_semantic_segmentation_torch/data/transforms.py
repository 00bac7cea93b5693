"""Paired (image, label) transforms on the host (counterpart of the JAX
``data/transforms.py``).

A transform is a callable ``t(rng, image, label) -> (image, label)`` where
``rng`` is a ``numpy.random.Generator``; ``label`` may be ``None``. Images
and labels are numpy arrays in PIL's modes (``data/image.py``; a PIL image
is taken as its array), and each operation gives PIL's pixels. Images
resample BICUBIC and labels NEAREST, as in the reference. The random
transforms draw from ``rng`` in the JAX package's order, so the same (seed,
epoch, index) gives the same arrays.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np

from . import image as im


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
        image = im.resize(image, self.image_size, im.BICUBIC)
        if label is not None:
            label = im.resize(label, self.label_size, im.NEAREST)
        return image, label


class RandomCrop:
    def __init__(self, size: Tuple[int, int]):
        self.size = tuple(size)  # (width, height), PIL order

    def __call__(self, rng, image, label=None):
        tw, th = self.size
        width, height = im.size(np.asarray(image))
        # reference quirk: offsets drawn in [0, extent-1] inclusive
        left = int(rng.integers(0, max(width - tw - 1, 0) + 1))
        upper = int(rng.integers(0, max(height - th - 1, 0) + 1))
        box = (left, upper, left + tw, upper + th)
        image = im.crop(image, box)
        if label is not None:
            label = im.crop(label, box)
        return image, label


class RandomHorizontalFlip:
    def __init__(self, p: float = 0.5):
        self.p = p

    def __call__(self, rng, image, label=None):
        if rng.random() < self.p:
            image = im.flip_left_right(image)
            if label is not None:
                label = im.flip_left_right(label)
        return image, label


class RandomResizedCrop:
    """The reference's sampler: 10 tries of an area in ``scale`` and a
    log-uniform aspect ratio in ``ratio``, then a central-crop fallback;
    the crop resizes to ``size`` (h, w), as the reference's ctor orders
    it."""

    def __init__(self, size: Tuple[int, int], scale=(0.5, 1.0),
                 ratio=(3 / 4, 4 / 3)):
        self.size = tuple(size)  # (h, w)
        self.scale = scale
        self.ratio = ratio

    def get_params(self, rng, width: int, height: int):
        area = height * width
        log_ratio = (math.log(self.ratio[0]), math.log(self.ratio[1]))
        for _ in range(10):
            target_area = area * rng.uniform(self.scale[0], self.scale[1])
            aspect_ratio = math.exp(rng.uniform(*log_ratio))
            w = int(round(math.sqrt(target_area * aspect_ratio)))
            h = int(round(math.sqrt(target_area / aspect_ratio)))
            if 0 < w <= width and 0 < h <= height:
                i = int(rng.integers(0, height - h + 1))
                j = int(rng.integers(0, width - w + 1))
                return i, j, h, w
        # central-crop fallback
        in_ratio = width / height
        if in_ratio < min(self.ratio):
            w = width
            h = int(round(w / min(self.ratio)))
        elif in_ratio > max(self.ratio):
            h = height
            w = int(round(h * max(self.ratio)))
        else:
            w, h = width, height
        return (height - h) // 2, (width - w) // 2, h, w

    def __call__(self, rng, image, label=None):
        top, left, h, w = self.get_params(rng, *im.size(np.asarray(image)))
        box = (left, top, left + w, top + h)
        out_wh = (self.size[1], self.size[0])
        image = im.resize(im.crop(image, box), out_wh, im.BICUBIC)
        if label is not None:
            label = im.resize(im.crop(label, box), out_wh, im.NEAREST)
        return image, label


class RandomChoice:
    def __init__(self, transforms: Sequence):
        self.transforms = list(transforms)

    def __call__(self, rng, image, label=None):
        t = self.transforms[int(rng.integers(0, len(self.transforms)))]
        return t(rng, image, label)


class RandomApply:
    """Apply the whole sub-pipeline with probability p; when skipped, the
    (image, label) pair passes through (the reference returns the image
    alone there, a fault the JAX package fixed)."""

    def __init__(self, transforms: Sequence, p: float = 0.5):
        self.transforms = list(transforms)
        self.p = p

    def __call__(self, rng, image, label=None):
        if rng.random() < self.p:
            for t in self.transforms:
                image, label = t(rng, image, label)
        return image, label


class ColorJitter:
    """Brightness/contrast/saturation jitter on the image only."""

    def __init__(self, brightness=0.0, contrast=0.0, saturation=0.0):
        self.brightness = brightness
        self.contrast = contrast
        self.saturation = saturation

    @staticmethod
    def _factor(rng, amount):
        return (float(rng.uniform(max(0.0, 1 - amount), 1 + amount))
                if amount else 1.0)

    def __call__(self, rng, image, label=None):
        for enhance, amount in ((im.enhance_brightness, self.brightness),
                                (im.enhance_contrast, self.contrast),
                                (im.enhance_color, self.saturation)):
            f = self._factor(rng, amount)
            if f != 1.0:
                image = enhance(image, f)
        return image, label


class MultipleApply:
    """Apply several pipelines to one input, each from its own generator
    seeded from ``rng``; returns the list of images and the label
    unchanged (multi-view augmentation)."""

    def __init__(self, transforms: Sequence):
        self.transforms = list(transforms)

    def __call__(self, rng, image, label=None):
        views = []
        for t in self.transforms:
            seed = int(rng.integers(0, 2 ** 63 - 1))
            views.append(t(np.random.default_rng(seed), image, label))
        return [v[0] for v in views], label


class ToArray:
    """An image -> float32 HWC numpy. uint8 scales to [0, 1]; float passes
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
        if label is not None:
            label = np.asarray(label, dtype=np.int64)
        return arr, label


class Normalize:
    """(x - mean) / std on the (already float HWC) image."""

    def __init__(self, mean, std):
        self.mean = np.asarray(mean, dtype=np.float32)
        self.std = np.asarray(std, dtype=np.float32)

    def __call__(self, rng, image, label=None):
        return (image - self.mean) / self.std, label


class BGRMeanSubtract:
    """Legacy-DeepLab input prep on a float HWC image in [0, 1] (after
    ``ToArray``): RGB -> BGR, scale to [0, 255], subtract the mean."""

    def __init__(self, mean=(104.00698793, 116.66876762, 122.67891434)):
        self.mean = np.asarray(mean, dtype=np.float32)

    def __call__(self, rng, image, label=None):
        image = image[..., ::-1] * 255.0 - self.mean
        return image.astype(np.float32), label
