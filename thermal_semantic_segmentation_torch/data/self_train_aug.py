"""Param-recording augmentations for self-training (counterpart of the JAX
``data/self_train_aug.py``; reference utils/self_train_augmentation.py).

Jointly transforms (image, gt mask, hard pseudo mask, soft pseudo maps) and
records the random draws, so that ``train/self_train.full2weak_coords`` can
map the teacher's features of the *full* image into the student's view:

  resized_hw: (2,) int32  -- RandomSized output (h, w)
  crop:       (4,) int32  -- (y1, y2, x1, x2) of RandomCrop
  flip:       () bool     -- RandomHorizontallyFlip applied

The soft maps (C, h, w) resample bilinearly with aligned corners, in float32
from the JAX package's float64 source coordinates (``ops/resize
.resize_bilinear_taps``), on the host. The image and the masks are numpy
arrays in PIL's modes, resampled by ``data/image.py`` as PIL does.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..ops.resize import resize_bilinear_taps
from . import image as im


def interp_soft(lpsoft: np.ndarray, h: int, w: int) -> np.ndarray:
    """(C, H, W) float -> (C, h, w) float32, bilinear align_corners, in the
    JAX package's float32 arithmetic (``ops/resize.resize_bilinear_taps``).
    """
    x = torch.from_numpy(np.asarray(lpsoft, dtype=np.float32))
    y = resize_bilinear_taps(x[None].permute(0, 2, 3, 1), h, w)
    return y[0].permute(2, 0, 1).numpy()


class SelfTrainAugment:
    """RandomSized -> RandomCrop -> RandomHorizontallyFlip, recording the
    draws.

    resize: base width of RandomSized (default 1200); rcrop: (tw, th) crop
    size in PIL order (default (512, 256)); hflip: flip probability. The
    draws come from ``rng`` in the JAX package's order.
    """

    def __init__(self, resize: int = 1200, rcrop: Tuple[int, int] = (512, 256),
                 hflip: float = 0.5):
        self.resize = resize
        self.rcrop = tuple(rcrop)
        self.hflip = hflip

    def __call__(self, rng: np.random.Generator, img, mask: np.ndarray,
                 mask_hard: Optional[np.ndarray] = None,
                 lpsoft: Optional[np.ndarray] = None):
        """img: an 'F' (H, W) float32 or 8-bit image (``data/image.py``; a
        PIL image is taken as its array); mask, mask_hard: (H, W) uint8;
        lpsoft: (C, h, w) soft maps at any size. Returns (image (th, tw[,
        3]) float32, mask int64, hard mask int64 or None, soft maps (C, th,
        tw) float32 or None, params)."""
        img = np.asarray(img)
        mask_img = np.uint8(mask)
        hard_img = np.uint8(mask_hard) if mask_hard is not None else None
        width, height = im.size(img)
        if lpsoft is not None:
            lpsoft = interp_soft(lpsoft, height, width)
        params = {}

        # RandomSized (self_train_augmentation.py:130-157)
        prop = width / height
        w = int(rng.uniform(0.5, 1.5) * self.resize)
        h = int(w / prop)
        params["resized_hw"] = np.array([h, w], dtype=np.int32)
        img = im.resize(img, (w, h), im.BILINEAR)
        mask_img = im.resize(mask_img, (w, h), im.NEAREST)
        if hard_img is not None:
            hard_img = im.resize(hard_img, (w, h), im.NEAREST)
        if lpsoft is not None:
            lpsoft = interp_soft(lpsoft, h, w)

        # RandomCrop (self_train_augmentation.py:42-102)
        tw, th = self.rcrop
        if w < tw or h < th:
            # undersized: resized straight to the crop size (the reference's
            # fallback)
            img = im.resize(img, (tw, th), im.BILINEAR)
            mask_img = im.resize(mask_img, (tw, th), im.NEAREST)
            if hard_img is not None:
                hard_img = im.resize(hard_img, (tw, th), im.NEAREST)
            if lpsoft is not None:
                lpsoft = interp_soft(lpsoft, th, tw)
            params["crop"] = np.array([0, th, 0, tw], dtype=np.int32)
            params["resized_hw"] = np.array([th, tw], dtype=np.int32)
        else:
            x1 = int(rng.integers(0, w - tw + 1))
            y1 = int(rng.integers(0, h - th + 1))
            params["crop"] = np.array([y1, y1 + th, x1, x1 + tw],
                                      dtype=np.int32)
            box = (x1, y1, x1 + tw, y1 + th)
            img = im.crop(img, box)
            mask_img = im.crop(mask_img, box)
            if hard_img is not None:
                hard_img = im.crop(hard_img, box)
            if lpsoft is not None:
                lpsoft = lpsoft[:, y1:y1 + th, x1:x1 + tw]

        # RandomHorizontallyFlip (self_train_augmentation.py:160-188)
        flip = rng.random() < self.hflip
        params["flip"] = np.bool_(flip)
        if flip:
            img = im.flip_left_right(img)
            mask_img = im.flip_left_right(mask_img)
            if hard_img is not None:
                hard_img = im.flip_left_right(hard_img)
            if lpsoft is not None:
                lpsoft = lpsoft[:, :, ::-1]

        out_hard = (np.asarray(hard_img, dtype=np.int64)
                    if hard_img is not None else None)
        if lpsoft is not None:
            lpsoft = np.ascontiguousarray(lpsoft, dtype=np.float32)
        return (np.asarray(img, dtype=np.float32),
                np.asarray(mask_img, dtype=np.int64), out_hard, lpsoft, params)
