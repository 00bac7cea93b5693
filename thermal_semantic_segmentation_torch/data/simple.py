"""Unlabelled auxiliary datasets (counterpart of the JAX ``data/simple.py``):
the KITTI raw frames and the FLIR ADAS thermal train frames. The
translation-distance pairs come with their slice. PIL is imported where a
frame is decoded."""

from __future__ import annotations

import os
from typing import Callable

import numpy as np

from .freiburg import _pil_image
from .list_files import flir_list, kitti_list, parse_list_file


class Kitti:
    """Unlabelled KITTI raw frames (reference data/kitti_dataset.py:26-67),
    listed by ``kitti_list`` on first use; RGB, or grayscale with
    ``grayscale``. In translation mode a sample also carries its
    destination, ``translation_name`` prefixed to its path."""

    def __init__(self, root: str, transforms: Callable, *,
                 grayscale: bool = False, translation_mode: bool = False,
                 translation_name: str = "translation"):
        list_file = os.path.join(root, "image_list", "kitti_data.txt")
        if not os.path.exists(list_file):
            kitti_list(root)
        self.data_list = parse_list_file(list_file)
        self.transforms = transforms
        self.grayscale = grayscale
        self.translation_mode = translation_mode
        self.translation_name = translation_name

    def __len__(self) -> int:
        return len(self.data_list)

    def get(self, index: int, rng: np.random.Generator) -> dict:
        image_name = self.data_list[index]
        image = _pil_image().open(image_name).convert("RGB")
        if self.grayscale:
            from PIL import ImageOps
            image = ImageOps.grayscale(image)
        img, _ = self.transforms(rng, image, None)
        out = {"image": img}
        if self.translation_mode:
            out["img_path"] = self.translation_name + image_name
        return out


class FlirTrain:
    """Unlabelled FLIR ADAS thermal frames (reference
    data/target_dataset.py:7-39), listed by ``flir_list`` on first use."""

    def __init__(self, root: str, transforms: Callable):
        list_file = os.path.join(root, "image_list", "train.txt")
        if not os.path.exists(list_file):
            flir_list(root, "train")
        self.data_list = parse_list_file(list_file)
        self.transforms = transforms

    def __len__(self) -> int:
        return len(self.data_list)

    def get(self, index: int, rng: np.random.Generator) -> dict:
        image = _pil_image().open(self.data_list[index])
        img, _ = self.transforms(rng, image, None)
        return {"image": img}
