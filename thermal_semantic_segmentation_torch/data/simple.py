"""Unlabelled auxiliary datasets (counterpart of the JAX ``data/simple.py``):
the FLIR ADAS thermal train frames. KITTI and the translation-distance pairs
come with their slices. PIL is imported where a frame is decoded."""

from __future__ import annotations

import os
from typing import Callable

import numpy as np

from .freiburg import _pil_image
from .list_files import flir_list, parse_list_file


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
