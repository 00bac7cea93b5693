"""Cityscapes source dataset, original and translated (counterpart of the
JAX ``data/cityscapes.py``).

The 19-class label ids merge into the 13-class Freiburg taxonomy through a
256-entry lookup table (reference data/source_dataset.py:45-49); unmapped
ids become the ignore label 12. Frames and labels are read by
``data/image.py`` (no PIL).
"""

from __future__ import annotations

import os
from typing import Callable, Optional

import numpy as np

from . import image as im
from .list_files import cityscapes_list, parse_list_file

# the 19 Cityscapes evaluation classes, in train-id order
CLASSES = ['road', 'sidewalk', 'building', 'wall', 'fence', 'pole',
           'traffic light', 'traffic sign', 'vegetation', 'terrain', 'sky',
           'person', 'rider', 'car', 'truck', 'bus', 'train', 'motorcycle',
           'bicycle']

# 19-class label ids -> the merged 13-class Freiburg train ids
ID_TO_TRAIN_ID = {
    7: 0, 8: 1, 11: 2, 12: 3, 13: 4, 17: 5,
    19: 5, 20: 5, 21: 6, 22: 7, 23: 8, 24: 9, 25: 9,
    26: 10, 27: 10, 28: 10, 31: 10, 32: 11, 33: 11,
}
IGNORE_LABEL = 12


def _build_lut(mapping: dict, ignore: int) -> np.ndarray:
    lut = np.full(256, ignore, dtype=np.int64)
    for k, v in mapping.items():
        lut[k] = v
    lut.setflags(write=False)
    return lut


_LUT = _build_lut(ID_TO_TRAIN_ID, IGNORE_LABEL)


def remap_label(label) -> np.ndarray:
    """Label ids -> train ids (int64); ids without a train id -> 12."""
    return _LUT[np.asarray(label, dtype=np.int64).clip(0, 255)]


class Cityscapes:
    """Original (or translated) Cityscapes frames with merged 13-class
    labels. The label path swaps ``data_folder`` for ``label_folder``
    (reference source_dataset.py:73-76)."""

    def __init__(self, root: str, *, split: str = "train",
                 data_folder: str = "leftImg8bit",
                 label_folder: str = "gtFine_labelIds",
                 transforms: Optional[Callable] = None,
                 train_mode: bool = True):
        if split not in ("train", "val"):
            raise ValueError(f"invalid split {split!r}")
        list_path = os.path.join(root, "image_list",
                                 f"{data_folder}_{split}.txt")
        if not os.path.exists(list_path):
            cityscapes_list(root, data_folder, split, list_root=root)
        self.data_list = parse_list_file(list_path)
        self.label_list = [p.replace(data_folder, label_folder)
                           for p in self.data_list]
        self.data_folder = data_folder
        self.transforms = transforms
        self.train_mode = train_mode

    def __len__(self) -> int:
        return len(self.data_list)

    def get(self, index: int, rng: np.random.Generator) -> dict:
        image_name = self.data_list[index]
        image = im.open_image(image_name, "RGB" if self.data_folder
                              == "leftImg8bit" else None)
        if not self.train_mode:
            img, _ = self.transforms(rng, image, None)
            return {"image": img, "img_path": image_name.replace(
                "leftImg8bit", "translation")}
        label = im.open_image(self.label_list[index])
        img, lab = self.transforms(rng, image, label)
        return {"image": img, "label": remap_label(lab)}


def CityscapesTranslation(root: str, data_folder: str = "translation",
                          **kwargs) -> Cityscapes:
    """Translated Cityscapes: the frames under ``translation``."""
    return Cityscapes(root, data_folder=data_folder, **kwargs)


# the colours of the merged 13 train ids (the head of the reference's
# table, source_dataset.py:51-55)
TRAIN_ID_TO_COLOR = np.array([
    (128, 64, 128), (244, 35, 232), (70, 70, 70), (102, 102, 156),
    (190, 153, 153), (153, 153, 153), (107, 142, 35), (152, 251, 152),
    (70, 130, 180), (220, 20, 60), (0, 0, 142), (119, 11, 32), (0, 0, 0),
], dtype=np.uint8)
TRAIN_ID_TO_COLOR.setflags(write=False)


def decode_target(target) -> np.ndarray:
    """A train-id map as RGB (..., 3) uint8 for viewing (reference
    base_dataset.py:117-138); ids outside [0, 12] take the nearest end's
    colour."""
    t = np.clip(np.asarray(target, np.int64), 0, len(TRAIN_ID_TO_COLOR) - 1)
    return TRAIN_ID_TO_COLOR[t]
