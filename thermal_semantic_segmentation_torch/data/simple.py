"""Auxiliary datasets (counterpart of the JAX ``data/simple.py``): the
unlabelled KITTI raw frames and FLIR ADAS thermal train frames, and the
(original, translated) pairs of the translation-distance eval. Frames are
read by ``data/image.py`` (PNG without PIL; JPEG through PIL)."""

from __future__ import annotations

import os
from typing import Callable

import numpy as np

from . import image as im
from .freiburg import COL_CROP, RAW_SIZE, load_ir_image, load_label
from .list_files import (flir_list, freiburg_lists, kitti_list,
                         parse_list_file)


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
        image = im.open_image(image_name, "RGB")
        if self.grayscale:
            image = im.convert(image, "L")
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
        image = im.open_image(self.data_list[index])
        img, _ = self.transforms(rng, image, None)
        return {"image": img}


class DistanceDataset:
    """(original, translated) pairs of the Freiburg ``split`` for the
    translation-quality eval (reference data/distance_dataset.py:9-49).

    The lists are written on first use when missing. A frame's
    translation is its root-relative path with ``split`` swapped for
    ``translate_name`` and ``ir_aligned`` for ``rgb`` (only below the
    root, so a root holding 'train' stays as it is). The original is the
    windowed IR frame (``domain`` 'IR') or the resized, cropped RGB frame
    scaled to [0, 1] ('RGB'). The translation is scaled by 1/255 when its
    file holds uint8 or its values pass 1.5: the file's dtype decides, so a
    near-black uint8 frame is still scaled. ``with_label`` adds the
    frame's label, resized and cropped as the frame (``load_label``)."""

    def __init__(self, root: str, translate_name: str, *,
                 split: str = "train", domain: str = "IR",
                 with_label: bool = False):
        list_file = os.path.join(root, "image_list",
                                 f"{split}_{domain}_data.txt")
        label_file = os.path.join(root, "image_list",
                                  f"{split}_{domain}_label.txt")
        if not os.path.exists(list_file) or (
                with_label and not os.path.exists(label_file)):
            freiburg_lists(root, split, domain)
        self.data_list = parse_list_file(list_file)
        self.label_list = None
        if with_label:
            self.label_list = parse_list_file(label_file)
            if len(self.label_list) != len(self.data_list):
                raise ValueError(
                    f"{label_file} lists {len(self.label_list)} labels for "
                    f"{len(self.data_list)} frames")
        self.root = root
        self.translate_name = translate_name
        self.split = split
        self.domain = domain

    def __len__(self) -> int:
        return len(self.data_list)

    def get(self, index: int, rng: np.random.Generator) -> dict:
        ori_name = self.data_list[index]
        rel = os.path.relpath(ori_name, self.root)
        trans_name = os.path.join(self.root, rel.replace(
            self.split, self.translate_name).replace("ir_aligned", "rgb"))
        if self.domain == "IR":
            ori = np.asarray(load_ir_image(ori_name),
                             dtype=np.float32)[..., None]
        elif self.domain == "RGB":
            arr = im.resize(im.open_image(ori_name, "RGB"), RAW_SIZE,
                            im.BICUBIC)[:, COL_CROP[0]:COL_CROP[1]]
            ori = arr.astype(np.float32) / 255.0
        else:
            raise ValueError("Not a valid domain.")
        raw = im.open_image(trans_name)
        trans = raw.astype(np.float32)
        if raw.dtype == np.uint8 or trans.max() > 1.5:
            trans = trans / 255.0
        if trans.ndim == 2:
            trans = trans[..., None]
        out = {"original": ori, "translated": trans.astype(np.float32)}
        if self.label_list is not None:
            out["label"] = np.asarray(load_label(self.label_list[index]),
                                      dtype=np.int32)
        return out
