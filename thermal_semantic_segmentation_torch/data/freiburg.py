"""Freiburg Thermal decoding, the train split and the test split
(counterpart of the JAX ``data/freiburg.py``).

IR radiometric normalisation: resize the 16-bit frame to RAW_SIZE BICUBIC,
crop columns COL_CROP, clamp to [IR_MIN, IR_MAX] and scale to [0, 1]. RGB
frames and labels get the same resize (labels NEAREST) and crop. PIL is
imported where it is used, so the package imports on a host without it.
The JAX package's decode cache (``data/cache.py``, off by default) is not
ported.
"""

from __future__ import annotations

import os
from typing import Callable, Optional, Sequence

import numpy as np

from .list_files import freiburg_lists, parse_list_file

IR_MIN, IR_MAX = 21800.0, 25000.0
RAW_SIZE = (960, 320)          # PIL (w, h)
COL_CROP = (150, 850)


def _pil_image():
    """PIL's ``Image`` module, with truncated files decoding to a partly
    zero image instead of raising, as the reference sets at every entry
    point."""
    from PIL import Image, ImageFile

    ImageFile.LOAD_TRUNCATED_IMAGES = True
    return Image


def load_ir_image(path_or_file):
    """16-bit IR PNG (path or file object) -> float [0, 1] PIL 'F' image,
    windowed and column-cropped."""
    Image = _pil_image()
    image = np.array(Image.open(path_or_file).resize(RAW_SIZE, Image.BICUBIC),
                     dtype=np.float32)
    image = image[:, COL_CROP[0]:COL_CROP[1]]
    image = np.clip(image, IR_MIN, IR_MAX)
    return Image.fromarray((image - IR_MIN) / (IR_MAX - IR_MIN))


def load_rgb_image(path: str, grayscale: bool = False):
    """RGB frame -> uint8 PIL image (grayscale 'L' with ``grayscale``),
    resized and column-cropped."""
    Image = _pil_image()
    img = Image.open(path).convert("RGB")
    if grayscale:
        from PIL import ImageOps
        img = ImageOps.grayscale(img)
    arr = np.array(img.resize(RAW_SIZE, Image.BICUBIC), dtype=np.float32)
    return Image.fromarray(np.uint8(arr[:, COL_CROP[0]:COL_CROP[1]]))


def load_label(path: str):
    """Label PNG -> 'L' PIL image, resized NEAREST and column-cropped."""
    Image = _pil_image()
    label = np.array(Image.open(path).resize(RAW_SIZE, Image.NEAREST),
                     dtype=np.uint8)
    return Image.fromarray(label[:, COL_CROP[0]:COL_CROP[1]], mode="L")


class Freiburg:
    """Train-split Freiburg (reference data/freiburg_dataset.py:12-152), in
    plain IR or RGB mode and in translation mode (``segmentation_mode=True``:
    the RGB frames' translated copies under ``translation_name``, with the
    RGB labels). The offline-translator mode (``translation_mode``), the
    self-training mode (``self_train``) and the native batch decoder
    (``native_decode``) are not yet ported and raise."""

    def __init__(self, root: str, split: str, domain: str, *,
                 transforms: Optional[Callable] = None,
                 with_label: bool = True, grayscale: bool = False,
                 segmentation_mode: bool = False,
                 translation_mode: bool = False,
                 translation_name: str = "translation",
                 self_train: bool = False, native_decode: bool = False):
        for flag, name, slice_ in (
                (translation_mode, "translation_mode", "translator"),
                (self_train, "self_train", "self-training"),
                (native_decode, "native_decode", "native loader")):
            if flag:
                raise NotImplementedError(
                    f"Freiburg({name}=True) belongs to the {slice_} slice and "
                    f"is not yet ported to the PyTorch package (see "
                    f"ROADMAP.md)")
        if split not in ("train", "test"):
            raise ValueError(f"invalid split {split!r}")
        data_file = os.path.join(root, "image_list",
                                 f"{split}_{domain}_data.txt")
        label_file = os.path.join(root, "image_list",
                                  f"{split}_{domain}_label.txt")
        if not (os.path.exists(data_file) and os.path.exists(label_file)):
            freiburg_lists(root, split, domain)
        self.data_list = parse_list_file(data_file)
        self.label_list = parse_list_file(label_file)
        self.root = root
        self.split = split
        self.domain = domain
        self.transforms = transforms
        self.with_label = with_label
        self.grayscale = grayscale
        self.segmentation_mode = segmentation_mode
        self.translation_name = translation_name

    def __len__(self) -> int:
        return len(self.data_list)

    def _swap_split(self, path: str) -> str:
        """Swap the first root-relative path segment equal to the split for
        the translation folder name (the reference's raw str.replace would
        also rewrite a 'train' elsewhere in the path)."""
        rel = os.path.relpath(path, self.root)
        parts = rel.split(os.sep)
        parts[parts.index(str(self.split))] = self.translation_name
        return os.path.join(self.root, *parts)

    def _load_image(self, image_name: str):
        if self.segmentation_mode:
            Image = _pil_image()
            return Image.fromarray(np.asarray(Image.open(
                self._swap_split(image_name))))
        if self.domain == "IR":
            return load_ir_image(image_name)
        if self.domain == "RGB":
            return load_rgb_image(image_name, self.grayscale)
        raise ValueError("Not a valid domain.")

    def get_batch(self, indices: Sequence[int], rngs):
        """No batch decode path (the native decoder is not yet ported): the
        loader reads sample by sample."""
        return None

    def get(self, index: int, rng: np.random.Generator) -> dict:
        image_name = self.data_list[index]
        out = {"img_path": os.path.basename(image_name)}
        image = self._load_image(image_name)
        if not self.with_label:
            out["image"], _ = self.transforms(rng, image, None)
            return out
        label = load_label(self.label_list[index])
        img, lab = self.transforms(rng, image, label)
        out["image"] = img
        out["label"] = np.asarray(lab, dtype=np.int64)
        return out


class FreiburgTest:
    """Test split: labels are .npy files (reference
    data/freiburg_dataset.py:154-208)."""

    def __init__(self, root: str, split: str, domain: str, *,
                 transforms: Callable, with_label: bool = True,
                 grayscale: bool = False):
        data_file = os.path.join(root, "image_list",
                                 f"{split}_{domain}_data.txt")
        label_file = os.path.join(root, "image_list",
                                  f"{split}_{domain}_label.txt")
        if not (os.path.exists(data_file) and os.path.exists(label_file)):
            freiburg_lists(root, split, domain)
        self.data_list = parse_list_file(data_file)
        self.label_list = parse_list_file(label_file)
        self.domain = domain
        self.transforms = transforms
        self.with_label = with_label
        self.grayscale = grayscale

    def __len__(self) -> int:
        return len(self.data_list)

    def get(self, index: int, rng: np.random.Generator) -> dict:
        image_name = self.data_list[index]
        if self.domain == "IR":
            image = load_ir_image(image_name)
        elif self.domain == "RGB":
            image = load_rgb_image(image_name, self.grayscale)
        else:
            raise ValueError("Not a valid domain.")

        if not self.with_label:
            img, _ = self.transforms(rng, image, None)
            return {"image": img}

        Image = _pil_image()
        label = Image.fromarray(np.load(self.label_list[index])).resize(
            RAW_SIZE, Image.NEAREST)
        label = Image.fromarray(np.array(label)[:, COL_CROP[0]:COL_CROP[1]])
        img, lab = self.transforms(rng, image, label)
        return {"image": img, "label": np.asarray(lab, dtype=np.int64)}
