"""Freiburg Thermal decoding, the train split, the test split and the
translated test pairs (counterpart of the JAX ``data/freiburg.py``).

IR radiometric normalisation: resize the 16-bit frame to RAW_SIZE BICUBIC,
crop columns COL_CROP, clamp to [IR_MIN, IR_MAX] and scale to [0, 1]. RGB
frames and labels get the same resize (labels NEAREST) and crop. PIL is
imported where it is used, so the package imports on a host without it.
Decoded frames and labels go through the process's decode cache
(``data/cache.py``, off unless ``--decode_cache_mb`` or
``--decode_cache_dir`` is given) under the JAX package's keys: ('ir', path),
('rgb', path, grayscale), ('label', path) and ('translated', path).
"""

from __future__ import annotations

import glob
import os
from typing import Callable, Optional, Sequence

import numpy as np

from .cache import decode_cache
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
    windowed and column-cropped. A file object is decoded every time (it
    has no stable cache key)."""
    Image = _pil_image()

    def decode():
        image = np.array(Image.open(path_or_file).resize(
            RAW_SIZE, Image.BICUBIC), dtype=np.float32)
        image = np.clip(image[:, COL_CROP[0]:COL_CROP[1]], IR_MIN, IR_MAX)
        return (image - IR_MIN) / (IR_MAX - IR_MIN)

    if not isinstance(path_or_file, str):
        return Image.fromarray(decode())
    return Image.fromarray(decode_cache().get_or_decode(
        ("ir", path_or_file), decode))


def load_rgb_image(path: str, grayscale: bool = False):
    """RGB frame -> uint8 PIL image (grayscale 'L' with ``grayscale``),
    resized and column-cropped."""
    Image = _pil_image()

    def decode():
        img = Image.open(path).convert("RGB")
        if grayscale:
            from PIL import ImageOps
            img = ImageOps.grayscale(img)
        arr = np.array(img.resize(RAW_SIZE, Image.BICUBIC), dtype=np.float32)
        return np.uint8(arr[:, COL_CROP[0]:COL_CROP[1]])

    return Image.fromarray(decode_cache().get_or_decode(
        ("rgb", path, grayscale), decode))


def load_label(path: str):
    """Label PNG -> 'L' PIL image, resized NEAREST and column-cropped."""
    Image = _pil_image()

    def decode():
        label = np.array(Image.open(path).resize(RAW_SIZE, Image.NEAREST),
                         dtype=np.uint8)
        return label[:, COL_CROP[0]:COL_CROP[1]]

    return Image.fromarray(decode_cache().get_or_decode(("label", path),
                                                        decode), mode="L")


class Freiburg:
    """Train-split Freiburg (reference data/freiburg_dataset.py:12-152), in
    plain IR or RGB mode, in translation mode (``segmentation_mode=True``:
    the RGB frames' translated copies under ``translation_name``, with the
    RGB labels), in the offline translator's mode (``translation_mode``:
    the frame and its destination ``img_path``, the frame's path with the
    split segment swapped for ``translation_name``) and in self-training
    mode (``self_train=True``, below). With ``native_decode``, plain IR
    and RGB frames are decoded a batch at a time by the native C++ IO
    (``get_batch``).

    Self-training mode (reference :107-134) reads the IR frame and its
    label, the hard pseudo-label PNG under ``path_lp`` and, with
    ``proto_rectify``, the soft maps ``.npy`` under ``path_soft``. With a
    ``threshold``, the hard labels whose ``_conf.npy`` confidence is at most
    the threshold become ``ignore_index``, only ``hard_keep_classes`` are
    kept (the reference's (5, 11)), and the map is resized NEAREST to the
    frame's size. ``augmentations`` (``data/self_train_aug
    .SelfTrainAugment``) then transforms them together; a sample also
    carries the frame before augmentation (``image_full``) and the recorded
    draws (``weak_params``)."""

    def __init__(self, root: str, split: str, domain: str, *,
                 transforms: Optional[Callable] = None,
                 with_label: bool = True, grayscale: bool = False,
                 segmentation_mode: bool = False,
                 translation_mode: bool = False,
                 translation_name: str = "translation",
                 self_train: bool = False,
                 augmentations: Optional[Callable] = None,
                 path_soft: Optional[str] = None,
                 path_lp: Optional[str] = None, threshold: float = 0.0,
                 ignore_index: int = 12, proto_rectify: bool = True,
                 hard_keep_classes: Sequence[int] = (5, 11),
                 native_decode: bool = False):
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
        self.translation_mode = translation_mode
        self.translation_name = translation_name
        self.self_train = self_train
        self.augmentations = augmentations
        self.path_soft = path_soft
        self.path_lp = path_lp
        self.threshold = threshold
        self.ignore_index = ignore_index
        self.proto_rectify = proto_rectify
        self.hard_keep_classes = tuple(hard_keep_classes)
        self.native_decode = native_decode

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
        if self.self_train:
            return load_ir_image(image_name)
        if self.segmentation_mode:
            Image = _pil_image()
            translated = self._swap_split(image_name)
            return Image.fromarray(decode_cache().get_or_decode(
                ("translated", translated),
                lambda: np.asarray(Image.open(translated))))
        if self.domain == "IR":
            return load_ir_image(image_name)
        if self.domain == "RGB":
            return load_rgb_image(image_name, self.grayscale)
        raise ValueError("Not a valid domain.")

    def get_batch(self, indices: Sequence[int], rngs):
        """The batch path of ``native_decode``: one native call decodes the
        batch's frames on a C++ thread pool (16-bit decode, bilinear resize,
        column crop and IR window), then each sample's transforms run on its
        frame. None where this mode has no native path (translation,
        self-training, grayscale) or the library is unavailable: the loader
        then reads sample by sample. The native resize is bilinear, the PIL
        path's BICUBIC, so the two agree in distribution, not bit for bit;
        PIL stays the parity path."""
        from . import native_loader as nl

        plain = not (self.segmentation_mode or self.self_train
                     or self.grayscale)
        if not (self.native_decode and plain and nl.available()):
            return None
        Image = _pil_image()
        paths = [self.data_list[i] for i in indices]
        if self.domain == "IR":
            images = [Image.fromarray(a[..., 0])
                      for a in nl.decode_ir_batch(paths)]
        else:
            images = [Image.fromarray(a) for a in nl.decode_rgb_batch(paths)]
        return [self.get(i, rng, image=img)
                for i, rng, img in zip(indices, rngs, images)]

    def get(self, index: int, rng: np.random.Generator, image=None) -> dict:
        """Sample ``index``; ``image``, when given, is its decoded frame
        (``get_batch``)."""
        image_name = self.data_list[index]
        out = {"img_path": os.path.basename(image_name)}
        if image is None:
            image = self._load_image(image_name)
        if self.translation_mode:
            out["image"], _ = self.transforms(rng, image, None)
            out["img_path"] = self._swap_split(image_name)
            return out
        if not self.with_label:
            out["image"], _ = self.transforms(rng, image, None)
            return out
        label = load_label(self.label_list[index])
        if self.self_train:
            return self._self_train_sample(out, image, label, rng)
        img, lab = self.transforms(rng, image, label)
        out["image"] = img
        out["label"] = np.asarray(lab, dtype=np.int64)
        return out

    def _self_train_sample(self, out: dict, image, label, rng) -> dict:
        Image = _pil_image()
        name = out["img_path"]
        label_soft = None
        if self.proto_rectify:
            label_soft = np.load(os.path.join(
                self.path_soft, name.replace(".png", ".npy")))
        label_hard = np.array(Image.open(os.path.join(self.path_lp, name)),
                              dtype=np.uint8)
        if self.threshold:
            conf = np.load(os.path.join(self.path_lp,
                                        name.replace(".png", "_conf.npy")))
            label_hard[conf <= self.threshold] = self.ignore_index
            keep = np.full(label_hard.shape, self.ignore_index, np.uint8)
            for cid in self.hard_keep_classes:
                keep[label_hard == cid] = cid
            label_hard = np.array(Image.fromarray(keep).resize(
                image.size, Image.NEAREST), dtype=np.uint8)
        image_full = np.asarray(image, dtype=np.float32)
        img, mask, mask_hard, lpsoft, params = self.augmentations(
            rng, image, np.array(label, dtype=np.uint8), label_hard,
            label_soft)
        out["image"] = _with_channel(img)
        out["label"] = mask
        if mask_hard is not None:
            out["label_hard"] = mask_hard
        if lpsoft is not None:
            out["label_soft"] = lpsoft
        out["weak_params"] = params
        out["image_full"] = _with_channel(image_full)
        return out


def _with_channel(arr: np.ndarray) -> np.ndarray:
    """HW(C) float32 -> HWC with an explicit channel axis."""
    return arr[..., None] if arr.ndim == 2 else arr


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


class FreiburgTranslationPairs:
    """Translated frames and their ground truth: ``*_translation.jpg`` under
    ``root``/``folder`` beside ``*_groundtruth.png`` (reference
    FreiburgTranslation, data/freiburg_dataset.py:228-244), or with
    ``strip_underscore=False`` the name's ``translation.jpg`` swapped for
    ``groundtruth.png`` (FreiburgT2S, :211-225). Labels are int64."""

    def __init__(self, folder: str, transforms: Callable,
                 root: str = "datasets/freiburg/translations/",
                 strip_underscore: bool = True):
        pattern = os.path.join(root, folder, "*_translation.jpg")
        self.translation_files = sorted(glob.glob(pattern, recursive=True))
        self.transforms = transforms
        self._old = "_translation.jpg" if strip_underscore \
            else "translation.jpg"
        self._new = "_groundtruth.png" if strip_underscore \
            else "groundtruth.png"

    def __len__(self) -> int:
        return len(self.translation_files)

    def get(self, index: int, rng: np.random.Generator) -> dict:
        Image = _pil_image()
        image_name = self.translation_files[index]
        image = Image.open(image_name)
        label = Image.open(image_name.replace(self._old, self._new))
        img, lab = self.transforms(rng, image, label)
        return {"image": img, "label": np.asarray(lab, dtype=np.int64)}
