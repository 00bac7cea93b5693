"""Freiburg Thermal decoding, the train split, the test split and the
translated test pairs (counterpart of the JAX ``data/freiburg.py``).

IR radiometric normalisation: resize the 16-bit frame to RAW_SIZE BICUBIC,
crop columns COL_CROP, clamp to [IR_MIN, IR_MAX] and scale to [0, 1]. RGB
frames and labels get the same resize (labels NEAREST) and crop. Frames are
numpy arrays in PIL's modes, read and resampled by ``data/image.py`` as PIL
does, without PIL (the t2s sets' JPEG frames need PIL).
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

from . import image as im
from .cache import decode_cache
from .list_files import freiburg_lists, parse_list_file

IR_MIN, IR_MAX = 21800.0, 25000.0
RAW_SIZE = (960, 320)          # PIL (w, h)
COL_CROP = (150, 850)


def ir_frame(frame: np.ndarray) -> np.ndarray:
    """A decoded IR frame ('I;16') -> float32 'F' (H, crop width) in
    [0, 1]: the BICUBIC resize to RAW_SIZE, the column crop, the clamp to
    [IR_MIN, IR_MAX] and the scale."""
    image = im.resize(frame, RAW_SIZE, im.BICUBIC).astype(np.float32)
    image = np.clip(image[:, COL_CROP[0]:COL_CROP[1]], IR_MIN, IR_MAX)
    return (image - IR_MIN) / (IR_MAX - IR_MIN)


def load_ir_image(path_or_file) -> np.ndarray:
    """16-bit IR PNG (path, file object or bytes) -> float32 'F' (H, W) in
    [0, 1], windowed and column-cropped (``ir_frame``). A file object or
    bytes are decoded every time (no stable cache key)."""
    def decode():
        return ir_frame(im.open_image(path_or_file))

    if not isinstance(path_or_file, str):
        return decode()
    return decode_cache().get_or_decode(("ir", path_or_file), decode)


def load_rgb_image(path: str, grayscale: bool = False) -> np.ndarray:
    """RGB frame -> uint8 'RGB' (H, W, 3) ('L' (H, W) with ``grayscale``),
    resized and column-cropped."""
    def decode():
        img = im.open_image(path, "RGB")
        if grayscale:
            img = im.convert(img, "L")
        return np.ascontiguousarray(im.resize(img, RAW_SIZE, im.BICUBIC)[
            :, COL_CROP[0]:COL_CROP[1]])

    return decode_cache().get_or_decode(("rgb", path, grayscale), decode)


def load_label(path: str) -> np.ndarray:
    """Label PNG -> uint8 (H, W) ids, resized NEAREST and column-cropped."""
    def decode():
        label = im.resize(im.open_image(path), RAW_SIZE, im.NEAREST)
        return np.ascontiguousarray(
            np.asarray(label, np.uint8)[:, COL_CROP[0]:COL_CROP[1]])

    return decode_cache().get_or_decode(("label", path), decode)


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
            translated = self._swap_split(image_name)
            return decode_cache().get_or_decode(
                ("translated", translated), lambda: im.open_image(translated))
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
        then reads sample by sample. The native resize is bilinear, the
        sample path's PIL BICUBIC, so the two agree in distribution, not bit
        for bit; the sample path stays the parity path."""
        from . import native_loader as nl

        plain = not (self.segmentation_mode or self.self_train
                     or self.grayscale)
        if not (self.native_decode and plain and nl.available()):
            return None
        paths = [self.data_list[i] for i in indices]
        if self.domain == "IR":
            images = [a[..., 0] for a in nl.decode_ir_batch(paths)]
        else:
            images = list(nl.decode_rgb_batch(paths))
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
        name = out["img_path"]
        label_soft = None
        if self.proto_rectify:
            label_soft = np.load(os.path.join(
                self.path_soft, name.replace(".png", ".npy")))
        label_hard = np.array(im.open_image(os.path.join(self.path_lp, name)),
                              dtype=np.uint8)
        if self.threshold:
            conf = np.load(os.path.join(self.path_lp,
                                        name.replace(".png", "_conf.npy")))
            label_hard[conf <= self.threshold] = self.ignore_index
            keep = np.full(label_hard.shape, self.ignore_index, np.uint8)
            for cid in self.hard_keep_classes:
                keep[label_hard == cid] = cid
            label_hard = im.resize(keep, im.size(image), im.NEAREST)
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

        label = im.resize(np.load(self.label_list[index]), RAW_SIZE,
                          im.NEAREST)[:, COL_CROP[0]:COL_CROP[1]]
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
        image_name = self.translation_files[index]
        image = im.open_image(image_name)        # JPEG: PIL
        label = im.open_image(image_name.replace(self._old, self._new))
        img, lab = self.transforms(rng, image, label)
        return {"image": img, "label": np.asarray(lab, dtype=np.int64)}
