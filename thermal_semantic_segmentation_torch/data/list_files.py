"""Freiburg, Cityscapes, FLIR and KITTI list files in the reference's
directory grammar (counterpart of the JAX ``data/list_files.py``).

The reference writes ``image_list/*.txt`` manifests on first use and derives
label paths by string substitution. The same rules apply here, with sorted
(filesystem-independent) order, so a tree lists the same pairs in the same
order as in the JAX package.
"""

from __future__ import annotations

import glob
import os
from typing import List, Tuple


def _walk_files(root: str) -> List[str]:
    out: List[str] = []
    for dirpath, _dirnames, filenames in os.walk(root):
        for filename in sorted(filenames):
            out.append(os.path.join(dirpath, filename))
    return sorted(out)


def freiburg_pairs(root: str, split: str, domain: str,
                   time: str = "day") -> List[Tuple[str, str]]:
    """Freiburg (frame, derived label) path pairs:
      test:  <root>/test/<time>/Images<domain>/**  with labels under
             SegmentationClass, '_<domain>.png' -> '_rgb.npy'
      train: IR  -> <root>/train/seq_*_<time>/*/fl_ir_aligned/*.png,
                    labels via 'ir_aligned' -> 'rgb_labels'
             RGB -> <root>/train/seq_*_<time>/*/fl_rgb/*.png,
                    labels via 'rgb' -> 'rgb_labels'
    Label paths are derived, not checked for existence. The substitution
    applies to the root-relative part only, so a root that itself holds the
    pattern (e.g. .../rgb_data/...) stays intact.
    """
    def swap(path, old, new, suffix=("", "")):
        rel = os.path.relpath(path, root).replace(old, new)
        if suffix[0] and rel.endswith(suffix[0]):
            rel = rel[: -len(suffix[0])] + suffix[1]
        return os.path.join(root, rel)

    if split == "test":
        im_dir = os.path.join(root, split, time, "Images" + domain)
        return [(path, swap(path, "Images" + domain, "SegmentationClass",
                            suffix=("_" + domain.lower() + ".png",
                                    "_rgb.npy")))
                for path in _walk_files(im_dir)]
    if split == "train":
        sub, old = (("fl_ir_aligned", "ir_aligned") if domain == "IR"
                    else ("fl_rgb", "rgb"))
        files = sorted(glob.glob(os.path.join(
            root, "train", f"seq_*_{time}", "*", sub, "*.png")))
        return [(f, swap(f, old, "rgb_labels")) for f in files]
    raise ValueError(f"invalid split {split!r}")


def freiburg_lists(root: str, split: str, domain: str,
                   time: str = "day") -> Tuple[str, str]:
    """Write (and return the paths of) the Freiburg data and label list
    files, following :func:`freiburg_pairs`."""
    list_dir = os.path.join(root, "image_list")
    os.makedirs(list_dir, exist_ok=True)
    data_file = os.path.join(list_dir, f"{split}_{domain}_data.txt")
    label_file = os.path.join(list_dir, f"{split}_{domain}_label.txt")

    pairs = freiburg_pairs(root, split, domain, time)
    with open(data_file, "w") as f:
        f.write("".join(p + "\n" for p, _ in pairs))
    with open(label_file, "w") as f:
        f.write("".join(lab + "\n" for _, lab in pairs))
    return data_file, label_file


def cityscapes_list(root: str, data_folder: str, split: str,
                    list_root: str = "datasets/source_dataset") -> str:
    """Write the Cityscapes manifest ``<list_root>/image_list/
    <data_folder>_<split>.txt``: every file under
    ``<root>/<data_folder>/<split>``, sorted. ``data_folder`` is
    'leftImg8bit', 'translation' or 'gtFine_labelIds'; for the last, only
    files ending in 'gtFine_labelIds.png' are listed."""
    im_dir = os.path.join(root, data_folder, split)
    list_dir = os.path.join(list_root, "image_list")
    os.makedirs(list_dir, exist_ok=True)
    list_path = os.path.join(list_dir, f"{data_folder}_{split}.txt")
    paths = _walk_files(im_dir)
    if data_folder == "gtFine_labelIds":
        paths = [p for p in paths if p.endswith("gtFine_labelIds.png")]
    with open(list_path, "w") as f:
        f.write("".join(p + "\n" for p in paths))
    return list_path


def flir_list(root: str, split: str, data_folder: str = "images") -> str:
    """Write the FLIR ADAS manifest (reference utils/misc.py:211-233
    grammar): every file under ``<root>/train`` into
    ``<root>/image_list/train.txt``, or under ``<root>/test/<data_folder>``
    into ``image_list/test_<data_folder>.txt``, sorted."""
    if split == "train":
        im_dir = os.path.join(root, split)
        list_path = os.path.join(root, "image_list", "train.txt")
    elif split == "test":
        im_dir = os.path.join(root, split, data_folder)
        list_path = os.path.join(root, "image_list",
                                 f"test_{data_folder}.txt")
    else:
        raise ValueError("path does not exist.")
    os.makedirs(os.path.dirname(list_path), exist_ok=True)
    with open(list_path, "w") as f:
        f.write("".join(p + "\n" for p in _walk_files(im_dir)))
    return list_path


def kitti_list(root: str) -> str:
    """KITTI raw frames: <root>/2011_09_*/2011_09_*/image_02/data/*.png."""
    list_dir = os.path.join(root, "image_list")
    os.makedirs(list_dir, exist_ok=True)
    list_path = os.path.join(list_dir, "kitti_data.txt")
    files = sorted(glob.glob(os.path.join(root, "2011_09_*", "2011_09_*",
                                          "image_02", "data", "*.png")))
    with open(list_path, "w") as f:
        f.write("".join(p + "\n" for p in files))
    return list_path


def parse_list_file(path: str) -> List[str]:
    with open(path) as f:
        return [line.strip() for line in f if line.strip()]
