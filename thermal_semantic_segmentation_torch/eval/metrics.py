"""Segmentation metrics with the reference's semantics (numpy copy of the JAX
``eval/metrics.py``).

- 13-class (Freiburg) mIoU is ``nanmean(iu[:11])``: class 11 (motorcycle,
  bicycle) and class 12 (ignore) are left out.
- 19-class (Cityscapes) mIoU is the nanmean over all classes.
- Axis 0 of the histogram is ground truth, axis 1 is prediction.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np

FREIBURG_CLASS_NAMES = [
    "IoU road,parking",
    "IoU ground,sidewalk",
    "IoU building,",
    "IoU curb",
    "IoU fence",
    "IoU pole,traffic light,traffic sign",
    "IoU vegetation",
    "IoU terrain",
    "IoU sky",
    "IoU person,rider",
    "IoU car,truck,bus,train",
    "IoU motorcycle,bicycle",
]

CITYSCAPES_CLASS_NAMES = [
    "IoU road", "IoU sidewalk", "IoU building,", "IoU wall", "IoU fence",
    "IoU pole", "IoU traffic light", "IoU traffic sign", "IoU vegetation",
    "IoU terrain", "IoU sky", "IoU person", "IoU rider", "IoU car",
    "IoU truck", "IoU bus", "IoU train", "IoU motorcycle", "IoU bicycle",
]


@dataclass
class SegScores:
    acc: float
    acc_cls: float
    mean_iu: float
    fwavacc: float
    cls_iu: Dict[str, float]

    def astuple(self):
        return self.acc, self.acc_cls, self.mean_iu, self.fwavacc, self.cls_iu


def scores_from_hist(hist) -> SegScores:
    """(acc, acc_cls, mean_iu, fwavacc, cls_iu) of a (C, C) confusion matrix
    (rows ground truth, columns predictions); C of 13 or 19 selects the
    Freiburg or Cityscapes names and mIoU rule."""
    hist = np.asarray(hist, dtype=np.float64)
    num_classes = hist.shape[0]
    with np.errstate(divide="ignore", invalid="ignore"):
        acc = np.diag(hist).sum() / hist.sum()
        acc_cls = np.nanmean(np.diag(hist) / hist.sum(axis=1))
        iu = np.diag(hist) / (hist.sum(axis=1) + hist.sum(axis=0)
                              - np.diag(hist))
        if num_classes == 13:
            mean_iu = np.nanmean(iu[:11])
            cls_iu = dict(zip(FREIBURG_CLASS_NAMES, iu))
        elif num_classes == 19:
            mean_iu = np.nanmean(iu)
            cls_iu = dict(zip(CITYSCAPES_CLASS_NAMES, iu))
        else:
            raise ValueError("invalid dataset for evaluation.")
        freq = hist.sum(axis=1) / hist.sum()
        fwavacc = (freq[freq > 0] * iu[freq > 0]).sum()
    return SegScores(float(acc), float(acc_cls), float(mean_iu),
                     float(fwavacc), {k: float(v) for k, v in cls_iu.items()})


def evaluate(predictions, gts, num_classes: int):
    """The reference ``evaluate`` for host arrays: sequences of prediction
    and ground-truth maps -> (acc, acc_cls, mean_iu, fwavacc, cls_iu)."""
    hist = np.zeros((num_classes, num_classes), dtype=np.int64)
    for lp, lt in zip(predictions, gts):
        lp = np.asarray(lp).reshape(-1)
        lt = np.asarray(lt).reshape(-1)
        mask = (lt >= 0) & (lt < num_classes)
        hist += np.bincount(
            num_classes * lt[mask].astype(np.int64)
            + lp[mask].astype(np.int64),
            minlength=num_classes ** 2,
        ).reshape(num_classes, num_classes)
    return scores_from_hist(hist).astuple()
