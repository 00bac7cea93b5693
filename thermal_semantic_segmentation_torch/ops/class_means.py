"""Masked per-class feature means and the sequential prototype fold
(counterpart of the JAX ``ops/class_means.py``).

The per-pixel class and confidence come from the ``upsample_argmax`` kernel
at the logits' own size (its 2-tap tables are then the identity), the
per-class sums from one batched matmul of the one-hot masks with the
features. The fold keeps the reference's sample-major, class-minor order:
within one sample each class appears once, so a step over the samples that
updates all classes at once is the same sequence. Nothing leaves the device.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..kernels.upsample_argmax import upsample_argmax

MAX_PROTOTYPE_COUNT = 3000.0  # reference cal_prototype.py:93 momentum-regime
# cap: the one source for every fold and merge that must respect it


def masked_class_means(feat: torch.Tensor, outputs: torch.Tensor, *,
                       num_classes: int, thresh: Optional[float] = None,
                       labels: Optional[torch.Tensor] = None,
                       min_pixels: int = 10
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-sample per-class means of ``feat`` over the predicted regions.

    feat: (N, H, W, F); outputs: (N, H, W, C) float32 logits (same H, W).
    labels: optional (N, H, W) ground truth; a pixel then counts only where
    the prediction and the label agree (labels outside [0, C) count
    nowhere). thresh: when set and >= 0, a pixel adds to the sums only if
    its max-softmax confidence is at least ``thresh``.

    Returns (vectors (N, C, F) float32, valid (N, C) bool): valid where the
    masked count is > 0 and the unmasked count of predicted pixels is
    >= ``min_pixels`` (reference cal_prototype.py:133-135).
    """
    n, h, w, _ = outputs.shape
    pred, conf = upsample_argmax(outputs, h, w)
    classes = torch.arange(num_classes, device=outputs.device)
    onehot = pred[..., None] == classes                       # (N,H,W,C)
    if labels is not None:
        onehot = onehot & (labels[..., None] == classes)
    onehot = onehot.reshape(n, h * w, num_classes).float()
    if thresh is None or thresh < 0:
        masked = onehot
    else:
        masked = onehot * (conf >= thresh).reshape(n, h * w, 1)
    flat_feat = feat.float().reshape(n, h * w, -1)
    sums = torch.bmm(masked.transpose(1, 2), flat_feat)        # (N,C,F)
    cnt_masked = masked.sum(dim=1)                             # (N,C)
    cnt_unmasked = onehot.sum(dim=1)
    vectors = sums / cnt_masked.clamp_min(1.0)[..., None]
    valid = (cnt_masked > 0) & (cnt_unmasked >= min_pixels)
    return vectors, valid


def fold_prototypes(prototypes: torch.Tensor, counts: torch.Tensor,
                    vectors: torch.Tensor, valid: torch.Tensor, *,
                    momentum: float = 1e-4, mode: str = "moving_average",
                    start_mean: bool = True,
                    max_count: float = MAX_PROTOTYPE_COUNT,
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fold (N, C, F) class vectors into (C, F) prototypes, sample by
    sample, as the reference's update_objective_SingleVector
    (self_training.py:211-227, cal_prototype.py:153-169):
      mean:           p = (p * n + v) / (n + 1)
      moving_average: p = p * (1 - momentum) + momentum * v
      start_mean:     'mean' while the class count is < 100
    Invalid entries and all-zero vectors are skipped; counts (float32)
    saturate at ``max_count``. Returns (prototypes, counts) as new tensors.
    """
    if mode not in ("mean", "moving_average"):
        raise ValueError(f"unknown prototype update mode {mode!r}")
    protos = prototypes.float()
    nums = counts.float()
    for v, ok in zip(vectors.float(), valid):
        ok = ok & (v.sum(dim=1) != 0.0)
        if mode == "mean":
            use_mean = torch.ones_like(ok)
        elif start_mean:
            use_mean = nums < 100.0
        else:
            use_mean = torch.zeros_like(ok)
        col = nums[:, None]
        p_mean = (protos * col + v) / (col + 1.0)
        p_ma = protos * (1.0 - momentum) + momentum * v
        p_new = torch.where(use_mean[:, None], p_mean, p_ma)
        protos = torch.where(ok[:, None], p_new, protos)
        nums = torch.where(ok, torch.clamp(nums + 1.0, max=max_count), nums)
    return protos, nums
