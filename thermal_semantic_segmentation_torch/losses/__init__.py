"""Loss functions (counterpart of the JAX ``losses/__init__.py``; the pixel
cross entropy and self-training's reverse cross entropy so far, the other
losses come with their slices).

Segmentation losses take NHWC logits and (N, H, W) integer labels.
"""

from __future__ import annotations

import math

import torch


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, *,
                  ignore_index: int = 255) -> torch.Tensor:
    """Mean CE over the pixels whose label is in [0, C) and is not
    ``ignore_index``; the others contribute nothing.

    logits: (N, H, W, C); labels: (N, H, W) int. The denominator is
    ``max(count, 1)``, so an all-ignored batch gives 0 (with zero gradients).
    ``F.cross_entropy(ignore_index=...)`` is not used: it neither drops other
    out-of-range labels (on a CUDA tensor a 255 trips a device assert) nor
    returns 0 for an all-ignored batch.
    """
    num_classes = logits.shape[-1]
    labels = labels.long()
    valid = (labels != ignore_index) & (labels >= 0) & (labels < num_classes)
    logp = torch.log_softmax(logits.float(), dim=-1)
    picked = torch.where(valid, labels, 0).unsqueeze(-1)
    nll = -logp.gather(-1, picked).squeeze(-1)
    nll = torch.where(valid, nll, 0.0)
    return nll.sum() / valid.sum().clamp_min(1)


def reverse_cross_entropy(logits: torch.Tensor, labels: torch.Tensor, *,
                          num_classes: int, ignore_index: int) -> torch.Tensor:
    """Symmetric reverse CE of self-training (reference
    self_training.py:167-174):
    ``-sum_valid(sum_c p_c * log(clip(onehot_c, 1e-4, 1))) / (n_valid + 1e-6)``
    with ``p = clip(softmax(logits), 1e-7, 1)``.

    logits: (N, H, W, C); labels: (N, H, W) int. A pixel is valid where its
    label is not ``ignore_index``. The one-hot has ``num_classes + 1``
    columns, the last dropped, as in the JAX package: a label outside
    [0, num_classes) has no class (an all-1e-4 row).
    """
    p = torch.softmax(logits.float(), dim=-1).clamp(1e-7, 1.0)
    labels = labels.long()
    mask = (labels != ignore_index).float()
    onehot = labels[..., None] == torch.arange(num_classes,
                                               device=labels.device)
    log_onehot = torch.where(onehot, 0.0, math.log(1e-4))
    per_pix = -(p * log_onehot).sum(dim=-1)
    return (per_pix * mask).sum() / (mask.sum() + 1e-6)
