"""Loss functions (counterpart of the JAX ``losses/__init__.py``; only the
pixel cross entropy so far, the other losses come with their slices).

Segmentation losses take NHWC logits and (N, H, W) integer labels.
"""

from __future__ import annotations

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
