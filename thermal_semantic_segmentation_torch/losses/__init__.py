"""Loss functions (counterpart of the JAX ``losses/__init__.py``): pixel
cross entropy, self-training's reverse cross entropy, focal loss, CyCADA's
semantic consistency, the LSGAN / vanilla / Wasserstein GAN losses and L1.

Segmentation losses take NHWC logits and (N, H, W) integer labels.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F


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
    nll_sum, count = cross_entropy_terms(logits, labels,
                                         ignore_index=ignore_index)
    return nll_sum / count.clamp_min(1)


def cross_entropy_terms(logits: torch.Tensor, labels: torch.Tensor, *,
                        ignore_index: int = 255):
    """(sum of the NLL over the valid pixels, their count as an int64
    tensor): ``cross_entropy``'s numerator and denominator, for a loss
    normalised by a count over several processes' batches."""
    num_classes = logits.shape[-1]
    labels = labels.long()
    valid = (labels != ignore_index) & (labels >= 0) & (labels < num_classes)
    logp = torch.log_softmax(
        logits.to(torch.promote_types(logits.dtype, torch.float32)), dim=-1)
    picked = torch.where(valid, labels, 0).unsqueeze(-1)
    nll = -logp.gather(-1, picked).squeeze(-1)
    nll = torch.where(valid, nll, 0.0)
    return nll.sum(), valid.sum()


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
    total, count = reverse_cross_entropy_terms(
        logits, labels, num_classes=num_classes, ignore_index=ignore_index)
    return total / (count + 1e-6)


def reverse_cross_entropy_terms(logits: torch.Tensor, labels: torch.Tensor,
                                *, num_classes: int, ignore_index: int):
    """(sum of the per-pixel reverse CE over the valid pixels, their count
    as a float32 tensor): ``reverse_cross_entropy``'s numerator and
    denominator, before the 1e-6."""
    p = torch.softmax(logits.float(), dim=-1).clamp(1e-7, 1.0)
    labels = labels.long()
    mask = (labels != ignore_index).float()
    onehot = labels[..., None] == torch.arange(num_classes,
                                               device=labels.device)
    log_onehot = torch.where(onehot, 0.0, math.log(1e-4))
    per_pix = -(p * log_onehot).sum(dim=-1)
    return (per_pix * mask).sum(), mask.sum()


def focal_loss(logits: torch.Tensor, labels: torch.Tensor, *,
               gamma: float = 0.0, alpha=None,
               ignore_index: Optional[int] = None) -> torch.Tensor:
    """Focal loss (reference utils/loss.py:153-184): the mean over valid
    pixels of ``-(1 - pt)^gamma * log(pt) [* alpha[label]]``, ``pt`` the
    softmax probability of the label, taken without a gradient. A pixel is
    valid where its label is in [0, C) and is not ``ignore_index``; the
    denominator is ``max(count, 1)``."""
    num_classes = logits.shape[-1]
    labels = labels.long()
    valid = (labels >= 0) & (labels < num_classes)
    if ignore_index is not None:
        valid &= labels != ignore_index
    safe = torch.where(valid, labels, 0).unsqueeze(-1)
    logpt = torch.log_softmax(logits.float(), dim=-1).gather(-1, safe)[..., 0]
    pt = logpt.detach().exp()
    if alpha is not None:
        alpha = torch.as_tensor(alpha, dtype=logpt.dtype,
                                device=logpt.device)
        logpt = logpt * alpha[safe[..., 0]]
    loss = torch.where(valid, -((1.0 - pt) ** gamma) * logpt, 0.0)
    return loss.sum() / valid.sum().clamp_min(1)


def semantic_consistency(logits: torch.Tensor, labels: torch.Tensor, *,
                         ignore_classes: Sequence[int] = ()) -> torch.Tensor:
    """CyCADA semantic-consistency loss (reference utils/loss.py:102-150):
    cross entropy with ``ignore_index`` 255, the ``ignore_classes`` ids
    remapped to 255."""
    nll_sum, count = semantic_consistency_terms(
        logits, labels, ignore_classes=ignore_classes)
    return nll_sum / count.clamp_min(1)


def semantic_consistency_terms(logits: torch.Tensor, labels: torch.Tensor,
                               *, ignore_classes: Sequence[int] = ()):
    """``semantic_consistency``'s (NLL sum, valid count), as
    ``cross_entropy_terms`` gives them."""
    labels = labels.long()
    for cid in ignore_classes:
        labels = torch.where(labels == cid, 255, labels)
    return cross_entropy_terms(logits, labels, ignore_index=255)


def lsgan_loss(prediction: torch.Tensor, real: bool) -> torch.Tensor:
    """Least-squares GAN loss: the MSE against all ones or all zeros."""
    return ((prediction.float() - (1.0 if real else 0.0)) ** 2).mean()


def vanilla_gan_loss(prediction: torch.Tensor, real: bool) -> torch.Tensor:
    """BCE with logits against all ones or all zeros, in the stable form
    ``max(p, 0) - p z + log1p(exp(-|p|))``."""
    p = prediction.float()
    z = 1.0 if real else 0.0
    return (p.clamp_min(0) - p * z + torch.log1p(torch.exp(-p.abs()))).mean()


def wasserstein_gan_loss(prediction: torch.Tensor, real: bool) -> torch.Tensor:
    p = prediction.float()
    return -p.mean() if real else p.mean()


def l1_loss(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return F.l1_loss(a.float(), b.float())


GAN_LOSSES = {
    "lsgan": lsgan_loss,
    "vanilla": vanilla_gan_loss,
    "wgan": wasserstein_gan_loss,
}
