"""Confusion-matrix accumulation on the device (counterpart of the JAX
``ops/confmat.py``).

Rows are ground truth, columns are predictions. Counts are int64, as the
reference's ``np.bincount`` gives them, so no entry loses integer exactness
(a float32 count does above 2**24).
"""

from __future__ import annotations

import torch


def confusion_matrix(pred: torch.Tensor, true: torch.Tensor,
                     num_classes: int) -> torch.Tensor:
    """(num_classes, num_classes) int64 hist of ``pred`` against ``true``.

    Pixels with ``0 <= true < num_classes`` count, so an ignore label inside
    that range (12 of 13 Freiburg classes) has its own row, as in the JAX
    package and the reference's ``_fast_hist``; every other label is dropped.
    ``pred`` must lie in [0, num_classes) (it is an argmax over the classes).
    """
    c = num_classes
    true = true.reshape(-1).long()
    pred = pred.reshape(-1).long()
    valid = (true >= 0) & (true < c)
    # dropped pixels go to one extra bin, so no boolean indexing (whose
    # output size depends on the data) is needed
    idx = torch.where(valid, c * true + pred, c * c)
    return torch.bincount(idx, minlength=c * c + 1)[:c * c].view(c, c)
