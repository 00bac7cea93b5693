"""Translation-quality evaluation (counterpart of the JAX
``eval/distance.py``; reference distance_evaluate.py): the L1 distance and
SSIM between original frames and their translations, and optionally the
L1 per segmentation class.

The per-class view is the JAX package's extension: a global L1 cannot see
a rare class translated into another class's intensity range. Its sums are
``index_add_`` over the label ids (float64), its counts ``index_add_`` of
ones (int64); the JAX package's one-hot contraction is a TPU workaround.
Everything accumulates on the device and reaches the host once, at the
end.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..data.device_pipeline import device_prefetch
from ..device import resolve_device
from ..ops.ssim import ssim
from ..parallel import mesh as pmesh
from ..utils.meters import AverageMeter


def pair_metrics(ori: torch.Tensor, trans: torch.Tensor):
    """(mean |ori - trans|, SSIM) of one batch of (N, H, W, C) images, as
    float32 device scalars."""
    l1 = (ori.float() - trans.float()).abs().mean()
    return l1, ssim(ori, trans, data_range=1.0)


def per_class_l1_sums(ori: torch.Tensor, trans: torch.Tensor,
                      label: torch.Tensor, num_classes: int):
    """(per-class sums of the channel-mean |ori - trans| (float64),
    per-class pixel counts (int64)) of one batch; labels outside
    [0, num_classes) count nowhere."""
    diff = (ori.float() - trans.float()).abs().mean(dim=-1).reshape(-1)
    label = label.reshape(-1).long()
    valid = (label >= 0) & (label < num_classes)
    # the dropped pixels go to one extra bin: no data-dependent shapes
    idx = torch.where(valid, label, num_classes)
    sums = torch.zeros(num_classes + 1, dtype=torch.float64,
                       device=diff.device).index_add_(0, idx, diff.double())
    counts = torch.zeros(num_classes + 1, dtype=torch.int64,
                         device=diff.device).index_add_(
        0, idx, torch.ones_like(idx))
    return sums[:num_classes], counts[:num_classes]


def evaluate_distance(loader, *, num_classes: Optional[int] = None,
                      device=None, reduce_processes: bool = False,
                      wire: Optional[str] = "packed"):
    """Returns (avg_l1, avg_ssim), or (avg_l1, avg_ssim, per_class_l1) when
    ``num_classes`` is given: per_class_l1[k] (float64 numpy) is the mean
    of the channel-mean |ori - trans| over the pixels labelled k, nan for a
    class that never appears; the batches must then carry a ``label``
    (``DistanceDataset(with_label=True)``).

    ``loader`` yields dicts of numpy ``original`` and ``translated``
    (N, H, W, C) float32. The L1 is sample-weighted; the SSIM is the mean
    of the batches' means, as the reference computes it, so it depends on
    how the loader groups the samples. Nothing evaluated gives nan, never
    a perfect-looking 0. ``device``: default the CUDA device (raises
    without one).

    ``reduce_processes``: set when each process scored its own shard
    (``DataLoader(shard=host_shard(), shard_lockstep=False)``): the L1
    sums and counts, SSIM sums and batch counts and the per-class sums
    and counts are summed across the processes after the loop, and every
    process returns the global scores; an empty shard adds nothing.
    ``wire``: the batches' transfer (``device_prefetch``)."""
    device = resolve_device(device)
    distances = AverageMeter("distance", ":3.4f")
    ssim_sum, ssim_n = 0.0, 0
    k = num_classes or 0
    cls_sums = torch.zeros(k, dtype=torch.float64, device=device)
    cls_counts = torch.zeros(k, dtype=torch.int64, device=device)
    for batch in device_prefetch(iter(loader), device, wire=wire):
        ori, trans = batch["original"], batch["translated"]
        l1, s = pair_metrics(ori, trans)
        distances.update(l1.double(), ori.shape[0])
        ssim_sum = ssim_sum + s.double()
        ssim_n += 1
        if num_classes is not None:
            sums, counts = per_class_l1_sums(ori, trans, batch["label"],
                                             num_classes)
            cls_sums += sums
            cls_counts += counts
    l1_sum, l1_n = distances.sum, distances.count
    if reduce_processes and pmesh.process_count() > 1:
        stats = pmesh.all_reduce(torch.cat([
            torch.tensor([float(l1_sum), l1_n, float(ssim_sum), ssim_n],
                         dtype=torch.float64, device=device),
            cls_sums, cls_counts.double()]))
        l1_sum, l1_n, ssim_sum, ssim_n = stats[:4].tolist()
        cls_sums, cls_counts = stats[4:4 + k], stats[4 + k:].long()
    # nan, not 0, when nothing was evaluated: an empty split or shard must
    # never read as a perfect translation score
    avg_l1 = float(l1_sum / l1_n) if l1_n else float("nan")
    avg_ssim = float(ssim_sum / ssim_n) if ssim_n else float("nan")
    if num_classes is None:
        return avg_l1, avg_ssim
    with np.errstate(invalid="ignore"):
        per_class = cls_sums.cpu().numpy() / cls_counts.cpu().numpy()
    return avg_l1, avg_ssim, per_class
