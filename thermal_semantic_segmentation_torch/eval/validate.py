"""Segmentation validation (counterpart of the JAX ``eval/validate.py``).

Batch inference, align-corners upsample to the label's size, argmax,
confusion-matrix accumulation, then (mean_iu, val_loss, cls_iu) under the
``iu[:11]`` Freiburg rule. The confusion matrix (int64) and the loss sum
accumulate on the device; they reach the host once, at the end. Optional
palette-PNG dumps follow the reference layout
(``<save_root>/<i>_prediction.png`` / ``_image.png`` / ``_groundtruth.png``),
written by ``data/png.py`` (no PIL).

A ragged tail batch runs at its own size. The JAX package pads it with zero
images labelled ``ignore_index`` to keep one compiled shape; those pixels
are counted in the ignore row of the confusion matrix, whose predictions
then add to the scored classes' column sums, so padding changes mIoU. Here
there is nothing to pad, and the result is the reference's batch-1 result.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from ..data.device_pipeline import device_prefetch
from ..data.palette import colorize_prediction, freiburg_palette
from ..data.png import write_gray_png, write_rgb_png
from ..device import resolve_device
from ..parallel import mesh as pmesh
from ..train.seg import build_seg_eval_step
from .metrics import scores_from_hist


def seg_validate(model, loader, *, num_classes: int = 13,
                 ignore_index: int = 12, visualize: Optional[str] = None,
                 save_root: Optional[str] = None, iter_counter: int = 0,
                 eval_step=None, device=None, bf16: bool = False, mesh=None,
                 reduce_processes: bool = False,
                 wire: Optional[str] = "packed"):
    """Returns (mean_iu, val_loss, cls_iu) like the reference seg_validate.

    ``model`` lives on ``device`` (default: the CUDA device; raises without
    one). ``loader`` yields dicts of numpy ``image`` (N, H, W, C) float32
    and ``label`` (N, H, W) int. ``visualize``: None | 'save_all' |
    'save_one' (the reference's flag values). ``eval_step``: a prebuilt
    ``build_seg_eval_step`` step. ``val_loss`` is the mean of the batches'
    mean CE weighted by their image counts, as in the JAX package.

    ``reduce_processes``: set when each process scored its own shard of
    the set (``DataLoader(shard=host_shard(), shard_lockstep=False)``):
    the confusion matrices, loss sums and image counts are summed across
    the processes after the loop (the shards may hold different numbers of
    batches), and every process returns the global scores. Leave it off
    when each process scores the whole set (the trainers' validation).

    ``mesh`` (``parallel/mesh.LocalMesh``, ``--data_parallel``): the model
    is copied once onto each of the mesh's devices, each batch's rows are
    split over the copies, and their confusion matrices add up on
    ``device``; a batch's loss is the copies' CEs weighted by their valid
    pixel counts, the CE of the whole batch. The predictions written with
    ``visualize`` come back in row order. ``wire``: the batches' transfer
    (``data/device_pipeline.device_prefetch``).
    """
    device = resolve_device(device)
    mesh = pmesh.LocalMesh.of(mesh, device)
    replicas = pmesh.replicate(mesh, model)
    if eval_step is None:
        eval_step = build_seg_eval_step(num_classes=num_classes,
                                        ignore_index=ignore_index,
                                        device=device, bf16=bf16)
    hist = torch.zeros((num_classes, num_classes), dtype=torch.int64,
                       device=device)
    loss_sum = torch.zeros((), dtype=torch.float64, device=device)
    n_seen = 0
    palette = freiburg_palette()

    for i, batch in enumerate(device_prefetch(loader, device, mesh=mesh,
                                              wire=wire)):
        bhist, loss, pred = _split_eval(eval_step, replicas, batch["image"],
                                        batch["label"], device, num_classes,
                                        ignore_index)
        # the first share holds the batch's first row
        image, label = batch["image"][0], batch["label"][0]
        hist += bhist
        loss_sum += loss * pred.shape[0]  # no per-batch host sync
        n_seen += pred.shape[0]
        if visualize is not None and save_root:
            os.makedirs(save_root, exist_ok=True)
            if visualize == "save_all" or (visualize == "save_one" and i == 0):
                suffix = f"_{iter_counter}" if visualize == "save_one" else ""
                for name, ids in ((f"{i}_prediction{suffix}.png", pred[0]),
                                  (f"{i}_groundtruth.png", label[0])):
                    with open(os.path.join(save_root, name), "wb") as f:
                        f.write(colorize_prediction(ids.cpu().numpy(),
                                                    palette))
                img8 = np.clip(image[0].cpu().numpy() * 255.0, 0,
                               255).astype(np.uint8)
                path = os.path.join(save_root, f"{i}_image.png")
                if img8.shape[-1] == 1:
                    write_gray_png(path, img8[..., 0])
                else:
                    write_rgb_png(path, img8)

    if reduce_processes and pmesh.process_count() > 1:
        hist = pmesh.all_reduce(hist)
        totals = pmesh.all_reduce(torch.stack(
            [loss_sum, torch.tensor(float(n_seen), dtype=torch.float64,
                                    device=device)]))
        loss_sum, n_seen = totals[0], int(totals[1])
    scores = scores_from_hist(hist.cpu().numpy())
    val_loss = float(loss_sum) / max(n_seen, 1)
    return scores.mean_iu, val_loss, scores.cls_iu


def _split_eval(eval_step, replicas, images, labels, device, num_classes,
                ignore_index):
    """``eval_step`` on each replica's share of a batch
    (``parallel/mesh.map_shares``): the summed confusion matrix, the whole
    batch's CE in float64 (each share's CE weighted by its valid pixel
    count) and the predictions in row order, all on ``device``."""

    def share(net, x, y):
        hist, loss, pred = eval_step(net, x, y)
        valid = ((y != ignore_index) & (y >= 0) & (y < num_classes)).sum()
        valid = valid.double()
        return hist[None], (loss.double() * valid)[None], valid[None], pred

    hist, loss, valid, pred = pmesh.map_shares(share, replicas, device,
                                               images, labels)
    return hist.sum(0), loss.sum() / valid.sum().clamp_min(1), pred
