"""Class prototypes over a frozen segmenter (counterpart of the JAX
``train/prototypes.py``; reference cal_prototype.py:21-169).

Each batch: an eval-mode forward, the per-sample per-class masked feature
means (``ops/class_means.masked_class_means``, the classes from the CUDA
``upsample_argmax`` kernel) and their fold into the running prototypes in
'mean' mode, as the reference's calc_prototype passes (cal_prototype.py:75).
The prototypes (C, F) and counts (C,) stay on the device; they are read back
once, at the end.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..data.device_pipeline import device_prefetch
from ..device import resolve_device
from ..kernels.upsample_argmax import upsample_argmax
from ..ops.class_means import (MAX_PROTOTYPE_COUNT, fold_prototypes,
                               masked_class_means)
from ..parallel import mesh as pmesh
from .seg import forward_nhwc, frozen_inference


def make_prototype_step(model, *, num_classes: int, bf16: bool = False,
                        mesh=None):
    """Returns ``step(prototypes, counts, images) -> (prototypes, counts)``
    where ``images`` is the list of the replicas' (N, H, W, C) shares of a
    batch (``device_prefetch(..., mesh=mesh)``) and ``mesh``
    (``parallel/mesh.LocalMesh``, default the model's device alone) holds
    the replicas: each copy of the model gives its rows' per-sample class
    vectors, which are put back in row order on the model's device before
    the fold, so the result is the one-device fold's."""
    device = next(model.parameters()).device
    replicas = pmesh.replicate(pmesh.LocalMesh.of(mesh, device), model)

    def partials(net, images):
        with frozen_inference(net):
            out = forward_nhwc(net, images, bf16=bf16)
            _, h, w, _ = out["out"].shape
            pred, conf = upsample_argmax(out["out"], h, w)
            return masked_class_means(out["feat"], pred, conf,
                                      num_classes=num_classes)

    def step(prototypes, counts, images):
        vectors, valid = pmesh.map_shares(partials, replicas, device, images)
        with torch.inference_mode():
            return fold_prototypes(prototypes, counts, vectors, valid,
                                   mode="mean")

    return step


def calc_prototypes(model, loader, *, num_classes: int = 13,
                    feat_dim: int = 256, epochs: int = 1, max_steps: int = 0,
                    wire: str | None = "packed", mesh=None, device=None,
                    bf16: bool = False) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (prototypes (C, F), counts (C,)) as numpy float32 arrays.

    ``model`` lives on ``device`` (default: the CUDA device; raises without
    one). ``loader`` yields dicts with a numpy ``image`` (N, H, W, C).
    With several processes each folds its own shard
    (``DataLoader(shard=host_shard(), shard_lockstep=False)``) and the
    partials merge after the loop (``merge_process_prototypes``); every
    process returns the merged arrays. ``mesh``
    (``parallel/mesh.LocalMesh``, ``--data_parallel``) splits each batch
    over copies of the model (``make_prototype_step``). ``wire``: the
    batches' transfer (``device_prefetch``).
    """
    device = resolve_device(device)
    mesh = pmesh.LocalMesh.of(mesh, device)
    step = make_prototype_step(model, num_classes=num_classes, bf16=bf16,
                               mesh=mesh)
    prototypes = torch.zeros((num_classes, feat_dim), dtype=torch.float32,
                             device=device)
    counts = torch.zeros((num_classes,), dtype=torch.float32, device=device)
    for epoch in range(epochs):
        images = ({"image": b["image"]} for b in loader)
        for i, batch in enumerate(device_prefetch(images, device,
                                                  mesh=mesh, wire=wire)):
            if max_steps and i >= max_steps:
                break
            prototypes, counts = step(prototypes, counts, batch["image"])
            if i % 10 == 0:
                print(f"epoch [{epoch}], prototype calculation: "
                      f"[{i}/{len(loader)}]")
    if pmesh.process_count() > 1:
        prototypes, counts = (pmesh.all_gather(prototypes),
                              pmesh.all_gather(counts))
    else:
        prototypes, counts = prototypes[None], counts[None]
    return merge_process_prototypes(prototypes.cpu().numpy(),
                                    counts.cpu().numpy())


def merge_process_prototypes(all_prototypes: np.ndarray,
                             all_counts: np.ndarray,
                             max_count: float = MAX_PROTOTYPE_COUNT
                             ) -> Tuple[np.ndarray, np.ndarray]:
    """Combine the per-process partial prototypes (P, C, F) and counts
    (P, C) of a run (``calc_prototypes`` all-gathers them), as the JAX
    ``merge_process_prototypes`` does after its all-gather: the 'mean'
    fold keeps a count-weighted running mean per class, so the global result is ``sum_p(proto_p * n_p) / sum_p(n_p)``;
    the merged counts are clamped to ``max_count``, a count the
    single-process fold could produce. One process: its own arrays."""
    if len(all_prototypes) == 1:
        return all_prototypes[0], all_counts[0]
    total = all_counts.sum(axis=0)                                  # (C,)
    weighted = (all_prototypes * all_counts[..., None]).sum(axis=0)  # (C,F)
    merged = weighted / np.maximum(total, 1.0)[:, None]
    total = np.minimum(total, max_count)
    return (merged.astype(all_prototypes.dtype),
            total.astype(all_counts.dtype))
