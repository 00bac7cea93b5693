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
from ..ops.class_means import (MAX_PROTOTYPE_COUNT, fold_prototypes,
                               masked_class_means)
from .seg import forward_nhwc, frozen_inference


def make_prototype_step(model, *, num_classes: int, bf16: bool = False):
    """Returns ``step(prototypes, counts, images) -> (prototypes, counts)``
    for (N, H, W, C) ``images`` on the model's device."""

    def step(prototypes, counts, images):
        with frozen_inference(model):
            out = forward_nhwc(model, images, bf16=bf16)
            vectors, valid = masked_class_means(out["feat"], out["out"],
                                                num_classes=num_classes)
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
    ``mesh`` (multi-GPU) and ``wire='packed_bf16'`` are not yet ported.
    """
    if mesh is not None:
        raise NotImplementedError(
            "mesh (multi-GPU prototypes) is not yet ported to the PyTorch "
            "package (see ROADMAP.md)")
    if wire == "packed_bf16":
        raise NotImplementedError(
            "wire='packed_bf16' is not yet ported to the PyTorch package "
            "(see ROADMAP.md)")
    device = resolve_device(device)
    step = make_prototype_step(model, num_classes=num_classes, bf16=bf16)
    prototypes = torch.zeros((num_classes, feat_dim), dtype=torch.float32,
                             device=device)
    counts = torch.zeros((num_classes,), dtype=torch.float32, device=device)
    for epoch in range(epochs):
        images = ({"image": b["image"]} for b in loader)
        for i, batch in enumerate(device_prefetch(images, device)):
            if max_steps and i >= max_steps:
                break
            prototypes, counts = step(prototypes, counts, batch["image"])
            if i % 10 == 0:
                print(f"epoch [{epoch}], prototype calculation: "
                      f"[{i}/{len(loader)}]")
    # the port runs one process: its partials are the gathered ones (the
    # all-gather across processes comes with multi-GPU)
    return merge_process_prototypes(prototypes.cpu().numpy()[None],
                                    counts.cpu().numpy()[None])


def merge_process_prototypes(all_prototypes: np.ndarray,
                             all_counts: np.ndarray,
                             max_count: float = MAX_PROTOTYPE_COUNT
                             ) -> Tuple[np.ndarray, np.ndarray]:
    """Combine the per-process partial prototypes (P, C, F) and counts
    (P, C) of a run, as the JAX ``merge_process_prototypes`` does after its
    all-gather: the 'mean' fold keeps a count-weighted running mean per
    class, so the global result is ``sum_p(proto_p * n_p) / sum_p(n_p)``;
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
