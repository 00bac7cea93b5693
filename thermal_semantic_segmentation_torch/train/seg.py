"""Segmentation steps (counterpart of the JAX ``train/seg.py``; the eval step
so far, the train step comes with the training slice)."""

from __future__ import annotations

import torch

from ..device import resolve_device
from ..kernels.upsample_argmax import upsample_argmax
from ..losses import cross_entropy
from ..ops.confmat import confusion_matrix
from ..ops.resize import upsample_logits


def build_seg_eval_step(*, num_classes: int, ignore_index: int, device=None,
                        bf16: bool = False):
    """Returns ``eval_step(model, image, label) -> (hist, loss, pred)`` on
    ``device`` (default: the CUDA device; raises without one).

    ``image`` is (N, H, W, C) float32 and ``label`` (N, H, W) int, both on
    the device. The forward runs in inference mode (under bfloat16 autocast
    with ``bf16``); its stride-8 logits are upsampled to the label's own
    (H, W). ``loss`` is the CE over the upsampled logits; ``pred`` (N, H, W)
    int32 comes from the fused ``upsample_argmax`` kernel on the stride-8
    logits (its plain version on the CPU); ``hist`` is the int64 (C, C)
    confusion matrix of the batch. Nothing is copied to the host.
    """
    device = resolve_device(device)

    def eval_step(model, image: torch.Tensor, label: torch.Tensor):
        out_h, out_w = label.shape[1:3]
        with torch.inference_mode():
            with torch.autocast(device.type, dtype=torch.bfloat16,
                                enabled=bf16):
                out = model(image.permute(0, 3, 1, 2))["out"]
            # channels_last NCHW logits viewed as NHWC: no copy
            logits = out.float().permute(0, 2, 3, 1)
            loss = cross_entropy(upsample_logits(logits, out_h, out_w), label,
                                 ignore_index=ignore_index)
            pred, _ = upsample_argmax(logits, out_h, out_w)
            hist = confusion_matrix(pred, label, num_classes)
        return hist, loss, pred

    return eval_step
