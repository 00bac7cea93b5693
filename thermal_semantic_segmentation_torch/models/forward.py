"""The eval forwards of the two kinds of net, on NHWC float32 images, as the
inference server runs them (``serving/``) and as ``core/export.py`` traces
them into an artifact: one body each, so the live and the exported function
cannot drift apart.
"""

from __future__ import annotations

import torch

from ..kernels.upsample_argmax import upsample_argmax
from ..ops.resize import upsample_logits


def seg_forward(model, images: torch.Tensor, label_hw, output: str = "ids",
                bf16: bool = False) -> torch.Tensor:
    """The eval protocol of the DeepLab ``model``: NHWC float32 ``images``
    -> ``output`` 'ids' ((n, *label_hw) uint8 classes from the
    ``upsample_argmax`` kernel) or 'logits' ((n, *label_hw, C) float32
    align-corners upsampled logits). ``bf16``: the net under bfloat16
    autocast; the logits leave it as float32."""
    with torch.autocast(images.device.type, dtype=torch.bfloat16,
                        enabled=bf16):
        out = model(images.permute(0, 3, 1, 2))["out"]
    # channels_last NCHW logits viewed as NHWC: no copy
    logits = out.float().permute(0, 2, 3, 1)
    if output == "logits":
        return upsample_logits(logits, *label_hw)
    pred, _ = upsample_argmax(logits, *label_hw)
    # uint8 ids: 4x fewer bytes on the device->host copy
    return pred.to(torch.uint8)


def generator_forward(model, images: torch.Tensor,
                      bf16: bool = False) -> torch.Tensor:
    """A GAN generator's eval forward: NHWC normalised ``images`` -> NHWC
    float32 images in the tanh range (bfloat16 autocast with ``bf16``)."""
    with torch.autocast(images.device.type, dtype=torch.bfloat16,
                        enabled=bf16):
        out = model(images.permute(0, 3, 1, 2))
    return out.float().permute(0, 2, 3, 1)
