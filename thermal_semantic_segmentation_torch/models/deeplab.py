"""DeepLabV2-ResNet101 segmenter (counterpart of the JAX ``models/deeplab.py``).

``num_channels`` 1 or 3 selects thermal vs RGB input; ``head='module2'`` is
the GroupNorm + SE ASPP head returning ``{'feat', 'out'}`` at stride 8;
``bn_clr`` adds a BatchNorm on the 2048-channel feature. The module is NCHW
and is kept in ``channels_last`` memory format; its state_dict uses the
reference torch keys, so a reference ``.pth`` loads with ``strict=True``.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..device import resolve_device
from ..nn.aspp import ASPPModule2
from ..nn.resnet import BN_EPS, BatchNorm2d, ResNetBackbone


class DeepLabV2(ResNetBackbone):
    """Backbone, optional ``bn_pretrain``, and the ASPP head ``layer5``.

    The backbone's modules sit at the top level of the state_dict (``conv1``,
    ``layer1`` ...), as in the reference model.
    """

    def __init__(self, num_classes: int = 13, num_channels: int = 3,
                 head: str = "module2", bn_clr: bool = False,
                 layers: Sequence[int] = (3, 4, 23, 3)):
        if head == "legacy":
            raise NotImplementedError(
                "head='legacy' is not yet ported (see ROADMAP.md)")
        if head != "module2":
            raise ValueError(f"unknown head {head!r}")
        super().__init__(layers=layers, num_channels=num_channels)
        self.bn_pretrain = BatchNorm2d(2048, eps=BN_EPS) if bn_clr else None
        self.layer5 = ASPPModule2(2048, num_classes)

    def init_weights_(self, generator: torch.Generator) -> None:
        super().init_weights_(generator)   # also resets bn_pretrain
        self.layer5.init_weights_(generator)

    def forward(self, x: torch.Tensor) -> dict:
        """x: (N, C, H, W) -> {'feat': (N, 256, H/8, W/8),
        'out': (N, num_classes, H/8, W/8)}."""
        feat = super().forward(x)
        if self.bn_pretrain is not None:
            feat = self.bn_pretrain(feat)
        return self.layer5(feat)


def create_deeplab(seed=0, *, device=None, num_classes: int = 13,
                   num_channels: int = 1, head: str = "module2",
                   bn_clr: bool = False,
                   layers: Sequence[int] = (3, 4, 23, 3)) -> DeepLabV2:
    """Build the model with weights drawn from ``seed`` (an int or a
    ``torch.Generator``), in eval mode, channels_last, on ``device``
    (default: the CUDA device; raises without one)."""
    dev = resolve_device(device)
    generator = seed if isinstance(seed, torch.Generator) else \
        torch.Generator().manual_seed(int(seed))
    model = DeepLabV2(num_classes=num_classes, num_channels=num_channels,
                      head=head, bn_clr=bn_clr, layers=tuple(layers))
    model.init_weights_(generator)   # on the CPU: the same weights anywhere
    return model.to(device=dev, memory_format=torch.channels_last).eval()


HEAD_MODULES = ("layer5", "bn_pretrain")


def backbone_and_head_params(model: nn.Module):
    """Split ``model.named_parameters()`` into (backbone, head) lists: the
    reference's optim_parameters split, as the JAX package's
    ``backbone_and_head_masks`` makes it. ``conv1``, ``bn1`` and
    ``layer1``-``layer4`` train at the base lr; ``layer5`` (the ASPP head)
    and ``bn_pretrain`` at the head's multiple."""
    backbone, head = [], []
    for name, p in model.named_parameters():
        (head if name.split(".")[0] in HEAD_MODULES else backbone).append(p)
    return backbone, head
