"""DeepLabV2-ResNet101 segmenter (counterpart of the JAX ``models/deeplab.py``).

``num_channels`` 1 or 3 selects thermal vs RGB input; ``bn_clr`` adds a
BatchNorm on the 2048-channel feature. Two heads, each returning
``{'feat', 'out'}`` at stride 8: ``DeepLabV2`` carries the GroupNorm + SE
ASPP head (``head='module2'``), ``LegacyDeepLabV2`` the plain ASPP_V2 sum
head of the reference's legacy zoo nets (``head='legacy'``;
semantic_segmentation_models.py:182, thermal_semantic_segmentation_models
.py:186). ``create_deeplab`` builds either. The modules are NCHW and kept
in ``channels_last`` memory format; their state_dicts use the reference
torch keys of each model, so a reference ``.pth`` loads with
``strict=True``.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..device import resolve_device
from ..nn.aspp import ASPPLegacy, ASPPModule2
from ..nn.resnet import BN_EPS, BatchNorm2d, ResNetBackbone


class DeepLabV2(ResNetBackbone):
    """Backbone, optional ``bn_pretrain``, and the ASPP head ``layer5``.

    The backbone's modules sit at the top level of the state_dict (``conv1``,
    ``layer1`` ...), as in the reference model.
    """

    def __init__(self, num_classes: int = 13, num_channels: int = 3,
                 head: str = "module2", bn_clr: bool = False,
                 layers: Sequence[int] = (3, 4, 23, 3), remat: str = "none"):
        if head != "module2":
            raise ValueError(f"DeepLabV2 carries the module2 head, not "
                             f"{head!r} (the legacy head is LegacyDeepLabV2; "
                             f"create_deeplab builds either)")
        super().__init__(layers=layers, num_channels=num_channels,
                         remat=remat)
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


class LegacyDeepLabV2(nn.Module):
    """The legacy DeepLabV2: the backbone under ``backbone`` and the ASPP_V2
    sum head under ``classifier``. Its
    state_dict carries the reference legacy keys (``backbone.*``,
    ``classifier.conv2d_list.{i}.{weight,bias}``), those that the JAX
    package's ``torch_legacy_state_dict_to_flax`` reads. ``'feat'`` is
    the 2048-channel backbone feature, as in the JAX model."""

    def __init__(self, num_classes: int = 19, num_channels: int = 3,
                 layers: Sequence[int] = (3, 4, 23, 3), remat: str = "none"):
        super().__init__()
        self.backbone = ResNetBackbone(layers=layers,
                                       num_channels=num_channels, remat=remat)
        self.classifier = ASPPLegacy(2048, num_classes)

    def init_weights_(self, generator: torch.Generator) -> None:
        self.backbone.init_weights_(generator)
        self.classifier.init_weights_(generator)

    def forward(self, x: torch.Tensor) -> dict:
        """x: (N, C, H, W) -> {'feat': (N, 2048, H/8, W/8),
        'out': (N, num_classes, H/8, W/8)}."""
        feat = self.backbone(x)
        return {"feat": feat, "out": self.classifier(feat)}


def create_deeplab(seed=0, *, device=None, num_classes: int = 13,
                   num_channels: int = 1, head: str = "module2",
                   bn_clr: bool = False,
                   layers: Sequence[int] = (3, 4, 23, 3),
                   remat: str = "none", freeze_bn: bool = False) -> nn.Module:
    """Build the model of ``head`` ('module2': ``DeepLabV2``, 'legacy':
    ``LegacyDeepLabV2``) with weights drawn from ``seed`` (an int or a
    ``torch.Generator``), in eval mode, channels_last, on ``device``
    (default: the CUDA device; raises without one).

    ``remat`` ('none', 'dots', 'full') rematerialises the backbone's
    blocks in the backward pass (``nn/resnet.py``). ``freeze_bn=True`` is
    the reference's ``freeze_bn_func`` and the JAX ``FrozenBNModel``: every
    BatchNorm's weight and bias gets no gradient (so no optimizer moves
    it), while its running statistics still move and a train-mode forward
    still normalises with the batch's statistics (no ``eval()``)."""
    dev = resolve_device(device)
    generator = seed if isinstance(seed, torch.Generator) else \
        torch.Generator().manual_seed(int(seed))
    if head == "legacy":
        if bn_clr:
            raise ValueError("bn_clr is an option of the module2 head")
        model = LegacyDeepLabV2(num_classes=num_classes,
                                num_channels=num_channels,
                                layers=tuple(layers), remat=remat)
    else:
        model = DeepLabV2(num_classes=num_classes, num_channels=num_channels,
                          head=head, bn_clr=bn_clr, layers=tuple(layers),
                          remat=remat)
    model.init_weights_(generator)   # on the CPU: the same weights anywhere
    if freeze_bn:
        freeze_batchnorm_affine(model)
    return model.to(device=dev, memory_format=torch.channels_last).eval()


def freeze_batchnorm_affine(model: nn.Module) -> None:
    """No gradient for any BatchNorm's weight and bias (the GroupNorms of
    the head keep theirs, as the JAX mask selects the modules that own
    batch statistics)."""
    for m in model.modules():
        if isinstance(m, nn.BatchNorm2d) and m.affine:
            m.weight.requires_grad_(False)
            m.bias.requires_grad_(False)


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
