"""Dilated ResNet-101 backbone for DeepLabV2 (NCHW modules, run channels_last).

Counterpart of the JAX ``nn/resnet.py``: 7x7/2 stem, ceil-mode 3x3/2
maxpool, bottleneck stages with stride 2 only in layer2 and dilations 2/4 in
layers 3/4 (output stride 8). The stem is the plain 7x7 stride-2 conv; the
JAX package's space-to-depth rewrite of it exists only for the TPU.
Submodule names give the reference state_dict keys
(``layerS.B.{conv,bn}k``, ``layerS.B.downsample.{0,1}``).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.pool import ceil_max_pool

BN_EPS = 1e-5
CONV_STD = 0.01
# (planes, stride, dilation) of the four stages
STAGES = ((64, 1, 1), (128, 2, 1), (256, 1, 2), (512, 1, 4))


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` whose running variance follows flax's
    ``nn.BatchNorm``: a train-mode forward folds the BIASED batch variance
    into ``running_var`` (torch folds the unbiased one, n/(n-1) larger).

    The normalisation stays ``F.batch_norm``'s (cuDNN on the card). It
    folds into a copy of the C old values, which autograd keeps, and the
    buffer then gets ``(1-m) * old + (copy - (1-m) * old) * (n-1)/n``: O(C)
    work. The state_dict keys are ``nn.BatchNorm2d``'s. With
    ``track_running_stats`` set False, a train-mode forward normalises with
    the batch's statistics and leaves every buffer as it was.
    """

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not (self.training and self.track_running_stats):
            return super().forward(x)
        self.num_batches_tracked.add_(1)
        m = self.momentum
        folded = self.running_var.clone()
        y = F.batch_norm(x, self.running_mean, folded, self.weight, self.bias,
                         True, m, self.eps)
        n = x.numel() // x.shape[1]
        with torch.no_grad():
            self.running_var.mul_(1.0 - m).add_(
                (folded - self.running_var) * ((n - 1) / n))
        return y


class Bottleneck(nn.Module):
    """1x1(stride) -> 3x3(dilated) -> 1x1(x4), plus an optional downsample.

    The stride sits on the first 1x1 conv, not on the 3x3, as in the
    reference.
    """

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 dilation: int = 1, downsample: bool = False):
        super().__init__()
        d = dilation
        self.conv1 = nn.Conv2d(inplanes, planes, 1, stride=stride, bias=False)
        self.bn1 = BatchNorm2d(planes, eps=BN_EPS)
        self.conv2 = nn.Conv2d(planes, planes, 3, padding=d, dilation=d,
                               bias=False)
        self.bn2 = BatchNorm2d(planes, eps=BN_EPS)
        self.conv3 = nn.Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = BatchNorm2d(planes * 4, eps=BN_EPS)
        self.relu = nn.ReLU(inplace=True)
        self.downsample = nn.Sequential(
            nn.Conv2d(inplanes, planes * 4, 1, stride=stride, bias=False),
            BatchNorm2d(planes * 4, eps=BN_EPS)) if downsample else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        residual = x if self.downsample is None else self.downsample(x)
        y = self.relu(self.bn1(self.conv1(x)))
        y = self.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        return self.relu(y + residual)


class ResNetBackbone(nn.Module):
    """Stem + four bottleneck stages; NCHW in, the stride-8 2048-channel
    feature map out."""

    def __init__(self, layers: Sequence[int] = (3, 4, 23, 3),
                 num_channels: int = 3):
        super().__init__()
        self.conv1 = nn.Conv2d(num_channels, 64, 7, stride=2, padding=3,
                               bias=False)
        self.bn1 = BatchNorm2d(64, eps=BN_EPS)
        self.relu = nn.ReLU(inplace=True)
        self.maxpool = ceil_max_pool(3, 2, 1)
        inplanes = 64
        for si, ((planes, stride, dilation), blocks) in enumerate(
                zip(STAGES, layers), start=1):
            # the reference's downsample condition includes dilation 2/4
            needs_ds = (stride != 1 or inplanes != planes * 4
                        or dilation in (2, 4))
            stage = []
            for bi in range(blocks):
                stage.append(Bottleneck(
                    inplanes if bi == 0 else planes * 4, planes,
                    stride=stride if bi == 0 else 1, dilation=dilation,
                    downsample=needs_ds and bi == 0))
            setattr(self, f"layer{si}", nn.Sequential(*stage))
            inplanes = planes * 4

    def init_weights_(self, generator: torch.Generator) -> None:
        """Backbone init: N(0, 0.01) convs, unit/zero BatchNorm."""
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                nn.init.normal_(m.weight, 0.0, CONV_STD, generator=generator)
            elif isinstance(m, nn.BatchNorm2d):
                nn.init.ones_(m.weight)
                nn.init.zeros_(m.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.maxpool(self.relu(self.bn1(self.conv1(x))))
        return self.layer4(self.layer3(self.layer2(self.layer1(x))))
