"""The ASPP heads of DeepLabV2 (counterpart of the JAX ``nn/aspp.py``):
the GroupNorm + SE head ``ASPPModule2`` and the legacy sum head
``ASPPLegacy``.

ASPPModule2:

1x1 + four dilated 3x3 branches -> 256 channels each with GroupNorm(32) and
ReLU, channel concat, SE gate, 3x3 bottleneck conv + GroupNorm, channel
dropout (training only, drawn from an explicit generator), 1x1 classifier
without bias. Returns both the 256-channel
pre-classifier feature ('feat') and the logits ('out'). Submodule names give
the reference state_dict keys: ``conv2d_list.{i}.{0,1}``,
``bottleneck.{0.se.0, 0.se.2, 1, 2}`` and ``head.1``.

ASPPLegacy (ASPP_V2, the reference's zoo nets): four dilated 3x3 convs
with biases straight to the logits, summed; keys ``conv2d_list.{i}``.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from .spatial import Conv2d, GroupNorm, WidthSharded, spatial_mean

GN_EPS = 1e-5
GN_GROUPS = 32
BRANCH_WIDTH = 256
DILATIONS = (6, 12, 18, 24)
DROPRATE = 0.1
HEAD_STD = 0.001
# the standard deviation of a unit normal cut at +-2 (jax.nn.initializers)
TRUNCATED_NORMAL_STD = .87962566103423978
LEGACY_STD = 0.01
# The branches run on at most this many feature-map pixels (N * H * W) per
# call. Past about 22,000 (H100, cuDNN 9.2, float32), cuDNN leaves its
# implicit-GEMM kernel for the 2048-channel dilated 3x3 convs for a direct
# one ~46x slower per image (chip_smoke.py prints both). The branches
# treat each image alone, so splitting the batch changes no result; a
# batch of 8 at 256x512 (33x65 maps) stays one call.
MAX_BRANCH_PIXELS = 8 * 33 * 65


def split_branches(branches, x: torch.Tensor, layout=None) -> torch.Tensor:
    """``branches(x)``, in parts of the batch of at most
    ``MAX_BRANCH_PIXELS`` map pixels each when ``x`` is larger. On a
    width-sharded map (``layout``) the pixels are those of the widest
    shard, so that every rank of the spatial group takes as many parts
    (each part runs the branches' exchanges)."""
    width = x.shape[3] if layout is None else -(-layout.width_of(x)
                                                 // layout.size)
    per_call = max(1, MAX_BRANCH_PIXELS // (x.shape[2] * width))
    if x.shape[0] > per_call:
        return torch.cat([branches(part) for part in x.split(per_call)])
    return branches(x)


class Dropout2d(nn.Module):
    """Train-mode dropout of whole channels (p = ``DROPRATE``), as the JAX
    package's ``nn.Dropout(broadcast_dims=(1, 2))``: kept channels scale by
    1/(1-p). The mask comes from ``generator``, a ``torch.Generator`` on the
    input's device that the train step seeds before each forward; a
    train-mode forward without one raises. Setting ``p`` to 0 switches it
    off (the parity tests do). It has no parameters, so ``head.1`` stays
    the classifier's key."""

    def __init__(self, p: float = DROPRATE):
        super().__init__()
        self.p = p
        self.generator = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.p == 0.0:
            return x
        if self.generator is None:
            raise RuntimeError("train-mode dropout needs a seeded generator "
                               "(train.seg.seed_dropout)")
        keep = 1.0 - self.p
        mask = torch.rand(x.shape[:2], generator=self.generator,
                          device=x.device) < keep
        return torch.where(mask[:, :, None, None], x / keep, 0.0)


class SEBlock(WidthSharded, nn.Module):
    """Squeeze-and-excitation channel gate (its mean over the full width
    of a width-sharded map)."""

    def __init__(self, channels: int, reduction: int = 16):
        super().__init__()
        self.se = nn.Sequential(
            nn.Linear(channels, channels // reduction), nn.ReLU(inplace=True),
            nn.Linear(channels // reduction, channels), nn.Sigmoid())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = self.se(spatial_mean(x, self.spatial))
        return x * s[:, :, None, None]


class ASPPModule2(WidthSharded, nn.Module):

    def __init__(self, in_channels: int, num_classes: int):
        super().__init__()

        def branch(kernel: int, d: int) -> nn.Sequential:
            pad = d if kernel == 3 else 0
            return nn.Sequential(
                Conv2d(in_channels, BRANCH_WIDTH, kernel, padding=pad,
                       dilation=d, bias=True),
                GroupNorm(GN_GROUPS, BRANCH_WIDTH, eps=GN_EPS),
                nn.ReLU(inplace=True))

        self.conv2d_list = nn.ModuleList(
            [branch(1, 1)] + [branch(3, d) for d in DILATIONS])
        concat = BRANCH_WIDTH * (len(DILATIONS) + 1)
        self.bottleneck = nn.Sequential(
            SEBlock(concat),
            Conv2d(concat, BRANCH_WIDTH, 3, padding=1, bias=True),
            GroupNorm(GN_GROUPS, BRANCH_WIDTH, eps=GN_EPS))
        self.head = nn.Sequential(
            Dropout2d(DROPRATE),
            Conv2d(BRANCH_WIDTH, num_classes, 1, bias=False))

    def init_weights_(self, generator: torch.Generator) -> None:
        """As the JAX head: flax's ``kaiming_normal`` branch/bottleneck
        convs, its default ``lecun_normal`` SE layers, zero biases and an
        N(0, 0.001) classifier."""
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                _variance_scaling_(m.weight, 2.0, generator)
                if m.bias is not None:
                    nn.init.zeros_(m.bias)
            elif isinstance(m, nn.Linear):
                _variance_scaling_(m.weight, 1.0, generator)
                nn.init.zeros_(m.bias)
            elif isinstance(m, nn.GroupNorm):
                nn.init.ones_(m.weight)
                nn.init.zeros_(m.bias)
        nn.init.normal_(self.head[1].weight, 0.0, HEAD_STD,
                        generator=generator)

    def branches(self, x: torch.Tensor) -> torch.Tensor:
        """The five branches' outputs, concatenated along channels."""
        return torch.cat([b(x) for b in self.conv2d_list], dim=1)

    def forward(self, x: torch.Tensor) -> dict:
        feat = self.head[0](self.bottleneck(split_branches(
            self.branches, x, self.spatial)))
        return {"feat": feat, "out": self.head[1](feat)}


def _variance_scaling_(weight: torch.Tensor, scale: float,
                       generator: torch.Generator) -> None:
    """flax's ``variance_scaling(scale, 'fan_in', 'truncated_normal')``: a
    normal cut at two of its standard deviations, scaled so that the
    result's variance is ``scale / fan_in``: unit normals past the cut
    are dropped and more drawn until there are enough (the inverse CDF of
    ``nn.init.trunc_normal_`` takes over twice as long on the CPU, where
    the models are built)."""
    std = math.sqrt(scale / weight[0].numel()) / TRUNCATED_NORMAL_STD
    n = weight.numel()
    kept = []
    while sum(k.numel() for k in kept) < n:
        z = torch.randn(n + n // 16 + 16, generator=generator,
                        dtype=weight.dtype)
        kept.append(z[z.abs() <= 2.0])
    with torch.no_grad():
        weight.copy_(torch.cat(kept)[:n].view_as(weight).mul_(std))


class ASPPLegacy(nn.Module):
    """The sum of four dilated 3x3 convs, ``in_channels`` -> the logits,
    at dilations 6/12/18/24 (JAX ``nn/aspp.py::ASPPLegacy``), summed in
    the reference's order; the branches split as ``ASPPModule2``'s."""

    def __init__(self, in_channels: int, num_classes: int):
        super().__init__()
        self.conv2d_list = nn.ModuleList(
            Conv2d(in_channels, num_classes, 3, padding=d, dilation=d,
                   bias=True) for d in DILATIONS)

    def init_weights_(self, generator: torch.Generator) -> None:
        """N(0, 0.01) kernels and zero biases, as the JAX head."""
        for m in self.conv2d_list:
            nn.init.normal_(m.weight, 0.0, LEGACY_STD, generator=generator)
            nn.init.zeros_(m.bias)

    def branches(self, x: torch.Tensor) -> torch.Tensor:
        out = self.conv2d_list[0](x)
        for conv in self.conv2d_list[1:]:
            out = out + conv(x)
        return out

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return split_branches(self.branches, x)
