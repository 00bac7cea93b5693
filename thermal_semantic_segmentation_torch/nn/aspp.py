"""The GroupNorm + SE ASPP head of DeepLabV2 (counterpart of the JAX
``nn/aspp.py::ASPPModule2``).

1x1 + four dilated 3x3 branches -> 256 channels each with GroupNorm(32) and
ReLU, channel concat, SE gate, 3x3 bottleneck conv + GroupNorm, channel
dropout (training only, drawn from an explicit generator), 1x1 classifier
without bias. Returns both the 256-channel
pre-classifier feature ('feat') and the logits ('out'). Submodule names give
the reference state_dict keys: ``conv2d_list.{i}.{0,1}``,
``bottleneck.{0.se.0, 0.se.2, 1, 2}`` and ``head.1``.
"""

from __future__ import annotations

import torch
from torch import nn

GN_EPS = 1e-5
GN_GROUPS = 32
BRANCH_WIDTH = 256
DILATIONS = (6, 12, 18, 24)
DROPRATE = 0.1
HEAD_STD = 0.001
# The branches run on at most this many feature-map pixels (N * H * W) per
# call. Past about 22,000 (H100, cuDNN 9.2, float32), cuDNN leaves its
# implicit-GEMM kernel for the 2048-channel dilated 3x3 convs for a direct
# one ~46x slower per image (chip_smoke.py prints both). The branches
# treat each image alone, so splitting the batch changes no result; a
# batch of 8 at 256x512 (33x65 maps) stays one call.
MAX_BRANCH_PIXELS = 8 * 33 * 65


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


class SEBlock(nn.Module):
    """Squeeze-and-excitation channel gate."""

    def __init__(self, channels: int, reduction: int = 16):
        super().__init__()
        self.se = nn.Sequential(
            nn.Linear(channels, channels // reduction), nn.ReLU(inplace=True),
            nn.Linear(channels // reduction, channels), nn.Sigmoid())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = self.se(x.mean(dim=(2, 3)))
        return x * s[:, :, None, None]


class ASPPModule2(nn.Module):

    def __init__(self, in_channels: int, num_classes: int):
        super().__init__()

        def branch(kernel: int, d: int) -> nn.Sequential:
            pad = d if kernel == 3 else 0
            return nn.Sequential(
                nn.Conv2d(in_channels, BRANCH_WIDTH, kernel, padding=pad,
                          dilation=d, bias=True),
                nn.GroupNorm(GN_GROUPS, BRANCH_WIDTH, eps=GN_EPS),
                nn.ReLU(inplace=True))

        self.conv2d_list = nn.ModuleList(
            [branch(1, 1)] + [branch(3, d) for d in DILATIONS])
        concat = BRANCH_WIDTH * (len(DILATIONS) + 1)
        self.bottleneck = nn.Sequential(
            SEBlock(concat),
            nn.Conv2d(concat, BRANCH_WIDTH, 3, padding=1, bias=True),
            nn.GroupNorm(GN_GROUPS, BRANCH_WIDTH, eps=GN_EPS))
        self.head = nn.Sequential(
            Dropout2d(DROPRATE),
            nn.Conv2d(BRANCH_WIDTH, num_classes, 1, bias=False))

    def init_weights_(self, generator: torch.Generator) -> None:
        """Kaiming-normal branch/bottleneck convs, N(0, 0.001) classifier."""
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                nn.init.kaiming_normal_(m.weight, nonlinearity="relu",
                                        generator=generator)
                if m.bias is not None:
                    nn.init.zeros_(m.bias)
            elif isinstance(m, nn.Linear):
                nn.init.normal_(m.weight, 0.0, 0.01, generator=generator)
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
        per_call = max(1, MAX_BRANCH_PIXELS // (x.shape[2] * x.shape[3]))
        if x.shape[0] > per_call:
            y = torch.cat([self.branches(part)
                           for part in x.split(per_call)])
        else:
            y = self.branches(x)
        feat = self.head[0](self.bottleneck(y))
        return {"feat": feat, "out": self.head[1](feat)}
