"""Dilated ResNet-101 backbone for DeepLabV2 (NCHW modules, run channels_last).

Counterpart of the JAX ``nn/resnet.py``: 7x7/2 stem, ceil-mode 3x3/2
maxpool, bottleneck stages with stride 2 only in layer2 and dilations 2/4 in
layers 3/4 (output stride 8). The stem is the plain 7x7 stride-2 conv; the
JAX package's space-to-depth rewrite of it exists only for the TPU.
Submodule names give the reference state_dict keys
(``layerS.B.{conv,bn}k``, ``layerS.B.downsample.{0,1}``).

``remat`` rematerialises the bottleneck blocks in the backward pass, as the
JAX backbone's ``remat`` does: 'none' keeps every activation; 'dots' keeps
the convolution outputs and recomputes BatchNorm and ReLU (the selective
checkpoint policy that is ``jax.checkpoint_policies.dots_saveable``);
'full' keeps only each block's input and recomputes the block. A
recomputed BatchNorm normalises as the first pass did and folds nothing
into its running statistics: flax's remat is functional and folds them
once a step, and so does this.
"""

from __future__ import annotations

import contextlib
from typing import Sequence

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..ops.pool import ceil_max_pool
from ..parallel.spatial import group_sum
from .spatial import Conv2d

BN_EPS = 1e-5
CONV_STD = 0.01
# (planes, stride, dilation) of the four stages
STAGES = ((64, 1, 1), (128, 2, 1), (256, 1, 2), (512, 1, 4))


REMAT_MODES = ("none", "dots", "full")
# the ops whose outputs 'dots' keeps: the convolutions and matmuls
_DOTS = (torch.ops.aten.convolution.default, torch.ops.aten.mm.default,
         torch.ops.aten.addmm.default, torch.ops.aten.bmm.default)
# > 0 while a checkpointed block recomputes its forward in the backward pass
_recomputing = 0


@contextlib.contextmanager
def _recompute(inner):
    """``inner`` (the checkpoint's recomputation context), with the
    BatchNorm buffer updates switched off inside it."""
    global _recomputing
    _recomputing += 1
    try:
        with inner:
            yield
    finally:
        _recomputing -= 1


def _dots_saveable(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat_contexts(remat: str):
    """``checkpoint``'s ``context_fn`` for ``remat``: (the first pass's
    context, the recomputation's)."""
    if remat == "dots":
        first, again = create_selective_checkpoint_contexts(_dots_saveable)
    else:
        first, again = contextlib.nullcontext(), contextlib.nullcontext()
    return first, _recompute(again)


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` whose running variance follows flax's
    ``nn.BatchNorm``: a train-mode forward folds the BIASED batch variance
    into ``running_var`` (torch folds the unbiased one, n/(n-1) larger).

    The normalisation stays ``F.batch_norm``'s (cuDNN on the card). It
    folds into copies of the 2C old values, which autograd keeps; the
    buffers then get the mean's copy and
    ``(1-m) * old + (copy - (1-m) * old) * (n-1)/n``: O(C) work. The
    state_dict keys are ``nn.BatchNorm2d``'s. With ``track_running_stats``
    set False, a train-mode forward normalises with the batch's statistics
    and leaves every buffer as it was. A forward recomputed by a
    checkpointed block (``remat``) updates no buffer.

    ``sync_group``, set by the train steps under a mesh
    (``synchronised``), is a process group whose ranks' batches are
    normalised as one in train mode: the per-channel sums, sums of squares
    and counts are all-reduced (differentiably), and the biased global
    variance ``E[x^2] - E[x]^2`` is used, and folded where the layer tracks
    its statistics, as flax computes it over the global batch. The
    normalisation is ``x * scale + shift`` with per-channel ``scale`` and
    ``shift`` (``_normalise``), whose backward keeps no full-size tensor
    but ``x``, which the sum of squares keeps already (cuDNN's BatchNorm
    keeps none). With one rank it changes nothing.
    """

    sync_group = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        group = self.sync_group
        if group is not None and dist.get_world_size(group) > 1:
            return self._synchronised(x, group)
        if not self.track_running_stats:
            return super().forward(x)
        m = self.momentum
        mean = self.running_mean.clone()
        folded = self.running_var.clone()
        y = F.batch_norm(x, mean, folded, self.weight, self.bias, True, m,
                         self.eps)
        if not _recomputing:
            n = x.numel() // x.shape[1]
            with torch.no_grad():
                self.num_batches_tracked.add_(1)
                self.running_mean.copy_(mean)
                self.running_var.mul_(1.0 - m).add_(
                    (folded - self.running_var) * ((n - 1) / n))
        return y

    def _synchronised(self, x: torch.Tensor, group) -> torch.Tensor:
        c = x.shape[1]
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        local = torch.cat([xf.sum((0, 2, 3)), (xf * xf).sum((0, 2, 3)),
                           xf.new_full((1,), x.numel() // c)])
        total = group_sum(local, group)
        n = total[-1]
        mean = total[:c] / n
        var = (total[c:2 * c] / n - mean * mean).clamp_min(0.0)
        y = _normalise(xf, mean, var, self.eps, self.weight, self.bias)
        if self.track_running_stats and not _recomputing:
            m = self.momentum
            with torch.no_grad():
                self.num_batches_tracked.add_(1)
                self.running_mean.mul_(1.0 - m).add_(m * mean.detach())
                self.running_var.mul_(1.0 - m).add_(m * var.detach())
        return y.to(x.dtype)


def _normalise(xf, mean, var, eps, weight, bias):
    """``(xf - mean) * rsqrt(var + eps) * weight + bias`` per channel, as
    ``xf * scale + shift``: its backward keeps ``xf`` and per-channel
    vectors, and no full-size intermediate."""
    scale = torch.rsqrt(var + eps)
    if weight is not None:
        scale = scale * weight
    shift = -mean * scale
    if bias is not None:
        shift = shift + bias
    shape = (1, -1, 1, 1)
    return torch.addcmul(shift.view(shape), xf, scale.view(shape))


@contextlib.contextmanager
def synchronised(modules, group):
    """Every ``BatchNorm2d`` of ``modules`` normalises over ``group``'s
    global batch inside the block (no change with ``group`` None)."""
    norms = [m for net in modules for m in net.modules()
             if isinstance(m, BatchNorm2d)]
    for m in norms:
        m.sync_group = group
    try:
        yield
    finally:
        for m in norms:
            m.sync_group = None


class Bottleneck(nn.Module):
    """1x1(stride) -> 3x3(dilated) -> 1x1(x4), plus an optional downsample.

    The stride sits on the first 1x1 conv, not on the 3x3, as in the
    reference.
    """

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 dilation: int = 1, downsample: bool = False):
        super().__init__()
        d = dilation
        self.conv1 = Conv2d(inplanes, planes, 1, stride=stride, bias=False)
        self.bn1 = BatchNorm2d(planes, eps=BN_EPS)
        self.conv2 = Conv2d(planes, planes, 3, padding=d, dilation=d,
                            bias=False)
        self.bn2 = BatchNorm2d(planes, eps=BN_EPS)
        self.conv3 = Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = BatchNorm2d(planes * 4, eps=BN_EPS)
        self.relu = nn.ReLU(inplace=True)
        self.downsample = nn.Sequential(
            Conv2d(inplanes, planes * 4, 1, stride=stride, bias=False),
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
                 num_channels: int = 3, remat: str = "none"):
        super().__init__()
        if remat not in REMAT_MODES:
            raise ValueError(f"unknown remat mode {remat!r}")
        self.remat = remat
        self.conv1 = Conv2d(num_channels, 64, 7, stride=2, padding=3,
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
        for stage in (self.layer1, self.layer2, self.layer3, self.layer4):
            for block in stage:
                if self.remat == "none" or not torch.is_grad_enabled():
                    x = block(x)
                else:
                    # the backbone draws no random numbers: no RNG state
                    # to carry into the recomputation
                    x = checkpoint(block, x, use_reentrant=False,
                                   preserve_rng_state=False,
                                   context_fn=lambda: _remat_contexts(
                                       self.remat))
        return x
