"""Normalisation layers of the GAN nets (counterpart of the JAX
``nn/norms.py``; reference utils/misc.py:80-97).

'batch'    -> ``nn/resnet.BatchNorm2d``: affine, running statistics with
              torch momentum 0.1 and flax's biased running variance
'instance' -> ``InstanceNorm2d``: no affine, no running statistics
'none'     -> identity; the convs then carry a bias
"""

from __future__ import annotations

from typing import Callable, Tuple

from torch import nn

from .resnet import BatchNorm2d

BN_MOMENTUM = 0.1
BN_EPS = 1e-5


def make_norm(norm: str) -> Tuple[Callable[[int], nn.Module], bool]:
    """(factory(channels) -> layer, use_bias for the convs)."""
    if norm == "batch":
        return (lambda c: BatchNorm2d(c, eps=BN_EPS, momentum=BN_MOMENTUM),
                False)
    if norm == "instance":
        return (lambda c: nn.InstanceNorm2d(c, eps=BN_EPS, affine=False),
                True)
    if norm == "none":
        return (lambda c: nn.Identity()), True
    raise NotImplementedError(f"normalization layer [{norm}] is not found")
