"""Pooling with PyTorch edge semantics (counterpart of the JAX ``ops/pool.py``)."""

from __future__ import annotations

import torch


def ceil_max_pool(window: int = 3, stride: int = 2,
                  padding: int = 1) -> "MaxPool2d":
    """MaxPool2d with ceil mode, as the DeepLab stem uses it (NCHW); it
    also runs on width-sharded maps (``nn/spatial.py``).

    Ceil mode changes the output grid (128 -> 65 rows), which the checkpoint
    layout depends on. (``nn/spatial.py`` is imported here: ``nn``'s
    ResNet imports this module.)
    """
    from ..nn.spatial import MaxPool2d

    return MaxPool2d(window, stride, padding, ceil_mode=True)


def max_pool_ceil(x_nhwc: torch.Tensor, window: int = 3, stride: int = 2,
                  padding: int = 1) -> torch.Tensor:
    """MaxPool2d(window, stride, padding, ceil_mode=True) on NHWC input."""
    pool = ceil_max_pool(window, stride, padding)
    return pool(x_nhwc.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


def global_avg_pool(x_nhwc: torch.Tensor) -> torch.Tensor:
    """AdaptiveAvgPool2d((1, 1)) of NHWC ``x``: the (N, C) means over
    (H, W)."""
    return x_nhwc.mean(dim=(1, 2))
