"""Layers that run on a map whose width is split over the ranks of a
spatial group (``parallel/spatial.py``), and the context that switches
them on.

Each is the stock layer (the state_dict keys are ``nn.Conv2d``'s,
``nn.MaxPool2d``'s, ``nn.GroupNorm``'s) until ``width_sharded`` gives it a
``SpatialLayout``; then:

- ``Conv2d`` and ``MaxPool2d`` compute this rank's output columns
  ``[lo, hi)`` of the global output grid. They fetch the input columns
  ``[lo*s - p, (hi-1)*s - p + d*(k-1)]`` through the exchange (outside the
  map: 0 for the convolution, -inf for the pool) and run with no width
  padding; the height, never split, keeps its padding. The output grid
  comes from the global width (a ceil-mode pool maps 256 columns to 129
  whatever the shards hold). A rank with no output column computes one
  and keeps none, so that every rank runs the same exchanges.
- ``GroupNorm`` normalises each sample's groups with statistics over the
  full width: local sums and sums of squares, summed over the group, and
  the variance ``E[x^2] - E[x]^2`` (flax's, which the JAX package uses).
- ``spatial_mean`` is the mean over (H, W) of the full width.

``WidthSharded`` marks the modules that take a layout (``ASPPModule2``
and its SE gate too, in ``nn/aspp.py``).
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.spatial import (SpatialLayout, column_range, gather_columns,
                                group_sum)


class WidthSharded:
    """A module that runs on width-sharded maps while ``spatial`` (a
    ``SpatialLayout``) is set."""

    spatial = None


@contextlib.contextmanager
def width_sharded(modules, layout):
    """Every ``WidthSharded`` module of ``modules`` runs on the shards of
    ``layout`` inside the block (no change with ``layout`` None)."""
    marked = [m for net in modules for m in net.modules()
              if isinstance(m, WidthSharded)]
    for m in marked:
        m.spatial = layout
    try:
        yield
    finally:
        for m in marked:
            m.spatial = None


def _out_width(width: int, k: int, s: int, p: int, d: int,
               ceil_mode: bool) -> int:
    """PyTorch's output size of a window op along one axis."""
    span = width + 2 * p - d * (k - 1) - 1
    out = (-(-span // s) if ceil_mode else span // s) + 1
    if ceil_mode and (out - 1) * s >= width + p:
        out -= 1
    return out


def window_columns(x: torch.Tensor, layout: SpatialLayout, k: int, s: int,
                   p: int, d: int, pad: float, ceil_mode: bool = False):
    """(input columns of this rank's output columns, the count of those
    output columns, the global output width) of a width-``k`` window op
    with stride ``s``, padding ``p`` and dilation ``d`` on the shard
    ``x``. The columns come padded and exchanged: the op runs on them
    with no width padding and gives at least the count asked for."""
    width = layout.width_of(x)
    out = _out_width(width, k, s, p, d, ceil_mode)
    ranges = []
    for q in range(layout.size):
        lo, hi = column_range(out, layout.size, q)
        a = lo * s - p
        ranges.append((a, a + (max(hi - lo, 1) - 1) * s + d * (k - 1) + 1))
    lo, hi = layout.columns(out)
    return gather_columns(x, layout, width, ranges, pad), hi - lo, out


class Conv2d(WidthSharded, nn.Conv2d):
    """``nn.Conv2d`` that runs on width-sharded maps (see the module
    docstring); zero padding only."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        layout = self.spatial
        if layout is None:
            return super().forward(x)
        if self.padding_mode != "zeros" or isinstance(self.padding, str):
            raise ValueError("a width-sharded convolution takes integer "
                             "zero padding")
        cols, n, out = window_columns(x, layout, self.kernel_size[1],
                                      self.stride[1], self.padding[1],
                                      self.dilation[1], 0.0)
        y = F.conv2d(cols, self.weight, self.bias, self.stride,
                     (self.padding[0], 0), self.dilation, self.groups)
        y = y[..., :n]
        layout.record(y, out)
        return y


class MaxPool2d(WidthSharded, nn.MaxPool2d):
    """``nn.MaxPool2d`` that runs on width-sharded maps (see the module
    docstring)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        layout = self.spatial
        if layout is None:
            return super().forward(x)
        kh, kw = nn.modules.utils._pair(self.kernel_size)
        sh, sw = nn.modules.utils._pair(self.stride)
        ph, pw = nn.modules.utils._pair(self.padding)
        dh, dw = nn.modules.utils._pair(self.dilation)
        cols, n, out = window_columns(x, layout, kw, sw, pw, dw,
                                      float("-inf"), self.ceil_mode)
        y = F.max_pool2d(cols, (kh, kw), (sh, sw), (ph, 0), (dh, dw),
                         ceil_mode=self.ceil_mode)[..., :n]
        layout.record(y, out)
        return y


class GroupNorm(WidthSharded, nn.GroupNorm):
    """``nn.GroupNorm`` whose statistics span the full width of a
    width-sharded map (see the module docstring). Computed in at least
    float32 and returned so, as autocast runs ``group_norm``; in the
    input's dtype outside autocast."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        layout = self.spatial
        if layout is None:
            return super().forward(x)
        n, c, h, _ = x.shape
        g = self.num_groups
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        sums = torch.stack([xf.sum((2, 3)), (xf * xf).sum((2, 3))])
        sums = group_sum(sums.view(2, n, g, c // g).sum(-1), layout.group)
        count = (c // g) * h * layout.width_of(x)
        mean = sums[0] / count
        var = (sums[1] / count - mean * mean).clamp_min(0.0)
        scale = torch.rsqrt(var + self.eps).repeat_interleave(c // g, 1)
        shift = -mean.repeat_interleave(c // g, 1) * scale
        if self.affine:
            shift = shift * self.weight + self.bias
            scale = scale * self.weight
        y = xf * scale[:, :, None, None] + shift[:, :, None, None]
        return y if torch.is_autocast_enabled(x.device.type) \
            else y.to(x.dtype)


def spatial_mean(x: torch.Tensor, layout) -> torch.Tensor:
    """(N, C): the mean of NCHW ``x`` over (H, W), over the full width
    when ``layout`` is set."""
    if layout is None:
        return x.mean(dim=(2, 3))
    total = group_sum(x.sum(dim=(2, 3)), layout.group)
    return total / (x.shape[2] * layout.width_of(x))
