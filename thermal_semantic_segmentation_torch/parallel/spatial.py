"""The width of a feature map split over ranks: the layout, the column
exchange and the differentiable sum of the (data, spatial) mesh
(``parallel/mesh.make_mesh_2d``).

The JAX package shards the image width over its ``'spatial'`` mesh axis
and leaves the halo exchanges of the convolutions to XLA. The port does
them by hand, with three pieces:

- **Layout.** Every width is split evenly: rank ``r`` of ``S`` owns the
  columns ``[r*W // S, (r+1)*W // S)`` (``column_range``), at every stage
  of the net (512 -> 256 -> 129 -> 65 columns for a 512-wide image), so
  shards may differ by one column and may be empty where ``W < S``.
  ``SpatialLayout`` is one rank's view of it during a step: its spatial
  group and index, and the global width of each feature map it has seen.
- **Exchange** (``gather_columns``): any global column range ``[a, b)`` of
  a width-sharded tensor on this rank, columns outside ``[0, W)`` filled
  with a pad value (0 for a convolution, -inf for a max pool). Its
  backward is the transpose: the gradient of each column that came from
  another rank is added to that rank's gradient. A range may reach past
  the neighbouring shards (a dilation-24 convolution on a 65-wide map at
  spatial 4 reaches two shards away), so each column comes from whichever
  rank owns it.
- **Sum** (``group_sum``): a sum over a process group whose gradient is
  the sum of the ranks' gradients, for statistics over the full width
  (GroupNorm, the SE gate's mean) and over the global batch (BatchNorm).

Every rank of the spatial group passes the same ranges for every rank
(they follow from the layer's geometry and the global width), so each
rank knows what every other one needs without asking. The exchange moves
one buffer: each rank's halo columns (those of its range that it does
not own, inside ``[0, W)``) one after another, every owner writing the
columns it holds; an all-reduce (sum) of the buffer gives every rank its
own. Only ``all_reduce`` is used, which gloo on the CPU, gloo on CUDA
tensors and NCCL all take; under gloo a CUDA buffer is staged through the
host explicitly, which also serves dtypes (bfloat16) that gloo's CUDA path
may lack. When no rank needs a halo the collective is skipped on every
rank alike.

Collectives run in the middle of the backward pass (the exchange's and
the sums' transposes). Every rank runs the same graph, so autograd issues
them in the same order on every rank; a rank with no rows or no columns
still runs every exchange, with empty pieces.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field

import torch
import torch.distributed as dist


def column_range(width: int, parts: int, index: int):
    """(lo, hi): the columns of a ``width``-wide map that shard ``index``
    of ``parts`` owns."""
    return index * width // parts, (index + 1) * width // parts


@dataclass
class SpatialLayout:
    """One rank's view of the width split during a step: its spatial
    group (the ranks of its data index), their count and its index among
    them, and the global width of every feature map of the forward,
    keyed by the (height, local width) of this rank's shard of it. The
    image's global width is set by ``start``; each sharded layer records
    the width of the map it makes (``record``) and looks up that of its
    input (``width_of``)."""

    group: object
    size: int
    index: int
    widths: dict = field(default_factory=dict)

    def start(self, x: torch.Tensor, width: int) -> None:
        """A new forward of the NCHW shard ``x`` of a ``width``-wide
        image."""
        self.widths = {}
        self.record(x, width)

    def record(self, x: torch.Tensor, width: int) -> None:
        key = (x.shape[2], x.shape[3])
        if self.widths.setdefault(key, width) != width:
            raise RuntimeError(
                f"two maps of height {key[0]} hold {key[1]} columns on "
                f"this rank but are {self.widths[key]} and {width} wide")
        lo, hi = self.columns(width)
        if hi - lo != x.shape[3]:
            raise ValueError(
                f"a shard of {x.shape[3]} columns is not shard "
                f"{self.index} of {self.size} of a {width}-wide map")

    def width_of(self, x: torch.Tensor) -> int:
        """The global width of the NCHW map whose shard is ``x``."""
        try:
            return self.widths[(x.shape[2], x.shape[3])]
        except KeyError:
            raise RuntimeError(
                f"no width-sharded layer made a map of height "
                f"{x.shape[2]} with {x.shape[3]} columns on this rank "
                f"(start the forward with SpatialLayout.start)") from None

    def columns(self, width: int):
        """(lo, hi) of this rank in a ``width``-wide map."""
        return column_range(width, self.size, self.index)


def all_reduce_(buf: torch.Tensor, group) -> None:
    """Sum ``buf`` over ``group`` in place; a CUDA tensor goes through the
    host under gloo. Every collective of this module is one call of this
    (an exchange's buffer is 4-D, a sum's has fewer dimensions)."""
    if buf.is_cuda and dist.get_backend(group) == "gloo":
        host = buf.cpu()
        dist.all_reduce(host, group=group)
        buf.copy_(host)
    else:
        dist.all_reduce(buf, group=group)


class _GroupSum(torch.autograd.Function):
    """The sum of ``x`` over ``group``'s ranks; its gradient is the sum of
    the ranks' gradients (every rank's loss depends on every rank's
    ``x``)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        all_reduce_(y, group)
        return y

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        all_reduce_(grad, ctx.group)
        return grad, None


def group_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over ``group``'s ranks, differentiable."""
    return _GroupSum.apply(x, group)


@functools.lru_cache(maxsize=512)
def _plan(width: int, size: int, ranges: tuple):
    """(owned columns of every rank, every rank's halo pieces as (buffer
    offset, c0, c1), buffer columns) of an exchange of ``ranges``."""
    owned = tuple(column_range(width, size, q) for q in range(size))
    slots, total = [], 0
    for (a, b), (lo, hi) in zip(ranges, owned):
        pieces = []
        for c0, c1 in ((max(a, 0), min(b, lo)), (max(a, hi), min(b, width))):
            if c1 > c0:
                pieces.append((total, c0, c1))
                total += c1 - c0
        slots.append(tuple(pieces))
    return owned, tuple(slots), total


class _Columns(torch.autograd.Function):
    """``gather_columns``'s forward and its transpose."""

    @staticmethod
    def forward(ctx, x, layout, width, ranges, pad):
        owned, slots, total = _plan(width, layout.size, ranges)
        me = layout.index
        lo, hi = owned[me]
        a, b = ranges[me]
        ctx.layout, ctx.plan, ctx.a, ctx.b = layout, (owned, slots, total), \
            a, b
        src = x.permute(0, 2, 3, 1)                    # (N, H, w, C)
        n, h, _, c = src.shape
        out = x.new_full((n, h, b - a, c), pad)
        s0, s1 = max(a, lo), min(b, hi)
        if s1 > s0:
            out[:, :, s0 - a:s1 - a] = src[:, :, s0 - lo:s1 - lo]
        if total:
            buf = x.new_zeros((n, h, total, c))
            for q, pieces in enumerate(slots):
                if q == me:
                    continue
                for t, c0, c1 in pieces:
                    s0, s1 = max(c0, lo), min(c1, hi)
                    if s1 > s0:
                        buf[:, :, t + s0 - c0:t + s1 - c0] = \
                            src[:, :, s0 - lo:s1 - lo]
            all_reduce_(buf, layout.group)
            for t, c0, c1 in slots[me]:
                out[:, :, c0 - a:c1 - a] = buf[:, :, t:t + c1 - c0]
        return out.permute(0, 3, 1, 2)

    @staticmethod
    def backward(ctx, grad):
        owned, slots, total = ctx.plan
        me, a, b = ctx.layout.index, ctx.a, ctx.b
        lo, hi = owned[me]
        g = grad.permute(0, 2, 3, 1)                   # (N, H, b - a, C)
        n, h, _, c = g.shape
        gx = grad.new_zeros((n, h, hi - lo, c))
        s0, s1 = max(a, lo), min(b, hi)
        if s1 > s0:
            gx[:, :, s0 - lo:s1 - lo] += g[:, :, s0 - a:s1 - a]
        if total:
            buf = grad.new_zeros((n, h, total, c))
            for t, c0, c1 in slots[me]:
                buf[:, :, t:t + c1 - c0] = g[:, :, c0 - a:c1 - a]
            all_reduce_(buf, ctx.layout.group)
            for q, pieces in enumerate(slots):
                if q == me:
                    continue
                for t, c0, c1 in pieces:
                    s0, s1 = max(c0, lo), min(c1, hi)
                    if s1 > s0:
                        gx[:, :, s0 - lo:s1 - lo] += \
                            buf[:, :, t + s0 - c0:t + s1 - c0]
        return gx.permute(0, 3, 1, 2), None, None, None, None


def gather_columns(x: torch.Tensor, layout: SpatialLayout, width: int,
                   ranges, pad: float = 0.0) -> torch.Tensor:
    """Global columns ``ranges[layout.index]`` of the ``width``-wide NCHW
    map whose shard on this rank is ``x``, as an NCHW tensor
    (channels_last memory); columns outside ``[0, width)`` hold ``pad``.

    ``ranges`` holds the range of every rank of the spatial group, the
    same on every rank: every rank calls this together. Where every range
    is its rank's own columns, ``x`` comes back as it is."""
    ranges = tuple((int(a), int(b)) for a, b in ranges)
    owned = [column_range(width, layout.size, q) for q in range(layout.size)]
    if list(ranges) == owned:
        return x
    return _Columns.apply(x, layout, width, ranges, pad)
