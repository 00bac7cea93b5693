"""Bilinear resize with PyTorch align-corners semantics, NHWC at the interface.

Counterpart of ``thermal_semantic_segmentation_tpu/ops/resize.py``. The JAX
package contracts dense interpolation matrices on the MXU; here the resize
is ``F.interpolate`` (the JAX package computes it outside Pallas, so a library
call is the right counterpart). ``interp_taps_np`` keeps the JAX matrix
arithmetic (float64 source coordinates, float32 weights) as 2-tap tables for
the fused ``kernels/upsample_argmax`` kernel and ``resize_bilinear_taps``.
Self-training adds ``resize_nearest`` and ``sample_bilinear_at``; the JAX
package writes both as one-hot matrix products (a TPU workaround for slow
gathers), here they are index gathers. The translator's PIL-style bicubic
resize of 8-bit images is ``resize_bicubic_8bit``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from ..parallel.spatial import column_range, gather_columns


def _source_coords(in_size: int, out_size: int) -> np.ndarray:
    """The float64 source coordinate of each output index of an
    align-corners resize."""
    i = np.arange(out_size, dtype=np.float64)
    if in_size == out_size:
        return i
    scale = (in_size - 1) / (out_size - 1) if out_size > 1 else 0.0
    return i * scale


@functools.lru_cache(maxsize=128)
def interp_taps_np(in_size: int, out_size: int):
    """(lo, hi, w_hi) per output index of an align-corners resize:
    ``out[i] = (1 - w_hi[i]) * x[lo[i]] + w_hi[i] * x[hi[i]]``.

    The same arithmetic as the JAX package's dense ``_interp_matrix_np``
    (whose row i holds ``1 - w_hi`` at ``lo`` and ``w_hi`` at ``hi``), so the
    weights are bit-identical to the reference's. lo/hi are int32, w_hi is
    float32; the arrays are read-only because the cache shares them.
    """
    src = _source_coords(in_size, out_size)
    lo = np.clip(np.floor(src).astype(np.int64), 0, in_size - 1)
    hi = np.minimum(lo + 1, in_size - 1)
    w_hi = (src - lo).astype(np.float32)
    taps = (lo.astype(np.int32), hi.astype(np.int32), w_hi)
    for t in taps:
        t.setflags(write=False)
    return taps


def resize_bilinear(x: torch.Tensor, out_h: int, out_w: int, *,
                    align_corners: bool = True) -> torch.Tensor:
    """Bilinearly resize NHWC ``x`` to (out_h, out_w), computed in at least
    float32 and returned in ``x``'s dtype."""
    y = x.permute(0, 3, 1, 2)
    y = F.interpolate(y.to(torch.promote_types(y.dtype, torch.float32)),
                      size=(out_h, out_w),
                      mode="bilinear", align_corners=align_corners)
    return y.permute(0, 2, 3, 1).to(x.dtype)


def upsample_logits(logits_nhwc: torch.Tensor, out_h: int, out_w: int,
                    layout=None) -> torch.Tensor:
    """The canonical logits upsample: bilinear, align_corners=True.

    With ``layout`` (``parallel/spatial.SpatialLayout``) the logits are
    this rank's shard of a width-sharded map and the result is this
    rank's columns of the global (out_h, out_w) upsample, in at least
    float32: the taps come from the global sizes (65 -> 512 columns), and
    the source columns of this rank's output columns come through the
    exchange. The arithmetic is ``resize_bilinear_taps``'s (the JAX
    package's), rows first; in float64 the weights are float64 too."""
    if layout is None:
        return resize_bilinear(logits_nhwc, out_h, out_w, align_corners=True)
    x = logits_nhwc.permute(0, 3, 1, 2)
    width = layout.width_of(x)
    lo, hi, _ = interp_taps_np(width, out_w)
    ranges = []
    for q in range(layout.size):
        c0, c1 = column_range(out_w, layout.size, q)
        ranges.append((int(lo[c0]), int(hi[c1 - 1]) + 1) if c1 > c0
                      else (0, 0))
    a = ranges[layout.index][0]
    y = gather_columns(x, layout, width, ranges).permute(0, 2, 3, 1)
    y = y.to(torch.promote_types(y.dtype, torch.float32))
    lo_d, hi_d, w_d = _device_taps(y.shape[1], out_h, y.device, y.dtype)
    w = w_d.reshape(1, -1, 1, 1)
    y = y.index_select(1, lo_d) * (1.0 - w) + y.index_select(1, hi_d) * w
    c0, c1 = layout.columns(out_w)
    lo_d, hi_d, w_d = _device_taps(width, out_w, y.device, y.dtype)
    w = w_d[c0:c1].reshape(1, 1, -1, 1)
    return (y.index_select(2, lo_d[c0:c1] - a) * (1.0 - w)
            + y.index_select(2, hi_d[c0:c1] - a) * w)


def resize_bilinear_taps(x: torch.Tensor, out_h: int,
                         out_w: int) -> torch.Tensor:
    """Align-corners bilinear resize of NHWC ``x`` in the JAX package's
    float32 arithmetic: rows, then columns, each ``x[lo] * (1 - w_hi) +
    x[hi] * w_hi`` from ``interp_taps_np``, as two products and a sum.
    ``F.interpolate`` rounds differently (a few ulps); where a result is
    truncated to an integer, as the JAX self-training step truncates its
    resized hard ids, only this arithmetic gives the reference's ids."""
    x = x.float()
    for axis, size in ((1, out_h), (2, out_w)):
        lo, hi, w = _device_taps(x.shape[axis], size, x.device)
        shape = [1, 1, 1, 1]
        shape[axis] = size
        w = w.reshape(shape)
        x = x.index_select(axis, lo) * (1.0 - w) + x.index_select(axis, hi) * w
    return x


@functools.lru_cache(maxsize=64)
def _device_taps(in_size: int, out_size: int, device: torch.device,
                 dtype: torch.dtype = torch.float32):
    """``interp_taps_np`` as (lo, hi int64, w_hi float32) tensors on
    ``device``, uploaded once per size (an upload waits for the host), as
    ordinary tensors even when first asked for under inference mode. With
    ``dtype`` float64, w_hi is the float64 value that float32 rounds."""
    lo, hi, w = interp_taps_np(in_size, out_size)
    if dtype == torch.float64:
        w = _source_coords(in_size, out_size) - lo
    with torch.inference_mode(False):
        return (torch.tensor(lo, dtype=torch.int64, device=device),
                torch.tensor(hi, dtype=torch.int64, device=device),
                torch.tensor(w, device=device))


@functools.lru_cache(maxsize=128)
def nearest_index_np(in_size: int, out_size: int) -> np.ndarray:
    """Source index per output index of torch's 'nearest' resize,
    ``floor(i * in / out)`` in float64 (the JAX package's selection
    matrices put their one at the same column). Read-only, int64."""
    src = np.clip(np.floor(np.arange(out_size) * (in_size / out_size)), 0,
                  in_size - 1).astype(np.int64)
    src.setflags(write=False)
    return src


def resize_nearest(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Nearest resize of NHWC ``x`` (any dtype, kept), as torch
    ``F.interpolate(mode='nearest')``: an index gather per axis."""
    rows = _device_nearest(x.shape[1], out_h, x.device)
    cols = _device_nearest(x.shape[2], out_w, x.device)
    return x.index_select(1, rows).index_select(2, cols)


@functools.lru_cache(maxsize=64)
def _device_nearest(in_size: int, out_size: int,
                    device: torch.device) -> torch.Tensor:
    """``nearest_index_np`` on ``device``, uploaded once per size, as an
    ordinary tensor even when first asked for under inference mode."""
    with torch.inference_mode(False):
        return torch.tensor(nearest_index_np(in_size, out_size),
                            device=device)


def sample_bilinear_at(x: torch.Tensor, src_rows: torch.Tensor,
                       src_cols: torch.Tensor) -> torch.Tensor:
    """Per-sample separable bilinear sampling at fractional coordinates.

    x: (N, H, W, C); src_rows: (N, out_h) and src_cols: (N, out_w) float
    coordinates into H and W. Returns (N, out_h, out_w, C) float32. Each
    axis is a 2-tap gather: ``lo = clip(floor(src), 0, size - 1)``, ``hi =
    min(lo + 1, size - 1)``, ``w_hi = src - lo``. An align-corners resize
    followed by a crop and a flip is such a sample (``train/self_train
    .full2weak_coords`` gives the coordinates)."""
    x = x.float()
    n, h, w, c = x.shape

    def taps(src, size):
        lo = torch.floor(src).clamp(0, size - 1).long()
        hi = (lo + 1).clamp(max=size - 1)
        return lo, hi, (src - lo).float()

    lo, hi, wr = taps(src_rows, h)
    oh = lo.shape[1]

    def rows(idx):
        return torch.gather(x, 1, idx[:, :, None, None].expand(n, oh, w, c))

    wr = wr[:, :, None, None]
    y = rows(lo) * (1.0 - wr) + rows(hi) * wr              # (N, oh, W, C)
    lo, hi, wc = taps(src_cols, w)
    ow = lo.shape[1]

    def cols(idx):
        return torch.gather(y, 2, idx[:, None, :, None].expand(n, oh, ow, c))

    wc = wc[:, None, :, None]
    return cols(lo) * (1.0 - wc) + cols(hi) * wc


def resize_bicubic_8bit(pixels: torch.Tensor, out_h: int,
                        out_w: int) -> torch.Tensor:
    """(N, C, H, W) 8-bit values -> (N, C, out_h, out_w) uint8, as PIL's
    BICUBIC ``resize`` of an 8-bit image: a horizontal pass, then a
    vertical one (a pass whose size does not change is skipped), each
    rounded and clipped to 0..255 as PIL stores its 8-bit intermediate.
    ``F.interpolate``'s antialiased bicubic is PIL's filter (a = -0.5,
    widened when reducing); PIL's fixed-point sums leave at most one grey
    level between the two."""
    x = pixels.float()
    h, w = x.shape[-2:]
    for size, changes in (((h, out_w), out_w != w),
                          ((out_h, out_w), out_h != h)):
        if changes:
            x = F.interpolate(x, size=size, mode="bicubic", antialias=True,
                              align_corners=False)
            x = torch.floor(x + 0.5).clamp_(0.0, 255.0)
    return x.to(torch.uint8)
