"""Bilinear resize with PyTorch align-corners semantics, NHWC at the interface.

Counterpart of ``thermal_semantic_segmentation_tpu/ops/resize.py``. The JAX
package contracts dense interpolation matrices on the MXU; here the resize
is ``F.interpolate`` (the JAX package computes it outside Pallas, so a library
call is the right counterpart). ``interp_taps_np`` keeps the JAX matrix
arithmetic (float64 source coordinates, float32 weights) as 2-tap tables for
the fused ``kernels/upsample_argmax`` kernel.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


@functools.lru_cache(maxsize=128)
def interp_taps_np(in_size: int, out_size: int):
    """(lo, hi, w_hi) per output index of an align-corners resize:
    ``out[i] = (1 - w_hi[i]) * x[lo[i]] + w_hi[i] * x[hi[i]]``.

    The same arithmetic as the JAX package's dense ``_interp_matrix_np``
    (whose row i holds ``1 - w_hi`` at ``lo`` and ``w_hi`` at ``hi``), so the
    weights are bit-identical to the reference's. lo/hi are int32, w_hi is
    float32; the arrays are read-only because the cache shares them.
    """
    i = np.arange(out_size, dtype=np.float64)
    if in_size == out_size:
        src = i
    else:
        scale = (in_size - 1) / (out_size - 1) if out_size > 1 else 0.0
        src = i * scale
    lo = np.clip(np.floor(src).astype(np.int64), 0, in_size - 1)
    hi = np.minimum(lo + 1, in_size - 1)
    w_hi = (src - lo).astype(np.float32)
    taps = (lo.astype(np.int32), hi.astype(np.int32), w_hi)
    for t in taps:
        t.setflags(write=False)
    return taps


def resize_bilinear(x: torch.Tensor, out_h: int, out_w: int, *,
                    align_corners: bool = True) -> torch.Tensor:
    """Bilinearly resize NHWC ``x`` to (out_h, out_w), computed in float32
    and returned in ``x``'s dtype."""
    y = F.interpolate(x.permute(0, 3, 1, 2).float(), size=(out_h, out_w),
                      mode="bilinear", align_corners=align_corners)
    return y.permute(0, 2, 3, 1).to(x.dtype)


def upsample_logits(logits_nhwc: torch.Tensor, out_h: int,
                    out_w: int) -> torch.Tensor:
    """The canonical logits upsample: bilinear, align_corners=True."""
    return resize_bilinear(logits_nhwc, out_h, out_w, align_corners=True)
