"""Fused bilinear align-corners upsample + argmax + max-softmax confidence.

Replaces the TPU kernel ``thermal_semantic_segmentation_tpu/ops/
pallas_kernels.py::upsample_argmax`` (body ``_kernel``). The CUDA source is
``csrc/upsample_argmax.cu``: one thread per output pixel, looping over the
classes, with 2-tap interpolation tables built here on the host.

The kernel is bound by memory traffic: at the serving shape (8, 33, 65, 13)
-> 256x512 it must read 0.9 MB of logits and write 8.4 MB of ids and
confidences. Its design never writes the upsampled (N, 256, 512, 13) float32
logits (about 54 MB at batch 8), which the plain version below materialises.

``upsample_argmax`` launches the kernel for a CUDA tensor and runs the plain
version only for a CPU tensor. ``upsample_argmax.launches`` counts kernel
launches (CPU calls leave it unchanged).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..ops.resize import interp_taps_np, upsample_logits
from . import build

_MAX_GRID_YZ = 65535


def upsample_argmax_reference(logits_nhwc: torch.Tensor, out_h: int,
                              out_w: int):
    """Plain PyTorch version: ``upsample_logits``, argmax (a tie keeps the
    lowest class) and the max of the softmax. Returns (pred int32, conf f32),
    both (N, out_h, out_w)."""
    up = upsample_logits(logits_nhwc.float(), out_h, out_w)
    pred = up.argmax(dim=-1).to(torch.int32)
    conf = torch.softmax(up, dim=-1).amax(dim=-1)
    return pred, conf


@functools.lru_cache(maxsize=32)
def _device_taps(in_size: int, out_size: int, device: torch.device):
    """(lo, hi, w_hi) tables on ``device``, uploaded once per size."""
    lo, hi, w = interp_taps_np(in_size, out_size)
    return tuple(torch.from_numpy(np.array(t)).to(device) for t in (lo, hi, w))


def _bind(lib: ctypes.CDLL):
    fn = lib.tss_upsample_argmax_f32
    vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    fn.argtypes = [vp, ll, ll, ll, ll, i, i, vp, vp, vp, vp, vp, vp, i, i,
                   vp, vp, vp]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=1)
def _kernel_fn():
    return _bind(build.load("upsample_argmax"))


def upsample_argmax(logits_nhwc: torch.Tensor, out_h: int, out_w: int):
    """(N, h, w, C) float32 logits -> (pred (N, out_h, out_w) int32,
    conf (N, out_h, out_w) float32), bilinear align_corners.

    A CUDA tensor goes through the hand-written kernel (any strides; no
    copy for a channels_last model output viewed as NHWC); a CPU tensor
    through ``upsample_argmax_reference``.
    """
    x = logits_nhwc
    if x.dim() != 4:
        raise ValueError(f"expected (N, h, w, C) logits, got shape "
                         f"{tuple(x.shape)}")
    if x.device.type == "cpu":
        return upsample_argmax_reference(x, out_h, out_w)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.dtype != torch.float32:
        raise TypeError(f"the kernel takes float32 logits, got {x.dtype}")
    n, h, w, c = x.shape
    if min(n, h, w, c, out_h, out_w) < 1:
        raise ValueError(f"empty shape {tuple(x.shape)} -> ({out_h}, {out_w})")
    if n > _MAX_GRID_YZ or out_h > _MAX_GRID_YZ:
        raise ValueError(f"batch {n} / out_h {out_h} exceed the launch grid "
                         f"({_MAX_GRID_YZ})")
    dev = x.device
    pred = torch.empty((n, out_h, out_w), dtype=torch.int32, device=dev)
    conf = torch.empty((n, out_h, out_w), dtype=torch.float32, device=dev)
    row_lo, row_hi, row_w = _device_taps(h, out_h, dev)
    col_lo, col_hi, col_w = _device_taps(w, out_w, dev)
    sn, sh, sw, sc = x.stride()
    fn = _kernel_fn()
    with torch.cuda.device(dev):  # launch on the tensor's own card
        err = fn(x.data_ptr(), sn, sh, sw, sc, n, c,
                 row_lo.data_ptr(), row_hi.data_ptr(), row_w.data_ptr(),
                 col_lo.data_ptr(), col_hi.data_ptr(), col_w.data_ptr(),
                 out_h, out_w, pred.data_ptr(), conf.data_ptr(),
                 torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"upsample_argmax kernel launch failed: CUDA "
                           f"error {err}")
    upsample_argmax.launches += 1
    return pred, conf


upsample_argmax.launches = 0
