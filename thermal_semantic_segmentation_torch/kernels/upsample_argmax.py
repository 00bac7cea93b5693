"""Fused bilinear align-corners upsample + argmax + max-softmax confidence.

Replaces the TPU kernel ``thermal_semantic_segmentation_tpu/ops/
pallas_kernels.py::upsample_argmax`` (body ``_kernel``). The CUDA source is
``csrc/upsample_argmax.cu``: one block per (image, tile of output rows, tile
of output columns) stages the row-interpolated logits in shared memory, and
each thread interpolates columns, takes the argmax and the confidence for 4
consecutive output pixels. ``launch_plan`` picks the tiles on the host; the
2-tap interpolation tables are built here too.

The kernel's floor is memory traffic: at the serving shape (8, 33, 65, 13)
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
from dataclasses import dataclass

import numpy as np
import torch

from ..ops.resize import interp_taps_np, upsample_logits
from . import build

VEC = 4                    # output columns per thread (kVec in the source)
MAX_TILE_W = 512           # output columns per block
TARGET_THREADS = 128       # threads per block (kMaxThreads in the source)
ROWS_PER_THREAD = 2        # output rows each thread takes in its tile
SMEM_LIMIT = 48 * 1024     # dynamic shared memory without the opt-in attribute
_MAX_GRID_YZ = 65535
_MAX_INT = 2**31 - 1


def upsample_argmax_reference(logits_nhwc: torch.Tensor, out_h: int,
                              out_w: int):
    """Plain PyTorch version: ``upsample_logits``, argmax (a tie keeps the
    lowest class) and the max of the softmax. Returns (pred int32, conf f32),
    both (N, out_h, out_w)."""
    up = upsample_logits(logits_nhwc.float(), out_h, out_w)
    pred = up.argmax(dim=-1).to(torch.int32)
    conf = torch.softmax(up, dim=-1).amax(dim=-1)
    return pred, conf


@dataclass(frozen=True)
class LaunchPlan:
    """Tiling of one launch: blocks of (tile_w / VEC, block_h) threads over
    a grid of (ceil(out_w / tile_w), ceil(out_h / tile_h), n); each block
    stages ``span`` source columns of ``pitch`` floats for each of its
    ``tile_h`` output rows, which its threads take in steps of block_h."""
    tile_h: int
    tile_w: int
    block_h: int
    span: int
    pitch: int
    grid: tuple[int, int, int]

    @property
    def threads(self) -> int:
        return self.tile_w // VEC * self.block_h

    @property
    def smem_bytes(self) -> int:
        return 4 * self.tile_h * self.span * self.pitch


def smem_pitch(num_classes: int) -> int:
    """Floats per staged source column: a multiple of 4 (float4 reads) whose
    quarter is odd, so 8 neighbouring columns hit distinct bank groups."""
    return 4 * (-(-num_classes // 4) | 1)


def staged_span(in_w: int, out_w: int, tile_w: int) -> int:
    """Source columns a column tile must stage: the widest tap range of any
    tile (the tables are monotone, so a tile's range runs from the low tap of
    its first column to the high tap of its last)."""
    lo, hi, _ = interp_taps_np(in_w, out_w)
    starts = np.arange(0, out_w, tile_w)
    ends = np.minimum(starts + tile_w, out_w) - 1
    return int((hi[ends] - lo[starts]).max()) + 1


@functools.lru_cache(maxsize=64)
def launch_plan(n: int, in_w: int, num_classes: int, out_h: int,
                out_w: int) -> LaunchPlan:
    """The widest column tile (up to MAX_TILE_W) and the tallest row tile
    (up to TARGET_THREADS threads of ROWS_PER_THREAD rows each) whose staged
    rows fit in SMEM_LIMIT. Raises ValueError for a shape no tiling can
    take."""
    pitch = smem_pitch(num_classes)
    tile_w = min(MAX_TILE_W, -(-out_w // VEC) * VEC)
    while True:
        span = staged_span(in_w, out_w, tile_w)
        row_bytes = 4 * span * pitch
        block_h = min(out_h, max(1, TARGET_THREADS // (tile_w // VEC)))
        tile_h = min(out_h, block_h * ROWS_PER_THREAD,
                     SMEM_LIMIT // row_bytes)
        if tile_h >= 1:
            break
        if tile_w == VEC:
            raise ValueError(
                f"upsample_argmax: one staged row of {span} source columns x "
                f"{num_classes} classes needs {row_bytes} bytes of shared "
                f"memory, over {SMEM_LIMIT}")
        tile_w = max(VEC, tile_w // 2 // VEC * VEC)
    grid = (-(-out_w // tile_w), -(-out_h // tile_h), n)
    if max(grid[1:]) > _MAX_GRID_YZ:
        raise ValueError(f"upsample_argmax: grid {grid} exceeds the launch "
                         f"limit {_MAX_GRID_YZ} in y or z")
    return LaunchPlan(tile_h, tile_w, min(block_h, tile_h), span, pitch,
                      grid)


@functools.lru_cache(maxsize=32)
def _device_taps(in_size: int, out_size: int, device: torch.device):
    """(lo, hi, w_hi) tables on ``device``, uploaded once per size, padded
    with their last entry to a multiple of VEC so that a thread reads its
    columns' taps as one int4 / float4."""
    pad = -out_size % VEC
    return tuple(torch.from_numpy(np.pad(t, (0, pad), mode="edge")).to(device)
                 for t in interp_taps_np(in_size, out_size))


def _bind(lib: ctypes.CDLL):
    fn = lib.tss_upsample_argmax_f32
    vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    fn.argtypes = [vp, ll, i, i, i, i, i, i, vp, vp, vp, vp, vp, vp,
                   i, i, i, i, i, i, i, vp, vp, vp]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=1)
def _kernel_fn():
    return _bind(build.load("upsample_argmax"))


def upsample_argmax(logits_nhwc: torch.Tensor, out_h: int, out_w: int):
    """(N, h, w, C) float32 logits -> (pred (N, out_h, out_w) int32,
    conf (N, out_h, out_w) float32), bilinear align_corners.

    A CUDA tensor goes through the hand-written kernel (any strides whose
    offsets inside one image fit in 32 bits; no copy for a channels_last
    model output viewed as NHWC); a CPU tensor through
    ``upsample_argmax_reference``.
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
    sn, sh, sw, sc = x.stride()
    if (h - 1) * sh + (w - 1) * sw + (c - 1) * sc > _MAX_INT:
        raise ValueError(f"one image of logits spans more than 2**31 "
                         f"elements (shape {tuple(x.shape)}, strides "
                         f"{x.stride()}): the kernel's offsets are 32-bit")
    plan = launch_plan(n, w, c, out_h, out_w)
    dev = x.device
    pred = torch.empty((n, out_h, out_w), dtype=torch.int32, device=dev)
    conf = torch.empty((n, out_h, out_w), dtype=torch.float32, device=dev)
    row_lo, row_hi, row_w = _device_taps(h, out_h, dev)
    col_lo, col_hi, col_w = _device_taps(w, out_w, dev)
    fn = _kernel_fn()
    with torch.cuda.device(dev):  # launch on the tensor's own card
        err = fn(x.data_ptr(), sn, sh, sw, sc, n, w, c,
                 row_lo.data_ptr(), row_hi.data_ptr(), row_w.data_ptr(),
                 col_lo.data_ptr(), col_hi.data_ptr(), col_w.data_ptr(),
                 out_h, out_w, plan.tile_h, plan.tile_w, plan.block_h,
                 plan.span, plan.pitch, pred.data_ptr(), conf.data_ptr(),
                 torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"upsample_argmax kernel launch failed: CUDA "
                           f"error {err}")
    upsample_argmax.launches += 1
    return pred, conf


upsample_argmax.launches = 0
