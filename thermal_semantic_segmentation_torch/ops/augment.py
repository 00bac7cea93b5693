"""Device-side augmentation (counterpart of the JAX ``ops/augment.py``).

The reference augments on the host with PIL, sample by sample
(utils/transforms.py RandomResizedCrop and flip). Here the same family runs
on the device inside the train step (``train/seg.py`` ``device_augment``):
one batched RandomResizedCrop, horizontal flip and optional normalisation,
its draws from a ``torch.Generator``, so the host only decodes full frames.

Sampler (``sample_crop_params``): torchvision's get_params
(utils/transforms.py:225-268) vectorised as in the JAX package: 10
candidates of area and log-aspect are drawn at once for every sample, the
first valid one is taken, and the central-crop fallback applies when none
is. Resampling (``resized_crop_flip``) takes those parameters: images are
bilinear with half-pixel centres (``ops/resize.sample_bilinear_at``),
labels take the nearest rule of JAX :113-116 by a plain gather (the JAX
package's one-hot contraction was a TPU workaround). The host PIL path
resamples BICUBIC, so the two pipelines agree in distribution, not bit for
bit; the host path stays the parity path.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from .resize import sample_bilinear_at

TRIES = 10


def sample_crop_params(generator: torch.Generator, n: int,
                       in_hw: Tuple[int, int],
                       scale: Tuple[float, float] = (0.5, 1.0),
                       ratio: Tuple[float, float] = (1.5, 8.0 / 3.0),
                       flip_p: float = 0.5) -> dict:
    """Crop and flip draws of ``n`` samples from ``generator`` (on the
    device the tensors are made on): {'top', 'left', 'h', 'w'} float32 (n,)
    and 'flip' bool (n,), the JAX ``_sample_crop_params`` rule for each
    sample. Draw order: areas (n, 10), log-aspects (n, 10), the top and
    left fractions (n,) each, then the flips (n,)."""
    dev = generator.device
    H, W = in_hw

    def uniform(*shape, lo=0.0, hi=1.0):
        u = torch.rand(shape, generator=generator, device=dev)
        return lo + u * (hi - lo)

    area = float(H * W)
    target = area * uniform(n, TRIES, lo=scale[0], hi=scale[1])
    aspect = torch.exp(uniform(n, TRIES, lo=math.log(ratio[0]),
                               hi=math.log(ratio[1])))
    w = torch.round(torch.sqrt(target * aspect))
    h = torch.round(torch.sqrt(target / aspect))
    valid = (w > 0) & (w <= W) & (h > 0) & (h <= H)
    first = valid.int().argmax(dim=1, keepdim=True)   # 0 when none is
    any_valid = valid.any(dim=1)
    h_sel = h.gather(1, first)[:, 0]
    w_sel = w.gather(1, first)[:, 0]
    top = torch.floor(uniform(n) * (H - h_sel + 1.0))
    left = torch.floor(uniform(n) * (W - w_sel + 1.0))

    # central-crop fallback, the input's aspect clamped into the range
    in_ratio = W / H
    if in_ratio < min(ratio):
        fw, fh = float(W), float(round(W / min(ratio)))
    elif in_ratio > max(ratio):
        fh, fw = float(H), float(round(H * max(ratio)))
    else:
        fw, fh = float(W), float(H)
    f_top, f_left = (H - fh) // 2, (W - fw) // 2

    def pick(sampled, fallback):
        return torch.where(any_valid, sampled,
                           torch.full_like(sampled, fallback))

    return {"top": pick(top, f_top), "left": pick(left, f_left),
            "h": pick(h_sel, fh), "w": pick(w_sel, fw),
            "flip": uniform(n) < flip_p}


def resized_crop_flip(images: torch.Tensor, params: dict,
                      out_hw: Tuple[int, int], *,
                      labels: Optional[torch.Tensor] = None,
                      mean: Optional[torch.Tensor] = None,
                      std: Optional[torch.Tensor] = None):
    """Resample each sample's crop (``params`` as ``sample_crop_params``
    gives them, on the images' device) to ``out_hw`` and flip it.

    images (N, H, W, C) float -> (N, oh, ow, C) float32, bilinear with
    half-pixel centres, then ``(x - mean) / std`` when ``mean`` is given;
    labels (N, H, W) int -> (N, oh, ow) of their dtype, nearest. Returns
    (images, labels or None)."""
    n, H, W, _ = images.shape
    oh, ow = out_hw
    dev = images.device
    top, left = params["top"][:, None], params["left"][:, None]
    sh = params["h"][:, None] / oh
    sw = params["w"][:, None] / ow
    jr = (torch.arange(oh, device=dev, dtype=torch.float32) + 0.5)[None]
    jc = (torch.arange(ow, device=dev, dtype=torch.float32) + 0.5)[None]
    flip = params["flip"][:, None]

    rows = (top + jr * sh - 0.5).clamp(0.0, H - 1.0)
    cols = (left + jc * sw - 0.5).clamp(0.0, W - 1.0)
    cols = torch.where(flip, cols.flip(1), cols)
    out = sample_bilinear_at(images, rows, cols)
    if mean is not None:
        out = (out - mean) / std

    out_labels = None
    if labels is not None:
        nr = torch.floor(top + jr * sh).clamp(0, H - 1).long()
        nc = torch.floor(left + jc * sw).clamp(0, W - 1).long()
        nc = torch.where(flip, nc.flip(1), nc)
        picked = labels.gather(1, nr[:, :, None].expand(n, oh, W))
        out_labels = picked.gather(2, nc[:, None, :].expand(n, oh, ow))
    return out, out_labels


def random_resized_crop_flip(generator: torch.Generator,
                             images: torch.Tensor, *,
                             labels: Optional[torch.Tensor] = None,
                             out_hw: Tuple[int, int] = (256, 512),
                             scale: Tuple[float, float] = (0.5, 1.0),
                             ratio: Tuple[float, float] = (1.5, 8.0 / 3.0),
                             flip_p: float = 0.5,
                             mean: Optional[torch.Tensor] = None,
                             std: Optional[torch.Tensor] = None):
    """Batched RandomResizedCrop + flip (+ normalise) of (N, H, W, C)
    ``images`` and optional (N, H, W) ``labels`` with draws from
    ``generator`` (on the images' device). Returns (images, labels or
    None)."""
    params = sample_crop_params(generator, images.shape[0],
                                tuple(images.shape[1:3]), scale, ratio,
                                flip_p)
    return resized_crop_flip(images, params, out_hw, labels=labels,
                             mean=mean, std=std)


def ir_window_normalize(raw: torch.Tensor, *, minval: float = 21800.0,
                        maxval: float = 25000.0) -> torch.Tensor:
    """The Freiburg IR radiometric window on the device
    (freiburg_dataset.py:72-82): clamp to [minval, maxval], scale to
    [0, 1]."""
    x = raw.float().clamp(minval, maxval)
    return (x - minval) / (maxval - minval)
