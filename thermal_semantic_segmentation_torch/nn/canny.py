"""Differentiable Canny edges with fixed filters (counterpart of the JAX
``nn/canny.py``; reference models/net_canny.py:7-155).

The 5-tap Gaussian (sigma 1, unnormalised) as a 1x5 pass and then a 5x1
pass, the two Sobel filters, the orientation quantised to 45-degree bins,
8-direction non-maximum suppression and a threshold. The contour loss of
the GAN step backpropagates through the edges of the generated image.

The NMS selects the two directional responses with ``gather`` on the
orientation index; the JAX package's one-hot select is a TPU workaround.
Like the JAX package (and unlike the reference, whose gather lacks the
batch offset) every sample reads its own responses.

Two ways to run the fixed filters give the same edges up to float noise:
on the card, cuDNN convolutions and a float32 root; on the CPU, each
filter's taps summed in the order of XLA's CPU convolution and the root
taken in float64, so the edges equal the JAX package's bit for bit there.
The decisions (orientation bin, NMS, threshold) are made in one place,
``_edge_mask``, without a gradient.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

# scipy.signal.gaussian(5, 1): exp(-x^2 / 2), unnormalised
_GAUSS = np.exp(-(np.arange(5, dtype=np.float64) - 2.0) ** 2 / 2.0).astype(
    np.float32)
_SOBEL = np.array([[1, 0, -1], [2, 0, -2], [1, 0, -1]], np.float32)
# the 8 directional difference filters, 0, 45, ..., 315 degrees
# (reference net_canny.py:38-70)
_DIRS = np.array([
    [[0, 0, 0], [0, 1, -1], [0, 0, 0]],
    [[0, 0, 0], [0, 1, 0], [0, 0, -1]],
    [[0, 0, 0], [0, 1, 0], [0, -1, 0]],
    [[0, 0, 0], [0, 1, 0], [-1, 0, 0]],
    [[0, 0, 0], [-1, 1, 0], [0, 0, 0]],
    [[-1, 0, 0], [0, 1, 0], [0, 0, 0]],
    [[0, -1, 0], [0, 1, 0], [0, 0, 0]],
    [[0, 0, -1], [0, 1, 0], [0, 0, 0]],
], np.float32)


# the order in which the reference's convolution (XLA's, on the CPU) sums
# the taps of each filter, kept so the edges equal the reference's bit for
# bit: ((t0 + t1) + (t2 + t3)) + t4 for the 5-tap Gaussian, and
# (((t0 + t1) + (t4 + t5)) + ((t2 + t3) + (t6 + t7))) + t8 for a 3x3
# filter with its taps in row-major order. Zero taps are left out.
_ORDER = {5: ((((0, 1), (2, 3)), 4)),
          9: ((((0, 1), (4, 5)), ((2, 3), (6, 7))), 8)}


def _ordered_conv(x: torch.Tensor, kernel: np.ndarray) -> torch.Tensor:
    """'SAME' zero-padded cross-correlation of (B, H, W) maps with a fixed
    (kh, kw) filter: a product per nonzero tap, each of a shifted view of
    the padded maps, summed in ``_ORDER``."""
    kh, kw = kernel.shape
    h, w = x.shape[-2:]
    xp = F.pad(x, (kw // 2, kw // 2, kh // 2, kh // 2))
    taps = kernel.reshape(-1)

    def tap(t):
        weight = float(taps[t])
        if weight == 0.0:
            return None
        i, j = divmod(t, kw)
        view = xp[..., i:i + h, j:j + w]
        return view if weight == 1.0 else view * weight

    def total(node):
        if isinstance(node, int):
            return tap(node)
        a, b = (total(n) for n in node)
        return b if a is None else a if b is None else a + b

    return total(_ORDER[taps.size])


@functools.lru_cache(maxsize=None)
def _filters(device: torch.device) -> dict:
    """The fixed filters as (out, 1, kh, kw) conv weights on ``device``,
    uploaded once: a copy per call would wait for the host."""
    def w(k):
        return torch.from_numpy(np.ascontiguousarray(k)).to(device)

    return {"row": w(_GAUSS[None, None, None, :]),
            "col": w(_GAUSS[None, None, :, None]),
            "sobel": w(np.stack([_SOBEL, _SOBEL.T])[:, None]),
            "dirs": w(_DIRS[:, None])}


def _blur_sobel(x: torch.Tensor, exact: bool):
    """(B, H, W) maps -> their blurred Sobel responses gx, gy (B, H, W)."""
    if exact:
        blurred = _ordered_conv(_ordered_conv(x, _GAUSS[None, :]),
                                _GAUSS[:, None])
        return _ordered_conv(blurred, _SOBEL), _ordered_conv(blurred,
                                                             _SOBEL.T)
    f = _filters(x.device)
    blurred = F.conv2d(F.conv2d(x[:, None], f["row"], padding=(0, 2)),
                       f["col"], padding=(2, 0))
    g = F.conv2d(blurred, f["sobel"], padding=1)
    return g[:, 0], g[:, 1]


def _directional(grad_mag: torch.Tensor, exact: bool) -> torch.Tensor:
    """(N, 1, H, W) magnitudes -> the 8 directional differences (N, 8, H,
    W)."""
    if exact:
        return torch.stack([_ordered_conv(grad_mag[:, 0], d) for d in _DIRS],
                           1)
    return F.conv2d(grad_mag, _filters(grad_mag.device)["dirs"], padding=1)


def _safe_magnitude(gx: torch.Tensor, gy: torch.Tensor,
                    exact: bool) -> torch.Tensor:
    """sqrt(gx^2 + gy^2) whose gradient is 0, not NaN, where both are 0.

    sqrt's gradient at 0 is infinite, flat regions (tanh-saturated
    generator outputs, piecewise-constant frames) hit exactly 0, and the
    masking ``where``s downstream multiply a zero cotangent by that
    infinity: NaN, which poisons every parameter in one step. The double
    ``where`` keeps the forward value and gives a zero gradient there.
    ``exact`` takes the root in float64 and rounds it once to float32,
    which is the correctly rounded float32 root (torch's vectorised
    float32 ``sqrt`` on the CPU is not, in a fraction of a percent of
    values; the card's is)."""
    m2 = gx * gx + gy * gy
    pos = m2 > 0.0
    safe = torch.where(pos, m2, 1.0)
    root = torch.sqrt(safe.double()).float() if exact else torch.sqrt(safe)
    return torch.where(pos, root, 0.0)


def _edge_mask(grad_mag: torch.Tensor, gx: torch.Tensor, gy: torch.Tensor,
               threshold: float, exact: bool) -> torch.Tensor:
    """The discrete decisions, (N, 1, H, W) bool: a pixel is kept when its
    magnitude is a maximum along the quantised orientation (8-direction
    NMS) and not under ``threshold``. Only selects: no gradient (atan2's
    at (0, 0) is NaN)."""
    with torch.no_grad():
        orientation = torch.atan2(gy, gx) * (180.0 / 3.14159) + 180.0
        orientation = torch.round(orientation / 45.0) * 45.0
        idx_pos = torch.round(orientation / 45.0).long() % 8
        idx_neg = (idx_pos + 4) % 8
        directional = _directional(grad_mag, exact)
        sel_pos = directional.gather(1, idx_pos)
        sel_neg = directional.gather(1, idx_neg)
        return (torch.minimum(sel_pos, sel_neg) > 0.0) & ~(grad_mag
                                                           < threshold)


def canny_edges(img: torch.Tensor, *, threshold: float = 10.0,
                exact: bool | None = None) -> torch.Tensor:
    """img: (N, H, W, C) with C in {1, 3} -> thresholded thin edges
    (N, H, W, 1), float32. A 3-channel image sums the per-channel
    magnitudes and gradients. ``exact`` (default: on the CPU) runs the
    filters as XLA's CPU does; otherwise as cuDNN convolutions."""
    n, h, w, c = img.shape
    if c not in (1, 3):
        raise ValueError("Channel number does not fit.")
    if exact is None:
        exact = img.device.type == "cpu"
    x = img.float().permute(0, 3, 1, 2).reshape(n * c, h, w)
    gx, gy = (g.reshape(n, c, h, w) for g in _blur_sobel(x, exact))
    mags = _safe_magnitude(gx, gy, exact)
    if c == 3:
        grad_mag = (mags[:, 0] + mags[:, 1] + mags[:, 2]).unsqueeze(1)
        gx = (gx[:, 0] + gx[:, 1] + gx[:, 2]).unsqueeze(1)
        gy = (gy[:, 0] + gy[:, 1] + gy[:, 2]).unsqueeze(1)
    else:
        grad_mag = mags
    keep = _edge_mask(grad_mag, gx, gy, threshold, exact)
    return torch.where(keep, grad_mag, 0.0).permute(0, 2, 3, 1)
