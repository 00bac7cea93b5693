"""SSIM between NHWC images (counterpart of the JAX ``ops/ssim.py``).

The defaults of the ``pytorch_msssim.ssim`` call of the reference's
translation-quality eval (distance_evaluate.py:9,47): an 11-tap Gaussian
window with sigma 1.5 (normalised), K1 = 0.01, K2 = 0.03, per-channel
filtering with VALID padding, the mean over the map (``size_average``).
The port does not import pytorch_msssim.

The filtering is two depthwise ``F.conv2d`` passes (11x1, then 1x11) over
the five maps x, y, x*x, y*y and x*y stacked along the channels, so one
pair of convolutions serves them all. The variance terms are catastrophic
cancellations (E[x^2] - E[x]^2 whose operands agree to ~3 digits): they
need float32 convolutions, which the port's float32 mode keeps (TF32 off,
``device.set_float32_numerics``); TF32 or bf16 would turn them into noise.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

K1, K2 = 0.01, 0.03


def gaussian_window(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    """The normalised 1-D Gaussian, built in float64, cast to float32."""
    x = np.arange(size, dtype=np.float64) - (size - 1) / 2.0
    g = np.exp(-(x ** 2) / (2 * sigma ** 2))
    return (g / g.sum()).astype(np.float32)


def _filter_valid(maps: torch.Tensor, win: np.ndarray) -> torch.Tensor:
    """Separable depthwise Gaussian filtering of (N, C, H, W), VALID
    padding: the rows first, then the columns, as the JAX op."""
    c = maps.shape[1]
    w = torch.from_numpy(win).to(device=maps.device, dtype=maps.dtype)
    y = F.conv2d(maps, w.view(1, 1, -1, 1).expand(c, 1, -1, 1), groups=c)
    return F.conv2d(y, w.view(1, 1, 1, -1).expand(c, 1, 1, -1), groups=c)


def ssim(x: torch.Tensor, y: torch.Tensor, *, data_range: float = 1.0,
         win_size: int = 11, sigma: float = 1.5,
         size_average: bool = True) -> torch.Tensor:
    """SSIM of (N, H, W, C) images in float32: a scalar tensor
    (``size_average``) or one value per image (N,)."""
    x = x.float().permute(0, 3, 1, 2)
    y = y.float().permute(0, 3, 1, 2)
    c1 = (K1 * data_range) ** 2
    c2 = (K2 * data_range) ** 2
    mu_x, mu_y, mu_xx, mu_yy, mu_xy = _filter_valid(
        torch.cat([x, y, x * x, y * y, x * y], dim=1),
        gaussian_window(win_size, sigma)).chunk(5, dim=1)
    var_x = mu_xx - mu_x ** 2
    var_y = mu_yy - mu_y ** 2
    cov = mu_xy - mu_x * mu_y
    ssim_map = ((2 * mu_x * mu_y + c1) * (2 * cov + c2)) / (
        (mu_x ** 2 + mu_y ** 2 + c1) * (var_x + var_y + c2))
    if size_average:
        return ssim_map.mean()
    return ssim_map.mean(dim=(1, 2, 3))
