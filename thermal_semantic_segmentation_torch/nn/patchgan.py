"""70x70 PatchGAN discriminator (counterpart of the JAX ``nn/patchgan.py``;
reference models/discriminators.py:12-55).

NCHW modules (run in ``channels_last``) with the reference's ``Sequential``
indices: conv 0, then for each layer n a conv at 3n-1 and a norm at 3n,
the head at 3 n_layers + 2. The head gives a 1-channel map of raw patch
scores: no sigmoid (the LSGAN loss takes raw scores).
"""

from __future__ import annotations

import torch
from torch import nn

from .generators import GanNet
from .norms import make_norm


class NLayerDiscriminator(GanNet):
    """Weights N(0, 0.02), as the JAX package draws them."""

    def __init__(self, input_nc: int = 1, ndf: int = 64, n_layers: int = 3,
                 norm: str = "batch"):
        super().__init__()
        norm_layer, use_bias = make_norm(norm)
        layers = [nn.Conv2d(input_nc, ndf, 4, stride=2, padding=1),
                  nn.LeakyReLU(0.2)]
        mult = 1
        for n in range(1, n_layers + 1):
            prev, mult = mult, min(2 ** n, 8)
            layers += [nn.Conv2d(ndf * prev, ndf * mult, 4,
                                 stride=2 if n < n_layers else 1, padding=1,
                                 bias=use_bias),
                       norm_layer(ndf * mult), nn.LeakyReLU(0.2)]
        layers.append(nn.Conv2d(ndf * mult, 1, 4, stride=1, padding=1))
        self.model = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.model(x)
