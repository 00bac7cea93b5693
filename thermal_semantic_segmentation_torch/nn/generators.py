"""CycleGAN generators: the U-Net (5, 7 or 8 downs) and the ResNet generator
(6 or 9 blocks); counterpart of the JAX ``nn/generators.py``.

The modules are NCHW (run in ``channels_last`` memory format) and are built
as the reference builds them (models/generators.py:74-235), so their
state_dict keys are the reference's and a reference ``.pth`` loads with
``load_state_dict``. The U-Net is the recursive ``UnetSkipConnectionBlock``
chain, whose ``Sequential`` indices are:

  outermost    [downconv 0, sub 1, relu 2, upconv 3, tanh 4]
  intermediate [lrelu 0, downconv 1, downnorm 2, sub 3, relu 4, upconv 5,
                upnorm 6 (, dropout 7)]
  innermost    [lrelu 0, downconv 1, relu 2, upconv 3, upnorm 4]

The reference's activations are in-place, so its skip carries
``leaky_relu(x)`` where the JAX package carries ``x``; the ReLU that
follows every concat makes the two equal, and here the activations are
not in-place. The up-convolutions are ``nn.ConvTranspose2d`` (k4/s2/p1 in
the U-Net, k3/s2/p1 with ``output_padding=1`` in the ResNet); the JAX
package's ``PhasedConvTranspose`` is a TPU rewrite of the same operation.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from .norms import make_norm

INIT_TYPES = ("normal", "xavier", "kaiming", "orthogonal")


def weight_init(init_type: str = "normal", init_gain: float = 0.02):
    """``init(weight, generator)`` for a conv or transposed-conv weight,
    as the JAX ``weight_init`` draws it (flax's initializers, reference
    utils/misc.py:100-132): normal N(0, gain); xavier and kaiming the
    truncated normals of flax's ``xavier_normal`` (fan_avg, scale 1) and
    ``kaiming_normal`` (fan_in, scale 2), whose gain they ignore;
    orthogonal with scale ``gain``. Fans count as flax counts its kernels
    (a transposed conv's input channels are dim 0 of its torch weight)."""
    if init_type not in INIT_TYPES:
        raise NotImplementedError(
            f"initialization method [{init_type}] is not implemented")

    def init(weight: torch.Tensor, generator: torch.Generator,
             transposed: bool = False) -> None:
        if init_type == "normal":
            nn.init.normal_(weight, 0.0, init_gain, generator=generator)
        elif init_type == "orthogonal":
            nn.init.orthogonal_(weight, init_gain, generator=generator)
        else:
            rf = math.prod(weight.shape[2:])
            fan_in = weight.shape[0 if transposed else 1] * rf
            fan_out = weight.shape[1 if transposed else 0] * rf
            scale, fan = ((1.0, (fan_in + fan_out) / 2)
                          if init_type == "xavier" else (2.0, fan_in))
            # flax's truncated normal: N(0, 1) cut at +-2, scaled so the
            # variance is scale / fan
            std = math.sqrt(scale / fan) / 0.87962566103423978
            nn.init.trunc_normal_(weight, 0.0, std, -2 * std, 2 * std,
                                  generator=generator)

    return init


class GanNet(nn.Module):
    """Base of the GAN nets: ``init_weights_`` draws every conv weight from
    ``weight_init(init_type, init_gain)``, zeros the biases and sets every
    norm's scale to 1 and bias to 0, as flax's initializers do."""

    init_type = "normal"
    init_gain = 0.02

    def init_weights_(self, generator: torch.Generator) -> None:
        init = weight_init(self.init_type, self.init_gain)
        for m in self.modules():
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
                init(m.weight, generator,
                     transposed=isinstance(m, nn.ConvTranspose2d))
                if m.bias is not None:
                    nn.init.zeros_(m.bias)
            elif isinstance(m, nn.BatchNorm2d):
                nn.init.ones_(m.weight)
                nn.init.zeros_(m.bias)


class UnetSkipConnectionBlock(nn.Module):
    """One level of the U-Net: down, the inner levels, up, and (but for the
    outermost level) the skip concat of its input with its output."""

    def __init__(self, outer_nc: int, inner_nc: int, input_nc=None,
                 submodule=None, *, outermost: bool = False,
                 innermost: bool = False, norm: str = "batch",
                 use_dropout: bool = False):
        super().__init__()
        self.outermost = outermost
        norm_layer, use_bias = make_norm(norm)
        input_nc = outer_nc if input_nc is None else input_nc
        downconv = nn.Conv2d(input_nc, inner_nc, 4, stride=2, padding=1,
                             bias=use_bias)
        if outermost:
            upconv = nn.ConvTranspose2d(inner_nc * 2, outer_nc, 4, stride=2,
                                        padding=1)
            layers = [downconv, submodule, nn.ReLU(), upconv, nn.Tanh()]
        elif innermost:
            upconv = nn.ConvTranspose2d(inner_nc, outer_nc, 4, stride=2,
                                        padding=1, bias=use_bias)
            layers = [nn.LeakyReLU(0.2), downconv, nn.ReLU(), upconv,
                      norm_layer(outer_nc)]
        else:
            upconv = nn.ConvTranspose2d(inner_nc * 2, outer_nc, 4, stride=2,
                                        padding=1, bias=use_bias)
            layers = [nn.LeakyReLU(0.2), downconv, norm_layer(inner_nc),
                      submodule, nn.ReLU(), upconv, norm_layer(outer_nc)]
            if use_dropout:
                layers.append(nn.Dropout(0.5))
        self.model = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.outermost:
            return self.model(x)
        return torch.cat([x, self.model(x)], 1)


class UnetGenerator(GanNet):
    """U-Net with ``num_downs`` stride-2 levels (reference
    models/generators.py:136-165); H and W must be divisible by
    2**num_downs. Widths ngf, 2ngf, 4ngf, then 8ngf; dropout, if asked
    for, in the num_downs - 5 middle 8ngf levels."""

    def __init__(self, input_nc: int = 3, output_nc: int = 3,
                 num_downs: int = 8, ngf: int = 64, norm: str = "batch",
                 use_dropout: bool = False, init_type: str = "normal",
                 init_gain: float = 0.02):
        super().__init__()
        if num_downs < 5:
            raise ValueError(f"num_downs must be at least 5, got {num_downs}")
        self.init_type, self.init_gain = init_type, init_gain
        block = UnetSkipConnectionBlock(ngf * 8, ngf * 8, innermost=True,
                                        norm=norm)
        for _ in range(num_downs - 5):
            block = UnetSkipConnectionBlock(ngf * 8, ngf * 8, submodule=block,
                                            norm=norm,
                                            use_dropout=use_dropout)
        for mult in (4, 2, 1):
            block = UnetSkipConnectionBlock(ngf * mult, ngf * mult * 2,
                                            submodule=block, norm=norm)
        self.model = UnetSkipConnectionBlock(output_nc, ngf,
                                             input_nc=input_nc,
                                             submodule=block, outermost=True,
                                             norm=norm)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.model(x)


class ResnetBlock(nn.Module):
    """x + [pad, conv3, norm, relu, (dropout), pad, conv3, norm](x)
    (reference models/generators.py:16-71); 'zero' padding puts the pad in
    the convs instead of in layers of its own."""

    def __init__(self, dim: int, *, norm: str = "batch",
                 use_dropout: bool = False, use_bias: bool = False,
                 padding_type: str = "reflect"):
        super().__init__()
        norm_layer, _ = make_norm(norm)
        pads = {"reflect": nn.ReflectionPad2d, "replicate": nn.ReplicationPad2d}
        if padding_type not in (*pads, "zero"):
            raise NotImplementedError(
                f"padding [{padding_type}] is not implemented")
        p = 1 if padding_type == "zero" else 0

        def pad():
            return [pads[padding_type](1)] if padding_type in pads else []

        layers = pad() + [nn.Conv2d(dim, dim, 3, padding=p, bias=use_bias),
                          norm_layer(dim), nn.ReLU()]
        if use_dropout:
            layers.append(nn.Dropout(0.5))
        layers += pad() + [nn.Conv2d(dim, dim, 3, padding=p, bias=use_bias),
                           norm_layer(dim)]
        self.conv_block = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.conv_block(x)


class ResnetGenerator(GanNet):
    """Reflection-padded 7x7 stem, 2 stride-2 downs, ``n_blocks`` ResNet
    blocks at 4ngf, 2 transposed-conv ups, a reflection-padded 7x7 head
    and tanh (reference models/generators.py:74-133)."""

    def __init__(self, input_nc: int = 3, output_nc: int = 3, ngf: int = 64,
                 n_blocks: int = 9, norm: str = "batch",
                 use_dropout: bool = False, padding_type: str = "reflect",
                 init_type: str = "normal", init_gain: float = 0.02):
        super().__init__()
        self.init_type, self.init_gain = init_type, init_gain
        norm_layer, use_bias = make_norm(norm)
        layers = [nn.ReflectionPad2d(3),
                  nn.Conv2d(input_nc, ngf, 7, bias=use_bias),
                  norm_layer(ngf), nn.ReLU()]
        for i in range(2):
            c = ngf * 2 ** i
            layers += [nn.Conv2d(c, c * 2, 3, stride=2, padding=1,
                                 bias=use_bias),
                       norm_layer(c * 2), nn.ReLU()]
        layers += [ResnetBlock(ngf * 4, norm=norm, use_dropout=use_dropout,
                               use_bias=use_bias, padding_type=padding_type)
                   for _ in range(n_blocks)]
        for i in range(2):
            c = ngf * 2 ** (2 - i)
            layers += [nn.ConvTranspose2d(c, c // 2, 3, stride=2, padding=1,
                                          output_padding=1, bias=use_bias),
                       norm_layer(c // 2), nn.ReLU()]
        layers += [nn.ReflectionPad2d(3), nn.Conv2d(ngf, output_nc, 7),
                   nn.Tanh()]
        self.model = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.model(x)
