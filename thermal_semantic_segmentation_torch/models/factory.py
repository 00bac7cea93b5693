"""Net factories (counterpart of the JAX ``models/factory.py``; reference
models/generators.py:238-345, models/discriminators.py:12,
semantic_segmentation_models.py:182, thermal_semantic_segmentation_models
.py:186).

The GAN factories build a module on the CPU with torch's default weights;
``init_gan_net`` draws its weights from a seed and puts it on the device.
The legacy DeepLab factories build the full-width ResNet-101 with the
ASPP_V2 head, its weights drawn from a seed, on the device, in eval mode:
the GAN's frozen semantic nets.
"""

from __future__ import annotations

import torch
from torch import nn

from ..device import resolve_device
from .deeplab import LegacyDeepLabV2, create_deeplab
from ..nn.generators import ResnetGenerator, UnetGenerator
from ..nn.patchgan import NLayerDiscriminator


def _unet(num_downs: int):
    def build(ngf: int = 64, input_nc: int = 3, output_nc: int = 3,
              norm: str = "batch", use_dropout: bool = False,
              init_type: str = "normal", init_gain: float = 0.02):
        return UnetGenerator(input_nc, output_nc, num_downs=num_downs,
                             ngf=ngf, norm=norm, use_dropout=use_dropout,
                             init_type=init_type, init_gain=init_gain)
    build.__name__ = build.__qualname__ = f"unet_{2 ** num_downs}"
    build.__doc__ = (f"U-Net with {num_downs} downs (inputs divisible by "
                     f"{2 ** num_downs}).")
    return build


def _resnet(n_blocks: int):
    def build(ngf: int = 64, input_nc: int = 3, output_nc: int = 3,
              norm: str = "batch", use_dropout: bool = False,
              init_type: str = "normal", init_gain: float = 0.02):
        return ResnetGenerator(input_nc, output_nc, ngf=ngf,
                               n_blocks=n_blocks, norm=norm,
                               use_dropout=use_dropout, init_type=init_type,
                               init_gain=init_gain)
    build.__name__ = build.__qualname__ = f"resnet_{n_blocks}"
    build.__doc__ = f"ResNet generator with {n_blocks} blocks."
    return build


unet_256, unet_128, unet_32 = _unet(8), _unet(7), _unet(5)
resnet_9, resnet_6 = _resnet(9), _resnet(6)


def patchgan(ndf: int = 64, input_nc: int = 1, n_layers: int = 3,
             norm: str = "batch") -> NLayerDiscriminator:
    """The 70x70 PatchGAN."""
    return NLayerDiscriminator(input_nc, ndf=ndf, n_layers=n_layers,
                               norm=norm)


def deeplabv2_resnet101(num_classes: int = 19, *, seed=0,
                        device=None) -> LegacyDeepLabV2:
    """The legacy 3-channel DeepLabV2-ResNet101 (reference
    semantic_segmentation_models.py:182-200); it takes BGR
    mean-subtracted [0, 255] input (``train/gan.gan_to_seg_tensor``)."""
    return create_deeplab(seed, device=device, num_classes=num_classes,
                          num_channels=3, head="legacy")


def deeplabv2_resnet101_thermal(num_classes: int = 19, *, seed=0,
                                device=None) -> LegacyDeepLabV2:
    """The legacy 1-channel thermal DeepLabV2-ResNet101 (reference
    thermal_semantic_segmentation_models.py:186-204)."""
    return create_deeplab(seed, device=device, num_classes=num_classes,
                          num_channels=1, head="legacy")


def init_gan_net(model: nn.Module, seed=0, *, device=None) -> nn.Module:
    """Draw ``model``'s weights from ``seed`` (an int or a
    ``torch.Generator``) on the CPU, so a seed gives the same weights on any
    device, then move it to ``device`` (default: the CUDA device; raises
    without one) in ``channels_last`` memory format, in train mode."""
    dev = resolve_device(device)
    generator = seed if isinstance(seed, torch.Generator) else \
        torch.Generator().manual_seed(int(seed))
    model.init_weights_(generator)
    return model.to(device=dev, memory_format=torch.channels_last).train()
