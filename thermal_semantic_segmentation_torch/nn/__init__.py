"""torch.nn building blocks (the JAX package's flax.linen ones)."""

from .aspp import ASPPLegacy, ASPPModule2, SEBlock
from .canny import canny_edges
from .generators import ResnetGenerator, UnetGenerator
from .norms import make_norm
from .patchgan import NLayerDiscriminator
from .resnet import Bottleneck, ResNetBackbone

__all__ = ["ASPPLegacy", "ASPPModule2", "SEBlock", "canny_edges",
           "ResnetGenerator", "UnetGenerator", "make_norm",
           "NLayerDiscriminator", "Bottleneck", "ResNetBackbone"]
