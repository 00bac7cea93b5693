"""Model zoo and checkpoint converters.

``models/convert.py`` is the JAX ``models/torch_convert.py``; its
``flax_*`` converters are ``jax_*`` here (``RENAMED``). The JAX names in
``LEFT_OUT`` have no counterpart, each for the reason given.
"""

from .convert import jax_variables_to_state_dict
from .deeplab import DeepLabV2, create_deeplab
from .factory import (deeplabv2_resnet101, deeplabv2_resnet101_thermal,
                      init_gan_net, patchgan, resnet_6, resnet_9, unet_32,
                      unet_128, unet_256)

RENAMED = {"flax_to_torch_state_dict": "jax_variables_to_state_dict"}
LEFT_OUT = {
    "torch_legacy_state_dict_to_flax": "not needed in torch: a legacy .pth "
                                       "loads natively",
    "torch_state_dict_to_flax": "not needed in torch: a .pth loads "
                                "natively",
}

__all__ = ["DeepLabV2", "create_deeplab", "deeplabv2_resnet101",
           "deeplabv2_resnet101_thermal", "init_gan_net", "patchgan",
           "resnet_6", "resnet_9", "unet_32", "unet_128", "unet_256",
           "jax_variables_to_state_dict"]
