"""Training engines.

The JAX names in ``LEFT_OUT`` have no counterpart, each for the reason
given.
"""

from .gan import GanTrainState, create_gan_state, make_gan_steps
from .prototypes import calc_prototypes, make_prototype_step
from .pseudo import generate_pseudo_labels, make_pseudo_fns
from .seg import (SegTrainState, build_seg_eval_step, create_seg_state,
                  make_seg_train_step)
from .self_train import (SelfTrainState, create_self_train_state,
                         full2weak_coords, make_self_train_step,
                         prototype_weights)

LEFT_OUT = {
    "make_fused_gan_step": "TPU rewrite: the fused GAN step with the "
                           "device image pool",
}

__all__ = ["GanTrainState", "create_gan_state", "make_gan_steps",
           "calc_prototypes", "make_prototype_step", "generate_pseudo_labels",
           "make_pseudo_fns", "SegTrainState", "build_seg_eval_step",
           "create_seg_state", "make_seg_train_step", "SelfTrainState",
           "create_self_train_state", "full2weak_coords",
           "make_self_train_step", "prototype_weights"]
