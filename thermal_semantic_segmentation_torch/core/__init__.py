"""Core: checkpointing, random streams, schedules."""

from .checkpoint import (AsyncCheckpointer, abstract_like, load_checkpoint,
                         load_sharded, save_checkpoint, save_sharded)
from .prng import host_rng, split_for_step
from .schedule import ReduceLROnPlateau, poly_lr

__all__ = ["AsyncCheckpointer", "abstract_like", "load_checkpoint",
           "load_sharded", "save_checkpoint", "save_sharded", "host_rng",
           "split_for_step", "ReduceLROnPlateau", "poly_lr"]
