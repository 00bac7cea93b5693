"""Datasets, transforms and the prefetching loader (the JAX
``data/__init__.py``'s public names).

The JAX package sets PIL's ``ImageFile.LOAD_TRUNCATED_IMAGES`` here, for
every PIL read. The port imports no PIL at import time: its PNG reader
decodes a truncated file as PIL does with that flag, and
``image.read_image`` sets the flag where it hands a JPEG to PIL.
"""

from .cityscapes import Cityscapes, CityscapesTranslation, remap_label
from .freiburg import Freiburg, FreiburgTest, FreiburgTranslationPairs
from .loader import DataLoader, default_collate, split_indices
from .palette import colorize_prediction, freiburg_palette
from .self_train_aug import SelfTrainAugment
from .simple import DistanceDataset, FlirTrain, Kitti

__all__ = ["Cityscapes", "CityscapesTranslation", "remap_label", "Freiburg",
           "FreiburgTest", "FreiburgTranslationPairs", "DataLoader",
           "default_collate", "split_indices", "colorize_prediction",
           "freiburg_palette", "SelfTrainAugment", "DistanceDataset",
           "FlirTrain", "Kitti"]
