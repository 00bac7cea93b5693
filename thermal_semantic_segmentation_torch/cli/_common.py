"""Shared CLI plumbing: dataset selection, checkpoint loading and saving,
and model construction (counterpart of the JAX ``cli/_common.py``)."""

from __future__ import annotations

import os
import re
import tempfile
import zipfile

import numpy as np
import torch

from ..core.checkpoint import load_checkpoint
from ..data import transforms as T
from ..data.cityscapes import Cityscapes, CityscapesTranslation
from ..data.freiburg import Freiburg, FreiburgTest
from ..models.convert import jax_variables_to_state_dict
from ..models.deeplab import create_deeplab

_BLOCK_KEY = re.compile(r"layer([1-4])\.(\d+)\.conv1\.weight$")
# numpy objects a reference .pth may carry beside its tensors (the JAX
# package's export stores epoch/val_loss as numpy arrays): numpy's array
# reconstructor and the numeric dtypes, and nothing else (no object arrays)
_NUMPY_SAFE = [(getattr(np, "_core", None) or np.core).multiarray._reconstruct,
               np.ndarray, np.dtype] + [
    type(np.dtype(t)) for t in
    ("b1", "i1", "i2", "i4", "i8", "u1", "u2", "u4", "u8", "f2", "f4", "f8")]


def train_transform():
    """The train augmentation (reference segmentation_train.py:89-94):
    RandomResizedCrop to 256x512 with scale (0.5, 1) and ratio (1.5, 8/3),
    a horizontal flip, ToArray."""
    return T.Compose([
        T.RandomResizedCrop(size=(256, 512), ratio=(1.5, 8 / 3.),
                            scale=(0.5, 1.0)),
        T.RandomHorizontalFlip(),
        T.ToArray(),
    ])


def val_transform():
    """Resize((512, 256)) + ToArray (reference segmentation_train.py:96-99)."""
    return T.Compose([T.Resize((512, 256)), T.ToArray()])


def build_seg_dataset(args, transform, *, for_eval: bool = False):
    """The dataset switch of the reference (segmentation_train.py:104-123,
    segmentation_evaluate.py:99-118). Train: Cityscapes (original or
    translated) and the Freiburg train split (IR, RGB, translated RGB).
    Eval: the Freiburg IR and RGB test splits; the eval CLI's other
    datasets are not yet ported."""
    name = args.dataset
    if name not in ("cityscapes", "cityscapes_translation", "freiburg_ir",
                    "freiburg_rgb", "freiburg_translation", "freiburg_t2s"):
        raise ValueError("dataset does not exist.")
    if for_eval and name in ("freiburg_ir", "freiburg_rgb"):
        return FreiburgTest(args.freiburg_root, "test",
                            "IR" if name == "freiburg_ir" else "RGB",
                            transforms=transform, with_label=True,
                            grayscale=args.grayscale)
    if for_eval or name == "freiburg_t2s":
        raise NotImplementedError(
            f"the {name} {'test' if for_eval else 'train'} dataset is not "
            f"yet ported to the PyTorch package (see ROADMAP.md)")
    if name == "cityscapes_translation":
        return CityscapesTranslation(args.source_root, transforms=transform)
    if name == "cityscapes":
        return Cityscapes(args.source_root, transforms=transform)
    if name == "freiburg_translation":
        return Freiburg(args.freiburg_root, "train", "RGB",
                        transforms=transform, with_label=True,
                        segmentation_mode=True,
                        translation_name=args.translation_name)
    return Freiburg(args.freiburg_root, "train",
                    "IR" if name == "freiburg_ir" else "RGB",
                    transforms=transform, with_label=True,
                    grayscale=args.grayscale)


def model_meta_from_state_dict(sd) -> dict:
    """Architecture of a reference DeepLabV2 (module2 head) state_dict: the
    checkpoint is authoritative for it, as its tensors ARE that model."""
    if "conv1.weight" not in sd or "layer5.head.1.weight" not in sd:
        raise ValueError("not a DeepLabV2 state_dict with the module2 head "
                         "(legacy-head checkpoints are not yet ported)")
    blocks = {}
    for key in sd:
        m = _BLOCK_KEY.match(key)
        if m:
            stage, block = int(m.group(1)), int(m.group(2))
            blocks[stage] = max(blocks.get(stage, 0), block + 1)
    return {"layers": [blocks.get(s, 0) for s in (1, 2, 3, 4)],
            "num_channels": int(sd["conv1.weight"].shape[1]),
            "num_classes": int(sd["layer5.head.1.weight"].shape[0]),
            "bn_clr": "bn_pretrain.weight" in sd}


def load_seg_checkpoint(path: str):
    """Load a seg checkpoint: a reference-schema ``.pth``
    (``{'sem_net_state_dict', 'epoch', 'val_loss', ...}`` or a bare
    state_dict, read with ``torch.load(weights_only=True)``), or the JAX
    package's native msgpack checkpoint (``{'variables', 'epoch', ...}``,
    its variables converted by ``jax_variables_to_state_dict``).

    Returns (state_dict, meta); meta carries the checkpoint's extra keys plus
    the architecture read from the state_dict.
    """
    if zipfile.is_zipfile(path):
        with torch.serialization.safe_globals(_NUMPY_SAFE):
            ckpt = torch.load(path, map_location="cpu", weights_only=True)
        if "sem_net_state_dict" in ckpt:
            sd = ckpt["sem_net_state_dict"]
            meta = {k: v for k, v in ckpt.items()
                    if not k.endswith("state_dict")}
        else:
            sd, meta = ckpt, {}
    else:
        try:
            ckpt = load_checkpoint(path)
        except ValueError as e:
            raise ValueError(f"{path!r} is neither a torch .pth nor a "
                             f"msgpack checkpoint: {e}") from e
        if not isinstance(ckpt, dict) or "variables" not in ckpt:
            raise ValueError(f"{path!r} is a msgpack file without the seg "
                             f"checkpoint's 'variables'")
        meta = dict(ckpt)
        sd = jax_variables_to_state_dict(meta.pop("variables"))
    meta.update(model_meta_from_state_dict(sd))
    return sd, meta


def save_seg_checkpoint(path: str, state_dict, *, epoch: int,
                        val_loss: float) -> None:
    """Write the reference seg ``.pth`` schema ``{'epoch',
    'sem_net_state_dict', 'val_loss'}`` (reference
    segmentation_train.py:182-190), tensors on the CPU, atomically: into a
    temporary file beside ``path``, then ``os.replace``. The state_dict
    carries the architecture (``model_meta_from_state_dict``)."""
    payload = {"epoch": int(epoch),
               "sem_net_state_dict": {k: v.detach().cpu()
                                      for k, v in state_dict.items()},
               "val_loss": float(val_loss)}
    directory = os.path.dirname(os.path.abspath(path))
    os.makedirs(directory, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            torch.save(payload, f)
        os.replace(tmp, path)
    except BaseException:
        os.unlink(tmp)
        raise


def model_meta(args) -> dict:
    """The architecture ``args`` builds, in ``model_meta_from_state_dict``'s
    keys, so a saved checkpoint can be held to it."""
    return {"layers": list(getattr(args, "layers", (3, 4, 23, 3))),
            "num_channels": 1 if args.net_mode == "one_channel" else 3,
            "num_classes": int(args.num_classes),
            "bn_clr": bool(getattr(args, "bn_clr", False))}


def apply_model_meta(args, meta) -> None:
    """Adopt architecture keys from checkpoint meta into ``args`` before the
    model is built (the checkpoint is authoritative)."""
    def as_cmp(v):
        return tuple(v) if isinstance(v, (list, tuple)) else v

    updates = {}
    if "layers" in meta:
        updates["layers"] = tuple(int(x) for x in meta["layers"])
    if "num_channels" in meta:
        updates["net_mode"] = ("one_channel" if int(meta["num_channels"]) == 1
                               else "three_channels")
    if "num_classes" in meta:
        updates["num_classes"] = int(meta["num_classes"])
    if "bn_clr" in meta:
        updates["bn_clr"] = bool(meta["bn_clr"])
    for key, new in updates.items():
        old = getattr(args, key, None)
        if old is not None and as_cmp(old) != as_cmp(new):
            print(f"checkpoint meta overrides --{key}: {old} -> {new}")
        setattr(args, key, new)


def build_deeplab(args, *, device=None):
    """net_mode switch -> a seeded ``DeepLabV2`` on ``device``."""
    if args.net_mode == "one_channel":
        num_channels = 1
    elif args.net_mode == "three_channels":
        num_channels = 3
    else:
        raise ValueError("net mode does not exist.")
    return create_deeplab(args.seed, device=device,
                          num_classes=args.num_classes,
                          num_channels=num_channels,
                          bn_clr=getattr(args, "bn_clr", False),
                          layers=getattr(args, "layers", (3, 4, 23, 3)))
