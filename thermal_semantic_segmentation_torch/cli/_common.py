"""Shared CLI plumbing: dataset selection, checkpoint loading and saving
(seg and GAN), and model construction (counterpart of the JAX
``cli/_common.py``).

Under ``--distributed`` every rank runs the same loop on replicated
weights; checkpoint writes funnel through process 0 (``primary_host``),
which assumes the ranks share the storage they resume from."""

from __future__ import annotations

import os
import re
import tempfile
import zipfile
from typing import Optional

import numpy as np
import torch

from ..core.checkpoint import load_checkpoint
from ..data import transforms as T
from ..data.cityscapes import Cityscapes, CityscapesTranslation
from ..data.freiburg import Freiburg, FreiburgTest, FreiburgTranslationPairs
from ..device import resolve_device
from ..models.convert import (GAN_KEYS, jax_gan_checkpoint_to_torch,
                              jax_legacy_variables_to_state_dict,
                              jax_variables_to_state_dict)
from ..models.deeplab import create_deeplab
from ..nn.generators import UnetGenerator
from ..parallel.mesh import process_count, process_index

_BLOCK_KEY = re.compile(r"layer([1-4])\.(\d+)\.conv1\.weight$")
# numpy objects a reference .pth may carry beside its tensors (the JAX
# package's export stores epoch/val_loss as numpy arrays): numpy's array
# reconstructor and the numeric dtypes, and nothing else (no object arrays)
_NUMPY_SAFE = [(getattr(np, "_core", None) or np.core).multiarray._reconstruct,
               np.ndarray, np.dtype] + [
    type(np.dtype(t)) for t in
    ("b1", "i1", "i2", "i4", "i8", "u1", "u2", "u4", "u8", "f2", "f4", "f8")]


def resolve_wire(args, *, bf16_compute: bool | None = None) -> str | None:
    """``--wire`` as a ``device_prefetch`` mode (None for 'none'), keeping
    the lossy 'packed_bf16' to runs that compute in bfloat16: a float32 run
    (``--bf16`` false, or ``bf16_compute=False``) gets 'packed' with a
    warning instead, as the JAX CLIs do."""
    wire = getattr(args, "wire", "packed")
    if wire == "none":
        return None
    if wire == "packed_bf16":
        bf16 = (bf16_compute if bf16_compute is not None
                else getattr(args, "bf16", False))
        if not bf16:
            import logging
            logging.getLogger(__name__).warning(
                "--wire packed_bf16 requires bf16 compute to be lossless; "
                "this run computes in float32 — using --wire packed instead")
            return "packed"
    return wire


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
    segmentation_evaluate.py:99-118): Cityscapes, original or translated;
    the Freiburg IR and RGB splits (train, or test with ``for_eval``);
    translated Freiburg (train: the RGB frames' translations under
    ``-translation_name``; eval: the ``*_translation.jpg`` pairs under
    ``translations/test_<checkpoint name minus _segmentation.pth>/``); and
    the thermal-to-RGB pairs under ``translations/t2s/<-t2s_folder>``."""
    name = args.dataset
    if name == "cityscapes_translation":
        return CityscapesTranslation(args.source_root, transforms=transform)
    if name == "cityscapes":
        return Cityscapes(args.source_root, transforms=transform)
    if name in ("freiburg_ir", "freiburg_rgb"):
        domain = "IR" if name == "freiburg_ir" else "RGB"
        if for_eval:
            return FreiburgTest(args.freiburg_root, "test", domain,
                                transforms=transform, with_label=True,
                                grayscale=args.grayscale)
        return Freiburg(args.freiburg_root, "train", domain,
                        transforms=transform, with_label=True,
                        grayscale=args.grayscale,
                        native_decode=getattr(args, "native_decode", False))
    if name == "freiburg_translation":
        if for_eval:
            folder = "test_" + args.checkpoint_name.replace(
                "_segmentation.pth", "") + "/"
            return FreiburgTranslationPairs(
                folder=folder, transforms=transform,
                root=os.path.join(args.freiburg_root, "translations"))
        return Freiburg(args.freiburg_root, "train", "RGB",
                        transforms=transform, with_label=True,
                        segmentation_mode=True,
                        translation_name=args.translation_name)
    if name == "freiburg_t2s":
        return FreiburgTranslationPairs(
            folder=args.t2s_folder, transforms=transform,
            root=os.path.join(args.freiburg_root, "translations", "t2s"),
            strip_underscore=False)
    raise ValueError("dataset does not exist.")


def model_meta_from_state_dict(sd) -> dict:
    """Architecture of a reference DeepLabV2 (module2 head) state_dict: the
    checkpoint is authoritative for it, as its tensors ARE that model."""
    if "conv1.weight" not in sd or "layer5.head.1.weight" not in sd:
        raise ValueError("not a DeepLabV2 state_dict with the module2 head: "
                         "the seg CLIs build the module2 head only, as the "
                         "JAX package's do (a legacy-head net is a GAN's "
                         "frozen sem net, -sem_mode legacy)")
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
    if not os.path.exists(path) and process_count() > 1:
        raise FileNotFoundError(
            f"checkpoint {path!r} not found on process {process_index()}: "
            f"multi-process runs write checkpoints from process 0 only and "
            f"resume from storage every process shares")
    if zipfile.is_zipfile(path):
        ckpt = _torch_load(path)
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


def load_legacy_sem_state_dict(path: str):
    """A frozen legacy sem net's state_dict (``LegacyDeepLabV2``'s keys)
    from a reference legacy ``.pth`` (a bare state_dict, or one under
    ``sem_net_state_dict``) or from the JAX package's msgpack
    (``{'variables'}`` or bare ``DeepLabV2(head='legacy')`` variables),
    as the JAX CLI's ``_load_sem_variables`` reads them."""
    if zipfile.is_zipfile(path):
        ckpt = _torch_load(path)
        return ckpt.get("sem_net_state_dict", ckpt)
    try:
        ckpt = load_checkpoint(path)
    except ValueError as e:
        raise ValueError(f"{path!r} is neither a torch .pth nor a "
                         f"msgpack checkpoint: {e}") from e
    if not isinstance(ckpt, dict):
        raise ValueError(f"{path!r} holds no legacy sem-net variables")
    return jax_legacy_variables_to_state_dict(ckpt.get("variables", ckpt))


def _torch_load(path: str):
    """A ``.pth`` read with ``weights_only=True``: tensors, containers,
    numbers and numpy's numeric arrays, nothing else."""
    with torch.serialization.safe_globals(_NUMPY_SAFE):
        return torch.load(path, map_location="cpu", weights_only=True)


def primary_host() -> bool:
    """True on the process that owns the shared file system's side
    effects: rank 0 of a multi-process job, always with one process."""
    return process_index() == 0


def _save_atomically(path: str, payload: dict) -> None:
    """``torch.save`` into a temporary file beside ``path``, then
    ``os.replace``: a reader never sees a half-written checkpoint. Only
    process 0 writes (``primary_host``): all ranks writing one path would
    double the IO and race readers of a network file system."""
    if not primary_host():
        return
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


def save_seg_checkpoint(path: str, state_dict, *, epoch: int,
                        val_loss: Optional[float] = None,
                        highest_mean_iu: Optional[float] = None,
                        objective_vectors=None) -> None:
    """Write the reference seg ``.pth`` schema ``{'epoch',
    'sem_net_state_dict', 'val_loss'}`` (reference
    segmentation_train.py:182-190), tensors on the CPU, atomically: into a
    temporary file beside ``path``, then ``os.replace``. The state_dict
    carries the architecture (``model_meta_from_state_dict``). The
    self-training saves carry ``highest_mean_iu`` and the moving prototypes
    ``objective_vectors`` (a float32 CPU tensor) instead of ``val_loss``
    (JAX cli/self_train_main.py:120-127); a key left at None is not
    written."""
    payload = {"epoch": int(epoch),
               "sem_net_state_dict": {k: v.detach().cpu()
                                      for k, v in state_dict.items()}}
    if val_loss is not None:
        payload["val_loss"] = float(val_loss)
    if highest_mean_iu is not None:
        payload["highest_mean_iu"] = float(highest_mean_iu)
    if objective_vectors is not None:
        payload["objective_vectors"] = torch.as_tensor(
            objective_vectors, dtype=torch.float32).detach().cpu().clone()
    _save_atomically(path, payload)


def save_gan_checkpoint(path: str, g_nets, d_nets, *, epoch: int) -> None:
    """Write the reference GAN ``.pth`` schema (reference main.py:128-136,
    main_gan.py:110-114): ``{'epoch', 'net_g_s2t_state_dict',
    'net_g_t2s_state_dict', 'net_d_t_state_dict', 'net_d_s_state_dict'}``
    for the nets given ({'s2t', 't2s'} and {'t', 's'}: modules or their
    state_dicts), tensors on the CPU, atomically. The JAX package's CLIs read it (its ``.pth`` path)."""
    payload = {"epoch": int(epoch)}
    for nets, keys in ((g_nets, GAN_KEYS["g"]), (d_nets, GAN_KEYS["d"])):
        for name, key in keys:
            if name in nets:
                net = nets[name]
                sd = net.state_dict() if isinstance(net, torch.nn.Module) \
                    else net
                payload[key] = {k: v.detach().cpu() for k, v in sd.items()}
    _save_atomically(path, payload)


def load_gan_checkpoint(path: str, *, norm: str = "batch",
                        num_downs=None) -> dict:
    """A GAN checkpoint in the reference ``.pth`` schema, read from a
    ``.pth`` (``torch.load(weights_only=True)``) or from the JAX package's
    msgpack GAN checkpoint (``{'epoch', 'g_vars', 'd_vars'}`` and any
    ``'sem_vars'``, converted by ``jax_gan_checkpoint_to_torch``). The
    frozen legacy sem nets of a reference ``.pth``
    (``net_seg_s_state_dict``, ``net_seg_t_state_dict``) are kept.
    ``norm`` and ``num_downs`` describe a msgpack checkpoint's nets
    (``jax_gan_checkpoint_to_torch``)."""
    if zipfile.is_zipfile(path):
        ckpt = _torch_load(path)
    else:
        try:
            ckpt = load_checkpoint(path)
        except ValueError as e:
            raise ValueError(f"{path!r} is neither a torch .pth nor a "
                             f"msgpack checkpoint: {e}") from e
        if not isinstance(ckpt, dict) or "g_vars" not in ckpt:
            raise ValueError(f"{path!r} is a msgpack file without a GAN "
                             f"checkpoint's 'g_vars'")
        ckpt = jax_gan_checkpoint_to_torch(ckpt, norm=norm,
                                           num_downs=num_downs)
    if "epoch" not in ckpt or not any(key in ckpt for _, key in
                                      GAN_KEYS["g"]):
        raise ValueError(f"{path!r} holds no GAN generator")
    return ckpt


def build_generator_from_gan_checkpoint(path: str, generator_type: str, *,
                                        input_nc: int, output_nc: int,
                                        device=None):
    """The U-Net generator ``generator_type`` ('s2t' or 't2s') of a GAN
    checkpoint, loaded strictly, in eval mode, ``channels_last`` on
    ``device`` (default: the CUDA device; raises without one). The
    checkpoint is authoritative for the width (``model.model.0.weight``'s
    output channels) and the depth (the nesting of its keys), as a
    training run's ``-ngf`` may differ from the default. Returns (model,
    ngf)."""
    device = resolve_device(device)
    ckpt = load_gan_checkpoint(path)
    key = dict(GAN_KEYS["g"])[generator_type]
    if key not in ckpt:
        raise KeyError(f"{path!r} has no {generator_type} generator")
    sd = ckpt[key]
    ngf = int(sd["model.model.0.weight"].shape[0])
    num_downs = max(k.count(".model.") for k in sd)
    model = UnetGenerator(input_nc, output_nc, num_downs=num_downs, ngf=ngf)
    model.load_state_dict(sd, strict=True)
    return model.to(device=device,
                     memory_format=torch.channels_last).eval(), ngf


def maybe_data_parallel(args, batch_size: int, verb: str):
    """The ``LocalMesh`` of ``--data_parallel`` for an inference loop over
    batches of ``batch_size`` (JAX ``maybe_data_parallel``), or None with
    the flag off. Its devices: every card this process sees, shrunk to a
    count that divides ``batch_size`` (``parallel/mesh.local_data_mesh``);
    under ``--distributed`` this rank's own card, since every rank holds
    one."""
    if not getattr(args, "data_parallel", False):
        return None
    from ..parallel.mesh import local_data_mesh, process_count
    devices = None
    if process_count() > 1:
        devices = [resolve_device(getattr(args, "device", "") or None)]
    mesh = local_data_mesh(batch_size=batch_size, devices=devices)
    print(f"{verb} data-parallel over {mesh.size} devices")
    return mesh


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
    """net_mode switch -> a seeded ``DeepLabV2`` on ``device``, its
    backbone rematerialised as ``--remat`` says."""
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
                          layers=getattr(args, "layers", (3, 4, 23, 3)),
                          remat=getattr(args, "remat", "none"))
