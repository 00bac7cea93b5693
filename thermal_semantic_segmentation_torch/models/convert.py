"""Carry DeepLabV2 and GAN weights from the JAX package's variable trees to
the port.

``jax_variables_to_state_dict`` takes the ``{'params', 'batch_stats'}`` tree
of the JAX ``DeepLabV2`` (numpy arrays or anything ``np.asarray`` accepts)
and returns the reference-layout state_dict that the port's ``DeepLabV2``
loads with ``strict=True``. It is the port's own copy of the mapping (the
port imports nothing of the JAX package) and raises on any key it leaves
unconverted.

Layout transforms:
  conv kernel (kh, kw, I, O) -> weight (O, I, kh, kw)
  dense kernel (I, O)        -> weight (O, I)
  norm scale/bias            -> weight/bias; batch_stats mean/var ->
                                running_mean/running_var
  transposed-conv kernel (kh, kw, I, O) -> weight (I, O, kh, kw), flipped
                                in space (flax's transposed conv correlates
                                where torch's convolves)

The GAN nets' layouts (``_unet_layout``, ``_patchgan_layout``,
``_resnet_gen_layout``) are the port's own copies of the JAX package's
``models/torch_convert.py`` tables: (torch prefix, flax path, kind) per
layer, the torch prefixes following the reference's ``Sequential``
indices (documented in ``nn/generators.py`` and ``nn/patchgan.py``).
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch

_BLOCK = re.compile(r"layer(\d)_(\d+)$")


def _flatten(tree: Mapping, prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def jax_variables_to_state_dict(variables: Mapping) -> Dict[str, torch.Tensor]:
    unknown = set(variables) - {"params", "batch_stats"}
    if unknown:
        raise ValueError(f"unexpected variable collections {sorted(unknown)}")
    params = dict(_flatten(variables["params"]))
    stats = dict(_flatten(variables.get("batch_stats", {})))
    out: Dict[str, torch.Tensor] = {}

    def take(tree, path) -> np.ndarray:
        if path not in tree:
            raise KeyError(f"JAX variables lack {'/'.join(path)}")
        return np.asarray(tree.pop(path), dtype=np.float32)

    def put(key, arr):
        out[key] = torch.from_numpy(np.ascontiguousarray(arr).copy())

    def conv(tp, path, bias=False):
        put(f"{tp}.weight", take(params, path + ("kernel",)).transpose(3, 2, 0, 1))
        if bias:
            put(f"{tp}.bias", take(params, path + ("bias",)))

    def norm(tp, path, running=True):
        put(f"{tp}.weight", take(params, path + ("scale",)))
        put(f"{tp}.bias", take(params, path + ("bias",)))
        if running:
            put(f"{tp}.running_mean", take(stats, path + ("mean",)))
            put(f"{tp}.running_var", take(stats, path + ("var",)))

    def dense(tp, path):
        put(f"{tp}.weight", take(params, path + ("kernel",)).T)
        put(f"{tp}.bias", take(params, path + ("bias",)))

    conv("conv1", ("backbone", "conv1"))
    norm("bn1", ("backbone", "bn1"))
    blocks = sorted({m.groups() for p in params if p[0] == "backbone"
                     for m in [_BLOCK.match(p[1])] if m},
                    key=lambda sb: (int(sb[0]), int(sb[1])))
    for stage, block in blocks:
        tp, mod = f"layer{stage}.{block}", ("backbone", f"layer{stage}_{block}")
        for k in (1, 2, 3):
            conv(f"{tp}.conv{k}", mod + (f"conv{k}",))
            norm(f"{tp}.bn{k}", mod + (f"bn{k}",))
        if mod + ("downsample_conv", "kernel") in params:
            conv(f"{tp}.downsample.0", mod + ("downsample_conv",))
            norm(f"{tp}.downsample.1", mod + ("downsample_bn",))
    if ("bn_pretrain", "scale") in params:
        norm("bn_pretrain", ("bn_pretrain",))

    l5 = ("layer5",)
    i = 0
    while l5 + (f"branch{i}_conv", "kernel") in params:
        conv(f"layer5.conv2d_list.{i}.0", l5 + (f"branch{i}_conv",), bias=True)
        norm(f"layer5.conv2d_list.{i}.1", l5 + (f"branch{i}_gn",),
             running=False)
        i += 1
    dense("layer5.bottleneck.0.se.0", l5 + ("se", "fc1"))
    dense("layer5.bottleneck.0.se.2", l5 + ("se", "fc2"))
    conv("layer5.bottleneck.1", l5 + ("bottleneck_conv",), bias=True)
    norm("layer5.bottleneck.2", l5 + ("bottleneck_gn",), running=False)
    conv("layer5.head.1", l5 + ("head_conv",))

    leftover = ["params/" + "/".join(p) for p in params]
    leftover += ["batch_stats/" + "/".join(p) for p in stats]
    if leftover:
        raise ValueError(f"unconverted JAX variables: {leftover[:10]}")
    return out


def _put(out, key, arr) -> None:
    out[key] = torch.from_numpy(np.array(arr, dtype=np.float32, order="C"))


def _unet_layout(num_downs: int, norm: str = "batch"):
    """(torch prefix, flax path, kind) for the U-Net, outermost level
    first; each level's block nests under the previous one's ``model.1``
    (outermost) or ``model.3``."""
    batch = norm == "batch"
    entries = [("model.model.0", ("down0",), "conv"),
               ("model.model.3", ("up0",), "convT")]
    pfx = "model.model.1"
    for d in range(1, num_downs):
        inner = d == num_downs - 1
        entries.append((f"{pfx}.model.1", (f"down{d}",), "conv"))
        if not inner and batch:
            entries.append((f"{pfx}.model.2", (f"down{d}_norm",), "norm"))
        up_i = 3 if inner else 5
        entries.append((f"{pfx}.model.{up_i}", (f"up{d}",), "convT"))
        if batch:
            entries.append((f"{pfx}.model.{up_i + 1}", (f"up{d}_norm",),
                            "norm"))
        pfx += ".model.3"
    return entries


def _patchgan_layout(n_layers: int = 3, norm: str = "batch"):
    """conv 0, per layer n a conv at 3n-1 and a norm at 3n, the head at
    3 n_layers + 2."""
    entries = [("model.0", ("conv0",), "conv")]
    for n in range(1, n_layers + 1):
        entries.append((f"model.{3 * n - 1}", (f"conv{n}",), "conv"))
        if norm == "batch":
            entries.append((f"model.{3 * n}", (f"norm{n}",), "norm"))
    entries.append((f"model.{3 * n_layers + 2}", ("head",), "conv"))
    return entries


def _resnet_gen_layout(n_blocks: int, norm: str = "batch",
                       use_dropout: bool = False,
                       padding_type: str = "reflect"):
    """[pad 0, stem 1, norm 2, relu 3], downs at 4 + 3i, the blocks, the
    ups, pad, head."""
    batch = norm == "batch"
    entries = [("model.1", ("stem",), "conv")]
    if batch:
        entries.append(("model.2", ("stem_norm",), "norm"))
    idx = 4
    for d in range(2):
        entries.append((f"model.{idx}", (f"down{d}",), "conv"))
        if batch:
            entries.append((f"model.{idx + 1}", (f"down{d}_norm",), "norm"))
        idx += 3
    pad_layers = padding_type in ("reflect", "replicate")
    for bi in range(n_blocks):
        base = f"model.{idx + bi}.conv_block"
        j = 1 if pad_layers else 0
        entries.append((f"{base}.{j}", (f"block{bi}", "conv1"), "conv"))
        if batch:
            entries.append((f"{base}.{j + 1}", (f"block{bi}", "norm1"),
                            "norm"))
        j2 = j + 3 + (1 if use_dropout else 0) + (1 if pad_layers else 0)
        entries.append((f"{base}.{j2}", (f"block{bi}", "conv2"), "conv"))
        if batch:
            entries.append((f"{base}.{j2 + 1}", (f"block{bi}", "norm2"),
                            "norm"))
    idx += n_blocks
    for u in range(2):
        entries.append((f"model.{idx}", (f"up{u}",), "convT"))
        if batch:
            entries.append((f"model.{idx + 1}", (f"up{u}_norm",), "norm"))
        idx += 3
    entries.append((f"model.{idx + 1}", ("head",), "conv"))
    return entries


def _layout_to_state_dict(entries, variables: Mapping):
    """Map a GAN net's JAX variables through a layout; raises on a layer
    the variables lack and on variables the layout leaves unconverted."""
    unknown = set(variables) - {"params", "batch_stats"}
    if unknown:
        raise ValueError(f"unexpected variable collections {sorted(unknown)}")
    params = dict(_flatten(variables["params"]))
    stats = dict(_flatten(variables.get("batch_stats", {})))
    out: Dict[str, torch.Tensor] = {}

    def take(tree, path):
        if path not in tree:
            raise KeyError(f"JAX variables lack {'/'.join(path)}")
        return np.asarray(tree.pop(path), dtype=np.float32)

    for tp, path, kind in entries:
        if kind == "norm":
            _put(out, f"{tp}.weight", take(params, path + ("scale",)))
            _put(out, f"{tp}.bias", take(params, path + ("bias",)))
            _put(out, f"{tp}.running_mean", take(stats, path + ("mean",)))
            _put(out, f"{tp}.running_var", take(stats, path + ("var",)))
            continue
        kernel = take(params, path + ("kernel",))
        _put(out, f"{tp}.weight", kernel.transpose(3, 2, 0, 1)
             if kind == "conv" else kernel[::-1, ::-1].transpose(2, 3, 0, 1))
        if path + ("bias",) in params:
            _put(out, f"{tp}.bias", take(params, path + ("bias",)))
    leftover = ["params/" + "/".join(p) for p in params]
    leftover += ["batch_stats/" + "/".join(p) for p in stats]
    if leftover:
        raise ValueError(f"unconverted JAX variables: {leftover[:10]}")
    return out


def unet_num_downs(variables: Mapping) -> int:
    """The U-Net depth of JAX U-Net variables: its count of down convs."""
    return sum(1 for k in variables["params"] if re.fullmatch(r"down\d+", k))


def unet_variables_to_state_dict(variables: Mapping, *, num_downs=None,
                                 norm: str = "batch"):
    """JAX ``UnetGenerator`` variables -> the port's (reference) state_dict;
    the depth is read from the variables unless given."""
    if num_downs is None:
        num_downs = unet_num_downs(variables)
    return _layout_to_state_dict(_unet_layout(num_downs, norm), variables)


def patchgan_variables_to_state_dict(variables: Mapping, *,
                                     n_layers: int = 3, norm: str = "batch"):
    return _layout_to_state_dict(_patchgan_layout(n_layers, norm), variables)


def resnet_generator_variables_to_state_dict(
        variables: Mapping, *, n_blocks: int, norm: str = "batch",
        use_dropout: bool = False, padding_type: str = "reflect"):
    return _layout_to_state_dict(
        _resnet_gen_layout(n_blocks, norm, use_dropout, padding_type),
        variables)


GAN_KEYS = {"g": (("s2t", "net_g_s2t_state_dict"),
                  ("t2s", "net_g_t2s_state_dict")),
            "d": (("t", "net_d_t_state_dict"), ("s", "net_d_s_state_dict"))}


def jax_gan_checkpoint_to_torch(ckpt: Mapping, *, norm: str = "batch",
                                n_layers: int = 3) -> dict:
    """The JAX package's GAN checkpoint (``{'epoch', 'g_vars', 'd_vars'}``,
    U-Net generators and PatchGANs) -> the reference ``.pth`` schema
    ``{'epoch', 'net_g_s2t_state_dict', 'net_g_t2s_state_dict',
    'net_d_t_state_dict', 'net_d_s_state_dict'}`` (the nets it holds)."""
    out = {"epoch": int(ckpt["epoch"])}
    for name, key in GAN_KEYS["g"]:
        if name in ckpt.get("g_vars", {}):
            out[key] = unet_variables_to_state_dict(ckpt["g_vars"][name],
                                                    norm=norm)
    for name, key in GAN_KEYS["d"]:
        if name in ckpt.get("d_vars", {}):
            out[key] = patchgan_variables_to_state_dict(
                ckpt["d_vars"][name], n_layers=n_layers, norm=norm)
    return out
