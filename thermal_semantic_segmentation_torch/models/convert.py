"""Carry DeepLabV2 and GAN weights from the JAX package's variable trees to
the port.

``jax_variables_to_state_dict`` takes the ``{'params', 'batch_stats'}`` tree
of the JAX ``DeepLabV2`` (numpy arrays or anything ``np.asarray`` accepts)
and returns the reference-layout state_dict that the port's ``DeepLabV2``
loads with ``strict=True``; ``jax_legacy_variables_to_state_dict`` does
the same for the legacy head and ``LegacyDeepLabV2``. They are the port's
own copy of the mapping (the port imports nothing of the JAX package) and
raise on any key they leave unconverted.

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


class _Converter:
    """One JAX variable tree on its way to a state_dict: ``take`` pops a
    leaf (raising when it is missing), ``finish`` raises on any leaf left
    unconverted."""

    def __init__(self, variables: Mapping):
        unknown = set(variables) - {"params", "batch_stats"}
        if unknown:
            raise ValueError(
                f"unexpected variable collections {sorted(unknown)}")
        self.params = dict(_flatten(variables["params"]))
        self.stats = dict(_flatten(variables.get("batch_stats", {})))
        self.out: Dict[str, torch.Tensor] = {}

    @staticmethod
    def take(tree, path) -> np.ndarray:
        if path not in tree:
            raise KeyError(f"JAX variables lack {'/'.join(path)}")
        return np.asarray(tree.pop(path), dtype=np.float32)

    def conv(self, tp, path, bias=False):
        _put(self.out, f"{tp}.weight",
             self.take(self.params, path + ("kernel",)).transpose(3, 2, 0, 1))
        if bias:
            _put(self.out, f"{tp}.bias", self.take(self.params,
                                                   path + ("bias",)))

    def norm(self, tp, path, running=True):
        _put(self.out, f"{tp}.weight", self.take(self.params,
                                                 path + ("scale",)))
        _put(self.out, f"{tp}.bias", self.take(self.params, path + ("bias",)))
        if running:
            _put(self.out, f"{tp}.running_mean",
                 self.take(self.stats, path + ("mean",)))
            _put(self.out, f"{tp}.running_var",
                 self.take(self.stats, path + ("var",)))

    def dense(self, tp, path):
        _put(self.out, f"{tp}.weight",
             self.take(self.params, path + ("kernel",)).T)
        _put(self.out, f"{tp}.bias", self.take(self.params, path + ("bias",)))

    def backbone(self, prefix: str) -> None:
        """The ResNet backbone, its torch keys under ``prefix``."""
        params = self.params
        self.conv(f"{prefix}conv1", ("backbone", "conv1"))
        self.norm(f"{prefix}bn1", ("backbone", "bn1"))
        blocks = sorted({m.groups() for p in params if p[0] == "backbone"
                         for m in [_BLOCK.match(p[1])] if m},
                        key=lambda sb: (int(sb[0]), int(sb[1])))
        for stage, block in blocks:
            tp = f"{prefix}layer{stage}.{block}"
            mod = ("backbone", f"layer{stage}_{block}")
            for k in (1, 2, 3):
                self.conv(f"{tp}.conv{k}", mod + (f"conv{k}",))
                self.norm(f"{tp}.bn{k}", mod + (f"bn{k}",))
            if mod + ("downsample_conv", "kernel") in params:
                self.conv(f"{tp}.downsample.0", mod + ("downsample_conv",))
                self.norm(f"{tp}.downsample.1", mod + ("downsample_bn",))

    def finish(self) -> Dict[str, torch.Tensor]:
        leftover = ["params/" + "/".join(p) for p in self.params]
        leftover += ["batch_stats/" + "/".join(p) for p in self.stats]
        if leftover:
            raise ValueError(f"unconverted JAX variables: {leftover[:10]}")
        return self.out


def jax_variables_to_state_dict(variables: Mapping) -> Dict[str, torch.Tensor]:
    """JAX ``DeepLabV2`` (module2 head) variables -> the port's
    ``DeepLabV2`` state_dict."""
    c = _Converter(variables)
    c.backbone("")
    if ("bn_pretrain", "scale") in c.params:
        c.norm("bn_pretrain", ("bn_pretrain",))
    l5 = ("layer5",)
    i = 0
    while l5 + (f"branch{i}_conv", "kernel") in c.params:
        c.conv(f"layer5.conv2d_list.{i}.0", l5 + (f"branch{i}_conv",),
               bias=True)
        c.norm(f"layer5.conv2d_list.{i}.1", l5 + (f"branch{i}_gn",),
               running=False)
        i += 1
    c.dense("layer5.bottleneck.0.se.0", l5 + ("se", "fc1"))
    c.dense("layer5.bottleneck.0.se.2", l5 + ("se", "fc2"))
    c.conv("layer5.bottleneck.1", l5 + ("bottleneck_conv",), bias=True)
    c.norm("layer5.bottleneck.2", l5 + ("bottleneck_gn",), running=False)
    c.conv("layer5.head.1", l5 + ("head_conv",))
    return c.finish()


def jax_legacy_variables_to_state_dict(
        variables: Mapping) -> Dict[str, torch.Tensor]:
    """JAX ``DeepLabV2(head='legacy')`` variables -> the port's
    ``LegacyDeepLabV2`` state_dict, in the reference legacy keys
    (``backbone.*``, ``classifier.conv2d_list.{i}.{weight,bias}``): the
    inverse of the JAX package's ``torch_legacy_state_dict_to_flax``."""
    c = _Converter(variables)
    c.backbone("backbone.")
    i = 0
    while ("layer5", f"branch{i}_conv", "kernel") in c.params:
        c.conv(f"classifier.conv2d_list.{i}", ("layer5", f"branch{i}_conv"),
               bias=True)
        i += 1
    return c.finish()


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
    c = _Converter(variables)
    for tp, path, kind in entries:
        if kind == "norm":
            c.norm(tp, path)
        elif kind == "conv":
            c.conv(tp, path, bias=path + ("bias",) in c.params)
        else:
            kernel = c.take(c.params, path + ("kernel",))
            _put(c.out, f"{tp}.weight",
                 kernel[::-1, ::-1].transpose(2, 3, 0, 1))
            if path + ("bias",) in c.params:
                _put(c.out, f"{tp}.bias", c.take(c.params, path + ("bias",)))
    return c.finish()


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
            "d": (("t", "net_d_t_state_dict"), ("s", "net_d_s_state_dict")),
            "sem": (("s", "net_seg_s_state_dict"),
                    ("t", "net_seg_t_state_dict"))}


def jax_gan_checkpoint_to_torch(ckpt: Mapping, *, norm: str = "batch",
                                n_layers: int = 3, num_downs=None) -> dict:
    """The JAX package's GAN checkpoint (``{'epoch', 'g_vars', 'd_vars'}``,
    U-Net generators and PatchGANs, and ``'sem_vars'``, the frozen legacy
    sem nets, when it has them) -> the reference ``.pth`` schema
    ``{'epoch', 'net_g_s2t_state_dict', 'net_g_t2s_state_dict',
    'net_d_t_state_dict', 'net_d_s_state_dict', 'net_seg_s_state_dict',
    'net_seg_t_state_dict'}`` (the nets it holds). ``num_downs``: the
    U-Nets' depth, read from their variables when None."""
    out = {"epoch": int(ckpt["epoch"])}
    for name, key in GAN_KEYS["g"]:
        if name in ckpt.get("g_vars", {}):
            out[key] = unet_variables_to_state_dict(
                ckpt["g_vars"][name], num_downs=num_downs, norm=norm)
    for name, key in GAN_KEYS["d"]:
        if name in ckpt.get("d_vars", {}):
            out[key] = patchgan_variables_to_state_dict(
                ckpt["d_vars"][name], n_layers=n_layers, norm=norm)
    for name, key in GAN_KEYS["sem"]:
        if name in ckpt.get("sem_vars", {}):
            out[key] = jax_legacy_variables_to_state_dict(
                ckpt["sem_vars"][name])
    return out
