"""Carry DeepLabV2 weights from the JAX package's variable tree to the port.

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
