"""The port's (data, spatial) mesh (parallel/mesh.make_mesh_2d,
parallel/spatial.py, the width-sharded layers of nn/spatial.py, the
sharded upsample of ops/resize.py and the seg train step of train/seg.py
on a ``SpatialMesh``) in four processes over gloo on the CPU, against
the JAX package's dp x sp step in this one.

The worker is this file run as a script: ``python
tests/test_torch_spatial.py <rank> <world> <port> <out>``. It joins a
gloo group of four, runs every case at layouts data 2 x spatial 2 and
data 1 x spatial 4 and writes its results to ``<out>``; it imports no
JAX. One run of the workers serves every test; it has its own timeout
(``RUN_TIMEOUT``), and each test another (``TEST_TIMEOUT``). The oracles
run in this process while the workers run.

Sizes: DeepLab layers 1,1,1,1 at 64x128, dropout off, a global batch of
4. At spatial 4 the image splits into 32-column shards, the stride-8 map
(17 wide) into 4/4/4/5: the ASPP's dilation-6 and -12 halos cross two and
three shards and those of 18 and 24 reach padding only. The last 32
label columns ignore half their pixels, so one rank (two at 2 x 2)
counts far fewer valid pixels than the others. The step with device
augmentation takes raw 80x176 frames (the last 44 label columns half
ignored) and crops them to 64x128 on the grid.

The eval step runs on the grid at both layouts, on a batch whose labels
are 48x100 (the logits upsample to the label's own size, its width split
50/50 and 25 x 4), against JAX's eval step on the joined batch and on
inputs ``device_put`` under its width shardings.

The 2 x 2 'sync' step also runs with dropout on, against the port's
one-process step whose masks are those that each data index's key
(dropout seed, step, data index) draws for its rows, on every spatial
rank of it alike; and in float64.

Tolerances: against JAX's single-device step on the joined batch, the
loss rtol 2e-4 (tests/test_parallel.py's own), the parameters inside one
step's lr envelope (tests/test_torch_dist_train.py's rule) and the
BatchNorm statistics 5e-4; against JAX's own 2 x 2 dp x sp step, the
loss rtol 2e-4; against the port's one-process step on the joined batch,
the loss rtol 1e-5 and the gradients 5e-4 in units of the largest (with
device augmentation, on the batch that each data index's draws crop
from its rows, as JAX's crops cannot be drawn by torch); every rank's
state bit-equal (sha256); in float64, the loss and each gradient tensor
within 1e-10 of its own largest value; the eval step's pred and hist
exact outside logit near-ties (top-2 gap ``TIE_GAP``, the eval tests'
rule) and its loss rtol 1e-5. The exchange alone: its output exact
(it moves values), its gradient within 1e-5; the layers alone: outputs
and gradients within 1e-5 of the largest value of each (float32 sums in
another order).
"""

import hashlib
import json
import os
import signal
import socket
import subprocess
import sys
import zlib

import numpy as np

WORLD = 4
HW = (64, 128)
BATCH = 4
LR = 1e-4
IGNORE = 12
LAYOUTS = (2, 4)                 # spatial ranks: data 2 x 2, data 1 x 4
# (name, spatial, remat, grad_accum, bn_mode) of the train steps
STEPS = [("2x2", 2, "none", 1, "sync"), ("1x4", 4, "none", 1, "sync"),
         ("2x2-full", 2, "full", 1, "sync"), ("2x2-ga2", 2, "none", 2, "sync"),
         ("2x2-per_replica", 2, "none", 1, "per_replica")]
# the step with device augmentation: raw frames of RAW_HW cropped on the
# grid to HW (dropout seed AUG_SEED), at both layouts
AUG_STEPS = [("2x2-aug", 2), ("1x4-aug", 4)]
RAW_HW, AUG_SEED = (80, 176), 3
# the 2 x 2 'sync' step with dropout on (dropout seed DROPOUT_SEED), and
# in float64 with dropout off: (name, dtype, dropout)
EXTRA_STEPS = [("2x2-dropout", "float32", True),
               ("2x2-f64", "float64", False)]
DROPOUT_SEED = 9
# the eval step's labels: their own size, which the logits upsample to
EVAL_LABEL_HW = (48, 100)
TIE_GAP = 1e-5
RUN_TIMEOUT, TEST_TIMEOUT = 420, 300
LOSS_RTOL, JAX_LOSS_RTOL, GRAD_ATOL, STATS_ATOL = 1e-5, 2e-4, 5e-4, 5e-4
LAYER_ATOL = 1e-5
# float64: the loss and each gradient tensor, in units of its own largest
# value, against the port's one-process float64 step
F64_RTOL = 1e-10

# exchange cases: (name, spatial, width, pad, ranges of the spatial ranks)
EXCHANGES = [
    ("multi_owner_and_outside", 4, 17, 0.0,
     ((-3, 9), (0, 0), (15, 22), (-30, -25))),
    ("empty_shards", 4, 3, 0.0, ((-1, 4), (1, 2), (0, 1), (2, 2))),
    ("dilation_24_at_2", 2, 65, 0.0, ((-24, 56), (8, 89))),
    ("pool_pad", 4, 33, float("-inf"), ((-1, 16), (15, 32), (31, 34),
                                        (33, 35))),
    ("all_in_range", 2, 16, 0.0, ((0, 16), (0, 16))),
]


def random_exchanges():
    """Seeded random ranges at both layouts: starts from 10 left of the
    map to 5 right of it, lengths 0 to the width + 10."""
    rng = np.random.default_rng(70)
    out = []
    for k, (s, w) in enumerate(((4, 17), (4, 9), (2, 33), (2, 5))):
        ranges = []
        for _ in range(s):
            a = int(rng.integers(-10, w + 6))
            ranges.append((a, a + int(rng.integers(0, w + 11))))
        out.append((f"random{k}", s, w, 0.0, tuple(ranges)))
    return out


ALL_EXCHANGES = EXCHANGES + random_exchanges()

# the width-sharded layers: (name, input width, channels)
LAYERS = [("stem_7x7_s2", 128, 2), ("conv_1x1_s2", 33, 4),
          ("conv_3x3_d2", 17, 4), ("conv_3x3_d6", 17, 4),
          ("conv_3x3_d24", 17, 4), ("maxpool_ceil", 64, 4),
          ("maxpool_ceil_odd", 33, 4), ("groupnorm", 17, 8),
          ("se_mean", 17, 4), ("upsample", 17, 4)]


def exchange_input(name, width, d):
    """The full (2, 3, 4, width) map of an exchange case at data index
    ``d``."""
    rng = np.random.default_rng([zlib.crc32(name.encode()), d])
    return rng.standard_normal((2, 3, 4, width)).astype(np.float32)


def layer_of(name, channels):
    """The port's layer ``name`` (its weights from a seed)."""
    import torch

    from thermal_semantic_segmentation_torch.nn import spatial as sp
    torch.manual_seed(71)
    c = channels
    return {"stem_7x7_s2": lambda: sp.Conv2d(c, 3, 7, stride=2, padding=3,
                                             bias=False),
            "conv_1x1_s2": lambda: sp.Conv2d(c, 5, 1, stride=2, bias=False),
            "conv_3x3_d2": lambda: sp.Conv2d(c, 5, 3, padding=2,
                                             dilation=2),
            "conv_3x3_d6": lambda: sp.Conv2d(c, 5, 3, padding=6,
                                             dilation=6),
            "conv_3x3_d24": lambda: sp.Conv2d(c, 5, 3, padding=24,
                                              dilation=24),
            "maxpool_ceil": lambda: sp.MaxPool2d(3, 2, 1, ceil_mode=True),
            "maxpool_ceil_odd": lambda: sp.MaxPool2d(3, 2, 1,
                                                     ceil_mode=True),
            "groupnorm": lambda: _affine(sp.GroupNorm(2, c)),
            "se_mean": lambda: None, "upsample": lambda: None}[name]()


def _affine(norm):
    import torch
    with torch.no_grad():
        norm.weight.uniform_(0.5, 1.5)
        norm.bias.uniform_(-0.5, 0.5)
    return norm


def layer_input(name, width, channels):
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    return rng.standard_normal((2, channels, 6, width)).astype(np.float32)


def apply_layer(name, layer, x, layout=None):
    """The layer's output (NCHW; the upsample's is NHWC at HW)."""
    from thermal_semantic_segmentation_torch.nn.spatial import spatial_mean
    from thermal_semantic_segmentation_torch.ops.resize import (
        upsample_logits)
    if name == "se_mean":
        return spatial_mean(x, layout)
    if name == "upsample":
        return upsample_logits(x.permute(0, 2, 3, 1), 48, HW[1], layout)
    return layer(x)


def step_batch():
    """The global batch: the last 32 label columns half ignored."""
    rng = np.random.default_rng(72)
    image = rng.uniform(0, 1, (BATCH, *HW, 1)).astype(np.float32)
    label = rng.integers(0, 13, (BATCH, *HW))
    label[:, :, 96:][rng.random((BATCH, HW[0], 32)) < 0.5] = 255
    label[rng.random(label.shape) < 0.02] = 255
    return image, label


def raw_batch():
    """The global batch of raw frames for the augmented step: the last
    44 label columns half ignored."""
    rng = np.random.default_rng(75)
    image = rng.uniform(0, 1, (BATCH, *RAW_HW, 1)).astype(np.float32)
    label = rng.integers(0, 13, (BATCH, *RAW_HW))
    label[:, :, -44:][rng.random((BATCH, RAW_HW[0], 44)) < 0.5] = 255
    return image, label


def eval_batch():
    """The eval step's global batch: images at HW, labels at
    EVAL_LABEL_HW with some ignored (255, and 12 that the loss ignores but
    the confusion matrix counts)."""
    rng = np.random.default_rng(76)
    image = rng.uniform(0, 1, (BATCH, *HW, 1)).astype(np.float32)
    label = rng.integers(0, 13, (BATCH, *EVAL_LABEL_HW))
    label[rng.random(label.shape) < 0.05] = 255
    return image, label


def worker(rank: int, world: int, port: str, out: str) -> None:
    import torch
    import torch.distributed as dist

    from thermal_semantic_segmentation_torch.models.deeplab import DeepLabV2
    from thermal_semantic_segmentation_torch.nn.spatial import width_sharded
    from thermal_semantic_segmentation_torch.parallel import mesh as pmesh
    from thermal_semantic_segmentation_torch.parallel.spatial import (
        column_range, gather_columns)
    from thermal_semantic_segmentation_torch.train.seg import (
        build_seg_eval_step, create_seg_state, make_seg_train_step)

    torch.set_num_threads(1)
    pmesh.init_distributed(f"localhost:{port}", world, rank, device="cpu")
    meshes = {s: pmesh.make_mesh_2d("cpu", spatial=s) for s in LAYOUTS}
    arrays, meta = {}, {"rank": rank}
    image, label = step_batch()
    for s, mesh in meshes.items():
        meta[f"mesh/{s}"] = [mesh.data, mesh.spatial, mesh.data_index,
                             mesh.spatial_index]
        arrays[f"mesh/{s}/image"] = pmesh.image_sharding(
            mesh, torch.from_numpy(image)).numpy()
        arrays[f"mesh/{s}/label"] = pmesh.label_sharding(
            mesh, torch.from_numpy(label)).numpy()

    # -- the exchange alone ------------------------------------------------
    for name, s, width, pad, ranges in ALL_EXCHANGES:
        mesh = meshes[s]
        full = exchange_input(name, width, mesh.data_index)
        lo, hi = column_range(width, s, mesh.spatial_index)
        x = torch.from_numpy(full[..., lo:hi]).contiguous(
            memory_format=torch.channels_last).requires_grad_()
        y = gather_columns(x, mesh.layout(), width, ranges, pad)
        a, b = ranges[mesh.spatial_index]
        weights = torch.from_numpy(np.random.default_rng(
            [73, rank]).standard_normal((2, 3, 4, b - a)).astype(np.float32))
        (y.clamp_min(-1e3) * weights).sum().backward()
        arrays[f"ex/{name}/out"] = y.detach().numpy()
        arrays[f"ex/{name}/grad"] = x.grad.numpy()

    # -- the layers alone --------------------------------------------------
    for s, mesh in meshes.items():
        for name, width, channels in LAYERS:
            layer = layer_of(name, channels)
            full = layer_input(name, width, channels)
            lo, hi = column_range(width, s, mesh.spatial_index)
            x = torch.from_numpy(full[..., lo:hi]).contiguous(
                memory_format=torch.channels_last).requires_grad_()
            layout = mesh.layout()
            layout.start(x, width)
            with width_sharded([layer] if layer is not None else [],
                               layout):
                y = apply_layer(name, layer, x, layout)
            weights = torch.from_numpy(np.random.default_rng(
                [74, mesh.spatial_index]).standard_normal(y.shape).astype(
                    np.float32))
            (y * weights).sum().backward()
            key = f"layer/{s}/{name}"
            arrays[f"{key}/out"] = y.detach().numpy()
            arrays[f"{key}/grad"] = x.grad.numpy()
            if layer is not None:
                for n, p in layer.named_parameters():
                    g = p.grad.clone()
                    dist.all_reduce(g, group=mesh.spatial_group)
                    arrays[f"{key}/param/{n}"] = g.numpy()

    # -- the train steps ---------------------------------------------------
    def record(name, model, loss):
        meta[f"{name}/loss"] = float(loss)
        for n, p in model.named_parameters():
            arrays[f"{name}/grad/{n}"] = p.grad.numpy().copy()
        for n, v in model.state_dict().items():
            arrays[f"{name}/state/{n}"] = v.numpy().copy()

    start = torch.load(os.path.join(out, "start.pt"))
    for name, s, remat, ga, mode in STEPS:
        mesh = meshes[s]
        model = DeepLabV2(num_channels=1, num_classes=13, layers=(1, 1, 1, 1),
                          remat=remat)
        model.load_state_dict(start, strict=True)
        model = model.to(memory_format=torch.channels_last)
        model.layer5.head[0].p = 0.0
        state = create_seg_state(model, learning_rate=LR, device="cpu")
        step = make_seg_train_step(ignore_index=IGNORE, label_hw=HW,
                                   base_lr=LR, bn_mode=mode, mesh=mesh,
                                   grad_accum=ga, device="cpu")
        loss = step(state,
                    pmesh.image_sharding(mesh, torch.from_numpy(image)),
                    pmesh.label_sharding(mesh, torch.from_numpy(label)))
        record(name, model, loss)

    # -- device augmentation of raw frames on the grid -----------------------
    raw_image, raw_label = raw_batch()
    for name, s in AUG_STEPS:
        mesh = meshes[s]
        model = DeepLabV2(num_channels=1, num_classes=13, layers=(1, 1, 1, 1))
        model.load_state_dict(start, strict=True)
        model = model.to(memory_format=torch.channels_last)
        model.layer5.head[0].p = 0.0
        state = create_seg_state(model, learning_rate=LR, device="cpu")
        step = make_seg_train_step(ignore_index=IGNORE, label_hw=HW,
                                   base_lr=LR, mesh=mesh, device_augment=True,
                                   dropout_seed=AUG_SEED, device="cpu")
        loss = step(state,
                    pmesh.image_sharding(mesh, torch.from_numpy(raw_image)),
                    pmesh.label_sharding(mesh, torch.from_numpy(raw_label)))
        record(name, model, loss)

    # -- dropout on, and float64, at 2 x 2 -----------------------------------
    mesh = meshes[2]
    for name, dtype, dropout in EXTRA_STEPS:
        dtype = getattr(torch, dtype)
        model = DeepLabV2(num_channels=1, num_classes=13, layers=(1, 1, 1, 1))
        model.load_state_dict(start, strict=True)
        model = model.to(dtype, memory_format=torch.channels_last)
        if not dropout:
            model.layer5.head[0].p = 0.0
        state = create_seg_state(model, learning_rate=LR, device="cpu")
        step = make_seg_train_step(ignore_index=IGNORE, label_hw=HW,
                                   base_lr=LR, mesh=mesh,
                                   dropout_seed=DROPOUT_SEED, device="cpu")
        loss = step(state,
                    pmesh.image_sharding(mesh, torch.from_numpy(image)).to(
                        dtype),
                    pmesh.label_sharding(mesh, torch.from_numpy(label)))
        record(name, model, loss)

    # -- the eval step on the grid -------------------------------------------
    eval_image, eval_label = eval_batch()
    for s, mesh in meshes.items():
        model = DeepLabV2(num_channels=1, num_classes=13, layers=(1, 1, 1, 1))
        model.load_state_dict(start, strict=True)
        model = model.to(memory_format=torch.channels_last).train()
        step = build_seg_eval_step(num_classes=13, ignore_index=IGNORE,
                                   mesh=mesh, device="cpu")
        hist, loss, pred = step(
            model, pmesh.image_sharding(mesh, torch.from_numpy(eval_image)),
            pmesh.label_sharding(mesh, torch.from_numpy(eval_label)))
        meta[f"eval/{s}/loss"] = float(loss)
        meta[f"eval/{s}/training"] = model.training
        arrays[f"eval/{s}/hist"] = hist.numpy()
        arrays[f"eval/{s}/pred"] = pred.numpy()

    # -- a block that is not its shard ---------------------------------------
    mesh = meshes[2]
    model = DeepLabV2(num_channels=1, num_classes=13, layers=(1, 1, 1, 1))
    state = create_seg_state(model, learning_rate=LR, device="cpu")
    step = make_seg_train_step(ignore_index=IGNORE, label_hw=HW, base_lr=LR,
                               mesh=mesh, device="cpu")
    im = pmesh.image_sharding(mesh, torch.from_numpy(image))
    lb = pmesh.label_sharding(mesh, torch.from_numpy(label))
    if rank == 3:                       # one rank's block is not its shard
        im = im[:, :, 1:]
    try:
        step(state, im, lb)
        meta["refused/block"] = ""
    except ValueError as e:
        meta["refused/block"] = str(e)

    dist.barrier()
    steps = {k for k in arrays if "/state/" in k or "/grad/" in k}
    meta["digests"] = {k: hashlib.sha256(
        np.ascontiguousarray(arrays[k]).tobytes()).hexdigest() for k in steps}
    # the steps' tensors of rank 0 only: the others are held to it by digest
    np.savez(os.path.join(out, f"worker{rank}.npz"),
             **{k: v for k, v in arrays.items() if rank == 0 or k not in steps})
    with open(os.path.join(out, f"worker{rank}.json"), "w") as f:
        json.dump(meta, f)
    dist.destroy_process_group()


if __name__ == "__main__":
    worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
    sys.exit(0)


import flax.linen as fnn  # noqa: E402
import pytest  # noqa: E402

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tests.test_torch_deeplab import jax_deeplab_with_twin  # noqa: E402
from tests.test_torch_train import as_state_dict, no_dropout  # noqa: E402
from thermal_semantic_segmentation_tpu.parallel.mesh import (  # noqa: E402
    image_sharding as jax_image_sharding,
    label_sharding as jax_label_sharding, make_mesh_2d as jax_make_mesh_2d,
    replicate)
from thermal_semantic_segmentation_tpu.train import (  # noqa: E402
    seg as jax_seg)
from thermal_semantic_segmentation_torch.parallel.spatial import (  # noqa: E402,E501
    column_range)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def test_timeout():
    """Each test's own limit: SIGALRM ends one that hangs."""
    def expired(signum, frame):
        raise TimeoutError(f"test exceeded {TEST_TIMEOUT} s")
    previous = signal.signal(signal.SIGALRM, expired)
    signal.alarm(TEST_TIMEOUT)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, previous)


def _jax_step(model, variables, *, ga=1, mode="sync", mesh=None):
    """One JAX step on the global batch: (loss, state dict). ``mesh``: a
    2 x 2 ``make_mesh_2d`` fed width-sharded inputs, as
    tests/test_parallel.py feeds it."""
    state = jax_seg.create_seg_state(
        model, jax.tree.map(jnp.asarray, variables), learning_rate=LR)
    kw = {"bn_mode": mode, "mesh": mesh} if mode != "sync" else {}
    step = jax_seg.make_seg_train_step(ignore_index=IGNORE, label_hw=HW,
                                       base_lr=LR, grad_accum=ga, **kw)
    image, label = (jnp.asarray(a) for a in step_batch())
    if mesh is not None:
        state = replicate(mesh, state)
        image = jax.device_put(image, jax_image_sharding(mesh, spatial=True))
        label = jax.device_put(label, jax_label_sharding(mesh, spatial=True))
    with fnn.intercept_methods(no_dropout):
        state, loss = step(state, image, label)
    state = jax.device_get(state)
    return float(loss), as_state_dict(state.params, state.batch_stats)


def _jax_eval(model, variables, mesh=None):
    """JAX's eval step on ``eval_batch()``: (hist, loss, pred) as numpy.
    ``mesh``: a ``make_mesh_2d`` whose width shardings the inputs are
    ``device_put`` under (tests/test_parallel.py's way)."""
    from jax.sharding import NamedSharding, PartitionSpec
    step = jax_seg.build_seg_eval_step(model, num_classes=13,
                                       ignore_index=IGNORE)
    image, label = (jnp.asarray(a) for a in eval_batch())
    if mesh is not None:
        variables = jax.device_put(variables, NamedSharding(
            mesh, PartitionSpec()))
        image = jax.device_put(image, jax_image_sharding(mesh, spatial=True))
        label = jax.device_put(label, jax_label_sharding(mesh, spatial=True))
    return tuple(np.asarray(a) for a in step(variables, image, label))


def _eval_decided(model, variables):
    """The pixels of ``eval_batch()`` whose JAX upsampled logits' top-2 gap
    is at least TIE_GAP."""
    from thermal_semantic_segmentation_tpu.ops.resize import (
        upsample_logits as jax_upsample_logits)
    out = model.apply(variables, jnp.asarray(eval_batch()[0]), train=False)
    up = np.asarray(jax_upsample_logits(out["out"], *EVAL_LABEL_HW))
    top2 = np.sort(up, axis=-1)[..., -2:]
    return (top2[..., 1] - top2[..., 0]) >= TIE_GAP


def augmented_batch(data):
    """The batch the grid's device augmentation trains on at ``data``
    data indices: each data index's raw rows cropped with its own draws
    (seeded from (AUG_SEED + 1, step 0) and, with several data indices,
    the index), joined."""
    from thermal_semantic_segmentation_torch.ops.augment import (
        random_resized_crop_flip)
    from thermal_semantic_segmentation_torch.train.seg import (
        augment_generator)
    image, label = (torch.from_numpy(a) for a in raw_batch())
    rows = BATCH // data
    parts = [random_resized_crop_flip(
        augment_generator(torch.device("cpu"), AUG_SEED, 0,
                          *((d,) if data > 1 else ())),
        image[d * rows:(d + 1) * rows], labels=label[d * rows:(d + 1) * rows],
        out_hw=HW) for d in range(data)]
    return (torch.cat([p[0] for p in parts]).numpy(),
            torch.cat([p[1] for p in parts]).numpy())


class _JoinedMasks(torch.nn.Module):
    """``nn/aspp.Dropout2d``'s arithmetic with the masks of ``masks``:
    each data index's rows, drawn as the grid's step should draw them, by
    a generator seeded from (dropout seed, step, data index)."""

    def __init__(self, p, data, channels):
        super().__init__()
        self.keep = 1.0 - p
        rows = BATCH // data
        parts = []
        for d in range(data):
            seed = int(np.random.SeedSequence([DROPOUT_SEED, 0, d])
                       .generate_state(1, np.uint64)[0])
            parts.append(torch.rand((rows, channels), generator=torch.Generator(
            ).manual_seed(seed)) < self.keep)
        self.masks = torch.cat(parts)

    def forward(self, x):
        return torch.where(self.masks[:, :, None, None], x / self.keep, 0.0)


def _port_step(twin, ga, batch=None, dtype=None, dropout_data=None):
    """The port's one-process step on the joined batch (default
    ``step_batch()``), in ``dtype`` (default float32), with dropout off or,
    given ``dropout_data``, the masks of that many data indices
    (``_JoinedMasks``): (loss, gradients, state dict)."""
    from thermal_semantic_segmentation_torch.train.seg import (
        create_seg_state, make_seg_train_step)
    dtype = dtype or torch.float32
    model = type(twin)(num_channels=1, num_classes=13, layers=(1, 1, 1, 1))
    model.load_state_dict(twin.state_dict(), strict=True)
    model = model.to(dtype, memory_format=torch.channels_last)
    dropout = model.layer5.head[0]
    if dropout_data is None:
        dropout.p = 0.0
    else:
        model.layer5.head[0] = _JoinedMasks(
            dropout.p, dropout_data, model.layer5.head[1].in_channels)
    state = create_seg_state(model, learning_rate=LR, device="cpu")
    step = make_seg_train_step(ignore_index=IGNORE, label_hw=HW, base_lr=LR,
                               grad_accum=ga, device="cpu")
    image, label = batch if batch is not None else step_batch()
    loss = float(step(state, torch.from_numpy(image).to(dtype),
                      torch.from_numpy(label)))
    return (loss, {n: p.grad.numpy().copy()
                   for n, p in model.named_parameters()},
            {k: v.numpy().copy() for k, v in model.state_dict().items()})


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One run of ``WORLD`` workers and, while they run, the oracles:
    ((arrays, meta) rank by rank, the oracles)."""
    out = tmp_path_factory.mktemp("spatial")
    model, variables, twin = jax_deeplab_with_twin(31)
    torch.save(twin.state_dict(), str(out / "start.pt"))
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (REPO, os.environ.get("PYTHONPATH", "")) if p))
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(r), str(WORLD),
         str(port), str(out)], cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(WORLD)]
    logs = []
    # the oracles leave a core to each worker
    threads = torch.get_num_threads()
    torch.set_num_threads(max(1, (os.cpu_count() or 1) - WORLD))
    try:
        grid = jax_make_mesh_2d(jax.devices()[:WORLD], spatial=2)
        oracles = {
            "jax1": _jax_step(model, variables),
            "jax2": _jax_step(model, variables, ga=2),
            "jax_dp_sp": _jax_step(model, variables, mesh=grid),
            "jax_per_replica": _jax_step(model, variables,
                                         mode="per_replica", mesh=grid),
            "port1": _port_step(twin, 1), "port2": _port_step(twin, 2),
            **{name: _port_step(twin, 1, augmented_batch(WORLD // s))
               for name, s in AUG_STEPS},
            "2x2-dropout": _port_step(twin, 1, dropout_data=WORLD // 2),
            "2x2-f64": _port_step(twin, 1, dtype=torch.float64),
            "jax_eval": _jax_eval(model, variables),
            **{f"jax_eval/{s}": _jax_eval(model, variables, jax_make_mesh_2d(
                jax.devices()[:WORLD], spatial=s)) for s in LAYOUTS},
            "eval_decided": _eval_decided(model, variables),
            "params": [n for n, _ in twin.named_parameters()]}
        for p in procs:
            logs.append(p.communicate(timeout=RUN_TIMEOUT)[0])
    finally:
        torch.set_num_threads(threads)
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-6000:]
    results = []
    for r in range(WORLD):
        with open(out / f"worker{r}.json") as f:
            meta = json.load(f)
        results.append((dict(np.load(out / f"worker{r}.npz")), meta))
        os.remove(out / f"worker{r}.npz")
    return results, oracles


def _rank_of(d, q, s):
    return d * s + q


@pytest.mark.parametrize("s", LAYOUTS)
def test_mesh_blocks_match_jax_shardings(runs, s):
    """Rank ``r`` sits at (r // spatial, r % spatial) as JAX reshapes its
    devices, and its image and label blocks are the shards that JAX's
    ``image_sharding``/``label_sharding(spatial=True)`` put on that
    device."""
    results, _ = runs
    mesh = jax_make_mesh_2d(jax.devices()[:WORLD], spatial=s)
    image, label = step_batch()
    placed = {"image": jax.device_put(image, jax_image_sharding(
        mesh, spatial=True)), "label": jax.device_put(label, jax_label_sharding(
            mesh, spatial=True))}
    position = {dev: (d, q) for (d, q), dev in np.ndenumerate(mesh.devices)}
    for what, arr in placed.items():
        for shard in arr.addressable_shards:
            d, q = position[shard.device]
            arrays, meta = results[_rank_of(d, q, s)]
            assert meta[f"mesh/{s}"] == [WORLD // s, s, d, q]
            np.testing.assert_array_equal(arrays[f"mesh/{s}/{what}"],
                                          np.asarray(shard.data))


def _close(got, want, err_msg=""):
    """Within ``LAYER_ATOL`` of the largest value of ``want`` (or of 1)."""
    scale = max(1.0, float(np.abs(want).max(initial=0.0)))
    np.testing.assert_allclose(got, want, rtol=0, atol=LAYER_ATOL * scale,
                               err_msg=err_msg)


def _exchange_reference(name, s, width, pad, ranges, d):
    """Each spatial rank's columns of the padded full map by ``torch.cat``
    and the gradient of the sum of their losses by autograd."""
    full = exchange_input(name, width, d)
    f = torch.from_numpy(full).requires_grad_()
    outs, total = [], 0.0
    for q, (a, b) in enumerate(ranges):
        left = max(0, min(-a, b - a))
        right = max(0, min(b - width, b - a))
        mid = f[..., min(max(a, 0), width):max(min(b, width), 0)]
        padded = torch.cat([f.new_full((2, 3, 4, left), pad), mid,
                            f.new_full((2, 3, 4, right), pad)], dim=-1)
        assert padded.shape[-1] == b - a
        outs.append(padded.detach().numpy())
        weights = torch.from_numpy(np.random.default_rng(
            [73, _rank_of(d, q, s)]).standard_normal(
                (2, 3, 4, b - a)).astype(np.float32))
        total = total + (padded.clamp_min(-1e3) * weights).sum()
    total.backward()
    return outs, f.grad.numpy()


@pytest.mark.parametrize("case", ALL_EXCHANGES, ids=[c[0] for c in
                                                     ALL_EXCHANGES])
def test_exchange_matches_the_full_map(runs, case):
    """Any column range, empty, outside the map or spread over several
    owners: ``torch.cat`` of the padded full map, and the gradient its
    autograd gives the sum of every rank's loss, scattered back to the
    owners."""
    results, _ = runs
    name, s, width, pad, ranges = case
    for d in range(WORLD // s):
        outs, grad = _exchange_reference(name, s, width, pad, ranges, d)
        for q in range(s):
            arrays, _ = results[_rank_of(d, q, s)]
            lo, hi = column_range(width, s, q)
            np.testing.assert_array_equal(arrays[f"ex/{name}/out"], outs[q])
            np.testing.assert_allclose(arrays[f"ex/{name}/grad"],
                                       grad[..., lo:hi], rtol=0,
                                       atol=LAYER_ATOL, err_msg=name)


@pytest.mark.parametrize("s", LAYOUTS)
@pytest.mark.parametrize("layer", LAYERS, ids=[x[0] for x in LAYERS])
def test_sharded_layer_matches_the_plain_layer(runs, layer, s):
    """Each width-sharded layer on its shards: the plain layer on the full
    map, its output columns (the output grid from the global width: 64 ->
    33 and 33 -> 17 for the ceil-mode pool), its input gradient and its
    parameters' gradient summed over the spatial group."""
    results, _ = runs
    name, width, channels = layer
    module = layer_of(name, channels)
    x = torch.from_numpy(layer_input(name, width, channels)).requires_grad_()
    y = apply_layer(name, module, x)
    out_w = y.shape[2] if name == "upsample" else y.shape[-1]
    total = 0.0
    for q in range(s):
        lo, hi = column_range(out_w, s, q)
        part = y[:, :, lo:hi] if name == "upsample" else (
            y if name == "se_mean" else y[..., lo:hi])
        weights = torch.from_numpy(np.random.default_rng(
            [74, q]).standard_normal(part.shape).astype(np.float32))
        total = total + (part * weights).sum()
    total.backward()
    key = f"layer/{s}/{name}"
    for q in range(s):
        arrays, _ = results[q]
        lo, hi = column_range(out_w, s, q)
        want = y[:, :, lo:hi] if name == "upsample" else (
            y if name == "se_mean" else y[..., lo:hi])
        _close(arrays[f"{key}/out"], want.detach().numpy())
        lo, hi = column_range(width, s, q)
        _close(arrays[f"{key}/grad"], x.grad[..., lo:hi].numpy())
        for n, p in (module.named_parameters() if module is not None
                     else ()):
            _close(arrays[f"{key}/param/{n}"], p.grad.numpy(), n)


def _check_envelope(got, want, names):
    """Parameters within one Adam step's lr envelope: at most 5e-4 of
    them outside, none past 2 x."""
    outside = total = 0
    worst = 0.0
    for n in names:
        ratio = np.abs(got[n] - want[n]) / LR
        worst = max(worst, float(ratio.max()))
        outside += int((ratio > 1.0).sum())
        total += ratio.size
    print(f"{outside} of {total} parameters outside the lr envelope, worst "
          f"{worst:.3f} of it")
    assert outside <= 5e-4 * total and worst <= 2.0 + 1e-3


def _sub(arrays, prefix):
    return {k[len(prefix):]: v for k, v in arrays.items()
            if k.startswith(prefix)}


SYNC = [c for c in STEPS if c[4] == "sync"]


@pytest.mark.parametrize("case", SYNC, ids=[c[0] for c in SYNC])
def test_step_matches_jax_single_device_joined_batch(runs, case):
    """Every layout, remat and microbatching of the 'sync' step: JAX's
    single-device step on the 4-row global batch (loss, parameters,
    BatchNorm statistics)."""
    results, oracles = runs
    name, _, _, ga, _ = case
    want_loss, want = oracles[f"jax{ga}"]
    arrays, meta = results[0]
    np.testing.assert_allclose(meta[f"{name}/loss"], want_loss,
                               rtol=JAX_LOSS_RTOL)
    state = _sub(arrays, f"{name}/state/")
    _check_envelope(state, want, oracles["params"])
    for k, v in state.items():
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(v, want[k], rtol=0, atol=STATS_ATOL,
                                       err_msg=k)
        elif k.endswith("num_batches_tracked"):
            assert int(v) == ga, k       # one fold a microbatch, remat too


def test_dp_sp_loss_matches_jax_dp_sp_step(runs):
    """The 2 x 2 step's loss: JAX's own step on a 2 x 2 ``make_mesh_2d``
    with width-sharded inputs."""
    results, oracles = runs
    np.testing.assert_allclose(results[0][1]["2x2/loss"],
                               oracles["jax_dp_sp"][0], rtol=JAX_LOSS_RTOL)


def test_per_replica_matches_jax_2d_mesh_step(runs):
    """'per_replica' on the 2 x 2 grid: JAX's ``shard_map`` step on a
    2 x 2 mesh, where each data index is a replica whose two spatial
    devices compute its full width (loss, parameters, the averaged
    BatchNorm statistics)."""
    results, oracles = runs
    want_loss, want = oracles["jax_per_replica"]
    arrays, meta = results[0]
    np.testing.assert_allclose(meta["2x2-per_replica/loss"], want_loss,
                               rtol=JAX_LOSS_RTOL)
    state = _sub(arrays, "2x2-per_replica/state/")
    _check_envelope(state, want, oracles["params"])
    for k, v in state.items():
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(v, want[k], rtol=0, atol=STATS_ATOL,
                                       err_msg=k)


@pytest.mark.parametrize("name,oracle", [
    *((c[0], f"port{c[3]}") for c in SYNC),
    *((name, name) for name, _ in AUG_STEPS), ("2x2-dropout", "2x2-dropout")],
    ids=[c[0] for c in SYNC] + [name for name, _ in AUG_STEPS]
    + ["2x2-dropout"])
def test_step_matches_port_one_process_joined_batch(runs, name, oracle):
    """The port's own one-process step on the joined batch: the loss and
    every gradient (after the sum over the grid). With device
    augmentation of raw frames, the batch each data index's own draws
    crop from its rows (every spatial rank crops its whole rows alike and
    keeps its columns). With dropout on, the masks each data index's key
    draws for its rows (both spatial ranks of it drop the same
    channels)."""
    results, oracles = runs
    want_loss, want_grads, _ = oracles[oracle]
    arrays, meta = results[0]
    np.testing.assert_allclose(meta[f"{name}/loss"], want_loss,
                               rtol=LOSS_RTOL)
    grads = _sub(arrays, f"{name}/grad/")
    largest = max(float(np.abs(g).max()) for g in want_grads.values())
    worst = max(float(np.abs(grads[n] - g).max()) for n, g in
                want_grads.items()) / largest
    print(f"{name}: worst gradient error {worst:.2e} of the largest "
          f"({largest:.3e})")
    assert worst <= GRAD_ATOL


def test_float64_step_matches_port_one_process_tensor_by_tensor(runs):
    """The 2 x 2 step in float64: the port's one-process float64 step on
    the joined batch, the loss and each gradient tensor within
    ``F64_RTOL`` of its own largest value (a float32 rounding anywhere on
    the sharded path would show far above it)."""
    results, oracles = runs
    want_loss, want_grads, _ = oracles["2x2-f64"]
    arrays, meta = results[0]
    np.testing.assert_allclose(meta["2x2-f64/loss"], want_loss,
                               rtol=F64_RTOL)
    grads = _sub(arrays, "2x2-f64/grad/")
    errs = {n: float(np.abs(grads[n] - g).max()) / float(np.abs(g).max())
            for n, g in want_grads.items()}
    worst = max(errs, key=errs.get)
    print(f"worst gradient error {errs[worst]:.2e} of its own largest "
          f"({worst})")
    assert all(g.dtype == np.float64 for g in grads.values())
    assert errs[worst] <= F64_RTOL, worst


@pytest.mark.parametrize("name", [c[0] for c in STEPS]
                         + [name for name, _ in AUG_STEPS]
                         + [name for name, _, _ in EXTRA_STEPS])
def test_ranks_hold_identical_state(runs, name):
    """All four ranks' losses, gradients, parameters and buffers, bit for
    bit (by their sha256)."""
    results, _ = runs
    metas = [m for _, m in results]
    assert len({m[f"{name}/loss"] for m in metas}) == 1
    keys = [k for k in metas[0]["digests"] if k.startswith(f"{name}/")]
    assert len(keys) > 100
    for m in metas[1:]:
        for k in keys:
            assert m["digests"][k] == metas[0]["digests"][k], k


def test_a_block_that_is_not_its_shard_is_refused_on_every_rank(runs):
    """One rank's image block is a column short: every rank raises (the
    block sizes are gathered before any collective of the step)."""
    for _, meta in runs[0]:
        assert "rank 3's block" in meta["refused/block"], meta[
            "refused/block"]


def _joined_eval(results, s):
    """The grid eval step at spatial ``s``: (hist and loss of rank 0, the
    pred blocks joined into the global batch), after checking that every
    rank returned the same hist and loss and left the model in train
    mode."""
    data = WORLD // s
    blocks = [[results[_rank_of(d, q, s)][0][f"eval/{s}/pred"]
               for q in range(s)] for d in range(data)]
    pred = np.concatenate([np.concatenate(row, axis=2) for row in blocks])
    hist = results[0][0][f"eval/{s}/hist"]
    for arrays, meta in results:
        np.testing.assert_array_equal(arrays[f"eval/{s}/hist"], hist)
        assert meta[f"eval/{s}/loss"] == results[0][1][f"eval/{s}/loss"]
        assert meta[f"eval/{s}/training"] is True
    return hist, results[0][1][f"eval/{s}/loss"], pred


def _confusion(pred, label):
    from thermal_semantic_segmentation_torch.ops.confmat import (
        confusion_matrix)
    return confusion_matrix(torch.from_numpy(pred),
                            torch.from_numpy(label), 13).numpy()


@pytest.mark.parametrize("oracle", ["joined", "sharded"])
@pytest.mark.parametrize("s", LAYOUTS)
def test_grid_eval_step_matches_jax(runs, s, oracle):
    """The eval step on the grid (each rank its block of the batch, the
    labels at their own 48x100): its pred blocks joined, every rank's
    hist and loss, against JAX's eval step on the joined batch and on
    inputs ``device_put`` under ``image_sharding``/``label_sharding(mesh,
    spatial=True)`` of a data x spatial ``make_mesh_2d``: pred and hist
    exact outside near-ties, the loss rtol 1e-5; the hist is the joined
    pred's confusion matrix."""
    results, oracles = runs
    hist, loss, pred = _joined_eval(results, s)
    want_hist, want_loss, want_pred = oracles[
        "jax_eval" if oracle == "joined" else f"jax_eval/{s}"]
    decided = oracles["eval_decided"]
    label = eval_batch()[1]
    assert pred.shape == label.shape and pred.dtype == np.int32
    print(f"{(~decided).sum()} near-ties of {decided.size} pixels")
    np.testing.assert_array_equal(pred[decided], want_pred[decided])
    np.testing.assert_array_equal(hist, _confusion(pred, label))
    masked = np.where(decided, label, -1)
    np.testing.assert_array_equal(_confusion(pred, masked),
                                  _confusion(want_pred.astype(np.int32),
                                             masked))
    assert int(hist.sum()) == int(want_hist.sum())
    np.testing.assert_allclose(loss, float(want_loss), rtol=LOSS_RTOL)


@pytest.fixture
def one_gloo_process():
    """A one-process gloo group on a free port, torn down after the
    test; yields a function that joins another such group."""
    import torch.distributed as dist
    from thermal_semantic_segmentation_torch.parallel.mesh import (
        init_distributed)

    def join():
        if dist.is_initialized():
            dist.destroy_process_group()
        with socket.socket() as sock:
            sock.bind(("localhost", 0))
            port = sock.getsockname()[1]
        init_distributed(f"localhost:{port}", 1, 0, device="cpu")

    join()
    yield join
    if dist.is_initialized():
        dist.destroy_process_group()


def test_host_group_follows_a_new_process_group(one_gloo_process,
                                                monkeypatch):
    """Under a non-gloo job group ``host_group`` makes a gloo group; after
    the job's group is destroyed and another joined (the chip smoke test
    does so phase after phase), it makes a new one instead of handing
    back the destroyed one."""
    import torch.distributed as dist
    from thermal_semantic_segmentation_torch.parallel import mesh as pmesh
    real = dist.get_backend
    monkeypatch.setattr(dist, "get_backend", lambda group=None: (
        "nccl" if group is None else real(group)))
    first = pmesh.host_group()
    assert first is not dist.group.WORLD and pmesh.host_group() is first
    one_gloo_process()
    second = pmesh.host_group()
    assert second is not first
    flag = torch.ones(1)
    dist.all_reduce(flag, group=second)
    assert float(flag) == 1.0


@pytest.mark.parametrize("bf16", [False, True], ids=["float32", "bf16"])
def test_spatial_mesh_of_one_rank_is_the_plain_step(one_gloo_process, bf16):
    """``make_mesh_2d(spatial=1)`` in one process runs the sharded code
    (explicit padding through the exchange, GroupNorm and the SE mean
    from sums, the tap upsample, the gradient sum) with no collective
    across ranks: the plain step's loss (rtol 1e-5) and gradients (5e-4
    of the largest); under bfloat16 autocast, where the plain step's
    fused GroupNorm rounds otherwise before the bf16 convolutions, rtol
    1e-3 and 2e-2."""
    from thermal_semantic_segmentation_torch.models.deeplab import (
        create_deeplab)
    from thermal_semantic_segmentation_torch.parallel.mesh import (
        make_mesh_2d)
    from thermal_semantic_segmentation_torch.train.seg import (
        create_seg_state, make_seg_train_step)
    image, label = (torch.from_numpy(a) for a in step_batch())
    out = []
    for mesh in (None, make_mesh_2d("cpu", spatial=1)):
        model = create_deeplab(5, device="cpu", layers=(1, 1, 1, 1))
        model.layer5.head[0].p = 0.0
        state = create_seg_state(model, learning_rate=LR, device="cpu")
        step = make_seg_train_step(ignore_index=IGNORE, label_hw=HW,
                                   base_lr=LR, mesh=mesh, bf16=bf16,
                                   device="cpu")
        out.append((float(step(state, image, label)),
                    {n: p.grad for n, p in model.named_parameters()}))
    (want, want_grads), (got, grads) = out
    largest = max(float(g.abs().max()) for g in want_grads.values())
    worst = max(float((grads[n] - g).abs().max())
                for n, g in want_grads.items()) / largest
    print(f"loss {got} vs {want}, worst gradient error {worst:.2e}")
    np.testing.assert_allclose(got, want, rtol=1e-3 if bf16 else LOSS_RTOL)
    assert worst <= (2e-2 if bf16 else GRAD_ATOL)
