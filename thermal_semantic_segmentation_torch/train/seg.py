"""Segmentation train and eval steps (counterpart of the JAX
``train/seg.py``).

The train state is PyTorch's own: the model, an optimizer with one param
group per lr multiple, a step counter and the plateau scheduler's lr scale.
Before each optimizer step every group's lr is set to
``base_lr * lr_scale * lr_mult``, as the JAX step injects
``base_lr * lr_scale`` into optax.

The step: a train-mode forward (bfloat16 autocast with ``bf16``), the fp32
stride-8 logits upsampled to ``label_hw`` (align corners), the masked CE,
backward, one optimizer step. The loss comes back as a device tensor; the
step never waits for the device.

With a ``mesh`` (``parallel/mesh.make_mesh``) the step runs under
``DistributedDataParallel`` on every rank, in one of the JAX package's two
BatchNorm modes:
- 'sync': the step is the JAX step on the global batch (the ranks' local
  batches in rank order): BatchNorm normalises with the global batch's
  statistics (``nn/resnet.BatchNorm2d.sync_group``), the CE is each rank's
  NLL sum over the all-reduced count of valid pixels, and the gradient is
  the sum over ranks (DDP's average of world size times the loss);
- 'per_replica': JAX's ``shard_map`` step: each rank normalises with its
  own batch, the gradients and the loss are averaged, and the running
  statistics are averaged across ranks after the step (DDP's
  ``broadcast_buffers`` is off: it would copy rank 0's over the others).

With a ``parallel/mesh.SpatialMesh`` (``make_mesh_2d``: data x spatial
ranks) each rank holds one block of the global batch, its data index's
rows and its spatial index's columns of the image and the label
(``image_sharding``, ``label_sharding``), and the step is the JAX step fed
width-sharded inputs. The model's layers run on the width shards
(``nn/spatial.py``: halo exchanges, GroupNorm and the SE mean over the full
width), the logits are upsampled to the rank's label columns, and:
- 'sync': BatchNorm normalises over the whole grid and the CE is each
  rank's NLL sum over the grid's count of valid pixels: the JAX step on
  the global batch;
- 'per_replica': each data index is one replica, as JAX's ``shard_map``
  over the 'data' axis of a 2-D mesh runs it (its spatial ranks compute
  the replica's full width between them): BatchNorm and the count over
  the spatial group, the gradients, loss and running statistics averaged
  over the data indices.
There is no DDP: the exchanges' transposes run collectives on the spatial
groups in the middle of the backward, which DDP's bucketed all-reduces
over the grid could meet in another order on another rank. The gradients
are summed over the grid after the backward (``all_reduce_grads``). Each
step first gathers every rank's block sizes on the host, which gives the
image's global width and checks the blocks. With ``device_augment`` the
blocks are of the raw frames: every spatial rank of a data index gathers
their whole rows (a crop takes any columns), crops them with the same
draws and keeps its columns of the result.
"""

from __future__ import annotations

import contextlib
import warnings
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from ..core.prng import split_for_step
from ..device import resolve_device
from ..kernels.upsample_argmax import upsample_argmax
from ..losses import cross_entropy, cross_entropy_terms
from ..models.deeplab import backbone_and_head_params
from ..nn.aspp import Dropout2d
from ..nn.resnet import BatchNorm2d, synchronised
from ..nn.spatial import width_sharded
from ..parallel import mesh as pmesh
from ..parallel.spatial import column_range, gather_columns
from ..ops.augment import random_resized_crop_flip
from ..ops.confmat import confusion_matrix
from ..ops.resize import upsample_logits


@dataclass
class SegTrainState:
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0
    lr_scale: float = 1.0       # plateau-scheduler scale, set from the host


def create_seg_state(model: torch.nn.Module, *, learning_rate: float,
                     optimizer: str = "adam", lr_groups: bool = False,
                     head_lr_mult: float = 10.0, device=None) -> SegTrainState:
    """The optimizer over ``model``'s parameters, which must lie on
    ``device`` (default: the CUDA device; raises without one).

    ``adam`` is ``torch.optim.Adam`` with optax's defaults (0.9, 0.999, eps
    1e-8); ``sgd`` has momentum 0.9 and no dampening, as ``optax.sgd``.
    ``lr_groups=True`` puts the head (``layer5``, ``bn_pretrain``) in a
    group at ``head_lr_mult`` times the lr: for both optimizers that equals
    the JAX package's post-scaling of the head's updates.
    """
    device = resolve_device(device)
    params = list(model.parameters())
    if any(p.device != device for p in params):
        raise ValueError(f"the model's parameters are not all on {device}")
    if lr_groups:
        backbone, head = backbone_and_head_params(model)
        groups = [{"params": backbone, "lr_mult": 1.0},
                  {"params": head, "lr_mult": float(head_lr_mult)}]
    else:
        groups = [{"params": params, "lr_mult": 1.0}]
    if optimizer == "adam":
        opt = torch.optim.Adam(groups, lr=learning_rate, betas=(0.9, 0.999),
                               eps=1e-8)
    elif optimizer == "sgd":
        opt = torch.optim.SGD(groups, lr=learning_rate, momentum=0.9,
                              dampening=0.0)
    else:
        raise ValueError(optimizer)
    return SegTrainState(model=model, optimizer=opt)


def seed_dropout(model: torch.nn.Module, *key: int) -> None:
    """Seed every ``Dropout2d`` of ``model`` from ``key`` (e.g. (dropout
    seed, step) or (dropout seed, step, microbatch), as the JAX step folds
    the step and the microbatch into its key), with one generator on the
    device of the module's parameters."""
    seed = int(np.random.SeedSequence(list(key)).generate_state(
        1, np.uint64)[0])
    device = next(model.parameters()).device
    for m in model.modules():
        if isinstance(m, Dropout2d):
            if m.generator is None or m.generator.device != device:
                m.generator = torch.Generator(device=device)
            m.generator.manual_seed(seed)


def make_seg_train_step(*, ignore_index: int,
                        label_hw: Tuple[int, int] = (256, 512),
                        base_lr: float, dropout_seed: int = 0,
                        device_augment: bool = False, bn_mode: str = "sync",
                        mesh=None, grad_accum: int = 1, bf16: bool = False,
                        device=None):
    """Returns ``train_step(state, image, label) -> loss`` on ``device``
    (default: the CUDA device; raises without one).

    ``image`` is (N, H, W, C) float32 and ``label`` (N, H, W) int, both on
    the device; labels outside [0, C) and ``ignore_index`` add nothing to
    the loss. ``grad_accum > 1`` splits the batch into that many
    microbatches, each backpropagating its loss / grad_accum in order (so
    the BatchNorm running statistics thread through them in turn), then
    takes one optimizer step; the returned loss is the microbatches' mean.

    ``mesh``: the ranks of a process group (``parallel/mesh.DataMesh``);
    every rank passes its own batch, all of one size, and gets the same
    loss. ``bn_mode`` 'sync' or 'per_replica' as the module docstring
    says; without a mesh there is one replica, whose batch is the global
    batch, and the two are one step. Under 'sync' the ``grad_accum``
    microbatches are those of the global batch, as the JAX step scans
    them: microbatch ``i`` is global rows ``[i*mb, (i+1)*mb)``, so a rank
    adds the rows of its own batch that fall there, maybe none. Under
    'per_replica' each rank splits its own batch. A ``SpatialMesh``
    (``make_mesh_2d``) gives each rank its block of the global batch's
    rows and columns, as the module docstring says; its replicas are the
    data indices.

    ``device_augment``: the step takes raw full-size batches and crops,
    resizes to ``label_hw`` and flips them on the device before the forward
    (``ops/augment.random_resized_crop_flip``), as the JAX step does, with
    a generator of its own on the device seeded from (``dropout_seed`` + 1,
    step) and, with several replicas, the replica: the rank, or the data
    index on a ``SpatialMesh`` (``augment_generator``).
    """
    if bn_mode not in ("sync", "per_replica"):
        raise ValueError(f"unknown bn_mode {bn_mode!r}")
    device = resolve_device(device)

    grid = isinstance(mesh, pmesh.SpatialMesh)
    world, rank = (mesh.size, mesh.rank) if mesh is not None else (1, 0)
    # the replicas of the global batch: one a data index on a grid
    replicas, replica = ((mesh.data, mesh.data_index) if grid
                         else (world, rank))
    sync = bn_mode == "sync"
    # the group over which BatchNorm and the CE's count reduce
    norm_group = (None if mesh is None else mesh.group if sync
                  else mesh.spatial_group if grid else None)
    wrapped = {}

    def terms_of(model, image, label, layout=None, width=None):
        with torch.autocast(device.type, dtype=torch.bfloat16, enabled=bf16):
            x = image.permute(0, 3, 1, 2)
            if layout is not None:
                layout.start(x, width)
            out = model(x)["out"]
        # channels_last NCHW logits viewed as NHWC: no copy
        logits = out.to(torch.promote_types(out.dtype, torch.float32))
        logits = logits.permute(0, 2, 3, 1)
        return cross_entropy_terms(
            upsample_logits(logits, *label_hw, layout=layout), label,
            ignore_index=ignore_index)

    def ddp_of(model):
        ddp = wrapped.get("ddp")
        if ddp is None or ddp.module is not model:
            with warnings.catch_warnings():
                # newer torch calls broadcast_buffers deprecated, and says
                # to keep it where buffers must stay the rank's own
                warnings.simplefilter("ignore", FutureWarning)
                ddp = torch.nn.parallel.DistributedDataParallel(
                    model, device_ids=([device] if device.type == "cuda"
                                       else None),
                    broadcast_buffers=False, process_group=mesh.group)
            wrapped["ddp"] = ddp
        return ddp

    def microbatches(b: int):
        """The rows of this rank's batch of ``b`` in each microbatch."""
        if b % grad_accum:
            raise ValueError(f"batch {b} not divisible by grad_accum "
                             f"{grad_accum}")
        if not sync:
            mb = b // grad_accum
            return [slice(i * mb, (i + 1) * mb) for i in range(grad_accum)]
        mb = replicas * b // grad_accum
        return [slice(min(max(i * mb - replica * b, 0), b),
                      min(max((i + 1) * mb - replica * b, 0), b))
                for i in range(grad_accum)]

    def train_step(state: SegTrainState, image: torch.Tensor,
                   label: torch.Tensor) -> torch.Tensor:
        model = state.model
        layout = width = None
        if grid:
            # raw frames: labels at the image's size
            width, _ = grid_widths(mesh, image, label,
                                   "image" if device_augment else label_hw)
            layout = mesh.layout()
        if device_augment:
            if grid:
                # the crop takes any columns: every spatial rank of the data
                # index crops its whole rows with the same draws
                image, label = whole_rows(layout, width, image, label)
            image, label = random_resized_crop_flip(
                augment_generator(image.device, dropout_seed, state.step,
                                  *((replica,) if replicas > 1 else ())),
                image, labels=label, out_hw=label_hw)
            if grid:
                width = label_hw[1]
                lo, hi = layout.columns(width)
                image, label = image[:, :, lo:hi], label[:, :, lo:hi]
        rows_of = microbatches(image.shape[0])
        model.train()
        for group in state.optimizer.param_groups:
            group["lr"] = base_lr * state.lr_scale * group["lr_mult"]
        state.optimizer.zero_grad(set_to_none=True)
        net = model if mesh is None or grid else ddp_of(model)
        loss = torch.zeros((), device=image.device, dtype=torch.promote_types(
            image.dtype, torch.float32))
        with synchronised([model], norm_group), width_sharded([model],
                                                              layout):
            for i, rows in enumerate(rows_of):
                key = (((i,) if grad_accum > 1 else ())
                       + ((replica,) if replicas > 1 else ()))
                seed_dropout(model, dropout_seed, state.step, *key)
                last = mesh is None or grid or i == grad_accum - 1
                with contextlib.nullcontext() if last else net.no_sync():
                    nll_sum, count = terms_of(net, image[rows], label[rows],
                                              layout, width)
                    if norm_group is not None:
                        # this rank's share of the microbatch's CE: its
                        # NLL sum over the count of the ranks it spans
                        count = pmesh.all_reduce(count, group=norm_group)
                    part = nll_sum / count.clamp_min(1) / grad_accum
                    # DDP averages over the ranks; 'sync' wants their sum
                    (part * world if sync and not grid else part).backward()
                loss += part.detach()
        if grid:
            pmesh.all_reduce_grads(model.parameters(), mesh.group)
            if not sync:
                for p in model.parameters():
                    if p.grad is not None:
                        p.grad.div_(replicas)
        state.optimizer.step()
        state.step += 1
        if mesh is None:
            return loss
        if not sync:
            average_running_stats(model)
        loss = pmesh.all_reduce(loss, "sum" if sync or grid else "avg")
        return loss if sync or not grid else loss / replicas

    return train_step


def grid_widths(mesh, image: torch.Tensor, label: torch.Tensor,
                label_hw="blocks"):
    """(the global width of the image, the global (H, W) of the label)
    whose blocks this rank holds on the ``SpatialMesh`` ``mesh``, from
    every rank's block sizes gathered on the host (no device wait).
    ``label_hw``: the label's global size, or "image" (at the image's
    size, as raw frames are before the device augmentation), or "blocks"
    (whatever the blocks join to). Raises, on every rank alike, unless
    every rank holds as many rows and the columns of the even split of
    both widths that ``image_sharding`` and ``label_sharding`` cut."""
    sizes = pmesh.all_gather(torch.tensor(
        [image.shape[0], image.shape[1], image.shape[2], label.shape[0],
         label.shape[1], label.shape[2]]), pmesh.host_group()).tolist()
    width = sum(s[2] for s in sizes[:mesh.spatial])
    if label_hw == "image":
        label_hw = (sizes[0][1], width)
    elif label_hw == "blocks":
        label_hw = (sizes[0][4], sum(s[5] for s in sizes[:mesh.spatial]))
    label_h, label_w = label_hw
    for r, (n, h, w, ln, lh, lw) in enumerate(sizes):
        q = r % mesh.spatial
        lo, hi = column_range(width, mesh.spatial, q)
        llo, lhi = column_range(label_w, mesh.spatial, q)
        if (n, h) != tuple(sizes[0][:2]) or (ln, lh) != (n, label_h) \
                or (w, lw) != (hi - lo, lhi - llo):
            raise ValueError(
                f"rank {r}'s block ({n}, {h}, {w}) image, ({ln}, {lh}, "
                f"{lw}) label is not spatial shard {q} of {mesh.spatial} "
                f"of a {width}-wide image and a {(label_h, label_w)} "
                f"label with every rank's rows (blocks: {sizes})")
    return width, (label_h, label_w)


def whole_rows(layout, width: int, image: torch.Tensor,
               label: torch.Tensor):
    """The whole rows of this rank's (N, H, w, C) ``image`` and (N, H, w)
    ``label`` blocks of a ``width``-wide batch, from the ranks of its
    spatial group (every rank calls this together)."""
    every = [(0, width)] * layout.size
    image = gather_columns(image.permute(0, 3, 1, 2), layout, width, every)
    label = gather_columns(label[:, None], layout, width, every)
    return image.permute(0, 2, 3, 1), label[:, 0]


def augment_generator(device, dropout_seed: int, step: int,
                      *key: int) -> torch.Generator:
    """The device augmentation's generator of one step: on ``device``,
    seeded from (``dropout_seed`` + 1, ``step``, *key), apart from the
    dropout stream (``seed_dropout``) as JAX's ``key(dropout_seed + 1)``
    is."""
    return split_for_step(device, dropout_seed + 1, step, *key)


def average_running_stats(model: torch.nn.Module) -> None:
    """Replace every BatchNorm's running mean and variance by their mean
    over the ranks (JAX's ``pmean`` of the new batch statistics), in one
    all-reduce."""
    buffers = [b for m in model.modules() if isinstance(m, BatchNorm2d)
               for b in (m.running_mean, m.running_var)]
    if not buffers:
        return
    flat = pmesh.all_reduce(torch.cat([b.reshape(-1) for b in buffers]),
                            "avg")
    with torch.no_grad():
        for b, v in zip(buffers, flat.split([b.numel() for b in buffers])):
            b.copy_(v.view_as(b))


def build_seg_eval_step(*, num_classes: int, ignore_index: int, device=None,
                        bf16: bool = False, mesh=None):
    """Returns ``eval_step(model, image, label) -> (hist, loss, pred)`` on
    ``device`` (default: the CUDA device; raises without one).

    ``image`` is (N, H, W, C) float32 and ``label`` (N, H, W) int, both on
    the device. The forward runs in eval mode, whatever mode the model is
    in (the mode it had is restored after), as the JAX step applies
    ``train=False``; in inference mode and under bfloat16 autocast with
    ``bf16``. Its stride-8 logits are upsampled to the label's own (H, W).
    ``loss`` is the CE over the upsampled logits; ``pred`` (N, H, W) int32
    comes from the fused ``upsample_argmax`` kernel on the stride-8 logits
    (its plain version on the CPU); ``hist`` is the int64 (C, C) confusion
    matrix of the batch. Nothing is copied to the host.

    With a ``parallel/mesh.SpatialMesh`` (``make_mesh_2d``) each rank
    passes its block of the global batch, its data index's rows and its
    spatial index's columns of the image and of the label
    (``image_sharding``, ``label_sharding``; the label's global size is
    what its blocks join to), and the step is the JAX step fed
    width-sharded inputs. The forward runs on the width shards
    (``nn/spatial.py``); ``loss`` is the CE of the rank's label columns
    (the sharded upsample) summed over the grid and divided by the grid's
    count of valid pixels, the same on every rank; ``hist`` is the whole
    grid's, on every rank; ``pred`` is the rank's block, from the kernel
    on whole rows: the stride-8 logits' columns are gathered over the
    spatial group (at most 8 x 33 x 65 x 13 float32 at 256x512), each
    spatial rank upsamples its rows to the label's global size and keeps
    its columns. The block sizes are checked first, as the train step
    checks them (``grid_widths``).
    """
    device = resolve_device(device)

    def eval_step(model, image: torch.Tensor, label: torch.Tensor):
        out_h, out_w = label.shape[1:3]
        with frozen_inference(model):
            logits = forward_nhwc(model, image, bf16=bf16)["out"]
            loss = cross_entropy(upsample_logits(logits, out_h, out_w),
                                 label, ignore_index=ignore_index)
            pred, _ = upsample_argmax(logits, out_h, out_w)
            hist = confusion_matrix(pred, label, num_classes)
        return hist, loss, pred

    def grid_eval_step(model, image: torch.Tensor, label: torch.Tensor):
        width, (out_h, out_w) = grid_widths(mesh, image, label)
        layout = mesh.layout()
        with frozen_inference(model), width_sharded([model], layout):
            x = image.permute(0, 3, 1, 2)
            layout.start(x, width)
            with torch.autocast(device.type, dtype=torch.bfloat16,
                                enabled=bf16):
                out = model(x)["out"]
            logits = out.float()                     # NCHW, this rank's
            nll_sum, count = cross_entropy_terms(upsample_logits(
                logits.permute(0, 2, 3, 1), out_h, out_w, layout=layout),
                label, ignore_index=ignore_index)
            loss = (pmesh.all_reduce(nll_sum, group=mesh.group)
                    / pmesh.all_reduce(count, group=mesh.group).clamp_min(1))
            logits_w = layout.width_of(logits)
            rows = gather_columns(logits, layout, logits_w,
                                  [(0, logits_w)] * layout.size)
            pred, _ = upsample_argmax(rows.permute(0, 2, 3, 1), out_h, out_w)
            lo, hi = layout.columns(out_w)
            pred = pred[:, :, lo:hi]
            hist = pmesh.all_reduce(confusion_matrix(pred, label,
                                                     num_classes),
                                    group=mesh.group)
        return hist, loss, pred

    if mesh is None:
        return eval_step
    if not isinstance(mesh, pmesh.SpatialMesh):
        raise TypeError(f"the eval step takes a SpatialMesh, not "
                        f"{type(mesh).__name__}")
    return grid_eval_step


def forward_nhwc(model, image: torch.Tensor, *, bf16: bool = False) -> dict:
    """``model``'s ``{'feat', 'out'}`` for an (N, H, W, C) ``image``, as
    float32 (N, h, w, F) / (N, h, w, classes) tensors: the channels_last
    NCHW outputs viewed as NHWC, no copy. The forward runs under bfloat16
    autocast with ``bf16``."""
    with torch.autocast(image.device.type, dtype=torch.bfloat16,
                        enabled=bf16):
        out = model(image.permute(0, 3, 1, 2))
    return {k: v.float().permute(0, 2, 3, 1) for k, v in out.items()}


@contextlib.contextmanager
def frozen_inference(model):
    """Eval mode and ``torch.inference_mode()`` inside the block, whatever
    mode ``model`` was in (the mode it had is restored after), as the JAX
    package's inference steps apply ``train=False``: no BatchNorm buffer
    moves, no dropout, no autograd graph."""
    was_training = model.training
    model.eval()
    try:
        with torch.inference_mode():
            yield
    finally:
        model.train(was_training)
