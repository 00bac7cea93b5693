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
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..kernels.upsample_argmax import upsample_argmax
from ..losses import cross_entropy
from ..models.deeplab import backbone_and_head_params
from ..nn.aspp import Dropout2d
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
    ``device_augment`` and ``bn_mode='per_replica'`` / ``mesh``
    (multi-GPU) are not yet ported.
    """
    if device_augment:
        raise NotImplementedError(
            "device_augment (ops/augment.py) is not yet ported to the "
            "PyTorch package (see ROADMAP.md)")
    if bn_mode == "per_replica" or mesh is not None:
        raise NotImplementedError(
            "bn_mode='per_replica' and mesh (multi-GPU training) are not yet "
            "ported to the PyTorch package (see ROADMAP.md)")
    if bn_mode != "sync":
        raise ValueError(f"unknown bn_mode {bn_mode!r}")
    device = resolve_device(device)

    def loss_of(model, image, label):
        with torch.autocast(device.type, dtype=torch.bfloat16, enabled=bf16):
            out = model(image.permute(0, 3, 1, 2))["out"]
        # channels_last NCHW logits viewed as NHWC: no copy
        logits = out.float().permute(0, 2, 3, 1)
        return cross_entropy(upsample_logits(logits, *label_hw), label,
                             ignore_index=ignore_index)

    def train_step(state: SegTrainState, image: torch.Tensor,
                   label: torch.Tensor) -> torch.Tensor:
        if image.shape[0] % grad_accum:
            raise ValueError(f"batch {image.shape[0]} not divisible by "
                             f"grad_accum {grad_accum}")
        model, opt = state.model, state.optimizer
        model.train()
        for group in opt.param_groups:
            group["lr"] = base_lr * state.lr_scale * group["lr_mult"]
        opt.zero_grad(set_to_none=True)
        if grad_accum == 1:
            seed_dropout(model, dropout_seed, state.step)
            loss = loss_of(model, image, label)
            loss.backward()
            loss = loss.detach()
        else:
            loss = torch.zeros((), device=image.device)
            for i, (im, lab) in enumerate(zip(image.chunk(grad_accum),
                                              label.chunk(grad_accum))):
                seed_dropout(model, dropout_seed, state.step, i)
                mb_loss = loss_of(model, im, lab) / grad_accum
                mb_loss.backward()
                loss += mb_loss.detach()
        opt.step()
        state.step += 1
        return loss

    return train_step


def build_seg_eval_step(*, num_classes: int, ignore_index: int, device=None,
                        bf16: bool = False):
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
    """
    device = resolve_device(device)

    def eval_step(model, image: torch.Tensor, label: torch.Tensor):
        out_h, out_w = label.shape[1:3]
        was_training = model.training
        model.eval()
        try:
            with torch.inference_mode():
                with torch.autocast(device.type, dtype=torch.bfloat16,
                                    enabled=bf16):
                    out = model(image.permute(0, 3, 1, 2))["out"]
                # channels_last NCHW logits viewed as NHWC: no copy
                logits = out.float().permute(0, 2, 3, 1)
                loss = cross_entropy(upsample_logits(logits, out_h, out_w),
                                     label, ignore_index=ignore_index)
                pred, _ = upsample_argmax(logits, out_h, out_w)
                hist = confusion_matrix(pred, label, num_classes)
        finally:
            model.train(was_training)
        return hist, loss, pred

    return eval_step
