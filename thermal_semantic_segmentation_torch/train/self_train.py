"""Prototype-rectified self-training step (counterpart of the JAX
``train/self_train.py``; reference self_training.py:17-227).

One step, all on the device:
  - the EMA teacher's eval-mode forward on the full-size target frame;
  - ``full2weak``: the teacher's features sampled into the student's
    augmented view (an align-corners resize, then a crop and a flip, is a
    bilinear sample at per-sample affine coordinates);
  - the prototype-distance weights, the rectified soft labels, the
    confidence threshold and the hard-label override (self_training.py:
    106-112);
  - the student's source and target passes, one after the other, so the
    BatchNorm running statistics thread from source to target as in the
    reference (the JAX package's vmap-fused form is a TPU latency trick and
    equals this one); source CE plus pseudo CE and reverse CE (:114-118);
  - one backward and one Adam step;
  - the moving prototypes (:123-126): the teacher's classes from the
    ``upsample_argmax`` kernel on its stride-8 logits at full/4 size, its
    features resized apart, masked means and the sequential fold;
  - the EMA teacher (:128-132): parameters ``0.999 e + 0.001 q`` with
    ``torch._foreach_*``, buffers copied.

Nothing syncs to the host inside the step; the losses come back as device
tensors.

Under a ``mesh`` (``parallel/mesh.DataMesh``, one rank per card) the step
is the JAX step on the global batch, the ranks' batches in rank order:
- both student passes normalise with the global batch's BatchNorm
  statistics (``nn/resnet.synchronised``) and fold them, source then
  target;
- the source CE, the pseudo CE and the reverse CE are sums over each
  rank's valid pixels divided by the all-reduced global counts (the
  pseudo-labels are mostly ``ignore_index``, so the ranks' counts differ
  and a mean of the ranks' means is not the global mean);
- the student runs two forwards before one backward, so no DDP wrapper:
  after the backward ``all_reduce_grads`` sums the ranks' gradients, each
  the gradient of that rank's share of the global loss;
- the moving prototypes: each rank runs the kernel and the masked means
  on its own rows, the per-sample vectors are all-gathered into global
  order and every rank folds them, so the prototypes and counts stay
  bit-equal on every rank, as do the EMA teacher and its buffers (the
  parameters are).
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..kernels.upsample_argmax import upsample_argmax
from ..losses import cross_entropy_terms, reverse_cross_entropy_terms
from ..nn.resnet import synchronised
from ..ops.class_means import fold_prototypes, masked_class_means
from ..ops.resize import (resize_bilinear, resize_bilinear_taps,
                          resize_nearest, sample_bilinear_at, upsample_logits)
from ..parallel import mesh as pmesh
from .seg import create_seg_state, forward_nhwc, frozen_inference, seed_dropout

SCALE = 4   # self_training.py:29 scale_rate: pseudo labels at label_hw / 4


@dataclass
class SelfTrainState:
    model: torch.nn.Module          # the student
    teacher: torch.nn.Module        # the EMA teacher, eval mode, no grads
    optimizer: torch.optim.Optimizer
    prototypes: torch.Tensor        # (num_classes, F) float32
    proto_counts: torch.Tensor      # (num_classes,) float32
    step: int = 0
    lr_scale: float = 1.0           # plateau-scheduler scale, set from the host


def create_self_train_state(model: torch.nn.Module, *, prototypes,
                            learning_rate: float, num_classes: int = 13,
                            device=None) -> SelfTrainState:
    """The student ``model`` (on ``device``; default: the CUDA device,
    raises without one), a deep copy of it as the teacher, Adam with
    optax's defaults over the student (``train/seg.create_seg_state``), the
    (C, F) ``prototypes`` (array or tensor) and zero counts."""
    seg = create_seg_state(model, learning_rate=learning_rate, device=device)
    device = resolve_device(device)
    teacher = copy.deepcopy(model).eval().requires_grad_(False)
    return SelfTrainState(
        model=model, teacher=teacher, optimizer=seg.optimizer,
        prototypes=torch.as_tensor(np.asarray(prototypes),
                                   dtype=torch.float32).to(device),
        proto_counts=torch.zeros((num_classes,), dtype=torch.float32,
                                 device=device))


def full2weak_coords(weak_params: dict, *, feat_hw: Tuple[int, int],
                     out_hw: Tuple[int, int]):
    """Per-sample fractional source coordinates into the full-size feature
    map: (rows (B, out_h), cols (B, out_w)) float32.

    weak_params: {'resized_hw': (B, 2) int, 'crop': (B, 4) int (y1, y2, x1,
    x2), 'flip': (B,) bool} as ``data/self_train_aug`` records them. Every
    /4 is a floor division, as in the reference (self_training.py:151); a
    flipped sample reads its columns in reverse.
    """
    hf, wf = feat_hw
    oh, ow = out_hw
    resized, crop = weak_params["resized_hw"], weak_params["crop"]
    h4 = torch.div(resized[:, 0], 4, rounding_mode="floor").float()
    w4 = torch.div(resized[:, 1], 4, rounding_mode="floor").float()
    y1_4 = torch.div(crop[:, 0], 4, rounding_mode="floor").float()
    x1_4 = torch.div(crop[:, 2], 4, rounding_mode="floor").float()
    # the align-corners scale of the (hf, wf) -> (h4, w4) resize, as a true
    # float32 division (``int / tensor`` multiplies by a reciprocal)
    sr = torch.full_like(h4, hf - 1) / torch.clamp(h4 - 1.0, min=1.0)
    sc = torch.full_like(w4, wf - 1) / torch.clamp(w4 - 1.0, min=1.0)
    steps_h = torch.arange(oh, device=h4.device, dtype=torch.float32)
    steps_w = torch.arange(ow, device=w4.device, dtype=torch.float32)
    rows = (y1_4[:, None] + steps_h[None, :]) * sr[:, None]
    cols = (x1_4[:, None] + steps_w[None, :]) * sc[:, None]
    cols = torch.where(weak_params["flip"].bool()[:, None], cols.flip(1),
                       cols)
    return rows, cols


def prototype_weights(feat_weak: torch.Tensor, prototypes: torch.Tensor,
                      temperature: float) -> torch.Tensor:
    """``softmax(-(d - d_min) * T)`` over the per-class L2 distances of the
    features to the prototypes (self_training.py:136-143, 160-165), with
    ``d^2 = |f|^2 - 2 f.p + |p|^2`` clamped at 1e-12, in float32.
    feat_weak: (B, h, w, F) -> (B, h, w, C)."""
    f = feat_weak.float()
    p = prototypes.float()
    f2 = (f * f).sum(dim=-1, keepdim=True)
    p2 = (p * p).sum(dim=-1)
    fp = torch.einsum("bhwf,cf->bhwc", f, p)
    dist = torch.sqrt(torch.clamp(f2 - 2.0 * fp + p2, min=1e-12))
    dist = dist - dist.amin(dim=-1, keepdim=True)
    return torch.softmax(-dist * temperature, dim=-1)


def pseudo_labels(ema_feat: torch.Tensor, prototypes: torch.Tensor,
                  target_lp_soft: Optional[torch.Tensor],
                  target_lp_hard: torch.Tensor, weak_params: dict, *,
                  out_hw: Tuple[int, int], ignore_index: int,
                  proto_temperature: float = 0.5, train_thred: float = 0.0,
                  proto_rectify: bool = True) -> torch.Tensor:
    """The student's (B, out_h, out_w) int64 targets (JAX step :161-182).

    Rectified: the soft maps (B, C, th, tw) resized to ``out_hw``, weighted
    by ``prototype_weights`` of the teacher's features (B, fh, fw, F)
    sampled into each student view; their argmax, ``ignore_index`` where
    the normalised maximum is under ``train_thred``, and the hard ids
    (resized nearest) wherever those are not ``ignore_index``.

    Without ``proto_rectify`` the hard ids are resized bilinearly (in the
    JAX arithmetic, ``resize_bilinear_taps``) and truncated, as the JAX step
    does (its :179-182): a pixel between two classes takes an id between
    them, and one inside an ignore region may land just under 12 and
    become class 11 (ROADMAP.md §3).
    """
    oh, ow = out_hw
    if not proto_rectify:
        hard = resize_bilinear_taps(target_lp_hard[..., None], oh, ow)
        return hard[..., 0].to(torch.int32).long()
    soft = resize_bilinear(target_lp_soft.float().permute(0, 2, 3, 1), oh, ow)
    rows, cols = full2weak_coords(weak_params, feat_hw=ema_feat.shape[1:3],
                                  out_hw=out_hw)
    weights = prototype_weights(sample_bilinear_at(ema_feat, rows, cols),
                                prototypes, proto_temperature)
    hard = resize_nearest(target_lp_hard[..., None], oh, ow)[..., 0].long()
    rectified = weights * soft
    pseudo = rectified.argmax(dim=-1)
    rect_norm = rectified / rectified.sum(dim=-1, keepdim=True).clamp_min(1e-12)
    pseudo = torch.where(rect_norm.amax(dim=-1) < train_thred, ignore_index,
                         pseudo)
    return torch.where(hard != ignore_index, hard, pseudo)


def ema_update(teacher_params, student_params, decay: float) -> None:
    """The EMA teacher's update in place, ``e * decay + q * (1 - decay)``
    over the lists of tensors ``teacher_params`` (e) and
    ``student_params`` (q), in their dtype (JAX ``train/self_train.py``'s
    expression, reference self_training.py:128-132). Where ``e * decay``
    and ``q * (1 - decay)`` nearly cancel (a parameter near 0) the result's
    ulp is far below either term's, and neither this nor the JAX order of
    operations keeps the error within a few ulps of the result: it is
    within a few ulps of the larger term."""
    torch._foreach_mul_(teacher_params, decay)
    torch._foreach_add_(teacher_params, student_params, alpha=1.0 - decay)


def make_self_train_step(*, num_classes: int, ignore_index: int,
                         base_lr: float, proto_temperature: float = 0.5,
                         train_thred: float = 0.0, rce: bool = True,
                         rce_alpha: float = 0.1, rce_beta: float = 1.0,
                         proto_rectify: bool = True, ema: bool = True,
                         moving_prototype: bool = True,
                         proto_momentum: float = 1e-4,
                         ema_decay: float = 0.999,
                         label_hw: Tuple[int, int] = (256, 512),
                         dropout_seed: int = 0, bf16: bool = False,
                         mesh=None, device=None):
    """Returns ``step(state, source_image, source_label, target_image,
    target_image_full, target_lp_soft, target_lp_hard, weak_params,
    mark=None) -> (loss_pseudo, loss_source)`` on ``device`` (default: the
    CUDA device; raises without one).

    Images are (B, H, W, C) float32: source and target at ``label_hw``,
    the full target frame at its own size; labels (B, H, W) int;
    target_lp_soft (B, C, th, tw) channel-first as saved and augmented, or
    None with ``proto_rectify=False``; weak_params as
    ``full2weak_coords`` takes them. All on the device. ``mark``, when
    given, is called with each stage's name as the stage has been queued
    (the smoke test brackets them with CUDA events).

    The other arguments are the JAX step's (``pseudo_labels`` takes the
    rectification's); the student's passes run in sequence, which the JAX
    package's ``fused_student=False`` is. ``mesh``: the ranks of a process
    group, each passing its own batch, all of one size; every rank gets
    the global batch's losses (the module docstring says how). Each rank
    seeds its dropout with its rank folded in, as ``train/seg`` does.
    """
    device = resolve_device(device)
    oh, ow = label_hw[0] // SCALE, label_hw[1] // SCALE
    world, rank = (mesh.size, mesh.rank) if mesh is not None else (1, 0)
    pg = mesh.group if mesh is not None else None
    rank_key = (rank,) if world > 1 else ()

    def step(state: SelfTrainState, source_image, source_label, target_image,
             target_image_full, target_lp_soft, target_lp_hard, weak_params,
             mark: Optional[Callable[[str], None]] = None):
        mark = mark or (lambda stage: None)
        student, teacher, opt = state.model, state.teacher, state.optimizer
        fh, fw = (s // SCALE for s in target_image_full.shape[1:3])

        # the teacher on the full frame (no gradient)
        with frozen_inference(teacher):
            ema_out = forward_nhwc(teacher, target_image_full, bf16=bf16)
            ema_feat = resize_bilinear(ema_out["feat"], fh, fw)
        mark("teacher_forward")
        with torch.no_grad():
            pseudo = pseudo_labels(
                ema_feat, state.prototypes, target_lp_soft, target_lp_hard,
                weak_params, out_hw=(oh, ow), ignore_index=ignore_index,
                proto_temperature=proto_temperature, train_thred=train_thred,
                proto_rectify=proto_rectify)
        mark("rectify")

        # the student: source, then target, one backward
        student.train()
        for group in opt.param_groups:
            group["lr"] = base_lr * state.lr_scale * group["lr_mult"]
        opt.zero_grad(set_to_none=True)
        with synchronised([student], pg):
            seed_dropout(student, dropout_seed, state.step, *rank_key)
            src = forward_nhwc(student, source_image, bf16=bf16)["out"]
            src_terms = cross_entropy_terms(
                upsample_logits(src, *label_hw), source_label,
                ignore_index=ignore_index)
            mark("student_source")
            seed_dropout(student, dropout_seed, state.step, 1, *rank_key)
            tgt = forward_nhwc(student, target_image, bf16=bf16)["out"]
            tgt_logits = resize_bilinear(tgt, oh, ow)
            terms = [*src_terms, *cross_entropy_terms(
                tgt_logits, pseudo, ignore_index=ignore_index)]
            if rce:
                terms += reverse_cross_entropy_terms(
                    tgt_logits, pseudo, num_classes=num_classes,
                    ignore_index=ignore_index)
            sums, counts = terms[0::2], torch.stack(
                [c.float() for c in terms[1::2]])
            if mesh is not None:
                counts = pmesh.all_reduce(counts, group=pg)
            # each loss is this rank's share of the global batch's: its
            # sum over the global count (with one process, the loss)
            loss_source = sums[0] / counts[0].clamp_min(1)
            loss_pseudo = sums[1] / counts[1].clamp_min(1)
            if rce:
                loss_pseudo = (rce_alpha * loss_pseudo + rce_beta
                               * (sums[2] / (counts[2] + 1e-6)))
            mark("student_target")
            (loss_source + loss_pseudo).backward()
        if mesh is not None:
            pmesh.all_reduce_grads(student.parameters(), pg)
        mark("backward")
        opt.step()
        mark("adam")

        with torch.no_grad():
            if moving_prototype:
                pred, conf = upsample_argmax(ema_out["out"], fh, fw)
                vectors, valid = masked_class_means(
                    ema_feat, pred, conf, num_classes=num_classes)
                if mesh is not None:
                    # the global batch's vectors in sample order
                    vectors = pmesh.gather_rows(vectors, pg)
                    valid = pmesh.gather_rows(valid.to(torch.uint8),
                                              pg).bool()
                state.prototypes, state.proto_counts = fold_prototypes(
                    state.prototypes, state.proto_counts, vectors, valid,
                    momentum=proto_momentum, mode="moving_average",
                    start_mean=False)
                mark("prototypes")
            if ema:
                ema_update(list(teacher.parameters()),
                           list(student.parameters()), ema_decay)
                torch._foreach_copy_(list(teacher.buffers()),
                                     list(student.buffers()))
                mark("ema")
        state.step += 1
        losses = torch.stack([loss_pseudo.detach(), loss_source.detach()])
        if mesh is not None:
            losses = pmesh.all_reduce(losses, group=pg)
        return losses[0], losses[1]

    return step
