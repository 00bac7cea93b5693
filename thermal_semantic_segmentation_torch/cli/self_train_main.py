"""Self-training entry point (counterpart of the JAX
``cli/self_train_main.py``; reference self_train_main.py:18-140).

Reads what ``generate_pseudo_label`` (soft and hard pseudo-labels) and
``cal_prototype`` (class prototypes) wrote for ``-checkpoint_name``, then
runs the prototype-rectified self-training loop with an EMA teacher,
validating on the Freiburg IR test split every ``--val_interval`` steps and
saving ``best``/``last`` checkpoints with the moving prototypes:

    python -m thermal_semantic_segmentation_torch.cli.self_train_main \\
        --root . -checkpoint_name s.pth [--device cpu]

``self_train_epochs`` is the epoch loop; it takes its loaders, so a caller
can drive it with data of its own. Validation goes through ``seg_validate``
(each tail batch at its own size), so the CUDA ``upsample_argmax`` kernel
gives every validation batch's predictions, as it gives the teacher's
classes for the moving prototypes in each step. A SIGTERM or SIGINT stops
the loop after the step in flight and writes
``preempt_<-new_checkpoint_name>`` (the moving prototypes included), which
``--load_model true -checkpoint_name preempt_<name>`` resumes, the
interrupted epoch redone.

With ``--distributed true`` (torchrun, or the ``--coordinator_address``
flags) each rank trains on its ``host_shard`` of both train sets and the
step is the JAX step on the global batch (``train/self_train.py``).
Every decision that ends or steers the loop agrees across ranks: the
preemption poll is all-reduced (``utils/preempt.cross_process``) and each
validation's scores are rank 0's (or, with ``--data_parallel``, the
ranks' shards reduced), so the plateau scheduler, the early stop and the
best-mIoU save take the same turn everywhere; process 0 writes the
checkpoints. ``--data_parallel true`` shards validation: over the ranks
under ``--distributed``, else over this process's cards
(``parallel/mesh.LocalMesh``).
"""

from __future__ import annotations

import os
import time

import torch
import torch.distributed as dist

from ..core.checkpoint import load_checkpoint
from ..core.schedule import ReduceLROnPlateau
from ..data.device_pipeline import device_prefetch
from ..data.freiburg import Freiburg, FreiburgTest
from ..data.loader import DataLoader
from ..data.self_train_aug import SelfTrainAugment
from ..device import resolve_device
from ..eval.validate import seg_validate
from ..parallel import mesh as pmesh
from ..train.seg import build_seg_eval_step
from ..train.self_train import create_self_train_state, make_self_train_step
from ..utils.logging import get_logger
from ..utils.meters import AverageMeter, ProgressMeter
from ..utils.preempt import GracefulShutdown, NullShutdown, cross_process
from ._common import (apply_model_meta, build_deeplab, load_seg_checkpoint,
                      maybe_data_parallel, primary_host, resolve_wire,
                      save_seg_checkpoint, train_transform, val_transform)
from .cal_prototype import prototype_path
from .options import self_train_parse


def make_loaders(args):
    """(source, target, target val) loaders as the JAX CLI builds them:
    the translated RGB train frames with ``train_transform``, the IR train
    frames in self-training mode with their pseudo-labels, each process on
    its ``host_shard``, and the IR test split with ``val_transform``
    (sharded over the processes too with ``--data_parallel``)."""
    source = Freiburg(args.freiburg_root, "train", "RGB",
                      translation_name=args.translation_name,
                      segmentation_mode=True, transforms=train_transform())
    target = Freiburg(
        args.freiburg_root, "train", "IR", segmentation_mode=True,
        self_train=args.self_train,
        augmentations=SelfTrainAugment(args.resize, tuple(args.rcrop),
                                       args.hflip),
        path_soft=args.path_soft, path_lp=args.path_lp,
        threshold=args.threshold, ignore_index=args.ignore_index,
        proto_rectify=args.proto_rectify)
    target_val = FreiburgTest(args.freiburg_root, "test", "IR",
                              transforms=val_transform(), with_label=True)
    shard = pmesh.host_shard()
    return (DataLoader(source, args.batch_size, shuffle=True, drop_last=True,
                       seed=args.seed, shard=shard),
            DataLoader(target, args.batch_size, shuffle=True, drop_last=True,
                       seed=args.seed + 1, shard=shard),
            DataLoader(target_val, args.batch_size, shuffle=False,
                       drop_last=False, seed=args.seed + 2,
                       shard=shard if args.data_parallel else None,
                       shard_lockstep=False))


def merged_batches(tgt_loader, src_loader):
    """One dict per step from a target and a source batch."""
    for t, s in zip(tgt_loader, src_loader):
        batch = {"s_image": s["image"], "s_label": s["label"],
                 "t_image": t["image"], "t_full": t["image_full"],
                 "t_hard": t["label_hard"], "wp": t["weak_params"]}
        if "label_soft" in t:
            batch["t_soft"] = t["label_soft"]
        yield batch


def self_train_epochs(args, logger, src_loader, tgt_loader, val_loader,
                      shutdown=None):
    """Self-train ``args.epochs`` epochs (from the checkpoint's epoch + 1
    with ``--load_model``). Returns (state, history): one dict per epoch
    with its steps, target images, seconds of steps (validation excluded,
    up to a device synchronisation), step losses as (pseudo, source)
    pairs, its validations (step, mean_iu, val_loss, lr_scale, saved), the
    best mean_iu at its start and end, and whether it stopped early or
    was preempted. ``shutdown`` (a ``GracefulShutdown``) is polled before
    every step; once requested, ``preempt_<-new_checkpoint_name>`` is
    written with the previous epoch's number and the loop returns."""
    device = resolve_device(args.device or None)
    shutdown = cross_process(shutdown if shutdown is not None
                             else NullShutdown())
    # a process group (even of one rank) trains through the mesh step
    mesh = pmesh.make_mesh(device) if dist.is_initialized() else None
    distributed = pmesh.process_count() > 1
    # validation: every rank scores the whole set and takes rank 0's
    # scores, or (--data_parallel) its shard, reduced over the ranks;
    # one process shards it over its cards with --data_parallel
    reduce_val = (distributed
                  and getattr(val_loader, "shard", None) is not None)
    val_mesh = (None if distributed else
                maybe_data_parallel(args, args.batch_size, "validating"))
    restart_epoch, meta = 0, {}
    if args.load_model:
        path = os.path.join(args.model_root_path, args.checkpoint_name)
        state_dict, meta = load_seg_checkpoint(path)
        apply_model_meta(args, meta)   # the checkpoint's architecture wins
        restart_epoch = int(meta.get("epoch", -1)) + 1
        logger.info("loaded %s, resume from epoch %d", args.checkpoint_name,
                    restart_epoch)
        model = build_deeplab(args, device=device)
        model.load_state_dict(state_dict, strict=True)
        del state_dict
    else:
        model = build_deeplab(args, device=device)

    if "objective_vectors" in meta:
        # a self-training checkpoint (best/last): its moving prototypes are
        # the training state; the offline file belongs to the original
        # checkpoint's name
        prototypes = meta["objective_vectors"]
    else:
        prototypes = load_checkpoint(prototype_path(
            args.root, args.target_dataset,
            args.checkpoint_name))["objective_vectors"]
    state = create_self_train_state(model, prototypes=prototypes,
                                    learning_rate=args.lr,
                                    num_classes=args.num_classes,
                                    device=device)
    step = make_self_train_step(
        num_classes=args.num_classes, ignore_index=args.ignore_index,
        base_lr=args.lr, proto_temperature=args.proto_temperature,
        train_thred=args.train_thred, rce=args.rce, rce_alpha=args.rce_alpha,
        rce_beta=args.rce_beta, proto_rectify=args.proto_rectify,
        ema=args.ema, moving_prototype=args.moving_prototype,
        proto_momentum=args.proto_momentum,
        label_hw=(args.rcrop[1], args.rcrop[0]), dropout_seed=args.seed,
        bf16=args.bf16, mesh=mesh, device=device)
    eval_step = build_seg_eval_step(num_classes=args.num_classes,
                                    ignore_index=args.ignore_index,
                                    device=device, bf16=args.bf16)
    # the reference feeds mean_iu to a 'min' plateau scheduler
    # (self_train_main.py:67, 117); kept for parity
    scheduler = ReduceLROnPlateau(mode="min")
    # a resume keeps the best so far (else it would overwrite the best
    # checkpoint with a worse one)
    highest_mean_iu = float(meta.get("highest_mean_iu",
                                     args.initial_best_miou))
    os.makedirs(os.path.join(args.root, args.model_root_path), exist_ok=True)

    def save(tag: str, epoch: int):
        save_seg_checkpoint(
            os.path.join(args.root, args.model_root_path,
                         tag + args.new_checkpoint_name),
            state.model.state_dict(), epoch=epoch,
            highest_mean_iu=highest_mean_iu,
            objective_vectors=state.prototypes)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    # the soft pseudo-labels feed float32 prototype weights: never bf16 on
    # the wire, as in the JAX CLI
    wire = resolve_wire(args, bf16_compute=False)
    history, stale_vals = [], 0
    for epoch in range(restart_epoch, restart_epoch + args.epochs):
        pseudo_loss = AverageMeter("pseudo_loss", ":3.4f")
        s_loss = AverageMeter("s_loss", ":3.4f")
        progress = ProgressMeter(len(tgt_loader), [pseudo_loss, s_loss],
                                 prefix=f"Epoch: [{epoch}]")
        record = {"epoch": epoch, "steps": 0, "target_images": 0,
                  "train_s": 0.0, "losses": [], "validations": [],
                  "best_at_start": highest_mean_iu, "stopped_early": False,
                  "preempted": False}
        history.append(record)
        losses = []
        start = time.perf_counter()
        for i, b in enumerate(device_prefetch(
                merged_batches(tgt_loader, src_loader), device, wire=wire)):
            if args.max_steps and i >= args.max_steps:
                break
            if shutdown.requested:
                break
            loss_pseudo, loss_source = step(
                state, b["s_image"], b["s_label"], b["t_image"], b["t_full"],
                b.get("t_soft"), b["t_hard"], b["wp"])
            losses.append(torch.stack([loss_pseudo, loss_source]))
            record["steps"] += 1
            record["target_images"] += b["t_image"].shape[0]
            if i % 10 == 0:      # host sync only at log points
                pseudo_loss.update(float(loss_pseudo), args.batch_size)
                s_loss.update(float(loss_source), args.batch_size)
                progress.display(i, logger)

            if i % args.val_interval == 0 or i == len(tgt_loader) - 1:
                sync()
                record["train_s"] += time.perf_counter() - start
                mean_iu, val_loss, class_iou = seg_validate(
                    state.model, val_loader, num_classes=args.num_classes,
                    ignore_index=args.ignore_index, eval_step=eval_step,
                    visualize=(args.visualize_prediction
                               if primary_host() else None),
                    save_root=os.path.join(
                        args.root, "predictions",
                        args.new_checkpoint_name.replace(".pth", "")),
                    iter_counter=args.iter_counter, device=device,
                    mesh=val_mesh, reduce_processes=reduce_val, wire=wire)
                if distributed and not reduce_val:
                    mean_iu, val_loss = agreed_scores(mean_iu, val_loss)
                msg = "target test dataset mean iou score: " + str(mean_iu)
                logger.info(msg); print(msg)
                for k, v in class_iou.items():
                    line = f"target set class {k}: {v}"
                    logger.info(line); print(line)
                state.lr_scale = scheduler.step(mean_iu)
                saved = mean_iu > highest_mean_iu
                record["validations"].append(
                    {"step": i, "mean_iu": mean_iu, "val_loss": val_loss,
                     "lr_scale": state.lr_scale, "saved": saved})
                if saved:
                    highest_mean_iu = mean_iu
                    stale_vals = 0
                    print(f"mean iou improved to {mean_iu}! Saving...")
                    save("best", epoch)
                else:
                    print("Model not improved.")
                    stale_vals += 1
                    if (args.early_stop_patience
                            and stale_vals >= args.early_stop_patience):
                        msg = (f"early stop: no target-mIoU improvement in "
                               f"{stale_vals} consecutive validations "
                               f"(best {highest_mean_iu:.4f})")
                        print(msg); logger.info(msg)
                        record["stopped_early"] = True
                        break
                sync()
                start = time.perf_counter()
            args.iter_counter += 1
        if not record["stopped_early"]:
            sync()
            record["train_s"] += time.perf_counter() - start
        record["losses"] = (torch.stack(losses).tolist() if losses else [])
        record["best_at_end"] = highest_mean_iu
        if shutdown.requested:
            save("preempt_", epoch - 1)
            msg = (f"preempted (signal {shutdown.signum}) during epoch "
                   f"{epoch}; saved preempt_{args.new_checkpoint_name}: "
                   f"resume with --load_model true -checkpoint_name "
                   f"preempt_{args.new_checkpoint_name} --path_soft "
                   f"{args.path_soft} --path_lp {args.path_lp} (the "
                   f"pseudo-label paths otherwise follow the new "
                   f"checkpoint's name)")
            print(msg); logger.info(msg)
            record["preempted"] = True
            break
        save("last", epoch)
        if record["stopped_early"]:
            break
    return state, history


def agreed_scores(mean_iu: float, val_loss: float):
    """Rank 0's (mean_iu, val_loss) on every rank: the decisions they
    steer must not part over a last bit of a rank's own validation."""
    scores = pmesh.broadcast(torch.tensor([mean_iu, val_loss],
                                          dtype=torch.float64))
    return float(scores[0]), float(scores[1])


def self_train_main(args, logger, shutdown=None):
    return self_train_epochs(args, logger, *make_loaders(args),
                             shutdown=shutdown)


def main(argv=None):
    args = self_train_parse().parse_args(argv)
    resolve_device(args.device or None)   # no card and no --device: raise
    stem = args.checkpoint_name.replace(".pth", "")
    if not args.path_soft:
        args.path_soft = os.path.join(args.root, "pseudo_labels",
                                      args.pseudo_type, stem)
    if not args.path_lp:
        args.path_lp = os.path.join(args.root, "pseudo_labels", "hard", stem)
    args.logdir = os.path.join("logs", "self-training",
                               args.new_checkpoint_name.replace(".pth", ""))
    os.makedirs(args.logdir, exist_ok=True)
    with GracefulShutdown() as shutdown:
        return self_train_main(args, get_logger(args.logdir),
                               shutdown=shutdown)


if __name__ == "__main__":
    main()
