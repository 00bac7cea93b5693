"""Supervised segmentation training entry point (counterpart of the JAX
``cli/segmentation_train.py``).

The reference recipe: an 80/20 seed-42 split of the source dataset, Adam and
a plateau scheduler on the source-val loss, CE with ``ignore_index``, each
epoch's mIoU on source val and on the Freiburg IR test split, and the best
val loss's weights saved in the reference ``.pth`` schema:

    python -m thermal_semantic_segmentation_torch.cli.segmentation_train \\
        -dataset freiburg_ir -epochs 2 [--device cpu]

``train_epochs`` is the epoch loop; it takes its loaders, so a caller can
drive it with data of its own. Validation goes through ``seg_validate``, so
the CUDA ``upsample_argmax`` kernel gives every validation batch's
predictions.

Under ``--distributed`` (one process per card; ``torchrun`` or the
``--coordinator_address`` flags) each rank trains on its ``host_shard`` of
every epoch under ``DistributedDataParallel`` (``-bn_mode sync`` or
``per_replica``, ``train/seg.py``), validates the whole split itself (its
shard of it, the scores reduced over the ranks, with ``--data_parallel
true``), and process 0 writes the checkpoints. Without ``--distributed``,
``--data_parallel true`` splits each validation batch over the process's
cards (``parallel/mesh.LocalMesh``) when ``-val_batch_size`` divides
over them. A SIGTERM or SIGINT on any rank stops
every rank after the step in flight, and process 0 writes
``preempt_<-new_checkpoint_name>``, which ``-load_model true`` resumes
(the interrupted epoch is redone):

    torchrun --nproc_per_node 4 -m \
        thermal_semantic_segmentation_torch.cli.segmentation_train \
        -dataset freiburg_ir --distributed true
"""

from __future__ import annotations

import os
import time

import torch
import torch.distributed as dist

from ..core.schedule import ReduceLROnPlateau
from ..data import transforms as T
from ..data.device_pipeline import device_prefetch
from ..data.freiburg import FreiburgTest
from ..data.loader import DataLoader, split_indices
from ..device import resolve_device
from ..eval.validate import seg_validate
from ..parallel import mesh as pmesh
from ..parallel.mesh import host_shard, make_mesh, process_index
from ..train.seg import (build_seg_eval_step, create_seg_state,
                         make_seg_train_step)
from ..utils.logging import get_logger
from ..utils.meters import AverageMeter, ProgressMeter
from ..utils.observability import MetricsLogger
from ..utils.preempt import GracefulShutdown, NullShutdown, cross_process
from ._common import (apply_model_meta, build_deeplab, build_seg_dataset,
                      load_seg_checkpoint, primary_host, resolve_wire,
                      save_seg_checkpoint, train_transform, val_transform)
from .options import seg_parse


def make_loaders(args, source_dataset, target_val_dataset,
                 val_source=None):
    """(train, source val, target val) loaders: the seed-42 80/20 split;
    train shuffled with ``drop_last``, each process on its ``host_shard``
    (in lockstep); source val through ``val_source``, by default the train
    dataset, so through its augmenting transform, as the reference does
    (segmentation_train.py:143); the target test split in order. Every
    process validates the whole of both splits, or with ``--data_parallel``
    its shard of each."""
    train_idx, val_idx = split_indices(len(source_dataset), 0.2, seed=42)
    if val_source is None:
        val_source = source_dataset
    train_loader = DataLoader(source_dataset, args.batch_size, shuffle=True,
                              indices=train_idx, drop_last=True,
                              seed=args.seed, shard=host_shard())
    val_shard = host_shard() if args.data_parallel else None
    val_loader = DataLoader(val_source, args.val_batch_size,
                            shuffle=True, indices=val_idx, drop_last=False,
                            seed=args.seed + 1, shard=val_shard,
                            shard_lockstep=False)
    target_val_loader = DataLoader(target_val_dataset, args.val_batch_size,
                                   shuffle=False, drop_last=False,
                                   seed=args.seed + 2, shard=val_shard,
                                   shard_lockstep=False)
    return train_loader, val_loader, target_val_loader


def train_epochs(args, logger, train_loader, val_loader, target_val_loader,
                 shutdown=None):
    """Train ``args.epochs`` epochs (from the checkpoint's epoch + 1 with
    ``-load_model``), validating after each. Returns (state, history):
    one dict per epoch with its train images, seconds (up to a device
    synchronisation) and step losses, its source-val loss, the lr scale
    the scheduler set and the scheduler's step count, and whether the
    checkpoint was saved.

    In a process group (``--distributed``) the step runs under DDP on
    ``make_mesh``'s ranks. ``shutdown`` (a ``GracefulShutdown``), polled
    before every step and agreed across the ranks: once requested, the
    loop stops, ``preempt_<-new_checkpoint_name>`` is written with the
    previous epoch's number (resuming redoes this one), and the last
    record has ``preempted`` set and no validation."""
    device = resolve_device(args.device or None)
    shutdown = cross_process(shutdown if shutdown is not None
                             else NullShutdown())
    mesh = (make_mesh(device, batch_size=args.batch_size)
            if dist.is_initialized() else None)
    reduce_val = getattr(val_loader, "shard", None) is not None
    val_mesh = None
    if args.data_parallel and pmesh.process_count() == 1:
        cards = pmesh.default_devices()
        if args.val_batch_size % len(cards) == 0:
            val_mesh = pmesh.local_data_mesh(devices=cards)
        else:
            print(f"val_batch_size {args.val_batch_size} does not divide "
                  f"the {len(cards)}-device mesh; validation stays "
                  f"single-device")
    restart_epoch = 0
    lowest_val_loss = float("inf")
    if args.load_model:
        path = os.path.join(args.model_root_path, args.checkpoint_name)
        state_dict, meta = load_seg_checkpoint(path)
        apply_model_meta(args, meta)   # the checkpoint's architecture wins
        restart_epoch = int(meta.get("epoch", -1)) + 1
        if "val_loss" in meta:
            lowest_val_loss = float(meta["val_loss"])
        logger.info("loaded %s, resume from epoch %d", path, restart_epoch)
        model = build_deeplab(args, device=device)
        model.load_state_dict(state_dict, strict=True)
        del state_dict
    else:
        model = build_deeplab(args, device=device)

    state = create_seg_state(model, learning_rate=args.lr,
                             lr_groups=args.lr_groups, device=device)
    train_step = make_seg_train_step(
        ignore_index=args.ignore_index, label_hw=(256, 512), base_lr=args.lr,
        dropout_seed=args.seed, device_augment=args.device_aug,
        bn_mode=args.bn_mode, mesh=mesh, grad_accum=args.grad_accum,
        bf16=args.bf16, device=device)
    eval_step = build_seg_eval_step(num_classes=args.num_classes,
                                    ignore_index=args.ignore_index,
                                    device=device, bf16=args.bf16)
    scheduler = ReduceLROnPlateau(mode="min")

    os.makedirs(args.model_root_path, exist_ok=True)
    metrics_log = MetricsLogger(os.path.join(args.logdir, "metrics.jsonl"))
    wire = resolve_wire(args)
    history = []
    for epoch in range(restart_epoch, restart_epoch + args.epochs):
        print(f"--------START TRAINING [EPOCH: {epoch}]--------")
        train_loss = AverageMeter("train_loss", ":3.4f")
        images_per_sec = AverageMeter("img/s", ":5.1f")
        progress = ProgressMeter(len(train_loader),
                                 [train_loss, images_per_sec],
                                 prefix=f"Epoch: [{epoch}]")
        start = last = time.perf_counter()
        n_images, losses = 0, []
        for i, batch in enumerate(device_prefetch(train_loader, device,
                                                  wire=wire)):
            if args.max_steps and i >= args.max_steps:
                break
            if shutdown.requested:
                break
            loss = train_step(state, batch["image"], batch["label"])
            losses.append(loss)
            bs = batch["image"].shape[0]
            n_images += bs
            if i % args.log_interval == 0:
                loss_val = float(loss)  # host sync only at log points
                now = time.perf_counter()
                train_loss.update(loss_val, bs)
                images_per_sec.update(
                    bs * args.log_interval / max(now - last, 1e-9))
                last = now
                progress.display(i, logger)
                metrics_log.log(state.step, {
                    "train_loss": loss_val,
                    "images_per_sec": images_per_sec.val}, epoch=epoch)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        record = {"epoch": epoch, "train_images": n_images,
                  "train_s": time.perf_counter() - start,
                  "train_losses": (torch.stack(losses).tolist() if losses
                                   else []),
                  "preempted": False}
        if shutdown.requested:
            # the grace window is short: save and leave, no validation
            name = "preempt_" + args.new_checkpoint_name
            save_seg_checkpoint(os.path.join(args.model_root_path, name),
                                state.model.state_dict(), epoch=epoch - 1,
                                val_loss=lowest_val_loss)
            wrote = (f"saved {name}" if primary_host() else
                     f"save delegated to process 0 (rank {process_index()} "
                     f"exiting)")
            msg = (f"preempted (signal {shutdown.signum}) during epoch "
                   f"{epoch}; {wrote}: resume with -load_model true "
                   f"-checkpoint_name {name}")
            print(msg); logger.info(msg)
            record["preempted"] = True
            history.append(record)
            break

        mean_iu, val_loss, class_iou = seg_validate(
            state.model, val_loader, num_classes=args.num_classes,
            ignore_index=args.ignore_index, eval_step=eval_step,
            device=device, mesh=val_mesh, reduce_processes=reduce_val,
            wire=wire)
        state.lr_scale = scheduler.step(val_loss)
        record.update(val_loss=val_loss, lr_scale=state.lr_scale,
                      scheduler_steps=scheduler.num_steps,
                      saved=val_loss < lowest_val_loss)

        if val_loss < lowest_val_loss:
            verb = ("Saving..." if primary_host()
                    else "Save delegated to process 0.")
            msg = (f"val loss reduced from {lowest_val_loss} to {val_loss}! "
                   f"{verb}")
            lowest_val_loss = val_loss
            save_seg_checkpoint(
                os.path.join(args.model_root_path, args.new_checkpoint_name),
                state.model.state_dict(), epoch=epoch,
                val_loss=lowest_val_loss)
        else:
            msg = "Model not improved."
        print(msg); logger.info(msg)
        print("mean iou score: " + str(mean_iu))
        logger.info("mean iou score: %s", mean_iu)
        for k, v in class_iou.items():
            line = f"source valid set class {k}: {v}"
            logger.info(line); print(line)

        if args.net_mode == "one_channel":
            mean_iu, _, class_iou = seg_validate(
                state.model, target_val_loader, num_classes=13,
                ignore_index=args.ignore_index, eval_step=eval_step,
                device=device, mesh=val_mesh, reduce_processes=reduce_val,
                wire=wire)
            line = "target test dataset mean iou score: " + str(mean_iu)
            logger.info(line); print(line)
            for k, v in class_iou.items():
                line = f"target set class {k}: {v}"
                logger.info(line); print(line)
        else:
            # the target test split is 1-channel IR; a 3-channel net
            # cannot take it
            line = "target test dataset skipped (net is not one_channel)"
            logger.info(line); print(line)
        history.append(record)
    return state, history


def seg_main(args, logger, shutdown=None):
    """Build the datasets and run ``train_epochs``. With ``-device_aug
    true`` the train frames keep their full size (``ToArray`` only: the
    step crops them on the device) and the source val split resizes
    (``val_transform``), as the JAX CLI does."""
    if args.device_aug:
        source_dataset = build_seg_dataset(args, T.Compose([T.ToArray()]))
        val_source = build_seg_dataset(args, val_transform())
    else:
        source_dataset = build_seg_dataset(args, train_transform())
        val_source = None
    target_val_dataset = FreiburgTest(args.freiburg_root, "test", "IR",
                                      transforms=val_transform(),
                                      with_label=True)
    logger.info("Dataset created. Train with %s_%s, validate with "
                "FreiburgTest.", source_dataset.__class__.__name__,
                args.translation_name)
    return train_epochs(args, logger,
                        *make_loaders(args, source_dataset,
                                      target_val_dataset, val_source),
                        shutdown=shutdown)


def main(argv=None):
    args = seg_parse().parse_args(argv)
    resolve_device(args.device or None)   # no card and no --device: raise
    args.logdir = os.path.join("logs",
                               args.new_checkpoint_name.replace(".pth", ""))
    os.makedirs(args.logdir, exist_ok=True)
    with GracefulShutdown() as shutdown:
        return seg_main(args, get_logger(args.logdir), shutdown=shutdown)


if __name__ == "__main__":
    main()
