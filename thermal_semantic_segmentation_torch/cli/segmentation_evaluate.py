"""Segmentation evaluation entry point (counterpart of the JAX
``cli/segmentation_evaluate.py``).

Loads a reference-schema ``.pth`` checkpoint, scores the test split with the
confusion matrix and loss sum kept on the device, and prints mIoU, val loss
and the per-class IoUs in the reference's format:

    python -m thermal_semantic_segmentation_torch.cli.segmentation_evaluate \\
        -dataset freiburg_ir -checkpoint_name s.pth [--device cpu]

Every image is scored, the ragged tail batch at its own size, so any
``-val_batch_size`` gives the reference's batch-1 scores. Under
``--distributed`` each process scores its own slice of the set and the
confusion matrices and loss sums are summed across the processes; with
``-visualize_prediction`` every process scores the whole set instead (the
dump names would collide) and process 0 alone writes the PNGs.
``--data_parallel true`` splits each batch over the process's cards
(``parallel/mesh.LocalMesh``); the confusion matrices add up.
"""

from __future__ import annotations

import os

from ..data.loader import DataLoader, split_indices
from ..device import resolve_device
from ..eval.validate import seg_validate
from ..parallel.mesh import host_shard
from ._common import (apply_model_meta, build_deeplab, build_seg_dataset,
                      load_seg_checkpoint, maybe_data_parallel, primary_host,
                      resolve_wire, val_transform)
from .options import evaluation_parse


def seg_evaluation(args):
    device = resolve_device(args.device or None)
    print("evaluating...")
    dataset = build_seg_dataset(args, val_transform(), for_eval=True)
    shard = host_shard()
    visualize = args.visualize_prediction
    if shard is not None and visualize:
        if primary_host():     # one copy of the warning
            print("--visualize_prediction with --distributed: every process "
                  "evaluates the full set (prediction file names would "
                  "collide); process 0 writes the PNGs")
        shard = None
        if not primary_host():
            visualize = None
    if args.data_split:
        _, val_idx = split_indices(len(dataset), 0.2, seed=42)
        loader = DataLoader(dataset, args.val_batch_size, shuffle=True,
                            indices=val_idx, drop_last=False, seed=args.seed,
                            shard=shard, shard_lockstep=False)
    else:
        loader = DataLoader(dataset, args.val_batch_size, shuffle=False,
                            drop_last=False, seed=args.seed, shard=shard,
                            shard_lockstep=False)

    state_dict, meta = load_seg_checkpoint(
        os.path.join(args.model_root_path, args.checkpoint_name))
    apply_model_meta(args, meta)  # the checkpoint's architecture wins
    model = build_deeplab(args, device=device)
    model.load_state_dict(state_dict, strict=True)

    save_root = None
    if visualize:
        save_root = os.path.join(
            args.root, "predictions",
            (args.new_checkpoint_name or args.checkpoint_name).replace(
                ".pth", ""))
        if args.baseline:
            save_root = (f"baseline_predictions/apply_{args.target_domain}"
                         f"_image_on_{args.source_domain}_domain_model")
        if args.generator_type == "t2s":
            save_root = (f"predictions/t2s/"
                         f"{args.checkpoint_name.replace('.pth', '')}")

    mean_iu, avg_loss, class_iou = seg_validate(
        model, loader, num_classes=args.num_classes,
        ignore_index=args.ignore_index, visualize=visualize,
        save_root=save_root, device=device, bf16=args.bf16,
        reduce_processes=shard is not None, wire=resolve_wire(args),
        mesh=maybe_data_parallel(args, args.val_batch_size, "evaluating"))
    print("checkpoint name: " + args.checkpoint_name)
    print(f"mean iou score: [{mean_iu}]. val_loss: [{avg_loss}]")
    for k, v in class_iou.items():
        print(f"target set class {k}: {v}")
    return mean_iu, avg_loss, class_iou


def main(argv=None):
    return seg_evaluation(evaluation_parse().parse_args(argv))


if __name__ == "__main__":
    main()
