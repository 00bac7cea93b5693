"""Pseudo-label generation entry point (counterpart of the JAX
``cli/generate_pseudo_label.py``; reference generate_pseudo_label.py).

Labels every image of the dataset's train split with a seg checkpoint (a
reference ``.pth`` or a JAX msgpack checkpoint) and writes the files under
``<root>/pseudo_labels/<pseudo_type>/<checkpoint name without .pth>``:

    python -m thermal_semantic_segmentation_torch.cli.generate_pseudo_label \\
        -checkpoint_name s.pth -pseudo_type hard [--flip true] [--device cpu]
    python -m thermal_semantic_segmentation_torch.cli.generate_pseudo_label \\
        -checkpoint_name s.pth -pseudo_type soft --soft true [--device cpu]

Every image is labelled, the ragged tail batch at its own size.
"""

from __future__ import annotations

import os

from ..data.loader import DataLoader
from ..device import resolve_device
from ..train.pseudo import generate_pseudo_labels
from ._common import (apply_model_meta, build_deeplab, build_seg_dataset,
                      load_seg_checkpoint, val_transform)
from .options import pseudo_generation_parse


def main(argv=None):
    args = pseudo_generation_parse().parse_args(argv)
    device = resolve_device(args.device or None)
    args.net_mode = "one_channel"
    args.num_classes = 13

    state_dict, meta = load_seg_checkpoint(
        os.path.join(args.model_root_path, args.checkpoint_name))
    apply_model_meta(args, meta)   # the checkpoint's architecture wins
    model = build_deeplab(args, device=device)
    model.load_state_dict(state_dict, strict=True)

    dataset = build_seg_dataset(args, val_transform())
    loader = DataLoader(dataset, args.batch_size, shuffle=False,
                        drop_last=False, seed=args.seed)
    save_path = os.path.join(args.root, "pseudo_labels", args.pseudo_type,
                             args.checkpoint_name.replace(".pth", ""))
    n = generate_pseudo_labels(model, loader, save_path=save_path,
                               soft=args.soft, flip=args.flip,
                               max_steps=args.max_steps, device=device,
                               bf16=args.bf16)
    print(f"wrote pseudo labels for {n} images to {save_path}")
    return n


if __name__ == "__main__":
    main()
