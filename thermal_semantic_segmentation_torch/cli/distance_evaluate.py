"""Translation-distance evaluation entry point (counterpart of the JAX
``cli/distance_evaluate.py``; reference distance_evaluate.py).

The L1 distance and SSIM between the Freiburg train frames and their
translations (the translator's output under ``-checkpoint_name`` minus
``.pth``) over the seed-42 20% split, and with ``--per_class true`` the L1
of each segmentation class:

    python -m thermal_semantic_segmentation_torch.cli.distance_evaluate \\
        -checkpoint_name freiburg_rgb2ir.pth [--per_class true] [--device cpu]

The batches are shuffled and the last partial one dropped, as the
reference does; the batch is clamped to the split, so a large
``-batch_size`` never drops every pair. Under ``--distributed`` each
process scores its own slice of the split and the sums reduce across the
processes; the batch is then clamped to the smallest slice.
"""

from __future__ import annotations

from ..data.loader import DataLoader, split_indices
from ..data.simple import DistanceDataset
from ..device import resolve_device
from ..eval.distance import evaluate_distance
from ..eval.metrics import FREIBURG_CLASS_NAMES
from ..parallel.mesh import host_shard
from ._common import resolve_wire
from .options import str2bool, translation_parse


def distance_parse():
    """``translation_parse`` plus ``--per_class`` and ``--num_classes``."""
    parser = translation_parse()
    parser.add_argument("--per_class", type=str2bool, default=False,
                        help="also report the mean L1 of each segmentation "
                             "class (reads the label list beside the data "
                             "list): a global L1 cannot see a rare class "
                             "translated into another class's intensity "
                             "range.")
    parser.add_argument("--num_classes", type=int, default=13)
    parser.data_parallel = False   # the JAX CLI reads it nowhere
    return parser


def main(argv=None):
    args = distance_parse().parse_args(argv)
    device = resolve_device(args.device or None)
    name = args.checkpoint_name.replace(".pth", "")
    dataset = DistanceDataset(args.freiburg_root, translate_name=name,
                              with_label=args.per_class)
    _, val_idx = split_indices(len(dataset), 0.2, seed=42)
    shard = host_shard()
    # the smallest slice (floor(n / processes)), not the split: drop_last
    # with a larger batch would drop every pair of some process
    n_local = len(val_idx) if shard is None else len(val_idx) // shard[1]
    loader = DataLoader(dataset, min(args.batch_size, max(n_local, 1)),
                        shuffle=True, indices=val_idx, drop_last=True,
                        shard=shard, shard_lockstep=False)
    print("Model: " + name)
    # SSIM and L1 run in float32 whatever --bf16 says: never bf16 the wire
    wire = resolve_wire(args, bf16_compute=False)
    if args.per_class:
        avg_l1, avg_ssim, per_class = evaluate_distance(
            loader, num_classes=args.num_classes, device=device,
            reduce_processes=shard is not None, wire=wire)
        # the eval protocol's class names without their "IoU " prefix;
        # index 12 is the ignore class
        names = [n.removeprefix("IoU ") for n in FREIBURG_CLASS_NAMES]
        names += ["ignore"] * max(0, args.num_classes - len(names))
        for k, v in enumerate(per_class):
            print(f"translation per-class L1 "
                  f"{names[k] if k < len(names) else k}: {v}")
    else:
        avg_l1, avg_ssim = evaluate_distance(
            loader, device=device, reduce_processes=shard is not None,
            wire=wire)
    print("L1 distance: " + str(avg_l1))
    print("SSIM score: " + str(avg_ssim))
    return avg_l1, avg_ssim


if __name__ == "__main__":
    main()
