"""Class-prototype computation entry point (counterpart of the JAX
``cli/cal_prototype.py``; reference cal_prototype.py).

Folds the per-class mean features of a seg checkpoint (a reference ``.pth``
or a JAX msgpack checkpoint) over the target dataset's train frames and
saves ``{'objective_vectors': (C, 256), 'counts': (C,)}`` in the JAX
package's msgpack format, which its self-training reads, under
``<root>/prototypes/prototypes_on_<dataset>_from_<checkpoint>``:

    python -m thermal_semantic_segmentation_torch.cli.cal_prototype \\
        -checkpoint_name s.pth -dataset freiburg_ir [--device cpu]
"""

from __future__ import annotations

import os

from ..core.checkpoint import save_checkpoint
from ..data import transforms as T
from ..data.freiburg import Freiburg
from ..data.loader import DataLoader
from ..data.simple import FlirTrain
from ..device import resolve_device
from ..train.prototypes import calc_prototypes
from ._common import apply_model_meta, build_deeplab, load_seg_checkpoint
from .options import calc_proto_parse


def prototype_path(root: str, dataset: str, checkpoint_name: str) -> str:
    return os.path.join(root, "prototypes",
                        f"prototypes_on_{dataset}_from_"
                        f"{checkpoint_name.replace('.pth', '')}")


def calc_prototype(args):
    device = resolve_device(args.device or None)
    tf = T.Compose([T.Resize((512, 256)), T.ToArray()])
    if args.dataset == "flir":
        dataset = FlirTrain(args.flir_root, tf)
    elif args.dataset == "freiburg_ir":
        dataset = Freiburg(args.freiburg_root, "train", "IR", transforms=tf,
                           with_label=False)
    else:
        raise ValueError("target dataset does not exist.")
    loader = DataLoader(dataset, args.batch_size, shuffle=True,
                        drop_last=True, seed=args.seed)

    state_dict, meta = load_seg_checkpoint(
        os.path.join(args.model_root_path, args.checkpoint_name))
    apply_model_meta(args, meta)   # the checkpoint's architecture wins
    model = build_deeplab(args, device=device)
    model.load_state_dict(state_dict, strict=True)

    prototypes, counts = calc_prototypes(model, loader,
                                         num_classes=args.num_classes,
                                         epochs=args.epochs,
                                         max_steps=args.max_steps,
                                         device=device, bf16=args.bf16)
    out_path = prototype_path(args.root, args.dataset, args.checkpoint_name)
    print("saving prototypes......")
    save_checkpoint(out_path, {"objective_vectors": prototypes,
                               "counts": counts})
    print(f"saved to {out_path}")
    return prototypes, counts


def main(argv=None):
    return calc_prototype(calc_proto_parse().parse_args(argv))


if __name__ == "__main__":
    main()
