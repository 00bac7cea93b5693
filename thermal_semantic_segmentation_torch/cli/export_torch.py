"""Write a checkpoint in the reference's torch ``.pth`` schemas (counterpart
of the JAX ``cli/export_torch.py``).

    python -m thermal_semantic_segmentation_torch.cli.export_torch \
        --kind seg --src checkpoints/semantic_segmentation/s.pth --dst s_torch.pth
    python -m thermal_semantic_segmentation_torch.cli.export_torch \
        --kind gan --src checkpoints/g.pth --dst g_torch.pth

``--src`` is the JAX package's msgpack checkpoint or a ``.pth`` of this
package (``load_seg_checkpoint``, ``load_gan_checkpoint``). The output is
written by ``save_seg_checkpoint`` / ``save_gan_checkpoint``:
  seg:  {'epoch', 'sem_net_state_dict', 'val_loss'} (reference
        segmentation_train.py:182-190), with the self-training keys
        ``highest_mean_iu`` and ``objective_vectors`` carried through
        (self_train_main.py:119-140);
  gan:  {'epoch', 'net_g_s2t_state_dict', 'net_g_t2s_state_dict',
         'net_d_t_state_dict', 'net_d_s_state_dict'} (main.py:128-136).
It runs on the host alone: no device is used.
"""

from __future__ import annotations

import argparse


def export_seg(src: str, dst: str) -> dict:
    """``src`` -> the reference seg ``.pth`` at ``dst``; returns the keys
    written with their values."""
    from ._common import load_seg_checkpoint, save_seg_checkpoint

    state_dict, meta = load_seg_checkpoint(src)
    save_seg_checkpoint(dst, state_dict, epoch=int(meta.get("epoch", 0)),
                        val_loss=meta.get("val_loss"),
                        highest_mean_iu=meta.get("highest_mean_iu"),
                        objective_vectors=meta.get("objective_vectors"))
    return _read(dst)


def export_gan(src: str, dst: str, *, norm: str = "batch",
               num_downs=None) -> dict:
    """``src`` -> the reference GAN ``.pth`` at ``dst`` (the generators and
    discriminators it holds); ``norm`` and ``num_downs`` describe the JAX
    package's nets (``num_downs`` None: read from the checkpoint)."""
    from ..models.convert import GAN_KEYS
    from ._common import load_gan_checkpoint, save_gan_checkpoint

    ckpt = load_gan_checkpoint(src, norm=norm, num_downs=num_downs)
    nets = [{name: ckpt[key] for name, key in GAN_KEYS[kind] if key in ckpt}
            for kind in ("g", "d")]
    save_gan_checkpoint(dst, *nets, epoch=int(ckpt["epoch"]))
    return _read(dst)


def _read(path: str) -> dict:
    from ._common import _torch_load
    return _torch_load(path)


def main(argv=None):
    parser = argparse.ArgumentParser(description="export to torch .pth")
    parser.add_argument("--kind", choices=["seg", "gan"], required=True)
    parser.add_argument("--src", required=True,
                        help="checkpoint path: the JAX package's msgpack or "
                             "a .pth")
    parser.add_argument("--dst", required=True, help="output .pth path")
    parser.add_argument("--norm", default="batch",
                        help="GAN norm layer (batch/instance) of a JAX "
                             "checkpoint")
    parser.add_argument("--num_downs", type=int, default=8,
                        help="UNet depth of a JAX checkpoint's generators")
    args = parser.parse_args(argv)
    if args.kind == "seg":
        payload = export_seg(args.src, args.dst)
    else:
        payload = export_gan(args.src, args.dst, norm=args.norm,
                             num_downs=args.num_downs)
    print(f"wrote {args.dst} with keys {sorted(payload)}")


if __name__ == "__main__":
    main()
