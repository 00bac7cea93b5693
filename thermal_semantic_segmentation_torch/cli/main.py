"""GAN translation training entry point (counterpart of the JAX
``cli/main.py``; reference main.py / main_gan.py).

``-cycle true`` (the default) trains the CycleGAN: two U-Net-256
generators and two 70x70 PatchGANs with the cycle losses; ``-cycle false``
(``cli/main_gan.py``) the one-direction s2t GAN. ``-with_contour true``
adds the Canny contour losses; ``-sem_loss true`` the semantic-consistency
losses of two frozen sem nets, where the CUDA ``upsample_argmax`` kernel
labels each real thermal frame. With ``-sem_mode legacy`` (the default,
the reference's recipe) they are the legacy 19-class DeepLabs (RGB and
thermal) on BGR mean-subtracted [0, 255] input, their weights from a
resumed checkpoint's ``net_seg_*`` dicts, else from ``-sem_checkpoint_s``
/ ``-sem_checkpoint_t`` (a reference legacy ``.pth`` or the JAX package's
msgpack), else, as the last resort, random from ``--seed`` (which makes
the loss meaningless); with ``-sem_mode module2`` two seg-trainer
checkpoints on [0, 1] input:

    python -m thermal_semantic_segmentation_torch.cli.main \\
        -source_dataset freiburg_rgb -target_dataset freiburg_ir [--device cpu]

``gan_epochs`` is the epoch loop; it takes its loaders, so a caller can
drive it with data of its own. A checkpoint in the reference ``.pth``
schema is saved every ``-save_interval`` epochs and after the last;
``-load_model true`` resumes from ``-checkpoint_name`` (the port's
``.pth``, a reference one or the JAX package's msgpack) at its saved
epoch, with fresh Adam moments, as the JAX CLI does. A SIGTERM or SIGINT
stops the loop after the step in flight and writes
``preempt_<-new_checkpoint_name>`` with the previous epoch's number, as the
JAX CLI does (a resume from it starts at that epoch, the checkpoint's own,
as every resume here does).

With ``--distributed true`` (torchrun, or the ``--coordinator_address``
flags) each rank trains on its ``host_shard`` of both sets, the step is
the JAX step on the global batch (``train/gan.py``: synchronised
BatchNorm, the pools fed every rank's fakes), the preemption poll is
all-reduced and process 0 writes the checkpoints. ``-host_pool true`` is
refused there (``train/gan.make_gan_steps``): the JAX host pool has no
cross-process form.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch
import torch.distributed as dist

from ..data import transforms as T
from ..data.cityscapes import Cityscapes
from ..data.device_pipeline import device_prefetch
from ..data.freiburg import Freiburg
from ..data.loader import DataLoader
from ..data.simple import FlirTrain, Kitti
from ..device import resolve_device
from ..models.convert import GAN_KEYS
from ..parallel import mesh as pmesh
from ..utils.preempt import GracefulShutdown, NullShutdown, cross_process
from ..models.deeplab import create_deeplab
from ..models.factory import (deeplabv2_resnet101, deeplabv2_resnet101_thermal,
                              init_gan_net, patchgan, unet_256)
from ..ops.image_pool import ImagePool
from ..train.gan import create_gan_state, make_gan_step, make_gan_steps
from ..utils.meters import AverageMeter, ProgressMeter
from ..utils.observability import VisdomPlotter
from ._common import (load_gan_checkpoint, load_legacy_sem_state_dict,
                      load_seg_checkpoint, resolve_wire, save_gan_checkpoint)
from .options import train_parse

POOL_SIZE = 50
METERS = ("g_s2t", "g_t2s", "d_s", "d_t", "cycle_s", "cycle_t", "con_s2t",
          "con_t2s")


def _gan_transform(normalize):
    """RandomResizedCrop to 256x512, a flip, ToArray, Normalize(mean=std=
    ``normalize``): images in [-1, 1] for the default 0.5."""
    mean = tuple(normalize)
    return T.Compose([
        T.RandomResizedCrop(size=(256, 512), ratio=(1.5, 8 / 3.),
                            scale=(0.5, 1.0)),
        T.RandomHorizontalFlip(),
        T.ToArray(),
        T.Normalize(mean, mean),
    ])


def build_gan_datasets(args):
    """(source, target): Cityscapes, the Freiburg RGB train split (with
    labels, for the s2t semantic loss) or KITTI; FLIR or the Freiburg IR
    train split."""
    src_tf = _gan_transform(args.normalize)
    tgt_tf = _gan_transform((0.5,))
    if args.source_dataset == "Cityscapes":
        source = Cityscapes(args.source_root, transforms=src_tf)
    elif args.source_dataset == "freiburg_rgb":
        source = Freiburg(args.freiburg_root, "train", "RGB",
                          transforms=src_tf, with_label=True,
                          grayscale=args.grayscale,
                          native_decode=args.native_decode)
    elif args.source_dataset == "kitti":
        source = Kitti(args.kitti_root, src_tf, grayscale=args.grayscale)
    else:
        raise ValueError("source dataset does not exist.")
    if args.target_dataset == "flir":
        target = FlirTrain(args.flir_root, tgt_tf)
    elif args.target_dataset == "freiburg_ir":
        target = Freiburg(args.freiburg_root, "train", "IR",
                          transforms=tgt_tf, with_label=False,
                          native_decode=args.native_decode)
    else:
        raise ValueError("target dataset does not exist.")
    return source, target


def make_loaders(args):
    """The shuffled source and target loaders (drop_last), as the JAX CLI
    seeds them, each process on its ``host_shard``."""
    source, target = build_gan_datasets(args)
    shard = pmesh.host_shard()
    return (DataLoader(source, args.batch_size, shuffle=True, drop_last=True,
                       seed=args.seed, shard=shard),
            DataLoader(target, args.batch_size, shuffle=True, drop_last=True,
                       seed=args.seed + 1, shard=shard))


def build_gan_nets(args, device):
    """({'s2t'[, 't2s']}, {'t'[, 's']}): U-Net-256 generators of width
    ``-ngf`` and PatchGANs, weights from ``--seed``."""
    s_nc, t_nc = args.s2t_input_nc, args.t2s_input_nc
    g = {"s2t": unet_256(ngf=args.ngf, input_nc=s_nc, output_nc=t_nc)}
    d = {"t": patchgan(input_nc=t_nc)}
    if args.cycle:
        g["t2s"] = unet_256(ngf=args.ngf, input_nc=t_nc, output_nc=s_nc)
        d["s"] = patchgan(input_nc=s_nc)
    for i, net in enumerate((*g.values(), *d.values())):
        init_gan_net(net, args.seed * 4 + i, device=device)
    return g, d


def load_sem_nets(args, device, ckpt=None):
    """The frozen sem nets {'s', 't'} of ``-sem_mode``, eval mode, no
    gradient. module2: two seg checkpoints, each with its own
    architecture. legacy: the two 19-class legacy DeepLabs, each from the
    resumed GAN checkpoint ``ckpt`` when it holds the net, else from its
    ``-sem_checkpoint_*`` flag, else random from ``--seed``."""
    nets = {}
    if args.sem_mode == "legacy":
        for name, build, path in (
                ("s", deeplabv2_resnet101, args.sem_checkpoint_s),
                ("t", deeplabv2_resnet101_thermal, args.sem_checkpoint_t)):
            net = build(num_classes=19, seed=args.seed, device=device)
            key = dict(GAN_KEYS["sem"])[name]
            if ckpt is not None and key in ckpt:
                net.load_state_dict(ckpt[key], strict=True)
                print(f"loaded frozen sem net '{name}' from the resumed "
                      f"checkpoint")
            elif path:
                net.load_state_dict(load_legacy_sem_state_dict(path),
                                    strict=True)
                print(f"loaded frozen sem net '{name}' from {path}")
            else:
                print(f"frozen sem net '{name}' has random weights (no "
                      f"-sem_checkpoint_{name}): the semantic loss is "
                      f"meaningless")
            nets[name] = net.eval().requires_grad_(False)
        return nets
    for name, path in (("s", args.sem_checkpoint_s),
                       ("t", args.sem_checkpoint_t)):
        if not path:
            raise SystemExit("-sem_mode module2 requires both "
                             "-sem_checkpoint_s and -sem_checkpoint_t "
                             "(segmentation_train checkpoints)")
        state_dict, meta = load_seg_checkpoint(path)
        net = create_deeplab(args.seed, device=device,
                             num_classes=meta["num_classes"],
                             num_channels=meta["num_channels"],
                             bn_clr=meta["bn_clr"], layers=meta["layers"])
        net.load_state_dict(state_dict, strict=True)
        nets[name] = net.eval().requires_grad_(False)
        print(f"loaded frozen module2 sem net '{name}' from {path}")
    return nets


def merged_batches(src_loader, tgt_loader, with_label: bool):
    """One dict per step from a source and a target batch."""
    for s, t in zip(src_loader, tgt_loader):
        batch = {"real_s": s["image"], "real_t": t["image"]}
        if with_label and "label" in s:
            batch["label_s"] = s["label"]
        yield batch


def gan_epochs(args, src_loader, tgt_loader, shutdown=None):
    """Train ``args.num_epoch`` epochs (from the checkpoint's epoch with
    ``-load_model``). Returns (state, history): one dict per epoch with its
    steps, source images, seconds of steps (up to a device
    synchronisation), each metric's value at every step and whether it was
    preempted. ``shutdown`` (a ``GracefulShutdown``) is polled before every
    step; once requested, the loop writes ``preempt_<-new_checkpoint_name>``
    and returns."""
    device = resolve_device(args.device or None)
    # a process group (even of one rank) trains through the mesh step
    mesh = pmesh.make_mesh(device) if dist.is_initialized() else None
    shutdown = cross_process(shutdown if shutdown is not None
                             else NullShutdown())
    g_nets, d_nets = build_gan_nets(args, device)
    restart_epoch, ckpt = 0, None
    ckpt_path = os.path.join(args.gan_model_root_path, args.checkpoint_name)
    if args.load_model:
        ckpt = load_gan_checkpoint(ckpt_path)
        restart_epoch = int(ckpt["epoch"])
        for nets, keys in ((g_nets, GAN_KEYS["g"]), (d_nets, GAN_KEYS["d"])):
            for name, key in keys:
                if name in nets:
                    nets[name].load_state_dict(ckpt[key], strict=True)
        print(f"loading trained model. start from epoch {restart_epoch}.")
    sem_nets = load_sem_nets(args, device, ckpt) if args.sem_loss else None
    state = create_gan_state(g_nets=g_nets, d_nets=d_nets,
                             learning_rate=args.lr, device=device)
    step_kwargs = dict(
        cycle=args.cycle, with_contour=args.with_contour,
        grayscale_source=args.grayscale,
        canny_rgb_threshold=args.canny_rgb_threshold,
        canny_thermal_threshold=args.canny_thermal_threshold,
        sem_nets=sem_nets, sem_norm=args.sem_mode, bf16=args.bf16,
        mesh=mesh)
    if args.host_pool:
        g_step, d_step = make_gan_steps(**step_kwargs)
        pools = {k: ImagePool(POOL_SIZE, seed=args.seed + i)
                 for i, k in enumerate(d_nets)}
    else:
        step, make_pools = make_gan_step(pool_size=POOL_SIZE, **step_kwargs)
        pools = None       # sized by the first batch

    os.makedirs(args.gan_model_root_path, exist_ok=True)
    plotter = VisdomPlotter()
    loss_lines, epoch_ratio = {}, []

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    wire = resolve_wire(args, bf16_compute=args.bf16)
    history = []
    print("--------START TRAINING--------")
    for epoch in range(restart_epoch, restart_epoch + args.num_epoch):
        print(f"--------EPOCH {epoch}--------")
        meters = {k: AverageMeter(k, ":3.4f") for k in METERS + (
            ("sem_s2t", "sem_t2s") if args.sem_loss else ())}
        n_batches = min(len(src_loader), len(tgt_loader))
        progress = ProgressMeter(n_batches, list(meters.values()),
                                 prefix=f"Epoch: [{epoch}]")
        record = {"epoch": epoch, "steps": 0, "images": 0, "train_s": 0.0,
                  "preempted": False}
        rows = []
        sync()
        start = time.perf_counter()
        for i, b in enumerate(device_prefetch(
                merged_batches(src_loader, tgt_loader, args.sem_loss),
                device, wire=wire)):
            if args.max_steps and i >= args.max_steps:
                break
            if shutdown.requested:
                break
            real_s, real_t = b["real_s"], b["real_t"]
            label_s = b.get("label_s")
            if args.host_pool:
                metrics, outs = g_step(state, real_s, real_t, label_s,
                                       with_sem=args.sem_loss)
                reals = {"t": real_t, "s": real_s}
                metrics.update(d_step(
                    state, {k: reals[k] for k in d_nets},
                    {k: pools[k].query(outs[f"fake_{k}"]) for k in d_nets}))
            else:
                if pools is None:
                    pools = make_pools(
                        {"t": tuple(real_t.shape[1:]),
                         **({"s": tuple(real_s.shape[1:])}
                            if args.cycle else {})},
                        device=device, seed=args.seed)
                metrics, outs = step(state, pools, real_s, real_t, label_s,
                                     with_sem=args.sem_loss)
            rows.append(metrics)
            record["steps"] += 1
            record["images"] += real_s.shape[0]
            if i % args.log_interval == 0:      # host sync only here
                vals = {k: float(v) for k, v in metrics.items()}
                for k, v in vals.items():
                    if k in meters:
                        meters[k].update(v, real_s.shape[0])
                progress.display(i)
                if plotter.vis is not None:
                    for name, img in {"real_s": real_s, "real_t": real_t,
                                      **outs}.items():
                        plotter.images(np.asarray(
                            img[0].float().cpu()).transpose(2, 0, 1),
                            win=name, title=name)
                    for k, v in vals.items():
                        if k in meters:
                            loss_lines.setdefault(k, []).append(v)
                    epoch_ratio.append(epoch + i / max(n_batches, 1))
                    plotter.plot_loss(epoch_ratio, loss_lines)
        sync()
        record["train_s"] = time.perf_counter() - start
        record["metrics"] = {k: torch.stack([r[k] for r in rows]).tolist()
                             for k in (rows[0] if rows else {})}
        history.append(record)
        if shutdown.requested:
            name = "preempt_" + args.new_checkpoint_name
            save_gan_checkpoint(os.path.join(args.gan_model_root_path, name),
                                state.g, state.d, epoch=epoch - 1)
            print(f"[preempt] saved {name}: resume with -load_model true "
                  f"-checkpoint_name {name}", flush=True)
            record["preempted"] = True
            break

        last = epoch == restart_epoch + args.num_epoch - 1
        if last or (epoch - restart_epoch + 1) % args.save_interval == 0:
            save_gan_checkpoint(
                ckpt_path if args.new_checkpoint_name == args.checkpoint_name
                else os.path.join(args.gan_model_root_path,
                                  args.new_checkpoint_name),
                state.g, state.d, epoch=epoch)
    return state, history


def gan_main(args, shutdown=None):
    return gan_epochs(args, *make_loaders(args), shutdown=shutdown)


def main(argv=None):
    args = train_parse().parse_args(argv)
    resolve_device(args.device or None)   # no card and no --device: raise
    with GracefulShutdown() as shutdown:
        return gan_main(args, shutdown=shutdown)


if __name__ == "__main__":
    main()
