"""Pseudo-label generation (counterpart of the JAX ``train/pseudo.py``;
reference generate_pseudo_label.py:60-96).

Device side, per batch: an eval-mode forward, then
- soft: the float32 softmax of the stride-8 logits;
- hard: (confidence, class) of each stride-8 logit vector, from the CUDA
  ``upsample_argmax`` kernel at the logits' own size;
- hard + flip: the softmax of the image and of its mirror image, each
  resized to the input's size, the second mirrored back, averaged, then
  max and argmax (a resize of probabilities, not of logits, so
  ``F.interpolate`` and not the kernel).
Host side, the files stream through a thread pool, so disk writes overlap
the next batch's forward. A ragged tail batch runs at its own size: in eval
mode each image's output does not depend on its batch, so the files equal
the JAX package's, whose tail is padded.
"""

from __future__ import annotations

import concurrent.futures as cf
import os

import numpy as np
import torch

from ..data.device_pipeline import device_prefetch
from ..data.palette import freiburg_palette
from ..data.png import write_gray_png, write_palette_png
from ..device import resolve_device
from ..kernels.upsample_argmax import upsample_argmax
from ..ops.resize import resize_bilinear
from ..parallel import mesh as pmesh
from .seg import forward_nhwc, frozen_inference


def make_pseudo_fns(model, *, bf16: bool = False):
    """(soft_fn, hard_fn, hard_flip_fn) of (N, H, W, C) images on the
    model's device: ``soft_fn`` gives (N, h, w, classes) probabilities at
    stride 8; ``hard_fn`` (conf float32, pred int32) at stride 8;
    ``hard_flip_fn`` (conf, pred) at the input's (H, W)."""

    def probs_of(images):
        logits = forward_nhwc(model, images, bf16=bf16)["out"]
        return torch.softmax(logits, dim=-1)

    def soft_fn(images):
        with frozen_inference(model):
            return probs_of(images)

    def hard_fn(images):
        with frozen_inference(model):
            logits = forward_nhwc(model, images, bf16=bf16)["out"]
            pred, conf = upsample_argmax(logits, *logits.shape[1:3])
        return conf, pred

    def hard_flip_fn(images):
        h, w = images.shape[1:3]
        with frozen_inference(model):
            # NHWC: dim 2 is W. Resize first, then mirror back (the other
            # order is not bit-equal to the JAX package's)
            probs = resize_bilinear(probs_of(images), h, w)
            probs_f = resize_bilinear(probs_of(torch.flip(images, (2,))),
                                      h, w)
            avg = (probs + torch.flip(probs_f, (2,))) / 2.0
            conf, pred = avg.max(dim=-1)
        return conf, pred.to(torch.int32)

    return soft_fn, hard_fn, hard_flip_fn


def write_soft(save_path: str, name: str, probs: np.ndarray) -> None:
    """(h, w, C) probabilities -> ``name.npy``, channel-first (C, h, w)
    float32, the reference's file format."""
    np.save(os.path.join(save_path, name.replace(".png", ".npy")),
            probs.transpose(2, 0, 1))


def write_hard(save_path: str, name: str, pseudo: np.ndarray,
               conf: np.ndarray, palette) -> None:
    """Class ids -> ``name`` (8-bit grayscale PNG) and ``name_color.png``
    (8-bit palette PNG); confidences -> ``name_conf.npy`` (float16)."""
    ids = pseudo.astype(np.uint8)
    write_gray_png(os.path.join(save_path, name), ids)
    write_palette_png(os.path.join(save_path, name[:-4] + "_color.png"),
                      ids, palette)
    np.save(os.path.join(save_path, name.replace(".png", "_conf.npy")),
            conf.astype(np.float16))


def write_hard_native(pool, save_path: str, names, pseudo: np.ndarray,
                      conf: np.ndarray, palette) -> list:
    """``write_hard``'s files for a batch, the PNGs by the native C++
    encoder (one call for the ids, one for the coloured maps) on ``pool``.
    Returns the futures."""
    from ..data import native_loader as nl
    base = [os.path.join(save_path, n) for n in names]
    ids = pseudo.astype(np.uint8)
    pal = np.asarray(palette, np.uint8).reshape(-1, 3)
    return [pool.submit(nl.encode_batch, base, ids),
            pool.submit(nl.encode_pal8_batch,
                        [b[:-4] + "_color.png" for b in base], ids, pal)] + [
        pool.submit(np.save, b.replace(".png", "_conf.npy"),
                    conf[k].astype(np.float16)) for k, b in enumerate(base)]


def generate_pseudo_labels(model, loader, *, save_path: str,
                           soft: bool = False, flip: bool = False,
                           max_steps: int = 0, writer_threads: int = 8,
                           native_encode: bool = False,
                           wire: str | None = "packed", mesh=None,
                           device=None, bf16: bool = False) -> int:
    """Run inference over ``loader`` and write the pseudo-label files of
    every image under ``save_path``; returns the number of images.

    ``model`` lives on ``device`` (default: the CUDA device; raises without
    one). ``loader`` yields dicts of a numpy ``image`` (N, H, W, C) and an
    ``img_path`` list. Soft: ``write_soft``; hard (with ``flip``, the
    mirrored-average labels at input size): ``write_hard``. Every write's
    result is taken, so a failed write fails the run. ``mesh``
    (``parallel/mesh.LocalMesh``, ``--data_parallel``): the model is
    copied once onto each of its devices, each batch's rows are split over
    the copies and the writers get their results in row order.
    ``native_encode``: each batch's two PNGs a file go through the native
    C++ encoder in two calls (``data/native_loader.py``), where the library
    is available; else the Python writers. ``wire``: the batches' transfer
    (``device_prefetch``).
    """
    if native_encode:
        from ..data import native_loader as nl
        native_encode = nl.available()
    device = resolve_device(device)
    os.makedirs(save_path, exist_ok=True)
    mesh = pmesh.LocalMesh.of(mesh, device)
    fns = [make_pseudo_fns(m, bf16=bf16)
           for m in pmesh.replicate(mesh, model)]

    def run(which, images):
        """fns[k][which] on each replica's share, as numpy arrays in row
        order."""
        out = pmesh.map_shares(lambda f, x: f[which](x), fns, "cpu", images)
        if isinstance(out, tuple):
            return tuple(o.numpy() for o in out)
        return out.numpy()

    palette = freiburg_palette()
    # labels, if the dataset has them, stay on the host
    batches = ({"image": b["image"], "img_path": b["img_path"]}
               for b in loader)
    n_written = 0
    with cf.ThreadPoolExecutor(max_workers=writer_threads) as pool:
        futures = []
        for i, batch in enumerate(device_prefetch(batches, device,
                                                  mesh=mesh, wire=wire)):
            if max_steps and i >= max_steps:
                break
            images = batch["image"]
            names = [os.path.basename(n) for n in batch["img_path"]]
            if soft:
                probs = run(0, images)
                futures += [pool.submit(write_soft, save_path, name, probs[k])
                            for k, name in enumerate(names)]
            elif native_encode:
                conf, pseudo = run(2 if flip else 1, images)
                futures += write_hard_native(pool, save_path, names, pseudo,
                                             conf, palette)
            else:
                conf, pseudo = run(2 if flip else 1, images)
                futures += [pool.submit(write_hard, save_path, name,
                                        pseudo[k], conf[k], palette)
                            for k, name in enumerate(names)]
            n_written += len(names)
            if i % 100 == 0:
                print(f"pseudo label generation: [{i}/{len(loader)}]")
        for f in futures:
            f.result()
    return n_written
