"""Offline dataset translation (counterpart of the JAX ``cli/translator.py``;
reference translator.py:15-68).

Loads a generator from a GAN checkpoint (the port's ``.pth``, a reference
one or the JAX package's msgpack), translates every frame of the dataset
at 256x512 (``Resize((512, 256))``), de-normalises with ``-denormalize``,
resizes to ``-save_image_size`` (H W) as PIL's BICUBIC does and writes each
frame to its destination, the frame's path under the translation folder
(``--native_encode true``: each batch's frames in one call to the native
C++ encoder, ``data/native_loader.py``, where it is available):

    python -m thermal_semantic_segmentation_torch.cli.translator \\
        -dataset freiburg_rgb -checkpoint_name g.pth [--device cpu]

``translate_batches`` is the batch loop; it takes its loader, so a caller
can drive it with data of its own. A ragged tail batch runs at its own
size (the JAX package pads it to keep one compiled shape). The forward,
de-normalisation and resize run on the device; PNG destinations (the
Freiburg frames) are encoded by ``data/png.py`` on writer threads, other
extensions through PIL.

``--distributed true``: each process translates its own slice of the
dataset (``host_shard``, the slices partition it) and writes its own
frames. ``--data_parallel true``: the generator is copied onto each card
of the process (``parallel/mesh.LocalMesh``) and each batch's rows are
split over the copies.
"""

from __future__ import annotations

import concurrent.futures as cf
import os
import time
from typing import Callable, Optional

import numpy as np
import torch

from ..data import png
from ..data import transforms as T
from ..data.cityscapes import Cityscapes
from ..data.device_pipeline import device_prefetch
from ..data.freiburg import Freiburg
from ..data.loader import DataLoader
from ..device import resolve_device
from ..ops.resize import resize_bicubic_8bit
from ..parallel import mesh as pmesh
from ._common import (build_generator_from_gan_checkpoint,
                      maybe_data_parallel, resolve_wire)
from .options import translation_parse

MAX_PENDING_WRITES = 4


def build_translation_dataset(args):
    tf = T.Compose([T.Resize((512, 256)), T.ToArray(),
                    T.Normalize(tuple(args.normalize), tuple(args.normalize))])
    if args.dataset == "Cityscapes":
        return Cityscapes(args.source_root, transforms=tf, train_mode=False)
    if args.dataset == "freiburg_rgb":
        return Freiburg(args.freiburg_root, "train", "RGB", transforms=tf,
                        with_label=False, grayscale=args.grayscale,
                        translation_mode=True)
    raise ValueError("dataset does not exist.")


def destination(path: str, suffix: str) -> str:
    """``path`` with ``_suffix`` before its extension (none if empty)."""
    if not suffix:
        return path
    base, ext = os.path.splitext(path)
    return f"{base}_{suffix}{ext}"


def write_frame(path: str, pixels: np.ndarray) -> None:
    """(H, W, C) uint8 -> ``path``: a gray (C = 1) or RGB PNG by
    ``data/png.py``, any other extension (JPEG) through PIL; without PIL
    that raises, naming the file."""
    frame = pixels[..., 0] if pixels.shape[-1] == 1 else pixels
    if path.lower().endswith(".png"):
        (png.write_gray_png if frame.ndim == 2 else png.write_rgb_png)(
            path, frame)
        return
    try:
        from PIL import Image
    except ImportError:
        raise RuntimeError(
            f"{path}: writing {os.path.splitext(path)[1] or 'this format'} "
            f"needs PIL, which is not installed on this host (PNG is written "
            f"without it)") from None
    Image.fromarray(frame).save(path)


def translate_batches(model, loader, *, denormalize, save_hw, suffix: str,
                      device, bf16: bool = False,
                      mark: Optional[Callable[[str], None]] = None,
                      mesh=None, wire: Optional[str] = "packed",
                      native_encode: bool = False):
    """Translate every batch of ``loader`` (dicts with an NHWC 'image' and
    the destinations 'img_path') and write the frames; the forward under
    bfloat16 autocast with ``bf16``. ``mark``, when given, is called with
    'batch' before each batch's device work is queued, then with 'forward'
    and 'resize' as its stages are. ``mesh`` (``parallel/mesh.LocalMesh``)
    splits each batch's rows over copies of the generator, one per device,
    and gathers the frames in row order. ``wire``: the batches' transfer
    (``device_prefetch``). ``native_encode``: each batch's frames, already
    at ``save_hw``, go to the native C++ encoder in one call (PNG or JPEG
    by suffix), where the library is available. Returns {'images',
    'seconds', 'encode_s'}: the frames written, the loop's seconds (every
    write finished) and the writer threads' seconds of encoding and
    writing."""
    mark = mark or (lambda stage: None)
    if native_encode:
        from ..data import native_loader as nl
        native_encode = nl.available()
    device = resolve_device(device)
    mesh = pmesh.LocalMesh.of(mesh, device)
    replicas = pmesh.replicate(mesh, model)
    denorms = {d: torch.tensor(denormalize, dtype=torch.float32,
                               device=d).reshape(1, -1, 1, 1)
               for d in set(mesh.devices)}
    encode_s = []

    def frames(net, image):
        """8-bit (N, H, W, C) frames at ``save_hw`` of one share."""
        denorm = denorms[image.device]
        with torch.inference_mode(), torch.autocast(
                image.device.type, dtype=torch.bfloat16, enabled=bf16):
            fake = net(image.permute(0, 3, 1, 2)).float()
            mark("forward")
            pixels = ((fake * denorm + denorm) * 255.0).clamp(0.0, 255.0)
            pixels = resize_bicubic_8bit(pixels.to(torch.uint8), *save_hw)
            mark("resize")
        return pixels.permute(0, 2, 3, 1).contiguous()

    def write_batch(pixels, paths):
        start = time.perf_counter()
        if native_encode:
            nl.encode_batch(paths, pixels)
        else:
            for frame, path in zip(pixels, paths):
                write_frame(path, frame)
        encode_s.append(time.perf_counter() - start)

    images, start = 0, time.perf_counter()
    futures = []
    with cf.ThreadPoolExecutor(max_workers=2) as pool:
        for batch in device_prefetch(loader, device, mesh=mesh, wire=wire):
            mark("batch")
            host = pmesh.map_shares(frames, replicas, "cpu",
                                    batch["image"]).numpy()
            paths = [destination(p, suffix) for p in batch["img_path"]]
            for p in paths:
                os.makedirs(os.path.dirname(p) or ".", exist_ok=True)
            futures.append(pool.submit(write_batch, host, paths))
            while len(futures) > MAX_PENDING_WRITES:
                futures.pop(0).result()   # raise write errors promptly
            images += host.shape[0]
        for f in futures:
            f.result()
    return {"images": images, "seconds": time.perf_counter() - start,
            "encode_s": sum(encode_s)}


def translate(args):
    device = resolve_device(args.device or None)
    # several processes partition the dataset: every frame is translated
    # once, by the process whose slice holds it
    loader = DataLoader(build_translation_dataset(args), args.batch_size,
                        shuffle=False, drop_last=False, seed=args.seed,
                        shard=pmesh.host_shard(), shard_lockstep=False)
    model, _ = build_generator_from_gan_checkpoint(
        os.path.join(args.gan_model_root_path, args.checkpoint_name),
        "s2t" if args.generator_type == "s2t" else "t2s",
        input_nc=args.input_nc, output_nc=args.output_nc, device=device)
    summary = translate_batches(
        model, loader, denormalize=args.denormalize,
        save_hw=tuple(args.save_image_size),
        suffix=args.translation_name_suffix, device=device, bf16=args.bf16,
        wire=resolve_wire(args), native_encode=args.native_encode,
        mesh=maybe_data_parallel(args, args.batch_size, "translating"))
    print("translation complete.")
    return summary


def main(argv=None):
    return translate(translation_parse().parse_args(argv))


if __name__ == "__main__":
    main()
