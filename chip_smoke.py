"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure ends the run with a non-zero exit and no result line):
  1. device: a CUDA card must be present; prints its name and power limit;
  2. build: compiles every kernel under csrc/ with nvcc (in parallel);
  3. kernels: each kernel against its plain PyTorch version on the card, at
     the serving shape, at the pseudo-label and prototype shapes (the
     logits' own size) and at the shapes that exercise its tiling (ragged
     edges, downsampling, one output row or column, a runtime class count,
     a strided view), with its timings, its bound, the timing floor of a
     one-element launch and its SASS counts;
  4. slice: the full-width DeepLabV2-ResNet101 seg server (random weights
     from a seed, loaded through the checkpoint path a user takes) answers
     requests from several threads, and the kernels' launch counts show the
     requests went through them;
  5. eval: the same model, loaded through the eval CLI's checkpoint path,
     scores seeded images with the loader and ``seg_validate`` (a ragged
     tail batch included); its confusion matrix and val_loss are held
     against the plain path and a float64 recomputation, and the kernels'
     launch counts show every batch went through them;
  6. train: the train CLI's epoch loop, from a reference .pth loaded with
     -load_model, trains the same model for two epochs on seeded images
     (the second resuming from the checkpoint the first saved) and
     validates after each, the kernels' launch counts showing every
     validation batch went through them; checks finite losses, a loss that
     falls on a repeated batch, the checkpoint round trip, the plateau
     scheduler's steps, and one train step of a tiny model on the card
     against the CPU; prints images/s (float32, and bfloat16 autocast),
     peak memory and a per-stage step breakdown;
  7. pseudo: the same model, loaded through the pseudo-label CLI's
     checkpoint path, writes hard, soft and hard+flip pseudo-labels of
     seeded images (a ragged tail batch included) through
     ``generate_pseudo_labels``; the ids read back from its PNGs and its
     confidences are held to the plain version (flip: a float64
     recomputation), the soft maps to a float64 softmax, and the kernel's
     launch count to the hard batches; prints images/s per mode and a
     per-stage batch breakdown;
  8. prototypes: the same model folds class prototypes of seeded images at
     batch 64 through ``calc_prototypes``, held to a float64 recomputation
     from the same features and the kernel's classes; the prototype file
     round trip; prints images/s and the masked-means and fold times.
The last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

H100_BYTES_PER_S = 3.35e12      # HBM3, H100 SXM data sheet
H100_F32_FLOPS = 67e12          # float32 outside the tensor cores

SERVE_SHAPE = (8, 33, 65, 13)   # stride-8 logits of a batch-8 256x512 request
SERVE_OUT = (256, 512)
# the pseudo-label (batch 4) and prototype (batch 64) launches: the kernel at
# the logits' own size gives their argmax and confidence
IDENTITY_SHAPES = [(4, 33, 65, 13), (64, 33, 65, 13)]
# (shape, out_hw, strided): "strided" holds the logits as NCHW-contiguous
# memory viewed as NHWC, so the kernel reads them through general strides
PARITY_CASES = [
    (SERVE_SHAPE, SERVE_OUT, False),
    *[(s, s[1:3], False) for s in IDENTITY_SHAPES],
    ((3, 9, 17, 13), (61, 127), False),
    ((2, 33, 65, 13), (250, 509), False),    # ragged row and column tiles
    ((1, 40, 70, 13), (17, 31), False),      # downsampling
    ((2, 9, 17, 13), (1, 128), False),       # one output row
    ((2, 9, 17, 13), (64, 1), False),        # one output column
    ((2, 9, 17, 19), (64, 128), False),      # runtime class count
    ((2, 33, 65, 13), (256, 512), True),
]
TIE_GAP = 1e-5
CONF_RTOL, CONF_ATOL = 1e-4, 1e-5
EVAL_IMAGES, EVAL_BATCH = 20, 8      # batches of 8, 8 and 4
NUM_CLASSES, IGNORE = 13, 12
LOSS_RTOL = 1e-5
# 96 source images split 77 / 19: 9 train steps of 8 (drop_last) and val
# batches of 8, 8, 3; 20 target images (8, 8, 4)
TRAIN_SOURCE, TRAIN_TARGET, TRAIN_BATCH = 96, 20, 8
TRAIN_LR = 1e-4                      # the train CLI's default -lr
REPEAT_STEPS = 10
PARITY_HW = (64, 128)                # card-vs-CPU step: layers 1,1,1,1
PSEUDO_IMAGES, PSEUDO_BATCH = 22, 4  # batches of 4 x 5 and a tail of 2
PROTO_IMAGES, PROTO_BATCH = 128, 64  # the prototype CLI's default batch
SOFT_SUM_ATOL = 1e-5
PROTO_RTOL = 1e-5


def fail(msg: str) -> None:
    print(f"FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def phase_device():
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a "
             "CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else \
        f"nvidia-smi failed: {smi.stderr.strip()}"
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} cudnn "
          f"{torch.backends.cudnn.version()} python {sys.version.split()[0]}",
          flush=True)
    return card


def phase_build():
    from thermal_semantic_segmentation_torch.kernels import build
    t0 = time.perf_counter()
    logs = build.build_all()
    secs = time.perf_counter() - t0
    for name, log in logs.items():
        print(f"nvcc {name}:\n{log.strip()}", flush=True)
    print(f"build: {sorted(logs)} in {secs:.2f} s", flush=True)


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median device time of one call, by CUDA events. A sleep kernel keeps
    the card busy while the host enqueues the call, so the events bracket
    the device work and not the host's launch overhead. The inputs stay
    warm in L2 between calls, as the server's logits are when its kernel
    reads them right after the forward that wrote them."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def tempfile_dir():
    """A temporary directory under the kernels' build directory (the
    checkout's own, gitignored), removed when its block ends."""
    import tempfile

    from thermal_semantic_segmentation_torch.kernels import build
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    return tempfile.TemporaryDirectory(dir=build.BUILD_DIR)


def upsample_argmax_bound(shape, out_hw):
    """(bound_ms, bound_by): each input byte read once and each output byte
    written once over HBM bandwidth, against the float32 operations of the
    function over the float32 peak. Operations per class: a separable
    upsample (3 per lerp, rows at (out_h, w) then columns at (out_h, out_w)),
    1 argmax compare and 4 softmax (max, subtract, exp, add)."""
    n, h, w, c = shape
    oh, ow = out_hw
    bytes_moved = n * h * w * c * 4 + n * oh * ow * (4 + 4)
    ops = n * c * (3 * oh * w + 3 * oh * ow + 5 * oh * ow)
    t_bytes = bytes_moved / H100_BYTES_PER_S * 1e3
    t_ops = ops / H100_F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def sass_counts(library: str, kernel: str) -> dict:
    """Static SASS counts of the kernels in ``library`` whose mangled name
    holds ``kernel``, from ``cuobjdump -sass``: all instructions, MUFU
    (special-function unit) ones, and those after the first block barrier
    (in a staged kernel, the straight-line per-thread compute)."""
    import os
    import re

    from thermal_semantic_segmentation_torch.kernels import build
    tool = os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")
    out = subprocess.run([tool, "-sass", library], capture_output=True,
                         text=True, timeout=120, check=True).stdout
    counts = {}
    for part in out.split("Function : ")[1:]:
        name = part.split(None, 1)[0]
        if kernel not in name:
            continue
        ops = [re.sub(r"^@!?P\w+\s+", "", m) for m in
               re.findall(r"/\*[0-9a-f]{4,}\*/\s+([^;]*);", part)]
        ops = [op for op in ops if not op.startswith("NOP")]
        bar = next((i for i, op in enumerate(ops)
                    if op.startswith("BAR.SYNC")), -1)
        counts[name] = {
            "instructions": len(ops),
            "mufu": sum(op.startswith("MUFU") for op in ops),
            "after_barrier": len(ops) - bar - 1,
            "mufu_after_barrier": sum(op.startswith("MUFU")
                                      for op in ops[bar + 1:]),
        }
    return counts


def phase_kernels():
    import torch
    import torch.nn.functional as F

    from thermal_semantic_segmentation_torch.kernels import build
    from thermal_semantic_segmentation_torch.kernels.upsample_argmax import (
        launch_plan, upsample_argmax, upsample_argmax_reference)
    from thermal_semantic_segmentation_torch.ops.resize import upsample_logits

    gen = torch.Generator().manual_seed(0)
    max_err = 0.0
    for shape, (oh, ow), strided in PARITY_CASES:
        x = torch.randn(shape, generator=gen).cuda()
        if strided:
            x = x.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
        pred, conf = upsample_argmax(x, oh, ow)
        torch.cuda.synchronize()
        want_pred, want_conf = upsample_argmax_reference(x, oh, ow)
        top2 = upsample_logits(x, oh, ow).topk(2, dim=-1).values
        decided = (top2[..., 0] - top2[..., 1]) > TIE_GAP
        wrong = int(((pred != want_pred) & decided).sum())
        err = float((conf - want_conf).abs().max())
        plan = launch_plan(shape[0], shape[2], shape[3], oh, ow)
        print(f"upsample_argmax {shape}->{(oh, ow)}"
              f"{' strided' if strided else ''} {plan}: pred mismatches "
              f"outside near-ties {wrong} (near-ties "
              f"{int((~decided).sum())}), conf max abs err {err:.3g}",
              flush=True)
        if wrong:
            fail(f"upsample_argmax pred disagrees at {wrong} pixels")
        if not torch.allclose(conf, want_conf, rtol=CONF_RTOL, atol=CONF_ATOL):
            fail(f"upsample_argmax conf outside rtol {CONF_RTOL} atol "
                 f"{CONF_ATOL}: max abs err {err}")
        max_err = max(max_err, err)

    x = torch.randn(SERVE_SHAPE, generator=gen).cuda()
    x_nchw = x.permute(0, 3, 1, 2)   # channels_last NCHW view, no copy

    def library():
        up = F.interpolate(x_nchw, size=SERVE_OUT, mode="bilinear",
                           align_corners=True)
        return torch.softmax(up, dim=1).max(dim=1)

    kernel_ms = time_ms(lambda: upsample_argmax(x, *SERVE_OUT))
    plain_ms = time_ms(lambda: upsample_argmax_reference(x, *SERVE_OUT))
    library_ms = time_ms(library)
    # what time_ms reads for a one-element kernel: its floor for any launch
    floor_ms = time_ms(lambda: x[0, 0, 0].add_(0))
    bound_ms, bound_by = upsample_argmax_bound(SERVE_SHAPE, SERVE_OUT)
    print(f"upsample_argmax {SERVE_SHAPE}->{SERVE_OUT}: kernel {kernel_ms} ms "
          f"(bound_share {bound_ms / kernel_ms:.4f}), plain {plain_ms} ms "
          f"(bound_share {bound_ms / plain_ms:.4f}), library {library_ms} ms "
          f"(bound_share {bound_ms / library_ms:.4f}), bound {bound_ms} ms "
          f"({bound_by}), one-element launch {floor_ms} ms", flush=True)
    try:
        sass = json.dumps(sass_counts(
            str(build.library_path("upsample_argmax")),
            "upsample_argmax_kernel"))
    except (OSError, subprocess.SubprocessError) as e:
        sass = f"not measured ({e!r})"
    print(f"sass upsample_argmax: {sass}", flush=True)

    # the pseudo-label and prototype shapes: out_hw == in_hw, where the
    # library call computing the same function is softmax().max()
    identity = []
    for shape in IDENTITY_SHAPES:
        y = torch.randn(shape, generator=gen).cuda()
        oh, ow = shape[1:3]
        k_ms = time_ms(lambda: upsample_argmax(y, oh, ow))
        p_ms = time_ms(lambda: upsample_argmax_reference(y, oh, ow))
        l_ms = time_ms(lambda: torch.softmax(y, dim=-1).max(dim=-1))
        b_ms, b_by = upsample_argmax_bound(shape, (oh, ow))
        print(f"upsample_argmax {shape}->{(oh, ow)}: kernel {k_ms} ms "
              f"(bound_share {b_ms / k_ms:.4f}), plain {p_ms} ms, library "
              f"softmax().max() {l_ms} ms, bound {b_ms} ms ({b_by})",
              flush=True)
        identity.append({"shape": f"{shape}->{(oh, ow)}", "ms": k_ms,
                         "plain_ms": p_ms, "library_ms": l_ms,
                         "bound_ms": b_ms, "bound_by": b_by})
    return [{
        "name": "upsample_argmax", "route": "cuda",
        "source": "thermal_semantic_segmentation_torch/csrc/upsample_argmax.cu",
        "replaces": "thermal_semantic_segmentation_tpu/ops/pallas_kernels.py:64",
        "shape": f"{SERVE_SHAPE}->{SERVE_OUT}", "launches": None,
        "max_abs_err": max_err, "ms": kernel_ms, "kernel_ms": kernel_ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": library_ms, "identity_shapes": identity,
    }]


def phase_slice(card: str) -> dict:
    """Drive the seg server end to end at full width; returns the kernels'
    launch counts from this run."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    import torch

    from thermal_semantic_segmentation_torch.cli.serve import (
        build_seg_server, serve_parse)
    from thermal_semantic_segmentation_torch.kernels.upsample_argmax import (
        upsample_argmax, upsample_argmax_reference)
    from thermal_semantic_segmentation_torch.models.deeplab import (
        create_deeplab)
    from thermal_semantic_segmentation_torch.ops.resize import upsample_logits

    hw, n_requests, n_threads = SERVE_OUT, 24, 4
    # ResNet-101 layers=(3, 4, 23, 3), 1 channel, 13 classes, module2 head:
    # random weights from a seed, saved in the reference .pth schema and
    # loaded back through the CLI's checkpoint path
    with tempfile_dir() as root:
        ref_model = create_deeplab(0)
        torch.save({"epoch": 0, "sem_net_state_dict": ref_model.state_dict()},
                   f"{root}/smoke.pth")
        del ref_model
        args = serve_parse().parse_args(
            ["-checkpoint_name", "smoke.pth", "--model_root_path", root,
             "-batch_size", "8", "--max_wait_ms", "20"])

        upsample_argmax.launches = 0      # counts from the main path only
        t0 = time.perf_counter()
        server = build_seg_server(args)
        server.warmup()
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        server.start()
        rng = np.random.default_rng(0)
        images = rng.uniform(0, 1, (n_requests, *hw, 1)).astype(np.float32)

        def client(tid):
            mine = range(tid, n_requests, n_threads)
            waiters = [(i, server.submit(images[i])) for i in mine]
            return [(i, w.get(timeout=600)) for i, w in waiters]

        try:
            t0 = time.perf_counter()
            with ThreadPoolExecutor(n_threads) as pool:
                answers = dict(a for part in pool.map(client, range(n_threads))
                               for a in part)
            serve_s = time.perf_counter() - t0
        finally:
            server.stop()
        launches = {"upsample_argmax": upsample_argmax.launches}

    for i, ids in answers.items():
        if isinstance(ids, Exception):
            fail(f"request {i} failed: {ids!r}")
        if ids.shape != hw or ids.dtype != np.uint8 or ids.max() >= 13:
            fail(f"request {i}: bad answer {ids.shape} {ids.dtype} "
                 f"max {ids.max()}")
    if server.requests_served != n_requests:
        fail(f"served {server.requests_served} of {n_requests}")
    if launches["upsample_argmax"] < server.batches_run:
        fail(f"upsample_argmax launched {launches['upsample_argmax']} times "
             f"for {server.batches_run} batches")

    # one batch against the model forward + the plain version on the card
    x = torch.from_numpy(images[:8]).cuda().permute(0, 3, 1, 2)
    with torch.inference_mode():
        logits = server.model(x)["out"].float().permute(0, 2, 3, 1)
        if not bool(torch.isfinite(logits).all()):
            fail("non-finite logits")
        want, _ = upsample_argmax_reference(logits, *hw)
        top2 = upsample_logits(logits, *hw).topk(2, dim=-1).values
        decided = ((top2[..., 0] - top2[..., 1]) > TIE_GAP).cpu().numpy()
    got = np.stack([answers[i] for i in range(8)])
    wrong = int(((got != want.cpu().numpy()) & decided).sum())
    print(f"slice check: batch of 8 vs forward + plain version: {wrong} "
          f"mismatches outside {int((~decided).sum())} near-ties", flush=True)
    if wrong:
        fail(f"served ids disagree with the plain path at {wrong} pixels")

    print(f"slice: served {server.requests_served} requests in "
          f"{server.batches_run} batches (mean coalesced batch "
          f"{server.requests_served / server.batches_run:.2f}), "
          f"{n_requests / serve_s:.2f} req/s from {n_threads} threads "
          f"({serve_s:.3f} s; setup {setup_s:.1f} s) on {card}; "
          f"launches {launches}", flush=True)
    print(f"batch breakdown: {json.dumps(batch_breakdown(server, images[:8]))}"
          f" on {card}", flush=True)
    return launches


def batch_breakdown(server, images, reps: int = 5) -> dict:
    """Median per-stage times of one batch-8 predict, the server's own steps
    bracketed by CUDA events: host->device copy, model forward, the
    upsample_argmax kernel, uint8 cast + device->host copy; and the host
    wall time of the whole step, whose remainder is device idle time."""
    import numpy as np
    import torch

    from thermal_semantic_segmentation_torch.kernels.upsample_argmax import (
        upsample_argmax)

    stages = ("h2d_ms", "forward_ms", "kernel_ms", "d2h_ms")
    rows = []
    for _ in range(reps):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        server._host.numpy()[...] = images
        ev[0].record()
        x = server._host.to(server.device, non_blocking=True)
        ev[1].record()
        with torch.inference_mode():
            out = server.model(x.permute(0, 3, 1, 2))["out"]
            ev[2].record()
            pred, _ = upsample_argmax(out.float().permute(0, 2, 3, 1),
                                      *server.label_hw)
            ev[3].record()
            pred.to(torch.uint8).cpu().numpy()
        ev[4].record()
        ev[4].synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        times = [ev[i].elapsed_time(ev[i + 1]) for i in range(4)]
        rows.append(times + [wall, 1.0 - sum(times) / wall])
    med = np.median(np.asarray(rows), axis=0)
    return dict(zip(stages + ("wall_ms", "device_idle_share"),
                    (float(v) for v in med)))


class SeededImages:
    """What ``val_transform`` and ``train_transform`` give for IR frames,
    made with numpy from a seed: float32 (H, W, 1) images in [0, 1] and
    int64 (H, W) labels in 0..12, about 5% of them 255 (outside the
    classes, so the loss and the confusion matrix must drop them)."""

    def __init__(self, n: int, hw, seed: int):
        import numpy as np
        rng = np.random.default_rng(seed)
        self.images = rng.random((n, *hw, 1), dtype=np.float32)
        self.labels = rng.integers(0, NUM_CLASSES, (n, *hw))
        self.labels[rng.random((n, *hw)) < 0.05] = 255

    def __len__(self) -> int:
        return len(self.images)

    def get(self, index: int, rng) -> dict:
        return {"image": self.images[index], "label": self.labels[index]}


def phase_eval(card: str) -> dict:
    """Score seeded images with the full-width model through the eval path;
    returns the kernels' launch counts from this run."""
    import os

    import numpy as np
    import torch
    import torch.nn.functional as F

    from thermal_semantic_segmentation_torch.cli._common import (
        apply_model_meta, build_deeplab, load_seg_checkpoint)
    from thermal_semantic_segmentation_torch.cli.options import (
        evaluation_parse)
    from thermal_semantic_segmentation_torch.data.loader import DataLoader
    from thermal_semantic_segmentation_torch.eval.metrics import (
        scores_from_hist)
    from thermal_semantic_segmentation_torch.eval.validate import (
        seg_validate)
    from thermal_semantic_segmentation_torch.kernels.upsample_argmax import (
        upsample_argmax, upsample_argmax_reference)
    from thermal_semantic_segmentation_torch.models.deeplab import (
        create_deeplab)
    from thermal_semantic_segmentation_torch.ops.resize import upsample_logits
    from thermal_semantic_segmentation_torch.train.seg import (
        build_seg_eval_step)

    hw = SERVE_OUT
    data = SeededImages(EVAL_IMAGES, hw, seed=1)
    # ResNet-101, 1 channel, 13 classes, module2 head: random weights from
    # seed 0, saved in the reference .pth schema and loaded back the way the
    # eval CLI loads a checkpoint
    with tempfile_dir() as root:
        ref_model = create_deeplab(0)
        torch.save({"epoch": 0, "sem_net_state_dict": ref_model.state_dict()},
                   f"{root}/smoke.pth")
        del ref_model
        args = evaluation_parse().parse_args(
            ["-checkpoint_name", "smoke.pth", "--model_root_path", root,
             "-val_batch_size", str(EVAL_BATCH)])
        state_dict, meta = load_seg_checkpoint(
            os.path.join(args.model_root_path, args.checkpoint_name))
    apply_model_meta(args, meta)
    model = build_deeplab(args)
    model.load_state_dict(state_dict, strict=True)
    del state_dict

    # the step seg_validate builds, recording each batch's outputs, and the
    # model's stride-8 logits, for the checks below
    step = build_seg_eval_step(num_classes=NUM_CLASSES, ignore_index=IGNORE)
    seen, logits_seen = [], []

    def recording_step(model, image, label):
        hist, loss, pred = step(model, image, label)
        seen.append((hist, loss, pred, label))
        return hist, loss, pred

    hook = model.register_forward_hook(lambda m, i, out: logits_seen.append(
        out["out"].float().permute(0, 2, 3, 1).clone()))

    def run():
        loader = DataLoader(data, args.val_batch_size, shuffle=False,
                            drop_last=False, seed=args.seed)
        return seg_validate(model, loader, num_classes=NUM_CLASSES,
                            ignore_index=IGNORE, eval_step=recording_step)

    run()                               # warm-up: cuDNN at both batch sizes
    torch.cuda.synchronize()
    seen.clear()
    logits_seen.clear()
    upsample_argmax.launches = 0        # counts from the main path only
    t0 = time.perf_counter()
    mean_iu, val_loss, cls_iu = run()
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    launches = {"upsample_argmax": upsample_argmax.launches}
    hook.remove()

    n_batches = len(seen)
    sizes = [p.shape[0] for _, _, p, _ in seen]
    if sizes != [8, 8, 4] or len(logits_seen) != n_batches:
        fail(f"eval ran batches of {sizes} ({len(logits_seen)} forwards)")
    if launches["upsample_argmax"] < n_batches:
        fail(f"upsample_argmax launched {launches['upsample_argmax']} times "
             f"for {n_batches} eval batches")

    # the confusion matrix: the device's against numpy's on the kernel's
    # preds, and the kernel's preds against the plain version's outside
    # near-ties; val_loss against a float64 recomputation
    hist_dev = sum(h for h, _, _, _ in seen).cpu().numpy()

    def np_hist(pred, label):
        ok = (label >= 0) & (label < NUM_CLASSES)
        return np.bincount(NUM_CLASSES * label[ok] + pred[ok],
                           minlength=NUM_CLASSES ** 2).reshape(
                               NUM_CLASSES, NUM_CLASSES)

    hist_np = np.zeros((NUM_CLASSES, NUM_CLASSES), np.int64)
    hist_diff = ties = wrong = 0
    loss64 = 0.0
    with torch.inference_mode():
        for (_, _, pred, label), logits in zip(seen, logits_seen):
            if not bool(torch.isfinite(logits).all()):
                fail("non-finite logits in eval")
            lab, got = label.cpu().numpy(), pred.long().cpu().numpy()
            hist_np += np_hist(got, lab)
            want, _ = upsample_argmax_reference(logits, *hw)
            top2 = upsample_logits(logits, *hw).topk(2, dim=-1).values
            decided = ((top2[..., 0] - top2[..., 1]) > TIE_GAP).cpu().numpy()
            want = want.long().cpu().numpy()
            ties += int((~decided).sum())
            wrong += int(((got != want) & decided).sum())
            masked = np.where(decided, lab, -1)
            hist_diff += int(np.abs(np_hist(got, masked)
                                    - np_hist(want, masked)).sum())
            up = F.interpolate(logits.permute(0, 3, 1, 2).double(), size=hw,
                               mode="bilinear", align_corners=True)
            logp = torch.log_softmax(up, dim=1)
            valid = (label != IGNORE) & (label >= 0) & (label < NUM_CLASSES)
            nll = -logp.gather(1, torch.where(valid, label, 0)[:, None])[:, 0]
            loss64 += float(torch.where(valid, nll, 0.0).sum()
                            / valid.sum().clamp_min(1)) * pred.shape[0]
    want_loss = loss64 / EVAL_IMAGES
    loss_err = abs(val_loss - want_loss) / abs(want_loss)
    counted = int(((data.labels >= 0) & (data.labels < NUM_CLASSES)).sum())
    print(f"eval check: confusion matrix device vs numpy "
          f"{int(np.abs(hist_dev - hist_np).sum())} counts apart ("
          f"{int(hist_dev.sum())} pixels counted of {counted} labelled in "
          f"0..12); kernel vs plain preds outside {ties} near-ties: {wrong} "
          f"pixels, hists {hist_diff} counts apart; val_loss {val_loss} vs "
          f"float64 {want_loss} (rel err {loss_err:.3g})", flush=True)
    if not np.array_equal(hist_dev, hist_np) or hist_dev.sum() != counted:
        fail("the device confusion matrix disagrees with numpy's")
    if wrong or hist_diff:
        fail(f"eval preds disagree with the plain path outside near-ties: "
             f"{wrong} pixels, {hist_diff} hist counts")
    if not loss_err <= LOSS_RTOL:
        fail(f"val_loss {val_loss} vs float64 {want_loss}: rel err "
             f"{loss_err} over {LOSS_RTOL}")
    if not (np.isfinite(mean_iu) and len(cls_iu) == 12
            and mean_iu == scores_from_hist(hist_np).mean_iu):
        fail(f"eval scores: mean_iu {mean_iu}, {len(cls_iu)} classes")

    print(f"eval: {EVAL_IMAGES} images in batches of {sizes} at "
          f"{EVAL_IMAGES / eval_s:.2f} images/s ({eval_s:.3f} s, after one "
          f"warm-up pass) on {card}; mean_iu {mean_iu} val_loss {val_loss}; "
          f"launches {launches}", flush=True)
    breakdown = eval_breakdown(model, data.images[:EVAL_BATCH],
                               data.labels[:EVAL_BATCH])
    print(f"eval batch breakdown: {json.dumps(breakdown)} on {card}",
          flush=True)
    return launches


def eval_breakdown(model, images, labels, reps: int = 5) -> dict:
    """Median per-stage times of one batch of the eval step, its own stages
    bracketed by CUDA events: host->device copy (pinned), model forward,
    upsample + CE, the upsample_argmax kernel, the confusion matrix; and
    the host wall time of the whole step, whose remainder is device idle
    time."""
    import numpy as np
    import torch

    from thermal_semantic_segmentation_torch.kernels.upsample_argmax import (
        upsample_argmax)
    from thermal_semantic_segmentation_torch.losses import cross_entropy
    from thermal_semantic_segmentation_torch.ops.confmat import (
        confusion_matrix)
    from thermal_semantic_segmentation_torch.ops.resize import upsample_logits

    dev = torch.device("cuda")
    hw = labels.shape[1:3]
    host_image = torch.from_numpy(images).pin_memory()
    host_label = torch.from_numpy(labels).pin_memory()
    stages = ("h2d_ms", "forward_ms", "upsample_ce_ms", "kernel_ms",
              "confmat_ms")
    rows = []
    for _ in range(reps):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ev[0].record()
        image = host_image.to(dev, non_blocking=True)
        label = host_label.to(dev, non_blocking=True)
        ev[1].record()
        with torch.inference_mode():
            out = model(image.permute(0, 3, 1, 2))["out"]
            ev[2].record()
            logits = out.float().permute(0, 2, 3, 1)
            cross_entropy(upsample_logits(logits, *hw), label,
                          ignore_index=IGNORE)
            ev[3].record()
            pred, _ = upsample_argmax(logits, *hw)
            ev[4].record()
            confusion_matrix(pred, label, NUM_CLASSES)
            ev[5].record()
        ev[5].synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        times = [ev[i].elapsed_time(ev[i + 1]) for i in range(5)]
        rows.append(times + [wall, 1.0 - sum(times) / wall])
    med = np.median(np.asarray(rows), axis=0)
    return dict(zip(stages + ("wall_ms", "device_idle_share"),
                    (float(v) for v in med)))


def phase_train(card: str) -> dict:
    """Train the full-width model through the train CLI's epoch loop and
    check it; returns the kernels' launch counts from the two epochs."""
    import math
    import os

    import torch

    from thermal_semantic_segmentation_torch.cli._common import (
        build_deeplab, load_seg_checkpoint)
    from thermal_semantic_segmentation_torch.cli.options import seg_parse
    from thermal_semantic_segmentation_torch.cli.segmentation_train import (
        make_loaders, train_epochs)
    from thermal_semantic_segmentation_torch.data.loader import split_indices
    from thermal_semantic_segmentation_torch.kernels.upsample_argmax import (
        upsample_argmax)
    from thermal_semantic_segmentation_torch.models.deeplab import (
        create_deeplab)
    from thermal_semantic_segmentation_torch.train.seg import (
        make_seg_train_step)
    from thermal_semantic_segmentation_torch.utils.logging import get_logger

    source = SeededImages(TRAIN_SOURCE, SERVE_OUT, seed=2)
    target = SeededImages(TRAIN_TARGET, SERVE_OUT, seed=3)
    n_train, n_val = map(len, split_indices(TRAIN_SOURCE))
    steps = n_train // TRAIN_BATCH
    val_batches = (math.ceil(n_val / TRAIN_BATCH)
                   + math.ceil(TRAIN_TARGET / TRAIN_BATCH))
    with tempfile_dir() as root:
        # ResNet-101, 1 channel, 13 classes, module2 head: random weights
        # from seed 0 in a reference .pth, loaded with -load_model
        ref_model = create_deeplab(0)
        torch.save({"epoch": -1,
                    "sem_net_state_dict": ref_model.state_dict()},
                   f"{root}/start.pth")
        del ref_model
        logdir = os.path.join(root, "logs")
        logger = get_logger(logdir)

        def run(checkpoint, *flags):
            args = seg_parse().parse_args(
                ["-load_model", "true", "-checkpoint_name", checkpoint,
                 "-new_checkpoint_name", "smoke_train.pth",
                 "--model_root_path", root, "-batch_size", str(TRAIN_BATCH),
                 "-val_batch_size", str(TRAIN_BATCH), *flags])
            args.logdir = logdir
            state, history = train_epochs(
                args, logger, *make_loaders(args, source, target))
            return args, state, history

        upsample_argmax.launches = 0      # counts from the main path only
        args, state, first = run("start.pth", "-epochs", "1")
        # the checkpoint epoch 0 saved, reloaded strictly into a new model
        path = os.path.join(root, "smoke_train.pth")
        state_dict, meta = load_seg_checkpoint(path)
        reloaded = build_deeplab(args)
        reloaded.load_state_dict(state_dict, strict=True)
        ckpt_diff = [k for k, v in state.model.state_dict().items()
                     if not torch.equal(reloaded.state_dict()[k], v)]
        del reloaded, state_dict, state
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _, state, second = run("smoke_train.pth", "-epochs", "1")
        peak_gb = torch.cuda.max_memory_allocated() / 2**30
        launches = {"upsample_argmax": upsample_argmax.launches}
        history = first + second

        # the same loop under bfloat16 autocast: its second epoch's speed
        _, _, bf16_history = run("smoke_train.pth", "-epochs", "2",
                                 "--bf16", "true")

    print(f"train check: epochs {[h['epoch'] for h in history]}, losses "
          f"{[h['train_losses'] for h in history]}, val_loss "
          f"{[h['val_loss'] for h in history]}, scheduler steps "
          f"{[h['scheduler_steps'] for h in history]}, checkpoint epoch "
          f"{meta['epoch']} val_loss {meta['val_loss']} ({len(ckpt_diff)} "
          f"tensors differ from the model's); launches {launches}",
          flush=True)
    if [h["epoch"] for h in history] != [0, 1]:
        fail(f"trained epochs {[h['epoch'] for h in history]}, not [0, 1]")
    for h in history:
        if len(h["train_losses"]) != steps or \
                h["train_images"] != steps * TRAIN_BATCH:
            fail(f"epoch {h['epoch']} ran {h['train_images']} images in "
                 f"{len(h['train_losses'])} steps")
        if not all(map(math.isfinite, h["train_losses"] + [h["val_loss"]])):
            fail(f"epoch {h['epoch']}: non-finite loss")
        if h["scheduler_steps"] != 1 or h["lr_scale"] != 1.0:
            fail(f"epoch {h['epoch']}: the plateau scheduler stepped "
                 f"{h['scheduler_steps']} times")
    if ckpt_diff or meta["epoch"] != 0 or \
            meta["val_loss"] != history[0]["val_loss"]:
        fail(f"the epoch-0 checkpoint does not reload as the model: "
             f"{ckpt_diff[:5]}, epoch {meta['epoch']}")
    if launches["upsample_argmax"] < 2 * val_batches:
        fail(f"upsample_argmax launched {launches['upsample_argmax']} times "
             f"for {2 * val_batches} validation batches")

    # the loss falls on one repeated batch
    image = torch.from_numpy(source.images[:TRAIN_BATCH]).cuda()
    label = torch.from_numpy(source.labels[:TRAIN_BATCH]).cuda()
    step = make_seg_train_step(ignore_index=IGNORE, label_hw=SERVE_OUT,
                               base_lr=TRAIN_LR)
    repeated = torch.stack([step(state, image, label)
                            for _ in range(REPEAT_STEPS)]).tolist()
    print(f"train check: {REPEAT_STEPS} steps on one batch: losses "
          f"{repeated}", flush=True)
    if not (all(map(math.isfinite, repeated)) and repeated[-1] < repeated[0]):
        fail(f"the loss did not fall on a repeated batch: {repeated}")
    train_step_parity()

    h = second[0]
    bf = bf16_history[-1]
    print(f"train: epoch 1, {h['train_images']} images in {steps} steps of "
          f"{TRAIN_BATCH} at {h['train_images'] / h['train_s']:.2f} images/s "
          f"({h['train_s']:.3f} s), float32, on {card}", flush=True)
    print(f"train bf16: epoch {bf['epoch']}, {bf['train_images']} images at "
          f"{bf['train_images'] / bf['train_s']:.2f} images/s "
          f"({bf['train_s']:.3f} s), bfloat16 autocast, losses "
          f"{bf['train_losses']}, on {card}", flush=True)
    n_params = sum(p.numel() for p in state.model.parameters())
    print(f"train peak device memory: {peak_gb:.3f} GiB "
          f"(torch.cuda.max_memory_allocated over epoch 1; {n_params} "
          f"parameters) on {card}", flush=True)
    print(f"train step breakdown: "
          f"{json.dumps(train_breakdown(state, image, label))} on {card}",
          flush=True)
    print(f"train step kernels: {json.dumps(train_kernels(state, image, label))}"
          f" on {card}", flush=True)
    return launches


def train_step_parity() -> None:
    """One train step of a tiny model (layers 1,1,1,1, 64x128, batch 2,
    dropout off, lr_groups) on the card and on the CPU, from the same
    weights and batch: the loss within rtol 1e-5; each parameter inside
    one step's lr envelope (10 x for the head) but for at most 0.05% of
    them, where Adam moves a parameter whose gradient sits at float noise
    by lr either way, so those land up to 2 x outside; BatchNorm buffers
    within lr."""
    import torch

    from thermal_semantic_segmentation_torch.models.deeplab import (
        backbone_and_head_params, create_deeplab)
    from thermal_semantic_segmentation_torch.train.seg import (
        create_seg_state, make_seg_train_step)

    data = SeededImages(2, PARITY_HW, seed=4)
    out = {}
    for dev in ("cuda", "cpu"):
        model = create_deeplab(7, device=dev, layers=(1, 1, 1, 1))
        model.layer5.head[0].p = 0.0
        state = create_seg_state(model, learning_rate=TRAIN_LR,
                                 lr_groups=True, device=dev)
        step = make_seg_train_step(ignore_index=IGNORE, label_hw=PARITY_HW,
                                   base_lr=TRAIN_LR, device=dev)
        loss = step(state, torch.from_numpy(data.images).to(dev),
                    torch.from_numpy(data.labels).to(dev))
        head = {id(p) for p in backbone_and_head_params(model)[1]}
        mult = {n: 10.0 if id(p) in head else 1.0
                for n, p in model.named_parameters()}
        out[dev] = (float(loss), {k: v.detach().cpu()
                                  for k, v in model.state_dict().items()})
    (card_loss, card_sd), (cpu_loss, cpu_sd) = out["cuda"], out["cpu"]
    worst = outside = total = 0
    buffer_err = 0.0
    for k, v in card_sd.items():
        diff = (v.double() - cpu_sd[k].double()).abs()
        if k in mult:
            ratio = diff / (TRAIN_LR * mult[k])
            worst = max(worst, float(ratio.max()))
            outside += int((ratio > 1.0).sum())
            total += ratio.numel()
        else:
            buffer_err = max(buffer_err, float(diff.max()))
    loss_err = abs(card_loss - cpu_loss) / abs(cpu_loss)
    print(f"train parity card vs CPU: loss {card_loss} vs {cpu_loss} (rel "
          f"err {loss_err:.3g}); {outside} of {total} parameters outside "
          f"the one-step lr envelope, worst {worst:.4f} of it; BatchNorm "
          f"buffers max abs err {buffer_err:.3g}", flush=True)
    if not loss_err <= LOSS_RTOL:
        fail(f"train step loss on the card {card_loss} vs the CPU {cpu_loss}")
    # a first Adam step moves each parameter by under lr: 2 x lr apart at
    # most (a flipped sign), plus float32 rounding of the parameter
    if outside > 5e-4 * total or worst > 2.01 or not buffer_err <= TRAIN_LR:
        fail("the card's train step left the CPU's lr envelope")


def train_breakdown(state, image, label, reps: int = 5) -> dict:
    """Median per-stage times of one batch-8 train step, its stages
    bracketed by CUDA events: host->device copy (pinned), forward,
    upsample + CE, backward, optimizer step; and the host wall time of the
    whole step, whose remainder is device idle time."""
    import numpy as np
    import torch

    from thermal_semantic_segmentation_torch.losses import cross_entropy
    from thermal_semantic_segmentation_torch.ops.resize import upsample_logits
    from thermal_semantic_segmentation_torch.train.seg import seed_dropout

    model, opt = state.model, state.optimizer
    model.train()
    host_image = image.cpu().pin_memory()
    host_label = label.cpu().pin_memory()
    stages = ("h2d_ms", "forward_ms", "upsample_ce_ms", "backward_ms",
              "optimizer_ms")
    rows = []
    for k in range(reps):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ev[0].record()
        x = host_image.to(image.device, non_blocking=True)
        y = host_label.to(image.device, non_blocking=True)
        ev[1].record()
        opt.zero_grad(set_to_none=True)
        seed_dropout(model, 0, k)
        out = model(x.permute(0, 3, 1, 2))["out"]
        ev[2].record()
        loss = cross_entropy(upsample_logits(out.float().permute(0, 2, 3, 1),
                                             *y.shape[1:3]), y,
                             ignore_index=IGNORE)
        ev[3].record()
        loss.backward()
        ev[4].record()
        opt.step()
        ev[5].record()
        ev[5].synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        times = [ev[i].elapsed_time(ev[i + 1]) for i in range(5)]
        rows.append(times + [wall, 1.0 - sum(times) / wall])
    med = np.median(np.asarray(rows), axis=0)
    return dict(zip(stages + ("wall_ms", "device_idle_share"),
                    (float(v) for v in med)))


def train_kernels(state, image, label, top: int = 12) -> dict:
    """Device time of one train step by kernel, from ``torch.profiler``:
    the total, the ``top`` kernels, and the share of the layout
    conversions and copies (cuDNN's nchwToNhwc / nhwcToNchw kernels,
    ATen's copy kernels), which a channels_last step should keep small."""
    import re

    import torch
    from torch.profiler import ProfilerActivity, profile

    from thermal_semantic_segmentation_torch.train.seg import (
        make_seg_train_step)

    step = make_seg_train_step(ignore_index=IGNORE, label_hw=SERVE_OUT,
                               base_lr=TRAIN_LR)
    step(state, image, label)
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            step(state, image, label)
            torch.cuda.synchronize()
        events = prof.key_averages()
    except RuntimeError as e:
        return {"not measured": repr(e)}

    def device_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    # the kernels themselves (the operators that launched them carry
    # their time too)
    kernels = [(e.key, device_us(e)) for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA
               and device_us(e) > 0]
    total = sum(t for _, t in kernels)
    if not total:
        return {"not measured": "the profiler recorded no device time"}
    layout = re.compile(r"nchwToNhwc|nhwcToNchw|copy_kernel")
    kernels.sort(key=lambda kt: -kt[1])
    return {"device_ms": total / 1e3,
            "layout_copy_share": sum(t for k, t in kernels
                                     if layout.search(k)) / total,
            "top": [[k[:90], round(t / 1e3, 4)] for k, t in kernels[:top]]}


class NamedImages:
    """Seeded float32 (H, W, 1) images in [0, 1] with file names, what
    ``val_transform`` gives for IR frames and the pseudo-label loader
    carries (the card's machine has no PIL)."""

    def __init__(self, n: int, hw, seed: int):
        import numpy as np
        self.images = np.random.default_rng(seed).random((n, *hw, 1),
                                                         dtype=np.float32)

    def __len__(self) -> int:
        return len(self.images)

    def get(self, index: int, rng) -> dict:
        return {"image": self.images[index], "img_path": f"{index:04d}.png"}


def read_png_ids(path: str):
    """The pixels of an 8-bit grayscale or palette PNG of filter-0 rows
    (what ``data/png.py`` writes), decoded here with zlib alone."""
    import struct
    import zlib

    import numpy as np
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        fail(f"{path}: not a PNG")
    pos, idat, size = 8, [], None
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if kind == b"IHDR":
            w, h, depth, colour = struct.unpack(">IIBB", body[:10])
            if depth != 8 or colour not in (0, 3):
                fail(f"{path}: depth {depth} colour type {colour}")
            size = (h, w)
        elif kind == b"IDAT":
            idat.append(body)
        pos += 12 + n
    rows = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(
        size[0], size[1] + 1)
    if rows[:, 0].any():
        fail(f"{path}: a row with a filter other than 0")
    return rows[:, 1:]


def load_smoke_model(parse, root: str):
    """The full-width model from ``root``/smoke.pth, through the checkpoint
    path the CLIs take (``parse``: the CLI's parser)."""
    import os

    from thermal_semantic_segmentation_torch.cli._common import (
        apply_model_meta, build_deeplab, load_seg_checkpoint)
    args = parse().parse_args(["-checkpoint_name", "smoke.pth",
                               "--model_root_path", root])
    state_dict, meta = load_seg_checkpoint(
        os.path.join(args.model_root_path, args.checkpoint_name))
    apply_model_meta(args, meta)
    model = build_deeplab(args)
    model.load_state_dict(state_dict, strict=True)
    return model


def phase_pseudo(card: str, root: str) -> dict:
    """Hard, soft and hard+flip pseudo-labels of seeded images with the
    full-width model through ``generate_pseudo_labels``; returns the
    kernels' launch counts from the three runs."""
    import math
    import os

    import numpy as np
    import torch
    import torch.nn.functional as F

    from thermal_semantic_segmentation_torch.cli.options import (
        pseudo_generation_parse)
    from thermal_semantic_segmentation_torch.data.loader import DataLoader
    from thermal_semantic_segmentation_torch.kernels.upsample_argmax import (
        upsample_argmax, upsample_argmax_reference)
    from thermal_semantic_segmentation_torch.train.pseudo import (
        generate_pseudo_labels)
    from thermal_semantic_segmentation_torch.train.seg import (
        forward_nhwc, frozen_inference)

    model = load_smoke_model(pseudo_generation_parse, root)
    dev = next(model.parameters()).device
    data = NamedImages(PSEUDO_IMAGES, SERVE_OUT, seed=5)
    n_batches = math.ceil(PSEUDO_IMAGES / PSEUDO_BATCH)
    with frozen_inference(model):   # warm-up: cuDNN at the tail's batch
        x = torch.from_numpy(data.images[:PSEUDO_IMAGES % PSEUDO_BATCH])
        forward_nhwc(model, x.to(dev))
    for mode in ("hard", "soft", "flip"):   # and one batch of each mode
        generate_pseudo_labels(
            model, DataLoader(data, PSEUDO_BATCH, shuffle=False,
                              drop_last=False),
            save_path=os.path.join(root, "warm-up", mode), max_steps=1,
            soft=mode == "soft", flip=mode == "flip")
    torch.cuda.synchronize()

    upsample_argmax.launches = 0      # counts from the main path only
    rates, dirs = {}, {}
    for mode in ("hard", "soft", "flip"):
        dirs[mode] = os.path.join(root, "pseudo_labels", mode)
        loader = DataLoader(data, PSEUDO_BATCH, shuffle=False,
                            drop_last=False)
        t0 = time.perf_counter()
        n = generate_pseudo_labels(model, loader, save_path=dirs[mode],
                                   soft=mode == "soft", flip=mode == "flip")
        secs = time.perf_counter() - t0
        if n != PSEUDO_IMAGES:
            fail(f"pseudo {mode}: {n} of {PSEUDO_IMAGES} images")
        rates[mode] = (PSEUDO_IMAGES / secs, secs)
    launches = {"upsample_argmax": upsample_argmax.launches}
    if launches["upsample_argmax"] != n_batches:
        fail(f"upsample_argmax launched {launches['upsample_argmax']} times "
             f"for {n_batches} hard pseudo-label batches")

    # each file against the plain path on the same images: hard ids (read
    # back from the PNGs) and confidences against the plain version,
    # flip ids and confidences against a float64 recomputation, soft maps
    # against a float64 softmax
    wrong = ties = flip_wrong = flip_ties = 0
    conf_ulps = flip_ulps = soft_err = sum_err = 0.0
    hw = SERVE_OUT

    def ulps(got16, want):
        want16 = want.astype(np.float16)
        return float((np.abs(got16.astype(np.float64) - want)
                      / np.spacing(want16).astype(np.float64)).max())

    with frozen_inference(model):
        for start in range(0, PSEUDO_IMAGES, PSEUDO_BATCH):
            x = torch.from_numpy(
                data.images[start:start + PSEUDO_BATCH]).to(dev)
            logits = forward_nhwc(model, x)["out"]
            if not bool(torch.isfinite(logits).all()):
                fail("non-finite logits in pseudo")
            want_pred, want_conf = upsample_argmax_reference(
                logits, *logits.shape[1:3])
            top2 = logits.topk(2, dim=-1).values
            decided = ((top2[..., 0] - top2[..., 1]) > TIE_GAP).cpu().numpy()
            probs64 = torch.softmax(logits.double(), dim=-1)
            logits_f = forward_nhwc(model, torch.flip(x, (2,)))["out"]
            probs_f64 = torch.softmax(logits_f.double(), dim=-1)
            up = F.interpolate(probs64.permute(0, 3, 1, 2), size=hw,
                               mode="bilinear", align_corners=True)
            up_f = F.interpolate(probs_f64.permute(0, 3, 1, 2), size=hw,
                                 mode="bilinear", align_corners=True)
            avg = ((up + torch.flip(up_f, (3,))) / 2.0).permute(0, 2, 3, 1)
            top2f = avg.topk(2, dim=-1).values
            decided_f = ((top2f[..., 0] - top2f[..., 1])
                         > TIE_GAP).cpu().numpy()
            flip_conf, flip_pred = (t.cpu().numpy() for t in avg.max(dim=-1))
            want_pred, want_conf = (want_pred.cpu().numpy(),
                                    want_conf.double().cpu().numpy())
            probs64 = probs64.cpu().numpy()
            for k in range(x.shape[0]):
                name = f"{start + k:04d}"
                ids = read_png_ids(os.path.join(dirs["hard"], name + ".png"))
                color = read_png_ids(os.path.join(dirs["hard"],
                                                  name + "_color.png"))
                if not np.array_equal(ids, color):
                    fail(f"{name}: the colour PNG holds other ids")
                wrong += int(((ids != want_pred[k]) & decided[k]).sum())
                ties += int((~decided[k]).sum())
                conf = np.load(os.path.join(dirs["hard"], name + "_conf.npy"))
                conf_ulps = max(conf_ulps, ulps(conf, want_conf[k]))
                ids = read_png_ids(os.path.join(dirs["flip"], name + ".png"))
                flip_wrong += int(((ids != flip_pred[k]) & decided_f[k]).sum())
                flip_ties += int((~decided_f[k]).sum())
                conf = np.load(os.path.join(dirs["flip"], name + "_conf.npy"))
                flip_ulps = max(flip_ulps, ulps(conf, flip_conf[k]))
                soft = np.load(os.path.join(dirs["soft"], name + ".npy"))
                if soft.shape != (NUM_CLASSES, *logits.shape[1:3]):
                    fail(f"{name}: soft map of shape {soft.shape}")
                sum_err = max(sum_err, float(np.abs(soft.sum(0) - 1.0).max()))
                soft_err = max(soft_err, float(np.abs(
                    soft - probs64[k].transpose(2, 0, 1)).max()))
    print(f"pseudo check: hard ids vs plain version outside {ties} "
          f"near-ties: {wrong} pixels, conf {conf_ulps:.3f} float16 ulps; "
          f"flip ids vs float64 outside {flip_ties} near-ties: {flip_wrong} "
          f"pixels, conf {flip_ulps:.3f} ulps; soft maps sum to 1 within "
          f"{sum_err:.3g}, vs float64 softmax {soft_err:.3g}; launches "
          f"{launches}", flush=True)
    if wrong or flip_wrong:
        fail(f"pseudo ids disagree outside near-ties: hard {wrong}, flip "
             f"{flip_wrong} pixels")
    if conf_ulps > 1.0 or flip_ulps > 1.0:
        fail(f"pseudo confidences {conf_ulps}, {flip_ulps} float16 ulps off")
    if not (sum_err <= SOFT_SUM_ATOL and soft_err <= SOFT_SUM_ATOL):
        fail(f"soft maps: sums {sum_err}, vs float64 {soft_err} over "
             f"{SOFT_SUM_ATOL}")
    for mode, (rate, secs) in rates.items():
        print(f"pseudo {mode}: {PSEUDO_IMAGES} images at batch "
              f"{PSEUDO_BATCH} at {rate:.2f} images/s ({secs:.3f} s, files "
              f"written) on {card}", flush=True)
    for mode in ("hard", "soft"):
        print(f"pseudo {mode} batch breakdown: "
              f"{json.dumps(pseudo_breakdown(model, data, mode))} on {card}",
              flush=True)
    print(f"pseudo hard loop: {json.dumps(pseudo_loop(model, data, root))} "
          f"on {card}", flush=True)
    return launches


def pseudo_loop(model, data, root: str) -> dict:
    """The hard pseudo-label loop as a whole: its device busy share under
    ``torch.profiler`` (kernel time over the profiled run's wall time), and
    its images/s unprofiled with 8 writer threads and with 1."""
    import os

    import torch
    from torch.profiler import ProfilerActivity, profile

    from thermal_semantic_segmentation_torch.data.loader import DataLoader
    from thermal_semantic_segmentation_torch.train.pseudo import (
        generate_pseudo_labels)

    def run(tag, threads):
        loader = DataLoader(data, PSEUDO_BATCH, shuffle=False,
                            drop_last=False)
        t0 = time.perf_counter()
        generate_pseudo_labels(model, loader, writer_threads=threads,
                               save_path=os.path.join(root, "loop", tag))
        return time.perf_counter() - t0

    out = {}
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            wall = run("profiled", 8)
        device_us = sum(getattr(e, "self_device_time_total",
                                getattr(e, "self_cuda_time_total", 0.0))
                        for e in prof.key_averages()
                        if e.device_type == torch.autograd.DeviceType.CUDA)
        out["profiled_device_busy_share"] = device_us / 1e3 / (wall * 1e3)
        out["profiled_wall_ms"] = wall * 1e3
    except RuntimeError as e:
        out["profiled_device_busy_share"] = f"not measured ({e!r})"
    for threads in (8, 1):
        out[f"images_per_s_{threads}_writers"] = PSEUDO_IMAGES / run(
            f"w{threads}", threads)
    return out


def pseudo_breakdown(model, data, mode: str, reps: int = 5) -> dict:
    """Median per-stage times of one batch-4 pseudo-label step, its device
    stages bracketed by CUDA events: host->device copy (pinned), forward,
    the kernel (hard) or the softmax (soft), device->host copy; then the
    host time to write the batch's files through the 8-thread pool; and the
    host wall time of the whole step, whose remainder is device idle
    time."""
    import concurrent.futures as cf
    import os

    import numpy as np
    import torch

    from thermal_semantic_segmentation_torch.data.palette import (
        freiburg_palette)
    from thermal_semantic_segmentation_torch.kernels.upsample_argmax import (
        upsample_argmax)
    from thermal_semantic_segmentation_torch.train.pseudo import (
        write_hard, write_soft)
    from thermal_semantic_segmentation_torch.train.seg import (
        forward_nhwc, frozen_inference)

    dev = next(model.parameters()).device
    host = torch.from_numpy(data.images[:PSEUDO_BATCH]).pin_memory()
    palette = freiburg_palette()
    stages = ("h2d_ms", "forward_ms",
              "kernel_ms" if mode == "hard" else "softmax_ms", "d2h_ms")
    rows = []
    with tempfile_dir() as out, cf.ThreadPoolExecutor(8) as pool:
        for _ in range(reps):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ev[0].record()
            x = host.to(dev, non_blocking=True)
            ev[1].record()
            with frozen_inference(model):
                logits = forward_nhwc(model, x)["out"]
                ev[2].record()
                if mode == "hard":
                    pred, conf = upsample_argmax(logits, *logits.shape[1:3])
                    ev[3].record()
                    pred, conf = pred.cpu().numpy(), conf.cpu().numpy()
                else:
                    probs = torch.softmax(logits, dim=-1)
                    ev[3].record()
                    probs = probs.contiguous().cpu().numpy()
            ev[4].record()
            t_w = time.perf_counter()
            if mode == "hard":
                futures = [pool.submit(write_hard, out, f"{k:04d}.png",
                                       pred[k], conf[k], palette)
                           for k in range(PSEUDO_BATCH)]
            else:
                futures = [pool.submit(write_soft, out, f"{k:04d}.png",
                                       probs[k])
                           for k in range(PSEUDO_BATCH)]
            for f in futures:
                f.result()
            end = time.perf_counter()
            write = (end - t_w) * 1e3
            wall = (end - t0) * 1e3
            times = [ev[i].elapsed_time(ev[i + 1]) for i in range(4)]
            rows.append(times + [write, wall, 1.0 - sum(times) / wall])
            if not os.listdir(out):
                fail("the breakdown wrote no files")
    med = np.median(np.asarray(rows), axis=0)
    return dict(zip(stages + ("write_ms", "wall_ms", "device_idle_share"),
                    (float(v) for v in med)))


def phase_prototypes(card: str, root: str) -> dict:
    """Class prototypes of seeded images with the full-width model through
    ``calc_prototypes``, checked against a float64 recomputation; returns
    the kernels' launch counts from the run."""
    import numpy as np
    import torch

    from thermal_semantic_segmentation_torch.cli.options import (
        calc_proto_parse)
    from thermal_semantic_segmentation_torch.core.checkpoint import (
        load_checkpoint, save_checkpoint)
    from thermal_semantic_segmentation_torch.data.loader import DataLoader
    from thermal_semantic_segmentation_torch.kernels.upsample_argmax import (
        upsample_argmax, upsample_argmax_reference)
    from thermal_semantic_segmentation_torch.ops.class_means import (
        fold_prototypes, masked_class_means)
    from thermal_semantic_segmentation_torch.train.prototypes import (
        calc_prototypes)
    from thermal_semantic_segmentation_torch.train.seg import (
        forward_nhwc, frozen_inference)

    model = load_smoke_model(calc_proto_parse, root)
    dev = next(model.parameters()).device
    data = NamedImages(PROTO_IMAGES, SERVE_OUT, seed=6)
    steps = PROTO_IMAGES // PROTO_BATCH
    with frozen_inference(model):   # warm-up: cuDNN at batch 64
        forward_nhwc(model, torch.from_numpy(
            data.images[:PROTO_BATCH]).to(dev))
    seen = []
    hook = model.register_forward_hook(lambda m, i, out: seen.append(
        {k: v.float().permute(0, 2, 3, 1).clone() for k, v in out.items()}))
    torch.cuda.synchronize()
    upsample_argmax.launches = 0      # counts from the main path only
    t0 = time.perf_counter()
    protos, counts = calc_prototypes(
        model, DataLoader(data, PROTO_BATCH, shuffle=True, drop_last=True,
                          seed=0), num_classes=NUM_CLASSES, epochs=1)
    secs = time.perf_counter() - t0
    launches = {"upsample_argmax": upsample_argmax.launches}
    hook.remove()
    if len(seen) != steps or launches["upsample_argmax"] != steps:
        fail(f"prototypes ran {len(seen)} forwards and "
             f"{launches['upsample_argmax']} kernel launches for {steps} "
             f"steps")

    # float64 masked means and the sequential 'mean' fold from the same
    # features and the kernel's own classes; the kernel's classes against
    # the plain version's outside near-ties
    p64 = np.zeros((NUM_CLASSES, 256))
    n64 = np.zeros(NUM_CLASSES)
    wrong = ties = 0
    for out in seen:
        logits = out["out"]
        n, h, w, _ = logits.shape
        pred, _ = upsample_argmax(logits, h, w)
        want, _ = upsample_argmax_reference(logits, h, w)
        top2 = logits.topk(2, dim=-1).values
        decided = (top2[..., 0] - top2[..., 1]) > TIE_GAP
        wrong += int(((pred != want) & decided).sum())
        ties += int((~decided).sum())
        pred = pred.reshape(n, h * w).cpu().numpy()
        feat = out["feat"].reshape(n, h * w, -1).double().cpu().numpy()
        for i in range(n):
            onehot = (pred[i][:, None] == np.arange(NUM_CLASSES)).astype(
                np.float64)
            cnt = onehot.sum(0)
            vec = (onehot.T @ feat[i]) / np.maximum(cnt, 1.0)[:, None]
            ok = (cnt > 0) & (cnt >= 10) & (vec.sum(1) != 0.0)
            p64[ok] = (p64[ok] * n64[ok, None] + vec[ok]) / (n64[ok, None]
                                                             + 1.0)
            n64[ok] = np.minimum(n64[ok] + 1.0, 3000.0)
    rel_err = float(np.abs(protos - p64).max() / np.abs(p64).max())
    with tempfile_dir() as tmp:
        path = f"{tmp}/prototypes_on_smoke"
        save_checkpoint(path, {"objective_vectors": protos, "counts": counts})
        back = load_checkpoint(path)
    round_trip = (np.array_equal(back["objective_vectors"], protos)
                  and np.array_equal(back["counts"], counts)
                  and back["objective_vectors"].dtype == protos.dtype)
    print(f"prototypes check: kernel classes vs plain outside {ties} "
          f"near-ties: {wrong} pixels; prototypes vs float64 rel err "
          f"{rel_err:.3g}, counts {counts.astype(int).tolist()} (float64 "
          f"{'equal' if np.array_equal(counts, n64) else n64.tolist()}); "
          f"checkpoint round trip {'equal' if round_trip else 'DIFFERS'}; "
          f"launches {launches}", flush=True)
    if wrong:
        fail(f"prototype classes disagree with the plain path at {wrong} "
             f"pixels")
    if not (rel_err <= PROTO_RTOL and np.array_equal(counts, n64)
            and counts.sum() > 0):
        fail(f"prototypes vs float64: rel err {rel_err}, counts {counts} "
             f"vs {n64}")
    if not round_trip:
        fail("the prototype file does not read back as written")

    # masked means and fold of one batch, by CUDA events
    feat, logits = seen[0]["feat"], seen[0]["out"]
    p0 = torch.zeros((NUM_CLASSES, 256), device=dev)
    n0 = torch.zeros((NUM_CLASSES,), device=dev)
    vectors, valid = masked_class_means(feat, logits, num_classes=NUM_CLASSES)
    means_ms = time_ms(lambda: masked_class_means(
        feat, logits, num_classes=NUM_CLASSES), reps=10)
    fold_ms = time_ms(lambda: fold_prototypes(p0, n0, vectors, valid,
                                              mode="mean"), reps=10)
    with frozen_inference(model):
        x = torch.from_numpy(data.images[:PROTO_BATCH]).to(dev)
        forward_ms = time_ms(lambda: forward_nhwc(model, x), reps=3,
                             warmup=1)
    aspp_branch_times(card)
    print(f"prototypes: {PROTO_IMAGES} images in {steps} steps of "
          f"{PROTO_BATCH} at {PROTO_IMAGES / secs:.2f} images/s "
          f"({secs:.3f} s) on {card}; per batch: forward {forward_ms} ms, "
          f"masked means {means_ms} ms, fold {fold_ms} ms", flush=True)
    return launches


def aspp_branch_times(card: str) -> None:
    """One dilated ASPP branch conv (2048 -> 256 channels, 3x3, dilation 6,
    float32, channels_last, 33x65 maps) at batch 10 and 11, where cuDNN
    changes kernels, and at batch 64 split as ``nn/aspp.py`` splits it
    (``MAX_BRANCH_PIXELS``)."""
    import torch

    from thermal_semantic_segmentation_torch.nn.aspp import MAX_BRANCH_PIXELS

    conv = torch.nn.Conv2d(2048, 256, 3, padding=6, dilation=6).cuda().to(
        memory_format=torch.channels_last)
    per_call = MAX_BRANCH_PIXELS // (33 * 65)
    times = {}
    with torch.inference_mode():
        for n in (10, 11, 64):
            x = torch.rand(n, 2048, 33, 65, device="cuda").contiguous(
                memory_format=torch.channels_last)
            if n < 64:
                times[f"batch {n}"] = time_ms(lambda: conv(x), reps=2,
                                              warmup=1)
        times[f"batch 64 in calls of {per_call}"] = time_ms(
            lambda: [conv(p) for p in x.split(per_call)], reps=3)
    print(f"ASPP dilated branch conv (ms): {json.dumps(times)} on {card}",
          flush=True)




def main() -> int:
    import torch
    t0 = time.perf_counter()
    card = phase_device()
    phase_build()
    kernels = phase_kernels()
    by_path = {"serve": phase_slice(card), "eval": phase_eval(card),
               "train": phase_train(card)}
    with tempfile_dir() as root:
        from thermal_semantic_segmentation_torch.models.deeplab import (
            create_deeplab)
        # ResNet-101, 1 channel, 13 classes, module2 head: random weights
        # from seed 0 in a reference .pth, for both offline phases
        torch.save({"epoch": 0,
                    "sem_net_state_dict": create_deeplab(0).state_dict()},
                   f"{root}/smoke.pth")
        by_path["pseudo"] = phase_pseudo(card, root)
        by_path["prototypes"] = phase_prototypes(card, root)
    for k in kernels:
        k["launches_by_path"] = {path: launches[k["name"]]
                                 for path, launches in by_path.items()}
        k["launches"] = sum(k["launches_by_path"].values())
        for path, n in k["launches_by_path"].items():
            if not n:
                fail(f"kernel {k['name']} was not launched on the {path} "
                     f"path")
    print(f"smoke: every phase passed in {time.perf_counter() - t0:.1f} s",
          flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)     # nvidia-smi's name, power.limit
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
