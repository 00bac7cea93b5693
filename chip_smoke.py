"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--phases export,serve_artifact,...]

Without arguments every phase runs; ``--phases`` runs the ones named and
those they need (``NEEDS``: translate and data_parallel take the gan
phase's checkpoint, distance the translate phase's PNGs, serve_artifact the
export phase's artifact; the multi-process phases the two gloo ranks' run),
always after the device, build and kernels phases. The check that each
kernel was launched holds over the phases that ran. The run closes with one
``summary <phase>`` line a phase (seconds and key numbers), then the
``kernels`` line, the card and the result line.

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
     round trip; prints images/s and the masked-means and fold times;
  9. self_train: two batch-4 epochs through ``self_train_epochs`` (the
     second resumed), checked against float64 and a tiny card-vs-CPU step;
     self_train_dist: the same loop under ``--distributed`` with one NCCL
     rank (the mesh step), a SIGTERM before the third step and the resume
     from ``preempt_``, the mesh step timed against the plain one; then
     two gloo ranks of a tiny model on the card (``gloo_runs``): bit-equal
     on both ranks, held to one rank on the joined batch and their
     gradients to a float64 step;
 10. gan: the full-width CycleGAN (UNet-256 ngf 64, PatchGAN ndf 64) with
     the contour and module2 semantic losses, its frozen sem nets
     full-width ResNet-101s, trains two batch-4 epochs of 8 steps through
     ``cli/main.gan_epochs`` (the second resumed from the first's
     checkpoint); checks finite losses, the checkpoint round trip, D's
     buffers through a G pass, the kernel's launches (one per step: the
     t2s labels), one step's t2s ids against the plain version and a tiny
     card-vs-CPU step (the card's discrete decisions replayed on the
     CPU); prints images/s, peak memory and a per-stage step
     breakdown; gan_dist: ``gan_epochs`` under ``--distributed`` with one
     NCCL rank, a SIGTERM and the resume, the mesh step timed; two gloo
     ranks of tiny nets whose pools, parameters and metrics are bit-equal
     and held to one rank on the joined batch;
 11. gan_legacy: the same with the GAN CLI's default -sem_mode legacy:
     the frozen sem nets are full-width 19-class legacy ResNet-101s
     (random weights, reference legacy .pth files), the kernel labels the
     t2s term from their (4, 33, 65, 19) logits;
 12. translate: the translator's batch loop writes seeded frames at batch 8
     to 320x700 PNGs from the gan phase's checkpoint; the pixels, read
     back with zlib, are held to a float64 recomputation: within one grey
     level, or within as many as the pixel has decisions (truncations and
     roundings in its support) lying within float32's error of their
     boundary (``translate_float64``); prints images/s and a forward /
     resize / encode breakdown;
 13. distance: ``evaluate_distance`` with the per-class L1 scores those
     PNGs against seeded originals and labels at batch 1 and 8; L1, SSIM
     and per-class L1 held to float64 on the CPU; prints pairs/s and the
     per-batch times. It launches no kernel;
 14. data_parallel: ``--data_parallel``'s ``LocalMesh`` of two replicas on
     the one card: eval, hard pseudo-labels, prototypes, the server's
     batches and the translator against one replica (ids outside
     near-ties, confusion matrices, confidences, prototypes, frames), the
     kernel's launches one a replica share, images/s of both;
 15. dist: the train CLI's loop under ``--distributed`` with one rank over
     NCCL (a process group on a free localhost port), the full-width model
     at batch 8 under DDP, with ``--remat`` none, dots and full, each
     epoch validated through the kernel; a SIGTERM sent before the third
     step of another epoch leaves ``preempt_dist.pth``, which
     ``-load_model`` resumes; prints each remat mode's step ms, images/s
     and peak memory and its gradients against ``none``'s on one batch;
     then two ranks on the one card over gloo (``python3 chip_smoke.py
     --dist-worker <rank> <port> <dir>``, NCCL takes one rank a card) with
     a tiny model: the two-rank 'sync' step against the one-rank step on
     the joined batch, 'per_replica''s state equal on both ranks, and the
     two-rank ``seg_validate``, ``evaluate_distance`` and prototype merge
     against their one-rank results;
 15b. spatial: the seg train step on a (data, spatial) mesh: two gloo
     ranks on the card (``python3 chip_smoke.py --spatial-worker <rank>
     <port> <dir>``) split the width of the full-width batch-8 step at
     data 1 x spatial 2 (halo exchanges, GroupNorm and SE over the full
     width, the sharded upsample); loss and gradients held to the plain
     step on the joined batch, the ranks' state bit-equal; each rank's
     peak memory, step time and exchange traffic beside the plain step's;
     the same step in float64, each gradient tensor held to the plain
     float64 step's; then the seg eval step on the same grid (the kernel
     on the gathered whole rows, each rank keeping its columns): pred
     outside near-ties and the hist at the decided pixels equal to the
     plain eval step's on the joined batch, the loss within 1e-5, and
     each rank's launches (path ``spatial``); then the 2-D mesh at
     spatial 1 on one NCCL rank against the plain step, in both; and the
     cost of the synchronised BatchNorm's normalisation;
 15c. checkpoint: the full-width train state (parameters and Adam's
     moments) written by ``save_checkpoint`` and by ``AsyncCheckpointer``
     (the snapshot's and the background write's times, train steps with
     the write in flight against steps without one, the file read back
     bit-equal), then ``save_sharded``/``load_sharded`` with the moments
     ``Shard(0)`` on one NCCL rank and on two gloo ranks on the card
     (``python3 chip_smoke.py --checkpoint-worker <rank> <port> <dir>``):
     seconds and bytes a rank, every leaf back bit-equal in its own
     placements and resharded to ``Replicate()``. It launches no kernel;
 16. export: ``cli/export_stablehlo`` writes the full-width model as a
     ``torch.export`` ids artifact with a symbolic batch (the kernel runs
     inside it as the op ``tss::upsample_argmax``) and self-checks it; the
     artifact, loaded back, answers batches of 3, 8 and 12 held to the live
     model outside near-ties, with one launch a chunk of 8 rows and the
     kernel named by ``torch.profiler``; the int8 container's bytes and ids;
     at the tiny depth a fixed-batch logits artifact (also moved to the CPU)
     and a generator; prints the export, save and load times and the
     artifact's batch-8 forward against the live model's;
 17. serve_translator: ``serve --kind translator`` from a GAN .pth
     (UNet-256, ngf 64) answers 24 requests from 4 threads at batch 8, each
     PNG encoded by its thread, held to float64; frames/s, the forward of a
     batch, the PNG encoding of a frame. It launches no kernel;
 18. serve_artifact: ``serve --artifact`` of the export phase's artifact
     and the live server in turns of 96 requests from 4 threads at batch 8
     (one warm-up turn each, then three; req/s as the median of the warm
     turns, a batch's forward, ids outside near-ties), then a one-rank NCCL
     ``serve --distributed`` answers a batch held to the live model; the
     artifact's and the ranked server's launches are counted apart
     (``serve_artifact`` and ``serve_distributed`` in the kernels line);
 19. profile: ``cli/profile_step`` at full width, float32, for the eval and
     seg steps (batch 8), the self-training step and the full CycleGAN
     step with the contour and module2 sem losses (batch 4), 2 warm-up and
     5 profiled steps each: each step's category table; its final line
     held to the JAX CLI's keys, device time within wall time, the
     categories summing to the device time; in the eval and GAN traces
     ``upsample_argmax_kernel`` named, at the kernels phase's time;
 20. device_aug: the train CLI's epoch loop with ``-device_aug true`` on
     seeded raw 320x700 frames (the loader's size), cropped to 256x512 on
     the card, then one validation through the kernel; the card's
     augmented batch against the CPU's from the same draws (images 1e-5,
     labels exact); the augmentation's ms against the step's;
 21. host_data: eval under bfloat16 autocast with ``--wire packed_bf16``
     against ``packed`` (the same ids; bytes and h2d ms of each), the
     decode cache through a hit and a disk-tier reload, and the native C++
     IO where the card's host can build it (encode -> decode_raw exact,
     ``decode_ir_batch`` against numpy, frames/s at 1 and 8 threads);
 21b. host_io: the entry points read files on the card's host, with no
     PIL: a seeded Freiburg tree at the raw 320x960 size (32 train
     triples of 16-bit IR, RGB and labels, 24 test IR frames with .npy
     labels) written by the script's own PNG encoder (rows through filter
     types 0-4, one Adam7 file) and read back exactly by the port's
     reader; decode cache off, host decode + resize ms a frame (IR, RGB;
     one thread, and the loader alone over 30 batches of the files
     cycled); the eval loop over those 30 batches from memory and from the
     files at 8 and 2 loader threads (the first batch alone, then images/s
     and the device's idle share over the device's span; equal mIoU);
     ``serve`` over HTTP on 127.0.0.1 answering 320 16-bit PNG bodies
     from 16 keep-alive connections in a load process of its own (ids
     equal to the in-process forward of the same bytes outside
     near-ties; req/s, p50 and p95 latency) and a JPEG body with a 400;
     ``segmentation_evaluate`` through its ``main`` at batch 8, its mIoU
     equal to the in-memory eval of the same decoded arrays;
     ``segmentation_train`` through its ``main``, three steps at batch 8
     (finite losses); PIL never imported. Then, in a process of its own
     where Pillow is installed, the reader, the IR window, the RGB, grey
     and label loads and their 512x256 resizes held to Pillow exactly,
     and the CPU tests of the reader and the resamplers run against it.
     Paths ``host_io_eval``, ``host_io_train`` and ``host_io_serve``.
     ``python3 chip_smoke.py --host-io-compare DIR`` measures the same
     numbers for the port in DIR (another checkout's root, e.g. an older
     commit that reads images with PIL) against this checkout's, in four
     processes (DIR, this, this, DIR);
 22. doctor: ``cli/doctor --check_backend true`` in a process of its own:
     PASS with the card's name and the kernels built and loaded;
 23. recipe: the accuracy gates' wiring run (``recipes/gates.py
     --smoke``) in this process, every stage through its CLI's ``main`` on
     files: a 16-frame GAN tree at the raw 320x960 size; the sem nets
     (``segmentation_train``, layers 1,1,1,1, RGB ``three_channels`` and
     IR); the full-width CycleGAN (ngf 64, contour and module2 sem losses,
     ``-max_steps 2``) through ``main`` (a 1-step baseline, then resumed
     with ``-load_model``) and ``main_gan``; ``translator`` and
     ``distance_evaluate`` after each; the per-class fidelity;
     ``segmentation_train`` on the translations, ``segmentation_evaluate``,
     ``generate_pseudo_label`` (soft and hard, flip), ``cal_prototype``,
     ``self_train_main`` and the final evaluation. Checks one translation
     a source frame, one pseudo-label file a target frame and mode, a
     finite (13, feature width) prototype file, every checkpoint loading,
     L1, SSIM and mIoU finite and in range, and the final CLI mIoU equal
     to the in-memory eval of the same checkpoint on the same decoded
     arrays. Path ``recipe``.
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
# self-training's teacher: the stride-8 logits of a batch-4 320x700 frame
# to full/4 size, the classes of the moving prototypes
TEACHER_SHAPE, TEACHER_OUT = (4, 41, 88, 13), (80, 175)
# the GAN's t2s labels: the frozen thermal net's stride-8 logits of a
# batch-4 256x512 crop to the crop's size
GAN_SHAPE, GAN_OUT = (4, 33, 65, 13), (256, 512)
# the same with -sem_mode legacy: the 19-class legacy thermal net's logits
GAN_LEGACY_SHAPE = (4, 33, 65, 19)
# (shape, out_hw, strided): "strided" holds the logits as NCHW-contiguous
# memory viewed as NHWC, so the kernel reads them through general strides
PARITY_CASES = [
    (SERVE_SHAPE, SERVE_OUT, False),
    *[(s, s[1:3], False) for s in IDENTITY_SHAPES],
    (TEACHER_SHAPE, TEACHER_OUT, False),
    (GAN_SHAPE, GAN_OUT, False),
    (GAN_LEGACY_SHAPE, GAN_OUT, False),
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
# self-training: -batch_size 4, 8 steps an epoch (36 target and source
# images, so the epoch's only validation is its first step's), 8 test
# images (2 validation batches); the CLI's lr
ST_BATCH, ST_STEPS, ST_IMAGES, ST_VAL_IMAGES = 4, 8, 36, 8
ST_FULL_HW = (320, 700)
ST_LR = 1e-6
ST_CHECK_MOMENTUM = 0.5      # the float64 check's step: a visible fold
# the EMA teacher against float64, in float32 ulps of the largest of its
# two terms and the result: where the terms cancel (a parameter near 0)
# the result's ulp is far below either term's rounding, in the JAX
# package's arithmetic too (tests/test_torch_ema.py)
EMA_ULPS = 2.0
# the GAN: -batch_size 4, 8 steps an epoch (36 source and target images),
# the CLI's default lr; the translator: batch 8 to 320x700 (5 batches and
# a tail)
GAN_BATCH, GAN_STEPS, GAN_IMAGES = 4, 8, 36
GAN_METRIC_RTOL, GAN_STATS_ATOL = 1e-4, 1e-5   # the CPU test's
GAN_GRAD_RTOL = 1e-4
TRANSLATE_IMAGES, TRANSLATE_BATCH = 44, 8
TRANSLATE_HW = (320, 700)
# the distance eval over the translate phase's PNGs: the CLI's default
# batch 1, then 8; held to float64
DISTANCE_BATCHES = (1, 8)
SSIM_ATOL, DISTANCE_RTOL = 1e-5, 1e-5
# the dist phase: 40 source images split 32 / 8 (4 train steps of 8, one
# val batch), 8 target images (one batch); the timed steps of each remat
# mode; its gradients against none's, relative to each tensor's largest
DIST_SOURCE, DIST_TARGET, DIST_TIMED_STEPS = 40, 8, 5
REMAT_MODES = ("none", "dots", "full")
# ten times the card's own run-to-run gradient noise (two 'none' passes:
# 4.9e-5, cuDNN's backward sums in no fixed order)
REMAT_GRAD_RTOL = 5e-4
PREEMPT_AT_POLL = 3          # SIGTERM before the third step
# two ranks over gloo, a tiny model: 2 images each in the step, 5 images
# to validate and 6 pairs to score at batch 1, 8 prototype images at 2
GLOO_WORLD, GLOO_LOCAL, GLOO_VAL, GLOO_PAIRS, GLOO_PROTO = 2, 2, 5, 6, 8
GLOO_TIMEOUT = 600
GLOO_METRIC_RTOL, GLOO_BUFFER_ATOL = 1e-6, 1e-5
# the two-rank sync step's gradients against a float64 one-rank step, in
# units of the largest gradient, may be off by twice the float32 one-rank
# step's own error plus this. On the CPU both float32 steps are 4e-4 off
# (conv1), the two ranks' other tensors under 3e-5; a backward that skips
# the all-reduce is 1.2e-2 off. Held to each tensor's own largest instead,
# one rank's float32 error alone reaches 5% on gradients ~1e-3 of the
# largest, and the ranks' sum over rank order moves near-cancelling ones
GLOO_GRAD_ATOL = 1e-4
# the self_train_dist and gan_dist phases: a few steps a run through the
# CLI loops under --distributed; the tiny two-rank self-training step's
# pseudo-label threshold (rank 1's flat soft maps fall under it) and the
# tiny GAN's pools (they swap from the second step); its metrics against
# one rank: Canny's edge decisions may part at float noise between batch
# shapes, each moving a contour L1 by ~1/32768 of the 4 x 64 x 128 pixels
DIST_STEPS = 4
GLOO_ST_THRESHOLD, GLOO_POOL, GLOO_GAN_RTOL = 0.3, 2, 1e-3
# the two-rank self-training step's gradients against float64, in units of
# the largest, may be off by twice one rank's error plus this: on the CPU
# the two ranks are 3.4e-4 off at conv1.weight (the synchronised BN's
# one-pass variance, E[x^2] - E[x]^2 as flax computes it), one rank
# 7.5e-5; without the gradient all-reduce 0.6, without the synchronised
# BN 0.12
GLOO_ST_GRAD_ATOL = 1e-3
# the two-rank GAN step's first gradients against one rank's on the joined
# batch, in units of the largest, and their global norm (the CPU test's
# rtol): summing where the ranks should average, or averaging where they
# should sum, puts both off by a half
GLOO_GAN_GRAD_ATOL, GLOO_GAN_NORM_RTOL = 1e-3, 1e-3
# the data_parallel phase: two replicas on the one card; prototypes of one
# batch of 64, 3 server batches of 8, 16 translated frames
DP_REPLICAS, DP_PROTO_IMAGES, DP_SERVE_BATCHES, DP_TRANSLATE_IMAGES = (
    2, 64, 3, 16)
# the export phase: the ids artifact's batches (12 runs as 8 + 4: the
# program takes at most 8 rows a call at 256x512); the int8 container's
# bytes against the float artifact's may be at most this
EXPORT_BATCHES = (3, 8, 12)
INT8_MAX_RATIO = 0.4
# the serving phases: the serve phase's traffic (24 requests from 4
# threads at batch 8); the one-rank serve --distributed answers a batch
SERVE_REQUESTS, SERVE_THREADS, SERVE_BATCH = 24, 4, 8
# serve_artifact's traffic: turns of 96 requests (12 batches) through the
# live server and the artifact's; the first turn of each warms it and is not
# counted, then each goes first in one or two of the pairs
ARTIFACT_REQUESTS = 96
WARM_TURNS = ("live", "artifact")
SERVE_TURNS = ("live", "artifact", "artifact", "live", "live", "artifact")
# grey levels: a translated pixel whose float64 value lies this close to an
# integer may truncate either side between two batch compositions
TRANSLATE_SERVE_SLACK = 1e-3
# the spatial phase: the full-width model's step at batch 8, 256x512, on a
# data 1 x spatial 2 mesh of two gloo ranks on the one card (each rank 8
# rows x 256 columns), held to the plain step on the joined batch. In
# float32 (which gives the memory and the times): the loss rtol 1e-5 (the
# CPU test's) and the gradients against a float64 plain step, in units of
# its largest gradient, at most twice the float32 plain step's own error
# plus 5e-4 (at full width the float32 plain step is itself some 4e-2 of
# the largest gradient from float64). In float64: every gradient tensor
# within 5e-4 of its own largest value of the float64 plain step's. The
# timed steps after the checked one
SPATIAL_WORLD, SPATIAL_SEED, SPATIAL_TIMED_STEPS = 2, 31, 3
SPATIAL_GRAD_ATOL = 5e-4
SPATIAL_TIMEOUT = 600
# the checkpoint phase: the full-width model's train state after one
# batch-8 step (seed-32 images); steps timed (median, after two warm-ups)
# without a write, and at most CKPT_MAX_STEPS while one is in flight; the
# sharded checkpoint over two gloo ranks on the card
CKPT_SEED, CKPT_STEPS, CKPT_MAX_STEPS = 32, 3, 20
CKPT_WORLD, CKPT_TIMEOUT = 2, 600


def fail(msg: str) -> None:
    print(f"FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


# each phase's key numbers for the closing summary, filled by ``note``
NOTES: dict = {}


def note(phase: str, **numbers) -> None:
    """Keep ``numbers`` (6 significant digits) as ``phase``'s key numbers
    for the summary that closes the run."""
    NOTES.setdefault(phase, {}).update(
        {k: float(f"{v:.6g}") if isinstance(v, float) else v
         for k, v in numbers.items()})


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
    note("kernels", serve_shape_ms=kernel_ms, bound_ms=bound_ms,
         library_ms=library_ms)
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
    # self-training's teacher and the GAN's t2s labels: the library call
    # computing the same function is F.interpolate + softmax().max()
    teacher = upsampled_shape_times(TEACHER_SHAPE, TEACHER_OUT, gen)
    gan = upsampled_shape_times(GAN_SHAPE, GAN_OUT, gen)
    gan_legacy = upsampled_shape_times(GAN_LEGACY_SHAPE, GAN_OUT, gen)
    return [{
        "name": "upsample_argmax", "route": "cuda",
        "source": "thermal_semantic_segmentation_torch/csrc/upsample_argmax.cu",
        "replaces": "thermal_semantic_segmentation_tpu/ops/pallas_kernels.py:64",
        "shape": f"{SERVE_SHAPE}->{SERVE_OUT}", "launches": None,
        "max_abs_err": max_err, "ms": kernel_ms, "kernel_ms": kernel_ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": library_ms, "identity_shapes": identity,
        "teacher_shape": teacher, "gan_shape": gan,
        "gan_legacy_shape": gan_legacy,
    }]


def upsampled_shape_times(shape, out_hw, gen) -> dict:
    """The kernel, its plain version and F.interpolate + softmax().max() at
    (shape -> out_hw), with the bound; printed and returned."""
    import torch
    import torch.nn.functional as F

    from thermal_semantic_segmentation_torch.kernels.upsample_argmax import (
        upsample_argmax, upsample_argmax_reference)
    y = torch.randn(shape, generator=gen).cuda()
    y_nchw = y.permute(0, 3, 1, 2)

    def library():
        up = F.interpolate(y_nchw, size=out_hw, mode="bilinear",
                           align_corners=True)
        return torch.softmax(up, dim=1).max(dim=1)

    k_ms = time_ms(lambda: upsample_argmax(y, *out_hw))
    p_ms = time_ms(lambda: upsample_argmax_reference(y, *out_hw))
    l_ms = time_ms(library)
    b_ms, b_by = upsample_argmax_bound(shape, out_hw)
    print(f"upsample_argmax {shape}->{out_hw}: kernel {k_ms} ms "
          f"(bound_share {b_ms / k_ms:.4f}), plain {p_ms} ms, library "
          f"F.interpolate + softmax().max() {l_ms} ms, bound {b_ms} ms "
          f"({b_by})", flush=True)
    return {"shape": f"{shape}->{out_hw}", "ms": k_ms, "plain_ms": p_ms,
            "library_ms": l_ms, "bound_ms": b_ms, "bound_by": b_by}


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
    note("serve", req_per_s=n_requests / serve_s,
         mean_batch=server.requests_served / server.batches_run)
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
    note("eval", images_per_s=EVAL_IMAGES / eval_s)
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
    note("train", f32_images_per_s=h["train_images"] / h["train_s"],
         bf16_images_per_s=bf["train_images"] / bf["train_s"],
         peak_gib=peak_gb)
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


def read_png_ids(path):
    """The pixels of an 8-bit grayscale or palette PNG of filter-0 rows
    (what ``data/png.py`` writes), decoded here with zlib alone; ``path``:
    a file, or the PNG's bytes."""
    import struct
    import zlib

    import numpy as np
    if isinstance(path, bytes):
        data, path = path, f"a {len(path)}-byte answer"
    else:
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
        note("pseudo", **{f"{mode}_images_per_s": rate})
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
    fh, fw = logits.shape[1:3]
    vectors, valid = masked_class_means(
        feat, *upsample_argmax(logits, fh, fw), num_classes=NUM_CLASSES)
    # the kernel's classes included, as a prototype step takes them
    means_ms = time_ms(lambda: masked_class_means(
        feat, *upsample_argmax(logits, fh, fw), num_classes=NUM_CLASSES),
        reps=10)
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
    note("prototypes", images_per_s=PROTO_IMAGES / secs,
         forward_ms=forward_ms)
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


class SeededSelfTrainTarget:
    """What ``Freiburg(self_train=True)`` gives with ``SelfTrainAugment``
    at the CLI's defaults, made with numpy from (seed, index): a 256x512
    crop of the frame and its label, the 320x700 frame itself, soft maps
    (13, 256, 512) that sum to 1, hard labels that are ignore but for two
    blocks of the kept classes 5 and 11, and the recorded draws (every
    other sample flipped)."""

    def __init__(self, n: int, seed: int):
        self.n, self.seed = n, seed

    def __len__(self) -> int:
        return self.n

    def get(self, index: int, rng) -> dict:
        import numpy as np
        rng = np.random.default_rng((self.seed, index))
        th, tw = SERVE_OUT
        fh, fw = ST_FULL_HW
        w = int(rng.uniform(0.5, 1.5) * 1200)
        h = int(w / (fw / fh))
        if w < tw or h < th:
            resized, crop = (th, tw), (0, th, 0, tw)
        else:
            y1, x1 = int(rng.integers(0, h - th + 1)), int(
                rng.integers(0, w - tw + 1))
            resized, crop = (h, w), (y1, y1 + th, x1, x1 + tw)
        soft = rng.random((NUM_CLASSES, th, tw), dtype=np.float32) ** 4
        soft /= soft.sum(0)
        hard = np.full((th, tw), IGNORE, np.int64)
        hard[20:90, 40:200] = 5
        hard[150:230, 300:480] = 11
        label = rng.integers(0, NUM_CLASSES, (th, tw))
        return {"image": rng.random((th, tw, 1), dtype=np.float32),
                "label": label, "label_hard": hard, "label_soft": soft,
                "image_full": rng.random((fh, fw, 1), dtype=np.float32),
                "weak_params": {
                    "resized_hw": np.array(resized, np.int32),
                    "crop": np.array(crop, np.int32),
                    "flip": np.bool_(index % 2 == 0)}}


def phase_self_train(card: str, root: str) -> dict:
    """Self-train the full-width model through the self-training CLI's
    epoch loop on seeded in-memory data and check it; returns the
    kernels' launch counts from the two epochs."""
    import math
    import os

    import numpy as np
    import torch

    from thermal_semantic_segmentation_torch.cli._common import (
        load_seg_checkpoint)
    from thermal_semantic_segmentation_torch.cli.cal_prototype import (
        prototype_path)
    from thermal_semantic_segmentation_torch.cli.options import (
        self_train_parse)
    from thermal_semantic_segmentation_torch.cli.self_train_main import (
        self_train_epochs)
    from thermal_semantic_segmentation_torch.core.checkpoint import (
        save_checkpoint)
    from thermal_semantic_segmentation_torch.data.loader import DataLoader
    from thermal_semantic_segmentation_torch.kernels.upsample_argmax import (
        upsample_argmax)
    from thermal_semantic_segmentation_torch.utils.logging import get_logger

    source = SeededImages(ST_IMAGES, SERVE_OUT, seed=7)
    target = SeededSelfTrainTarget(ST_IMAGES, seed=8)
    test = SeededImages(ST_VAL_IMAGES, SERVE_OUT, seed=9)
    val_batches = math.ceil(ST_VAL_IMAGES / ST_BATCH)
    protos0 = (np.random.default_rng(10).standard_normal(
        (NUM_CLASSES, 256)) * 0.1).astype(np.float32)
    save_checkpoint(prototype_path(root, "freiburg_ir", "smoke.pth"),
                    {"objective_vectors": protos0,
                     "counts": np.zeros(NUM_CLASSES, np.float32)})
    logger = get_logger(os.path.join(root, "logs", "self-training"))

    def run(checkpoint):
        args = self_train_parse().parse_args(
            ["--root", root, "--model_root_path", root, "-checkpoint_name",
             checkpoint, "-new_checkpoint_name", "smoke_st.pth", "--epochs",
             "1", "-max_steps", str(ST_STEPS), "-batch_size", str(ST_BATCH)])
        loaders = [DataLoader(data, ST_BATCH, shuffle=shuffle,
                              drop_last=shuffle, seed=args.seed + k)
                   for k, (data, shuffle) in enumerate(
                       ((source, True), (target, True), (test, False)))]
        state, history = self_train_epochs(args, logger, *loaders)
        return args, state, history

    upsample_argmax.launches = 0      # counts from the main path only
    _, state, first = run("smoke.pth")
    saved_path = os.path.join(root, "lastsmoke_st.pth")
    state_dict, meta = load_seg_checkpoint(saved_path)
    ckpt_diff = [k for k, v in state.model.state_dict().items()
                 if not torch.equal(state_dict[k], v.cpu())]
    round_trip = (not ckpt_diff and torch.equal(
        meta["objective_vectors"], state.prototypes.cpu())
        and meta["highest_mean_iu"] == first[0]["best_at_end"]
        and meta["epoch"] == first[0]["epoch"])
    del state, state_dict
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    args, state, second = run("lastsmoke_st.pth")
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    launches = {"upsample_argmax": upsample_argmax.launches}
    history = first + second
    dumps = sorted(os.listdir(os.path.join(root, "predictions", "smoke_st")))

    steps = sum(h["steps"] for h in history)
    validations = sum(len(h["validations"]) for h in history)
    losses = [x for h in history for pair in h["losses"] for x in pair]
    print(f"self_train check: epochs {[h['epoch'] for h in history]}, steps "
          f"{[h['steps'] for h in history]}, validations "
          f"{[h['validations'] for h in history]}, losses (pseudo, source) "
          f"{[h['losses'] for h in history]}; checkpoint round trip "
          f"{'equal' if round_trip else 'DIFFERS'} (epoch {meta['epoch']}, "
          f"highest_mean_iu {meta['highest_mean_iu']}, resumed best "
          f"{second[0]['best_at_start']}); dumps {dumps}; launches "
          f"{launches} for {steps} steps and {validations} validations of "
          f"{val_batches} batches", flush=True)
    if [h["epoch"] for h in history] != [1, 2] or \
            [h["steps"] for h in history] != [ST_STEPS, ST_STEPS]:
        fail(f"self-training ran epochs {[h['epoch'] for h in history]}")
    if not (losses and all(map(math.isfinite, losses))):
        fail("self-training: a non-finite or missing loss")
    if not round_trip or second[0]["best_at_start"] != meta[
            "highest_mean_iu"]:
        fail(f"the self-training checkpoint does not round-trip: "
             f"{ckpt_diff[:5]}")
    if dumps != ["0_groundtruth.png", "0_image.png", "0_prediction_0.png"]:
        fail(f"save_one dumps: {dumps}")
    if launches["upsample_argmax"] != steps + validations * val_batches:
        fail(f"upsample_argmax launched {launches['upsample_argmax']} times "
             f"for {steps} steps and {validations * val_batches} validation "
             f"batches")

    batch = next(iter(self_train_batches(target, source)))
    self_train_float64_check(state, batch)
    self_train_step_parity()
    h = second[0]
    print(f"self_train: epoch {h['epoch']}, {h['target_images']} target "
          f"images in {h['steps']} steps of {ST_BATCH} at "
          f"{h['target_images'] / h['train_s']:.2f} images/s "
          f"({h['train_s']:.3f} s of steps, validation apart), float32, on "
          f"{card}", flush=True)
    n_params = sum(p.numel() for p in state.model.parameters())
    print(f"self_train peak device memory: {peak_gb:.3f} GiB "
          f"(torch.cuda.max_memory_allocated over the resumed epoch; student "
          f"and teacher of {n_params} parameters each) on {card}", flush=True)
    note("self_train", images_per_s=h["target_images"] / h["train_s"],
         peak_gib=peak_gb)
    breakdown = self_train_breakdown(state, batch)
    print(f"self_train step breakdown: {json.dumps(breakdown)} on {card}",
          flush=True)
    # the epoch loop's step (host data, copies and Python included) against
    # the device work of one step: the share of the loop the card is busy
    loop_ms = h["train_s"] / h["steps"] * 1e3
    device_ms = sum(v for k, v in breakdown.items()
                    if k not in ("wall_ms", "device_idle_share"))
    print(f"self_train loop: {loop_ms:.3f} ms a step in the resumed epoch "
          f"against {device_ms:.3f} ms of device work a step in the "
          f"breakdown: device busy ~{device_ms / loop_ms:.3f} of the loop, on "
          f"{card}", flush=True)
    return launches


def self_train_batches(target, source):
    """The CLI's merged batches of ``target`` and ``source`` on the card."""
    from thermal_semantic_segmentation_torch.cli.self_train_main import (
        merged_batches)
    from thermal_semantic_segmentation_torch.data.device_pipeline import (
        device_prefetch)
    from thermal_semantic_segmentation_torch.data.loader import DataLoader

    loaders = [DataLoader(d, ST_BATCH, shuffle=False) for d in (target,
                                                                 source)]
    return device_prefetch(merged_batches(*loaders), "cuda")


def run_step(step, state, b, **kw):
    return step(state, b["s_image"], b["s_label"], b["t_image"], b["t_full"],
                b["t_soft"], b["t_hard"], b["wp"], **kw)


def self_train_float64_check(state, b) -> None:
    """One more self-training step of the full-width model (its fold at
    momentum ``ST_CHECK_MOMENTUM``): the EMA teacher's parameters against
    ``0.999 old + 0.001 new`` in float64 within ``EMA_ULPS`` float32 ulps of
    the largest of the two terms and the result,
    its buffers equal to the student's; the prototypes against float64
    masked means and a sequential moving-average fold from the teacher's
    own features and the kernel's classes (rel err ``PROTO_RTOL``), the
    counts exact; the teacher's logits of the shape the kernels phase
    times."""
    import numpy as np
    import torch

    from thermal_semantic_segmentation_torch.kernels.upsample_argmax import (
        upsample_argmax, upsample_argmax_reference)
    from thermal_semantic_segmentation_torch.ops.resize import (
        resize_bilinear, upsample_logits)
    from thermal_semantic_segmentation_torch.train.self_train import (
        make_self_train_step)

    step = make_self_train_step(num_classes=NUM_CLASSES, ignore_index=IGNORE,
                                base_lr=ST_LR,
                                proto_momentum=ST_CHECK_MOMENTUM)
    every = [k for k, _ in state.teacher.named_parameters()]
    names = ["conv1.weight", every[len(every) // 2], "layer5.head.1.weight",
             "bn1.weight"]
    old = {k: v.detach().double().cpu()
           for k, v in state.teacher.named_parameters() if k in names}
    protos = state.prototypes.double().cpu().numpy()
    counts = state.proto_counts.double().cpu().numpy()
    seen = []
    hook = state.teacher.register_forward_hook(lambda m, i, out: seen.append(
        {k: v.float().permute(0, 2, 3, 1).clone() for k, v in out.items()}))
    run_step(step, state, b)
    hook.remove()
    torch.cuda.synchronize()

    new_student = dict(state.model.named_parameters())
    new_teacher = dict(state.teacher.named_parameters())
    # the error in float32 ulps of the largest of the two terms and the
    # result, the bound; beside it, for the record, the error in ulps of
    # the result (past the bound where the terms cancel: one run read 8.1)
    # and that reading's worst element's terms
    ema_ulps = term_ulps = 0.0
    worst = None
    for k in names:
        kept = 0.999 * old[k]
        added = 0.001 * new_student[k].detach().double().cpu()
        want = kept + added
        got = new_teacher[k].detach().double().cpu()

        def ulps(of):
            return (got - want).abs() / torch.from_numpy(np.spacing(
                of.float().abs().numpy())).double()

        result = ulps(want)
        i = int(result.argmax())
        if float(result.flatten()[i]) >= ema_ulps:
            ema_ulps = float(result.flatten()[i])
            worst = (k, i, *(float(t.flatten()[i])
                             for t in (kept, added, want, got)))
        term_ulps = max(term_ulps, float(ulps(torch.maximum(torch.maximum(
            kept.abs(), added.abs()), want.abs())).max()))
    buffers_equal = all(torch.equal(a, b_) for a, b_ in zip(
        state.teacher.buffers(), state.model.buffers()))

    logits = seen[0]["out"]
    fh, fw = b["t_full"].shape[1] // 4, b["t_full"].shape[2] // 4
    pred, _ = upsample_argmax(logits, fh, fw)
    want_pred, _ = upsample_argmax_reference(logits, fh, fw)
    top2 = upsample_logits(logits, fh, fw).topk(2, dim=-1).values
    decided = (top2[..., 0] - top2[..., 1]) > TIE_GAP
    wrong = int(((pred != want_pred) & decided).sum())
    feat = resize_bilinear(seen[0]["feat"], fh, fw).double().cpu().numpy()
    pred = pred.cpu().numpy()
    n = feat.shape[0]
    for i in range(n):
        onehot = (pred[i].reshape(-1)[:, None] == np.arange(NUM_CLASSES))
        cnt = onehot.sum(0)
        vec = (onehot.T.astype(np.float64) @ feat[i].reshape(fh * fw, -1)) \
            / np.maximum(cnt, 1)[:, None]
        ok = (cnt >= 10) & (vec.sum(1) != 0.0)
        protos[ok] = (protos[ok] * (1.0 - ST_CHECK_MOMENTUM)
                      + ST_CHECK_MOMENTUM * vec[ok])
        counts[ok] = np.minimum(counts[ok] + 1.0, 3000.0)
    got = state.prototypes.double().cpu().numpy()
    rel_err = float(np.abs(got - protos).max() / np.abs(protos).max())
    counts_equal = np.array_equal(state.proto_counts.cpu().numpy(), counts)
    print(f"self_train float64 check: teacher logits "
          f"{tuple(logits.shape)} -> ({fh}, {fw}); EMA teacher vs float64 "
          f"{term_ulps:.3f} float32 ulps of the largest term over {names} "
          f"({ema_ulps:.3f} ulps of the result; its worst element {worst[0]}[{worst[1]}]: kept "
          f"{worst[2]!r}, added {worst[3]!r}, want {worst[4]!r}, got "
          f"{worst[5]!r}), buffers "
          f"{'equal' if buffers_equal else 'DIFFER'}; kernel classes vs "
          f"plain outside {int((~decided).sum())} near-ties: {wrong} pixels; "
          f"prototypes rel err {rel_err:.3g}, counts "
          f"{state.proto_counts.cpu().numpy().astype(int).tolist()} "
          f"({'equal' if counts_equal else counts.tolist()})", flush=True)
    note("self_train", ema_ulps=ema_ulps, ema_term_ulps=term_ulps)
    if tuple(logits.shape) != TEACHER_SHAPE or (fh, fw) != TEACHER_OUT:
        fail(f"the teacher's logits {tuple(logits.shape)} -> ({fh}, {fw}) "
             f"are not the kernels phase's {TEACHER_SHAPE} -> {TEACHER_OUT}")
    if term_ulps > EMA_ULPS or not buffers_equal:
        fail(f"EMA teacher: {term_ulps} ulps of the largest term, buffers "
             f"equal {buffers_equal}")
    if wrong:
        fail(f"the teacher's kernel classes disagree at {wrong} pixels")
    if not (rel_err <= PROTO_RTOL and counts_equal and counts.sum() > 0):
        fail(f"moving prototypes vs float64: rel err {rel_err}, counts "
             f"{state.proto_counts.tolist()} vs {counts.tolist()}")


def self_train_step_parity() -> None:
    """One self-training step of a tiny model (layers 1,1,1,1, label_hw
    64x128, 80x176 frames, batch 2, dropout off, fold momentum
    ``ST_CHECK_MOMENTUM``, lr ``TRAIN_LR``) on the card and on the CPU
    from the same weights and batch: losses within rtol ``LOSS_RTOL``;
    each parameter inside one step's lr envelope wherever the CPU's
    gradient is at least 1e-4 (elsewhere float noise may flip the sign of
    Adam's first step: at most 0.05% outside, none past 2 x lr); the EMA
    teacher within 0.001 x 2 lr, BatchNorm buffers within lr; prototypes
    rel err ``PROTO_RTOL``, counts equal."""
    import numpy as np
    import torch

    from thermal_semantic_segmentation_torch.models.deeplab import (
        create_deeplab)
    from thermal_semantic_segmentation_torch.train.self_train import (
        create_self_train_state, make_self_train_step)

    rng = np.random.default_rng(11)
    hw, full = PARITY_HW, (80, 176)
    soft = rng.random((2, NUM_CLASSES, *hw), dtype=np.float32) ** 4
    hard = np.full((2, *hw), IGNORE, np.int64)
    hard[0, 10:30, 20:60], hard[1, 40:60, 90:120] = 5, 11
    batch = {"s_image": rng.random((2, *hw, 1), dtype=np.float32),
             "s_label": rng.integers(0, NUM_CLASSES, (2, *hw)),
             "t_image": rng.random((2, *hw, 1), dtype=np.float32),
             "t_full": rng.random((2, *full, 1), dtype=np.float32),
             "t_soft": soft / soft.sum(1, keepdims=True), "t_hard": hard,
             "wp": {"resized_hw": np.array([[96, 160], [120, 200]], np.int32),
                    "crop": np.array([[8, 72, 16, 144], [4, 68, 8, 136]],
                                     np.int32),
                    "flip": np.array([True, False])}}
    protos = (rng.standard_normal((NUM_CLASSES, 256)) * 0.1).astype(
        np.float32)
    out = {}
    for dev in ("cuda", "cpu"):
        model = create_deeplab(12, device=dev, layers=(1, 1, 1, 1))
        model.layer5.head[0].p = 0.0
        state = create_self_train_state(model, prototypes=protos,
                                        learning_rate=TRAIN_LR, device=dev)
        step = make_self_train_step(
            num_classes=NUM_CLASSES, ignore_index=IGNORE, base_lr=TRAIN_LR,
            train_thred=0.1, label_hw=hw, proto_momentum=ST_CHECK_MOMENTUM,
            device=dev)
        b = {k: ({kk: torch.from_numpy(vv).to(dev) for kk, vv in v.items()}
                 if isinstance(v, dict) else torch.from_numpy(v).to(dev))
             for k, v in batch.items()}
        lp, ls = run_step(step, state, b)
        out[dev] = dict(
            losses=[float(lp), float(ls)],
            grads={n: p.grad.detach().cpu() for n, p in
                   model.named_parameters()},
            student={k: v.detach().cpu() for k, v in
                     model.state_dict().items()},
            teacher={k: v.detach().cpu() for k, v in
                     state.teacher.state_dict().items()},
            protos=state.prototypes.cpu(), counts=state.proto_counts.cpu())
    card, cpu = out["cuda"], out["cpu"]
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(card["losses"],
                                                       cpu["losses"]))
    outside = total = 0
    worst = teacher_err = buffer_err = 0.0
    sure_ok = True
    for k, v in card["student"].items():
        diff = (v.double() - cpu["student"][k].double()).abs()
        tdiff = (card["teacher"][k].double()
                 - cpu["teacher"][k].double()).abs()
        if k in cpu["grads"]:
            ratio = diff / TRAIN_LR
            worst = max(worst, float(ratio.max()))
            outside += int((ratio > 1.0).sum())
            total += ratio.numel()
            sure = cpu["grads"][k].abs() >= 1e-4
            sure_ok &= bool((ratio[sure] <= 1.0).all())
            teacher_err = max(teacher_err, float(tdiff.max()))
        else:
            buffer_err = max(buffer_err, float(diff.max()), float(tdiff.max()))
    proto_err = float((card["protos"] - cpu["protos"]).abs().max()
                      / cpu["protos"].abs().max())
    counts_equal = torch.equal(card["counts"], cpu["counts"])
    print(f"self_train parity card vs CPU: losses {card['losses']} vs "
          f"{cpu['losses']} (rel err {loss_err:.3g}); {outside} of {total} "
          f"parameters outside the one-step lr envelope (worst {worst:.4f} "
          f"of it; those with a gradient >= 1e-4 "
          f"{'all inside' if sure_ok else 'NOT all inside'}); EMA teacher "
          f"max abs err {teacher_err:.3g}, BatchNorm buffers {buffer_err:.3g}; "
          f"prototypes rel err {proto_err:.3g}, counts "
          f"{'equal' if counts_equal else 'DIFFER'}", flush=True)
    if not loss_err <= LOSS_RTOL:
        fail("self-training step losses on the card differ from the CPU's")
    if (not sure_ok or outside > 5e-4 * total or worst > 2.01
            or not teacher_err <= 0.002 * TRAIN_LR + 1e-6
            or not buffer_err <= TRAIN_LR):
        fail("the card's self-training step left the CPU's lr envelope")
    if not (proto_err <= PROTO_RTOL and counts_equal):
        fail("the card's moving prototypes differ from the CPU's")


def self_train_breakdown(state, b, reps: int = 5) -> dict:
    """Median per-stage times of one batch-4 self-training step at the
    CLI's settings, its stages bracketed by CUDA events at the marks the
    step sets (teacher forward, rectification, the student's source and
    target passes, backward, Adam, masked means + fold, EMA); and the host
    wall time of the whole step, whose remainder is device idle time."""
    import numpy as np
    import torch

    from thermal_semantic_segmentation_torch.train.self_train import (
        make_self_train_step)

    step = make_self_train_step(num_classes=NUM_CLASSES, ignore_index=IGNORE,
                                base_lr=ST_LR, proto_momentum=1e-4)
    rows, stages = [], []
    for _ in range(reps):
        marks = []

        def mark(stage):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks.append((stage, ev))

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mark("start")
        run_step(step, state, b, mark=mark)
        marks[-1][1].synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        stages = [f"{name}_ms" for name, _ in marks[1:]]
        times = [a.elapsed_time(b_) for (_, a), (_, b_) in zip(marks,
                                                               marks[1:])]
        rows.append(times + [wall, 1.0 - sum(times) / wall])
    med = np.median(np.asarray(rows), axis=0)
    return dict(zip(stages + ["wall_ms", "device_idle_share"],
                    (float(v) for v in med)))



class SeededGanImages:
    """What the GAN CLI's ``_gan_transform`` gives, made with numpy from a
    seed: float32 (H, W, C) images in [-1, 1], and for the source int64
    (H, W) labels in 0..12 (the s2t semantic loss's)."""

    def __init__(self, n: int, hw, channels: int, seed: int,
                 labels: bool = False):
        import numpy as np
        rng = np.random.default_rng(seed)
        self.images = rng.uniform(-1, 1, (n, *hw, channels)).astype(
            np.float32)
        self.labels = rng.integers(0, NUM_CLASSES, (n, *hw)) if labels \
            else None

    def __len__(self) -> int:
        return len(self.images)

    def get(self, index: int, rng) -> dict:
        out = {"image": self.images[index]}
        if self.labels is not None:
            out["label"] = self.labels[index]
        return out


def gan_argv(root: str, mode: str, *extra) -> list:
    """The CLI flags of a gan phase: the CycleGAN at the recipe's widths
    with the contour and semantic losses; ``mode`` 'module2' (the JAX
    gates' configuration) or 'legacy' (the default -sem_mode, the
    reference's recipe)."""
    name = "smoke_gan.pth" if mode == "module2" else "smoke_gan_legacy.pth"
    sem = ["-sem_mode", "module2"] if mode == "module2" else []
    return ["-batch_size", str(GAN_BATCH), "-num_epoch", "1", "-max_steps",
            str(GAN_STEPS), "-checkpoint_name", name,
            "-new_checkpoint_name", name, "-with_contour", "true",
            "-sem_loss", "true", *sem,
            "-sem_checkpoint_s", f"{root}/sem_{mode}_s.pth",
            "-sem_checkpoint_t", f"{root}/sem_{mode}_t.pth",
            "--gan_model_root_path", root, *extra]


def phase_gan(card: str, root: str, mode: str = "module2") -> dict:
    """Train the full-width CycleGAN through the GAN CLI's epoch loop on
    seeded in-memory data and check it; returns the kernels' launch
    counts from the two epochs. ``mode``: the frozen sem nets, full-width
    ResNet-101s with random weights from seeds, RGB and thermal: 'module2'
    (13 classes, seg .pth files) or 'legacy' (19 classes, the legacy
    head, reference legacy .pth files)."""
    import math

    import torch

    from thermal_semantic_segmentation_torch.cli._common import (
        load_gan_checkpoint)
    from thermal_semantic_segmentation_torch.cli.main import (
        gan_epochs, load_sem_nets)
    from thermal_semantic_segmentation_torch.cli.options import train_parse
    from thermal_semantic_segmentation_torch.data.loader import DataLoader
    from thermal_semantic_segmentation_torch.kernels.upsample_argmax import (
        upsample_argmax)
    from thermal_semantic_segmentation_torch.models.convert import GAN_KEYS
    from thermal_semantic_segmentation_torch.models.deeplab import (
        create_deeplab)

    label = "gan" if mode == "module2" else "gan_legacy"
    shape = GAN_SHAPE if mode == "module2" else GAN_LEGACY_SHAPE
    for name, channels, seed in (("s", 3, 1), ("t", 1, 2)):
        path = f"{root}/sem_{mode}_{name}.pth"
        if mode == "module2":
            torch.save({"epoch": 0, "sem_net_state_dict": create_deeplab(
                seed, num_channels=channels).state_dict()}, path)
        else:
            torch.save(create_deeplab(seed, num_channels=channels,
                                      num_classes=19, head="legacy")
                       .state_dict(), path)
    source = SeededGanImages(GAN_IMAGES, SERVE_OUT, 3, seed=21, labels=True)
    target = SeededGanImages(GAN_IMAGES, SERVE_OUT, 1, seed=22)

    def run(load: bool):
        args = train_parse().parse_args(gan_argv(
            root, mode, "-load_model", str(load).lower()))
        loaders = [DataLoader(data, GAN_BATCH, shuffle=True, drop_last=True,
                              seed=args.seed + k)
                   for k, data in enumerate((source, target))]
        return (args, *gan_epochs(args, *loaders))

    upsample_argmax.launches = 0      # counts from the main path only
    args, state, first = run(False)
    ckpt = load_gan_checkpoint(f"{root}/{args.new_checkpoint_name}")
    ckpt_diff = [f"{key}/{k}"
                 for nets, keys in ((state.g, GAN_KEYS["g"]),
                                    (state.d, GAN_KEYS["d"]))
                 for name, key in keys
                 for k, v in nets[name].state_dict().items()
                 if not torch.equal(ckpt[key][k], v.cpu())]
    round_trip = not ckpt_diff and ckpt["epoch"] == first[0]["epoch"]
    del state, ckpt
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    args, state, second = run(True)
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    launches = {"upsample_argmax": upsample_argmax.launches}
    history = first + second

    steps = sum(h["steps"] for h in history)
    values = [x for h in history for v in h["metrics"].values() for x in v]
    print(f"{label} check: epochs {[h['epoch'] for h in history]}, steps "
          f"{[h['steps'] for h in history]}, metrics "
          f"{[{k: [round(x, 5) for x in v] for k, v in h['metrics'].items()} for h in history]}; "
          f"checkpoint round trip {'equal' if round_trip else 'DIFFERS'}; "
          f"launches {launches} for {steps} steps", flush=True)
    if [h["epoch"] for h in history] != [0, 0] or \
            [h["steps"] for h in history] != [GAN_STEPS, GAN_STEPS]:
        fail(f"the GAN ran epochs {[h['epoch'] for h in history]}, steps "
             f"{[h['steps'] for h in history]}")
    if len(history[0]["metrics"]) != 11 or not all(
            map(math.isfinite, values)):
        fail("the GAN: a non-finite or missing loss")
    if not round_trip:
        fail(f"the GAN checkpoint does not round-trip: {ckpt_diff[:5]}")
    if launches["upsample_argmax"] != steps:
        fail(f"upsample_argmax launched {launches['upsample_argmax']} "
             f"times for {steps} GAN steps")

    batch = next(iter(gan_batches(source, target)))
    sem_nets = load_sem_nets(args, "cuda")
    gan_read_only_check(args, state, sem_nets, batch, shape)
    gan_step_parity(mode)
    h = second[0]
    print(f"{label}: epoch {h['epoch']} (resumed), {h['images']} source "
          f"images in {h['steps']} steps of {GAN_BATCH} at "
          f"{h['images'] / h['train_s']:.2f} images/s ({h['train_s']:.3f} s "
          f"of steps), float32, on {card}", flush=True)
    n_g = sum(p.numel() for net in state.g.values() for p in net.parameters())
    n_d = sum(p.numel() for net in state.d.values() for p in net.parameters())
    print(f"{label} peak device memory: {peak_gb:.3f} GiB "
          f"(torch.cuda.max_memory_allocated over the resumed epoch; "
          f"generators {n_g} and discriminators {n_d} parameters, two "
          f"frozen {mode} ResNet-101s) on {card}", flush=True)
    note(label, images_per_s=h["images"] / h["train_s"], peak_gib=peak_gb)
    breakdown = gan_breakdown(args, state, sem_nets, batch)
    print(f"{label} step breakdown: {json.dumps(breakdown)} on {card}",
          flush=True)
    loop_ms = h["train_s"] / h["steps"] * 1e3
    device_ms = sum(v for k, v in breakdown.items()
                    if k not in ("wall_ms", "device_idle_share"))
    print(f"{label} loop: {loop_ms:.3f} ms a step in the resumed epoch "
          f"against {device_ms:.3f} ms of device work a step in the "
          f"breakdown: device busy ~{device_ms / loop_ms:.3f} of the loop, "
          f"on {card}", flush=True)
    return launches


def gan_batches(source, target):
    """The CLI's merged batches of ``source`` and ``target`` on the card."""
    from thermal_semantic_segmentation_torch.cli.main import merged_batches
    from thermal_semantic_segmentation_torch.data.device_pipeline import (
        device_prefetch)
    from thermal_semantic_segmentation_torch.data.loader import DataLoader

    loaders = [DataLoader(d, GAN_BATCH, shuffle=False) for d in (source,
                                                                 target)]
    return device_prefetch(merged_batches(*loaders, True), "cuda")


def gan_step_kwargs(args, sem_nets) -> dict:
    return dict(cycle=args.cycle, with_contour=args.with_contour,
                grayscale_source=args.grayscale,
                canny_rgb_threshold=args.canny_rgb_threshold,
                canny_thermal_threshold=args.canny_thermal_threshold,
                sem_nets=sem_nets, sem_norm=args.sem_mode, bf16=args.bf16)


def gan_read_only_check(args, state, sem_nets, b, shape) -> None:
    """One more G update of the full-width nets: D's buffers bit for bit
    what they were, D's parameters without a gradient; the t2s ids the
    step took from the kernel (recorded) against the plain version on the
    same logits outside near-ties, the logits of the kernels phase's
    ``shape``."""
    import torch

    from thermal_semantic_segmentation_torch.kernels.upsample_argmax import (
        upsample_argmax_reference)
    from thermal_semantic_segmentation_torch.ops.resize import (
        upsample_logits)
    from thermal_semantic_segmentation_torch.train import gan

    g_step, _ = gan.make_gan_steps(**gan_step_kwargs(args, sem_nets))
    before = {n: {k: v.clone() for k, v in net.state_dict().items()}
              for n, net in state.d.items()}
    for net in state.d.values():      # the last D step's gradients
        net.zero_grad(set_to_none=True)
    seen = []
    kernel = gan.upsample_argmax

    def recording(logits, h, w):
        out = kernel(logits, h, w)
        seen.append((logits.detach().clone(), out[0]))
        return out

    gan.upsample_argmax = recording
    try:
        g_step(state, b["real_s"], b["real_t"], b["label_s"], with_sem=True)
    finally:
        gan.upsample_argmax = kernel
    torch.cuda.synchronize()
    changed = [f"{n}/{k}" for n, net in state.d.items()
               for k, v in net.state_dict().items()
               if not torch.equal(v, before[n][k])]
    grads = [n for n, net in state.d.items()
             for p in net.parameters() if p.grad is not None]
    logits, ids = seen[0]
    want, _ = upsample_argmax_reference(logits, *GAN_OUT)
    top2 = upsample_logits(logits, *GAN_OUT).topk(2, dim=-1).values
    decided = (top2[..., 0] - top2[..., 1]) > TIE_GAP
    wrong = int(((ids != want) & decided).sum())
    print(f"gan G pass: D buffers {'unchanged' if not changed else changed[:5]}"
          f", D parameters with a gradient {len(grads)}; t2s labels from "
          f"logits {tuple(logits.shape)} -> {GAN_OUT}: {wrong} pixels off "
          f"the plain version outside {int((~decided).sum())} near-ties",
          flush=True)
    if changed or grads:
        fail(f"the G pass moved D: buffers {changed[:5]}, grads {grads[:5]}")
    if len(seen) != 1 or tuple(logits.shape) != shape:
        fail(f"the t2s labels came from {len(seen)} kernel calls on "
             f"{tuple(logits.shape)}, not one on {shape}")
    if wrong:
        fail(f"the t2s labels disagree with the plain version at {wrong} "
             f"pixels")


def gan_step_parity(mode: str) -> None:
    """One GAN update of tiny nets (U-Net-32 ngf 8, PatchGAN ndf 8, sem
    nets of ``mode`` at layers 1,1,1,1; batch 2 at 64x128, the contour and
    sem losses, the host pool) on the card, then on the CPU from the same
    weights with
    the card's discrete decisions replayed (``DecisionTape``): each metric
    within rtol ``GAN_METRIC_RTOL``, the BatchNorm statistics within
    ``GAN_STATS_ATOL``, every parameter inside one Adam step's lr envelope
    (at most 5e-4 of them outside, none past 2 x lr, none with a CPU
    gradient >= 1e-4: the CPU test's tolerances), the gradients' norm
    within ``GAN_GRAD_RTOL`` and the Canny masks parted on at most 0.5% of
    their pixels (the CPU test's boundary rule)."""
    r = gan_parity_run(mode)
    print(f"gan parity ({mode}) card vs CPU: metrics {r['card']} vs {r['cpu']} (max "
          f"rel err {r['metric_err']:.3g}); BatchNorm statistics max abs err "
          f"{r['stats_err']:.3g}; card decisions replayed on the CPU, parted "
          f"{r['parted']} of {r['decided']}; {r['outside']} of {r['total']} "
          f"parameters outside the one-step lr envelope (worst "
          f"{r['worst']:.4f} of it; {r['sure_out']} with a CPU gradient >= "
          f"1e-4; by tensor: {r['where'][:4]}); gradient norm rel err "
          f"{r['grad_norm_err']:.3g}", flush=True)
    if not r["metric_err"] <= GAN_METRIC_RTOL:
        fail("the card's GAN step metrics differ from the CPU's")
    if not r["stats_err"] <= GAN_STATS_ATOL:
        fail("the card's GAN step BatchNorm statistics differ from the CPU's")
    if r["parted"]["edges"] > 0.005 * r["decided"]["edges"]:
        fail("the card's Canny edges part from the CPU's on more than 0.5% "
             "of the pixels")
    if (r["outside"] > 5e-4 * r["total"] or r["worst"] > 2.001
            or r["sure_out"] or not r["grad_norm_err"] <= GAN_GRAD_RTOL):
        fail("the card's GAN step left the CPU's lr envelope")


class DecisionTape:
    """Every discrete decision of one GAN update in the order the update
    makes it: each ReLU/LeakyReLU input's sign, each max pool's argmax,
    each Canny edge mask and the t2s ids. Recording (the card's update)
    keeps them; replaying (the CPU's update from the same weights) makes
    the update take the recorded ones and counts where its own part from
    them. Float noise may put an input on the other side of a kink, and
    one parted decision moves a gradient by a whole term: replayed, the
    two updates differ by float noise alone."""

    def __init__(self):
        import collections

        self.tape, self.at = [], None
        self.decided = collections.Counter()
        self.parted = collections.Counter()

    def replay(self) -> None:
        self.at = 0

    def decide(self, kind: str, own):
        """The decision to take: ``own`` when recording, else the
        recorded one (on ``own``'s device)."""
        if self.at is None:
            self.tape.append((kind, own.cpu()))
            return own
        if self.at >= len(self.tape) or self.tape[self.at][0] != kind or \
                self.tape[self.at][1].shape != own.shape:
            fail(f"the CPU's GAN update made decision {self.at} ({kind}, "
                 f"{tuple(own.shape)}) out of the card's order")
        taken = self.tape[self.at][1].to(own.device)
        self.at += 1
        self.decided[kind] += own.numel()
        self.parted[kind] += int((taken != own).sum())
        return taken

    def attach(self, nets) -> None:
        """Route the activations and max pools of ``nets`` through the
        tape."""
        import functools

        import torch

        def activation(m, forward, x):
            sign = self.decide("relu", x > 0)
            if self.at is None:
                return forward(x)
            return torch.where(sign, x, x * getattr(m, "negative_slope", 0.0))

        def max_pool(m, x):
            out, idx = torch.nn.functional.max_pool2d(
                x, m.kernel_size, m.stride, m.padding, m.dilation,
                ceil_mode=m.ceil_mode, return_indices=True)
            idx = self.decide("maxpool", idx)
            if self.at is None:
                return out
            n, c = idx.shape[:2]
            return x.reshape(n, c, -1).gather(2, idx.reshape(n, c, -1)) \
                .reshape(idx.shape)

        for net in nets:
            for m in net.modules():
                if isinstance(m, (torch.nn.ReLU, torch.nn.LeakyReLU)):
                    m.forward = functools.partial(activation, m, m.forward)
                elif isinstance(m, torch.nn.MaxPool2d):
                    m.forward = functools.partial(max_pool, m)


def gan_parity_run(mode: str) -> dict:
    """One tiny GAN update on the card and on the CPU (see
    ``gan_step_parity``); the differences between the two."""
    import numpy as np
    import torch

    from thermal_semantic_segmentation_torch.models import factory
    from thermal_semantic_segmentation_torch.models.deeplab import (
        create_deeplab)
    from thermal_semantic_segmentation_torch.nn import canny
    from thermal_semantic_segmentation_torch.ops.image_pool import ImagePool
    from thermal_semantic_segmentation_torch.train import gan

    rng = np.random.default_rng(23)
    batch = {"real_s": rng.uniform(-1, 1, (2, *PARITY_HW, 3)),
             "real_t": rng.uniform(-1, 1, (2, *PARITY_HW, 1)),
             "label_s": rng.integers(0, NUM_CLASSES, (2, *PARITY_HW))}
    kernel, edge_mask = gan.upsample_argmax, canny._edge_mask
    tape = DecisionTape()

    def argmax(logits, h, w):
        ids, conf = kernel(logits, h, w)
        return tape.decide("ids", ids), conf

    gan.upsample_argmax = argmax
    canny._edge_mask = lambda *a: tape.decide("edges", edge_mask(*a))
    out = {}
    try:
        for dev in ("cuda", "cpu"):
            g = {"s2t": factory.unet_32(ngf=8, output_nc=1),
                 "t2s": factory.unet_32(ngf=8, input_nc=1, output_nc=3)}
            d = {"t": factory.patchgan(ndf=8), "s": factory.patchgan(
                ndf=8, input_nc=3)}
            for i, net in enumerate((*g.values(), *d.values())):
                factory.init_gan_net(net, 30 + i, device=dev)
            sem = {name: create_deeplab(
                40 + i, device=dev, num_channels=c, head=mode,
                num_classes=19 if mode == "legacy" else NUM_CLASSES,
                layers=(1, 1, 1, 1)).requires_grad_(False)
                for i, (name, c) in enumerate((("s", 3), ("t", 1)))}
            tape.attach((*g.values(), *d.values(), *sem.values()))
            if dev == "cpu":
                tape.replay()
            state = gan.create_gan_state(g_nets=g, d_nets=d,
                                         learning_rate=TRAIN_LR, device=dev)
            g_step, d_step = gan.make_gan_steps(
                cycle=True, with_contour=True, sem_nets=sem, sem_norm=mode)
            b = {k: torch.from_numpy(v.astype(np.float32)
                                     if v.dtype.kind == "f" else v).to(dev)
                 for k, v in batch.items()}
            metrics, outs = g_step(state, b["real_s"], b["real_t"],
                                   b["label_s"], with_sem=True)
            grads = {f"{n}.{k}": p.grad.detach().cpu()
                     for n, net in g.items() for k, p in net.named_parameters()}
            pools = {n: ImagePool(50, seed=i) for i, n in enumerate(("t", "s"))}
            metrics.update(d_step(state, {"t": b["real_t"], "s": b["real_s"]},
                                  {n: pools[n].query(outs[f"fake_{n}"])
                                   for n in ("t", "s")}))
            grads.update({f"{n}.{k}": p.grad.detach().cpu()
                          for n, net in d.items()
                          for k, p in net.named_parameters()})
            out[dev] = dict(
                metrics={k: float(v) for k, v in metrics.items()},
                sd={f"{n}.{k}": v.detach().cpu()
                    for n, net in {**g, **d}.items()
                    for k, v in net.state_dict().items()},
                params={f"{n}.{k}" for n, net in {**g, **d}.items()
                        for k, _ in net.named_parameters()},
                grads=grads)
    finally:
        gan.upsample_argmax, canny._edge_mask = kernel, edge_mask
    if tape.at != len(tape.tape):
        fail(f"the CPU's GAN update took {tape.at} of the card's "
             f"{len(tape.tape)} decisions")
    card, cpu = out["cuda"], out["cpu"]
    r = {"card": card["metrics"], "cpu": cpu["metrics"],
         "metric_err": max(abs(card["metrics"][k] - v) / abs(v)
                           for k, v in cpu["metrics"].items()),
         "decided": dict(tape.decided), "parted": dict(tape.parted),
         "outside": 0, "total": 0, "sure_out": 0, "worst": 0.0,
         "stats_err": 0.0, "where": []}
    err_sq = norm_sq = 0.0
    for k, v in cpu["sd"].items():
        if k.endswith("num_batches_tracked"):
            continue
        diff = (card["sd"][k].double() - v.double()).abs()
        if k not in cpu["params"]:
            r["stats_err"] = max(r["stats_err"], float(diff.max()))
            continue
        ratio = diff / TRAIN_LR
        bad = ratio > 1.0
        g_cpu = cpu["grads"][k].double()
        g_err = card["grads"][k].double() - g_cpu
        err_sq += float(g_err.norm()) ** 2
        norm_sq += float(g_cpu.norm()) ** 2
        r["worst"] = max(r["worst"], float(ratio.max()))
        r["outside"] += int(bad.sum())
        r["total"] += ratio.numel()
        r["sure_out"] += int((bad & (g_cpu.abs() >= 1e-4)).sum())
        if bad.any():
            r["where"].append((k, int(bad.sum()), ratio.numel()))
    r["where"].sort(key=lambda w: -w[1])
    r["grad_norm_err"] = (err_sq / norm_sq) ** 0.5
    return r


def gan_breakdown(args, state, sem_nets, b, reps: int = 5) -> dict:
    """Median per-stage times of one batch-4 GAN update at the CLI's
    settings (device pools), its stages bracketed by CUDA events at the
    marks the step sets: G forwards (with D's adversarial passes), Canny,
    the sem nets (three ResNet-101 forwards, the upsampled CE terms), G
    backward, G Adam, the pools, the D step; and the host wall time of the
    whole update, whose remainder is device idle time."""
    import numpy as np
    import torch

    from thermal_semantic_segmentation_torch.train import gan

    step, make_pools = gan.make_gan_step(pool_size=50, **gan_step_kwargs(
        args, sem_nets))
    pools = make_pools({"t": tuple(b["real_t"].shape[1:]),
                        "s": tuple(b["real_s"].shape[1:])}, device="cuda")
    rows, stages = [], []
    for _ in range(reps + 1):          # the first fills cuDNN's choices
        marks = []

        def mark(stage):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks.append((stage, ev))

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mark("start")
        step(state, pools, b["real_s"], b["real_t"], b["label_s"],
             with_sem=True, mark=mark)
        marks[-1][1].synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        stages = [f"{name}_ms" for name, _ in marks[1:]]
        times = [a.elapsed_time(b_) for (_, a), (_, b_) in zip(marks,
                                                               marks[1:])]
        rows.append(times + [wall, 1.0 - sum(times) / wall])
    med = np.median(np.asarray(rows[1:]), axis=0)
    return dict(zip(stages + ["wall_ms", "device_idle_share"],
                    (float(v) for v in med)))


class SeededFrames:
    """What the translator's dataset gives at ``Resize((512, 256))`` with
    ``-normalize 0.5 0.5 0.5``, made with numpy from a seed: float32
    (256, 512, 3) frames in [-1, 1], each with its PNG destination under
    ``root``."""

    def __init__(self, n: int, seed: int, root: str):
        import numpy as np
        self.images = np.random.default_rng(seed).uniform(
            -1, 1, (n, *SERVE_OUT, 3)).astype(np.float32)
        self.root = root

    def __len__(self) -> int:
        return len(self.images)

    def get(self, index: int, rng) -> dict:
        return {"image": self.images[index],
                "img_path": f"{self.root}/{index:04d}.png"}


def translate_float64(fake, fake32):
    """The translator's pixels from the float64 generator output ``fake``
    (N, H, W): de-normalised and truncated to 8 bits, then PIL's two
    rounded BICUBIC passes (width, then height). Returns (pixels, allowed,
    counts). A float32 run can part from float64 only at a decision whose
    float64 value lies within float32's error of its boundary: a
    truncation within ``tau_t`` of an integer, ``tau_t`` the float32
    generator's largest error against float64 on this batch (``fake32``)
    in grey levels; a rounding within ``tau_r`` of a half, ``tau_r`` the
    float32 accumulation bound of a pass (taps x 2^-23 x sum |w x|). Each
    such decision in a pixel's support can move it by one more level, so
    ``allowed`` is the count of them in the support, and 1 where there is
    none; ``counts`` says how many there were."""
    import numpy as np

    # PIL's BICUBIC weights (a = -0.5, widened when reducing), from PIL's
    # algorithm in the port's data/image.py
    from thermal_semantic_segmentation_torch.data.image import weight_matrix
    mh = weight_matrix(SERVE_OUT[1], TRANSLATE_HW[1])   # (out_w, w)
    mv = weight_matrix(SERVE_OUT[0], TRANSLATE_HW[0])   # (out_h, h)
    v = np.clip((fake * 0.5 + 0.5) * 255.0, 0, 255)
    tau_t = float(np.abs(fake32 - fake).max()) * 127.5
    frac = v - np.floor(v)
    near_t = (np.minimum(frac, 1.0 - frac) <= tau_t) & (v > 0) & (v < 255)
    x8 = np.floor(v)
    tau = {}
    for name, m in (("h", mh), ("v", mv)):
        taps = int((m != 0).sum(1).max())
        tau[name] = taps * 2.0 ** -23 * 255.0 * float(np.abs(m).sum(1).max())
    h = x8 @ mh.T                                         # (n, h, out_w)
    near_h = np.abs(h - np.floor(h) - 0.5) <= tau["h"]
    hr = np.clip(np.floor(h + 0.5), 0, 255)
    o = mv @ hr                                           # (n, out_h, out_w)
    near_v = np.abs(o - np.floor(o) - 0.5) <= tau["v"]
    want = np.clip(np.floor(o + 0.5), 0, 255)
    # the near decisions in each output pixel's support, by the supports'
    # indicator matrices
    sh, sv = (mh != 0).astype(np.float32), (mv != 0).astype(np.float32)
    k = (sv @ (near_t.astype(np.float32) @ sh.T) + sv @ near_h.astype(
        np.float32) + near_v)
    k = np.rint(k).astype(np.int64)
    counts = {"tau_t_levels": tau_t, "tau_r_levels": max(tau.values()),
              "truncations": int(near_t.sum()),
              "first_roundings": int(near_h.sum()),
              "second_roundings": int(near_v.sum()),
              "pixels_with_near_decisions": int((k > 0).sum()),
              "most_in_one_pixel": int(k.max())}
    return want, np.maximum(k, 1), counts


def phase_translate(card: str, root: str) -> None:
    """Translate seeded frames through the translator's batch loop from
    the gan phase's checkpoint; check the PNGs (zlib) against a float64
    recomputation of the first batch."""
    import copy
    import os

    import numpy as np
    import torch

    from thermal_semantic_segmentation_torch.cli._common import (
        build_generator_from_gan_checkpoint)
    from thermal_semantic_segmentation_torch.cli.translator import (
        translate_batches)
    from thermal_semantic_segmentation_torch.data.loader import DataLoader

    model, ngf = build_generator_from_gan_checkpoint(
        f"{root}/smoke_gan.pth", "s2t", input_nc=3, output_nc=1)
    out_dir = f"{root}/translation"
    frames = SeededFrames(TRANSLATE_IMAGES, seed=24, root=out_dir)
    kw = dict(denormalize=[0.5], save_hw=TRANSLATE_HW, suffix="",
              device="cuda")
    # a warm-up batch (cuDNN's choices), written elsewhere
    translate_batches(model, DataLoader(SeededFrames(
        TRANSLATE_BATCH, seed=25, root=f"{root}/warm"), TRANSLATE_BATCH),
        **kw)
    marks = []

    def mark(stage):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append((stage, ev))

    summary = translate_batches(
        model, DataLoader(frames, TRANSLATE_BATCH, shuffle=False,
                          drop_last=False), mark=mark, **kw)
    torch.cuda.synchronize()
    per = {"forward": [], "resize": []}
    for (_, a), (stage, b) in zip(marks, marks[1:]):
        if stage in per:      # batch -> forward -> resize
            per[stage].append(a.elapsed_time(b))
    files = sorted(os.listdir(out_dir))
    pixels = [read_png_ids(f"{out_dir}/{f}") for f in files]

    # float64: the generator, de-normalisation (truncated to 8 bits as the
    # JAX translator does) and PIL's two rounded resample passes
    model64 = copy.deepcopy(model).double()
    x = torch.from_numpy(frames.images[:TRANSLATE_BATCH]).cuda()
    with torch.inference_mode():
        fake = model64(x.double().permute(0, 3, 1, 2))[:, 0].cpu().numpy()
        fake32 = model(x.permute(0, 3, 1, 2))[:, 0].double().cpu().numpy()
    got = np.stack(pixels[:TRANSLATE_BATCH]).astype(np.int64)
    want, allowed, counts = translate_float64(fake, fake32)
    err = np.abs(got - want)
    print(f"translate check: {len(files)} PNGs of {pixels[0].shape} from a "
          f"ngf {ngf} generator; the first batch against float64: max "
          f"{int(err.max())} grey levels, {float((err > 0).mean()):.5f} of "
          f"pixels off, {int((err > 1).sum())} by more than 1; decisions "
          f"within float32's error of their boundary: {json.dumps(counts)}",
          flush=True)
    if files != [f"{i:04d}.png" for i in range(TRANSLATE_IMAGES)] or any(
            p.shape != TRANSLATE_HW for p in pixels):
        fail(f"the translator wrote {files[:3]}... of "
             f"{[p.shape for p in pixels[:2]]}")
    if (err > allowed).any():
        fail(f"translated pixels off float64 by more than their near "
             f"decisions allow: {int((err > allowed).sum())} pixels, worst "
             f"{int(err.max())} grey levels")
    n = summary["images"]
    breakdown = {"forward_ms": statistics.median(per["forward"]),
                 "resize_ms": statistics.median(per["resize"]),
                 "encode_ms_per_image": summary["encode_s"] / n * 1e3}
    print(f"translate: {n} frames at batch {TRANSLATE_BATCH} to "
          f"{TRANSLATE_HW} at {n / summary['seconds']:.2f} images/s "
          f"({summary['seconds']:.3f} s, every PNG written), on {card}",
          flush=True)
    note("translate", images_per_s=n / summary["seconds"],
         forward_ms=breakdown["forward_ms"])
    print(f"translate batch breakdown: {json.dumps(breakdown)} (median "
          f"over batches; encode on 2 writer threads) on {card}", flush=True)


class TranslationPairs:
    """The translate phase's PNGs (read back with zlib) as the distance
    eval's pairs: each with a seeded (H, W, 1) IR original in [0, 1] and a
    seeded label map in 0..11 (class 12 never appears: a nan) with 5%
    255, what ``DistanceDataset(with_label=True)`` gives."""

    def __init__(self, paths, seed: int):
        import numpy as np
        rng = np.random.default_rng(seed)
        self.paths = paths
        self.originals = rng.random((len(paths), *TRANSLATE_HW, 1),
                                    dtype=np.float32)
        self.labels = rng.integers(0, NUM_CLASSES - 1,
                                   (len(paths), *TRANSLATE_HW)).astype(
            np.int32)
        self.labels[rng.random(self.labels.shape) < 0.05] = 255

    def __len__(self) -> int:
        return len(self.paths)

    def get(self, index: int, rng) -> dict:
        import numpy as np
        trans = read_png_ids(self.paths[index]).astype(np.float32) / 255.0
        return {"original": self.originals[index],
                "translated": trans[..., None],
                "label": self.labels[index]}


def distance_float64(batches) -> tuple:
    """(L1, SSIM, per-class sums, per-class counts) of ``batches`` in
    float64 on the CPU: the same formulas (the float32 window of
    ``ops/ssim.gaussian_window``), the SSIM the mean of batch means."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from thermal_semantic_segmentation_torch.ops.ssim import (
        K1, K2, gaussian_window)
    w = torch.from_numpy(gaussian_window().astype(np.float64))
    l1_sum = n = 0.0
    ssims = []
    sums = np.zeros(NUM_CLASSES)
    counts = np.zeros(NUM_CLASSES, np.int64)
    for b in batches:
        x = torch.from_numpy(b["original"]).double().permute(0, 3, 1, 2)
        y = torch.from_numpy(b["translated"]).double().permute(0, 3, 1, 2)
        diff = (x - y).abs()
        l1_sum += float(diff.mean()) * x.shape[0]
        n += x.shape[0]

        def filt(m):
            c = m.shape[1]
            m = F.conv2d(m, w.view(1, 1, -1, 1).expand(c, 1, -1, 1),
                         groups=c)
            return F.conv2d(m, w.view(1, 1, 1, -1).expand(c, 1, 1, -1),
                            groups=c)

        mx, my = filt(x), filt(y)
        vx, vy = filt(x * x) - mx ** 2, filt(y * y) - my ** 2
        cov = filt(x * y) - mx * my
        c1, c2 = K1 ** 2, K2 ** 2
        ssims.append(float((((2 * mx * my + c1) * (2 * cov + c2))
                            / ((mx ** 2 + my ** 2 + c1) * (vx + vy + c2)))
                           .mean()))
        lab = b["label"].reshape(-1)
        keep = (lab >= 0) & (lab < NUM_CLASSES)
        d = diff.mean(1).reshape(-1).numpy()
        sums += np.bincount(lab[keep], weights=d[keep],
                            minlength=NUM_CLASSES)
        counts += np.bincount(lab[keep], minlength=NUM_CLASSES)
    return l1_sum / n, float(np.mean(ssims)), sums, counts


def phase_distance(card: str, root: str) -> None:
    """``evaluate_distance`` with the per-class L1 over the translate
    phase's PNGs at batch 1 and 8 (the CLI's shuffled, drop_last loader),
    held to float64 on the CPU; prints pairs/s and the per-batch SSIM and
    per-class times."""
    import os

    import numpy as np
    import torch

    from thermal_semantic_segmentation_torch.data.loader import DataLoader
    from thermal_semantic_segmentation_torch.eval.distance import (
        evaluate_distance, pair_metrics, per_class_l1_sums)

    out_dir = f"{root}/translation"
    pairs = TranslationPairs(sorted(f"{out_dir}/{f}"
                                    for f in os.listdir(out_dir)), seed=26)
    for bs in DISTANCE_BATCHES:
        seen = []

        def recorded(loader):
            for b in loader:
                seen.append(b)
                yield b

        loader = DataLoader(pairs, bs, shuffle=True, drop_last=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        l1, ssim_score, per_class = evaluate_distance(
            recorded(loader), num_classes=NUM_CLASSES, device="cuda")
        secs = time.perf_counter() - t0
        want_l1, want_ssim, sums, counts = distance_float64(seen)
        with np.errstate(invalid="ignore"):
            want_class = sums / counts
        got_counts = sum(per_class_l1_sums(
            *(torch.from_numpy(b[k]).cuda()
              for k in ("original", "translated", "label")),
            NUM_CLASSES)[1].cpu() for b in seen).numpy()
        l1_err = abs(l1 - want_l1) / want_l1
        ssim_err = abs(ssim_score - want_ssim)
        decided = ~np.isnan(want_class)
        class_err = float(np.max(np.abs(per_class[decided]
                                        - want_class[decided])
                                 / want_class[decided]))
        n = sum(len(b["original"]) for b in seen)
        b0 = {k: torch.from_numpy(seen[0][k]).cuda()
              for k in ("original", "translated", "label")}
        ssim_ms = time_ms(lambda: pair_metrics(b0["original"],
                                               b0["translated"]))
        class_ms = time_ms(lambda: per_class_l1_sums(
            b0["original"], b0["translated"], b0["label"], NUM_CLASSES))
        print(f"distance batch {bs}: {n} pairs of {TRANSLATE_HW} in "
              f"{len(seen)} batches; L1 {l1!r} (float64 {want_l1!r}, rel err "
              f"{l1_err:.3g}), SSIM {ssim_score!r} (float64 {want_ssim!r}, "
              f"abs err {ssim_err:.3g}), per-class L1 max rel err "
              f"{class_err:.3g}, nan classes "
              f"{np.flatnonzero(np.isnan(per_class)).tolist()}, counts "
              f"{'equal' if np.array_equal(got_counts, counts) else 'DIFFER'}"
              f"", flush=True)
        print(f"distance batch {bs}: {n / secs:.2f} pairs/s ({secs:.3f} s, "
              f"PNG decode on the loader's threads included); a batch's L1 "
              f"+ SSIM {ssim_ms} ms, per-class sums {class_ms} ms, on {card}",
              flush=True)
        note("distance", **{f"batch{bs}_pairs_per_s": n / secs})
        if n != len(pairs) // bs * bs:
            fail(f"the distance eval scored {n} of {len(pairs)} pairs")
        if not (l1_err <= DISTANCE_RTOL and ssim_err <= SSIM_ATOL
                and class_err <= DISTANCE_RTOL):
            fail("the distance eval disagrees with float64")
        if not np.array_equal(np.isnan(per_class), ~decided) or \
                not np.array_equal(got_counts, counts):
            fail("the distance eval's per-class counts or nan classes "
                 "differ from float64")


def free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


class SigtermAtPoll:
    """A shutdown flag that sends this process SIGTERM at its ``at``-th
    poll (the train loop polls once before each step), then reads the
    ``GracefulShutdown`` it wraps."""

    def __init__(self, inner, at: int):
        self.inner, self.at, self.polls = inner, at, 0

    @property
    def requested(self) -> bool:
        import os
        import signal
        self.polls += 1
        if self.polls == self.at:
            os.kill(os.getpid(), signal.SIGTERM)
        return self.inner.requested

    @property
    def signum(self):
        return self.inner.signum


def phase_dist(card: str, gloo: dict) -> dict:
    """The train CLI's loop under ``--distributed`` with one rank over
    NCCL, full width, in each remat mode, and a SIGTERM with its resume;
    then the remat modes' speed, memory and gradients, and two ranks over
    gloo. Returns the kernels' launch counts from the CLI runs."""
    import math
    import os

    import torch
    import torch.distributed as dist

    from thermal_semantic_segmentation_torch.cli._common import (
        load_seg_checkpoint)
    from thermal_semantic_segmentation_torch.cli.options import seg_parse
    from thermal_semantic_segmentation_torch.cli.segmentation_train import (
        make_loaders, train_epochs)
    from thermal_semantic_segmentation_torch.data.loader import split_indices
    from thermal_semantic_segmentation_torch.kernels.upsample_argmax import (
        upsample_argmax)
    from thermal_semantic_segmentation_torch.models.deeplab import (
        create_deeplab)
    from thermal_semantic_segmentation_torch.parallel.mesh import make_mesh
    from thermal_semantic_segmentation_torch.utils.logging import get_logger
    from thermal_semantic_segmentation_torch.utils.preempt import (
        GracefulShutdown)

    source = SeededImages(DIST_SOURCE, SERVE_OUT, seed=12)
    target = SeededImages(DIST_TARGET, SERVE_OUT, seed=13)
    n_train, n_val = map(len, split_indices(DIST_SOURCE))
    steps = n_train // TRAIN_BATCH
    val_batches = (math.ceil(n_val / TRAIN_BATCH)
                   + math.ceil(DIST_TARGET / TRAIN_BATCH))
    dist_flags = ["--distributed", "true", "--coordinator_address",
                  f"localhost:{free_port()}", "--num_processes", "1",
                  "--process_id", "0"]
    with tempfile_dir() as root:
        torch.save({"epoch": -1,
                    "sem_net_state_dict": create_deeplab(0).state_dict()},
                   f"{root}/start.pth")
        logdir = os.path.join(root, "logs")
        logger = get_logger(logdir)

        def run(*flags, shutdown=None):
            args = seg_parse().parse_args(
                ["-load_model", "true", "--model_root_path", root,
                 "-new_checkpoint_name", "dist.pth", "-epochs", "1",
                 "-batch_size", str(TRAIN_BATCH), "-val_batch_size",
                 str(TRAIN_BATCH), *flags, *dist_flags])
            args.logdir = logdir
            return train_epochs(args, logger,
                                *make_loaders(args, source, target),
                                shutdown=shutdown)

        upsample_argmax.launches = 0      # counts from the main path only
        histories = {}
        for mode in REMAT_MODES:
            state, histories[mode] = run("-checkpoint_name", "start.pth",
                                         "--remat", mode)
            if state.model.remat != mode:
                fail(f"--remat {mode} built a {state.model.remat} model")
            del state
        with GracefulShutdown() as shutdown:
            _, preempted = run("-checkpoint_name", "start.pth",
                               shutdown=SigtermAtPoll(shutdown,
                                                      PREEMPT_AT_POLL))
        preempt_path = os.path.join(root, "preempt_dist.pth")
        _, meta = load_seg_checkpoint(preempt_path)
        _, resumed = run("-checkpoint_name", "preempt_dist.pth")
        launches = {"upsample_argmax": upsample_argmax.launches}
        torch.cuda.synchronize()
        backend, world = dist.get_backend(), dist.get_world_size()
        mesh = make_mesh()

    print(f"dist check: {backend} process group of {world}; losses "
          f"{ {m: h[0]['train_losses'] for m, h in histories.items()} }, "
          f"val_loss { {m: h[0]['val_loss'] for m, h in histories.items()} }"
          f"; SIGTERM at poll {PREEMPT_AT_POLL}: {preempted}, checkpoint "
          f"epoch {meta['epoch']}; resumed {resumed}; launches {launches}",
          flush=True)
    if backend != "nccl" or world != 1:
        fail(f"the --distributed CLI joined a {backend} group of {world}")
    for mode, h in histories.items():
        if [r["epoch"] for r in h] != [0] or \
                len(h[0]["train_losses"]) != steps or \
                not all(map(math.isfinite,
                            h[0]["train_losses"] + [h[0]["val_loss"]])):
            fail(f"--remat {mode}: the epoch did not run: {h}")
    if len(preempted) != 1 or not preempted[0]["preempted"] or \
            len(preempted[0]["train_losses"]) != PREEMPT_AT_POLL - 1 or \
            meta["epoch"] != -1:
        fail(f"the SIGTERM left no resumable preempt checkpoint: "
             f"{preempted}, epoch {meta['epoch']}")
    if [r["epoch"] for r in resumed] != [0] or resumed[0]["preempted"] or \
            len(resumed[0]["train_losses"]) != steps or \
            not math.isfinite(resumed[0]["val_loss"]):
        fail(f"the resume from preempt_dist.pth did not train: {resumed}")
    if launches["upsample_argmax"] != (len(REMAT_MODES) + 1) * val_batches:
        fail(f"upsample_argmax launched {launches['upsample_argmax']} "
             f"times for {(len(REMAT_MODES) + 1) * val_batches} validation "
             f"batches")

    image = torch.from_numpy(source.images[:TRAIN_BATCH]).cuda()
    label = torch.from_numpy(source.labels[:TRAIN_BATCH]).cuda()
    for mode, step_mesh in (("none", None), *((m, mesh)
                                               for m in REMAT_MODES)):
        ms, peak = remat_step_time(mode, step_mesh, image, label)
        what = "plain step" if step_mesh is None else "DDP step"
        print(f"dist remat {mode}: {what} {ms:.2f} ms, "
              f"{TRAIN_BATCH * 1e3 / ms:.2f} images/s, peak device memory "
              f"{peak:.3f} GiB (batch {TRAIN_BATCH} at 256x512, float32, "
              f"one NCCL rank) on {card}", flush=True)
        note("dist", **{f"{mode}_{'ddp' if step_mesh else 'plain'}_ms":
                        ms})
    remat_gradients(image, label)
    dist.destroy_process_group()
    two_ranks_over_gloo(gloo)
    return launches


def remat_step_time(mode: str, mesh, image, label):
    """(ms a step over ``DIST_TIMED_STEPS`` after two warm-ups, peak GiB
    over them) of the full-width DDP step with ``remat`` ``mode`` (the
    plain one-process step when ``mesh`` is None)."""
    import gc

    import torch

    from thermal_semantic_segmentation_torch.models.deeplab import (
        create_deeplab)
    from thermal_semantic_segmentation_torch.train.seg import (
        create_seg_state, make_seg_train_step)

    state = create_seg_state(create_deeplab(0, remat=mode),
                             learning_rate=TRAIN_LR)
    step = make_seg_train_step(ignore_index=IGNORE, label_hw=SERVE_OUT,
                               base_lr=TRAIN_LR, mesh=mesh)
    for _ in range(2):
        step(state, image, label)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(DIST_TIMED_STEPS):
        step(state, image, label)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / DIST_TIMED_STEPS
    peak = torch.cuda.max_memory_allocated() / 2**30
    del state, step
    gc.collect()
    torch.cuda.empty_cache()
    return ms, peak


def remat_gradients(image, label) -> None:
    """One batch's gradients in each remat mode from the same weights
    (dropout off), against 'none''s: the largest over the tensors of
    max|g - g_none| / max|g_none|, beside a second 'none' pass (the
    card's own run-to-run noise); every BatchNorm folded once."""
    import gc

    import torch

    from thermal_semantic_segmentation_torch.losses import cross_entropy
    from thermal_semantic_segmentation_torch.models.deeplab import (
        create_deeplab)
    from thermal_semantic_segmentation_torch.nn.resnet import BatchNorm2d
    from thermal_semantic_segmentation_torch.ops.resize import upsample_logits

    def grads(mode):
        model = create_deeplab(0, remat=mode).train()
        model.layer5.head[0].p = 0.0
        out = model(image.permute(0, 3, 1, 2))["out"]
        cross_entropy(upsample_logits(out.float().permute(0, 2, 3, 1),
                                      *SERVE_OUT), label,
                      ignore_index=IGNORE).backward()
        folds = {int(m.num_batches_tracked) for m in model.modules()
                 if isinstance(m, BatchNorm2d)}
        if folds != {1}:
            fail(f"--remat {mode}: BatchNorm folded {folds} times")
        return {n: p.grad for n, p in model.named_parameters()}

    base = grads("none")
    errs = {}
    for mode in ("none", "dots", "full"):
        other = grads(mode)
        errs[mode if mode != "none" else "none again"] = max(
            float((other[n] - g).abs().max() / g.abs().max().clamp_min(
                1e-30)) for n, g in base.items())
        del other
        gc.collect()
    print(f"dist remat gradients against none on one batch (largest "
          f"relative error over the tensors): {errs}", flush=True)
    for mode in ("dots", "full"):
        if not errs[mode] <= REMAT_GRAD_RTOL:
            fail(f"--remat {mode}'s gradients are {errs[mode]} from none's")
    del base
    gc.collect()
    torch.cuda.empty_cache()


class SeededPairs:
    """Seeded (original, translated, label) pairs for the distance eval."""

    def __init__(self, n: int, hw, seed: int):
        import numpy as np
        rng = np.random.default_rng(seed)
        self.ori = rng.random((n, *hw, 1), dtype=np.float32)
        self.trans = np.clip(self.ori + rng.normal(0, 0.2, self.ori.shape),
                             0, 1).astype(np.float32)
        self.labels = rng.integers(0, NUM_CLASSES, (n, *hw)).astype(
            np.int32)

    def __len__(self) -> int:
        return len(self.ori)

    def get(self, index: int, rng) -> dict:
        return {"original": self.ori[index],
                "translated": self.trans[index], "label": self.labels[index]}


def gloo_results(rank, sharded: bool) -> dict:
    """A tiny model's 'sync' and 'per_replica' steps (rank ``rank``'s
    images of the joined batch, or all of them with one rank), its
    validation, distance eval and prototypes, and a tiny self-training
    step and two tiny CycleGAN steps, on ``cuda:0``."""
    import torch

    from thermal_semantic_segmentation_torch.data.loader import DataLoader
    from thermal_semantic_segmentation_torch.eval.distance import (
        evaluate_distance)
    from thermal_semantic_segmentation_torch.eval.validate import (
        seg_validate)
    from thermal_semantic_segmentation_torch.models.deeplab import (
        create_deeplab)
    from thermal_semantic_segmentation_torch.parallel.mesh import (
        host_shard, make_mesh)
    from thermal_semantic_segmentation_torch.train.prototypes import (
        calc_prototypes)
    from thermal_semantic_segmentation_torch.train.seg import (
        create_seg_state, make_seg_train_step)

    dev = torch.device("cuda", 0)
    data = SeededImages(GLOO_WORLD * GLOO_LOCAL, PARITY_HW, seed=21)
    rows = (slice(rank * GLOO_LOCAL, (rank + 1) * GLOO_LOCAL) if sharded
            else slice(None))
    out = {}
    for mode in ("sync", "per_replica"):
        model = create_deeplab(7, device=dev, layers=(1, 1, 1, 1))
        model.layer5.head[0].p = 0.0
        state = create_seg_state(model, learning_rate=TRAIN_LR, device=dev)
        step = make_seg_train_step(
            ignore_index=IGNORE, label_hw=PARITY_HW, base_lr=TRAIN_LR,
            bn_mode=mode, mesh=make_mesh(dev) if sharded else None,
            device=dev)
        loss = step(state, torch.from_numpy(data.images[rows]).to(dev),
                    torch.from_numpy(data.labels[rows]).to(dev))
        out[mode] = (float(loss), {k: v.cpu() for k, v in
                                   model.state_dict().items()})
        out[f"{mode}_grad"] = {n: p.grad.cpu()
                               for n, p in model.named_parameters()}
    shard = host_shard() if sharded else None
    model = create_deeplab(7, device=dev, layers=(1, 1, 1, 1))
    out["val"] = seg_validate(
        model, DataLoader(SeededImages(GLOO_VAL, PARITY_HW, seed=22), 1,
                          drop_last=False, shard=shard, shard_lockstep=False),
        device=dev, reduce_processes=sharded)
    out["distance"] = evaluate_distance(
        DataLoader(SeededPairs(GLOO_PAIRS, PARITY_HW, seed=23), 1,
                   shuffle=True, drop_last=True, shard=shard,
                   shard_lockstep=False),
        num_classes=NUM_CLASSES, device=dev, reduce_processes=sharded)
    out["proto"] = calc_prototypes(
        model, DataLoader(SeededImages(GLOO_PROTO, PARITY_HW, seed=24), 2,
                          shuffle=True, drop_last=True, shard=shard,
                          shard_lockstep=False),
        num_classes=NUM_CLASSES, device=dev)
    mesh = make_mesh(dev) if sharded else None
    out["st"] = gloo_self_train(rows, mesh, dev)
    out["gan"] = gloo_gan(rows, mesh, dev)
    return out


def gloo_reference_grads() -> dict:
    """The gradients of the gloo 'sync' step's loss on the joined batch,
    one rank in float64 on ``cuda:0``: the anchor that both float32 steps
    are held to."""
    import torch

    from thermal_semantic_segmentation_torch.losses import cross_entropy
    from thermal_semantic_segmentation_torch.models.deeplab import (
        create_deeplab)
    from thermal_semantic_segmentation_torch.ops.resize import upsample_logits

    dev = torch.device("cuda", 0)
    data = SeededImages(GLOO_WORLD * GLOO_LOCAL, PARITY_HW, seed=21)
    model = create_deeplab(7, device=dev, layers=(1, 1, 1, 1)).double()
    model.layer5.head[0].p = 0.0
    model.train()
    image = torch.from_numpy(data.images).to(dev, torch.float64)
    out = model(image.permute(0, 3, 1, 2))["out"].permute(0, 2, 3, 1)
    cross_entropy(upsample_logits(out, *PARITY_HW),
                  torch.from_numpy(data.labels).to(dev),
                  ignore_index=IGNORE).backward()
    return {n: p.grad for n, p in model.named_parameters()}


def dist_worker(rank: int, port: int, root: str) -> int:
    """One of the two gloo ranks on ``cuda:0``; its results to
    ``<root>/gloo<rank>.pt``."""
    import torch
    import torch.distributed as dist

    from thermal_semantic_segmentation_torch.parallel.mesh import (
        init_distributed)

    init_distributed(f"localhost:{port}", GLOO_WORLD, rank, backend="gloo",
                     device="cuda:0")
    torch.save(gloo_results(rank, sharded=True), f"{root}/gloo{rank}.pt")
    dist.barrier()
    dist.destroy_process_group()
    return 0


def two_ranks_over_gloo(gloo: dict) -> None:
    """Two gloo ranks on the one card (``gloo``, from ``gloo_runs``)
    against one rank: the seg step, validation, distance eval and
    prototype merge."""
    import numpy as np
    import torch

    ranks, one = gloo["ranks"], gloo["one"]

    for mode in ("sync", "per_replica"):
        (l0, sd0), (l1, sd1) = ranks[0][mode], ranks[1][mode]
        g0, g1 = ranks[0][f"{mode}_grad"], ranks[1][f"{mode}_grad"]
        differ = [k for k in sd0 if not torch.equal(sd0[k], sd1[k])] + [
            n for n in g0 if not torch.equal(g0[n], g1[n])]
        if l0 != l1 or differ:
            fail(f"{mode}: the two ranks' state or gradients differ: losses "
                 f"{l0}, {l1}, tensors {differ[:5]}")
    (loss, sd), (want_loss, want_sd) = ranks[0]["sync"], one["sync"]
    outside = total = 0
    worst = buffer_err = 0.0
    for k, v in want_sd.items():
        diff = (sd[k].double() - v.double()).abs()
        if v.is_floating_point() and k.endswith(("running_mean",
                                                 "running_var")):
            buffer_err = max(buffer_err, float(diff.max()))
        elif v.is_floating_point():
            worst = max(worst, float(diff.max()) / TRAIN_LR)
            outside += int((diff > TRAIN_LR).sum())
            total += diff.numel()
    # the gradients tensor by tensor against float64, in units of the
    # largest float64 gradient: the two ranks' error no more than twice one
    # rank's float32 error plus GLOO_GRAD_ATOL
    ref = gloo_reference_grads()
    scale = max(float(g.abs().max()) for g in ref.values())

    def grad_errs(grads):
        return {n: float((grads[n].to(g.device, torch.float64) - g).abs().max())
                / scale for n, g in ref.items()}

    two_errs, one_errs = grad_errs(ranks[0]["sync_grad"]), grad_errs(
        one["sync_grad"])
    worse = [n for n in ref
             if two_errs[n] > 2 * one_errs[n] + GLOO_GRAD_ATOL]
    grad_err, one_err = max(two_errs.values()), max(one_errs.values())
    del ref
    loss_err = abs(loss - want_loss) / abs(want_loss)
    print(f"dist gloo: two ranks' sync step vs one rank on the joined "
          f"batch: loss {loss} vs {want_loss} (rel err {loss_err:.3g}), "
          f"gradients' largest error from float64 {grad_err:.3g} of the "
          f"largest gradient (one rank's {one_err:.3g}; {len(worse)} tensors "
          f"past the bound), {outside} of {total} parameters outside the "
          f"one-step lr envelope, worst {worst:.4f} x lr apart, BatchNorm "
          f"buffers max abs err {buffer_err:.3g}; per_replica state and "
          f"gradients equal on both ranks", flush=True)
    # as train_step_parity: a first Adam step moves each parameter by under
    # lr, so the envelope alone is loose; the gradients hold the backward
    if not (loss_err <= LOSS_RTOL and not worse
            and outside <= 5e-4 * total and worst <= 2.01
            and buffer_err <= GLOO_BUFFER_ATOL):
        fail("the two-rank sync step is not the one-rank step")
    def flat(result, name):
        if name == "val":
            result = [result[0], result[1], *result[2].values()]
        return np.concatenate([np.ravel(np.asarray(x, np.float64))
                               for x in result])

    for name in ("val", "distance", "proto"):
        g, w = flat(ranks[0][name], name), flat(one[name], name)
        other = flat(ranks[1][name], name)
        same_nan = np.array_equal(np.isnan(g), np.isnan(w))
        close = np.isnan(g) | np.isclose(g, w, rtol=GLOO_METRIC_RTOL,
                                         atol=GLOO_METRIC_RTOL)
        err = float(np.nanmax(np.abs(g - w) / np.maximum(np.abs(w), 1e-30)))
        print(f"dist gloo {name}: two ranks vs one, max rel err {err:.3g}",
              flush=True)
        if not (same_nan and close.all()):
            fail(f"the two-rank {name} differs from the one-rank run")
        if not np.array_equal(g, other, equal_nan=True):
            fail(f"the two ranks' {name} differ")

def dist_flags_one_rank() -> list:
    """The CLI flags of a one-rank NCCL group on a free localhost port."""
    return ["--distributed", "true", "--coordinator_address",
            f"localhost:{free_port()}", "--num_processes", "1",
            "--process_id", "0"]


def step_ms(fn, reps: int = DIST_TIMED_STEPS) -> float:
    """Median wall ms of ``fn`` (one train step), each call synchronised,
    after two warm-ups."""
    import torch
    times = []
    for i in range(reps + 2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        if i >= 2:
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def phase_self_train_dist(card: str, root: str, gloo: dict) -> dict:
    """The self-training CLI's loop under ``--distributed`` with one NCCL
    rank, the full-width model at batch 4: a run SIGTERMed before its
    third step and its resume from ``preempt_``; the mesh step's time
    against the plain step's on one batch; then two gloo ranks of a tiny
    model (``gloo``, from ``gloo_runs``). Returns the kernels' launch
    counts from the CLI runs."""
    import math
    import os

    import torch
    import torch.distributed as dist

    from thermal_semantic_segmentation_torch.cli._common import (
        load_seg_checkpoint)
    from thermal_semantic_segmentation_torch.cli.options import (
        self_train_parse)
    from thermal_semantic_segmentation_torch.cli.self_train_main import (
        self_train_epochs)
    from thermal_semantic_segmentation_torch.data.loader import DataLoader
    from thermal_semantic_segmentation_torch.kernels.upsample_argmax import (
        upsample_argmax)
    from thermal_semantic_segmentation_torch.parallel.mesh import (
        host_shard, make_mesh)
    from thermal_semantic_segmentation_torch.train.self_train import (
        make_self_train_step)
    from thermal_semantic_segmentation_torch.utils.logging import get_logger
    from thermal_semantic_segmentation_torch.utils.preempt import (
        GracefulShutdown)

    source = SeededImages(ST_IMAGES, SERVE_OUT, seed=7)
    target = SeededSelfTrainTarget(ST_IMAGES, seed=8)
    test = SeededImages(ST_VAL_IMAGES, SERVE_OUT, seed=9)
    val_batches = math.ceil(ST_VAL_IMAGES / ST_BATCH)
    flags = dist_flags_one_rank()
    logger = get_logger(os.path.join(root, "logs", "self-training-dist"))

    def run(checkpoint, shutdown=None):
        args = self_train_parse().parse_args(
            ["--root", root, "--model_root_path", root, "-checkpoint_name",
             checkpoint, "-new_checkpoint_name", "smoke_st_dist.pth",
             "--epochs", "1", "-max_steps", str(DIST_STEPS), "-batch_size",
             str(ST_BATCH), *flags])
        loaders = [DataLoader(data, ST_BATCH, shuffle=shuffle,
                              drop_last=shuffle, seed=args.seed + k,
                              shard=host_shard() if shuffle else None)
                   for k, (data, shuffle) in enumerate(
                       ((source, True), (target, True), (test, False)))]
        return self_train_epochs(args, logger, *loaders, shutdown=shutdown)

    upsample_argmax.launches = 0      # counts from the main path only
    with GracefulShutdown() as shutdown:
        state, first = run("smoke.pth", SigtermAtPoll(shutdown,
                                                      PREEMPT_AT_POLL))
    _, meta = load_seg_checkpoint(os.path.join(root,
                                               "preempt_smoke_st_dist.pth"))
    del state
    state, resumed = run("preempt_smoke_st_dist.pth")
    launches = {"upsample_argmax": upsample_argmax.launches}
    torch.cuda.synchronize()
    backend, world = dist.get_backend(), dist.get_world_size()
    history = first + resumed
    steps = sum(h["steps"] for h in history)
    validations = sum(len(h["validations"]) for h in history)
    losses = [x for h in history for pair in h["losses"] for x in pair]
    print(f"self_train_dist check: {backend} process group of {world}; "
          f"SIGTERM at poll {PREEMPT_AT_POLL}: epochs "
          f"{[(h['epoch'], h['steps'], h['preempted']) for h in history]}, "
          f"preempt checkpoint epoch {meta['epoch']} with prototypes "
          f"{'objective_vectors' in meta}; losses {losses}; launches "
          f"{launches} for {steps} steps and {validations} validations of "
          f"{val_batches} batches", flush=True)
    if backend != "nccl" or world != 1:
        fail(f"the --distributed self-training joined a {backend} group of "
             f"{world}")
    if [(h["steps"], h["preempted"]) for h in history] != [
            (PREEMPT_AT_POLL - 1, True), (DIST_STEPS, False)] or \
            resumed[0]["epoch"] != first[0]["epoch"] or \
            meta["epoch"] != first[0]["epoch"] - 1 or \
            "objective_vectors" not in meta:
        fail("the SIGTERM and resume of the --distributed self-training "
             "did not stop, save and redo the epoch")
    if not (losses and all(map(math.isfinite, losses))):
        fail("the --distributed self-training: a non-finite or missing loss")
    if launches["upsample_argmax"] != steps + validations * val_batches:
        fail(f"upsample_argmax launched {launches['upsample_argmax']} times "
             f"for {steps} steps and {validations * val_batches} validation "
             f"batches")

    b = next(iter(self_train_batches(target, source)))
    kw = dict(num_classes=NUM_CLASSES, ignore_index=IGNORE, base_lr=ST_LR)
    ms = {name: step_ms(lambda step=make_self_train_step(mesh=mesh, **kw):
                        run_step(step, state, b))
          for name, mesh in (("plain", None), ("mesh", make_mesh()))}
    print(f"self_train_dist step: one-rank NCCL mesh step {ms['mesh']:.2f} "
          f"ms ({ST_BATCH * 1e3 / ms['mesh']:.2f} images/s), plain step "
          f"{ms['plain']:.2f} ms ({ms['mesh'] / ms['plain']:.4f} x), batch "
          f"{ST_BATCH}, float32, median of {DIST_TIMED_STEPS} on {card}",
          flush=True)
    note("self_train_dist", mesh_ms=ms["mesh"], plain_ms=ms["plain"])
    del state
    dist.destroy_process_group()
    self_train_gloo_check(gloo)
    return launches


def phase_gan_dist(card: str, root: str, gloo: dict) -> dict:
    """The GAN CLI's loop under ``--distributed`` with one NCCL rank, the
    full-width CycleGAN with the contour and module2 sem losses at batch
    4: a run SIGTERMed before its third step and its resume from
    ``preempt_``; the mesh step's time against the plain step's; then two
    gloo ranks of tiny nets with bit-equal pools (``gloo``). Returns the
    kernels' launch counts from the CLI runs."""
    import math

    import torch
    import torch.distributed as dist

    from thermal_semantic_segmentation_torch.cli._common import (
        load_gan_checkpoint)
    from thermal_semantic_segmentation_torch.cli.main import (
        gan_epochs, load_sem_nets)
    from thermal_semantic_segmentation_torch.cli.options import train_parse
    from thermal_semantic_segmentation_torch.data.loader import DataLoader
    from thermal_semantic_segmentation_torch.kernels.upsample_argmax import (
        upsample_argmax)
    from thermal_semantic_segmentation_torch.parallel.mesh import (
        host_shard, make_mesh)
    from thermal_semantic_segmentation_torch.train.gan import make_gan_step
    from thermal_semantic_segmentation_torch.utils.preempt import (
        GracefulShutdown)

    source = SeededGanImages(GAN_IMAGES, SERVE_OUT, 3, seed=21, labels=True)
    target = SeededGanImages(GAN_IMAGES, SERVE_OUT, 1, seed=22)
    flags = dist_flags_one_rank()

    def run(load: str, shutdown=None):
        args = train_parse().parse_args(gan_argv(
            root, "module2", "-max_steps", str(DIST_STEPS),
            "-checkpoint_name", load or "smoke_gan.pth",
            "-new_checkpoint_name", "smoke_gan_dist.pth", "-load_model",
            "true" if load else "false", *flags))
        loaders = [DataLoader(data, GAN_BATCH, shuffle=True, drop_last=True,
                              seed=args.seed + k, shard=host_shard())
                   for k, data in enumerate((source, target))]
        return (args, *gan_epochs(args, *loaders, shutdown=shutdown))

    upsample_argmax.launches = 0      # counts from the main path only
    with GracefulShutdown() as shutdown:
        _, state, first = run("", SigtermAtPoll(shutdown, PREEMPT_AT_POLL))
    preempt = load_gan_checkpoint(f"{root}/preempt_smoke_gan_dist.pth")
    del state
    args, state, resumed = run("preempt_smoke_gan_dist.pth")
    launches = {"upsample_argmax": upsample_argmax.launches}
    torch.cuda.synchronize()
    backend, world = dist.get_backend(), dist.get_world_size()
    history = first + resumed
    steps = sum(h["steps"] for h in history)
    values = [x for h in history for v in h["metrics"].values() for x in v]
    print(f"gan_dist check: {backend} process group of {world}; SIGTERM at "
          f"poll {PREEMPT_AT_POLL}: epochs "
          f"{[(h['epoch'], h['steps'], h['preempted']) for h in history]}, "
          f"preempt checkpoint epoch {preempt['epoch']}; launches "
          f"{launches} for {steps} steps", flush=True)
    if backend != "nccl" or world != 1:
        fail(f"the --distributed GAN joined a {backend} group of {world}")
    if [(h["epoch"], h["steps"], h["preempted"]) for h in history] != [
            (0, PREEMPT_AT_POLL - 1, True), (-1, DIST_STEPS, False)] or \
            preempt["epoch"] != -1:
        fail("the SIGTERM and resume of the --distributed GAN did not stop, "
             "save and resume at the JAX CLI's epoch")
    if len(history[0]["metrics"]) != 11 or not all(
            map(math.isfinite, values)):
        fail("the --distributed GAN: a non-finite or missing loss")
    if launches["upsample_argmax"] != steps:
        fail(f"upsample_argmax launched {launches['upsample_argmax']} times "
             f"for {steps} GAN steps")

    b = next(iter(gan_batches(source, target)))
    sem_nets = load_sem_nets(args, "cuda")
    ms = {}
    for name, mesh in (("plain", None), ("mesh", make_mesh())):
        step, make_pools = make_gan_step(
            pool_size=50, mesh=mesh, **gan_step_kwargs(args, sem_nets))
        pools = make_pools({"t": (*SERVE_OUT, 1), "s": (*SERVE_OUT, 3)},
                           device="cuda")
        ms[name] = step_ms(lambda: step(state, pools, b["real_s"],
                                        b["real_t"], b["label_s"],
                                        with_sem=True))
    print(f"gan_dist step: one-rank NCCL mesh step {ms['mesh']:.2f} ms "
          f"({GAN_BATCH * 1e3 / ms['mesh']:.2f} images/s), plain step "
          f"{ms['plain']:.2f} ms ({ms['mesh'] / ms['plain']:.4f} x), batch "
          f"{GAN_BATCH}, float32, median of {DIST_TIMED_STEPS} on {card}",
          flush=True)
    note("gan_dist", mesh_ms=ms["mesh"], plain_ms=ms["plain"])
    del state, sem_nets
    dist.destroy_process_group()
    gan_gloo_check(gloo)
    return launches


def phase_data_parallel(card: str, root: str) -> dict:
    """``--data_parallel`` over a ``LocalMesh`` of two replicas on the one
    card (``[cuda:0, cuda:0]``): the full-width model's eval
    (``seg_validate``), hard pseudo-labels, prototypes and server batches,
    and the gan phase's generator's translations, each against the
    one-replica run: ids equal outside near-ties, confusion matrices
    apart only there, val_loss rtol ``LOSS_RTOL``, confidences within a
    float16 ulp, prototypes rel err ``PROTO_RTOL`` with equal counts,
    frames within one grey level; images/s of both. Returns the kernels'
    launch counts from the two-replica runs."""
    import os

    import numpy as np
    import torch

    from thermal_semantic_segmentation_torch.cli._common import (
        build_generator_from_gan_checkpoint)
    from thermal_semantic_segmentation_torch.cli.options import (
        evaluation_parse)
    from thermal_semantic_segmentation_torch.cli.translator import (
        translate_batches)
    from thermal_semantic_segmentation_torch.data.loader import DataLoader
    from thermal_semantic_segmentation_torch.eval.validate import (
        _split_eval, seg_validate)
    from thermal_semantic_segmentation_torch.kernels.upsample_argmax import (
        upsample_argmax)
    from thermal_semantic_segmentation_torch.ops.resize import upsample_logits
    from thermal_semantic_segmentation_torch.parallel.mesh import (
        local_data_mesh, replicate, split_rows)
    from thermal_semantic_segmentation_torch.serving.batcher import (
        InferenceServer)
    from thermal_semantic_segmentation_torch.train.prototypes import (
        calc_prototypes)
    from thermal_semantic_segmentation_torch.train.pseudo import (
        generate_pseudo_labels)
    from thermal_semantic_segmentation_torch.train.seg import (
        build_seg_eval_step, forward_nhwc, frozen_inference)

    mesh = local_data_mesh(batch_size=EVAL_BATCH,
                           devices=["cuda:0"] * DP_REPLICAS)
    model = load_smoke_model(evaluation_parse, root).eval()
    generator, _ = build_generator_from_gan_checkpoint(
        f"{root}/smoke_gan.pth", "s2t", input_nc=3, output_nc=1)
    evals = SeededImages(EVAL_IMAGES, SERVE_OUT, seed=40)
    named = NamedImages(PSEUDO_IMAGES, SERVE_OUT, seed=41)
    protos = SeededImages(DP_PROTO_IMAGES, SERVE_OUT, seed=42)
    serve_x = np.random.default_rng(43).random(
        (DP_SERVE_BATCHES, EVAL_BATCH, *SERVE_OUT, 1), dtype=np.float32)

    def run_all(m, tag):
        """Every path once with mesh ``m`` (None: one replica); (results,
        seconds per path)."""
        out, secs = {}, {}
        server = InferenceServer(model, batch_size=EVAL_BATCH, mesh=m)
        for name in ("eval", "pseudo", "proto", "translate", "serve"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if name == "eval":
                out[name] = seg_validate(model, DataLoader(
                    evals, EVAL_BATCH, drop_last=False), mesh=m)
            elif name == "pseudo":
                out[name] = f"{root}/dp_pseudo_{tag}"
                generate_pseudo_labels(model, DataLoader(
                    named, PSEUDO_BATCH, drop_last=False),
                    save_path=out[name], mesh=m)
            elif name == "proto":
                out[name] = calc_prototypes(model, DataLoader(
                    protos, DP_PROTO_IMAGES, drop_last=True), mesh=m)
            elif name == "translate":
                out[name] = f"{root}/dp_translate_{tag}"
                translate_batches(generator, DataLoader(SeededFrames(
                    DP_TRANSLATE_IMAGES, seed=44, root=out[name]),
                    TRANSLATE_BATCH, drop_last=False), denormalize=[0.5],
                    save_hw=TRANSLATE_HW, suffix="", device="cuda", mesh=m)
            else:
                out[name] = np.stack([server._predict(x) for x in serve_x])
            torch.cuda.synchronize()
            secs[name] = time.perf_counter() - t0
        return out, secs

    run_all(mesh, "warm")                    # cuDNN's choices, both sizes
    # in turns (one, two, two, one): each path's seconds are the mean of
    # its two runs of each kind; the launches are the two-replica runs'
    launches = {"upsample_argmax": 0}
    runs = {}
    for tag, m in (("one", None), ("two", mesh), ("two_b", mesh),
                   ("one_b", None)):
        upsample_argmax.launches = 0      # counts from the main path only
        runs[tag] = run_all(m, tag)
        if m is not None:
            launches["upsample_argmax"] += upsample_argmax.launches
    (one, one_s), (two, two_s) = runs["one"], runs["two"]
    one_s = {k: (v + runs["one_b"][1][k]) / 2 for k, v in one_s.items()}
    two_s = {k: (v + runs["two_b"][1][k]) / 2 for k, v in two_s.items()}
    # one launch a replica with rows (a batch of n rows has min(n, R)),
    # over the two two-replica runs
    want_launches = 2 * (
        sum(min(EVAL_BATCH, EVAL_IMAGES - i, DP_REPLICAS)
            for i in range(0, EVAL_IMAGES, EVAL_BATCH))
        + sum(min(PSEUDO_BATCH, PSEUDO_IMAGES - i, DP_REPLICAS)
              for i in range(0, PSEUDO_IMAGES, PSEUDO_BATCH))
        + DP_REPLICAS * (1 + DP_SERVE_BATCHES))

    # per-pixel checks: a batch's ids and confusion matrix through the
    # two replicas against one, outside the one replica's near-ties
    eval_step = build_seg_eval_step(num_classes=NUM_CLASSES,
                                    ignore_index=IGNORE)
    replicas = replicate(mesh, model)
    image = torch.from_numpy(evals.images[:EVAL_BATCH]).cuda()
    label = torch.from_numpy(evals.labels[:EVAL_BATCH]).cuda()
    hist1, loss1, pred1 = eval_step(model, image, label)
    shares = split_rows(mesh, EVAL_BATCH)
    hist2, loss2, pred2 = _split_eval(
        eval_step, replicas, [image[r] for r in shares],
        [label[r] for r in shares], torch.device("cuda"), NUM_CLASSES,
        IGNORE)
    with frozen_inference(model):
        logits = forward_nhwc(model, image)["out"]
        top2 = upsample_logits(logits, *SERVE_OUT).topk(2, dim=-1).values
    decided = (top2[..., 0] - top2[..., 1]) > TIE_GAP
    parted = pred1 != pred2
    eval_wrong = int((parted & decided).sum())
    hist_diff = int((hist1 - hist2).abs().sum())
    loss_err = abs(float(loss2) - float(loss1)) / abs(float(loss1))
    del replicas

    # pseudo-labels: ids outside the stride-8 logits' near-ties,
    # confidences within a float16 ulp
    pseudo_wrong = conf_bad = 0
    with frozen_inference(model):
        for i in range(0, PSEUDO_IMAGES, PSEUDO_BATCH):
            x = torch.from_numpy(named.images[i:i + PSEUDO_BATCH]).cuda()
            t2 = forward_nhwc(model, x)["out"].topk(2, dim=-1).values
            ok = ((t2[..., 0] - t2[..., 1]) > TIE_GAP).cpu().numpy()
            for k in range(x.shape[0]):
                stem = f"{i + k:04d}"
                a = read_png_ids(f"{one['pseudo']}/{stem}.png")
                b_ = read_png_ids(f"{two['pseudo']}/{stem}.png")
                pseudo_wrong += int(((a != b_) & ok[k]).sum())
                ca = np.load(f"{one['pseudo']}/{stem}_conf.npy")
                cb = np.load(f"{two['pseudo']}/{stem}_conf.npy")
                ulp = np.spacing(ca).astype(np.float32)
                conf_bad += int((np.abs(ca.astype(np.float32)
                                        - cb.astype(np.float32)) > ulp).sum())
    (p1, n1), (p2, n2) = one["proto"], two["proto"]
    proto_err = float(np.abs(p2 - p1).max() / np.abs(p1).max())
    frames_err = max(
        int(np.abs(read_png_ids(f"{one['translate']}/{f}").astype(int)
                   - read_png_ids(f"{two['translate']}/{f}").astype(int))
            .max()) for f in sorted(os.listdir(one["translate"])))
    n_frames = len(os.listdir(two["translate"]))
    serve_wrong = 0
    with frozen_inference(model):
        for x, a, b_ in zip(serve_x, one["serve"], two["serve"]):
            logits = forward_nhwc(model, torch.from_numpy(x).cuda())["out"]
            t2 = upsample_logits(logits, *SERVE_OUT).topk(2, dim=-1).values
            ok = ((t2[..., 0] - t2[..., 1]) > TIE_GAP).cpu().numpy()
            serve_wrong += int(((a != b_) & ok).sum())
    miou_diff = abs(two["eval"][0] - one["eval"][0])
    val_err = abs(two["eval"][1] - one["eval"][1]) / abs(one["eval"][1])
    print(f"data_parallel check: {mesh.size} replicas on cuda:0; eval batch "
          f"ids parted from one replica's at {int(parted.sum())} pixels, "
          f"{eval_wrong} outside {int((~decided).sum())} near-ties, "
          f"confusion matrices {hist_diff} counts apart, batch CE rel err "
          f"{loss_err:.3g}; whole run mIoU {two['eval'][0]} vs "
          f"{one['eval'][0]} (diff {miou_diff:.3g}), val_loss rel err "
          f"{val_err:.3g}; pseudo-label ids {pseudo_wrong} pixels apart "
          f"outside near-ties, {conf_bad} confidences past a float16 ulp; "
          f"prototypes rel err {proto_err:.3g}, counts "
          f"{'equal' if np.array_equal(n1, n2) else 'DIFFER'}; {n_frames} "
          f"translated frames at most {frames_err} grey levels apart; served "
          f"ids {serve_wrong} pixels apart outside near-ties; launches "
          f"{launches} (expected {want_launches})", flush=True)
    if eval_wrong or hist_diff > 2 * int(parted.sum()) or not (
            loss_err <= LOSS_RTOL and val_err <= LOSS_RTOL):
        fail("the two-replica eval differs from one replica's")
    if pseudo_wrong or conf_bad:
        fail("the two-replica pseudo-labels differ from one replica's")
    if not (proto_err <= PROTO_RTOL and np.array_equal(n1, n2)):
        fail("the two-replica prototypes differ from one replica's")
    if frames_err > 1 or n_frames != DP_TRANSLATE_IMAGES:
        fail("the two-replica translations differ from one replica's")
    if serve_wrong:
        fail("the two-replica server's ids differ from one replica's")
    if launches["upsample_argmax"] != want_launches:
        fail(f"upsample_argmax launched {launches['upsample_argmax']} times "
             f"on the two-replica paths, not {want_launches}")
    counts = {"eval": EVAL_IMAGES, "pseudo": PSEUDO_IMAGES,
              "proto": DP_PROTO_IMAGES, "translate": DP_TRANSLATE_IMAGES,
              "serve": DP_SERVE_BATCHES * EVAL_BATCH}
    rates = {name: {"one_replica": n / one_s[name],
                    "two_replicas": n / two_s[name],
                    "ratio": one_s[name] / two_s[name]}
             for name, n in counts.items()}
    # what the ratios are made of: the replicas (each seg_validate,
    # pseudo-label, prototype and translator call makes them; entries on
    # the model's own card share it) and the forward's per-image time at
    # the half batch each replica runs
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    copies = replicate(mesh, model)
    torch.cuda.synchronize()
    copy_ms = (time.perf_counter() - t0) * 1e3
    del copies
    per_image = {}
    with frozen_inference(model):
        for n in (EVAL_BATCH // DP_REPLICAS, EVAL_BATCH):
            x = torch.from_numpy(evals.images[:n]).cuda()
            per_image[n] = time_ms(lambda: forward_nhwc(model, x), reps=5,
                                   warmup=1) / n
    print(f"data_parallel parts: replicate {copy_ms:.2f} ms (the "
          f"replicas on cuda:0 share the model); forward {per_image[EVAL_BATCH // DP_REPLICAS]:.3f}"
          f" ms an image at batch {EVAL_BATCH // DP_REPLICAS} against "
          f"{per_image[EVAL_BATCH]:.3f} at batch {EVAL_BATCH} (ratio "
          f"{per_image[EVAL_BATCH] / per_image[EVAL_BATCH // DP_REPLICAS]:.4f}"
          f") on {card}", flush=True)
    print(f"data_parallel images/s: {json.dumps(rates)} (means of two "
          f"runs of each, in turns one, two, two, one; eval batch "
          f"{EVAL_BATCH}, pseudo hard batch {PSEUDO_BATCH} with every file "
          f"written, prototypes batch {DP_PROTO_IMAGES}, translate batch "
          f"{TRANSLATE_BATCH} with every PNG written, serve batch "
          f"{EVAL_BATCH}; two replicas share the one card's stream) on "
          f"{card}", flush=True)
    note("data_parallel", **{f"{name}_two_over_one": r["two_replicas"]
                             / r["one_replica"] for name, r in rates.items()})
    return launches


def gloo_runs() -> dict:
    """The two gloo ranks' results (``dist_worker``, two processes on the
    one card) and the one-rank results here, for the phases that check
    them."""
    import os

    import torch

    with tempfile_dir() as root:
        port = free_port()
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--dist-worker",
             str(r), str(port), root], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for r in range(GLOO_WORLD)]
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=GLOO_TIMEOUT)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for r, (p, log) in enumerate(zip(procs, logs)):
            if p.returncode != 0:
                fail(f"gloo rank {r} failed:\n{log[-4000:]}")
        ranks = [torch.load(f"{root}/gloo{r}.pt", weights_only=False)
                 for r in range(GLOO_WORLD)]
    return {"ranks": ranks, "one": gloo_results(0, sharded=False)}


def gloo_self_train_batch():
    """The tiny self-training step's joined batch (``GLOO_WORLD *
    GLOO_LOCAL`` rows at ``PARITY_HW``, 80x176 frames): rank 0's soft maps
    peaked, rank 1's flat, so most of rank 1's pseudo-labels fall under
    the threshold and the ranks' valid counts differ."""
    import numpy as np
    rng = np.random.default_rng(25)
    n, hw, full = GLOO_WORLD * GLOO_LOCAL, PARITY_HW, (80, 176)
    soft = rng.random((n, NUM_CLASSES, *hw), dtype=np.float32)
    soft[:GLOO_LOCAL] **= 6
    hard = np.full((n, *hw), IGNORE, np.int64)
    hard[0, 10:30, 20:60], hard[n - 1, 40:60, 90:120] = 5, 11
    label = rng.integers(0, NUM_CLASSES, (n, *hw))
    label[GLOO_LOCAL:][rng.random((n - GLOO_LOCAL, *hw)) < 0.5] = 255
    return {"s_image": rng.random((n, *hw, 1), dtype=np.float32),
            "s_label": label,
            "t_image": rng.random((n, *hw, 1), dtype=np.float32),
            "t_full": rng.random((n, *full, 1), dtype=np.float32),
            "t_soft": soft / soft.sum(1, keepdims=True), "t_hard": hard,
            "wp": {"resized_hw": np.array([[96, 160], [120, 200]] * 2,
                                          np.int32),
                   "crop": np.array([[8, 72, 16, 144], [4, 68, 8, 136]] * 2,
                                    np.int32),
                   "flip": np.array([True, False, False, True])}}


def gloo_self_train(rows, mesh, dev) -> dict:
    """One tiny self-training step on ``rows`` of the joined batch."""
    import numpy as np
    import torch

    from thermal_semantic_segmentation_torch.models.deeplab import (
        create_deeplab)
    from thermal_semantic_segmentation_torch.train.self_train import (
        create_self_train_state, make_self_train_step)

    batch = gloo_self_train_batch()
    protos = (np.random.default_rng(26).standard_normal((NUM_CLASSES, 256))
              * 0.1).astype(np.float32)
    model = create_deeplab(12, device=dev, layers=(1, 1, 1, 1))
    model.layer5.head[0].p = 0.0
    state = create_self_train_state(model, prototypes=protos,
                                    learning_rate=TRAIN_LR, device=dev)
    step = make_self_train_step(
        num_classes=NUM_CLASSES, ignore_index=IGNORE, base_lr=TRAIN_LR,
        train_thred=GLOO_ST_THRESHOLD, label_hw=PARITY_HW,
        proto_momentum=ST_CHECK_MOMENTUM, mesh=mesh, device=dev)
    b = {k: ({kk: torch.from_numpy(vv[rows]).to(dev)
              for kk, vv in v.items()} if isinstance(v, dict)
             else torch.from_numpy(v[rows]).to(dev))
         for k, v in batch.items()}
    lp, ls = run_step(step, state, b)
    return {"losses": [float(lp), float(ls)],
            "grads": {n: p.grad.detach().cpu()
                      for n, p in model.named_parameters()},
            "student": {k: v.detach().cpu()
                        for k, v in model.state_dict().items()},
            "teacher": {k: v.detach().cpu()
                        for k, v in state.teacher.state_dict().items()},
            "protos": state.prototypes.cpu(),
            "counts": state.proto_counts.cpu()}


def gloo_self_train_reference(dev="cuda:0") -> dict:
    """The gradients of the tiny self-training step's loss on the joined
    batch, one rank in float64 on ``cuda:0``: the pseudo-labels from the
    float32 teacher as the step makes them, then the student's two passes
    and the source CE, pseudo CE and reverse CE in float64."""
    import copy

    import numpy as np
    import torch
    import torch.nn.functional as F

    from thermal_semantic_segmentation_torch.models.deeplab import (
        create_deeplab)
    from thermal_semantic_segmentation_torch.ops.resize import resize_bilinear
    from thermal_semantic_segmentation_torch.train.seg import (
        forward_nhwc, frozen_inference)
    from thermal_semantic_segmentation_torch.train.self_train import (
        pseudo_labels)

    dev = torch.device(dev)
    b = gloo_self_train_batch()
    t = {k: (torch.from_numpy(v).to(dev) if not isinstance(v, dict) else
             {kk: torch.from_numpy(vv).to(dev) for kk, vv in v.items()})
         for k, v in b.items()}
    protos = torch.from_numpy((np.random.default_rng(26).standard_normal(
        (NUM_CLASSES, 256)) * 0.1).astype(np.float32)).to(dev)
    model = create_deeplab(12, device=dev, layers=(1, 1, 1, 1))
    model.layer5.head[0].p = 0.0
    teacher = copy.deepcopy(model)
    fh, fw = (s // 4 for s in t["t_full"].shape[1:3])
    oh, ow = PARITY_HW[0] // 4, PARITY_HW[1] // 4
    with frozen_inference(teacher):
        feat = resize_bilinear(forward_nhwc(teacher, t["t_full"])["feat"],
                               fh, fw)
        pseudo = pseudo_labels(feat, protos, t["t_soft"], t["t_hard"],
                               t["wp"], out_hw=(oh, ow), ignore_index=IGNORE,
                               train_thred=GLOO_ST_THRESHOLD)
    model = model.double().train()

    def logits(x, hw):
        out = model(x.double().permute(0, 3, 1, 2))["out"]
        return F.interpolate(out, size=hw, mode="bilinear",
                             align_corners=True).permute(0, 2, 3, 1)

    def ce(z, y):
        ok = (y != IGNORE) & (y >= 0) & (y < NUM_CLASSES)
        nll = -torch.log_softmax(z, -1).gather(
            -1, torch.where(ok, y, 0)[..., None])[..., 0]
        return torch.where(ok, nll, 0.0).sum() / ok.sum().clamp_min(1)

    def rce(z, y):
        p = torch.softmax(z, -1).clamp(1e-7, 1.0)
        onehot = y[..., None] == torch.arange(NUM_CLASSES, device=dev)
        per = -(p * torch.where(onehot, 0.0, float(np.log(1e-4)))).sum(-1)
        mask = (y != IGNORE).double()
        return (per * mask).sum() / (mask.sum() + 1e-6)

    tgt = logits(t["t_image"], (oh, ow))
    loss = (ce(logits(t["s_image"], PARITY_HW), t["s_label"].long())
            + 0.1 * ce(tgt, pseudo) + rce(tgt, pseudo))
    loss.backward()
    return {n: p.grad for n, p in model.named_parameters()}


def gloo_gan(rows, mesh, dev, steps: int = 2) -> dict:
    """``steps`` tiny CycleGAN steps (U-Net-32 ngf 8, PatchGAN ndf 8,
    module2 sem nets at layers 1,1,1,1; the contour and sem losses;
    device pools of ``GLOO_POOL``, so the pools swap from the second
    image of the second step) on ``rows`` of the joined batch."""
    import numpy as np
    import torch

    from thermal_semantic_segmentation_torch.models import factory
    from thermal_semantic_segmentation_torch.models.deeplab import (
        create_deeplab)
    from thermal_semantic_segmentation_torch.train import gan

    rng = np.random.default_rng(27)
    n = GLOO_WORLD * GLOO_LOCAL
    batches = [{"real_s": rng.uniform(-1, 1, (n, *PARITY_HW, 3)),
                "real_t": rng.uniform(-1, 1, (n, *PARITY_HW, 1)),
                "label_s": rng.integers(0, NUM_CLASSES, (n, *PARITY_HW))}
               for _ in range(steps)]
    g = {"s2t": factory.unet_32(ngf=8, output_nc=1),
         "t2s": factory.unet_32(ngf=8, input_nc=1, output_nc=3)}
    d = {"t": factory.patchgan(ndf=8), "s": factory.patchgan(ndf=8,
                                                             input_nc=3)}
    for i, net in enumerate((*g.values(), *d.values())):
        factory.init_gan_net(net, 30 + i, device=dev)
    sem = {name: create_deeplab(40 + i, device=dev, num_channels=c,
                                layers=(1, 1, 1, 1)).requires_grad_(False)
           for i, (name, c) in enumerate((("s", 3), ("t", 1)))}
    state = gan.create_gan_state(g_nets=g, d_nets=d, learning_rate=TRAIN_LR,
                                 device=dev)
    step, make_pools = gan.make_gan_step(pool_size=GLOO_POOL, cycle=True,
                                         with_contour=True, sem_nets=sem,
                                         sem_norm="module2", mesh=mesh)
    pools = make_pools({"t": (*PARITY_HW, 1), "s": (*PARITY_HW, 3)},
                       device=dev)
    metrics, grads = [], {}
    for b in batches:
        t = {k: torch.from_numpy(v[rows].astype(np.float32)
                                 if v.dtype.kind == "f" else v[rows]).to(dev)
             for k, v in b.items()}
        m, _ = step(state, pools, t["real_s"], t["real_t"], t["label_s"],
                    with_sem=True)
        metrics.append({k: float(v) for k, v in m.items()})
        if not grads:          # the first step's G and D gradients
            grads = {f"{name}.{k}": (p.grad.detach().cpu() if p.grad
                                     is not None else torch.zeros_like(
                                         p, device="cpu"))
                     for name, net in {**g, **d}.items()
                     for k, p in net.named_parameters()}
    return {"metrics": metrics, "grads": grads,
            "state": {f"{name}.{k}": v.detach().cpu()
                      for name, net in {**g, **d}.items()
                      for k, v in net.state_dict().items()},
            "params": [f"{name}.{k}" for name, net in {**g, **d}.items()
                       for k, _ in net.named_parameters()],
            "pools": {f"{name}.{f}": getattr(p, f).cpu()
                      for name, p in pools.items()
                      for f in ("buffer", "count")}}


def envelope(got: dict, want: dict, names, steps: int = 1):
    """(outside, total, worst): parameters ``names`` of ``got`` outside
    ``steps`` Adam steps' lr envelope around ``want``."""
    outside = total = 0
    worst = 0.0
    for k in names:
        ratio = (got[k].double() - want[k].double()).abs() / (
            steps * TRAIN_LR)
        worst = max(worst, float(ratio.max()))
        outside += int((ratio > 1.0).sum())
        total += ratio.numel()
    return outside, total, worst


def self_train_gloo_check(runs) -> None:
    """The two gloo ranks' self-training step: bit-equal on both ranks;
    against one rank on the joined batch (losses rtol ``LOSS_RTOL``, the
    one-step lr envelope with at most 5e-4 outside and none past 2 x,
    prototypes rel err ``PROTO_RTOL`` and equal counts); the gradients
    tensor by tensor against float64 in units of the largest gradient,
    no worse than twice one rank's float32 error plus
    ``GLOO_ST_GRAD_ATOL``."""
    import torch

    r0, r1 = (r["st"] for r in runs["ranks"])
    one = runs["one"]["st"]
    differ = [k for part in ("grads", "student", "teacher")
              for k in r0[part] if not torch.equal(r0[part][k], r1[part][k])]
    differ += [k for k in ("protos", "counts")
               if not torch.equal(r0[k], r1[k])]
    ref = gloo_self_train_reference()
    scale = max(float(g.abs().max()) for g in ref.values())

    def errs(grads):
        return {n: float((grads[n].to(g.device, torch.float64) - g).abs()
                         .max()) / scale for n, g in ref.items()}

    two_e, one_e = errs(r0["grads"]), errs(one["grads"])
    worse = [n for n in ref if two_e[n] > 2 * one_e[n] + GLOO_ST_GRAD_ATOL]
    del ref
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(r0["losses"],
                                                       one["losses"]))
    outside, total, worst = envelope(r0["student"], one["student"],
                                     r0["grads"])
    proto_err = float((r0["protos"] - one["protos"]).abs().max()
                      / one["protos"].abs().max())
    counts_equal = torch.equal(r0["counts"], one["counts"])
    print(f"self_train_dist gloo: two ranks' step vs one rank on the joined "
          f"batch: losses {r0['losses']} vs {one['losses']} (rel err "
          f"{loss_err:.3g}); gradients' largest error from float64 "
          f"{max(two_e.values()):.3g} of the largest gradient (one rank's "
          f"{max(one_e.values()):.3g}; {len(worse)} tensors past the bound); "
          f"{outside} of {total} parameters outside the one-step lr "
          f"envelope, worst {worst:.4f} x lr; prototypes rel err "
          f"{proto_err:.3g}, counts {'equal' if counts_equal else 'DIFFER'}"
          f"; ranks {'bit-equal' if not differ else differ[:5]}", flush=True)
    if differ:
        fail(f"the two ranks' self-training state differs: {differ[:5]}")
    if not (loss_err <= LOSS_RTOL and not worse and outside <= 5e-4 * total
            and worst <= 2.01 and proto_err <= PROTO_RTOL and counts_equal):
        fail("the two-rank self-training step is not the one-rank step")


def gan_gloo_check(runs) -> None:
    """The two gloo ranks' CycleGAN steps: pools, parameters, gradients
    and metrics bit-equal on both ranks; against one rank on the joined
    batch the metrics within rtol ``GLOO_GAN_RTOL``, the pools within
    ``GLOO_BUFFER_ATOL``, the first step's G and D gradients tensor by
    tensor within ``GLOO_GAN_GRAD_ATOL`` of the largest gradient and
    their global norm within rtol ``GLOO_GAN_NORM_RTOL`` (Adam's update
    does not see a scaled gradient, so only these catch a mean over ranks
    taken for the sum), and the parameters inside two steps' lr envelope
    (at most 5e-4 outside, none past 2 x)."""
    import torch

    r0, r1 = (r["gan"] for r in runs["ranks"])
    one = runs["one"]["gan"]
    differ = [k for part in ("state", "pools", "grads") for k in r0[part]
              if not torch.equal(r0[part][k], r1[part][k])]
    largest = max(float(v.abs().max()) for v in one["grads"].values())
    grad_errs = {k: float((r0["grads"][k].double() - v.double()).abs().max())
                 / largest for k, v in one["grads"].items()}
    norms = [sum(float(v.double().square().sum()) for v in gr.values())
             ** 0.5 for gr in (r0["grads"], one["grads"])]
    norm_err = abs(norms[0] - norms[1]) / norms[1]
    grad_worst = max(grad_errs, key=grad_errs.get)
    same_metrics = r0["metrics"] == r1["metrics"]
    metric_err = max(abs(a[k] - b[k]) / max(abs(b[k]), 1e-12)
                     for a, b in zip(r0["metrics"], one["metrics"])
                     for k in b)
    pool_err = max(float((r0["pools"][k].double()
                          - one["pools"][k].double()).abs().max())
                   for k in one["pools"])
    outside, total, worst = envelope(r0["state"], one["state"],
                                     one["params"], steps=2)
    counts = {k: int(v) for k, v in r0["pools"].items()
              if k.endswith("count")}
    print(f"gan_dist gloo: two ranks' steps vs one rank on the joined batch:"
          f" metrics max rel err {metric_err:.3g}; step-1 gradients' "
          f"largest error {grad_errs[grad_worst]:.3g} of the largest "
          f"gradient ({grad_worst}), global norm {norms[0]:.6g} vs "
          f"{norms[1]:.6g} (rel err {norm_err:.3g}); pools (counts {counts}) "
          f"max abs err {pool_err:.3g}; {outside} of {total} parameters "
          f"outside two steps' lr envelope, worst {worst:.4f} x lr; ranks' "
          f"pools, parameters, gradients and metrics "
          f"{'bit-equal' if not differ and same_metrics else differ[:5]}",
          flush=True)
    if differ or not same_metrics:
        fail(f"the two ranks' GAN state or pools differ: {differ[:5]}")
    if not (metric_err <= GLOO_GAN_RTOL and pool_err <= GLOO_BUFFER_ATOL
            and grad_errs[grad_worst] <= GLOO_GAN_GRAD_ATOL
            and norm_err <= GLOO_GAN_NORM_RTOL
            and outside <= 5e-4 * total and worst <= 2.01
            and set(counts.values()) == {GLOO_POOL}):
        fail("the two-rank GAN steps are not the one-rank steps")


def ids_mismatches(got, logits) -> tuple:
    """(pixels where the uint8 ids ``got`` differ from the argmax of the
    float32 upsampled ``logits`` (a CUDA tensor) outside near-ties, the
    near-ties): equality is asked only where the top-2 gap exceeds
    ``TIE_GAP``."""
    import numpy as np
    top2 = logits.topk(2, dim=-1).values
    decided = ((top2[..., 0] - top2[..., 1]) > TIE_GAP).cpu().numpy()
    want = logits.argmax(-1).cpu().numpy()
    got = got.cpu().numpy() if hasattr(got, "cpu") else np.asarray(got)
    return int(((got != want) & decided).sum()), int((~decided).sum())


def live_logits(model, x):
    """The live model's float32 logits of NHWC ``x`` upsampled to 256x512
    (the plain path, no kernel)."""
    import torch

    from thermal_semantic_segmentation_torch.ops.resize import (
        upsample_logits)
    from thermal_semantic_segmentation_torch.train.seg import forward_nhwc
    with torch.inference_mode():
        return upsample_logits(forward_nhwc(model, x)["out"], *SERVE_OUT)


def phase_export(card: str, root: str) -> dict:
    """The export CLI writes the full-width model of ``smoke.pth`` as an ids
    artifact with a symbolic batch and self-checks it; the artifact, loaded
    back, answers batches of 3, 8 and 12 (chunks of 8) held to the live
    model outside near-ties, its launches counted and the kernel named by
    ``torch.profiler`` inside the program; its batch-8 forward timed
    against the live model's. Then the int8 container (bytes against the
    float artifact's, ids against the live model on dequantized weights),
    and at the tiny depth a fixed-batch logits artifact (also loaded onto
    the CPU) and a generator. Returns the kernels' launch counts from the
    artifacts' calls."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from thermal_semantic_segmentation_torch.cli import export_stablehlo
    from thermal_semantic_segmentation_torch.core import export
    from thermal_semantic_segmentation_torch.kernels.upsample_argmax import (
        upsample_argmax)
    from thermal_semantic_segmentation_torch.models.deeplab import (
        create_deeplab)
    from thermal_semantic_segmentation_torch.models.factory import (
        init_gan_net, unet_256)
    from thermal_semantic_segmentation_torch.train.seg import forward_nhwc

    def cli(out, *extra):
        return export_stablehlo.main(
            ["-checkpoint_name", "smoke.pth", "--model_root_path", root,
             "--out", out, "--check", "true", *extra])

    upsample_argmax.launches = 0
    res = cli(f"{root}/smoke_ids.pt2")
    check_launches = upsample_argmax.launches
    t0 = time.perf_counter()
    art = export.load_exported(res["artifact"])
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    model = load_smoke_model(export_stablehlo.export_stablehlo_parse,
                             root).eval()
    rng = np.random.default_rng(50)
    images = torch.from_numpy(rng.random(
        (max(EXPORT_BATCHES), *SERVE_OUT, 1), dtype=np.float32)).cuda()
    upsample_argmax.launches = 0      # counts from the artifact's calls
    checks = {}
    for n in EXPORT_BATCHES:
        before = upsample_argmax.launches
        got = art.call(images[:n])
        torch.cuda.synchronize()
        calls = upsample_argmax.launches - before
        wrong, ties = ids_mismatches(got, live_logits(model, images[:n]))
        checks[n] = {"launches": calls, "mismatches": wrong,
                     "near_ties": ties}
        if (got.shape != (n, *SERVE_OUT) or got.dtype != torch.uint8
                or calls != -(-n // art.rows_per_call)):
            fail(f"export: batch {n} gave {tuple(got.shape)} {got.dtype} in "
                 f"{calls} launches")
        if wrong:
            fail(f"export: batch {n}'s ids disagree with the live model at "
                 f"{wrong} pixels outside near-ties")
    launches = {"upsample_argmax": upsample_argmax.launches}
    x8 = images[:SERVE_BATCH]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        art.call(x8)
        torch.cuda.synchronize()
    named = sorted({e.key for e in prof.key_averages()
                    if e.device_type == torch.autograd.DeviceType.CUDA
                    and "upsample_argmax" in e.key})
    if not named:
        fail("export: torch.profiler names no upsample_argmax kernel in "
             "the program's run")
    def live_ids():
        return upsample_argmax(forward_nhwc(model, x8)["out"], *SERVE_OUT)

    with torch.inference_mode():
        art_ms = time_ms(lambda: art.call(x8), reps=5, warmup=1)
        live_ms = time_ms(live_ids, reps=5, warmup=1)
        kernel_diff = device_kernel_diff(lambda: art.call(x8), live_ids)

    qres = cli(f"{root}/smoke_ids_int8.pt2", "--quantize", "int8")
    ratio = qres["sidecar"]["bytes"] / res["sidecar"]["bytes"]
    qart = export.load_exported(qres["artifact"])
    got = qart.call(x8)
    deq = export.dequantized_model(model)
    qwrong, qties = ids_mismatches(got, live_logits(deq, x8))
    del deq
    if ratio > INT8_MAX_RATIO or qwrong:
        fail(f"export int8: {ratio:.4f} of the float bytes, {qwrong} "
             f"mismatches outside near-ties")

    # the tiny depth: logits at a fixed batch, on the card and moved to
    # the CPU; a generator with a symbolic batch
    tiny = create_deeplab(0, layers=(1, 1, 1, 1))
    exp = export.export_seg_forward(tiny, batch=2, output="logits")
    export.save_exported(exp, f"{root}/tiny_logits.pt2",
                         meta={"output_kind": "logits"})
    logits_err = export._self_check(export.load_exported(
        f"{root}/tiny_logits.pt2"), 1, SERVE_OUT, 2, tiny, "logits")
    cpu_err = export._self_check(export.load_exported(
        f"{root}/tiny_logits.pt2", device="cpu"), 1, SERVE_OUT, 2,
        tiny.cpu(), "logits")
    gen = init_gan_net(unet_256(ngf=8, input_nc=3, output_nc=1), 62).eval()
    gexp = export.export_generator_forward(gen, channels=3)
    export.save_exported(gexp, f"{root}/tiny_g.pt2")
    gen_err = export._self_check(export.load_exported(f"{root}/tiny_g.pt2"),
                                 3, SERVE_OUT, None, gen, "image")

    print(f"export check: ids at batches {json.dumps(checks)} against the "
          f"live model; the CLI's self-check {res['check']} near-tie flips "
          f"({check_launches} launches); profiler names {named}; int8 "
          f"{qwrong} mismatches outside {qties} near-ties; tiny logits "
          f"{logits_err:.3g} (card), {cpu_err:.3g} (moved to the CPU), "
          f"generator {gen_err:.3g} max abs", flush=True)
    print(f"export: ResNet-101 ids artifact {res['sidecar']['bytes']} bytes "
          f"(rows_per_call {art.rows_per_call}), export {res['export_s']:.2f}"
          f" s, save {res['save_s']:.2f} s, load {load_s:.2f} s; int8 "
          f"container {qres['sidecar']['bytes']} bytes ({ratio:.4f} of the "
          f"float artifact), export {qres['export_s']:.2f} s; batch of 8: "
          f"artifact {art_ms} ms, live forward + kernel {live_ms} ms "
          f"({art_ms / live_ms:.4f} x); launches {launches} on {card}",
          flush=True)
    print(f"export kernels, artifact against live (device ms of one batch "
          f"of 8 by kernel, torch.profiler): {json.dumps(kernel_diff)} on "
          f"{card}", flush=True)
    note("export", export_s=res["export_s"], load_s=load_s,
         int8_bytes_ratio=ratio, artifact_ms=art_ms, live_ms=live_ms)
    return launches


def device_kernel_diff(fn_a, fn_b, top: int = 4) -> dict:
    """The device time of one call of ``fn_a`` and of ``fn_b`` by kernel,
    from ``torch.profiler``: the totals, and the ``top`` kernels whose time
    differs most between them (a's ms, b's ms)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    def by_kernel(fn):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        ms = {}
        for e in prof.key_averages():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                name = e.key[:60]   # the names that share it, summed
                ms[name] = ms.get(name, 0.0) + getattr(
                    e, "self_device_time_total", 0.0) / 1e3
        return ms

    a, b = by_kernel(fn_a), by_kernel(fn_b)
    names = sorted(set(a) | set(b),
                   key=lambda k: -abs(a.get(k, 0.0) - b.get(k, 0.0)))
    return {"total_ms": [sum(a.values()), sum(b.values())],
            "most_apart": {k: [a.get(k, 0.0), b.get(k, 0.0)]
                           for k in names[:top]}}


def smoke_translator(root: str) -> str:
    """A GAN .pth with a UNet-256 s2t generator at ngf 64 (the GAN CLI's
    width; random weights from seed 60) in ``root``; its name."""
    from thermal_semantic_segmentation_torch.cli._common import (
        save_gan_checkpoint)
    from thermal_semantic_segmentation_torch.models.factory import (
        init_gan_net, unet_256)
    g = init_gan_net(unet_256(ngf=64, input_nc=3, output_nc=1), 60)
    save_gan_checkpoint(f"{root}/smoke_translator.pth", {"s2t": g}, {},
                        epoch=0)
    return "smoke_translator.pth"


def drive(server, images, encode=None) -> tuple:
    """One request a row of ``images`` from ``SERVE_THREADS`` threads
    through a started ``server`` (HTTP bypassed), each thread encoding its
    answers with ``encode`` as the HTTP handler would; returns ({request:
    answer}, seconds)."""
    from concurrent.futures import ThreadPoolExecutor

    def client(tid):
        mine = range(tid, len(images), SERVE_THREADS)
        waiters = [(i, server.submit(images[i])) for i in mine]
        out = []
        for i, w in waiters:
            answer = w.get(timeout=600)
            if isinstance(answer, Exception):
                fail(f"request {i} failed: {answer!r}")
            if encode is not None:
                encode(answer, "png")
            out.append((i, answer))
        return out

    t0 = time.perf_counter()
    with ThreadPoolExecutor(SERVE_THREADS) as pool:
        answers = dict(a for part in pool.map(client, range(SERVE_THREADS))
                       for a in part)
    return answers, time.perf_counter() - t0


def phase_serve_translator(card: str, root: str) -> None:
    """``serve --kind translator`` from a GAN .pth (UNet-256, ngf 64) at
    batch 8: 24 requests from 4 threads, each answer encoded to a PNG
    (zlib) by its thread; the answers held to the generator's forward and
    de-normalisation in float64 (a pixel may part from it only where its
    truncation lies within float32's error of an integer, as
    ``translate_float64`` bounds the translator); frames/s, the forward of
    a batch and the PNG encoding of a frame. It launches no kernel."""
    import copy

    import numpy as np
    import torch

    from thermal_semantic_segmentation_torch.cli import serve

    args = serve.serve_parse().parse_args(
        ["--kind", "translator", "-checkpoint_name", smoke_translator(root),
         "--gan_model_root_path", root, "-batch_size", str(SERVE_BATCH),
         "--max_wait_ms", "20"])
    server, handler_kw = serve.build_server(args)
    encode = handler_kw["encode"]
    server.warmup()
    server.start()
    # the preprocess's output: (x - 0.5) / 0.5 of seeded RGB pixels
    images = np.random.default_rng(61).uniform(
        -1, 1, (SERVE_REQUESTS, *SERVE_OUT, 3)).astype(np.float32)
    try:
        answers, secs = drive(server, images, encode)
    finally:
        server.stop()
    if server.requests_served != SERVE_REQUESTS:
        fail(f"translator served {server.requests_served} of "
             f"{SERVE_REQUESTS}")
    # the server's batch path on one batch of the first 8 requests, held to
    # float64 on the same batch; the coalesced answers to those rows
    rows = server._predict(images[:SERVE_BATCH])[..., 0].astype(np.int64)
    served = np.stack([answers[i][..., 0] for i in range(SERVE_BATCH)]
                      ).astype(np.int64)
    x = torch.from_numpy(images[:SERVE_BATCH]).cuda().permute(0, 3, 1, 2)
    with torch.inference_mode():
        # float32's de-normalisation as the server computes it: its error
        # against float64 is the generator's and the arithmetic's together
        v32 = ((server.model(x)[:, 0] * 0.5 + 0.5) * 255.0).clamp(
            0, 255).double().cpu().numpy()
        fake = copy.deepcopy(server.model).double()(x.double())[
            :, 0].cpu().numpy()
        forward_ms = time_ms(lambda: server.model(x), reps=5, warmup=1)
    v = np.clip((fake * 0.5 + 0.5) * 255.0, 0, 255)
    tau = float(np.abs(v32 - v).max())
    frac = np.minimum(v - np.floor(v), np.ceil(v) - v)
    near = (frac <= tau) & (v > 0) & (v < 255)
    err = np.abs(rows - np.floor(v))
    # another batch's composition moves a row's float32 by float32 noise
    # too: a truncation within TRANSLATE_SERVE_SLACK levels of an integer
    # may land either side
    loose = (frac <= max(4 * tau, TRANSLATE_SERVE_SLACK)) & (v > 0) & (v < 255)
    moved = np.abs(served - rows)
    frame = answers[0]
    t0 = time.perf_counter()
    for i in range(SERVE_BATCH):
        encode(answers[i], "png")
    encode_ms = (time.perf_counter() - t0) / SERVE_BATCH * 1e3
    print(f"serve_translator check: the batch path's {SERVE_BATCH} rows "
          f"against float64: max {int(err.max())} grey levels, "
          f"{int((err[~near] > 0).sum())} "
          f"pixels off away from {int(near.sum())} near decisions (float32 "
          f"error {tau:.3g} levels); the coalesced answers "
          f"{int((moved > 0).sum())} pixels off those rows, "
          f"{int((moved[~loose] > 0).sum())} away from a near integer; "
          f"frame {frame.shape} {frame.dtype}", flush=True)
    if frame.shape != (*SERVE_OUT, 1) or frame.dtype != np.uint8:
        fail(f"translator answered {frame.shape} {frame.dtype}")
    if (err[~near] > 0).any() or err.max() > 1:
        fail("translated bytes part from float64 beyond float32's error")
    if (moved[~loose] > 0).any() or moved.max() > 1:
        fail("the coalesced answers part from the server's batch path")
    print(f"serve_translator: {SERVE_REQUESTS} requests at batch "
          f"{SERVE_BATCH} from {SERVE_THREADS} threads, each PNG encoded by "
          f"its thread: {SERVE_REQUESTS / secs:.2f} frames/s ({secs:.3f} s, "
          f"{server.batches_run} batches); forward {forward_ms} ms a batch "
          f"of {SERVE_BATCH}, PNG encode {encode_ms:.3f} ms a frame on one "
          f"host thread, on {card}", flush=True)
    note("serve_translator", frames_per_s=SERVE_REQUESTS / secs,
         forward_ms=forward_ms, encode_ms=encode_ms)


def phase_serve_artifact(card: str, root: str) -> dict:
    """``serve --artifact`` of the export phase's ids artifact and the live
    server of ``smoke.pth``, ``ARTIFACT_REQUESTS`` requests a turn through
    each (``WARM_TURNS`` not counted, then ``SERVE_TURNS``): req/s as the
    median of each server's warm turns, a batch's forward ms, ids equal
    outside the live model's near-ties. Then a one-rank NCCL ``serve
    --distributed`` answers a batch, held to the live server. Returns the
    kernels' launch counts of two paths: ``serve_artifact``, zeroed before
    and read after each of the artifact's turns, and
    ``serve_distributed``, zeroed before and read after the ranked
    server's run."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from thermal_semantic_segmentation_torch.cli import serve
    from thermal_semantic_segmentation_torch.kernels.upsample_argmax import (
        upsample_argmax)

    base = ["-batch_size", str(SERVE_BATCH), "--max_wait_ms", "20"]
    seg = ["-checkpoint_name", "smoke.pth", "--model_root_path", root]
    live, _ = serve.build_server(serve.serve_parse().parse_args(seg + base))
    blob, _ = serve.build_server(serve.serve_parse().parse_args(
        ["--artifact", f"{root}/smoke_ids.pt2", *base]))
    images = np.random.default_rng(70).random(
        (ARTIFACT_REQUESTS, *SERVE_OUT, 1), dtype=np.float32)
    for server in (live, blob):
        server.warmup()
        server.start()
    artifact_launches = 0
    rates = {"live": [], "artifact": []}
    answers = {}
    try:
        for turn, name in enumerate(WARM_TURNS + SERVE_TURNS):
            server = live if name == "live" else blob
            upsample_argmax.launches = 0      # counts from the path only
            answers[name], secs = drive(server, images)
            if name == "artifact":
                artifact_launches += upsample_argmax.launches
            if turn >= len(WARM_TURNS):
                rates[name].append(ARTIFACT_REQUESTS / secs)
    finally:
        for server in (live, blob):
            server.stop()
    x8 = torch.from_numpy(images[:SERVE_BATCH]).cuda()
    with torch.inference_mode():
        art_ms = time_ms(lambda: blob._predict_rows(None, x8), reps=5,
                         warmup=1)
        live_ms = time_ms(lambda: live._ids(live.model, x8), reps=5,
                          warmup=1)
    got = np.stack([answers["artifact"][i] for i in range(ARTIFACT_REQUESTS)])
    want = np.stack([answers["live"][i] for i in range(ARTIFACT_REQUESTS)])
    logits = torch.cat([live_logits(live.model, torch.from_numpy(
        images[k:k + SERVE_BATCH]).cuda()) for k in range(
        0, ARTIFACT_REQUESTS, SERVE_BATCH)])
    wrong, ties = ids_mismatches(got, logits)
    live_wrong, _ = ids_mismatches(want, logits)
    del logits

    # one-rank NCCL serve --distributed: joins at parse time, serves its card
    args = serve.serve_parse().parse_args(seg + base + dist_flags_one_rank())
    ranked, _ = serve.build_server(args)
    backend, world = dist.get_backend(), dist.get_world_size()
    upsample_argmax.launches = 0          # counts from the path only
    ranked.start()
    try:
        waiters = [ranked.submit(images[i]) for i in range(SERVE_BATCH)]
        dist_ids = np.stack([w.get(timeout=600) for w in waiters])
    finally:
        ranked.stop()
        dist.destroy_process_group()
    launches = {"serve_artifact": {"upsample_argmax": artifact_launches},
                "serve_distributed": {
                    "upsample_argmax": upsample_argmax.launches}}
    dist_wrong, _ = ids_mismatches(dist_ids, live_logits(
        live.model, torch.from_numpy(images[:SERVE_BATCH]).cuda()))
    print(f"serve_artifact check: artifact ids {wrong}, live ids "
          f"{live_wrong}, serve --distributed ({backend}, world {world}) ids "
          f"{dist_wrong} mismatches outside {ties} near-ties of the live "
          f"model; launches {launches}", flush=True)
    if wrong or live_wrong or dist_wrong or backend != "nccl" or world != 1:
        fail("serve_artifact: ids disagree with the live model, or the "
             "ranked server was not one NCCL rank")
    median = {k: statistics.median(v) for k, v in rates.items()}
    ratio = median["artifact"] / median["live"]
    print(f"serve_artifact: {ARTIFACT_REQUESTS} requests a turn at batch "
          f"{SERVE_BATCH} from {SERVE_THREADS} threads, a warm-up turn each "
          f"({', '.join(WARM_TURNS)}) then {', '.join(SERVE_TURNS)}: "
          f"artifact {rates['artifact']} req/s, live {rates['live']} req/s "
          f"(medians {median['artifact']:.2f}, {median['live']:.2f}: "
          f"{ratio:.4f} x); a batch of {SERVE_BATCH}: artifact {art_ms} ms, "
          f"live {live_ms} ms on {card}", flush=True)
    note("serve_artifact", req_per_s=median["artifact"],
         live_req_per_s=median["live"], ratio=ratio, artifact_ms=art_ms,
         live_ms=live_ms)
    return launches


# the profile phase: profile_step's steps at full width (float32), each
# step's batch and flags; 2 warm-up steps and 5 profiled ones
PROFILE_STEPS = (
    ("eval", 8, ()), ("seg", 8, ()), ("self_train", 4, ()),
    ("gan", 4, ("--gan_cycle", "true", "--with_contour", "true",
                "--sem_loss", "true", "--ngf", "64")))
PROFILE_WARMUP, PROFILE_RUNS = 2, 5
PROFILE_KEYS = {"step", "batch_size", "wall_ms_per_step",
                "device_ms_per_step", "categories_ms_per_step"}
# the profiler's kernel time against the kernels phase's CUDA-event time
PROFILE_KERNEL_RATIO = (0.5, 2.0)
# the device_aug phase: raw frames at the loader's size (RAW_SIZE 960x320
# after the column crop 150:850), cropped to 256x512 in the step
AUG_RAW_HW = (320, 700)
AUG_IMAGES, AUG_VAL_IMAGES, AUG_BATCH = 40, 8, 8
AUG_ATOL = 1e-5
# the host_data phase: native decode of seeded 16-bit frames
NATIVE_FRAMES, NATIVE_FRAME_HW = 32, (400, 1200)


def profile_run(argv) -> tuple:
    """``profile_step.main(argv)``: (its final JSON line, its printed
    output, the trace's per-op microseconds)."""
    import contextlib
    import io

    from thermal_semantic_segmentation_torch.cli import profile_step
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        profile_step.main(argv)
    text = out.getvalue()
    logdir = argv[argv.index("--logdir") + 1]
    per_op, _ = profile_step._aggregate_trace(logdir)
    return json.loads(text.strip().splitlines()[-1]), text, per_op


def phase_profile(card: str, root: str, kernels: list) -> dict:
    """``profile_step`` at full width for the eval, seg, self_train and
    full GAN steps: each step's category table, its final line held to
    the JAX CLI's keys, device time within wall time, the categories
    summing to the device time, and (eval, gan) the kernel named among the
    ops with the time the kernels phase measured. Returns the launches of
    the phase's steps."""
    import torch

    from thermal_semantic_segmentation_torch.kernels.upsample_argmax import (
        upsample_argmax)
    kernel = kernels[0]
    # the kernel's CUDA-event time at each step's shape (kernels phase)
    expect_ms = {"eval": kernel["ms"], "gan": kernel["gan_shape"]["ms"]}
    per_step = {}
    upsample_argmax.launches = 0        # counts from the main path only
    for step, batch, extra in PROFILE_STEPS:
        before = upsample_argmax.launches
        logdir = f"{root}/profile_{step}"
        summary, text, per_op = profile_run(
            ["--step", step, "--batch_size", str(batch), "--bf16", "false",
             "--steps", str(PROFILE_RUNS), "--warmup", str(PROFILE_WARMUP),
             "--logdir", logdir, *extra])
        torch.cuda.empty_cache()
        launched = upsample_argmax.launches - before
        table = text[text.index(f"\n{step} step"):text.rindex("\n{")]
        print(f"profile {step} (batch {batch}, float32, {card}):{table}",
              flush=True)
        print(f"profile {step} line: {json.dumps(summary)}", flush=True)
        if set(summary) != PROFILE_KEYS:
            fail(f"profile {step}: keys {sorted(summary)}, not the JAX "
                 f"CLI's {sorted(PROFILE_KEYS)}")
        wall, dev = summary["wall_ms_per_step"], summary["device_ms_per_step"]
        cats = summary["categories_ms_per_step"]
        if not 0 < dev <= wall:
            fail(f"profile {step}: device {dev} ms/step outside (0, wall "
                 f"{wall}]")
        # each category is rounded to 0.001 ms
        if abs(sum(cats.values()) - dev) > 1e-3 * (len(cats) + 1):
            fail(f"profile {step}: categories sum to {sum(cats.values())}, "
                 f"device {dev}")
        conv = (cats.get("convolution", 0.0) + cats.get("gemm", 0.0)) / dev
        info = {"wall_ms": wall, "device_ms": dev, "conv_gemm_share": conv,
                "launches": launched}
        if step in expect_ms:
            names = [op for op in per_op if "upsample_argmax_kernel" in op]
            if not names:
                fail(f"profile {step}: upsample_argmax_kernel is not among "
                     f"the trace's ops")
            if launched != PROFILE_WARMUP + 2 * PROFILE_RUNS:
                fail(f"profile {step}: {launched} kernel launches for "
                     f"{PROFILE_WARMUP + 2 * PROFILE_RUNS} steps")
            got = sum(per_op[op] for op in names) / 1e3 / PROFILE_RUNS
            want = expect_ms[step]          # one launch a step
            ratio = got / want
            print(f"profile {step}: upsample_argmax_kernel {got:.5f} ms/step "
                  f"in the trace, the kernels phase's {want:.5f} ms x 1 "
                  f"launch a step (ratio {ratio:.3f})", flush=True)
            if not PROFILE_KERNEL_RATIO[0] <= ratio <= PROFILE_KERNEL_RATIO[1]:
                fail(f"profile {step}: the trace's kernel time {got} ms/step "
                     f"is not the kernels phase's {want} ms")
            info["kernel_ms"] = got
        per_step[step] = info
        note("profile", **{f"{step}_{k}": v for k, v in info.items()})
    print(f"profile: {json.dumps(per_step)} on {card}", flush=True)
    return {"upsample_argmax": upsample_argmax.launches}


def phase_device_aug(card: str, root: str) -> dict:
    """The train CLI's epoch loop with ``-device_aug true`` on raw frames
    (the step crops them on the card), then one validation through the
    kernel; the card's augmented batch against the CPU's from the same
    crop parameters; the augmentation's time against the step's."""
    import math

    import torch

    from thermal_semantic_segmentation_torch.cli.options import seg_parse
    from thermal_semantic_segmentation_torch.cli.segmentation_train import (
        make_loaders, train_epochs)
    from thermal_semantic_segmentation_torch.data.loader import split_indices
    from thermal_semantic_segmentation_torch.kernels.upsample_argmax import (
        upsample_argmax)
    from thermal_semantic_segmentation_torch.ops.augment import (
        random_resized_crop_flip, resized_crop_flip, sample_crop_params)
    from thermal_semantic_segmentation_torch.train.seg import (
        augment_generator)
    from thermal_semantic_segmentation_torch.utils.logging import get_logger

    raw = SeededImages(AUG_IMAGES, AUG_RAW_HW, seed=11)
    val_source = SeededImages(AUG_IMAGES, SERVE_OUT, seed=12)
    target = SeededImages(AUG_VAL_IMAGES, SERVE_OUT, seed=13)
    n_train, n_val = map(len, split_indices(AUG_IMAGES))
    steps = n_train // AUG_BATCH
    val_batches = (math.ceil(n_val / AUG_BATCH)
                   + math.ceil(AUG_VAL_IMAGES / AUG_BATCH))
    args = seg_parse().parse_args(
        ["-load_model", "true", "-checkpoint_name", "smoke.pth",
         "-new_checkpoint_name", "smoke_aug.pth", "--model_root_path", root,
         "-batch_size", str(AUG_BATCH), "-val_batch_size", str(AUG_BATCH),
         "-epochs", "1", "-device_aug", "true"])
    args.logdir = f"{root}/logs_aug"
    upsample_argmax.launches = 0        # counts from the main path only
    state, history = train_epochs(
        args, get_logger(args.logdir),
        *make_loaders(args, raw, target, val_source))
    launches = {"upsample_argmax": upsample_argmax.launches}
    h = history[0]
    losses = h["train_losses"]
    print(f"device_aug: {h['train_images']} raw {AUG_RAW_HW} images in "
          f"{len(losses)} steps of {AUG_BATCH}, losses {losses}, val_loss "
          f"{h['val_loss']}; launches {launches} for {val_batches} "
          f"validation batches", flush=True)
    if len(losses) != steps or not all(map(math.isfinite,
                                           losses + [h["val_loss"]])):
        fail(f"device_aug: {len(losses)} steps (want {steps}) or a "
             f"non-finite loss")
    if launches["upsample_argmax"] != val_batches:
        fail(f"device_aug: {launches['upsample_argmax']} kernel launches for "
             f"{val_batches} validation batches")

    # one step's augmentation on the card and on the CPU from the same
    # draws (the step's generator at step 0)
    image = torch.from_numpy(raw.images[:AUG_BATCH]).cuda()
    label = torch.from_numpy(raw.labels[:AUG_BATCH]).cuda()
    params = sample_crop_params(augment_generator(image.device, args.seed, 0),
                                AUG_BATCH, AUG_RAW_HW)
    got, got_lab = resized_crop_flip(image, params, SERVE_OUT, labels=label)
    want, want_lab = resized_crop_flip(
        image.cpu(), {k: v.cpu() for k, v in params.items()}, SERVE_OUT,
        labels=label.cpu())
    err = float((got.cpu() - want).abs().max())
    lab_diff = int((got_lab.cpu() != want_lab).sum())
    crops = {k: [round(float(x), 1) for x in v]
             for k, v in params.items() if k != "flip"}
    print(f"device_aug check: crops {crops}, flips "
          f"{params['flip'].tolist()}; images max abs err {err:.3g} "
          f"(tolerance {AUG_ATOL}), labels differing {lab_diff}", flush=True)
    if err > AUG_ATOL or lab_diff:
        fail(f"device_aug: the card's augmented batch differs from the "
             f"CPU's (images {err}, labels {lab_diff})")
    gen = augment_generator(image.device, args.seed, 0)
    aug_ms = time_ms(lambda: random_resized_crop_flip(
        gen, image, labels=label, out_hw=SERVE_OUT))
    step_ms = h["train_s"] / len(losses) * 1e3
    print(f"device_aug: augmentation {aug_ms:.4f} ms a batch of "
          f"{AUG_BATCH} ({AUG_RAW_HW} -> {SERVE_OUT}) against {step_ms:.1f} "
          f"ms a step of the loop (first epoch, cuDNN warm-up included), on "
          f"{card}", flush=True)
    note("device_aug", augment_ms=aug_ms, step_ms=step_ms,
         images_max_abs_err=err)
    del state
    torch.cuda.empty_cache()
    return launches


def ir_decode_numpy(pixels, resize_wh=(960, 320), crop=(150, 850),
                    window=(21800.0, 25000.0)):
    """``decode_ir_batch``'s arithmetic on one decoded frame, in numpy
    float32 in the C++ source's order: the half-pixel bilinear resize,
    the column crop, the window."""
    import numpy as np

    f32 = np.float32
    src = pixels.astype(f32)
    h, w = src.shape
    ow, oh = resize_wh

    def taps(n_out, n_in):
        scale = f32(n_in) / f32(n_out)
        pos = (np.arange(n_out, dtype=f32) + f32(0.5)) * scale - f32(0.5)
        pos = np.minimum(np.maximum(pos, f32(0)), f32(n_in) - f32(1))
        lo = pos.astype(np.int64)
        return lo, np.minimum(lo + 1, n_in - 1), (pos - lo.astype(f32))

    y0, y1, wy = taps(oh, h)
    x0, x1, wx = taps(ow, w)
    wx, wy = wx[None, :], wy[:, None]
    top = src[y0][:, x0] * (f32(1) - wx) + src[y0][:, x1] * wx
    bot = src[y1][:, x0] * (f32(1) - wx) + src[y1][:, x1] * wx
    out = top * (f32(1) - wy) + bot * wy
    v = np.clip(out[:, crop[0]:crop[1]], f32(window[0]), f32(window[1]))
    return (v - f32(window[0])) * (f32(1) / (f32(window[1]) - f32(window[0])))


def phase_host_data(card: str, root: str) -> dict:
    """The host data path: eval under bfloat16 autocast with ``--wire
    packed_bf16`` against ``packed`` (the same ids; the copy's bytes and
    time), the decode cache through a hit and a disk-tier reload, and the
    native C++ IO where the card's host can build it."""
    import os

    import numpy as np
    import torch

    from thermal_semantic_segmentation_torch.cli.options import (
        evaluation_parse)
    from thermal_semantic_segmentation_torch.data import native_loader as nl
    from thermal_semantic_segmentation_torch.data.cache import (
        DecodeCache, decode_cache, set_decode_cache)
    from thermal_semantic_segmentation_torch.data.device_pipeline import (
        device_prefetch)
    from thermal_semantic_segmentation_torch.data.loader import DataLoader
    from thermal_semantic_segmentation_torch.data.png import write_gray16_png
    from thermal_semantic_segmentation_torch.eval.validate import (
        seg_validate)
    from thermal_semantic_segmentation_torch.kernels.upsample_argmax import (
        upsample_argmax)
    from thermal_semantic_segmentation_torch.train.seg import (
        build_seg_eval_step)

    data = SeededImages(EVAL_IMAGES, SERVE_OUT, seed=21)
    model = load_smoke_model(evaluation_parse, root)
    step = build_seg_eval_step(num_classes=NUM_CLASSES, ignore_index=IGNORE,
                               bf16=True)

    def loader():
        return DataLoader(data, EVAL_BATCH, shuffle=False, drop_last=False)

    results, preds = {}, {}
    upsample_argmax.launches = 0        # counts from the main path only
    for wire in ("packed", "packed_bf16"):
        results[wire] = seg_validate(model, loader(), num_classes=NUM_CLASSES,
                                     ignore_index=IGNORE, eval_step=step,
                                     bf16=True, wire=wire)
        preds[wire] = [step(model, b["image"], b["label"])[2].cpu()
                       for b in device_prefetch(loader(), "cuda", wire=wire)]
    launches = {"upsample_argmax": upsample_argmax.launches}
    mismatched = sum(int((a != b).sum())
                     for a, b in zip(preds["packed"], preds["packed_bf16"]))
    print(f"host_data wire: mIoU/val_loss packed {results['packed'][:2]}, "
          f"packed_bf16 {results['packed_bf16'][:2]}; ids differing "
          f"{mismatched} of {sum(p.numel() for p in preds['packed'])}; "
          f"launches {launches}", flush=True)
    if mismatched or results["packed"][0] != results["packed_bf16"][0]:
        fail(f"--wire packed_bf16 changed {mismatched} ids of a bf16 eval")

    batch = {"image": data.images[:EVAL_BATCH],
             "label": data.labels[:EVAL_BATCH]}
    for wire in ("packed", "packed_bf16"):
        n_bytes = sum(v.nbytes // (2 if wire == "packed_bf16"
                                   and v.dtype == np.float32 else 1)
                      for v in batch.values())
        image_bytes = batch["image"].nbytes // (2 if wire == "packed_bf16"
                                                else 1)

        def put():
            for b in device_prefetch([batch], "cuda", wire=wire):
                pass
            torch.cuda.synchronize()
        put()
        times = []
        for _ in range(10):
            t0 = time.perf_counter()
            put()
            times.append((time.perf_counter() - t0) * 1e3)
        h2d = statistics.median(times)
        print(f"host_data wire {wire}: {n_bytes} bytes a batch of "
              f"{EVAL_BATCH} ({image_bytes} of images), host cast + pin + "
              f"copy + restore {h2d:.4f} ms (median of 10, synchronised) on "
              f"{card}", flush=True)
        note("host_data", **{f"{wire}_bytes": n_bytes,
                             f"{wire}_h2d_ms": h2d})

    # the decode cache: a miss, a RAM hit, then a fresh cache's disk hit
    frames_dir = os.path.join(root, "frames16")
    os.makedirs(frames_dir, exist_ok=True)
    rng = np.random.default_rng(22)
    frames = rng.integers(21000, 26000, (NATIVE_FRAMES, *NATIVE_FRAME_HW),
                          dtype=np.uint16)
    paths = [os.path.join(frames_dir, f"{i:04d}.png")
             for i in range(NATIVE_FRAMES)]
    for path, frame in zip(paths, frames):
        write_gray16_png(path, frame)
    calls = []

    def decode():
        calls.append(1)
        return ir_decode_numpy(frames[0])

    disk = os.path.join(root, "decoded")
    try:
        set_decode_cache(64, disk_dir=disk)
        first = decode_cache().get_or_decode(("ir", paths[0]), decode)
        hit = decode_cache().get_or_decode(("ir", paths[0]), decode)
        fresh = DecodeCache(64 << 20, disk_dir=disk)
        reloaded = fresh.get_or_decode(("ir", paths[0]), decode)
        stats = (decode_cache().hits, decode_cache().misses, fresh.disk_hits)
    finally:
        set_decode_cache(0, disk_dir=None)
    print(f"host_data decode cache: decodes {len(calls)}, (hits, misses, "
          f"fresh disk hits) {stats}", flush=True)
    if len(calls) != 1 or hit is not first or stats != (1, 1, 1) or \
            not np.array_equal(reloaded, first):
        fail(f"decode cache: {len(calls)} decodes, stats {stats}")

    if not nl.available():
        why = nl.unavailable_reason().splitlines()[0]
        print(f"host_data native: the C++ IO does not build on this host "
              f"(needs g++ with png.h and jpeglib.h): {why}", flush=True)
        note("host_data", native="unavailable")
        return launches
    # encode -> decode_raw round trips, gray and RGB
    imgs = rng.integers(0, 256, (3, 37, 53, 3), dtype=np.uint8)
    gray = rng.integers(0, 256, (2, 29, 41), dtype=np.uint8)
    enc = [os.path.join(root, f"enc_{i}.png") for i in range(5)]
    nl.encode_batch(enc[:3], imgs)
    nl.encode_batch(enc[3:], gray)
    exact = all(np.array_equal(nl.decode_raw(p), x) for p, x in zip(
        enc, [*imgs, *gray[..., None]]))
    got = nl.decode_ir_batch(paths)
    want = np.stack([ir_decode_numpy(f) for f in frames])[..., None]
    diff = int((got != want).sum())
    rates = {}
    for threads in (1, 8):
        nl.decode_ir_batch(paths, n_threads=threads)
        t0 = time.perf_counter()
        nl.decode_ir_batch(paths, n_threads=threads)
        rates[threads] = NATIVE_FRAMES / (time.perf_counter() - t0)
    print(f"host_data native: {nl.library_path().name} built; encode -> "
          f"decode_raw exact {exact}; decode_ir_batch of {NATIVE_FRAMES} "
          f"16-bit {NATIVE_FRAME_HW} frames against numpy: {diff} values "
          f"differ; frames/s at 1 thread {rates[1]:.1f}, at 8 threads "
          f"{rates[8]:.1f} (warm page cache, {os.cpu_count()} host cores)",
          flush=True)
    if not exact or diff:
        fail(f"native IO: round trips exact {exact}, {diff} decoded values "
             f"differ from numpy")
    note("host_data", native_frames_per_s_1=rates[1],
         native_frames_per_s_8=rates[8])
    return launches


# the host_io phase: a Freiburg tree at the raw frame size, read from files
HOST_IO_HW = (320, 960)
HOST_IO_TRAIN, HOST_IO_TEST = 32, 24     # train triples, test IR frames
HOST_IO_BATCHES = 30        # timed eval batches, the test frames cycled
HOST_IO_CLIENTS = 16        # HTTP connections: two server batches in flight
HOST_IO_REQUESTS = 320
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
# an 8x8 grey baseline JPEG: a request body a host without PIL answers 400
JPEG_BODY = bytes.fromhex(
    "ffd8ffe000104a46494600010100000100010000ffdb004300100b0c0e0c0a100e0d0e"
    "1211101318281a181616183123251d283a333d3c3933383740485c4e404457453738"
    "506d51575f626768673e4d71797064785c656763ffc0000b080008000801011100ff"
    "c4001f0000010501010101010100000000000000000102030405060708090a0bffc4"
    "00b5100002010303020403050504040000017d010203000411051221314106135161"
    "07227114328191a1082342b1c11552d1f02433627282090a161718191a2526272829"
    "2a3435363738393a434445464748494a535455565758595a636465666768696a7374"
    "75767778797a838485868788898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3"
    "b4b5b6b7b8b9bac2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9"
    "eaf1f2f3f4f5f6f7f8f9faffda0008010100003f00483c1dff004cff004affd9")


def png_filtered_rows(raw, bpp: int, first: int):
    """(n, row_bytes) uint8 rows -> the stream rows, row r filtered by
    type (first + r) % 5 of the PNG specification (None, Sub, Up, Average,
    Paeth) with its type byte in front; and the next row's type."""
    import numpy as np

    r = raw.astype(np.int16)
    n = len(r)
    up = np.vstack([np.zeros((1, r.shape[1]), np.int16), r[:-1]])
    pad = np.zeros((n, bpp), np.int16)
    left = np.hstack([pad, r[:, :-bpp]])
    upleft = np.hstack([pad, up[:, :-bpp]])
    p = left + up - upleft
    pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - upleft)
    paeth = np.where((pa <= pb) & (pa <= pc), left,
                     np.where(pb <= pc, up, upleft))
    preds = np.stack([np.zeros_like(r), left, up, (left + up) // 2, paeth])
    kinds = (first + np.arange(n)) % 5
    out = np.empty((n, r.shape[1] + 1), np.uint8)
    out[:, 0] = kinds
    out[:, 1:] = (r - preds[kinds, np.arange(n)]) % 256
    return out, (first + n) % 5


def write_png(path: str, pixels, interlace: bool = False) -> None:
    """A PNG of uint16 (H, W) grey, uint8 (H, W) grey or (H, W, 3) RGB
    pixels with zlib alone: its rows cycle through filter types 0-4, and
    with ``interlace`` it is Adam7."""
    import struct
    import zlib

    import numpy as np

    depth = 16 if pixels.dtype == np.uint16 else 8
    h, w = pixels.shape[:2]
    c = pixels.shape[2] if pixels.ndim == 3 else 1
    samples = pixels.reshape(h, w, c)
    stream, kind = [], 0
    for x0, y0, dx, dy in ADAM7 if interlace else ((0, 0, 1, 1),):
        sub = samples[y0::dy, x0::dx]
        if not sub.size:
            continue
        raw = np.ascontiguousarray(sub.astype(">u2") if depth == 16 else sub
                                   ).reshape(len(sub), -1).view(np.uint8)
        rows, kind = png_filtered_rows(raw, c * depth // 8, kind)
        stream.append(rows.tobytes())

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data)))
    header = struct.pack(">IIBBBBB", w, h, depth, 2 if c == 3 else 0, 0, 0,
                         int(interlace))
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", header)
                + chunk(b"IDAT", zlib.compress(b"".join(stream), 1))
                + chunk(b"IEND", b""))


def write_freiburg_tree(root: str, seed: int) -> dict:
    """A seeded Freiburg tree at the raw frame size: HOST_IO_TRAIN train
    triples (uint16 IR, RGB, labels) and HOST_IO_TEST test IR frames with
    .npy labels, written by ``write_png`` (the first IR frame Adam7).
    Returns {path: the array written}."""
    import os

    import numpy as np

    rng = np.random.default_rng(seed)
    base = os.path.join(root, "train", "seq_00_day", "00")
    written = {}
    for i in range(HOST_IO_TRAIN):
        for sub, arr in (
                ("fl_ir_aligned", rng.integers(21000, 26000, HOST_IO_HW,
                                               dtype=np.uint16)),
                ("fl_rgb", rng.integers(0, 256, (*HOST_IO_HW, 3),
                                        dtype=np.uint8)),
                ("fl_rgb_labels", rng.integers(0, NUM_CLASSES, HOST_IO_HW,
                                               dtype=np.uint8))):
            path = os.path.join(base, sub, f"{i:04d}.png")
            os.makedirs(os.path.dirname(path), exist_ok=True)
            write_png(path, arr, interlace=(i == 0 and sub == "fl_ir_aligned"))
            written[path] = arr
    test = os.path.join(root, "test", "day")
    os.makedirs(os.path.join(test, "ImagesIR"), exist_ok=True)
    os.makedirs(os.path.join(test, "SegmentationClass"), exist_ok=True)
    for i in range(HOST_IO_TEST):
        arr = rng.integers(21000, 26000, HOST_IO_HW, dtype=np.uint16)
        path = os.path.join(test, "ImagesIR", f"{i:04d}_ir.png")
        write_png(path, arr)
        written[path] = arr
        np.save(os.path.join(test, "SegmentationClass", f"{i:04d}_rgb.npy"),
                rng.integers(0, NUM_CLASSES, HOST_IO_HW, dtype=np.uint8))
    return written


class HeldSamples:
    """A dataset of samples already decoded (the in-memory comparison)."""

    def __init__(self, samples):
        self.samples = samples

    def __len__(self) -> int:
        return len(self.samples)

    def get(self, index: int, rng) -> dict:
        return self.samples[index]


def eval_loop(model, loader) -> dict:
    """``seg_validate`` of ``loader`` with each eval step bracketed by CUDA
    events and the host clock. Returns mean_iu and: first_batch_s, the
    loop's start to the first step (the first batch's decode, which nothing
    overlaps); steady_images_per_s, the images of every step over the
    device's span from the first step's start to the last step's end;
    steady_idle_share, the device's idle share of that span; wait_ms, the
    main thread's mean time from one step's return to the next step's call
    (waiting on the loader and the transfer); step_host_ms, its mean time
    inside a step (queueing the forward's kernels); cpu_parallelism, the
    process's CPU seconds a wall second over the loop."""
    import torch

    from thermal_semantic_segmentation_torch.eval.validate import (
        seg_validate)
    from thermal_semantic_segmentation_torch.train.seg import (
        build_seg_eval_step)

    step = build_seg_eval_step(num_classes=NUM_CLASSES, ignore_index=IGNORE)
    events, calls, returns, images = [], [], [], []

    def bracketed(model, image, label):
        calls.append(time.perf_counter())
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = step(model, image, label)
        end.record()
        events.append((start, end))
        images.append(len(image))
        returns.append(time.perf_counter())
        return out

    torch.cuda.synchronize()
    t0, cpu = time.perf_counter(), time.process_time()
    mean_iu, _, _ = seg_validate(model, loader, num_classes=NUM_CLASSES,
                                 ignore_index=IGNORE, eval_step=bracketed)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    busy = sum(a.elapsed_time(b) for a, b in events) / 1e3
    span = events[0][0].elapsed_time(events[-1][1]) / 1e3
    return {"mean_iu": mean_iu, "batches": len(calls), "wall_s": wall,
            "cpu_parallelism": (time.process_time() - cpu) / wall,
            "step_host_ms": 1e3 * statistics.mean(
                b - a for a, b in zip(calls, returns)),
            "first_batch_s": calls[0] - t0,
            "steady_images_per_s": sum(images) / span,
            "steady_idle_share": 1.0 - busy / span,
            "wait_ms": 1e3 * statistics.mean(
                [b - a for a, b in zip(returns, calls[1:])] or [0.0])}


def loader_alone(ds, indices, threads: int = 8) -> dict:
    """The loader alone over ``indices`` at batch EVAL_BATCH: the first
    batch's seconds, then images/s over the rest and the process's CPU
    seconds a wall second over them (how many of its threads ran at
    once)."""
    from thermal_semantic_segmentation_torch.data.loader import DataLoader

    t0 = time.perf_counter()
    first, n = None, 0
    for batch in DataLoader(ds, EVAL_BATCH, shuffle=False, drop_last=False,
                            indices=indices, num_threads=threads):
        if first is None:
            first, cpu = time.perf_counter(), time.process_time()
        else:
            n += len(batch["image"])
    wall = time.perf_counter() - first
    return {"first_batch_s": first - t0, "images_per_s": n / wall,
            "cpu_parallelism": (time.process_time() - cpu) / wall}


def serve_http(args) -> tuple:
    """``cli/serve.start_http(args)``: (the HTTP server, not yet serving,
    the started batcher); its steps as ``serve.main`` took them in a port
    that predates it."""
    from http.server import ThreadingHTTPServer

    from thermal_semantic_segmentation_torch.cli import serve
    from thermal_semantic_segmentation_torch.serving.endpoints import (
        make_handler)

    if hasattr(serve, "start_http"):
        return serve.start_http(args)
    server, handler_kw = serve.build_server(args)
    server.warmup()
    server.start()
    info = {"checkpoint": args.checkpoint_name,
            "batch_size": args.batch_size, "kind": args.kind}
    return (ThreadingHTTPServer((args.host, args.port),
                                make_handler(server, info, **handler_kw)),
            server)


def http_load(url: str, paths_file: str, n_requests: int, n_clients: int,
              out: str) -> int:
    """``--http-load``: a load generator in a process of its own (so that
    its threads do not share the server's interpreter). ``n_clients``
    keep-alive connections POST the files listed in ``paths_file`` in
    turn, ``n_requests`` in all; pickles {"answers": {i: (status, body,
    latency s)}, "wall_s"} to ``out``."""
    import http.client
    import pickle
    import threading
    import urllib.parse

    with open(paths_file) as f:
        bodies = []
        for path in f.read().split("\n"):
            with open(path, "rb") as g:
                bodies.append(g.read())
    where = urllib.parse.urlsplit(url)
    target = f"{where.path}?{where.query}"
    answers = {}

    def client(tid):
        conn = http.client.HTTPConnection(where.hostname, where.port,
                                          timeout=600)
        for i in range(tid, n_requests, n_clients):
            t0 = time.perf_counter()
            conn.request("POST", target, body=bodies[i % len(bodies)])
            r = conn.getresponse()
            answers[i] = (r.status, r.read(), time.perf_counter() - t0)
        conn.close()

    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(t,))
               for t in range(n_clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    with open(out, "wb") as f:
        pickle.dump({"answers": answers, "wall_s": wall}, f)
    return 0


def host_io_measure(card: str, root: str, tree: str, jpeg: bool) -> dict:
    """The file-read paths' numbers for the port as imported (this
    checkout's, or an older one's under ``--host-io-compare``), decode
    cache off: decode + resize ms a frame (IR test samples, RGB train
    samples) on one thread and through the loader alone (HOST_IO_BATCHES
    batches, the files cycled; IR at 2, 4 and 8 threads); the eval loop
    over those batches from memory and from the files with 8 and 2 loader
    threads (``eval_loop``), their mIoU equal; ``serve`` over
    HTTP on 127.0.0.1 under ``http_load`` (HOST_IO_REQUESTS requests from
    HOST_IO_CLIENTS connections, two batches in flight), every answer's
    ids held to the in-process forward of its bytes outside near-ties;
    with ``jpeg``, a JPEG body answered 400. Returns the numbers, the
    in-memory mIoU of the test frames once over (``memory_iu``) and the
    server's kernel launches (``serve_launches``)."""
    import os
    import pickle
    import threading

    import numpy as np
    import torch

    from thermal_semantic_segmentation_torch.cli._common import val_transform
    from thermal_semantic_segmentation_torch.cli.options import (
        evaluation_parse)
    from thermal_semantic_segmentation_torch.cli.serve import serve_parse
    from thermal_semantic_segmentation_torch.data.cache import (
        decode_cache, set_decode_cache)
    from thermal_semantic_segmentation_torch.data.freiburg import (
        Freiburg, FreiburgTest)
    from thermal_semantic_segmentation_torch.data.loader import DataLoader
    from thermal_semantic_segmentation_torch.kernels.upsample_argmax import (
        upsample_argmax, upsample_argmax_reference)
    from thermal_semantic_segmentation_torch.ops.resize import upsample_logits
    from thermal_semantic_segmentation_torch.serving.batcher import (
        preprocess)

    set_decode_cache(0, disk_dir=None)
    hits = decode_cache().hits
    out = {}
    test_ds = FreiburgTest(tree, "test", "IR", transforms=val_transform())
    rgb_ds = Freiburg(tree, "train", "RGB", transforms=val_transform())
    cycled = [i % len(test_ds)
              for i in range(HOST_IO_BATCHES * EVAL_BATCH)]
    for kind, ds in (("ir", test_ds), ("rgb", rgb_ds)):
        ds.get(0, None)     # what builds at first use
        n = min(len(ds), HOST_IO_TEST)
        t0 = time.perf_counter()
        for i in range(n):
            ds.get(i, None)
        out[f"decode_ms_{kind}_1_thread"] = (
            (time.perf_counter() - t0) * 1e3 / n)
        for threads in (2, 4, 8) if kind == "ir" else (8,):
            alone = loader_alone(ds, [i % len(ds) for i in range(
                len(cycled))], threads)
            out[f"loader_{kind}_{threads}_ms"] = 1e3 / alone["images_per_s"]
            out[f"loader_{kind}_{threads}_cpu_parallelism"] = alone[
                "cpu_parallelism"]
        out[f"decode_ms_{kind}_loader"] = 1e3 / alone["images_per_s"]
        out[f"loader_{kind}_first_batch_s"] = alone["first_batch_s"]

    model = load_smoke_model(evaluation_parse, root)
    held = HeldSamples([test_ds.get(i, None) for i in range(len(test_ds))])
    out["memory_iu"] = eval_loop(model, DataLoader(
        held, EVAL_BATCH, shuffle=False, drop_last=False))["mean_iu"]
    for name, ds, threads in (("memory", held, 8), ("files", test_ds, 8),
                              ("files_2", test_ds, 2)):
        run = eval_loop(model, DataLoader(ds, EVAL_BATCH, shuffle=False,
                                          drop_last=False, indices=cycled,
                                          num_threads=threads))
        out.update({f"eval_{name}_{k}": v for k, v in run.items()})
    ious = {k: v for k, v in out.items() if k.endswith("_mean_iu")}
    if len(set(ious.values())) != 1:
        fail(f"host_io: the file-read evals' mIoU differ from the in-memory "
             f"eval's: {ious}")
    if decode_cache().hits != hits:
        fail("host_io: the decode cache was used")
    del model
    torch.cuda.empty_cache()

    paths = test_ds.data_list
    args = serve_parse().parse_args(
        ["-checkpoint_name", "smoke.pth", "--model_root_path", root,
         "-batch_size", str(EVAL_BATCH), "--max_wait_ms", "20", "--host",
         "127.0.0.1", "--port", str(free_port())])
    url = f"http://127.0.0.1:{args.port}/segment?format=ids"
    work = os.path.join(root, "host_io_http")
    os.makedirs(work, exist_ok=True)
    with open(os.path.join(work, "bodies.txt"), "w") as f:
        f.write("\n".join(paths))
    with open(os.path.join(work, "jpeg.txt"), "w") as f:
        f.write(os.path.join(work, "body.jpg"))
    with open(os.path.join(work, "body.jpg"), "wb") as f:
        f.write(JPEG_BODY)

    def load(listed, n, clients):
        subprocess.run([sys.executable, os.path.abspath(__file__),
                        "--http-load", url, os.path.join(work, listed),
                        str(n), str(clients),
                        os.path.join(work, "answers.pkl")],
                       check=True, timeout=600)
        with open(os.path.join(work, "answers.pkl"), "rb") as f:
            return pickle.load(f)

    upsample_argmax.launches = 0        # counts from the server only
    httpd, server = serve_http(args)
    serving = threading.Thread(target=httpd.serve_forever, daemon=True)
    serving.start()
    try:
        run = load("bodies.txt", HOST_IO_REQUESTS, HOST_IO_CLIENTS)
        jpeg_answer = load("jpeg.txt", 1, 1)["answers"][0] if jpeg else None
    finally:
        httpd.shutdown()
        httpd.server_close()
        server.stop()
        serving.join(timeout=60)
    out["serve_launches"] = upsample_argmax.launches
    answers = run["answers"]
    bad = {i: a[:2] for i, a in answers.items() if a[0] != 200}
    if len(answers) != HOST_IO_REQUESTS or bad:
        fail(f"host_io serve: {len(answers)} answers, not 200: {bad}")
    mismatched = ties = 0
    with torch.inference_mode():
        for lo in range(0, len(paths), EVAL_BATCH):
            bodies = []
            for path in paths[lo:lo + EVAL_BATCH]:
                with open(path, "rb") as f:
                    bodies.append(f.read())
            x = torch.from_numpy(np.stack([preprocess(b) for b in bodies])
                                 ).cuda()
            logits = server.model(x.permute(0, 3, 1, 2))["out"].float(
            ).permute(0, 2, 3, 1)
            want, _ = upsample_argmax_reference(logits, *SERVE_OUT)
            top2 = upsample_logits(logits, *SERVE_OUT).topk(2, dim=-1).values
            decided = ((top2[..., 0] - top2[..., 1]) > TIE_GAP).cpu().numpy()
            want = want.cpu().numpy()
            for i, a in answers.items():
                j = i % len(paths) - lo
                if 0 <= j < len(bodies):
                    got = read_png_ids(a[1])
                    ties += int((~decided[j]).sum())
                    mismatched += int(((got != want[j]) & decided[j]).sum())
    if mismatched:
        fail(f"host_io serve: {mismatched} ids differ from the in-process "
             f"forward outside near-ties")
    lat = np.asarray([a[2] for a in answers.values()]) * 1e3
    out.update(http_req_per_s=len(answers) / run["wall_s"],
               http_p50_ms=float(np.percentile(lat, 50)),
               http_p95_ms=float(np.percentile(lat, 95)),
               http_ids_mismatched=mismatched, http_near_ties=ties)
    if jpeg:
        jpeg_note = f"{jpeg_answer[0]} {jpeg_answer[1].decode(errors='replace')!r}"
        out["jpeg_answer"] = jpeg_note
        if not (jpeg_answer[0] == 400 and b"JPEG is not decoded on this host"
                in jpeg_answer[1] and b"PNG" in jpeg_answer[1]):
            fail(f"host_io serve: the JPEG body got {jpeg_note}")
    del server
    torch.cuda.empty_cache()
    return out


def pillow_oracle(tree: str) -> int:
    """``--pillow-oracle``: in a process of its own, with Pillow imported,
    the port's reader and resamplers held to Pillow exactly on every PNG of
    the host_io tree: ``read_png`` against ``np.asarray(Image.open())``;
    ``load_ir_image``, ``load_rgb_image`` (RGB and grey) and ``load_label``
    against the same steps in Pillow (the resize to RAW_SIZE, the column
    crop, the IR window); and each result's resize to 512x256 (BICUBIC;
    BILINEAR for RGB as the self-training augmentation; NEAREST for labels).
    Prints one JSON line: Pillow's version, arrays compared, the names of
    those that differ."""
    import glob
    import os

    import numpy as np
    import PIL
    from PIL import Image, ImageFile

    from thermal_semantic_segmentation_torch.data import image as im
    from thermal_semantic_segmentation_torch.data import png
    from thermal_semantic_segmentation_torch.data.freiburg import (
        COL_CROP, IR_MAX, IR_MIN, RAW_SIZE, load_ir_image, load_label,
        load_rgb_image)

    ImageFile.LOAD_TRUNCATED_IMAGES = True
    size = (512, 256)
    crop = slice(*COL_CROP)
    compared, differ = 0, []

    def check(name, got, want):
        nonlocal compared
        compared += 1
        if not (got.dtype == want.dtype and np.array_equal(got, want)):
            differ.append(name)

    def pil_resize(arr, resample):
        return np.asarray(Image.fromarray(arr).resize(size, resample))

    for path in sorted(glob.glob(os.path.join(tree, "**", "*.png"),
                                 recursive=True)):
        name = os.path.relpath(path, tree)
        with Image.open(path) as img:
            check(f"read_png {name}", png.read_png(path).pixels,
                  np.asarray(img))
            if "ImagesIR" in path or "fl_ir_aligned" in path:
                x = np.array(img.resize(RAW_SIZE, Image.BICUBIC),
                             np.float32)[:, crop]
                want = (np.clip(x, IR_MIN, IR_MAX) - IR_MIN) / (
                    IR_MAX - IR_MIN)
                got = load_ir_image(path)
                check(f"ir {name}", got, want)
                check(f"ir 512x256 {name}", im.resize(got, size, im.BICUBIC),
                      pil_resize(want, Image.BICUBIC))
            elif "fl_rgb_labels" in path:
                want = np.asarray(img.resize(RAW_SIZE, Image.NEAREST))[
                    :, crop]
                got = load_label(path)
                check(f"label {name}", got, want)
                check(f"label 512x256 {name}",
                      im.resize(got, size, im.NEAREST),
                      pil_resize(np.ascontiguousarray(want), Image.NEAREST))
            else:
                for mode in ("RGB", "L"):
                    want = np.ascontiguousarray(np.asarray(
                        img.convert(mode).resize(RAW_SIZE, Image.BICUBIC))[
                            :, crop])
                    got = load_rgb_image(path, grayscale=mode == "L")
                    check(f"{mode} {name}", got, want)
                    for resample, pil in ((im.BICUBIC, Image.BICUBIC),
                                          (im.BILINEAR, Image.BILINEAR)):
                        check(f"{mode} 512x256 {resample} {name}",
                              im.resize(got, size, resample),
                              pil_resize(want, pil))
    print(json.dumps({"pillow": PIL.__version__, "compared": compared,
                      "differ": len(differ), "first": differ[:5]}),
          flush=True)
    return 0


def host_io_child(package: str, root: str, tree: str, card: str,
                  block_pil: bool) -> int:
    """``--host-io-child``: ``host_io_measure`` of the port in
    ``package`` (a checkout's root), with ``import PIL`` failing when
    ``block_pil``; prints its numbers as one JSON line."""
    import os

    sys.path.insert(0, os.path.abspath(package))
    if block_pil:
        sys.modules["PIL"] = None
    import thermal_semantic_segmentation_torch as port

    numbers = host_io_measure(card, root, tree, jpeg=False)
    print(json.dumps({"package": os.path.dirname(port.__file__),
                      "pil_loaded": any(k.split(".")[0] == "PIL" and v
                                        for k, v in sys.modules.items()),
                      **numbers}), flush=True)
    return 0


def host_io_compare(other: str) -> int:
    """``--host-io-compare DIR``: ``host_io_measure`` of the port in DIR
    (another checkout's root, e.g. an older commit that reads images with
    PIL) against this checkout's with PIL blocked, on one seeded tree and
    checkpoint, in four processes in the order DIR, this, this, DIR. Prints
    a line a process and one of the medians of each side."""
    import os

    import torch

    from thermal_semantic_segmentation_torch.models.deeplab import (
        create_deeplab)

    card = phase_device()
    here = os.path.dirname(os.path.abspath(__file__))
    runs = {"other": [], "this": []}
    with tempfile_dir() as root:
        torch.save({"epoch": 0,
                    "sem_net_state_dict": create_deeplab(0).state_dict()},
                   f"{root}/smoke.pth")
        tree = os.path.join(root, "host_io", "freiburg")
        write_freiburg_tree(tree, seed=31)
        for side in ("other", "this", "this", "other"):
            package = other if side == "other" else here
            r = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--host-io-child",
                 package, root, tree, card, str(int(side == "this"))],
                capture_output=True, text=True, timeout=900)
            if r.returncode:
                print(r.stdout[-4000:], r.stderr[-4000:], flush=True)
                fail(f"host_io compare: the {side} run failed")
            numbers = json.loads(r.stdout.strip().splitlines()[-1])
            runs[side].append(numbers)
            print(f"host_io compare {side}: {json.dumps(numbers)} on {card}",
                  flush=True)
    keys = [k for k, v in runs["this"][0].items()
            if isinstance(v, float) and k in runs["other"][0]]
    print("host_io compare medians (this / other): " + json.dumps(
        {k: [statistics.median(r[k] for r in runs[s])
             for s in ("this", "other")] for k in keys}) + f" on {card}",
          flush=True)
    print(card, flush=True)
    return 0


def phase_host_io(card: str, root: str) -> dict:
    """``host_io_run`` with every import of PIL failing, as on a host
    without PIL (the card's host may have it installed); afterwards PIL
    must not be in ``sys.modules``. Then, where Pillow is installed, the
    reader and the resamplers held to it (``pillow_oracle`` and the CPU
    tests of both, processes of their own). Returns the kernels' launches
    a path."""
    import importlib.util
    import os

    installed = importlib.util.find_spec("PIL") is not None
    if "PIL" in sys.modules:
        fail("host_io: PIL was imported before the phase")
    sys.modules["PIL"] = None       # every import of PIL now fails
    try:
        launches = host_io_run(card, root)
    finally:
        blocked = "PIL" in sys.modules and sys.modules["PIL"] is None
        sys.modules.pop("PIL", None)
    leaked = sorted(k for k in sys.modules if k.split(".")[0] == "PIL")
    print(f"host_io PIL: installed on this host {installed}, blocked for the "
          f"phase {blocked}; after it 'PIL' in sys.modules "
          f"{'PIL' in sys.modules}, PIL modules {leaked}; on {card}",
          flush=True)
    if not blocked or leaked or "PIL" in sys.modules:
        fail(f"host_io: PIL was loaded ({leaked})")
    note("host_io", pil_installed=installed)
    if not installed:
        print(f"host_io pillow: not installed on this host, no oracle; on "
              f"{card}", flush=True)
        return launches
    r = subprocess.run([sys.executable, os.path.abspath(__file__),
                        "--pillow-oracle",
                        os.path.join(root, "host_io", "freiburg")],
                       capture_output=True, text=True, timeout=300)
    if r.returncode:
        print(r.stdout[-4000:], r.stderr[-4000:], flush=True)
        fail("host_io: the Pillow oracle failed")
    oracle = json.loads(r.stdout.strip().splitlines()[-1])
    print(f"host_io pillow: the port's read_png, IR window, RGB/grey and "
          f"label loads and 512x256 resizes against Pillow "
          f"{oracle['pillow']} on this host: {oracle['compared']} arrays, "
          f"{oracle['differ']} differ {oracle['first']}; on {card}",
          flush=True)
    if oracle["differ"]:
        fail(f"host_io: {oracle['differ']} arrays differ from Pillow's")
    # the CPU tests that hold the reader and the resamplers to Pillow (the
    # 'I;16' overshoot, every mode, filter and direction), on this host's
    # Pillow; without tests/conftest.py, which imports JAX
    r = subprocess.run([sys.executable, "-m", "pytest", "--noconftest", "-q",
                        "-p", "no:cacheprovider",
                        "tests/test_torch_png_read.py",
                        "tests/test_torch_image_ops.py"],
                       capture_output=True, text=True, timeout=300,
                       cwd=os.path.dirname(os.path.abspath(__file__)))
    tail = (r.stdout.strip().splitlines() or ["no output"])[-1]
    print(f"host_io pillow tests: tests/test_torch_png_read.py and "
          f"tests/test_torch_image_ops.py against Pillow {oracle['pillow']} "
          f"on this host: {tail}; on {card}", flush=True)
    if r.returncode:
        print(r.stdout[-4000:], r.stderr[-4000:], flush=True)
        fail("host_io: the Pillow tests failed on this host")
    note("host_io", pillow_arrays=oracle["compared"],
         pillow_differ=oracle["differ"])
    return launches


def host_io_run(card: str, root: str) -> dict:
    """The entry points read files on the card's host: a seeded Freiburg
    tree of PNGs (every filter type, one Adam7 file) read back exactly by
    the port's own reader; ``host_io_measure`` (decode ms, the eval loop
    from files and from memory, ``serve`` over HTTP, a JPEG body's 400);
    ``segmentation_evaluate`` through its ``main`` held to the in-memory
    eval of the same decoded arrays; ``segmentation_train`` three steps.
    Returns the kernels' launches a path."""
    import os

    import numpy as np
    import torch

    from thermal_semantic_segmentation_torch.cli import (
        segmentation_evaluate, segmentation_train)
    from thermal_semantic_segmentation_torch.data import png
    from thermal_semantic_segmentation_torch.kernels.upsample_argmax import (
        upsample_argmax)

    tree = os.path.join(root, "host_io", "freiburg")
    t0 = time.perf_counter()
    written = write_freiburg_tree(tree, seed=31)
    write_s = time.perf_counter() - t0
    wrong = [p for p, arr in written.items()
             if not (png.read_png(p).pixels.dtype == arr.dtype
                     and np.array_equal(png.read_png(p).pixels, arr))]
    print(f"host_io tree: {len(written)} PNGs at {HOST_IO_HW} ({HOST_IO_TRAIN}"
          f" train triples, {HOST_IO_TEST} test IR frames with .npy labels; "
          f"rows through filter types 0-4, one Adam7 file) written in "
          f"{write_s:.2f} s; decoded back by the port's reader: "
          f"{len(written) - len(wrong)} exact, {len(wrong)} not; on {card}",
          flush=True)
    if wrong:
        fail(f"host_io: {len(wrong)} files do not decode to what was "
             f"written: {wrong[:3]}")

    m = host_io_measure(card, root, tree, jpeg=True)
    frames = HOST_IO_BATCHES * EVAL_BATCH
    print(f"host_io decode: ms a frame (PNG decode, PIL's resizes, window or "
          f"crop, label), decode cache off: IR {m['decode_ms_ir_1_thread']:.2f}"
          f" on one thread, {m['decode_ms_ir_loader']:.2f} through the loader "
          f"alone ({frames} frames, the files cycled, the first batch "
          f"{m['loader_ir_first_batch_s']:.3f} s apart); RGB "
          f"{m['decode_ms_rgb_1_thread']:.2f} / {m['decode_ms_rgb_loader']:.2f}"
          f" (first batch {m['loader_rgb_first_batch_s']:.3f} s); the "
          f"loader alone on IR at 2, 4, 8 threads: ms a frame "
          + ", ".join(f"{m[f'loader_ir_{t}_ms']:.2f} (CPU parallelism "
                      f"{m[f'loader_ir_{t}_cpu_parallelism']:.2f})"
                      for t in (2, 4, 8))
          + f"; {os.cpu_count()} host cores; on {card}", flush=True)
    for name in ("files", "files_2", "memory"):
        print(f"host_io eval {name}: {m[f'eval_{name}_batches']} batches of "
              f"{EVAL_BATCH} (the test frames cycled): first batch "
              f"{m[f'eval_{name}_first_batch_s']:.3f} s, then "
              f"{m[f'eval_{name}_steady_images_per_s']:.2f} images/s over "
              f"the device's span, device idle share "
              f"{m[f'eval_{name}_steady_idle_share']:.3f}, the main thread "
              f"waits {m[f'eval_{name}_wait_ms']:.2f} ms a batch and spends "
              f"{m[f'eval_{name}_step_host_ms']:.2f} in a step, CPU "
              f"parallelism {m[f'eval_{name}_cpu_parallelism']:.2f}; mIoU "
              f"{m[f'eval_{name}_mean_iu']}; on {card}", flush=True)
    print(f"host_io serve: {HOST_IO_REQUESTS} 16-bit {HOST_IO_HW} PNG "
          f"bodies over HTTP from {HOST_IO_CLIENTS} keep-alive connections "
          f"in a load process of their own (server batch {EVAL_BATCH}) at "
          f"{m['http_req_per_s']:.2f} req/s, latency p50 "
          f"{m['http_p50_ms']:.1f} ms p95 {m['http_p95_ms']:.1f} ms; ids vs "
          f"the in-process forward of the same bytes: "
          f"{m['http_ids_mismatched']} pixels differ outside "
          f"{m['http_near_ties']} near-ties; JPEG body: {m['jpeg_answer']}; "
          f"launches {m['serve_launches']} on {card}", flush=True)
    note("host_io", **{k: v for k, v in m.items()
                       if isinstance(v, float) and not k.endswith("iu")})
    by_path = {"host_io_serve": {"upsample_argmax": m["serve_launches"]}}

    # segmentation_evaluate through its main, files read
    argv = ["-dataset", "freiburg_ir", "--freiburg_root", tree,
            "-checkpoint_name", "smoke.pth", "--model_root_path", root,
            "-val_batch_size", str(EVAL_BATCH)]
    upsample_argmax.launches = 0        # counts from the main path only
    cli_iu, cli_loss, _ = segmentation_evaluate.main(argv)
    by_path["host_io_eval"] = {"upsample_argmax": upsample_argmax.launches}
    print(f"host_io eval: segmentation_evaluate.main on the files mIoU "
          f"{cli_iu} (val_loss {cli_loss}), the in-memory eval of the same "
          f"decoded arrays {m['memory_iu']}; launches "
          f"{by_path['host_io_eval']} on {card}", flush=True)
    if cli_iu != m["memory_iu"]:
        fail(f"host_io: the file-read eval's mIoU {cli_iu} differs from the "
             f"in-memory eval's {m['memory_iu']}")

    # segmentation_train through its main, files read, three steps
    argv = ["-dataset", "freiburg_ir", "--freiburg_root", tree,
            "-load_model", "true", "-checkpoint_name", "smoke.pth",
            "--model_root_path", root, "-new_checkpoint_name", "host_io.pth",
            "-epochs", "1", "-max_steps", "3", "-batch_size",
            str(EVAL_BATCH), "-val_batch_size", str(EVAL_BATCH)]
    here = os.getcwd()
    os.chdir(os.path.join(root, "host_io"))     # the CLI writes logs/ here
    try:
        upsample_argmax.launches = 0    # counts from the main path only
        state, history = segmentation_train.main(argv)
        by_path["host_io_train"] = {
            "upsample_argmax": upsample_argmax.launches}
    finally:
        os.chdir(here)
    del state
    torch.cuda.empty_cache()
    h = history[-1]
    print(f"host_io train: segmentation_train.main on the files: "
          f"{len(h['train_losses'])} steps of {EVAL_BATCH}, losses "
          f"{h['train_losses']}, val_loss {h['val_loss']}; "
          f"{h['train_images'] / h['train_s']:.2f} images/s over the three "
          f"steps (the first one's set-up included), in-memory train phase "
          f"{NOTES.get('train', {}).get('f32_images_per_s', 'not run')} "
          f"images/s; launches {by_path['host_io_train']} on {card}",
          flush=True)
    if len(h["train_losses"]) != 3 or not all(
            np.isfinite(h["train_losses"] + [h["val_loss"]])):
        fail(f"host_io train: {h['train_losses']}, val_loss {h['val_loss']}")
    note("host_io", train_files_images_per_s=h["train_images"] / h["train_s"])
    return by_path


RECIPE_FRAMES = 16         # the gates' smoke tree: source = target frames
RECIPE_FEATURE_WIDTH = 256   # the module2 head's 'feat' width
RECIPE_FULL_WIDTH = "3,4,23,3"   # the convergence chain's ResNet-101
RECIPE_FULL_WIDTH_LR = "0.001"


def recipe_cli_vs_memory(tree: str, ckpt: str, name: str,
                         batch: int) -> tuple:
    """(CLI mIoU, in-memory mIoU, layers): checkpoint ``name`` through the
    eval CLI's ``main`` at ``-val_batch_size batch``, and through
    ``seg_validate`` on the same decoded test arrays at the same batch
    (comparison launches: not counted)."""
    import os

    import torch

    from thermal_semantic_segmentation_torch.cli import segmentation_evaluate
    from thermal_semantic_segmentation_torch.cli._common import (
        apply_model_meta, build_deeplab, load_seg_checkpoint, val_transform)
    from thermal_semantic_segmentation_torch.cli.options import (
        evaluation_parse)
    from thermal_semantic_segmentation_torch.data.freiburg import FreiburgTest
    from thermal_semantic_segmentation_torch.data.loader import DataLoader
    from thermal_semantic_segmentation_torch.eval.validate import seg_validate

    argv = ["-dataset", "freiburg_ir", "--freiburg_root", tree,
            "-checkpoint_name", name, "--model_root_path", ckpt,
            "-val_batch_size", str(batch)]
    cli_iu, _, _ = segmentation_evaluate.main(argv)
    args = evaluation_parse().parse_args(argv)
    state_dict, meta = load_seg_checkpoint(os.path.join(ckpt, name))
    apply_model_meta(args, meta)
    model = build_deeplab(args)
    model.load_state_dict(state_dict, strict=True)
    test_ds = FreiburgTest(tree, "test", "IR", transforms=val_transform())
    held = HeldSamples([test_ds.get(i, None) for i in range(len(test_ds))])
    memory_iu, _, _ = seg_validate(
        model, DataLoader(held, batch, shuffle=False, drop_last=False),
        num_classes=NUM_CLASSES, ignore_index=IGNORE)
    del model
    torch.cuda.empty_cache()
    return cli_iu, memory_iu, tuple(args.layers)


def phase_recipe(card: str, root: str) -> dict:
    """The gates' wiring run on the card (``recipes/gates.py --smoke``,
    in this process): the GAN gate's chain, then the pipeline gate's on
    its work directory, the self-training gate's (layers 1,1,1,1) and the
    convergence gate's at full width (layers 3,4,23,3, bf16), each in a
    directory of its own, every stage through its CLI's ``main`` on a
    16-frame tree of files. Checks the outputs' counts and loads, the
    measures' ranges, and each chain's final CLI mIoU against the
    in-memory eval of the same checkpoint on the same decoded arrays.
    Returns the kernel's launches over the four chains."""
    import glob
    import math
    import os

    import numpy as np

    from thermal_semantic_segmentation_torch.cli._common import (
        load_gan_checkpoint, load_seg_checkpoint)
    from thermal_semantic_segmentation_torch.core.checkpoint import (
        load_checkpoint)
    from thermal_semantic_segmentation_torch.kernels.upsample_argmax import (
        upsample_argmax)
    from thermal_semantic_segmentation_torch.recipes import gates

    work = os.path.join(root, "recipe")
    stages = {g: gates.Stages() for g in ("gan", "pipeline", "selftrain",
                                          "convergence")}
    upsample_argmax.launches = 0        # counts from the main path only
    gan = gates.gan_gate(f"{work}/gate", smoke=True, stages=stages["gan"])
    pipeline = gates.pipeline_gate(f"{work}/gate", smoke=True,
                                   stages=stages["pipeline"])
    selftrain = gates.selftrain_gate(f"{work}/selftrain", smoke=True,
                                     stages=stages["selftrain"])
    convergence = gates.convergence_gate(
        f"{work}/convergence", smoke=True, stages=stages["convergence"],
        layers=RECIPE_FULL_WIDTH, lr=RECIPE_FULL_WIDTH_LR)
    launches = {"upsample_argmax": upsample_argmax.launches}
    failures = []

    def count(tmp, *parts):
        return len(glob.glob(os.path.join(tmp, *parts)))

    def labels_and_prototypes(tmp, model):
        """The pseudo-label files of ``model`` by kind, and its
        prototypes' shape; a miss is a failure."""
        pseudo = {kind: count(tmp, "pseudo_labels", mode, model, pattern)
                  for kind, mode, pattern in (
                      ("soft", "soft", "[0-9][0-9][0-9][0-9].npy"),
                      ("hard", "hard", "[0-9][0-9][0-9][0-9].png"),
                      ("hard_color", "hard", "*_color.png"),
                      ("hard_conf", "hard", "*_conf.npy"))}
        if set(pseudo.values()) != {RECIPE_FRAMES}:
            failures.append(f"{model}: pseudo-label files {pseudo}, want "
                            f"{RECIPE_FRAMES} of each")
        protos = np.asarray(load_checkpoint(os.path.join(
            tmp, "prototypes", f"prototypes_on_freiburg_ir_from_{model}")
        )["objective_vectors"])
        if (protos.shape != (NUM_CLASSES, RECIPE_FEATURE_WIDTH)
                or not np.isfinite(protos).all()):
            failures.append(f"{model}: prototypes of shape {protos.shape}, "
                            f"finite {bool(np.isfinite(protos).all())}")
        return pseudo, protos.shape

    tmp = f"{work}/gate_smoke"
    n_trans = count(tmp, "datasets", "freiburg", "translation", "seq_00_day",
                    "00", "fl_rgb", "*.png")
    n_source = count(tmp, "datasets", "freiburg", "train", "seq_00_day", "00",
                     "fl_rgb", "*.png")
    if n_source != RECIPE_FRAMES or n_trans != n_source:
        failures.append(f"{n_trans} translations of {n_source} source frames")
    pseudo, protos = labels_and_prototypes(tmp, "pipeline_seg")
    st_pseudo, st_protos = labels_and_prototypes(f"{work}/selftrain_smoke",
                                                 "selftrain_source")
    for name in ("g_gate_base.pth", "g_gate.pth", "g_oneway.pth"):
        load_gan_checkpoint(os.path.join(tmp, "ckpt", name))
    for d, names in (("gate", ("sem_s.pth", "sem_t.pth", "pipeline_seg.pth",
                               "bestpipeline_st.pth",
                               "lastpipeline_st.pth")),
                     ("selftrain", ("selftrain_source.pth",
                                    "bestselftrain_adapted.pth",
                                    "lastselftrain_adapted.pth")),
                     ("convergence", ("convergence_gate.pth",))):
        for name in names:
            load_seg_checkpoint(os.path.join(work, f"{d}_smoke", "ckpt",
                                             name))
    measures = {"l1_baseline": gan["l1_baseline"],
                "l1_trained": gan["l1_trained"],
                "ssim_baseline": gan["ssim_baseline"],
                "ssim_trained": gan["ssim_trained"],
                "miou_seg": pipeline["miou_seg_on_translations"],
                "miou_final": pipeline["value"],
                "miou_source": selftrain["miou_source"],
                "miou_adapted": selftrain["miou_adapted"],
                "miou_convergence": convergence["value"]}
    for k, v in measures.items():
        lo = -1.0 if k.startswith("ssim") else 0.0
        if not (math.isfinite(v) and lo <= v <= 1.0):
            failures.append(f"{k} {v} outside [{lo}, 1]")
    if not all(0.0 <= v <= 1.0 for v in gan["per_class_l1"]):
        failures.append(f"per-class L1 {gan['per_class_l1']}")

    # each chain's final checkpoint through the eval CLI's main at the
    # batch its chain used, and in memory on the same decoded arrays
    finals = {}
    for chain, d, name, batch, got in (
            ("pipeline", "gate", "bestpipeline_st.pth", EVAL_BATCH,
             pipeline["value"]),
            ("selftrain", "selftrain", "bestselftrain_adapted.pth",
             EVAL_BATCH, selftrain["miou_adapted"]),
            # the convergence gate's eval runs at the CLI's default batch
            ("convergence", "convergence", "convergence_gate.pth", 1,
             convergence["value"])):
        tmp = os.path.join(work, f"{d}_smoke")
        cli_iu, memory_iu, layers = recipe_cli_vs_memory(
            os.path.join(tmp, "datasets", "freiburg"),
            os.path.join(tmp, "ckpt"), name, batch)
        finals[chain] = {"cli": float(cli_iu), "memory": float(memory_iu),
                         "layers": ",".join(map(str, layers))}
        if cli_iu != memory_iu:
            failures.append(f"{chain}: the final eval CLI's mIoU {cli_iu} "
                            f"differs from the in-memory eval's {memory_iu}")
        if round(float(cli_iu), 4) != got:
            failures.append(f"{chain}: the chain's final mIoU {got} is not "
                            f"the eval CLI's {cli_iu}")
    if finals["convergence"]["layers"] != RECIPE_FULL_WIDTH:
        failures.append(f"the convergence chain trained layers "
                        f"{finals['convergence']['layers']}, not "
                        f"{RECIPE_FULL_WIDTH}")
    seconds = {g: st.seconds for g, st in stages.items()}
    print(f"recipe: the gates' smoke chains on {RECIPE_FRAMES}-frame "
          f"{HOST_IO_HW} trees, full-width GAN and convergence (layers "
          f"{RECIPE_FULL_WIDTH}, bf16): stage seconds "
          f"{json.dumps(seconds)}; {n_trans} translations, pseudo-label "
          f"files {pseudo} / {st_pseudo}, prototypes {protos} / {st_protos}"
          f"; {json.dumps(measures)}, slot map {gan['slot_map']}; final "
          f"mIoU CLI and in memory {json.dumps(finals)}; launches "
          f"{launches} on {card}", flush=True)
    note("recipe", **{f"{g}_{k}_s": float(v) for g, secs in seconds.items()
                      for k, v in secs.items()})
    if failures:
        fail("recipe: " + "; ".join(failures))
    return launches


def phase_doctor(card: str) -> None:
    """The port's doctor with ``--check_backend true`` in a process of its
    own: PASS with the card's name and the kernels built and loaded."""
    import os

    proc = subprocess.run(
        [sys.executable, "-m", "thermal_semantic_segmentation_torch.cli.doctor",
         "--check_backend", "true", "--freiburg_root",
         os.path.join("nonexistent", "freiburg")],
        capture_output=True, text=True, timeout=600)
    print(f"doctor (exit {proc.returncode}):\n{proc.stdout.strip()}",
          flush=True)
    backend = [line for line in proc.stdout.splitlines()
               if "backend" in line]
    name = card.split(",")[0].strip()
    if proc.returncode != 0 or not backend or "PASS" not in backend[0] or \
            name not in backend[0] or "built and loaded" not in backend[0]:
        fail(f"doctor: exit {proc.returncode}, backend line {backend}, "
             f"stderr {proc.stderr.strip()[-2000:]}")
    note("doctor", backend="PASS")


def spatial_step(mesh, image, label, steps: int, dtype=None):
    """The full-width model (seed 0, dropout off; in ``dtype``, default
    float32, as is ``image``) and the seg step on ``mesh`` (None: the
    plain step): (first loss, first gradients and state, ms a step over
    ``steps`` more after the first, the first step's peak GiB above what
    was allocated before, the calls and bytes of ``parallel/spatial``'s
    collectives in the first step, counted by wrapping its
    ``all_reduce_``)."""
    import collections

    import torch

    dtype = dtype or torch.float32

    from thermal_semantic_segmentation_torch.models.deeplab import (
        create_deeplab)
    from thermal_semantic_segmentation_torch.parallel import spatial
    from thermal_semantic_segmentation_torch.train.seg import (
        create_seg_state, make_seg_train_step)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    model = create_deeplab(0).to(dtype)
    model.layer5.head[0].p = 0.0
    image = image.to(dtype)
    state = create_seg_state(model, learning_rate=TRAIN_LR)
    step = make_seg_train_step(ignore_index=IGNORE, label_hw=SERVE_OUT,
                               base_lr=TRAIN_LR, mesh=mesh)
    traffic = collections.Counter()
    real = spatial.all_reduce_

    def counted(buf, group):
        # an exchange's buffer is 4-D, a sum's has fewer dimensions
        kind = "exchange" if buf.dim() == 4 else "sum"
        traffic[f"{kind}_calls"] += 1
        traffic[f"{kind}_bytes"] += buf.numel() * buf.element_size()
        real(buf, group)

    spatial.all_reduce_ = counted
    try:
        loss = float(step(state, image, label))
    finally:
        spatial.all_reduce_ = real
    peak = (torch.cuda.max_memory_allocated() - before) / 2**30
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
    sd = {k: v.detach().clone() for k, v in model.state_dict().items()}
    ms = step_ms(lambda: step(state, image, label), steps) if steps else 0.0
    return loss, grads, sd, ms, peak, traffic


def spatial_eval(mesh, image, label) -> dict:
    """The seg eval step of the full-width model (seed 0) on ``mesh``
    (None: the plain step) on ``image`` and ``label``: its hist, loss and
    pred on the host, the kernel's launches in that call, and the ms of a
    step over ``SPATIAL_TIMED_STEPS`` more."""
    import torch

    from thermal_semantic_segmentation_torch.kernels.upsample_argmax import (
        upsample_argmax)
    from thermal_semantic_segmentation_torch.models.deeplab import (
        create_deeplab)
    from thermal_semantic_segmentation_torch.train.seg import (
        build_seg_eval_step)

    model = create_deeplab(0)
    step = build_seg_eval_step(num_classes=NUM_CLASSES, ignore_index=IGNORE,
                               mesh=mesh)
    upsample_argmax.launches = 0      # counts from the main path only
    hist, loss, pred = step(model, image, label)
    torch.cuda.synchronize()
    launches = upsample_argmax.launches
    ms = step_ms(lambda: step(model, image, label), SPATIAL_TIMED_STEPS)
    return {"hist": hist.cpu(), "loss": float(loss), "pred": pred.cpu(),
            "launches": launches, "ms": ms}


def spatial_worker(rank: int, port: int, root: str) -> int:
    """One of the spatial phase's two gloo ranks on ``cuda:0``: its step
    on its block of the joined batch in float32, then in float64, then
    the eval step on its block; the loss, times, peak, traffic and digests
    to ``<root>/spatial<rank>.pt``, rank 0's gradients of both steps too,
    and the eval step's results and launches."""
    import gc
    import hashlib

    import torch
    import torch.distributed as dist

    from thermal_semantic_segmentation_torch.parallel.mesh import (
        image_sharding, init_distributed, label_sharding, make_mesh_2d)

    init_distributed(f"localhost:{port}", SPATIAL_WORLD, rank,
                     backend="gloo", device="cuda:0")
    mesh = make_mesh_2d(spatial=SPATIAL_WORLD)
    data = SeededImages(TRAIN_BATCH, SERVE_OUT, seed=SPATIAL_SEED)
    image = image_sharding(mesh, torch.from_numpy(
        data.images)).contiguous().cuda()
    label = label_sharding(mesh, torch.from_numpy(
        data.labels)).contiguous().cuda()
    loss, grads, sd, ms, peak, traffic = spatial_step(
        mesh, image, label, SPATIAL_TIMED_STEPS)
    out = {"loss": loss, "ms": ms, "peak": peak, "traffic": traffic,
           "block": (tuple(image.shape), tuple(label.shape)), "digests": {}}
    for what, kind in ((grads, "grad"), (sd, "state")):
        out["digests"].update({f"{kind}/{k}": hashlib.sha256(
            v.cpu().numpy().tobytes()).hexdigest() for k, v in what.items()})
    if rank == 0:
        out["grads"] = {n: g.cpu() for n, g in grads.items()}
    del grads, sd
    gc.collect()
    torch.cuda.empty_cache()
    loss64, grads64, _, _, _, _ = spatial_step(mesh, image, label, 0,
                                               torch.float64)
    out["loss64"] = loss64
    out["digests"].update({f"grad64/{k}": hashlib.sha256(
        v.cpu().numpy().tobytes()).hexdigest() for k, v in grads64.items()})
    if rank == 0:
        out["grads64"] = {n: g.cpu() for n, g in grads64.items()}
    del grads64
    gc.collect()
    torch.cuda.empty_cache()
    out["eval"] = spatial_eval(mesh, image, label)
    torch.save(out, f"{root}/spatial{rank}.pt")
    dist.barrier()
    dist.destroy_process_group()
    return 0


def grad_errors(got: dict, want: dict) -> dict:
    """max|got - want| of each tensor, in units of the largest ``want``."""
    largest = max(float(g.abs().max()) for g in want.values())
    return {n: float((got[n].to(g.device, g.dtype) - g).abs().max())
            / largest for n, g in want.items()}


def own_errors(got: dict, want: dict) -> dict:
    """max|got - want| of each tensor, in units of its own largest
    ``want`` (of 1 where ``want`` is all 0)."""
    out = {}
    for n, g in want.items():
        scale = float(g.abs().max()) or 1.0
        out[n] = float((got[n].to(g.device, g.dtype) - g).abs().max()) / scale
    return out


def anchored(got: dict, plain: dict, f64: dict) -> tuple:
    """(largest error of ``got`` from ``f64``, the plain step's, the
    tensors where ``got`` is past twice the plain step's error plus
    ``SPATIAL_GRAD_ATOL``), in units of the largest float64 gradient."""
    errs, plain_errs = grad_errors(got, f64), grad_errors(plain, f64)
    worse = [n for n in f64
             if errs[n] > 2 * plain_errs[n] + SPATIAL_GRAD_ATOL]
    return max(errs.values()), max(plain_errs.values()), worse


def subtract_first(xf, mean, var, eps, weight, bias):
    """The synchronised BatchNorm's normalisation in the form the port
    used before ``nn/resnet._normalise``: ``(x - mean) * rsqrt(var + eps)
    * weight + bias`` in autograd ops, which keep two full-size tensors
    for the backward."""
    import torch
    shape = (1, -1, 1, 1)
    y = (xf - mean.view(shape)) * torch.rsqrt(var + eps).view(shape)
    return y * weight.view(shape) + bias.view(shape)


def sync_bn_normalise_cost(card: str) -> None:
    """What the synchronised BatchNorm's normalisation costs a multi-rank
    step: its forward and backward on the input of every BatchNorm of the
    full-width model at 4 rows of 256x512 (a rank's rows in a two-rank
    'sync' step of batch 8), timed by CUDA events, and the memory it
    keeps for the backward: the port's ``nn/resnet._normalise``, the
    subtract-first form before it, and that form under a checkpoint. The
    statistics and their all-reduce before it are the same in all three
    and left out; the mean and variance take gradients, as there."""
    import collections

    import torch
    from torch.utils.checkpoint import checkpoint

    from thermal_semantic_segmentation_torch.models.deeplab import (
        create_deeplab)
    from thermal_semantic_segmentation_torch.nn.resnet import (
        BN_EPS, BatchNorm2d, _normalise)

    model = create_deeplab(0)
    shapes = collections.Counter()
    hooks = [m.register_forward_pre_hook(
        lambda m, args: shapes.update([tuple(args[0].shape)]))
        for m in model.modules() if isinstance(m, BatchNorm2d)]
    with torch.no_grad():
        model.eval()(torch.rand(4, *SERVE_OUT, 1, device="cuda").permute(
            0, 3, 1, 2))
    for h in hooks:
        h.remove()
    del model
    forms = {"port": _normalise, "subtract_first": subtract_first,
             "subtract_first_checkpoint": lambda *a: checkpoint(
                 subtract_first, *a, use_reentrant=False,
                 preserve_rng_state=False)}
    totals = {name: [0.0, 0] for name in forms}
    for (n, c, h, w), count in shapes.items():
        x = torch.randn(n, h, w, c, device="cuda").permute(
            0, 3, 1, 2).requires_grad_()
        mean = torch.randn(c, device="cuda", requires_grad=True)
        var = torch.rand(c, device="cuda", requires_grad=True)
        weight = torch.rand(c, device="cuda", requires_grad=True)
        bias = torch.randn(c, device="cuda", requires_grad=True)
        grad = torch.randn_like(x)
        args = (x, mean, var, BN_EPS, weight, bias)
        for name, form in forms.items():
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated()
            y = form(*args)
            kept = torch.cuda.memory_allocated() - before - y.numel() * 4
            del y
            totals[name][0] += count * time_ms(
                lambda: form(*args).backward(grad), reps=10)
            totals[name][1] += count * kept
    layers = sum(shapes.values())
    print(f"sync BatchNorm normalisation, forward and backward of its "
          f"{layers} layers at 4 rows of 256x512 float32 (CUDA events), and "
          f"what it keeps for the backward (each layer alone): " + "; ".join(
              f"{name} {ms:.3f} ms, {kept / 2**30:.3f} GiB"
              for name, (ms, kept) in totals.items()) + f" on {card}",
          flush=True)
    note("spatial", **{f"sync_bn_{name}_ms": ms
                       for name, (ms, _) in totals.items()},
         **{f"sync_bn_{name}_kept_gib": kept / 2**30
            for name, (_, kept) in totals.items()})


def phase_spatial(card: str) -> None:
    """The seg train step on a (data, spatial) mesh: two gloo ranks on the
    one card (``python3 chip_smoke.py --spatial-worker <rank> <port>
    <dir>``) split the width of the full-width model's batch-8 step at
    data 1 x spatial 2, held to the plain step on the joined batch (loss,
    gradients, the two ranks' state bit-equal); each rank's peak memory
    and step time beside the plain step's; then the 2-D mesh at spatial 1
    on one NCCL rank against the plain step; the same two steps in
    float64, each gradient tensor held to the plain float64 step's; the
    cost of the synchronised BatchNorm's normalisation
    (``sync_bn_normalise_cost``). The ranks' eval step on the grid is
    held to the plain eval step (``spatial_eval_check``); returns the
    kernels' launch counts of the ranks' eval steps."""
    import gc
    import os

    import torch
    import torch.distributed as dist

    from thermal_semantic_segmentation_torch.parallel.mesh import (
        init_distributed, make_mesh_2d)

    with tempfile_dir() as root:
        port = free_port()
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--spatial-worker",
             str(r), str(port), root], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
            for r in range(SPATIAL_WORLD)]
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=SPATIAL_TIMEOUT)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for r, (p, log) in enumerate(zip(procs, logs)):
            if p.returncode != 0:
                fail(f"spatial rank {r} failed:\n{log[-4000:]}")
        ranks = [torch.load(f"{root}/spatial{r}.pt", weights_only=False)
                 for r in range(SPATIAL_WORLD)]

    data = SeededImages(TRAIN_BATCH, SERVE_OUT, seed=SPATIAL_SEED)
    image = torch.from_numpy(data.images).cuda()
    label = torch.from_numpy(data.labels).cuda()
    want, want_grads, _, plain_ms, plain_peak, _ = spatial_step(
        None, image, label, SPATIAL_TIMED_STEPS)
    want64, f64, _, _, _, _ = spatial_step(None, image, label, 0,
                                           torch.float64)
    gc.collect()
    torch.cuda.empty_cache()
    r0 = ranks[0]
    loss_err = abs(r0["loss"] - want) / abs(want)
    grad_err, plain_err, worse = anchored(r0["grads"], want_grads, f64)
    vs_plain = max(grad_errors(r0["grads"], want_grads).values())
    own = own_errors(r0["grads64"], f64)
    own_worst = max(own, key=own.get)
    past = [n for n, e in own.items() if e > SPATIAL_GRAD_ATOL]
    smallest = min(float(g.abs().max()) for g in f64.values()) / max(
        float(g.abs().max()) for g in f64.values())
    loss64_err = abs(r0["loss64"] - want64) / abs(want64)
    differ = [k for k in r0["digests"]
              if any(r["digests"][k] != r0["digests"][k] for r in ranks)]
    traffic = r0["traffic"]
    print(f"spatial: data 1 x spatial {SPATIAL_WORLD} over gloo on one card "
          f"(blocks {r0['block']}): float32 loss {r0['loss']} vs the plain "
          f"step's {want} (rel err {loss_err:.3g}); gradients' largest error "
          f"from float64 {grad_err:.3g} of the largest (the plain float32 "
          f"step's {plain_err:.3g}; {len(worse)} tensors past twice its "
          f"error plus {SPATIAL_GRAD_ATOL}: {worse[:4]}), from the plain "
          f"step {vs_plain:.3g}; {len(differ)} tensors differ between the "
          f"ranks", flush=True)
    print(f"spatial float64: loss {r0['loss64']} vs the plain step's "
          f"{want64} (rel err {loss64_err:.3g}); each gradient tensor against "
          f"the plain float64 step's in units of its own largest value: "
          f"worst {own[own_worst]:.3g} ({own_worst}), {len(past)} tensors "
          f"past {SPATIAL_GRAD_ATOL}: {past[:4]} (the smallest tensor's "
          f"largest value is {smallest:.3g} of the largest)", flush=True)
    for r, res in enumerate(ranks):
        print(f"spatial rank {r}: step {res['ms']:.2f} ms, peak device "
              f"memory {res['peak']:.3f} GiB (batch {TRAIN_BATCH} at "
              f"256x512, float32, its half of the width) on {card}",
              flush=True)
    print(f"spatial plain step: {plain_ms:.2f} ms, peak device memory "
          f"{plain_peak:.3f} GiB (batch {TRAIN_BATCH} at 256x512, float32, "
          f"one process) on {card}", flush=True)
    print(f"spatial traffic of one step on rank 0: "
          f"{traffic.get('exchange_calls', 0)} exchanges, "
          f"{traffic.get('exchange_bytes', 0) / 2**20:.1f} MiB; "
          f"{traffic.get('sum_calls', 0)} sums, "
          f"{traffic.get('sum_bytes', 0) / 2**20:.3f} MiB (gloo stages "
          f"every buffer through the host)", flush=True)
    note("spatial", loss_rel_err=loss_err, grad_err_f64=grad_err,
         plain_grad_err_f64=plain_err, grad_err_vs_plain=vs_plain,
         f64_own_grad_err=own[own_worst], f64_loss_rel_err=loss64_err,
         plain_ms=plain_ms, plain_peak_gib=plain_peak,
         **{f"rank{r}_ms": res["ms"] for r, res in enumerate(ranks)},
         **{f"rank{r}_peak_gib": res["peak"] for r, res in enumerate(ranks)},
         exchange_calls=traffic.get("exchange_calls", 0),
         exchange_mib=traffic.get("exchange_bytes", 0) / 2**20)
    failures = []
    if not (loss_err <= LOSS_RTOL and not worse and not differ):
        failures.append("the spatial mesh's float32 step is not the plain "
                        "step on the joined batch")
    if past:
        failures.append("the spatial mesh's float64 gradients are not the "
                        "plain float64 step's")
    launches, problem = spatial_eval_check(card, [r["eval"] for r in ranks],
                                           image, label)
    if problem:
        failures.append(problem)
    del r0, ranks

    init_distributed(f"localhost:{free_port()}", 1, 0)
    if dist.get_backend() != "nccl":
        fail(f"the one-rank group is {dist.get_backend()}, not NCCL")
    mesh = make_mesh_2d(spatial=1)
    loss, grads, _, _, _, _ = spatial_step(mesh, image, label, 0)
    _, grads64, _, _, _, _ = spatial_step(mesh, image, label, 0,
                                          torch.float64)
    dist.destroy_process_group()
    loss_err1 = abs(loss - want) / abs(want)
    grad_err1, _, worse1 = anchored(grads, want_grads, f64)
    own1 = max(own_errors(grads64, f64).values())
    print(f"spatial 1 over one NCCL rank: float32 loss {loss} vs {want} (rel "
          f"err {loss_err1:.3g}), gradients' largest error from float64 "
          f"{grad_err1:.3g} of the largest ({len(worse1)} tensors past the "
          f"bound), from the plain step "
          f"{max(grad_errors(grads, want_grads).values()):.3g}; float64 "
          f"gradients' worst error {own1:.3g} of each tensor's largest",
          flush=True)
    note("spatial", nccl_spatial1_loss_rel_err=loss_err1,
         nccl_spatial1_grad_err_f64=grad_err1,
         nccl_spatial1_f64_own_grad_err=own1)
    if not (loss_err1 <= LOSS_RTOL and not worse1
            and own1 <= SPATIAL_GRAD_ATOL):
        failures.append("the 2-D mesh at spatial 1 is not the plain step")
    if failures:
        fail("; ".join(failures))
    del grads, grads64, want_grads, f64
    gc.collect()
    torch.cuda.empty_cache()
    sync_bn_normalise_cost(card)
    return launches


def spatial_eval_check(card: str, ranks: list, image, label) -> tuple:
    """The grid eval step's results (one dict a rank, from
    ``spatial_eval``) against the plain eval step on the joined batch:
    the ranks' hist and loss the same, the joined pred equal outside logit
    near-ties (top-2 gap ``TIE_GAP`` of the plain forward's upsampled
    logits), the hist equal at the decided pixels, the loss within
    ``LOSS_RTOL``. Returns ({kernel: launches of the ranks}, the failure
    or "")."""
    import torch

    from thermal_semantic_segmentation_torch.models.deeplab import (
        create_deeplab)
    from thermal_semantic_segmentation_torch.ops.confmat import (
        confusion_matrix)
    from thermal_semantic_segmentation_torch.ops.resize import (
        upsample_logits)
    from thermal_semantic_segmentation_torch.train.seg import (
        forward_nhwc, frozen_inference)

    plain = spatial_eval(None, image, label)
    model = create_deeplab(0)
    with frozen_inference(model):
        logits = forward_nhwc(model, image)["out"]
        top2 = upsample_logits(logits, *label.shape[1:]).topk(
            2, dim=-1).values
    decided = ((top2[..., 0] - top2[..., 1]) > TIE_GAP).cpu()
    del model, logits, top2
    pred = torch.cat([r["pred"] for r in ranks], dim=2)
    wrong = int(((pred != plain["pred"]) & decided).sum())
    # the hist of the decided pixels: minus that of the others
    others = label.cpu().masked_fill(decided, -1)
    hist_decided = [h - confusion_matrix(p, others, NUM_CLASSES) for h, p in
                    ((ranks[0]["hist"], pred),
                     (plain["hist"], plain["pred"]))]
    hist_equal = torch.equal(*hist_decided)
    ranks_agree = all(torch.equal(r["hist"], ranks[0]["hist"])
                      and r["loss"] == ranks[0]["loss"] for r in ranks)
    loss_err = abs(ranks[0]["loss"] - plain["loss"]) / abs(plain["loss"])
    launches = [r["launches"] for r in ranks]
    print(f"spatial eval: data 1 x spatial {len(ranks)} over gloo, batch "
          f"{image.shape[0]} at {tuple(label.shape[1:])}: pred vs the plain "
          f"eval step outside {int((~decided).sum())} near-ties: {wrong} "
          f"pixels; hist at the decided pixels "
          f"{'equal' if hist_equal else 'DIFFERS'}; loss {ranks[0]['loss']} "
          f"vs {plain['loss']} (rel err {loss_err:.3g}); ranks "
          f"{'agree' if ranks_agree else 'DISAGREE'}; launches {launches}; "
          f"{[round(r['ms'], 2) for r in ranks]} ms a step on the ranks, "
          f"the plain step {plain['ms']:.2f} ms, on {card}", flush=True)
    note("spatial", eval_loss_rel_err=loss_err, eval_wrong_pixels=wrong,
         eval_plain_ms=plain["ms"],
         **{f"eval_rank{r}_ms": x["ms"] for r, x in enumerate(ranks)})
    ok = (not wrong and hist_equal and ranks_agree and loss_err <= LOSS_RTOL
          and all(n >= 1 for n in launches))
    return ({"upsample_argmax": sum(launches)},
            "" if ok else "the spatial mesh's eval step is not the plain "
            "eval step on the joined batch")


def train_payload(state) -> dict:
    """The seg train state as a checkpoint payload: the step, every
    parameter and Adam's two moments and step count, by parameter name."""
    import torch
    names = {p: n for n, p in state.model.named_parameters()}
    payload = {"step": torch.tensor(state.step),
               "params": {n: p.detach() for n, p in
                          state.model.named_parameters()},
               "exp_avg": {}, "exp_avg_sq": {}, "adam_step": {}}
    for p, st in state.optimizer.state.items():
        for k, key in (("exp_avg", "exp_avg"), ("exp_avg_sq", "exp_avg_sq"),
                       ("adam_step", "step")):
            v = st[key]
            payload[k][names[p]] = v if isinstance(v, torch.Tensor) else \
                torch.tensor(v)
    return payload


def flat_leaves(tree, prefix=""):
    """{"group/name": leaf} of every leaf of a nested dict (a tensor, or
    an array as ``load_checkpoint`` gives it back)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat_leaves(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def sharded_state(flat: dict, mesh, world: int, rank: int) -> dict:
    """The train state ``flat`` ({path: tensor on the card}) as DTensors on
    ``mesh``: the parameters replicated, the Adam moments ``Shard(0)``
    (``torch.chunk``'s rows, uneven where the rows do not divide), the
    step counts plain tensors."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    tree = {}
    for path, t in flat.items():
        t = t.contiguous()
        group, name = (path.split("/", 1) if "/" in path else (path, None))
        if name is None:
            tree[group] = t
            continue
        if group in ("exp_avg", "exp_avg_sq"):
            local = t.chunk(world, 0)[rank].clone() if t.shape[0] >= world \
                else None
            leaf = DTensor.from_local(
                local, mesh, [Shard(0)], run_check=False, shape=t.shape,
                stride=t.stride()) if local is not None else \
                DTensor.from_local(t, mesh, [Replicate()], run_check=False)
        elif group == "params":
            leaf = DTensor.from_local(t, mesh, [Replicate()],
                                      run_check=False)
        else:
            leaf = t
        tree.setdefault(group, {})[name] = leaf
    return tree


def sharded_roundtrip(flat: dict, mesh, world: int, rank: int,
                      path: str) -> dict:
    """``save_sharded`` of ``flat`` as ``sharded_state`` lays it out on
    ``mesh``, then ``load_sharded`` into its own placements and into
    ``Replicate()``: the write and load seconds, this rank's file bytes,
    and whether every leaf came back bit-equal (its own shard; the whole
    tensor replicated)."""
    import os

    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Replicate

    from thermal_semantic_segmentation_torch.core.checkpoint import (
        abstract_like, load_sharded, save_sharded)

    tree = sharded_state(flat, mesh, world, rank)
    torch.cuda.synchronize()
    dist.barrier()
    t0 = time.perf_counter()
    save_sharded(path, tree)
    dist.barrier()
    write_s = time.perf_counter() - t0
    out = {"write_s": write_s, "bytes": os.path.getsize(
        os.path.join(path, f"__{rank}_0.distcp")),
        "files": sorted(os.listdir(path))}
    for name, target in (("own", abstract_like(tree)),
                         ("replicated", abstract_like(
                             tree, sharding=(mesh, [Replicate()])))):
        dist.barrier()
        t0 = time.perf_counter()
        got = load_sharded(path, target)
        torch.cuda.synchronize()
        dist.barrier()
        out[f"load_{name}_s"] = time.perf_counter() - t0
        differ = []
        mine = flat_leaves(tree)
        for p, t in flat_leaves(got).items():
            want = mine[p]
            if name == "replicated":
                ok = (t.placements == (Replicate(),) and torch.equal(
                    t.to_local().cpu(), flat[p].cpu()))
            elif isinstance(t, DTensor):
                ok = (t.placements == want.placements and torch.equal(
                    t.to_local(), want.to_local()))
            else:
                ok = torch.equal(t.cpu(), want.cpu())
            if not ok:
                differ.append(p)
        out[f"{name}_differ"] = differ
    return out


def checkpoint_worker(rank: int, port: int, root: str) -> int:
    """One of the checkpoint phase's two gloo ranks on ``cuda:0``: the train
    state from ``<root>/sync.ckpt`` through ``sharded_roundtrip`` over a
    ``DeviceMesh`` of both, its results to ``<root>/ckpt<rank>.json``."""
    import json

    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from thermal_semantic_segmentation_torch.core.checkpoint import (
        load_checkpoint)
    from thermal_semantic_segmentation_torch.parallel.mesh import (
        init_distributed)

    init_distributed(f"localhost:{port}", CKPT_WORLD, rank, backend="gloo",
                     device="cuda:0")
    mesh = DeviceMesh("cuda", list(range(CKPT_WORLD)))
    flat = {p: torch.as_tensor(v).cuda() for p, v in flat_leaves(
        load_checkpoint(f"{root}/sync.ckpt")).items()}
    out = sharded_roundtrip(flat, mesh, CKPT_WORLD, rank, f"{root}/gloo")
    with open(f"{root}/ckpt{rank}.json", "w") as f:
        json.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()
    return 0


def phase_checkpoint(card: str) -> None:
    """Checkpoints of the full-width model's train state (parameters and
    Adam's moments after one batch-8 step) on the card: the synchronous
    ``save_checkpoint``; two ``AsyncCheckpointer.save`` calls (the first
    allocates the page-locked buffers the second reuses; each one's
    return and background write), with train steps run while the second
    write is in flight against steps without one; the file read back
    bit-equal to the state at the second save. Then ``save_sharded`` and
    ``load_sharded`` of the same state, the moments ``Shard(0)``, on one
    NCCL rank and on two gloo ranks on the card (``python3 chip_smoke.py
    --checkpoint-worker <rank> <port> <dir>``): write and load seconds,
    each rank's bytes, every leaf back bit-equal in its own placements
    and resharded to ``Replicate()``. Launches no kernel."""
    import os

    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from thermal_semantic_segmentation_torch.core import checkpoint as ck
    from thermal_semantic_segmentation_torch.models.deeplab import (
        create_deeplab)
    from thermal_semantic_segmentation_torch.parallel.mesh import (
        init_distributed)
    from thermal_semantic_segmentation_torch.train.seg import (
        create_seg_state, make_seg_train_step)

    data = SeededImages(TRAIN_BATCH, SERVE_OUT, seed=CKPT_SEED)
    image = torch.from_numpy(data.images).cuda()
    label = torch.from_numpy(data.labels).cuda()
    state = create_seg_state(create_deeplab(0), learning_rate=TRAIN_LR)
    step = make_seg_train_step(ignore_index=IGNORE, label_hw=SERVE_OUT,
                               base_lr=TRAIN_LR)

    def train():
        step(state, image, label)

    train()
    torch.cuda.synchronize()
    failures = []
    with tempfile_dir() as root:
        payload = train_payload(state)
        nbytes = sum(t.numel() * t.element_size()
                     for t in flat_leaves(payload).values())
        t0 = time.perf_counter()
        ck.save_checkpoint(f"{root}/sync.ckpt", payload)
        sync_s = time.perf_counter() - t0
        file_bytes = os.path.getsize(f"{root}/sync.ckpt")
        plain_ms = step_ms(train, CKPT_STEPS)

        # the background write's start and end, by wrapping the function
        # its thread calls
        writes = []
        real = ck.save_checkpoint

        def timed(path, tree):
            start = time.perf_counter()
            real(path, tree)
            writes.append((start, time.perf_counter()))

        ck.save_checkpoint = timed
        try:
            # the first save allocates the page-locked buffers that the
            # second reuses; train steps run while the second writes
            saver = ck.AsyncCheckpointer()
            returned, in_flight = [], []
            for i in range(2):
                payload = train_payload(state)
                if i:
                    at_save = {p: t.cpu().numpy().copy()
                               for p, t in flat_leaves(payload).items()}
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                saver.save(f"{root}/async.ckpt", payload)
                returned.append(time.perf_counter() - t0)
                while i and len(writes) < 2 and \
                        len(in_flight) < CKPT_MAX_STEPS:
                    s0 = time.perf_counter()
                    train()
                    torch.cuda.synchronize()
                    in_flight.append((time.perf_counter() - s0) * 1e3)
                saver.wait()
        finally:
            ck.save_checkpoint = real
        snapshot_s = returned[1]
        write_s = writes[1][1] - writes[1][0]
        after_ms = step_ms(train, CKPT_STEPS)
        loaded = flat_leaves(ck.load_checkpoint(f"{root}/async.ckpt"))
        differ = [p for p, a in at_save.items()
                  if p not in loaded or not np.array_equal(loaded[p], a)]
        differ += sorted(set(loaded) - set(at_save))
        print(f"checkpoint: train state of {len(at_save)} tensors, "
              f"{nbytes / 2**20:.1f} MiB ({file_bytes / 2**20:.1f} MiB "
              f"file): save_checkpoint {sync_s:.3f} s; AsyncCheckpointer."
              f"save returned in {returned[0] * 1e3:.1f} ms the first time "
              f"(page-locked buffers allocated), its write "
              f"{writes[0][1] - writes[0][0]:.3f} s; the second time in "
              f"{snapshot_s * 1e3:.1f} ms (the snapshot's copies queued), "
              f"its background write took {write_s:.3f} s; a "
              f"train step {plain_ms:.2f} ms without a write ({after_ms:.2f} "
              f"after), with the write in flight "
              f"{[round(x, 2) for x in in_flight]} ms; read back: "
              f"{len(differ)} tensors differ from the state at the save "
              f"(bit for bit), on {card}", flush=True)
        in_flight_ms = statistics.median(in_flight) if in_flight else 0.0
        note("checkpoint", state_mib=nbytes / 2**20, sync_save_s=sync_s,
             async_first_return_ms=returned[0] * 1e3,
             async_first_write_s=writes[0][1] - writes[0][0],
             async_snapshot_ms=snapshot_s * 1e3, async_write_s=write_s,
             step_ms=plain_ms, step_in_flight_ms=in_flight_ms,
             steps_in_flight=len(in_flight))
        if differ or len(writes) != 2 or not in_flight:
            failures.append(f"the async checkpoint is not the state at the "
                            f"save: {differ[:4]}, {len(in_flight)} steps in "
                            f"flight")
        del loaded, at_save, payload

        flat = flat_leaves(train_payload(state))
        init_distributed(f"localhost:{free_port()}", 1, 0)
        if dist.get_backend() != "nccl":
            fail(f"the one-rank group is {dist.get_backend()}, not NCCL")
        nccl = sharded_roundtrip(flat, DeviceMesh("cuda", [0]), 1, 0,
                                 f"{root}/nccl")
        dist.destroy_process_group()
        del flat, state
        torch.cuda.empty_cache()

        port = free_port()
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__),
             "--checkpoint-worker", str(r), str(port), root],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(CKPT_WORLD)]
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=CKPT_TIMEOUT)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for r, (p, log) in enumerate(zip(procs, logs)):
            if p.returncode != 0:
                fail(f"checkpoint rank {r} failed:\n{log[-4000:]}")
        ranks = []
        for r in range(CKPT_WORLD):
            with open(f"{root}/ckpt{r}.json") as f:
                ranks.append(json.load(f))
    for name, res in (("nccl rank 0", nccl), *(
            (f"gloo rank {r}", res) for r, res in enumerate(ranks))):
        print(f"checkpoint sharded, {name}: save_sharded {res['write_s']:.3f}"
              f" s, its file {res['bytes'] / 2**20:.1f} MiB; load_sharded "
              f"{res['load_own_s']:.3f} s into its own placements, "
              f"{res['load_replicated_s']:.3f} s resharded to Replicate(); "
              f"{len(res['own_differ'])} and {len(res['replicated_differ'])} "
              f"tensors differ; files {res['files']} on {card}", flush=True)
        if res["own_differ"] or res["replicated_differ"]:
            failures.append(f"the sharded checkpoint on {name} came back "
                            f"different: {res['own_differ'][:3]} "
                            f"{res['replicated_differ'][:3]}")
    if ranks[0]["bytes"] + ranks[1]["bytes"] > 1.05 * nbytes or \
            max(r["bytes"] for r in ranks) > 0.8 * nbytes:
        failures.append(f"the gloo ranks' files {[r['bytes'] for r in ranks]}"
                        f" do not split a {nbytes}-byte state")
    note("checkpoint", nccl_write_s=nccl["write_s"],
         nccl_load_s=nccl["load_own_s"],
         **{f"gloo{r}_{k}": res[k] for r, res in enumerate(ranks)
            for k in ("write_s", "load_own_s", "load_replicated_s")},
         **{f"gloo{r}_mib": res["bytes"] / 2**20
            for r, res in enumerate(ranks)})
    if failures:
        fail("; ".join(failures))


# every phase in the order a full run takes them, and the phases each one
# needs to have run first (their files under the run's root); "gloo" is
# the two gloo ranks' run that the multi-process phases check
PHASES = ("serve", "eval", "train", "pseudo", "prototypes", "self_train",
          "self_train_dist", "gan", "gan_dist", "gan_legacy", "translate",
          "distance", "data_parallel", "dist", "spatial", "checkpoint",
          "export",
          "serve_translator",
          "serve_artifact", "profile", "device_aug", "host_data", "host_io",
          "doctor", "recipe")
NEEDS = {"gan_dist": ("gan",), "translate": ("gan",),
         "distance": ("translate",), "data_parallel": ("gan",),
         "serve_artifact": ("export",)}
NEEDS_GLOO = ("self_train_dist", "gan_dist", "dist")


def selected_phases(arg: str) -> list:
    """The phases ``--phases a,b,...`` asks for with the ones they need, in
    the full run's order; every phase without the argument."""
    if not arg:
        return list(PHASES)
    want = [p.strip() for p in arg.split(",") if p.strip()]
    unknown = sorted(set(want) - set(PHASES))
    if unknown:
        fail(f"unknown phases {unknown}; the phases: {', '.join(PHASES)}")
    todo = set()
    while want:
        phase = want.pop()
        if phase not in todo:
            todo.add(phase)
            want.extend(NEEDS.get(phase, ()))
    return [p for p in PHASES if p in todo]


def main(argv) -> int:
    import argparse

    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--phases", default="",
                        help="comma-separated phases to run (with the ones "
                             "they need); default: every phase")
    phases = selected_phases(parser.parse_args(argv).phases)
    t0 = time.perf_counter()
    card = phase_device()
    phase_build()
    seconds = {}

    def timed(name, fn, *a):
        start = time.perf_counter()
        out = fn(*a)
        seconds[name] = time.perf_counter() - start
        return out

    kernels = timed("kernels", phase_kernels)
    by_path, paths = {}, {}
    with tempfile_dir() as root:
        from thermal_semantic_segmentation_torch.models.deeplab import (
            create_deeplab)
        # ResNet-101, 1 channel, 13 classes, module2 head: random weights
        # from seed 0 in a reference .pth, for the phases that load it
        torch.save({"epoch": 0,
                    "sem_net_state_dict": create_deeplab(0).state_dict()},
                   f"{root}/smoke.pth")
        gloo = (timed("gloo", gloo_runs)
                if set(phases) & set(NEEDS_GLOO) else None)
        runs = {
            "serve": lambda: phase_slice(card),
            "eval": lambda: phase_eval(card),
            "train": lambda: phase_train(card),
            "pseudo": lambda: phase_pseudo(card, root),
            "prototypes": lambda: phase_prototypes(card, root),
            "self_train": lambda: phase_self_train(card, root),
            "self_train_dist": lambda: phase_self_train_dist(card, root,
                                                             gloo),
            "gan": lambda: phase_gan(card, root),
            "gan_dist": lambda: phase_gan_dist(card, root, gloo),
            "gan_legacy": lambda: phase_gan(card, root, "legacy"),
            "translate": lambda: phase_translate(card, root),
            "distance": lambda: phase_distance(card, root),
            "data_parallel": lambda: phase_data_parallel(card, root),
            "dist": lambda: phase_dist(card, gloo),
            "spatial": lambda: phase_spatial(card),
            "checkpoint": lambda: phase_checkpoint(card),
            "export": lambda: phase_export(card, root),
            "serve_translator": lambda: phase_serve_translator(card, root),
            "serve_artifact": lambda: phase_serve_artifact(card, root),
            "profile": lambda: phase_profile(card, root, kernels),
            "device_aug": lambda: phase_device_aug(card, root),
            "host_data": lambda: phase_host_data(card, root),
            "host_io": lambda: phase_host_io(card, root),
            "doctor": lambda: phase_doctor(card),
            "recipe": lambda: phase_recipe(card, root),
        }
        for name in phases:
            launches = timed(name, runs[name])
            if launches is None:        # a phase that runs no kernel
                continue
            # {kernel: launches}, or {path: {kernel: launches}} from a phase
            # that drives more than one path
            if all(isinstance(v, dict) for v in launches.values()):
                paths[name] = list(launches)
                by_path.update(launches)
            else:
                paths[name] = [name]
                by_path[name] = launches
    for k in kernels:
        k["launches_by_path"] = {path: launches[k["name"]]
                                 for path, launches in by_path.items()}
        k["launches"] = sum(k["launches_by_path"].values())
        for path, n in k["launches_by_path"].items():
            if not n:
                fail(f"kernel {k['name']} was not launched on the {path} "
                     f"path")
    for name, secs in seconds.items():
        launched = {(k["name"] if path == name else f"{path}:{k['name']}"):
                    k["launches_by_path"][path]
                    for path in paths.get(name, ()) for k in kernels}
        print(f"summary {name}: {secs:.1f} s "
              f"{json.dumps({**NOTES.get(name, {}), **launched})}",
              flush=True)
    print(f"smoke: every phase passed ({', '.join(phases)}) in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)     # nvidia-smi's name, power.limit
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dist-worker"]:
        sys.exit(dist_worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]))
    if sys.argv[1:2] == ["--spatial-worker"]:
        sys.exit(spatial_worker(int(sys.argv[2]), int(sys.argv[3]),
                                sys.argv[4]))
    if sys.argv[1:2] == ["--http-load"]:
        sys.exit(http_load(sys.argv[2], sys.argv[3], int(sys.argv[4]),
                           int(sys.argv[5]), sys.argv[6]))
    if sys.argv[1:2] == ["--pillow-oracle"]:
        sys.exit(pillow_oracle(sys.argv[2]))
    if sys.argv[1:2] == ["--host-io-child"]:
        sys.exit(host_io_child(*sys.argv[2:6], bool(int(sys.argv[6]))))
    if sys.argv[1:2] == ["--host-io-compare"]:
        sys.exit(host_io_compare(sys.argv[2]))
    if sys.argv[1:2] == ["--checkpoint-worker"]:
        sys.exit(checkpoint_worker(int(sys.argv[2]), int(sys.argv[3]),
                                   sys.argv[4]))
    sys.exit(main(sys.argv[1:]))
