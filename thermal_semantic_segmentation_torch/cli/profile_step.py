"""Profile a train or eval step and print where its device time goes
(counterpart of the JAX ``cli/profile_step.py``).

Runs ``--warmup`` steps of the chosen step, ``--steps`` more timed without
the profiler, then ``--steps`` more under ``torch.profiler`` (CPU and CUDA activities), writes the Chrome trace under
``--logdir`` and sums its device events by kernel and by category:
convolution, gemm, elementwise, reduction/norm, copy/memset, the port's own
kernels (``upsample_argmax``) and other. Those numbers say whether a step is
convolution-bound, copy-bound or waiting on the host.

    python -m thermal_semantic_segmentation_torch.cli.profile_step \\
        --step eval --bf16 false [--batch_size 8 --steps 20]

Prints the category table, the top ``--top`` kernels and ONE final JSON line
with the JAX CLI's keys: step, batch_size, wall_ms_per_step,
device_ms_per_step, categories_ms_per_step. On the CPU (``--device cpu``)
the trace has no device events: the CPU ops that enclose no other op are
summed instead, and a note says so.
"""

from __future__ import annotations

import glob
import json
import os
import tempfile
from collections import defaultdict

STEPS = ("seg", "eval", "gan", "self_train")
TRACE_NAME = "profile.pt.trace.json"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")

# kernel name -> category: the first category one of whose (lower-case)
# fragments the name holds
CATEGORIES = (
    ("port kernels", ("upsample_argmax",)),
    ("convolution", ("conv", "fprop", "dgrad", "wgrad", "implicit",
                     "winograd")),
    ("gemm", ("gemm", "cublas", "cutlass", "matmul", "addmm")),
    ("copy/memset", ("copy", "memcpy", "memset", "fill", "cat",
                     "nchwtonhwc", "nhwctonchw", "transpose")),
    ("reduction/norm", ("norm", "reduce", "softmax", "nll", "welford",
                        "batch_norm", "bn_", "max_pool", "argmax")),
    ("elementwise", ("elementwise", "pointwise", "foreach", "adam",
                     "multi_tensor")),
)


def categorize(name: str, cat: str = "kernel") -> str:
    """The category of one device event: copies and memsets by the
    trace's own category, kernels by their name."""
    if cat in ("gpu_memcpy", "gpu_memset"):
        return "copy/memset"
    low = name.lower()
    for category, fragments in CATEGORIES:
        if any(f in low for f in fragments):
            return category
    return "other"


def _top_level(events):
    """The events of ``events`` (complete events of one thread each) that
    no other of them encloses."""
    by_thread = defaultdict(list)
    for e in events:
        by_thread[(e.get("pid"), e.get("tid"))].append(e)
    kept = []
    for evs in by_thread.values():
        evs.sort(key=lambda e: (float(e["ts"]), -float(e.get("dur", 0.0))))
        end = float("-inf")
        for e in evs:
            ts = float(e["ts"])
            if ts >= end:
                kept.append(e)
                end = ts + float(e.get("dur", 0.0))
    return kept


def _aggregate_trace(logdir: str):
    """(per_op, per_cat): microseconds summed by event name and by
    category over the newest ``*.pt.trace.json`` under ``logdir``.

    On the card: the device events only (``kernel``, ``gpu_memcpy`` and
    ``gpu_memset``), never the CPU-side ranges, which nest and would count
    the same time twice. Without device events (a CPU run): the CPU ops
    that enclose no other op, with a note."""
    paths = sorted(glob.glob(os.path.join(logdir, "*.pt.trace.json")),
                   key=os.path.getmtime)
    if not paths:
        raise FileNotFoundError(f"no trace under {logdir}")
    with open(paths[-1]) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X"]
    device = [e for e in events if e.get("cat") in DEVICE_CATS]
    per_op, per_cat = defaultdict(float), defaultdict(float)
    if device:
        for e in device:
            dur = float(e.get("dur", 0.0))
            per_op[e.get("name", "?")] += dur
            per_cat[categorize(e.get("name", ""), e["cat"])] += dur
        return per_op, per_cat
    print("note: no device events in this trace (CPU run); aggregating "
          "the outermost CPU ops")
    for e in _top_level([e for e in events if e.get("cat") == "cpu_op"]):
        dur = float(e.get("dur", 0.0))
        per_op[e.get("name", "?")] += dur
        per_cat[categorize(e.get("name", ""), "cpu_op")] += dur
    return per_op, per_cat


def _build(step_kind: str, args):
    """(run_once, device) for the requested step at the requested shapes;
    ``run_once()`` queues one step and returns its loss (a device
    tensor)."""
    if step_kind not in STEPS:
        raise SystemExit(
            f"unknown --step {step_kind!r} (seg | eval | gan | self_train)")

    import numpy as np
    import torch

    from ..device import resolve_device
    from ..models.deeplab import create_deeplab

    device = resolve_device(args.device or None)
    rng = np.random.default_rng(0)
    hw = tuple(args.image_size)
    b, nc = args.batch_size, args.num_classes
    layers = tuple(args.layers)

    def put(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    def images(channels, lo=0.0, shape_hw=hw):
        return put(rng.uniform(lo, 1, (b, *shape_hw, channels))
                   .astype(np.float32))

    def labels():
        return put(rng.integers(0, nc, (b, *hw)))

    if step_kind in ("seg", "eval"):
        from ..train.seg import (build_seg_eval_step, create_seg_state,
                                 make_seg_train_step)
        model = create_deeplab(0, device=device, num_classes=nc,
                               num_channels=1, layers=layers)
        image, label = images(1), labels()
        if step_kind == "eval":
            eval_step = build_seg_eval_step(num_classes=nc, ignore_index=12,
                                            device=device, bf16=args.bf16)
            return (lambda: eval_step(model, image, label)[1]), device
        state = create_seg_state(model, learning_rate=1e-4, device=device)
        step = make_seg_train_step(ignore_index=12, label_hw=hw,
                                   base_lr=1e-4, bf16=args.bf16,
                                   device=device)
        return (lambda: step(state, image, label)), device
    if step_kind == "gan":
        from ..models.factory import init_gan_net, patchgan, unet_256
        from ..train.gan import create_gan_state, make_gan_step

        cycle = args.gan_cycle or args.sem_loss
        g = {"s2t": unet_256(ngf=args.ngf, input_nc=3, output_nc=1)}
        d = {"t": patchgan(ndf=args.ngf, input_nc=1)}
        if cycle:
            g["t2s"] = unet_256(ngf=args.ngf, input_nc=1, output_nc=3)
            d["s"] = patchgan(ndf=args.ngf, input_nc=3)
        for i, net in enumerate((*g.values(), *d.values())):
            init_gan_net(net, i, device=device)
        sem_nets = label_s = None
        if args.sem_loss:
            # frozen module2 sem nets, one a domain: the recipe's fidelity
            # configuration (cli/main.py -sem_mode module2)
            sem_nets = {name: create_deeplab(
                1, device=device, num_classes=nc, num_channels=c,
                layers=layers).eval().requires_grad_(False)
                for name, c in (("s", 3), ("t", 1))}
            label_s = labels()
        state = create_gan_state(g_nets=g, d_nets=d, learning_rate=2e-4,
                                 device=device)
        step, make_pools = make_gan_step(
            pool_size=50, cycle=cycle, with_contour=args.with_contour,
            sem_nets=sem_nets, sem_norm="module2", bf16=args.bf16)
        pools = make_pools({"t": (*hw, 1), **({"s": (*hw, 3)} if cycle
                                               else {})},
                           device=device, seed=0)
        real_s, real_t = images(3, -1.0), images(1, -1.0)

        def run():
            metrics, _ = step(state, pools, real_s, real_t, label_s,
                              with_sem=args.sem_loss)
            return metrics["g_s2t"]
        return run, device
    from ..train.self_train import (create_self_train_state,
                                    make_self_train_step)
    model = create_deeplab(0, device=device, num_classes=nc, num_channels=1,
                           layers=layers)
    state = create_self_train_state(
        model, prototypes=rng.standard_normal((nc, 256)) * 0.1,
        learning_rate=1e-5, num_classes=nc, device=device)
    step = make_self_train_step(num_classes=nc, ignore_index=12,
                                base_lr=1e-5, train_thred=0.3, label_hw=hw,
                                bf16=args.bf16, device=device)
    full_hw = (hw[0] + 8, hw[1] + 24)
    batch = (images(1), labels(), images(1), images(1, shape_hw=full_hw),
             put(rng.uniform(0, 1, (b, nc, *hw)).astype(np.float32)),
             labels(),
             {"resized_hw": put(np.array([[hw[0] + 4, hw[1] + 12]] * b)),
              "crop": put(np.array([[2, 2 + hw[0], 4, 4 + hw[1]]] * b)),
              "flip": put(np.array(([True, False] * b)[:b]))})

    def run():
        loss_pseudo, _ = step(state, *batch)
        return loss_pseudo
    return run, device


def profile_parse():
    import argparse

    from .options import str2bool

    p = argparse.ArgumentParser(description="profile a train or eval step")
    p.add_argument("--step", type=str, default="seg", choices=list(STEPS))
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--image_size", type=int, nargs=2, default=[256, 512])
    p.add_argument("--layers", type=lambda s: tuple(
        int(x) for x in s.split(",")), default=(3, 4, 23, 3))
    p.add_argument("--num_classes", type=int, default=13)
    p.add_argument("--ngf", type=int, default=64)
    p.add_argument("--gan_cycle", type=str2bool, default=False,
                   help="profile the full CycleGAN step (both generator "
                        "directions and both discriminators) instead of "
                        "the one-direction step")
    p.add_argument("--with_contour", type=str2bool, default=False,
                   help="add the differentiable-canny contour loss to the "
                        "profiled GAN step (the recipe's fidelity config)")
    p.add_argument("--sem_loss", type=str2bool, default=False,
                   help="add the semantic-consistency loss with frozen "
                        "module2 sem nets at --layers (implies "
                        "--gan_cycle); the recipe's fidelity config")
    p.add_argument("--bf16", type=str2bool, default=True,
                   help="bfloat16 autocast in the step")
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--warmup", type=int, default=3)
    p.add_argument("--top", type=int, default=15,
                   help="rows in the per-op table")
    p.add_argument("--logdir", type=str, default="",
                   help="keep the Chrome trace here (default: a temporary "
                        "directory); chrome://tracing or Perfetto opens it")
    p.add_argument("--device", type=str, default="",
                   help='torch device; empty = the CUDA device (fails '
                        'without one), "cpu" runs on the CPU')
    return p


def main(argv=None):
    import time

    import torch
    from torch.profiler import ProfilerActivity, profile

    args = profile_parse().parse_args(argv)
    run, device = _build(args.step, args)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    for _ in range(args.warmup):
        run()
    sync()
    # the same steps without the profiler: what it adds to the wall time
    t0 = time.perf_counter()
    for _ in range(args.steps):
        loss = run()
    float(loss)
    sync()
    bare = time.perf_counter() - t0

    logdir = args.logdir or tempfile.mkdtemp(prefix="tss_profile_")
    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            loss = run()
        final = float(loss)       # waits for the last step
        sync()
        wall = time.perf_counter() - t0
    prof.export_chrome_trace(os.path.join(logdir, TRACE_NAME))

    per_op, per_cat = _aggregate_trace(logdir)
    total_us = sum(per_cat.values())
    n = args.steps
    print(f"\n{args.step} step x{n} @ batch {args.batch_size} "
          f"{tuple(args.image_size)}: wall {wall * 1e3 / n:.2f} ms/step, "
          f"device {total_us / 1e3 / n:.2f} ms/step (loss={final:.4f}); "
          f"without the profiler wall {bare * 1e3 / n:.2f} ms/step (the "
          f"profiler adds {(wall - bare) / max(bare, 1e-9):+.1%})\n")
    print(f"{'category':<40} {'ms/step':>10} {'share':>7}")
    for cat, us in sorted(per_cat.items(), key=lambda kv: -kv[1]):
        print(f"{cat[:40]:<40} {us / 1e3 / n:>10.3f} "
              f"{us / max(total_us, 1e-9):>6.1%}")
    print(f"\ntop {args.top} ops:")
    for op, us in sorted(per_op.items(), key=lambda kv: -kv[1])[:args.top]:
        print(f"  {us / 1e3 / n:>8.3f} ms  {op[:100]}")
    if args.logdir:
        print(f"\nraw trace kept at {logdir}")
    print(json.dumps({
        "step": args.step, "batch_size": args.batch_size,
        "wall_ms_per_step": round(wall * 1e3 / n, 3),
        "device_ms_per_step": round(total_us / 1e3 / n, 3),
        "categories_ms_per_step": {
            k: round(v / 1e3 / n, 3)
            for k, v in sorted(per_cat.items(), key=lambda kv: -kv[1])},
    }), flush=True)


if __name__ == "__main__":
    main()
