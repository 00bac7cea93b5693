"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure ends the run with a non-zero exit and no result line):
  1. device: a CUDA card must be present; prints its name and power limit;
  2. build: compiles every kernel under csrc/ with nvcc (in parallel);
  3. kernels: each kernel against its plain PyTorch version on the card, at
     the serving shape and at a ragged shape, with its timings and bound;
  4. slice: the full-width DeepLabV2-ResNet101 seg server (random weights
     from a seed, loaded through the checkpoint path a user takes) answers
     requests from several threads, and the kernels' launch counts show the
     requests went through them.
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
RAGGED_SHAPE = (3, 9, 17, 13)
RAGGED_OUT = (61, 127)
TIE_GAP = 1e-5
CONF_RTOL, CONF_ATOL = 1e-4, 1e-5


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
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)
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
    the device work and not the host's launch overhead."""
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


def phase_kernels():
    import torch
    import torch.nn.functional as F

    from thermal_semantic_segmentation_torch.kernels.upsample_argmax import (
        upsample_argmax, upsample_argmax_reference)
    from thermal_semantic_segmentation_torch.ops.resize import upsample_logits

    gen = torch.Generator().manual_seed(0)
    max_err = 0.0
    for shape, (oh, ow) in ((SERVE_SHAPE, SERVE_OUT), (RAGGED_SHAPE, RAGGED_OUT)):
        x = torch.randn(shape, generator=gen).cuda()
        pred, conf = upsample_argmax(x, oh, ow)
        torch.cuda.synchronize()
        want_pred, want_conf = upsample_argmax_reference(x, oh, ow)
        top2 = upsample_logits(x, oh, ow).topk(2, dim=-1).values
        decided = (top2[..., 0] - top2[..., 1]) > TIE_GAP
        wrong = int(((pred != want_pred) & decided).sum())
        err = float((conf - want_conf).abs().max())
        print(f"upsample_argmax {shape}->{(oh, ow)}: pred mismatches outside "
              f"near-ties {wrong} (near-ties {int((~decided).sum())}), conf "
              f"max abs err {err:.3g}", flush=True)
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
    bound_ms, bound_by = upsample_argmax_bound(SERVE_SHAPE, SERVE_OUT)
    return [{
        "name": "upsample_argmax", "route": "cuda",
        "source": "thermal_semantic_segmentation_torch/csrc/upsample_argmax.cu",
        "replaces": "thermal_semantic_segmentation_tpu/ops/pallas_kernels.py:63",
        "shape": f"{SERVE_SHAPE}->{SERVE_OUT}", "launches": None,
        "max_abs_err": max_err, "ms": kernel_ms, "kernel_ms": kernel_ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": library_ms,
    }]


def phase_slice(card: str) -> dict:
    """Drive the seg server end to end at full width; returns the kernels'
    launch counts from this run."""
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    import torch

    from thermal_semantic_segmentation_torch.cli.serve import (
        build_seg_server, serve_parse)
    from thermal_semantic_segmentation_torch.kernels import build
    from thermal_semantic_segmentation_torch.kernels.upsample_argmax import (
        upsample_argmax, upsample_argmax_reference)
    from thermal_semantic_segmentation_torch.models.deeplab import (
        create_deeplab)
    from thermal_semantic_segmentation_torch.ops.resize import upsample_logits

    hw, n_requests, n_threads = SERVE_OUT, 24, 4
    # ResNet-101 layers=(3, 4, 23, 3), 1 channel, 13 classes, module2 head:
    # random weights from a seed, saved in the reference .pth schema and
    # loaded back through the CLI's checkpoint path
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build.BUILD_DIR) as root:
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


def main() -> int:
    import torch
    card = phase_device()
    phase_build()
    kernels = phase_kernels()
    launches = phase_slice(card)
    for k in kernels:
        k["launches"] = launches[k["name"]]
        if not k["launches"]:
            fail(f"kernel {k['name']} was not launched on the main path")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)     # nvidia-smi's name, power.limit
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
