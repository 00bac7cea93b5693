"""The port's accuracy gates: its CLIs, run end to end on a synthetic
Freiburg tree of real files, must reach the JAX gates' thresholds.

    python -m thermal_semantic_segmentation_torch.recipes.gates \\
        {gan,pipeline,selftrain,convergence} [--workdir=DIR] [--smoke] \\
        [--device cpu] [--epochs N --layers L --lr X  (convergence only)]

- ``gan``: the CycleGAN must learn the pixel-aligned colour-to-intensity
  map of ``make_gan_freiburg_tree`` (512 frames, seed 5). Frozen sem nets
  (``segmentation_train`` at layers 1,1,1,1: RGB on the gate tree, IR on
  an auxiliary tree) pin the translation; ``main`` trains a 1-step
  baseline, then resumes it for 20 epochs at batch 8, bf16, with the
  contour and module2 semantic losses; ``translator``,
  ``distance_evaluate`` and ``per_class_fidelity`` measure both. It
  passes when the trained L1 is at most half the baseline's and every
  class lands in its own intensity slot. Writes ``GAN_GATE_TORCH.json``.
- ``pipeline``: the whole recipe on the GAN gate's work (``--workdir`` of
  the GAN gate: the GAN and its translations are reused when trained and
  complete): ``segmentation_train`` on the translations (60 epochs),
  ``segmentation_evaluate``, ``generate_pseudo_label`` (soft and hard,
  flip), ``cal_prototype``, ``self_train_main`` and the final evaluation.
  It passes when the final mIoU is at least 0.75 and at least the seg
  model's less 0.05. Writes ``PIPELINE_GATE_TORCH.json``.
- ``selftrain``: self-training must close a constructed domain gap
  (``make_selftrain_freiburg_tree``, 256 frames, seed 3: clean source
  bands, the target's shifted 0.35 slots with 0.25-slot noise):
  ``segmentation_train`` on the source frames (100 epochs, layers
  1,1,1,1), ``segmentation_evaluate`` on the target test split,
  ``generate_pseudo_label`` (soft and hard, flip), ``cal_prototype``,
  ``self_train_main`` (4 epochs, lr 3e-4) and the adapted model's
  evaluation. It passes when the adapted mIoU gains at least 0.05 on the
  source model's. Writes ``SELFTRAIN_GATE_TORCH.json``.
- ``convergence``: ``segmentation_train`` must learn the intensity rule
  of ``make_learnable_freiburg_tree`` (256 frames, seed 3, 3 bands) under
  the crop transform, bf16, batch 8; ``segmentation_evaluate`` scores the
  held-out test split. It passes at mIoU >= 0.9. It alone takes
  ``--epochs``, ``--layers`` and ``--lr`` (default 100, 1,1,1,1, 0.003;
  full width is ``--layers 3,4,23,3 --lr 0.001``). Writes
  ``CONVERGENCE_TORCH.json``.

Every stage is the CLI's own ``main(argv)``, called in this process, on
the CUDA card (``--device cpu``: on the CPU; with no card and no
``--device cpu`` the runner stops before any stage). Each stage prints
one JSON line: its name, seconds, the images its loaders delivered (a
train stage's validation images included; a GAN step reads a source and
a target image) and their rate, its mIoU, L1 or SSIM, and on the card
its peak of allocated device memory (``peak_gib``). The settings are the
JAX gates' (``bench_all.py`` of the JAX repo), unchanged.

``--workdir``: the trees, checkpoints and ``.done`` markers persist there,
so a cut run resumes; a stage is skipped only after an earlier run
completed it (the self-training source model and the convergence training:
with the same arguments). ``--smoke``: the wiring run (in
``<workdir>_smoke``): a 16-frame tree, 1-2 epochs a stage (``--layers``
still applies), ``-max_steps 2`` (a one-direction ``main_gan`` stage too);
the GAN at ngf 8 on the CPU. It checks no threshold and writes no gate
JSON.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import glob
import hashlib
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import zipfile

import numpy as np

from . import synthetic_trees
from .assert_miou import parse_miou
from .synthetic_trees import (make_gan_freiburg_tree,
                              make_learnable_freiburg_tree,
                              make_selftrain_freiburg_tree)

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
GATE_JSON = {"gan": "GAN_GATE_TORCH.json",
             "pipeline": "PIPELINE_GATE_TORCH.json",
             "selftrain": "SELFTRAIN_GATE_TORCH.json",
             "convergence": "CONVERGENCE_TORCH.json"}
# the convergence gate's options and their defaults (bench_all.py's)
CONVERGENCE_DEFAULTS = {"epochs": "100", "layers": "1,1,1,1", "lr": "0.003"}
SMOKE_STEPS = ["-max_steps", "2"]
# the pipeline reuses a GAN checkpoint with at least this many epochs
TRAINED_EPOCH, SMOKE_TRAINED_EPOCH = 5, 1


def evaluate_miou(eval_args) -> float:
    """Run ``segmentation_evaluate`` and parse its 'mean iou score' line."""
    from ..cli import segmentation_evaluate

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        segmentation_evaluate.main(list(eval_args))
    return parse_miou(out.getvalue())


def gan_checkpoint_trained(path, min_epoch: int = 5) -> bool:
    """True only if a GAN checkpoint (the port's ``.pth`` or a msgpack
    one) exists and its ``epoch`` (the last 0-based epoch trained) is at
    least ``min_epoch``: a crashed workdir can hold a 1-step baseline
    under the same name. An unreadable file is not trained."""
    if not os.path.exists(path):
        return False
    try:
        if zipfile.is_zipfile(path):
            import torch

            ckpt = torch.load(path, map_location="cpu", weights_only=True)
        else:
            from ..core.checkpoint import load_checkpoint

            ckpt = load_checkpoint(path)
        return int(ckpt["epoch"]) >= min_epoch
    except Exception:
        return False


def run_stage_once(marker_path, fn, key: str = "done"):
    """Run ``fn()`` unless ``<marker_path>.done`` says an earlier run
    completed it with the same ``key`` (a stage's arguments, where they
    can change between runs of one workdir); the marker is written only
    after ``fn`` returns (a seg checkpoint exists after its first best
    epoch, so its file proves nothing). A marker of another key is stale:
    it and ``marker_path`` go before ``fn`` runs. Returns whether ``fn``
    ran."""
    marker = marker_path + ".done"
    if os.path.exists(marker):
        with open(marker) as f:
            if f.read() == key + "\n":
                return False
        os.remove(marker)
        if os.path.exists(marker_path):
            os.remove(marker_path)
    fn()
    with open(marker, "w") as f:
        f.write(key + "\n")
    return True


def tree_fingerprint(maker, kwargs) -> str:
    """The version of a synthetic tree: a hash of the tree module's source
    and the maker's name and arguments."""
    with open(synthetic_trees.__file__, "rb") as f:
        src = f.read()
    blob = repr((maker.__name__, sorted(kwargs.items()))).encode() + src
    return hashlib.sha256(blob).hexdigest()[:16]


def ensure_tree(root, maker, *, invalidate=(), **kwargs):
    """Make a synthetic tree, or remake it when its stamped fingerprint no
    longer matches the maker's source and arguments; then every path in
    ``invalidate`` (checkpoints, markers, baselines made from the old
    tree) is removed too."""
    manifest = os.path.join(root, "_tree_manifest.json")
    fp = tree_fingerprint(maker, kwargs)
    if os.path.isdir(root):
        old = None
        try:
            with open(manifest) as f:
                old = json.load(f).get("fingerprint")
        except OSError:
            pass
        if old == fp:
            return root
        print(f"[gate] synthetic tree at {root} is stale (generator or "
              f"args changed: {old} != {fp}): regenerating and "
              f"invalidating derived state", flush=True)
        shutil.rmtree(root)
        for p in invalidate:
            if os.path.isdir(p):
                shutil.rmtree(p, ignore_errors=True)
            elif os.path.exists(p):
                os.remove(p)
    maker(root, **kwargs)
    with open(manifest, "w") as f:
        json.dump({"fingerprint": fp, "maker": maker.__name__,
                   "kwargs": {k: repr(v) for k, v in kwargs.items()}}, f)
    return root


def per_class_fidelity(root, n_bands: int = 5, max_frames: int = 64):
    """(per_class_l1, slot_map) of the translations against the aligned
    real IR: per class k over its labelled pixels, the mean |translated -
    real| on the [0, 1] radiometric scale, and the slot floor(median * n)
    its median translated intensity lands in. A global L1 cannot see a
    narrow class translated into another's slot; a correct translation
    has slot_map == [0, ..., n_bands - 1]."""
    from ..data import image

    t_dir = os.path.join(root, "translation", "seq_00_day", "00", "fl_rgb")
    base = os.path.join(root, "train", "seq_00_day", "00")
    files = sorted(glob.glob(os.path.join(t_dir, "*.png")))[:max_frames]
    assert files, f"no translations under {t_dir}"
    abs_sum, cnt = np.zeros(n_bands), np.zeros(n_bands)
    medians = [[] for _ in range(n_bands)]
    for tp in files:
        name = os.path.basename(tp)
        trans = np.asarray(image.open_image(tp), np.float32) / 255.0
        ir = np.asarray(image.open_image(
            os.path.join(base, "fl_ir_aligned", name)), np.float32)
        ir = (np.clip(ir, 21800.0, 25000.0) - 21800.0) / 3200.0
        lab = np.asarray(image.open_image(
            os.path.join(base, "fl_rgb_labels", name)))
        # translations hold the crop-visible window (data/freiburg.py):
        # align the IR and the labels the same way
        h, w = lab.shape
        c0, c1 = round(w * 150 / 960), round(w * 850 / 960)
        ir, lab = ir[:, c0:c1], lab[:, c0:c1]
        if trans.shape != ir.shape:
            trans = np.asarray(image.resize(
                (trans * 255).astype(np.uint8), (ir.shape[1], ir.shape[0]),
                image.BILINEAR), np.float32) / 255.0
        d = np.abs(trans - ir)
        for k in range(n_bands):
            m = lab == k
            if m.any():
                abs_sum[k] += d[m].sum()
                cnt[k] += m.sum()
                medians[k].append(float(np.median(trans[m])))
    per_class_l1 = [round(v, 4)
                    for v in (abs_sum / np.maximum(cnt, 1)).tolist()]
    slot_map = [int(np.clip(np.floor(np.median(v) * n_bands), 0,
                            n_bands - 1)) if v else -1 for v in medians]
    return per_class_l1, slot_map


class Stages:
    """Runs the gate's stages: times each, counts the images its loaders
    deliver, prints its JSON line and keeps its seconds."""

    def __init__(self):
        self.seconds = {}

    def run(self, name, fn, measure=None):
        """``fn()``, then ``measure(result)``'s numbers (a dict) on the
        stage's line, and on the card the stage's peak of allocated
        device memory; returns ``fn``'s result."""
        import torch

        from ..data.loader import DataLoader

        images = [0]
        inner = DataLoader.__iter__

        def counted(loader):
            for batch in inner(loader):
                images[0] += len(batch["image"] if "image" in batch
                                 else next(iter(batch.values())))
                yield batch

        DataLoader.__iter__ = counted
        card = torch.cuda.is_available()
        if card:
            torch.cuda.reset_peak_memory_stats()
        start = time.perf_counter()
        try:
            out = fn()
        finally:
            DataLoader.__iter__ = inner
        seconds = time.perf_counter() - start
        self.seconds[name] = round(seconds, 2)
        line = {"stage": name, "seconds": round(seconds, 3)}
        if images[0]:       # a stage that reads through no loader has none
            line.update(images=images[0],
                        images_per_s=round(images[0] / seconds, 3))
        if card:
            line["peak_gib"] = round(torch.cuda.max_memory_allocated()
                                     / 2**30, 3)
        line.update(measure(out) if measure else {})
        print(json.dumps(line), flush=True)
        _release()
        return out

    def once(self, name, marker_path, fn, key: str = "done"):
        """``run`` under ``run_stage_once``; a stage an earlier run
        completed prints ``"reused": true``."""
        ran, before = [], self.seconds.get(name)
        self.run(name, lambda: ran.append(run_stage_once(marker_path, fn,
                                                         key)),
                 lambda _: {} if ran[0] else {"reused": True})
        if not ran[0]:      # keep an earlier run's seconds, if any
            self.seconds.pop(name)
            if before is not None:
                self.seconds[name] = before


def _release() -> None:
    """Give the card's cached blocks back between stages."""
    gc.collect()
    import torch

    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def pretrain_sem_nets(tmp, root, stages, *, smoke: bool = False,
                      device_flags=()):
    """The GAN's frozen sem nets, both through ``segmentation_train``:
    sem_s an RGB module2 net on the gate tree's source labels, sem_t an IR
    net on a different-seed auxiliary tree (the gate tree's target labels
    stay out of training). Returns (sem_s_path, sem_t_path)."""
    from ..cli import segmentation_train

    ckpt_dir = os.path.join(tmp, "ckpt")
    aux_root = os.path.join(tmp, "datasets", "freiburg_semaux")
    sem_s = os.path.join(ckpt_dir, "sem_s.pth")
    sem_t = os.path.join(ckpt_dir, "sem_t.pth")
    ensure_tree(aux_root, make_gan_freiburg_tree,
                n_train=16 if smoke else 256, n_test=8, seed=12,
                invalidate=[sem_t, sem_t + ".done"])
    epochs_s, epochs_t = ("1", "1") if smoke else ("15", "40")
    common = ["--model_root_path", ckpt_dir, "--layers", "1,1,1,1",
              "--decode_cache_mb", "2048", "-batch_size", "8",
              "-val_batch_size", "8", "-lr", "0.003", "--bf16", "true",
              *(SMOKE_STEPS if smoke else []), *device_flags]
    stages.once("sem_s_pretrain", sem_s, lambda: segmentation_train.main([
        "-dataset", "freiburg_rgb", "-net_mode", "three_channels",
        "-epochs", epochs_s, "-new_checkpoint_name", "sem_s.pth",
        "--freiburg_root", root, *common]))
    stages.once("sem_t_pretrain", sem_t, lambda: segmentation_train.main([
        "-dataset", "freiburg_ir", "-net_mode", "one_channel",
        "-epochs", epochs_t, "-new_checkpoint_name", "sem_t.pth",
        "--freiburg_root", aux_root, *common]))
    if not smoke:
        stages.run("sem_t_eval", lambda: evaluate_miou(
            ["-dataset", "freiburg_ir", "-val_batch_size", "8",
             "-checkpoint_name", "sem_t.pth", "-net_mode", "one_channel",
             "--freiburg_root", aux_root, "--model_root_path", ckpt_dir,
             "--layers", "1,1,1,1", "--decode_cache_mb", "2048",
             *device_flags]),
            lambda miou: {"miou": round(miou, 4)})
    return sem_s, sem_t


def _work_dir(workdir, smoke: bool):
    """The run's directory: ``workdir`` (``<workdir>_smoke`` for a smoke
    run, so a smoke's tiny tree and markers never meet a real run's), or
    a temporary one."""
    if workdir:
        workdir = workdir.rstrip("/") + ("_smoke" if smoke else "")
        os.makedirs(workdir, exist_ok=True)
        return contextlib.nullcontext(os.path.abspath(workdir))
    return tempfile.TemporaryDirectory()


def _gan_tree(tmp, smoke: bool) -> str:
    root = os.path.join(tmp, "datasets", "freiburg")
    return ensure_tree(root, make_gan_freiburg_tree,
                       n_train=16 if smoke else 512, n_test=8, seed=5,
                       invalidate=[os.path.join(tmp, "ckpt"),
                                   os.path.join(tmp, "baseline.json"),
                                   os.path.join(tmp, "pseudo_labels"),
                                   os.path.join(tmp, "prototypes")])


def _sem_flags(sem_s, sem_t) -> list:
    # the reference's translation-fidelity machinery: frozen per-domain
    # sem nets (semantic consistency) and the contour loss
    return ["-sem_loss", "true", "-sem_mode", "module2",
            "-sem_checkpoint_s", sem_s, "-sem_checkpoint_t", sem_t,
            "-with_contour", "true"]


def _narrow(smoke: bool, device_flags) -> list:
    # a 64-wide CycleGAN step takes minutes on the CPU: the CPU wiring
    # run trains ngf 8 (the translator reads the width off the checkpoint)
    return ["-ngf", "8"] if smoke and "cpu" in device_flags else []


def gan_gate(workdir=None, *, smoke: bool = False, device_flags=(),
             stages=None) -> dict:
    """The GAN translation-quality gate; returns its result."""
    from ..cli import distance_evaluate, main as gan_cli, main_gan, translator

    stages = stages or Stages()
    epochs = "2" if smoke else "20"
    steps = SMOKE_STEPS if smoke else []
    with _work_dir(workdir, smoke) as tmp, contextlib.chdir(tmp):
        root = _gan_tree(tmp, smoke)
        ckpt_dir = os.path.join(tmp, "ckpt")
        baseline_file = os.path.join(tmp, "baseline.json")
        common = ["--freiburg_root", root, "--gan_model_root_path", ckpt_dir,
                  "--bf16", "true", "--decode_cache_mb", "4096",
                  *device_flags]
        sem_s, sem_t = pretrain_sem_nets(tmp, root, stages, smoke=smoke,
                                         device_flags=device_flags)
        train_common = ["-source_dataset", "freiburg_rgb",
                        "-target_dataset", "freiburg_ir", "-batch_size", "8",
                        *_sem_flags(sem_s, sem_t), *_narrow(smoke,
                                                             device_flags),
                        *common]

        def translate_and_measure(tag, ckpt_name="g_gate.pth"):
            stages.run(f"translate_{tag}", lambda: translator.main([
                "-dataset", "freiburg_rgb", "-batch_size", "8",
                "-checkpoint_name", ckpt_name, "-input_nc", "3",
                "-output_nc", "1", "-save_image_size", "320", "700",
                "-translation_name_suffix", "", *common]))
            # the translations land under <root>/translation/...: the
            # distance CLI reads them through checkpoint_name translation.pth
            l1, ssim = stages.run(f"distance_{tag}", lambda: tuple(
                map(float, distance_evaluate.main(
                    ["-checkpoint_name", "translation.pth", "-batch_size",
                     "8", *common]))),
                lambda r: {"l1": round(r[0], 4), "ssim": round(r[1], 4)})
            return l1, ssim

        t0 = time.perf_counter()
        if os.path.exists(baseline_file):
            with open(baseline_file) as f:
                b = json.load(f)
            l1_0, ssim_0 = b["l1"], b["ssim"]
        else:
            # the untrained baseline under its own name: a workdir whose
            # g_gate.pth is trained keeps it
            stages.run("gan_baseline", lambda: gan_cli.main([
                "-num_epoch", "1", "-max_steps", "1",
                "-checkpoint_name", "g_gate_base.pth",
                "-new_checkpoint_name", "g_gate_base.pth", *train_common]))
            l1_0, ssim_0 = translate_and_measure("baseline",
                                                 "g_gate_base.pth")
            with open(baseline_file, "w") as f:
                json.dump({"l1": l1_0, "ssim": ssim_0}, f)
        print(json.dumps({"stage": "baseline", "l1": round(l1_0, 4),
                          "ssim": round(ssim_0, 4)}), flush=True)
        # ckpt["epoch"] is the last 0-based epoch: 19 after 20 epochs
        trained_ckpt = os.path.join(ckpt_dir, "g_gate.pth")
        if not gan_checkpoint_trained(trained_ckpt,
                                      min_epoch=int(epochs) - 1):
            start = ("g_gate.pth" if os.path.exists(trained_ckpt)
                     else "g_gate_base.pth")
            stages.run("gan_train", lambda: gan_cli.main([
                "-load_model", "true", "-num_epoch", epochs,
                "-save_interval", "1000", "-checkpoint_name", start,
                "-new_checkpoint_name", "g_gate.pth", *steps,
                *train_common]))
        if smoke:
            # the one-direction CLI, wiring only: its checkpoint is not
            # measured
            stages.run("gan_oneway", lambda: main_gan.main([
                "-num_epoch", "1", "-checkpoint_name", "g_oneway.pth",
                "-new_checkpoint_name", "g_oneway.pth", *steps,
                *train_common]))
        l1_1, ssim_1 = translate_and_measure("trained")
        per_class_l1, slot_map = stages.run(
            "fidelity", lambda: per_class_fidelity(root),
            lambda r: {"per_class_l1": r[0], "slot_map": r[1]})

    slots_ok = slot_map == list(range(len(slot_map)))
    return {"metric": "gan_gate_l1_ratio",
            "value": round(l1_1 / max(l1_0, 1e-9), 4), "unit": "ratio",
            "l1_baseline": round(l1_0, 4), "l1_trained": round(l1_1, 4),
            "ssim_baseline": round(ssim_0, 4),
            "ssim_trained": round(ssim_1, 4),
            "per_class_l1": per_class_l1, "slot_map": slot_map,
            "slots_identity": slots_ok, "threshold_ratio": 0.5,
            "passed": l1_1 <= 0.5 * l1_0 and slots_ok,
            "protocol": "distance_evaluate (L1+SSIM vs aligned real IR, "
                        "seed-42 20% val split) + per-class slot check",
            "sem_loss": True, "with_contour": True, "epochs": int(epochs),
            "total_sec": round(time.perf_counter() - t0, 1)}


def pipeline_gate(workdir=None, *, smoke: bool = False, device_flags=(),
                  stages=None) -> dict:
    """The full-recipe gate; returns its result. Raises at once when the
    translation's slot map is not the identity (not in a smoke run): a
    scrambled map spoils every later stage."""
    from ..cli import (cal_prototype, generate_pseudo_label, main as gan_cli,
                       segmentation_train, self_train_main, translator)

    stages = stages or Stages()
    gan_epochs, seg_epochs, st_epochs = (("1", "2", "1") if smoke
                                         else ("20", "60", "4"))
    steps = SMOKE_STEPS if smoke else []
    with _work_dir(workdir, smoke) as tmp, contextlib.chdir(tmp):
        root = _gan_tree(tmp, smoke)
        ckpt_dir = os.path.join(tmp, "ckpt")
        common = ["--freiburg_root", root, "--model_root_path", ckpt_dir,
                  "--layers", "1,1,1,1", "--decode_cache_mb", "2048",
                  *device_flags]
        net1 = ["-net_mode", "one_channel"]
        sem_s, sem_t = pretrain_sem_nets(tmp, root, stages, smoke=smoke,
                                         device_flags=device_flags)

        def evaluate(tag, ckpt_name):
            return stages.run(tag, lambda: evaluate_miou(
                ["-dataset", "freiburg_ir", "-val_batch_size", "8",
                 "-checkpoint_name", ckpt_name, *common, *net1]),
                lambda miou: {"miou": round(miou, 4)})

        t0 = time.perf_counter()
        g_path = os.path.join(ckpt_dir, "g_gate.pth")
        if not gan_checkpoint_trained(
                g_path, SMOKE_TRAINED_EPOCH if smoke else TRAINED_EPOCH):
            stages.run("gan_train", lambda: gan_cli.main([
                "-source_dataset", "freiburg_rgb",
                "-target_dataset", "freiburg_ir", "-batch_size", "8",
                "-num_epoch", gan_epochs, "-save_interval", "1000",
                "-checkpoint_name", "g_gate.pth",
                "-new_checkpoint_name", "g_gate.pth", "--bf16", "true",
                *steps, *_narrow(smoke, device_flags),
                *_sem_flags(sem_s, sem_t), "--freiburg_root", root,
                "--gan_model_root_path", ckpt_dir, "--decode_cache_mb",
                "4096", *device_flags]))
        # translations are reused only when complete (one per source
        # frame) and newer than the generator checkpoint
        src_pngs = glob.glob(os.path.join(
            root, "train", "seq_00_day", "00", "fl_rgb", "*.png"))
        trans_pngs = glob.glob(os.path.join(
            root, "translation", "seq_00_day", "00", "fl_rgb", "*.png"))
        if (not trans_pngs or len(trans_pngs) != len(src_pngs)
                or min(map(os.path.getmtime, trans_pngs))
                < os.path.getmtime(g_path)):
            stages.run("translate", lambda: translator.main([
                "-dataset", "freiburg_rgb", "-batch_size", "8",
                "-checkpoint_name", "g_gate.pth", "-input_nc", "3",
                "-output_nc", "1", "-save_image_size", "320", "700",
                "-translation_name_suffix", "", "--bf16", "true",
                "--freiburg_root", root, "--gan_model_root_path", ckpt_dir,
                "--decode_cache_mb", "4096", *device_flags]))
        per_class_l1, slot_map = stages.run(
            "translation_fidelity", lambda: per_class_fidelity(root),
            lambda r: {"per_class_l1": r[0], "slot_map": r[1]})
        if not smoke and slot_map != list(range(len(slot_map))):
            raise AssertionError(
                f"pipeline gate: translation slot_map {slot_map} is not the "
                f"identity: the GAN stage did not pin the class-to-intensity "
                f"map (per_class_l1={per_class_l1})")
        stages.once("seg_on_translations",
                    os.path.join(ckpt_dir, "pipeline_seg.pth"),
                    lambda: segmentation_train.main([
                        "-dataset", "freiburg_translation",
                        "-translation_name", "translation",
                        "-epochs", seg_epochs, "-batch_size", "8",
                        "-val_batch_size", "8", "-lr", "0.003",
                        "-new_checkpoint_name", "pipeline_seg.pth", *steps,
                        *common, *net1]))
        miou_seg = evaluate("seg_eval", "pipeline_seg.pth")
        for soft, ptype in (("True", "soft"), ("False", "hard")):
            stages.run(f"pseudo_{ptype}", lambda: generate_pseudo_label.main([
                "--root", tmp, "--soft", soft, "-pseudo_type", ptype,
                "--flip", "True", "-batch_size", "8",
                "-checkpoint_name", "pipeline_seg.pth", *common]))
        stages.run("prototypes", lambda: cal_prototype.main([
            "-root", tmp, "-dataset", "freiburg_ir", "-epochs", "1",
            "-batch_size", "8", "-max_steps", "2" if smoke else "32",
            "-checkpoint_name", "pipeline_seg.pth", *common, *net1]))
        stages.run("self_train", lambda: self_train_main.main([
            "--root", tmp, "-checkpoint_name", "pipeline_seg.pth",
            "-new_checkpoint_name", "pipeline_st.pth",
            "-translation_name", "translation",
            "--lr", "0.0003", "--epochs", st_epochs, "--val_interval", "32",
            # best-checkpoint keeps the peak; this stops the drift after it
            "--early_stop_patience", "6",
            "-batch_size", "4", *steps, *common]))
        miou_final = evaluate("final_eval", os.path.join(
            ckpt_dir, "bestpipeline_st.pth"))

    passed = miou_final >= 0.75 and miou_final >= miou_seg - 0.05
    return {"metric": "pipeline_gate_final_miou",
            "value": round(miou_final, 4), "unit": "mIoU",
            "miou_seg_on_translations": round(miou_seg, 4),
            "translation_per_class_l1": per_class_l1,
            "translation_slot_map": slot_map,
            "sem_loss": True, "with_contour": True,
            "threshold": 0.75, "passed": passed,
            "protocol": "256x512, nanmean(iu[:11]), real-IR test split",
            "stages": "gan->translate->seg->pseudo->proto->selftrain->eval",
            "total_sec": round(time.perf_counter() - t0, 1)}


def selftrain_gate(workdir=None, *, smoke: bool = False, device_flags=(),
                   stages=None) -> dict:
    """The self-training gate; returns its result."""
    from ..cli import (cal_prototype, generate_pseudo_label,
                       segmentation_train, self_train_main)

    stages = stages or Stages()
    source_epochs, st_epochs = ("2", "1") if smoke else ("100", "4")
    steps = SMOKE_STEPS if smoke else []
    with _work_dir(workdir, smoke) as tmp, contextlib.chdir(tmp):
        root = os.path.join(tmp, "datasets", "freiburg")
        ckpt_dir = os.path.join(tmp, "ckpt")
        ensure_tree(root, make_selftrain_freiburg_tree,
                    n_train=16 if smoke else 256, n_test=8, seed=3,
                    invalidate=[ckpt_dir, os.path.join(tmp, "pseudo_labels"),
                                os.path.join(tmp, "prototypes")])
        common = ["--freiburg_root", root, "--model_root_path", ckpt_dir,
                  "--layers", "1,1,1,1", "--decode_cache_mb", "2048",
                  *device_flags]
        # the pseudo-label and self-training parsers take no -net_mode
        net1 = ["-net_mode", "one_channel"]

        def evaluate(tag, ckpt_name):
            return stages.run(tag, lambda: evaluate_miou(
                ["-dataset", "freiburg_ir", "-val_batch_size", "8",
                 "-checkpoint_name", ckpt_name, *common, *net1]),
                lambda miou: {"miou": round(miou, 4)})

        t0 = time.perf_counter()
        source_argv = ["-dataset", "freiburg_translation",
                       "-translation_name", "synthetic_translation",
                       "-epochs", source_epochs, "-batch_size", "8",
                       "-val_batch_size", "8", "-lr", "0.003",
                       "-new_checkpoint_name", "selftrain_source.pth",
                       *steps, *common, *net1]
        stages.once("selftrain_source",
                    os.path.join(ckpt_dir, "selftrain_source.pth"),
                    lambda: segmentation_train.main(source_argv),
                    key=" ".join(source_argv))
        miou_source = evaluate("source_eval", "selftrain_source.pth")
        for soft, ptype in (("True", "soft"), ("False", "hard")):
            stages.run(f"pseudo_{ptype}", lambda: generate_pseudo_label.main([
                "--root", tmp, "--soft", soft, "-pseudo_type", ptype,
                "--flip", "True", "-batch_size", "8",
                "-checkpoint_name", "selftrain_source.pth", *common]))
        stages.run("prototypes", lambda: cal_prototype.main([
            "-root", tmp, "-dataset", "freiburg_ir", "-epochs", "1",
            "-batch_size", "8", "-max_steps", "2" if smoke else "32",
            "-checkpoint_name", "selftrain_source.pth", *common, *net1]))
        stages.run("self_train", lambda: self_train_main.main([
            "--root", tmp, "-checkpoint_name", "selftrain_source.pth",
            "-new_checkpoint_name", "selftrain_adapted.pth",
            "-translation_name", "synthetic_translation",
            "--lr", "0.0003", "--epochs", st_epochs, "--val_interval", "32",
            "-batch_size", "4", *steps, *common]))
        miou_adapted = evaluate("adapted_eval", os.path.join(
            ckpt_dir, "bestselftrain_adapted.pth"))

    gain = miou_adapted - miou_source
    return {"metric": "selftrain_gate_miou_gain", "value": round(gain, 4),
            "unit": "mIoU", "miou_source": round(miou_source, 4),
            "miou_adapted": round(miou_adapted, 4),
            "threshold_gain": 0.05, "passed": gain >= 0.05,
            "protocol": "256x512, nanmean(iu[:11])",
            "total_sec": round(time.perf_counter() - t0, 1)}


def convergence_gate(workdir=None, *, smoke: bool = False, device_flags=(),
                     stages=None,
                     epochs: str = CONVERGENCE_DEFAULTS["epochs"],
                     layers: str = CONVERGENCE_DEFAULTS["layers"],
                     lr: str = CONVERGENCE_DEFAULTS["lr"]) -> dict:
    """The convergence gate; returns its result. ``train_sec`` is null
    when an earlier run of ``workdir`` completed the training at the same
    options."""
    from ..cli import segmentation_train

    stages = stages or Stages()
    if smoke:
        epochs = "2"
    steps = SMOKE_STEPS if smoke else []
    with _work_dir(workdir, smoke) as tmp, contextlib.chdir(tmp):
        root = os.path.join(tmp, "datasets", "freiburg")
        ckpt_dir = os.path.join(tmp, "ckpt")
        ensure_tree(root, make_learnable_freiburg_tree,
                    n_train=16 if smoke else 256, n_test=8, seed=3,
                    n_bands=3, invalidate=[ckpt_dir])
        common = ["--freiburg_root", root, "--model_root_path", ckpt_dir,
                  "--layers", layers, "--decode_cache_mb", "1024",
                  "-net_mode", "one_channel", *device_flags]
        # a run at other options in the same workdir trains anew
        train_argv = ["-dataset", "freiburg_ir", "-epochs", epochs,
                      "-batch_size", "8", "-val_batch_size", "8",
                      "-lr", lr, "--bf16", "true",
                      "-new_checkpoint_name", "convergence_gate.pth",
                      *steps, *common]
        stages.once("convergence_train",
                    os.path.join(ckpt_dir, "convergence_gate.pth"),
                    lambda: segmentation_train.main(train_argv),
                    key=" ".join(train_argv))
        miou = stages.run("convergence_eval", lambda: evaluate_miou(
            ["-dataset", "freiburg_ir", "-checkpoint_name",
             "convergence_gate.pth", *common]),
            lambda m: {"miou": round(m, 4)})

    return {"metric": "synthetic_convergence_miou", "value": round(miou, 4),
            "unit": "mIoU", "threshold": 0.9, "passed": miou >= 0.9,
            "epochs": int(epochs), "layers": layers, "lr": float(lr),
            "bf16": True, "protocol": "256x512, nanmean(iu[:11])",
            "train_sec": stages.seconds.get("convergence_train")}


GATES = {"gan": gan_gate, "pipeline": pipeline_gate,
         "selftrain": selftrain_gate, "convergence": convergence_gate}


def card_name() -> str:
    """The card's name and power limit as ``nvidia-smi`` prints them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="Run one of the port's accuracy gates through its CLIs.")
    parser.add_argument("gate", choices=sorted(GATES))
    parser.add_argument("--workdir", default="",
                        help="keep the trees, checkpoints and stage markers "
                             "here (a cut run resumes); default: a "
                             "temporary directory")
    parser.add_argument("--smoke", action="store_true",
                        help="the wiring run: tiny tree, 1-2 epochs a "
                             "stage, no threshold, no gate JSON")
    parser.add_argument("--device", default="", choices=("", "cpu"),
                        help="cpu: run every stage on the CPU; default: "
                             "the CUDA card")
    for name, default in CONVERGENCE_DEFAULTS.items():
        parser.add_argument(f"--{name}", default=None,
                            help=f"convergence only (default {default})")
    args = parser.parse_args(argv)
    options = {k: getattr(args, k) for k in CONVERGENCE_DEFAULTS
               if getattr(args, k) is not None}
    if options and args.gate != "convergence":
        parser.error(f"--{', --'.join(options)}: the convergence gate's "
                     f"options, not the {args.gate} gate's")
    import torch

    if args.device != "cpu" and not torch.cuda.is_available():
        sys.exit("gates: no CUDA card is available; pass --device cpu to "
                 "run the stages on the CPU")
    device_flags = ["--device", "cpu"] if args.device == "cpu" else []
    stages = Stages()
    result = GATES[args.gate](args.workdir or None, smoke=args.smoke,
                              device_flags=device_flags, stages=stages,
                              **options)
    result["device"] = "cpu" if device_flags else card_name()
    result["stage_sec"] = stages.seconds
    if args.smoke:
        print(json.dumps({**result, "smoke": True}), flush=True)
        return 0
    with open(os.path.join(REPO, GATE_JSON[args.gate]), "w") as f:
        f.write(json.dumps(result) + "\n")
    print(json.dumps(result), flush=True)
    if not result["passed"]:
        print(f"{args.gate} gate FAILED", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
