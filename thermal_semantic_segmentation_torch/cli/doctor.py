"""Environment, dataset and checkpoint sanity checker (counterpart of the JAX
``cli/doctor.py``).

The common failures of a new setup are a mislaid dataset tree (the
reference's list-file grammar is strict: train/seq_*/NN/fl_ir_aligned,
fl_rgb and fl_rgb_labels siblings; test/day|night/ImagesIR with .npy
labels; reference utils/misc.py freiburg_txt:236, data/freiburg_dataset.py),
a checkpoint of the wrong schema, and a card or compiler the kernels cannot
use. ``doctor`` builds the real dataset classes and checkpoint loaders from
the flags, probes the card and the kernels, and reports PASS, WARN or FAIL
for each, so a fault shows here with a message instead of three stages into
a pipeline run:

    python -m thermal_semantic_segmentation_torch.cli.doctor \\
        --freiburg_root datasets/freiburg -checkpoint_name s.pth

Exit status: 0 when nothing FAILs (WARNs allowed), 1 otherwise. The JAX
doctor's compile-cache check has no counterpart: the port compiles nothing
but its kernels, whose build directory already persists across processes
(the backend line names it).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the checkout holding the package (the probe runs from a fresh interpreter)
_REPO_ROOT = os.path.dirname(PACKAGE_DIR)
RECIPE = os.path.join(PACKAGE_DIR, "recipes", "full_pipeline.sh")

# the backend probe: the card's count and name, then every kernel of csrc/
# built (nvcc, at first use) and loaded
_PROBE = """
import json, torch
from thermal_semantic_segmentation_torch.kernels import build
if not torch.cuda.is_available():
    raise SystemExit("torch.cuda.is_available() is false (no CUDA card "
                     "visible to torch " + torch.__version__ + ")")
build.build_all()
names = build.kernel_names()
for name in names:
    build.load(name)
print(json.dumps({"n": torch.cuda.device_count(),
                  "name": torch.cuda.get_device_name(0),
                  "kernels": names, "build_dir": str(build.BUILD_DIR)}))
"""


class _Report:
    def __init__(self):
        self.failed = False

    def ok(self, what, detail=""):
        print(f"  PASS  {what}" + (f" — {detail}" if detail else ""))

    def warn(self, what, detail=""):
        print(f"  WARN  {what}" + (f" — {detail}" if detail else ""))

    def fail(self, what, detail=""):
        self.failed = True
        print(f"  FAIL  {what}" + (f" — {detail}" if detail else ""))


def _check_backend(rep: _Report, timeout_s: int = 600):
    """Probe the card and build and load the kernels in a subprocess: a
    failed CUDA initialisation or a crashing kernel library cannot take
    the doctor down with it."""
    env = {**os.environ}
    env["PYTHONPATH"] = os.pathsep.join(
        [_REPO_ROOT] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    try:
        r = subprocess.run([sys.executable, "-c", _PROBE],
                           capture_output=True, timeout=timeout_s, text=True,
                           env=env)
    except subprocess.TimeoutExpired:
        rep.fail("backend", f"no answer in {timeout_s}s (CUDA init or nvcc "
                            "hung)")
        return
    if r.returncode == 0:
        info = json.loads(r.stdout.strip().splitlines()[-1])
        rep.ok("backend", f"{info['n']} x {info['name']}; kernels "
               f"{', '.join(info['kernels'])} built and loaded (build dir "
               f"{info['build_dir']}, kept across processes)")
    else:
        tail = (r.stderr or r.stdout or "").strip().splitlines()[-1:] or ["?"]
        rep.fail("backend", tail[0])


def _check_dataset(rep: _Report, name: str, build):
    try:
        ds = build()
        n = len(ds)
        if n == 0:
            rep.fail(name, "constructed but EMPTY (0 samples) — check the "
                           "tree layout against the reference's")
        else:
            # load one sample: catches unreadable or mislabelled files
            import numpy as np
            ds.get(0, np.random.default_rng(0))
            rep.ok(name, f"{n} samples, sample 0 loads")
    except FileNotFoundError as e:
        rep.fail(name, f"missing path: {e}")
    except Exception as e:
        rep.fail(name, f"{type(e).__name__}: {e}")


def _check_freiburg(rep: _Report, args):
    root = args.freiburg_root
    if not os.path.isdir(root):
        rep.warn("freiburg root", f"{root} does not exist — skipping "
                                  "dataset checks (pass --freiburg_root)")
        return
    from ..data import transforms as T
    from ..data.freiburg import Freiburg, FreiburgTest
    tf = T.Compose([T.Resize((128, 64)), T.ToArray()])
    _check_dataset(rep, "freiburg train IR", lambda: Freiburg(
        root, "train", "IR", transforms=tf, with_label=True))
    _check_dataset(rep, "freiburg train RGB", lambda: Freiburg(
        root, "train", "RGB", transforms=tf, with_label=True))
    _check_dataset(rep, "freiburg test IR", lambda: FreiburgTest(
        root, "test", "IR", transforms=tf, with_label=True))
    tname = getattr(args, "translation_name", "") or ""
    if tname:
        tdir = os.path.join(root, tname)
        if os.path.isdir(tdir):
            _check_dataset(rep, f"translated source ({tname})",
                           lambda: Freiburg(root, "train", "RGB",
                                            transforms=tf, with_label=True,
                                            segmentation_mode=True,
                                            translation_name=tname))
        else:
            rep.warn(f"translated source ({tname})",
                     f"{tdir} absent — run cli.translator first if the seg "
                     "recipe expects translated frames")


def _check_tree_grammar(rep: _Report, args):
    """Audit a Freiburg tree against the reference list-file grammar
    (utils/misc.py freiburg_txt:236-278, data/freiburg_dataset.py) file by
    file: the dataset checks above say 'loadable', this names the broken
    label siblings when it is not.

    Returns True when the tree can drive the full recipe (train IR and RGB
    with their label siblings and the day test split, all present). The
    pairs come from ``data/list_files.freiburg_pairs``, the code the
    datasets use, so the audit cannot drift from the grammar it audits."""
    from ..data.list_files import freiburg_pairs

    root = args.freiburg_root
    if not os.path.isdir(root):
        return False

    ready = True

    def audit(name, pairs):
        nonlocal ready
        if not pairs:
            rep.fail(f"grammar: {name}", "matched NOTHING — tree does "
                     "not follow the reference layout")
            ready = False
            return
        missing = [(f, d) for f, d in pairs if not os.path.exists(d)]
        if missing:
            ex = "; ".join(f"{os.path.relpath(f, root)} -> "
                           f"{os.path.relpath(d, root)}"
                           for f, d in missing[:3])
            rep.fail(f"grammar: {name}",
                     f"{len(missing)}/{len(pairs)} label siblings missing, "
                     f"e.g. {ex}")
            ready = False
        else:
            rep.ok(f"grammar: {name}", f"{len(pairs)} frames, all label "
                   f"siblings present")

    for time in ("day",):
        ir = freiburg_pairs(root, "train", "IR", time)
        audit(f"train IR ({time})", ir)
        rgb = freiburg_pairs(root, "train", "RGB", time)
        audit(f"train RGB ({time})", rgb)
        if ir and rgb and len(ir) != len(rgb):
            rep.warn(f"train pairing ({time})",
                     f"{len(ir)} IR vs {len(rgb)} RGB frames (the GAN "
                     "loaders zip lockstep; unequal counts just truncate)")
        audit(f"test IR ({time})", freiburg_pairs(root, "test", "IR", time))
    return ready


def _emit_recipe(args, ready: bool):
    """Print the full-recipe command for the tree (the north-star run, the
    reference's self_train_main.py:53 mIoU threshold 0.52 as its gate),
    with the package's own copy of recipes/full_pipeline.sh, which runs
    the port's CLIs."""
    root = os.path.abspath(args.freiburg_root)
    print()
    if not ready:
        print("recipe: tree NOT ready — fix the FAILs above, then re-run "
              "doctor to get the launch command.")
        return
    # the script runs from a working directory that CONTAINS
    # datasets/freiburg (the CLIs' default root)
    suffix = os.sep + os.path.join("datasets", "freiburg")
    if root.endswith(suffix):
        workdir = root[: -len(suffix)] or os.sep
        cd = (f"cd {workdir} && "
              if os.path.abspath(os.getcwd()) != workdir else "")
    else:
        print(f"recipe: the pipeline CLIs default to datasets/freiburg; "
              f"from your chosen working directory link the tree first:  "
              f"mkdir -p datasets && ln -s {root} datasets/freiburg")
        cd = ""
    print("recipe: tree is ready. Full adaptation pipeline with the "
          "reference's own save threshold as the gate:")
    print(f"  {cd}MIN_MIOU=0.52 {RECIPE}")
    print("  (add SEM_S=<rgb_seg.pth> SEM_T=<ir_seg.pth> for translation-"
          "fidelity losses once per-domain seg checkpoints exist; "
          "see the script's header)")


def _check_checkpoint(rep: _Report, args):
    name = getattr(args, "checkpoint_name", "") or ""
    if not name:
        return
    path = os.path.join(args.model_root_path, name)
    if not os.path.exists(path):
        rep.warn("seg checkpoint", f"{path} absent")
        return
    try:
        from ._common import load_seg_checkpoint
        state_dict, meta = load_seg_checkpoint(path)
        n_params = sum(v.numel() for k, v in state_dict.items()
                       if not k.endswith(("running_mean", "running_var",
                                          "num_batches_tracked")))
        rep.ok("seg checkpoint",
               f"{name}: {n_params / 1e6:.1f}M params, meta "
               f"{ {k: v for k, v in meta.items() if k != 'objective_vectors'} }")
    except Exception as e:
        rep.fail("seg checkpoint", f"{type(e).__name__}: {e}")


def _check_native(rep: _Report):
    from ..data import gxx, image, png
    from ..data import native_loader as nl
    try:
        png._unfilter_lib()
        image._resample_lib()
        rep.ok("PNG reader", f"PNG is read by the port's own reader (no "
               f"PIL): the row unfilter "
               f"{gxx.library_path(png.UNFILTER_SOURCE).name} and PIL's "
               f"resample {gxx.library_path(image.RESAMPLE_SOURCE).name} "
               f"built from csrc/ with g++ and loaded")
    except (RuntimeError, OSError) as e:
        rep.fail("PNG reader", f"csrc/png_unfilter.cpp or csrc/resample.cpp "
                 f"does not build or load with g++, so no image can be read "
                 f"or resized: {str(e).splitlines()[0]}")
    if nl.available():
        rep.ok("native C++ IO", f"{nl.library_path().name} built from "
               f"csrc/tss_io.cpp and loaded")
    else:
        rep.warn("native C++ IO", "unavailable (the build needs g++ with "
                 "the libpng and libjpeg headers): --native_decode and "
                 "--native_encode fall back to the port's own PNG reader "
                 "and writer. "
                 + nl.unavailable_reason().splitlines()[0])


def doctor_parse():
    from .options import HostConfigParser, _add_roots, str2bool
    p = HostConfigParser(description="environment/dataset sanity checks")
    p.add_argument("-checkpoint_name", type=str, default="")
    p.add_argument("-translation_name", type=str, default="")
    p.add_argument("--check_backend", type=str2bool, default=True,
                   help="probe the CUDA card and build and load the "
                        "kernels in a subprocess (off for host-only "
                        "checks)")
    _add_roots(p)
    return p


def main(argv=None):
    args = doctor_parse().parse_args(argv)
    rep = _Report()
    print("doctor:")
    if args.check_backend:
        _check_backend(rep)
    _check_freiburg(rep, args)
    ready = _check_tree_grammar(rep, args)
    _check_checkpoint(rep, args)
    _check_native(rep)
    print("doctor: FAIL" if rep.failed else "doctor: ok")
    if os.path.isdir(args.freiburg_root):
        _emit_recipe(args, ready and not rep.failed)
    return 1 if rep.failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
