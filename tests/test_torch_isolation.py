"""The PyTorch port stands alone: it imports neither JAX nor anything of the
JAX package (nor PIL when a module is imported: the card's machine has
none), its entry points refuse to fall back to the CPU quietly, and its CLIs
take the JAX package's host flags where the JAX CLIs take them."""

import ast
import pkgutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import thermal_semantic_segmentation_torch as port  # noqa: E402
from thermal_semantic_segmentation_torch.cli import (  # noqa: E402
    _common, cal_prototype, distance_evaluate, generate_pseudo_label, main,
    main_gan, segmentation_evaluate, segmentation_train, self_train_main,
    translator)
from thermal_semantic_segmentation_torch.data.device_pipeline import (  # noqa: E402,E501
    device_prefetch)
from thermal_semantic_segmentation_torch.eval.distance import (  # noqa: E402
    evaluate_distance)
from thermal_semantic_segmentation_torch.eval.validate import (  # noqa: E402
    seg_validate)
from thermal_semantic_segmentation_torch.models.deeplab import (  # noqa: E402
    create_deeplab)
from thermal_semantic_segmentation_torch.models.factory import (  # noqa: E402
    init_gan_net, patchgan)
from thermal_semantic_segmentation_torch.serving.batcher import (  # noqa: E402
    InferenceServer)
from thermal_semantic_segmentation_torch.train.prototypes import (  # noqa: E402,E501
    calc_prototypes)
from thermal_semantic_segmentation_torch.train.pseudo import (  # noqa: E402
    generate_pseudo_labels)
from thermal_semantic_segmentation_torch.train.seg import (  # noqa: E402
    build_seg_eval_step, create_seg_state, make_seg_train_step)
from thermal_semantic_segmentation_torch.train.self_train import (  # noqa: E402,E501
    create_self_train_state, make_self_train_step)
from thermal_semantic_segmentation_torch.train.gan import (  # noqa: E402
    create_gan_state)
from thermal_semantic_segmentation_torch.utils.observability import (  # noqa: E402,E501
    profiler_trace)

BANNED = ("jax", "jaxlib", "flax", "optax", "msgpack",
          "thermal_semantic_segmentation_tpu")
PORT_DIR = Path(port.__file__).parent
REPO = PORT_DIR.parent
SOURCES = sorted(PORT_DIR.rglob("*.py")) + [REPO / "chip_smoke.py"]


def _banned(name: str) -> bool:
    # nor the repo's tests (the JAX repo's tree makers live there)
    return name.split(".")[0] in BANNED + ("tests",)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_banned_import_in_source(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    found = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            found += [a.name for a in node.names if _banned(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if node.module and _banned(node.module):
                found.append(node.module)
    assert not found, f"{path} imports {found}"


def test_importing_every_module_loads_no_banned_package():
    modules = [m.name for m in pkgutil.walk_packages(
        [str(PORT_DIR)], prefix=f"{port.__name__}.")]
    assert len(modules) >= 30, modules
    for new in ("cli.segmentation_evaluate", "eval.validate", "train.seg",
                "data.loader", "data.device_pipeline", "ops.confmat",
                "cli.segmentation_train", "core.schedule", "data.cityscapes",
                "utils.meters", "utils.logging", "utils.observability",
                "core.checkpoint", "data.png", "data.simple",
                "ops.class_means", "train.pseudo", "train.prototypes",
                "cli.generate_pseudo_label", "cli.cal_prototype",
                "data.self_train_aug", "train.self_train",
                "cli.self_train_main", "nn.norms", "nn.generators",
                "nn.patchgan", "nn.canny", "ops.image_pool",
                "models.factory", "train.gan", "cli.main", "cli.main_gan",
                "cli.translator", "ops.ssim", "eval.distance",
                "cli.distance_evaluate", "parallel.mesh", "utils.preempt",
                "core.export", "cli.export_stablehlo", "cli.export_torch",
                "cli.serve", "serving.codec", "cli.profile_step",
                "cli.doctor", "ops.augment", "data.cache",
                "data.native_loader", "data.triple_transforms",
                "parallel.spatial", "nn.spatial", "data.image", "data.gxx",
                "recipes.gates", "recipes.synthetic_trees",
                "recipes.assert_miou"):
        assert f"{port.__name__}.{new}" in modules
    code = (
        "import importlib, sys\n"
        f"for m in {modules!r}: importlib.import_module(m)\n"
        f"bad = sorted(k for k in sys.modules if k.split('.')[0] in {BANNED!r})\n"
        "bad += ['PIL'] if 'PIL' in sys.modules else []\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


# the files of the port's last slices that are not Python modules, and the
# modules, which the import checks above cover too
LAST_SLICE_FILES = ["cli/profile_step.py", "cli/doctor.py", "ops/augment.py",
                    "data/cache.py", "data/native_loader.py",
                    "data/triple_transforms.py", "csrc/tss_io.cpp",
                    "recipes/full_pipeline.sh", "recipes/assert_miou.py",
                    "data/png.py", "data/image.py", "data/gxx.py",
                    "csrc/png_unfilter.cpp", "csrc/resample.cpp",
                    "recipes/gates.py", "recipes/synthetic_trees.py",
                    "recipes/convergence_gate.sh"]


@pytest.mark.parametrize("rel", LAST_SLICE_FILES)
def test_last_slice_files_name_nothing_of_the_jax_package(rel):
    """Neither the modules nor the recipe copy nor the C++ copy name the
    JAX package or its native library."""
    text = (PORT_DIR / rel).read_text()
    assert "thermal_semantic_segmentation_tpu" not in text
    assert "native/libtss_io" not in text


def test_native_io_and_doctor_load_nothing_of_the_jax_package(tmp_path):
    """The native library the port loads is its own build (no file of the
    JAX package, its ``native/libtss_io.so`` included, is mapped into the
    process), and the doctor's host checks import no banned module."""
    code = (
        "import sys\n"
        "from thermal_semantic_segmentation_torch.data import "
        "native_loader as nl\n"
        "from thermal_semantic_segmentation_torch.cli import doctor\n"
        "nl.available()\n"
        f"doctor.main(['--check_backend', 'false', '--freiburg_root', "
        f"{str(tmp_path / 'none')!r}])\n"
        "maps = open('/proc/self/maps').read()\n"
        f"bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        f"{BANNED!r})\n"
        "bad += ['maps'] if 'thermal_semantic_segmentation_tpu' in maps "
        "else []\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("entry", [
    "create_deeplab", "InferenceServer", "build_seg_eval_step",
    "seg_validate", "seg_evaluation", "make_seg_train_step",
    "create_seg_state", "segmentation_train", "generate_pseudo_labels",
    "calc_prototypes", "generate_pseudo_label", "cal_prototype",
    "make_self_train_step", "create_self_train_state", "self_train_main",
    "init_gan_net", "create_gan_state", "build_generator_from_gan_checkpoint",
    "main", "main_gan", "translator", "evaluate_distance",
    "distance_evaluate", "deeplabv2_resnet101", "init_distributed",
    "profiler_trace"])
def test_entry_points_raise_without_a_card(monkeypatch, entry):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        if entry == "create_deeplab":
            create_deeplab(0, layers=(1, 1, 1, 1))
        elif entry == "InferenceServer":
            InferenceServer(create_deeplab(0, device="cpu",
                                           layers=(1, 1, 1, 1)))
        elif entry == "build_seg_eval_step":
            build_seg_eval_step(num_classes=13, ignore_index=12)
        elif entry == "profiler_trace":
            with profiler_trace("unused"):
                pass
        elif entry == "seg_validate":
            seg_validate(create_deeplab(0, device="cpu", layers=(1, 1, 1, 1)),
                         [])
        elif entry == "make_seg_train_step":
            make_seg_train_step(ignore_index=12, base_lr=1e-4)
        elif entry == "create_seg_state":
            create_seg_state(create_deeplab(0, device="cpu",
                                            layers=(1, 1, 1, 1)),
                             learning_rate=1e-4)
        elif entry == "segmentation_train":
            segmentation_train.main(["-dataset", "freiburg_ir"])
        elif entry == "generate_pseudo_labels":
            generate_pseudo_labels(None, [], save_path="unused")
        elif entry == "calc_prototypes":
            calc_prototypes(None, [])
        elif entry == "generate_pseudo_label":
            generate_pseudo_label.main([])
        elif entry == "cal_prototype":
            cal_prototype.main([])
        elif entry == "make_self_train_step":
            make_self_train_step(num_classes=13, ignore_index=12,
                                 base_lr=1e-6)
        elif entry == "create_self_train_state":
            create_self_train_state(
                create_deeplab(0, device="cpu", layers=(1, 1, 1, 1)),
                prototypes=np.zeros((13, 256), np.float32),
                learning_rate=1e-6)
        elif entry == "self_train_main":
            self_train_main.main([])
        elif entry == "init_gan_net":
            init_gan_net(patchgan(ndf=8), 0)
        elif entry == "create_gan_state":
            create_gan_state(g_nets={}, d_nets={}, learning_rate=1e-4)
        elif entry == "build_generator_from_gan_checkpoint":
            _common.build_generator_from_gan_checkpoint(
                "unused.pth", "s2t", input_nc=3, output_nc=1)
        elif entry == "main":
            main.main([])
        elif entry == "main_gan":
            main_gan.main([])
        elif entry == "translator":
            translator.main([])
        elif entry == "evaluate_distance":
            evaluate_distance([])
        elif entry == "distance_evaluate":
            distance_evaluate.main([])
        elif entry == "deeplabv2_resnet101":
            from thermal_semantic_segmentation_torch.models.factory import (
                deeplabv2_resnet101)
            deeplabv2_resnet101()
        elif entry == "init_distributed":
            from thermal_semantic_segmentation_torch.parallel.mesh import (
                init_distributed)
            init_distributed("localhost:1", 1, 0)
        else:
            segmentation_evaluate.main(["-dataset", "freiburg_ir"])


DISTRIBUTED = ["--distributed", "true"]
DATA_PARALLEL = ["--data_parallel", "true"]
REMAT_FULL = ["--remat", "full"]


TRAIN_PORTED = [DISTRIBUTED, ["-bn_mode", "per_replica"], REMAT_FULL,
                ["--remat", "dots"]]
GAN_CLIS = [("main", main), ("main_gan", main_gan),
            ("translator", translator),
            ("distance_evaluate", distance_evaluate)]


@pytest.mark.parametrize("name,cli", [
    (name, cli) for name, cli in GAN_CLIS if name != "translator"],
    ids=["main", "main_gan", "distance_evaluate"])
def test_gan_clis_refuse_data_parallel(name, cli, capsys):
    """``--data_parallel`` stays refused where the JAX CLI reads it
    nowhere (main, main_gan, distance_evaluate), with that reason."""
    with pytest.raises(SystemExit) as exit_info:
        cli.main(DATA_PARALLEL + ["--device", "cpu"])
    assert exit_info.value.code != 0
    err = capsys.readouterr().err
    assert ("error: --data_parallel " in err
            and "is read nowhere by this entry point" in err)


# -- the JAX package's host flags, each landing where the JAX CLI puts it:
# the dataset's native_decode, the process's decode cache, the wire after
# resolve_wire, the writer's native_encode and the step's device_augment.
# A stub in place of each CLI's loop records what reached it; no loop runs.

class _Reached(Exception):
    """Raised by a stub in place of a CLI's loop."""


def _stop_at(monkeypatch, module, name) -> dict:
    """Replace ``module.name`` by a stub that records its arguments and
    raises ``_Reached``; returns the record."""
    seen = {}

    def stub(*args, **kwargs):
        seen.update(args=args, kwargs=kwargs)
        raise _Reached
    monkeypatch.setattr(module, name, stub)
    return seen


def _record(monkeypatch, module, name) -> dict:
    """Wrap ``module.name`` so that its keyword arguments and result are
    recorded; returns the record."""
    seen, real = {}, getattr(module, name)

    def wrapper(*args, **kwargs):
        seen.update(kwargs)
        seen["result"] = real(*args, **kwargs)
        return seen["result"]
    monkeypatch.setattr(module, name, wrapper)
    return seen


@pytest.fixture
def fresh_decode_cache():
    """The process's decode cache off before and after the test."""
    from thermal_semantic_segmentation_torch.data.cache import (
        set_decode_cache)
    set_decode_cache(0, disk_dir=None)
    yield
    set_decode_cache(0, disk_dir=None)


HOST_FLAGS = {
    "native_decode": ["--native_decode", "true"],
    "native_encode": ["--native_encode", "true"],
    # with bf16 compute, where resolve_wire keeps packed_bf16
    "wire": ["--wire", "packed_bf16", "--bf16", "true"],
    "decode_cache_mb": ["--decode_cache_mb", "512"],
    "decode_cache_dir": ["--decode_cache_dir"],     # + a directory
    "device_aug": ["-device_aug", "true"],
}
SEG_FLAGS = ["native_decode", "wire", "decode_cache_mb", "decode_cache_dir"]
WRITER_FLAGS = ["native_decode", "native_encode", "wire", "decode_cache_mb",
                "decode_cache_dir"]


def _flag_argv(flag, tmp_path) -> list:
    argv = list(HOST_FLAGS[flag])
    return argv + [str(tmp_path / "decoded")] if flag == \
        "decode_cache_dir" else argv


def _assert_landed(flag, tmp_path, *, datasets=(), reads_native_decode=False,
                   wire="packed", bf16_wire=True, native_encode=None):
    """``flag`` landed where the JAX CLI puts it, and no other flag moved:
    the decode cache's bound and disk tier, each dataset's
    ``native_decode`` (where the JAX CLI passes it), the wire the loop got
    (packed_bf16 where the CLI computes in bf16) and the writer's
    ``native_encode`` (where the CLI has one)."""
    from thermal_semantic_segmentation_torch.data.cache import decode_cache
    cache = decode_cache()
    assert cache.max_bytes == (512 << 20 if flag == "decode_cache_mb"
                               else 0)
    assert cache.disk_dir == (str(tmp_path / "decoded")
                              if flag == "decode_cache_dir" else None)
    for ds in datasets:
        assert getattr(ds, "native_decode", False) == (
            reads_native_decode and flag == "native_decode"), ds
    assert wire == ("packed_bf16" if flag == "wire" and bf16_wire
                    else "packed")
    if native_encode is not None:
        assert native_encode == (flag == "native_encode")


def _seg_argv(root, tree) -> list:
    return ["-checkpoint_name", "s.pth", "--model_root_path", str(root),
            "--freiburg_root", tree, "--device", "cpu"]


@pytest.mark.parametrize("flag", SEG_FLAGS)
def test_eval_cli_accepts_host_flags(flag, tiny_tree, tmp_path, monkeypatch,
                                     fresh_decode_cache):
    """The test split has no native path in the JAX CLI either."""
    root, tree = tiny_tree
    seen = _stop_at(monkeypatch, segmentation_evaluate, "seg_validate")
    with pytest.raises(_Reached):
        segmentation_evaluate.main(["-dataset", "freiburg_ir",
                                    *_seg_argv(root, tree),
                                    *_flag_argv(flag, tmp_path)])
    _assert_landed(flag, tmp_path, datasets=[seen["args"][1].dataset],
                   wire=seen["kwargs"]["wire"])


@pytest.mark.parametrize("flag", SEG_FLAGS + ["device_aug"])
def test_train_cli_accepts_host_flags(flag, tiny_tree, tmp_path, monkeypatch,
                                      fresh_decode_cache):
    """``-device_aug true``: the step augments on the device, the train
    frames keep their size (``ToArray`` only) and the source val split
    resizes (``val_transform``), as in the JAX CLI."""
    root, tree = tiny_tree
    monkeypatch.chdir(tmp_path)        # the CLI writes logs/<name>/
    made = _record(monkeypatch, segmentation_train, "make_seg_train_step")
    loaders = _record(monkeypatch, segmentation_train, "make_loaders")
    seen = _stop_at(monkeypatch, segmentation_train, "device_prefetch")
    with pytest.raises(_Reached):
        segmentation_train.main(
            ["-dataset", "freiburg_ir", "--freiburg_root", tree,
             "-batch_size", "2", "--layers", "1,1,1,1",
             "--model_root_path", str(tmp_path), "-new_checkpoint_name",
             "n.pth", "--device", "cpu", *_flag_argv(flag, tmp_path)])
    train, val, _ = loaders["result"]
    assert seen["args"][0] is train
    _assert_landed(flag, tmp_path, datasets=[train.dataset],
                   reads_native_decode=True, wire=seen["kwargs"]["wire"])
    assert made["device_augment"] == (flag == "device_aug")
    train_tf = [type(t).__name__ for t in train.dataset.transforms.transforms]
    val_tf = [type(t).__name__ for t in val.dataset.transforms.transforms]
    if flag == "device_aug":
        assert train_tf == ["ToArray"] and val_tf == ["Resize", "ToArray"]
    else:
        assert val.dataset is train.dataset
        assert train_tf == ["RandomResizedCrop", "RandomHorizontalFlip",
                            "ToArray"]


@pytest.mark.parametrize("cli", [generate_pseudo_label, cal_prototype],
                         ids=["generate_pseudo_label", "cal_prototype"])
@pytest.mark.parametrize("flag", WRITER_FLAGS)
def test_pseudo_and_prototype_clis_accept_host_flags(cli, flag, tiny_tree,
                                                     tmp_path, monkeypatch,
                                                     fresh_decode_cache):
    """The pseudo-label CLI's dataset takes ``--native_decode`` and its
    writer ``--native_encode``; the JAX prototype CLI reads neither."""
    root, tree = tiny_tree
    pseudo = cli is generate_pseudo_label
    seen = _stop_at(monkeypatch, cli, "generate_pseudo_labels" if pseudo
                    else "calc_prototypes")
    with pytest.raises(_Reached):
        cli.main([*_seg_argv(root, tree), "-batch_size", "2",
                  "--root" if pseudo else "-root", str(tmp_path),
                  *_flag_argv(flag, tmp_path)])
    kw = seen["kwargs"]
    _assert_landed(flag, tmp_path, datasets=[seen["args"][1].dataset],
                   reads_native_decode=pseudo, wire=kw["wire"],
                   native_encode=kw["native_encode"] if pseudo else None)
    assert pseudo or "native_encode" not in kw


@pytest.fixture(scope="module")
def tiny_prototypes(tiny_tree):
    """The prototype file the self-training CLI reads for s.pth."""
    from thermal_semantic_segmentation_torch.cli.cal_prototype import (
        prototype_path)
    from thermal_semantic_segmentation_torch.core.checkpoint import (
        save_checkpoint)
    root, _ = tiny_tree
    save_checkpoint(prototype_path(str(root), "freiburg_ir", "s.pth"),
                    {"objective_vectors": np.zeros((13, 256), np.float32),
                     "counts": np.ones(13, np.float32)})
    return root


@pytest.mark.parametrize("flag", SEG_FLAGS)
def test_self_train_cli_accepts_host_flags(flag, tiny_tree, tiny_prototypes,
                                           tmp_path, monkeypatch,
                                           fresh_decode_cache):
    """The self-training datasets have no native path, and the CLI keeps
    the wire lossless (its soft labels weigh float32 prototypes) even
    under ``--bf16 true``, as the JAX CLI does."""
    root, tree = tiny_tree
    monkeypatch.chdir(tmp_path)        # the CLI writes logs/self-training/
    loaders = _record(monkeypatch, self_train_main, "make_loaders")
    seen = _stop_at(monkeypatch, self_train_main, "device_prefetch")
    with pytest.raises(_Reached):
        self_train_main.main([*_seg_argv(root, tree), "--root", str(root),
                              "-batch_size", "2",
                              *_flag_argv(flag, tmp_path)])
    _assert_landed(flag, tmp_path,
                   datasets=[ld.dataset for ld in loaders["result"]],
                   wire=seen["kwargs"]["wire"], bf16_wire=False)


@pytest.fixture(scope="module")
def tiny_gan(tiny_tree):
    """A GAN checkpoint of a tiny s2t U-Net beside the tree."""
    from thermal_semantic_segmentation_torch.models import factory
    root, _ = tiny_tree
    g = factory.init_gan_net(factory.unet_32(ngf=4, output_nc=1), 0,
                             device="cpu")
    _common.save_gan_checkpoint(str(root / "g.pth"), {"s2t": g}, {}, epoch=0)
    return root


@pytest.mark.parametrize("name,cli", GAN_CLIS,
                         ids=[name for name, _ in GAN_CLIS])
@pytest.mark.parametrize("flag", WRITER_FLAGS)
def test_gan_clis_accept_host_flags(name, cli, flag, tiny_tree, tiny_gan,
                                    tmp_path, monkeypatch,
                                    fresh_decode_cache):
    """The GAN trainers' Freiburg datasets take ``--native_decode`` and
    keep packed_bf16 under ``--bf16 true``; the translator's writer takes
    ``--native_encode``; distance evaluation keeps the wire lossless (its
    SSIM and L1 run in float32). The JAX CLIs read no other of these."""
    root, tree = tiny_tree
    extra = _flag_argv(flag, tmp_path)
    if name in ("main", "main_gan"):
        loaders = _record(monkeypatch, main, "make_loaders")
        seen = _stop_at(monkeypatch, main, "device_prefetch")
        argv = ["-source_dataset", "freiburg_rgb", "-target_dataset",
                "freiburg_ir", "--freiburg_root", tree, "-batch_size", "2",
                "-ngf", "8", "--gan_model_root_path", str(tmp_path)]
    elif name == "translator":
        seen = _stop_at(monkeypatch, translator, "translate_batches")
        argv = ["-dataset", "freiburg_rgb", "--freiburg_root", tree,
                "-checkpoint_name", "g.pth", "--gan_model_root_path",
                str(tiny_gan)]
    else:
        seen = _stop_at(monkeypatch, distance_evaluate, "evaluate_distance")
        argv = ["-checkpoint_name", "t.pth", "--freiburg_root", tree]
    with pytest.raises(_Reached):
        cli.main(argv + ["--device", "cpu"] + extra)
    kw = seen["kwargs"]
    if name in ("main", "main_gan"):
        datasets = [ld.dataset for ld in loaders["result"]]
    else:
        datasets = [seen["args"][1 if name == "translator" else 0].dataset]
    _assert_landed(
        flag, tmp_path, datasets=datasets,
        reads_native_decode=name in ("main", "main_gan"), wire=kw["wire"],
        bf16_wire=name != "distance_evaluate",
        native_encode=(kw["native_encode"] if name == "translator"
                       else None))


# -- the flags this port now runs, in place of their refusals -------------

@pytest.fixture
def one_process_group():
    """``--distributed true`` with one process over gloo on a free
    port; the group is torn down after the test."""
    import socket
    import torch.distributed as dist
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    yield ["--distributed", "true", "--coordinator_address",
           f"localhost:{port}", "--num_processes", "1", "--process_id", "0"]
    if dist.is_initialized():
        dist.destroy_process_group()


def _joined_one_gloo_process():
    import torch.distributed as dist
    from thermal_semantic_segmentation_torch.parallel.mesh import host_shard
    return (dist.is_initialized() and dist.get_world_size() == 1
            and dist.get_backend() == "gloo" and host_shard() is None)


@pytest.fixture(scope="module")
def tiny_tree(tmp_path_factory):
    """A 5-train / 3-test frame Freiburg tree and a tiny seg checkpoint
    (layers 1,1,1,1) in its directory."""
    from tests.synthetic import make_freiburg_tree
    root = tmp_path_factory.mktemp("tree")
    tree = make_freiburg_tree(str(root / "fr"), n_train=5, n_test=3)
    torch.save({"epoch": 0, "sem_net_state_dict": create_deeplab(
        0, device="cpu", layers=(1, 1, 1, 1)).state_dict()},
        str(root / "s.pth"))
    return root, tree


def test_eval_cli_accepts_distributed(tiny_tree, one_process_group):
    """One process in a gloo group scores the set as a lone process does
    (the cross-process sums of two processes: tests/test_torch_dist.py)."""
    root, tree = tiny_tree
    argv = ["-dataset", "freiburg_ir", "-checkpoint_name", "s.pth",
            "--model_root_path", str(root), "--freiburg_root", tree,
            "-val_batch_size", "2", "--device", "cpu"]
    want = segmentation_evaluate.main(argv)
    got = segmentation_evaluate.main(argv + one_process_group)
    assert _joined_one_gloo_process()
    assert got == want


@pytest.mark.parametrize("argv", TRAIN_PORTED,
                         ids=["distributed", "per_replica", "remat_full",
                              "remat_dots"])
def test_train_cli_runs_ported_flags(argv, tiny_tree, one_process_group,
                                     tmp_path, monkeypatch):
    root, tree = tiny_tree
    monkeypatch.chdir(tmp_path)        # the CLI writes logs/<name>/
    if argv == DISTRIBUTED:
        argv = one_process_group
    state, history = segmentation_train.main(
        ["-dataset", "freiburg_ir", "--freiburg_root", tree, "-epochs", "1",
         "-batch_size", "2", "-val_batch_size", "2", "-max_steps", "1",
         "--layers", "1,1,1,1", "--model_root_path", str(tmp_path),
         "-new_checkpoint_name", "n.pth", "--device", "cpu", *argv])
    assert len(history[0]["train_losses"]) == 1
    assert np.isfinite(history[0]["train_losses"] + [history[0]["val_loss"]]).all()
    assert (tmp_path / "n.pth").exists()
    assert state.model.remat == (argv[1] if argv[0] == "--remat" else "none")
    assert _joined_one_gloo_process() == (argv == one_process_group)


@pytest.mark.parametrize("cli", [generate_pseudo_label, cal_prototype],
                         ids=["generate_pseudo_label", "cal_prototype"])
def test_pseudo_and_prototype_clis_accept_distributed(cli, tiny_tree,
                                                      one_process_group,
                                                      tmp_path):
    root, tree = tiny_tree
    argv = ["-checkpoint_name", "s.pth", "--model_root_path", str(root),
            "--freiburg_root", tree, "-batch_size", "2", "--device", "cpu"]
    if cli is generate_pseudo_label:
        argv += ["--root", str(tmp_path)]
        assert cli.main(argv + one_process_group) == 5
        written = tmp_path / "pseudo_labels" / "hard" / "s"
        assert len(list(written.glob("*_conf.npy"))) == 5
    else:
        argv += ["-root", str(tmp_path), "-epochs", "1"]
        want = cli.main(argv)
        got = cli.main(argv + one_process_group)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    assert _joined_one_gloo_process()


def test_distance_cli_accepts_distributed(tmp_path, one_process_group):
    from PIL import Image
    from tests.synthetic import make_freiburg_tree
    tree = make_freiburg_tree(str(tmp_path / "fr"), n_train=5, n_test=0,
                              hw=(320, 960))
    base = tmp_path / "fr" / "t" / "seq_00_day" / "00" / "fl_rgb"
    base.mkdir(parents=True)
    rng = np.random.default_rng(0)
    for i in range(5):
        Image.fromarray(rng.integers(0, 256, (320, 700)).astype(np.uint8),
                        mode="L").save(base / f"{i:04d}.png")
    argv = ["-checkpoint_name", "t.pth", "--freiburg_root", tree,
            "--device", "cpu"]
    want = distance_evaluate.main(argv)
    got = distance_evaluate.main(argv + one_process_group)
    assert _joined_one_gloo_process()
    assert got == want and np.isfinite(got).all()


@pytest.fixture
def two_cpu_replicas(monkeypatch):
    """``--data_parallel`` sees two devices, both the CPU: the
    ``LocalMesh`` runs two model copies on it."""
    from thermal_semantic_segmentation_torch.parallel import mesh as pmesh
    monkeypatch.setattr(pmesh, "default_devices",
                        lambda: [torch.device("cpu")] * 2)


def test_eval_cli_accepts_data_parallel(tiny_tree, two_cpu_replicas, capsys):
    """Batches of 2 and a tail of 1 split over two CPU replicas: the
    one-device scores (mIoU exactly, val_loss rtol 1e-6)."""
    root, tree = tiny_tree
    argv = ["-dataset", "freiburg_ir", "-checkpoint_name", "s.pth",
            "--model_root_path", str(root), "--freiburg_root", tree,
            "-val_batch_size", "2", "--device", "cpu"]
    want = segmentation_evaluate.main(argv)
    got = segmentation_evaluate.main(argv + DATA_PARALLEL)
    assert "evaluating data-parallel over 2 devices" in capsys.readouterr().out
    assert got[0] == want[0] and got[2] == want[2]
    np.testing.assert_allclose(got[1], want[1], rtol=1e-6)


def test_train_cli_accepts_data_parallel(tiny_tree, two_cpu_replicas,
                                         tmp_path, monkeypatch):
    """The train CLI validates over two CPU replicas: the same step, the
    one-device val_loss (rtol 1e-6)."""
    root, tree = tiny_tree
    monkeypatch.chdir(tmp_path)        # the CLI writes logs/<name>/
    argv = ["-dataset", "freiburg_ir", "--freiburg_root", tree, "-epochs",
            "1", "-batch_size", "2", "-val_batch_size", "2", "-max_steps",
            "1", "--layers", "1,1,1,1", "--model_root_path", str(tmp_path),
            "-new_checkpoint_name", "n.pth", "--device", "cpu"]
    _, want = segmentation_train.main(argv)
    _, got = segmentation_train.main(argv + DATA_PARALLEL)
    assert got[0]["train_losses"] == want[0]["train_losses"]
    np.testing.assert_allclose(got[0]["val_loss"], want[0]["val_loss"],
                               rtol=1e-6)


@pytest.mark.parametrize("cli", [generate_pseudo_label, cal_prototype],
                         ids=["generate_pseudo_label", "cal_prototype"])
def test_pseudo_and_prototype_clis_accept_data_parallel(cli, tiny_tree,
                                                        two_cpu_replicas,
                                                        tmp_path):
    """Batches of 2 and a tail of 1 over two CPU replicas: the one-device
    files (ids equal, confidences 1e-6) and prototypes (5e-6, counts
    exact)."""
    root, tree = tiny_tree
    argv = ["-checkpoint_name", "s.pth", "--model_root_path", str(root),
            "--freiburg_root", tree, "-batch_size", "2", "--device", "cpu"]
    if cli is generate_pseudo_label:
        out = {}
        for name, extra in (("one", []), ("two", DATA_PARALLEL)):
            assert cli.main(argv + ["--root", str(tmp_path / name)]
                            + extra) == 5
            out[name] = tmp_path / name / "pseudo_labels" / "hard" / "s"
        files = sorted(p.name for p in out["one"].iterdir())
        assert files == sorted(p.name for p in out["two"].iterdir())
        for f in files:
            if f.endswith("_conf.npy"):
                np.testing.assert_allclose(np.load(out["two"] / f),
                                           np.load(out["one"] / f), atol=1e-6)
            elif not f.endswith("_color.png"):
                assert (out["two"] / f).read_bytes() == \
                    (out["one"] / f).read_bytes(), f
    else:
        argv += ["-root", str(tmp_path), "-epochs", "1"]
        want = cli.main(argv)
        got = cli.main(argv + DATA_PARALLEL)
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_allclose(got[0], want[0], rtol=0, atol=5e-6)


def test_self_train_cli_accepts_remat():
    """The self-training CLI builds its student with ``--remat``: a train
    step through it folds each BatchNorm's statistics once."""
    from thermal_semantic_segmentation_torch.cli.options import (
        self_train_parse)
    args = self_train_parse().parse_args(REMAT_FULL + [
        "--device", "cpu", "--layers", "1,1,1,1"])
    args.net_mode, args.num_classes = "one_channel", 13
    model = _common.build_deeplab(args, device="cpu").train()
    model.layer5.head[0].p = 0.0
    assert model.remat == "full"
    model(torch.rand(2, 1, 32, 64))["out"].sum().backward()
    assert int(model.bn1.num_batches_tracked) == 1
    assert int(model.layer1[0].bn1.num_batches_tracked) == 1
    assert model.layer1[0].conv1.weight.grad is not None


@pytest.mark.parametrize("name,cli", GAN_CLIS,
                         ids=[name for name, _ in GAN_CLIS])
def test_gan_clis_accept_remat(name, cli):
    """The JAX CLIs that build no DeepLab take ``--remat`` and leave it
    unused; so do these."""
    from thermal_semantic_segmentation_torch.cli.options import (
        train_parse, translation_parse)
    parse = {"main": train_parse, "main_gan": train_parse,
             "translator": translation_parse,
             "distance_evaluate": distance_evaluate.distance_parse}[name]
    assert parse().parse_args(REMAT_FULL + ["--device", "cpu"]).remat == \
        "full"


def test_translator_writes_pngs_without_pil(tmp_path):
    """The translator's batch loop encodes PNG destinations itself (the
    card's machine has no PIL), a tail batch at its own size."""
    code = (
        "import sys, numpy as np\n"
        "from thermal_semantic_segmentation_torch.cli import _common, "
        "translator\n"
        "from thermal_semantic_segmentation_torch.models import factory\n"
        "g = factory.init_gan_net(factory.unet_32(ngf=4, output_nc=1), 0, "
        "device='cpu')\n"
        f"ckpt = {str(tmp_path / 'g.pth')!r}\n"
        "_common.save_gan_checkpoint(ckpt, {'s2t': g}, {}, epoch=0)\n"
        "model, ngf = _common.build_generator_from_gan_checkpoint(ckpt, "
        "'s2t', input_nc=3, output_nc=1, device='cpu')\n"
        "rng = np.random.default_rng(0)\n"
        f"out = {str(tmp_path / 'out')!r}\n"
        "batches = [{'image': rng.uniform(-1, 1, (n, 32, 64, 3))"
        ".astype(np.float32), 'img_path': [f'{out}/{i}{k}.png' "
        "for k in range(n)]} for i, n in enumerate((2, 1))]\n"
        "s = translator.translate_batches(model, batches, denormalize=[0.5],"
        " save_hw=(40, 72), suffix='x', device='cpu')\n"
        "assert s['images'] == 3 and ngf == 4, s\n"
        "sys.exit(1 if 'PIL' in sys.modules else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert sorted(p.name for p in (tmp_path / "out").iterdir()) == [
        "00_x.png", "01_x.png", "10_x.png"]


def test_device_prefetch_carries_nested_dicts():
    """A nested dict of arrays (self-training's weak_params) arrives as
    tensors; a flat batch arrives as before, other values untouched."""
    flat = {"image": np.ones((2, 3), np.float32), "img_path": ["a", "b"]}
    nested = dict(flat, weak_params={
        "crop": np.arange(8, dtype=np.int32).reshape(2, 4),
        "flip": np.array([True, False]), "deeper": {"x": np.zeros(2)}})
    got = list(device_prefetch([flat, nested], "cpu"))
    assert got[0].keys() == flat.keys() and got[0]["img_path"] == ["a", "b"]
    assert torch.equal(got[0]["image"], torch.ones((2, 3)))
    wp = got[1]["weak_params"]
    assert torch.equal(wp["crop"], torch.arange(8, dtype=torch.int32)
                       .reshape(2, 4))
    assert wp["flip"].dtype == torch.bool and wp["flip"].tolist() == [
        True, False]
    assert torch.equal(wp["deeper"]["x"], torch.zeros(2, dtype=torch.float64))


def test_validation_dumps_load_no_pil(tmp_path):
    """seg_validate's save_all dumps, as the self-training CLI writes its
    save_one dumps, need no PIL (the card's machine has none)."""
    code = (
        "import sys, numpy as np\n"
        "from thermal_semantic_segmentation_torch.eval.validate import "
        "seg_validate\n"
        "from thermal_semantic_segmentation_torch.models.deeplab import "
        "create_deeplab\n"
        "m = create_deeplab(0, device='cpu', layers=(1, 1, 1, 1))\n"
        "b = [{'image': np.zeros((1, 16, 32, 1), np.float32),"
        " 'label': np.zeros((1, 16, 32), np.int64)}]\n"
        f"seg_validate(m, b, device='cpu', visualize='save_all', "
        f"save_root={str(tmp_path)!r})\n"
        "sys.exit(1 if 'PIL' in sys.modules else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "0_groundtruth.png", "0_image.png", "0_prediction.png"]


def test_train_step_runs_device_augment():
    """``device_augment=True``: the step crops raw frames to ``label_hw``
    with the draws of ``augment_generator`` (dropout_seed + 1, step) and
    then takes the plain step, so it equals the plain step on the batch
    ``random_resized_crop_flip`` gives from the same generator (loss and
    weights within float32 noise, rtol 1e-6)."""
    from thermal_semantic_segmentation_torch.ops.augment import (
        random_resized_crop_flip)
    from thermal_semantic_segmentation_torch.train.seg import (
        augment_generator)
    rng = np.random.default_rng(0)
    image = torch.from_numpy(rng.random((2, 40, 90, 1), dtype=np.float32))
    label = torch.from_numpy(rng.integers(0, 13, (2, 40, 90)))
    import copy
    first = create_deeplab(0, device="cpu", layers=(1, 1, 1, 1))
    first.layer5.head[0].p = 0.0
    out = {}
    for aug, model in ((True, first), (False, copy.deepcopy(first))):
        state = create_seg_state(model, learning_rate=1e-4, device="cpu")
        step = make_seg_train_step(ignore_index=12, label_hw=(32, 64),
                                   base_lr=1e-4, dropout_seed=3,
                                   device_augment=aug, device="cpu")
        if aug:
            out[aug] = step(state, image, label)
        else:
            img, lab = random_resized_crop_flip(
                augment_generator(torch.device("cpu"), 3, 0), image,
                labels=label, out_hw=(32, 64))
            assert img.shape == (2, 32, 64, 1) and lab.shape == (2, 32, 64)
            out[aug] = step(state, img, lab)
        out[(aug, "w")] = model.conv1.weight.detach().clone()
    torch.testing.assert_close(out[True], out[False], rtol=1e-6, atol=0)
    torch.testing.assert_close(out[(True, "w")], out[(False, "w")],
                               rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("mode", ["per_replica", "mesh"])
def test_train_step_runs_bn_mode_and_mesh(mode, one_process_group):
    """``bn_mode='per_replica'`` without a mesh (one replica) and a
    one-process mesh (DDP over gloo) each give the plain step's loss and
    weights within float32 noise (rtol 1e-6)."""
    from thermal_semantic_segmentation_torch.cli.options import seg_parse
    from thermal_semantic_segmentation_torch.parallel.mesh import make_mesh
    kw = {"bn_mode": "per_replica"}
    if mode == "mesh":
        seg_parse().parse_args(one_process_group + ["--device", "cpu"])
        kw = {"mesh": make_mesh("cpu")}
    rng = np.random.default_rng(0)
    image = torch.from_numpy(rng.uniform(0, 1, (2, 32, 64, 1)).astype(
        np.float32))
    label = torch.from_numpy(rng.integers(0, 13, (2, 32, 64)))
    out = []
    for extra in ({}, kw):
        model = create_deeplab(0, device="cpu", layers=(1, 1, 1, 1))
        model.layer5.head[0].p = 0.0
        state = create_seg_state(model, learning_rate=1e-4, device="cpu")
        step = make_seg_train_step(ignore_index=12, label_hw=(32, 64),
                                   base_lr=1e-4, device="cpu", **extra)
        out.append((float(step(state, image, label)), model.state_dict()))
    (want, want_sd), (got, got_sd) = out
    np.testing.assert_allclose(got, want, rtol=1e-6)
    for k, v in want_sd.items():
        torch.testing.assert_close(got_sd[k], v, rtol=1e-6, atol=1e-7)


def test_chip_smoke_alone_fails_without_result(tmp_path):
    """Without a card, or without the rest of the repo beside it, the smoke
    test exits non-zero and prints no result line."""
    (tmp_path / "chip_smoke.py").write_text((REPO / "chip_smoke.py").read_text())
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


# One body of code reads every PNG path of the slice, run by a child
# process with PIL blocked on the port's modules and, here, with PIL on the
# JAX package's; each key names one array of one sample.
PIL_FREE_GATHER = '''
def gather(kind, spec, common, freiburg, aug, preprocess, host_rng):
    import numpy as np
    from thermal_semantic_segmentation_torch.cli.options import seg_parse

    out = {}

    def put(prefix, sample):
        for key, value in sample.items():
            if key == "weak_params":
                for k, v in value.items():
                    out[f"{prefix}/weak_params/{k}"] = np.asarray(v)
            elif key != "img_path":
                out[f"{prefix}/{key}"] = np.asarray(value)

    if kind == "freiburg":
        for dataset, gray, for_eval in (
                ("freiburg_ir", False, False), ("freiburg_rgb", False, False),
                ("freiburg_rgb", True, False),
                ("freiburg_translation", False, False),
                ("freiburg_ir", False, True)):
            args = seg_parse().parse_args(
                ["-dataset", dataset, "--freiburg_root", spec["fr"],
                 "-translation_name", "translation", "-grayscale", str(gray)])
            tf = common.val_transform() if for_eval else \\
                common.train_transform()
            ds = common.build_seg_dataset(args, tf, for_eval=for_eval)
            for i in range(len(ds)):
                put(f"{dataset}/{gray}/{for_eval}/{i}",
                    ds.get(i, host_rng(0, 1, i)))
    elif kind == "cityscapes":
        for dataset in ("cityscapes", "cityscapes_translation"):
            args = seg_parse().parse_args(
                ["-dataset", dataset, "--source_root", spec["cs"]])
            ds = common.build_seg_dataset(args, common.train_transform())
            for i in range(len(ds)):
                put(f"{dataset}/{i}", ds.get(i, host_rng(0, 2, i)))
    elif kind == "self_train":
        for threshold in (0.3, 0.0):
            ds = freiburg.Freiburg(
                spec["fr"], "train", "IR", segmentation_mode=True,
                self_train=True, path_soft=spec["soft"],
                path_lp=spec["hard"], threshold=threshold, ignore_index=12,
                augmentations=aug.SelfTrainAugment(600, (256, 128), 0.5))
            for i in range(len(ds)):
                put(f"{threshold}/{i}", ds.get(i, np.random.default_rng(i)))
    elif kind == "preprocess":
        for name, channels in spec["bodies"]:
            with open(spec["dir"] + "/" + name, "rb") as f:
                out[f"{name}/{channels}"] = preprocess(f.read(), (256, 512),
                                                      channels)
    return out
'''

PIL_FREE_KINDS = ("freiburg", "cityscapes", "self_train", "preprocess")

PIL_FREE_CHILD = '''
import json, sys
sys.modules["PIL"] = None       # every import of PIL now fails
import numpy as np
from thermal_semantic_segmentation_torch.cli import _common, translator
from thermal_semantic_segmentation_torch.core.prng import host_rng
from thermal_semantic_segmentation_torch.data import freiburg, self_train_aug
from thermal_semantic_segmentation_torch.serving.batcher import preprocess
''' + PIL_FREE_GATHER + '''
spec = json.loads(sys.argv[1])
for kind in spec["kinds"]:
    out = gather(kind, spec, _common, freiburg, self_train_aug, preprocess,
                 host_rng)
    np.savez(f"{spec['dir']}/{kind}.npz", **out)
with open(spec["jpeg"], "rb") as f:
    jpeg = f.read()
errors = {}
for name, fn in (
        ("body", lambda: preprocess(jpeg)),
        ("t2s", lambda: freiburg.FreiburgTranslationPairs(
            "t2s", _common.val_transform(), root=spec["dir"],
            strip_underscore=False).get(0, None)),
        ("write", lambda: translator.write_frame(
            spec["dir"] + "/out.jpg", np.zeros((4, 4, 1), np.uint8)))):
    try:
        fn()
        errors[name] = "no error"
    except ModuleNotFoundError as e:
        errors[name] = "bare ModuleNotFoundError: " + str(e)
    except Exception as e:
        errors[name] = type(e).__name__ + ": " + str(e)
with open(spec["dir"] + "/errors.json", "w") as f:
    json.dump(errors, f)
'''


@pytest.fixture(scope="module")
def pil_free_reads(tmp_path_factory):
    """Trees of PIL-written PNGs (Freiburg with translations, Cityscapes,
    the self-training pseudo-labels), request bodies and JPEG files, read
    by one child process with PIL blocked."""
    import json

    from PIL import Image

    from tests.synthetic import make_cityscapes_tree, make_freiburg_tree
    base = tmp_path_factory.mktemp("pil_free")
    fr = make_freiburg_tree(str(base / "fr"), n_train=3, n_test=2,
                            translation_name="translation")
    cs = make_cityscapes_tree(str(base / "cs"), n=2)
    make_cityscapes_tree(str(base / "cs"), n=2, data_folder="translation",
                         seed=2)
    rng = np.random.default_rng(6)
    for sub in ("hard", "soft"):
        (base / sub).mkdir()
    for i in range(3):
        Image.fromarray(rng.integers(0, 13, (256, 512)).astype(np.uint8)).save(
            base / "hard" / f"{i:04d}.png")
        np.save(base / "hard" / f"{i:04d}_conf.npy",
                rng.random((256, 512)).astype(np.float16))
        soft = rng.random((13, 33, 65)).astype(np.float32)
        np.save(base / "soft" / f"{i:04d}.npy", soft / soft.sum(0))
    bodies = {
        "u16.png": Image.fromarray(rng.integers(20500, 26500, (41, 123))
                                   .astype(np.uint16)),
        "gray.png": Image.fromarray(rng.integers(0, 256, (37, 90))
                                    .astype(np.uint8)),
        "rgb.png": Image.fromarray(rng.integers(0, 256, (37, 90, 3))
                                   .astype(np.uint8)),
        "rgba.png": Image.fromarray(rng.integers(0, 256, (37, 90, 4))
                                    .astype(np.uint8)),
    }
    pal = Image.fromarray(rng.integers(0, 9, (37, 90)).astype(np.uint8),
                          mode="P")
    pal.putpalette(rng.integers(0, 256, 27).tolist())
    bodies["palette.png"] = pal
    for name, img in bodies.items():
        img.save(base / name)
    (base / "t2s").mkdir()
    Image.fromarray(rng.integers(0, 256, (40, 80, 3)).astype(np.uint8)).save(
        base / "t2s" / "0000_translation.jpg")
    Image.fromarray(rng.integers(0, 13, (40, 80)).astype(np.uint8)).save(
        base / "t2s" / "0000_groundtruth.png")
    spec = {"fr": fr, "cs": cs, "soft": str(base / "soft"),
            "hard": str(base / "hard"), "dir": str(base),
            "kinds": PIL_FREE_KINDS, "jpeg": str(base / "t2s" /
                                                  "0000_translation.jpg"),
            "bodies": [("u16.png", 1), ("gray.png", 1), ("rgb.png", 1),
                       ("rgb.png", 3), ("rgba.png", 3), ("palette.png", 3),
                       ("palette.png", 1)]}
    proc = subprocess.run(
        [sys.executable, "-c", PIL_FREE_CHILD, json.dumps(spec)], cwd=REPO,
        capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return spec, json.loads((base / "errors.json").read_text())


@pytest.mark.parametrize("kind", PIL_FREE_KINDS)
def test_png_paths_read_without_pil_match_jax(pil_free_reads, kind):
    """With PIL blocked, the port reads the Freiburg splits (IR, RGB, gray,
    translated, the test split's .npy labels), Cityscapes (original and
    translated), the self-training samples (hard PNG pseudo-labels) and
    16-bit, L, RGB, RGBA and palette PNG request bodies: each array equals
    the JAX package's from PIL (the soft maps within 1e-6, as
    tests/test_torch_self_train_data.py holds them)."""
    from thermal_semantic_segmentation_tpu.cli import _common as jax_common
    from thermal_semantic_segmentation_tpu.core.prng import (
        host_rng as jax_host_rng)
    from thermal_semantic_segmentation_tpu.data import (
        freiburg as jax_freiburg, self_train_aug as jax_aug)
    from thermal_semantic_segmentation_tpu.serving.batcher import (
        preprocess as jax_preprocess)
    spec, _ = pil_free_reads
    scope: dict = {}
    exec(PIL_FREE_GATHER, scope)
    want = scope["gather"](kind, spec, jax_common, jax_freiburg, jax_aug,
                           jax_preprocess, jax_host_rng)
    got = np.load(f"{spec['dir']}/{kind}.npz")
    assert len(want) >= 7 and sorted(got.files) == sorted(want)
    for key, value in want.items():
        assert got[key].dtype == value.dtype, key
        if key.endswith("label_soft"):
            np.testing.assert_allclose(got[key], value, rtol=0, atol=1e-6,
                                       err_msg=key)
        else:
            np.testing.assert_array_equal(got[key], value, err_msg=key)


def test_jpeg_paths_without_pil_name_the_file(pil_free_reads):
    """JPEG is not read without PIL: a JPEG request body, a t2s
    ``*translation.jpg`` frame and a translator ``.jpg`` destination raise
    an error that names the file (or the request body) and says PNG works,
    never a bare ModuleNotFoundError."""
    spec, errors = pil_free_reads
    assert errors["body"].startswith("ImageReadError: request body: JPEG "
                                     "is not decoded on this host")
    assert errors["t2s"].startswith(f"ImageReadError: {spec['jpeg']}: JPEG")
    assert errors["write"].startswith(
        f"RuntimeError: {spec['dir']}/out.jpg: writing .jpg needs PIL")
    for message in errors.values():
        assert "PNG" in message and "ModuleNotFoundError" not in message
