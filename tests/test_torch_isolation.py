"""The PyTorch port stands alone: it imports neither JAX nor anything of the
JAX package (nor PIL when a module is imported: the card's machine has
none), its entry points refuse to fall back to the CPU quietly, and its CLIs
refuse the JAX package's flags they have not ported."""

import ast
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import thermal_semantic_segmentation_torch as port  # noqa: E402
from thermal_semantic_segmentation_torch.cli import (  # noqa: E402
    cal_prototype, generate_pseudo_label, segmentation_evaluate,
    segmentation_train)
from thermal_semantic_segmentation_torch.eval.validate import (  # noqa: E402
    seg_validate)
from thermal_semantic_segmentation_torch.models.deeplab import (  # noqa: E402
    create_deeplab)
from thermal_semantic_segmentation_torch.serving.batcher import (  # noqa: E402
    InferenceServer)
from thermal_semantic_segmentation_torch.train.prototypes import (  # noqa: E402,E501
    calc_prototypes)
from thermal_semantic_segmentation_torch.train.pseudo import (  # noqa: E402
    generate_pseudo_labels)
from thermal_semantic_segmentation_torch.train.seg import (  # noqa: E402
    build_seg_eval_step, create_seg_state, make_seg_train_step)

BANNED = ("jax", "jaxlib", "flax", "optax", "msgpack",
          "thermal_semantic_segmentation_tpu")
PORT_DIR = Path(port.__file__).parent
REPO = PORT_DIR.parent
SOURCES = sorted(PORT_DIR.rglob("*.py")) + [REPO / "chip_smoke.py"]


def _banned(name: str) -> bool:
    return name.split(".")[0] in BANNED


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
                "cli.generate_pseudo_label", "cli.cal_prototype"):
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


@pytest.mark.parametrize("entry", [
    "create_deeplab", "InferenceServer", "build_seg_eval_step",
    "seg_validate", "seg_evaluation", "make_seg_train_step",
    "create_seg_state", "segmentation_train", "generate_pseudo_labels",
    "calc_prototypes", "generate_pseudo_label", "cal_prototype"])
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
        else:
            segmentation_evaluate.main(["-dataset", "freiburg_ir"])


@pytest.mark.parametrize("argv", [
    ["--distributed", "true"], ["--data_parallel", "true"],
    ["--native_decode", "true"], ["--wire", "packed_bf16"],
    ["--decode_cache_mb", "512"], ["--decode_cache_dir", "cache"]])
def test_eval_cli_refuses_flags_not_yet_ported(argv, capsys):
    with pytest.raises(SystemExit) as exit_info:
        segmentation_evaluate.main(argv + ["--device", "cpu"])
    assert exit_info.value.code != 0
    assert "not yet ported" in capsys.readouterr().err


@pytest.mark.parametrize("argv", [
    ["--distributed", "true"], ["--data_parallel", "true"],
    ["--native_decode", "true"], ["--wire", "packed_bf16"],
    ["--decode_cache_mb", "512"], ["--decode_cache_dir", "cache"],
    ["-device_aug", "true"], ["-bn_mode", "per_replica"],
    ["--remat", "full"], ["--remat", "dots"]])
def test_train_cli_refuses_flags_not_yet_ported(argv, capsys):
    with pytest.raises(SystemExit) as exit_info:
        segmentation_train.main(argv + ["--device", "cpu"])
    assert exit_info.value.code != 0
    err = capsys.readouterr().err
    assert f"error: {argv[0]} " in err and "is not yet ported" in err


@pytest.mark.parametrize("cli", [generate_pseudo_label, cal_prototype],
                         ids=["generate_pseudo_label", "cal_prototype"])
@pytest.mark.parametrize("argv", [
    ["--distributed", "true"], ["--data_parallel", "true"],
    ["--native_decode", "true"], ["--native_encode", "true"],
    ["--wire", "packed_bf16"], ["--decode_cache_mb", "512"],
    ["--decode_cache_dir", "cache"]])
def test_pseudo_and_prototype_clis_refuse_flags_not_yet_ported(cli, argv,
                                                               capsys):
    with pytest.raises(SystemExit) as exit_info:
        cli.main(argv + ["--device", "cpu"])
    assert exit_info.value.code != 0
    err = capsys.readouterr().err
    assert f"error: {argv[0]} " in err and "is not yet ported" in err


def test_train_step_refuses_modes_not_yet_ported():
    for kw in ({"device_augment": True}, {"bn_mode": "per_replica"},
               {"mesh": object()}):
        with pytest.raises(NotImplementedError, match="not yet ported"):
            make_seg_train_step(ignore_index=12, base_lr=1e-4, device="cpu",
                                **kw)


def test_chip_smoke_alone_fails_without_result(tmp_path):
    """Without a card, or without the rest of the repo beside it, the smoke
    test exits non-zero and prints no result line."""
    (tmp_path / "chip_smoke.py").write_text((REPO / "chip_smoke.py").read_text())
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
