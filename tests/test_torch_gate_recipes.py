"""The port's self-training and convergence gates (``recipes/gates.py``
``selftrain_gate``, ``convergence_gate``) against the JAX repo's
(``bench_all.bench_selftrain_gate``, ``bench_all.bench_convergence``), on
the CPU.

- argument parity: with every CLI's ``main`` stubbed in both packages (a
  stubbed ``segmentation_evaluate`` prints a reference-format 'mean iou
  score' line, lower for the source model than for the adapted one) and
  the tree makers at 64x192, both gates call the same CLIs in the same
  order with the same arguments, apart from the port's ``--device cpu``;
  their trees come from the same maker arguments and their JSONs carry
  the same keys and values (the seconds aside); ``bench_all``'s
  ``--epochs=``/``--layers=``/``--lr=`` are the port's ``--epochs``/
  ``--layers``/``--lr``;
- the ``--smoke --device cpu`` chain of both gates runs (the CLIs shrunk
  by ``tests/test_torch_gates.py``'s ``tiny_clis``): the stage list, the
  pseudo-label and prototype files, every checkpoint loads, the final
  mIoU is the eval CLI's own on the same checkpoint, no gate JSON; a
  second convergence run in the same directory reuses its training, and
  a run at other options there trains anew;
- ``gates.main`` refuses the convergence gate's options for any other
  gate.
"""

import glob
import json
import os
import shutil
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import bench_all  # noqa: E402
from tests import synthetic  # noqa: E402
from tests.test_torch_gates import SMALL_HW, tiny_clis  # noqa: E402,F401
from thermal_semantic_segmentation_tpu.core.checkpoint import (  # noqa: E402
    load_checkpoint as jax_load_checkpoint)
from thermal_semantic_segmentation_torch.cli import (  # noqa: E402
    _common, segmentation_evaluate)
from thermal_semantic_segmentation_torch.recipes import gates  # noqa: E402

CLIS = ("segmentation_train", "segmentation_evaluate",
        "generate_pseudo_label", "cal_prototype", "self_train_main")
MAKERS = {"selftrain": "make_selftrain_freiburg_tree",
          "convergence": "make_learnable_freiburg_tree"}
SOURCE_MIOU, ADAPTED_MIOU, CONVERGED_MIOU = 0.4125, 0.6375, 0.9375


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _stub_clis(monkeypatch, calls):
    """Every CLI's ``main`` in both packages records ``(package, cli,
    argv)`` and makes its ``--model_root_path`` (where a gate's stage
    marker goes); the eval CLI prints a 'mean iou score' line."""
    import importlib

    def stub(package, cli):
        def main(argv=None):
            argv = list(argv)
            calls.append((package, cli, argv))
            if "--model_root_path" in argv:
                os.makedirs(argv[argv.index("--model_root_path") + 1],
                            exist_ok=True)
            if cli == "segmentation_evaluate":
                name = argv[argv.index("-checkpoint_name") + 1]
                miou = (ADAPTED_MIOU if "adapted" in name else
                        CONVERGED_MIOU if "convergence" in name else
                        SOURCE_MIOU)
                print(f"mean iou score: [{miou}]. val_loss: [0.25]")
        return main

    for package in ("thermal_semantic_segmentation_tpu",
                    "thermal_semantic_segmentation_torch"):
        for cli in CLIS:
            module = importlib.import_module(f"{package}.cli.{cli}")
            monkeypatch.setattr(module, "main", stub(package, cli))


def _stub_makers(monkeypatch, made, frames=None):
    """Both packages' tree makers at 64x192, each call recorded as
    ``(package, maker, root, kwargs)``; ``frames``: each split written
    with at most that many frames (the CLIs are stubs)."""
    for package, module in (("jax", synthetic), ("port", gates)):
        for name in MAKERS.values():
            real = getattr(module, name)

            def small(root, _real=real, _package=package, _name=name,
                      **kwargs):
                made.append((_package, _name, root, kwargs))
                written = {**kwargs} if frames is None else {
                    **kwargs, "n_train": min(kwargs["n_train"], frames),
                    "n_test": min(kwargs["n_test"], frames)}
                return _real(root, hw=SMALL_HW, **written)
            small.__name__ = name
            monkeypatch.setattr(module, name, small)


def _normalised(calls, made, package, cli_package):
    """The package's CLI calls, its work directory (the tree root's
    grandparent) written ``<work>``; the port's ``--device cpu`` pair
    taken out (exactly one a call)."""
    (root,) = [r for p, _, r, _ in made if p == package]
    work = os.path.dirname(os.path.dirname(root))
    out = []
    for p, cli, argv in calls:
        if p != cli_package:
            continue
        argv = [a.replace(work, "<work>") for a in argv]
        if package == "port":
            at = [i for i, a in enumerate(argv) if a == "--device"]
            assert len(at) == 1 and argv[at[0] + 1] == "cpu", argv
            del argv[at[0]:at[0] + 2]
        out.append((cli, argv))
    return out


CASES = {
    "selftrain": (["selftrain"], []),
    "convergence": (["convergence"], []),
    "convergence_options": (["convergence", "--epochs=7",
                             "--layers=1,2,1,1", "--lr=0.01"],
                            ["--epochs", "7", "--layers", "1,2,1,1",
                             "--lr", "0.01"]),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_gate_calls_the_clis_as_bench_all(case, tmp_path, monkeypatch,
                                          capsys):
    jax_argv, port_options = CASES[case]
    gate = jax_argv[0]
    calls, made = [], []
    _stub_clis(monkeypatch, calls)
    _stub_makers(monkeypatch, made, frames=2)
    # bench_all writes its JSON beside its __file__ (and fingerprints its
    # trees by the tests/synthetic.py there), the port beside REPO
    os.makedirs(tmp_path / "tests")
    shutil.copy(synthetic.__file__, tmp_path / "tests" / "synthetic.py")
    monkeypatch.setattr(bench_all, "__file__", str(tmp_path / "bench_all.py"))
    monkeypatch.setattr(gates, "REPO", str(tmp_path))
    monkeypatch.setattr(sys, "argv", ["bench_all.py", *jax_argv,
                                      f"--workdir={tmp_path / 'jax'}"])
    jax_result = {"selftrain": bench_all.bench_selftrain_gate,
                  "convergence": bench_all.bench_convergence}[gate]()
    assert gates.main([gate, "--device", "cpu", "--workdir",
                       str(tmp_path / "port"), *port_options]) == 0
    capsys.readouterr()

    jax_calls = _normalised(calls, made, "jax",
                            "thermal_semantic_segmentation_tpu")
    port_calls = _normalised(calls, made, "port",
                             "thermal_semantic_segmentation_torch")
    want = {"selftrain": ["segmentation_train", "segmentation_evaluate",
                          "generate_pseudo_label", "generate_pseudo_label",
                          "cal_prototype", "self_train_main",
                          "segmentation_evaluate"],
            "convergence": ["segmentation_train",
                            "segmentation_evaluate"]}[gate]
    assert [cli for cli, _ in jax_calls] == want
    assert port_calls == jax_calls
    # the same trees
    assert [(n, k) for p, n, _, k in made if p == "port"] == \
        [(n, k) for p, n, _, k in made if p == "jax"]
    assert [n for _, n, _, _ in made] == [MAKERS[gate]] * 2

    name = {"selftrain": "SELFTRAIN_GATE", "convergence": "CONVERGENCE"}[gate]
    with open(tmp_path / f"{name}.json") as f:
        jax_json = json.load(f)
    with open(tmp_path / f"{name}_TORCH.json") as f:
        port_json = json.load(f)
    assert jax_json == jax_result
    timed = {"total_sec", "train_sec"}
    assert {k: v for k, v in port_json.items() if k in jax_json
            and k not in timed} == {k: v for k, v in jax_json.items()
                                    if k not in timed}
    assert set(jax_json) <= set(port_json)
    assert port_json["device"] == "cpu" and port_json["passed"]
    if gate == "selftrain":
        assert port_json["miou_source"] == SOURCE_MIOU
        assert port_json["miou_adapted"] == ADAPTED_MIOU
        assert port_json["value"] == round(ADAPTED_MIOU - SOURCE_MIOU, 4)
        assert list(port_json["stage_sec"]) == [
            "selftrain_source", "source_eval", "pseudo_soft", "pseudo_hard",
            "prototypes", "self_train", "adapted_eval"]
    else:
        assert port_json["value"] == CONVERGED_MIOU
        assert port_json["lr"] == float(dict(
            a.split("=") for a in jax_argv[1:]).get("--lr", "0.003"))
        assert list(port_json["stage_sec"]) == ["convergence_train",
                                                "convergence_eval"]
        assert port_json["train_sec"] == \
            port_json["stage_sec"]["convergence_train"]


def _lines(out):
    return [json.loads(line) for line in out.splitlines()
            if line.startswith('{"stage"')]


@pytest.fixture
def small_gate_trees(monkeypatch):
    _stub_makers(monkeypatch, [])


def test_selftrain_smoke_chain(tiny_clis, small_gate_trees,  # noqa: F811
                               tmp_path, capsys, monkeypatch):
    monkeypatch.setattr(gates, "REPO", str(tmp_path))
    gates.main(["selftrain", "--smoke", "--device", "cpu", "--workdir",
                str(tmp_path / "st")])
    lines = _lines(capsys.readouterr().out)
    assert [line["stage"] for line in lines] == [
        "selftrain_source", "source_eval", "pseudo_soft", "pseudo_hard",
        "prototypes", "self_train", "adapted_eval"]
    smoke = str(tmp_path / "st_smoke")
    tree = os.path.join(smoke, "datasets", "freiburg")
    frames = 16
    labels = os.path.join(smoke, "pseudo_labels")
    for pattern, n in (("soft/selftrain_source/*.npy", frames),
                       ("hard/selftrain_source/*_color.png", frames),
                       ("hard/selftrain_source/*_conf.npy", frames),
                       ("hard/selftrain_source/*.png", 2 * frames)):
        assert len(glob.glob(os.path.join(labels, pattern))) == n, pattern
    protos = jax_load_checkpoint(os.path.join(
        smoke, "prototypes",
        "prototypes_on_freiburg_ir_from_selftrain_source"))
    assert np.asarray(protos["objective_vectors"]).shape == (13, 256)
    ckpt = os.path.join(smoke, "ckpt")
    for name in ("selftrain_source.pth", "bestselftrain_adapted.pth",
                 "lastselftrain_adapted.pth"):
        _common.load_seg_checkpoint(os.path.join(ckpt, name))
    # the stages' mIoU is the eval CLI's own, parsed from its output
    by_stage = {line["stage"]: line for line in lines}
    for stage, name in (("source_eval", "selftrain_source.pth"),
                        ("adapted_eval", "bestselftrain_adapted.pth")):
        cli_iu = segmentation_evaluate.main([
            "-dataset", "freiburg_ir", "--freiburg_root", tree,
            "-checkpoint_name", name, "--model_root_path", ckpt,
            "-val_batch_size", "8", "--device", "cpu"])[0]
        assert by_stage[stage]["miou"] == round(float(cli_iu), 4), stage
    assert not glob.glob(str(tmp_path / "*.json"))


def test_convergence_smoke_chain(tiny_clis, small_gate_trees,  # noqa: F811
                                 tmp_path, capsys, monkeypatch):
    monkeypatch.setattr(gates, "REPO", str(tmp_path))
    argv = ["convergence", "--smoke", "--device", "cpu", "--workdir",
            str(tmp_path / "cv"), "--layers", "1,1,1,1", "--lr", "0.001"]
    gates.main(argv)
    out = capsys.readouterr().out
    lines = _lines(out)
    assert [line["stage"] for line in lines] == ["convergence_train",
                                                 "convergence_eval"]
    smoke = str(tmp_path / "cv_smoke")
    ckpt = os.path.join(smoke, "ckpt")
    _, meta = _common.load_seg_checkpoint(os.path.join(
        ckpt, "convergence_gate.pth"))
    assert [int(x) for x in meta["layers"]] == [1, 1, 1, 1]
    # the eval CLI at the gate's own arguments (its default batch)
    cli_iu = segmentation_evaluate.main([
        "-dataset", "freiburg_ir", "--freiburg_root",
        os.path.join(smoke, "datasets", "freiburg"), "-checkpoint_name",
        "convergence_gate.pth", "--model_root_path", ckpt, "--device",
        "cpu"])[0]
    assert lines[1]["miou"] == round(float(cli_iu), 4)
    result = json.loads(out.strip().splitlines()[-1])
    assert result["smoke"] and result["lr"] == 0.001
    assert result["train_sec"] == result["stage_sec"]["convergence_train"]
    # a second run in the same directory reuses the trained checkpoint
    gates.main(argv)
    out = capsys.readouterr().out
    again = _lines(out)
    assert again[0] == {**again[0], "stage": "convergence_train",
                        "reused": True}
    assert again[1]["miou"] == lines[1]["miou"]
    assert json.loads(out.strip().splitlines()[-1])["train_sec"] is None
    # other options in the same directory: the training runs again, and
    # the checkpoint and the JSON carry the new width
    gates.main([*argv[:-4], "--layers", "1,1,2,1", "--lr", "0.001"])
    out = capsys.readouterr().out
    wider = _lines(out)
    assert "reused" not in wider[0]
    result = json.loads(out.strip().splitlines()[-1])
    assert result["layers"] == "1,1,2,1" and result["train_sec"] > 0
    _, meta = _common.load_seg_checkpoint(os.path.join(
        ckpt, "convergence_gate.pth"))
    assert [int(x) for x in meta["layers"]] == [1, 1, 2, 1]
    assert not glob.glob(str(tmp_path / "*.json"))


@pytest.mark.parametrize("gate", ["gan", "pipeline", "selftrain"])
@pytest.mark.parametrize("option", ["--epochs", "--layers", "--lr"])
def test_convergence_options_are_refused_for_other_gates(gate, option,
                                                         tmp_path, capsys):
    with pytest.raises(SystemExit) as exc:
        gates.main([gate, "--device", "cpu", "--workdir",
                    str(tmp_path / "w"), option, "1"])
    assert exc.value.code == 2
    assert "the convergence gate's options" in capsys.readouterr().err
    assert not os.path.exists(tmp_path / "w")
