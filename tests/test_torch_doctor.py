"""The port's doctor (``cli/doctor.py``): the cases of the JAX package's
``tests/test_doctor.py`` with ``--check_backend false``, against the port's
datasets and checkpoint loader and its own recipe copy; the same report
lines and exit status as the JAX doctor on the same trees. Also the backend
probe on a host without a card."""

import os
import shutil

import pytest

torch = pytest.importorskip("torch")

from tests.synthetic import make_freiburg_tree  # noqa: E402
from thermal_semantic_segmentation_torch.cli import doctor  # noqa: E402
from thermal_semantic_segmentation_torch.models.deeplab import (  # noqa: E402
    create_deeplab)
from thermal_semantic_segmentation_tpu.cli import (  # noqa: E402
    doctor as jax_doctor)


def _check_lines(out):
    """The PASS/WARN/FAIL lines' status and subject, without details."""
    return [line.split(" — ")[0] for line in out.splitlines()
            if line.strip().startswith(("PASS", "WARN", "FAIL"))]


def _both(argv, capsys):
    """(port rc, port output, JAX rc, JAX output) for the same argv."""
    rc = doctor.main(argv)
    out = capsys.readouterr().out
    jax_rc = jax_doctor.main(argv)
    jax_out = capsys.readouterr().out
    return rc, out, jax_rc, jax_out


def test_doctor_passes_on_healthy_tree(tmp_path, capsys):
    root = make_freiburg_tree(str(tmp_path / "freiburg"), n_train=2, n_test=1,
                              translation_name="translation")
    ckpt_dir = tmp_path / "ckpt"
    ckpt_dir.mkdir()
    torch.save({"epoch": 0, "sem_net_state_dict": create_deeplab(
        0, device="cpu", layers=(1, 1, 1, 1)).state_dict()},
        str(ckpt_dir / "s.pth"))
    rc = doctor.main(["--freiburg_root", root, "--model_root_path",
                      str(ckpt_dir), "-checkpoint_name", "s.pth",
                      "-translation_name", "translation",
                      "--check_backend", "false"])
    out = capsys.readouterr().out
    assert rc == 0 and "doctor: ok" in out
    assert "PASS  freiburg train IR" in out
    assert "PASS  seg checkpoint" in out and "'layers': [1, 1, 1, 1]" in out
    assert "PASS  translated source (translation)" in out
    assert "PASS  PNG reader" in out and "png_unfilter" in out
    assert "compile cache" not in out


def test_doctor_fails_on_broken_tree(tmp_path, capsys):
    root = make_freiburg_tree(str(tmp_path / "freiburg"), n_train=2, n_test=1)
    shutil.rmtree(os.path.join(root, "train", "seq_00_day", "00",
                               "fl_rgb_labels"))
    rc, out, jax_rc, jax_out = _both(
        ["--freiburg_root", root, "--check_backend", "false"], capsys)
    assert rc == jax_rc == 1 and "doctor: FAIL" in out
    # the port's PNG reader line has no JAX counterpart
    assert [line for line in _check_lines(out)
            if "native" not in line and "PNG reader" not in line] == [
        line for line in _check_lines(jax_out)
        if "native" not in line and "compile cache" not in line]


def test_doctor_grammar_audit_and_recipe(tmp_path, capsys, monkeypatch):
    """The audit names the broken sibling, and a ready tree gets the launch
    command of the port's own recipe copy (MIN_MIOU=0.52, reference
    self_train_main.py:53), with the cd a tree outside ./datasets needs."""
    parent = tmp_path / "mnt"
    root = make_freiburg_tree(str(parent / "datasets" / "freiburg"),
                              n_train=3, n_test=1)
    rc = doctor.main(["--freiburg_root", root, "--check_backend", "false"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "grammar: train IR (day)" in out and "3 frames" in out
    assert "recipe: tree is ready" in out
    import thermal_semantic_segmentation_torch as pkg
    script = os.path.join(os.path.dirname(os.path.abspath(pkg.__file__)),
                          "recipes", "full_pipeline.sh")
    assert os.path.isfile(script) and os.access(script, os.X_OK)
    assert f"MIN_MIOU=0.52 {script}" in out
    assert f"cd {parent} && " in out

    os.remove(os.path.join(root, "train", "seq_00_day", "00",
                           "fl_rgb_labels", "0001.png"))
    rc = doctor.main(["--freiburg_root", root, "--check_backend", "false"])
    out = capsys.readouterr().out
    assert rc == 1
    assert "1/3 label siblings missing" in out
    assert "fl_rgb_labels/0001.png" in out.replace(os.sep, "/")
    assert "recipe: tree NOT ready" in out


def test_doctor_recipe_paths_are_separator_safe(tmp_path, capsys):
    root = make_freiburg_tree(str(tmp_path / "thermal-datasets" / "freiburg"),
                              n_train=2, n_test=1)
    im_dir = os.path.join(root, "test", "day", "ImagesIR")
    lab_dir = os.path.join(root, "test", "day", "SegmentationClass")
    for d in (im_dir, lab_dir):
        os.makedirs(os.path.join(d, "seq_extra"), exist_ok=True)
        for f in sorted(os.listdir(d)):
            if os.path.isfile(os.path.join(d, f)):
                shutil.move(os.path.join(d, f),
                            os.path.join(d, "seq_extra", f))
    rc = doctor.main(["--freiburg_root", root, "--check_backend", "false"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "grammar: test IR (day)" in out
    launch = next(line for line in out.splitlines()
                  if "MIN_MIOU=0.52" in line)
    assert "cd " not in launch
    assert f"ln -s {root} datasets/freiburg" in out


def test_doctor_warns_on_missing_root(tmp_path, capsys):
    rc, out, jax_rc, jax_out = _both(
        ["--freiburg_root", str(tmp_path / "nope"), "--check_backend",
         "false"], capsys)
    assert rc == jax_rc == 0
    assert "WARN  freiburg root" in out
    assert "recipe" not in out


def test_doctor_backend_check_fails_without_a_card(tmp_path, capsys):
    """The probe runs in a subprocess and reports the missing card as a
    FAIL with its reason (exit status 1)."""
    rc = doctor.main(["--freiburg_root", str(tmp_path / "nope")])
    out = capsys.readouterr().out
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the probe passes here")
    assert rc == 1
    assert "FAIL  backend" in out and "is_available() is false" in out


def test_recipe_copy_runs_the_port():
    """The package's recipe copy drives the port's CLIs and gates with its
    own assert_miou.py, which parses the port's eval line."""
    import importlib.util
    import thermal_semantic_segmentation_torch as pkg
    rdir = os.path.join(os.path.dirname(pkg.__file__), "recipes")
    text = open(os.path.join(rdir, "full_pipeline.sh")).read()
    assert "thermal_semantic_segmentation_torch.cli.${mod}" in text
    assert '"${HERE}/assert_miou.py"' in text
    spec = importlib.util.spec_from_file_location(
        "assert_miou", os.path.join(rdir, "assert_miou.py"))
    gate = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gate)
    assert gate.parse_miou("mean iou score: [0.5312]. val_loss: [0.4]") == \
        0.5312
    with pytest.raises(ValueError):
        gate.parse_miou("no score here")
