"""The port's train CLI (cli/segmentation_train.py, cli/options.seg_parse,
cli/_common.save_seg_checkpoint) against the JAX CLI, on a synthetic
Freiburg tree and a synthetic translated-Cityscapes tree, from one
reference ``.pth`` of a tiny DeepLabV2 (layers 1,1,1,1) that both load with
``-load_model true``.

Both run ``-epochs 2 -batch_size 2 -val_batch_size 1 -max_steps 3`` with
dropout off (the JAX CLI inside a flax interceptor, the port with the ASPP
head's dropout rate at 0), each from a working directory of its own
(``logs/`` is relative). Batch 1 keeps the JAX package's padded-tail mIoU
fault (ROADMAP.md §3) out of the comparison. Tolerances: each epoch's
source-val loss within rtol 1e-5 (6 Adam steps from the same weights,
whose float noise moves a few parameters by about lr); the saved
parameters inside the 6 x lr envelope of the JAX run's but for an outlier
count, as in tests/test_torch_train.py.
"""

import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import flax.linen as fnn  # noqa: E402
import jax  # noqa: E402

from tests.synthetic import (make_cityscapes_tree,  # noqa: E402
                             make_freiburg_tree)
from tests.test_torch_deeplab import jax_deeplab_with_twin  # noqa: E402
from tests.test_torch_train import no_dropout  # noqa: E402
from thermal_semantic_segmentation_tpu.cli import (  # noqa: E402
    _common as jax_common, segmentation_train as jax_cli)
from thermal_semantic_segmentation_torch.cli import (  # noqa: E402
    _common, segmentation_train)
from thermal_semantic_segmentation_torch.cli.options import (  # noqa: E402
    seg_parse)
from thermal_semantic_segmentation_torch.nn import aspp  # noqa: E402

LR = 1e-4                  # the CLI's default -lr
STEPS = 2 * 3              # epochs x max_steps
VAL_LOSS_RTOL = 1e-5



@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    """Two intra-op threads: the suite runs several test processes on a
    few cores, where more threads only wait on each other."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """A Freiburg tree (10 train frames: 8 train, 2 val; 2 test frames for
    the target split), a translated-Cityscapes tree of 10 frames, made
    single-channel as the RGB-to-thermal translator writes them, and the
    start checkpoint in the reference schema."""
    from PIL import Image

    base = tmp_path_factory.mktemp("train_cli")
    fr = make_freiburg_tree(str(base / "fr"), n_train=10, n_test=2)
    cs = make_cityscapes_tree(str(base / "cs"), n=10,
                              data_folder="translation")
    for dirpath, _, files in os.walk(os.path.join(cs, "translation")):
        for name in files:
            path = os.path.join(dirpath, name)
            Image.open(path).convert("L").save(path)
    _, _, twin = jax_deeplab_with_twin(6)
    start = str(base / "start.pth")
    torch.save({"epoch": -1, "sem_net_state_dict": twin.state_dict()}, start)
    return fr, cs, start


def _argv(trees, dataset, root):
    fr, cs, start = trees
    os.makedirs(root, exist_ok=True)
    shutil.copy(start, os.path.join(root, "start.pth"))
    return ["-dataset", dataset, "--freiburg_root", fr, "--source_root", cs,
            "-epochs", "2", "-batch_size", "2", "-val_batch_size", "1",
            "-max_steps", "3", "--layers", "1,1,1,1", "-load_model", "true",
            "-checkpoint_name", "start.pth", "-new_checkpoint_name", "s.pth",
            "--model_root_path", root]


@pytest.mark.parametrize("dataset", ["freiburg_ir", "cityscapes_translation"])
def test_train_cli_matches_jax_cli(trees, dataset, tmp_path, monkeypatch,
                                   capsys):
    want_val = []
    jax_validate = jax_cli.seg_validate

    def recording_validate(*args, **kwargs):
        scores = jax_validate(*args, **kwargs)
        want_val.append(scores)
        return scores

    monkeypatch.setattr(jax_cli, "seg_validate", recording_validate)
    monkeypatch.chdir(tmp_path)
    with fnn.intercept_methods(no_dropout):
        jax_cli.main(_argv(trees, dataset, str(tmp_path / "jax")))
    capsys.readouterr()

    monkeypatch.setattr(aspp, "DROPRATE", 0.0)
    port_root = str(tmp_path / "port")
    state, history = segmentation_train.main(
        _argv(trees, dataset, port_root) + ["--device", "cpu"])
    out = capsys.readouterr().out
    assert state.step == STEPS
    assert [h["epoch"] for h in history] == [0, 1]
    assert [h["train_images"] for h in history] == [6, 6]
    assert out.count("--------START TRAINING [EPOCH: ") == 2
    assert "val loss reduced from inf to " in out
    assert out.count("target test dataset mean iou score: ") == 2
    assert os.path.exists(tmp_path / "logs" / "s" / "metrics.jsonl")

    # JAX validates source val, then the target test split, each epoch
    got = [h["val_loss"] for h in history]
    want = [want_val[0][1], want_val[2][1]]
    print(f"{dataset}: val_loss port {got} JAX {want}")
    np.testing.assert_allclose(got, want, rtol=VAL_LOSS_RTOL)

    # the port's .pth in the JAX package's loader, against the JAX run's
    saved, meta = jax_common.load_seg_checkpoint(
        os.path.join(port_root, "s.pth"))
    theirs, their_meta = jax_common.load_seg_checkpoint(
        str(tmp_path / "jax" / "s.pth"))
    assert set(meta) == {"epoch", "val_loss"}
    assert int(meta["epoch"]) == int(their_meta["epoch"])
    assert float(meta["val_loss"]) == min(got)
    worst, outside, total = 0.0, 0, 0
    for g, w in zip(jax.tree.leaves(saved["params"]),
                    jax.tree.leaves(theirs["params"])):
        ratio = np.abs(np.asarray(g) - np.asarray(w)) / (STEPS * LR)
        worst = max(worst, float(ratio.max()))
        outside += int((ratio > 1.0).sum())
        total += ratio.size
    print(f"{dataset}: {outside} of {total} parameters outside the "
          f"{STEPS} x lr envelope, worst {worst:.3f} of it")
    assert outside <= 1e-4 * total and worst <= 2.0
    assert jax.tree.structure(saved["batch_stats"]) == jax.tree.structure(
        theirs["batch_stats"])

    # the port's loader reads it back as the model's state_dict
    sd, arch = _common.load_seg_checkpoint(os.path.join(port_root, "s.pth"))
    args = seg_parse().parse_args(_argv(trees, dataset, port_root))
    assert {k: arch[k] for k in _common.model_meta(args)} == \
        _common.model_meta(args)
    if history[1]["saved"]:
        for k, v in state.model.state_dict().items():
            assert torch.equal(sd[k], v), k


def test_train_cli_resumes_from_its_checkpoint(trees, tmp_path, monkeypatch,
                                               capsys):
    """-load_model true continues at the saved epoch + 1 with the saved
    val_loss as the one to beat."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(aspp, "DROPRATE", 0.0)
    root = str(tmp_path / "ck")
    argv = _argv(trees, "freiburg_ir", root) + ["--device", "cpu"]
    argv[argv.index("-max_steps") + 1] = "1"
    argv[argv.index("-epochs") + 1] = "1"
    segmentation_train.main(argv)
    first = torch.load(os.path.join(root, "s.pth"), weights_only=True)
    assert set(first) == {"epoch", "sem_net_state_dict", "val_loss"}
    assert first["epoch"] == 0
    capsys.readouterr()

    argv[argv.index("-checkpoint_name") + 1] = "s.pth"
    _, history = segmentation_train.main(argv)
    out = capsys.readouterr().out
    assert "--------START TRAINING [EPOCH: 1]--------" in out
    assert [h["epoch"] for h in history] == [1]
    if history[0]["saved"]:
        assert (f"val loss reduced from {first['val_loss']} to "
                f"{history[0]['val_loss']}! Saving...") in out
    else:
        assert history[0]["val_loss"] >= first["val_loss"]
        assert "Model not improved." in out
