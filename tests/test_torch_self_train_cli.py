"""The port's self-training CLI (cli/self_train_main.py,
cli/options.self_train_parse, cli/_common.save_seg_checkpoint's self-train
keys) against the JAX CLI, on one synthetic Freiburg tree with translated
source frames, from the pseudo-labels and prototypes the port's own
pseudo-label and prototype CLIs wrote for one tiny reference ``.pth``.

Both CLIs run ``--epochs 1 -max_steps 2 --val_interval 1 -batch_size 2``
(a validation after each step) with dropout off and the transforms shrunk
to 64x128, as tests/test_cli_chain.py shrinks them (the JAX CLI on its
one-device mesh). The test split has 2 frames, which the batch divides, so
the JAX package's padded-tail fault (ROADMAP.md §3) stays out of it.
Tolerances: each validation's mean_iu 1e-6, val_loss rtol 1e-5; the saved
moving prototypes 5e-4, ``highest_mean_iu`` 1e-6. A resume reads the
prototypes and the best mean_iu back, from the port's own ``last`` file
and from the JAX CLI's msgpack one.
"""

import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import flax.linen as fnn  # noqa: E402
import jax  # noqa: E402

from tests.synthetic import make_freiburg_tree  # noqa: E402
from tests.test_torch_deeplab import jax_deeplab_with_twin  # noqa: E402
from tests.test_torch_isolation import one_process_group  # noqa: E402,F401
from tests.test_torch_pseudo_proto_cli import _tiny  # noqa: E402
from tests.test_torch_train import no_dropout  # noqa: E402
from thermal_semantic_segmentation_tpu.cli import (  # noqa: E402
    _common as jax_common, self_train_main as jax_st)
from thermal_semantic_segmentation_tpu.data import (  # noqa: E402
    transforms as JT)
from thermal_semantic_segmentation_torch.cli import (  # noqa: E402
    _common, cal_prototype, generate_pseudo_label, self_train_main)
from thermal_semantic_segmentation_torch.data import (  # noqa: E402
    transforms as T)
from thermal_semantic_segmentation_torch.nn import aspp  # noqa: E402

MEAN_IU_ATOL, VAL_LOSS_RTOL, PROTO_ATOL = 1e-6, 1e-5, 5e-4
# a step and a prototype fold large enough that an argument the epoch loop
# passes wrongly to the step shows in the validations and the prototypes
MOVING = ("--lr", "1e-3", "--proto_momentum", "0.5")


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    """Two intra-op threads: the suite runs several test processes on a
    few cores, where more threads only wait on each other."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _tiny_val(transforms):
    return lambda: transforms.Compose([transforms.Resize((128, 64)),
                                       transforms.ToArray()])


def _tiny_train(transforms):
    return lambda: transforms.Compose([
        transforms.RandomResizedCrop(size=(64, 128), ratio=(1.5, 8 / 3.),
                                     scale=(0.5, 1.0)),
        transforms.RandomHorizontalFlip(), transforms.ToArray()])


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The tree, the start checkpoint and the port's pseudo-labels and
    prototypes for it."""
    root = tmp_path_factory.mktemp("st_cli")
    tree = make_freiburg_tree(str(root / "freiburg"), n_train=4, n_test=2,
                              translation_name="translation")
    _, _, twin = jax_deeplab_with_twin(14)
    start = root / "src.pth"
    torch.save({"epoch": 0, "sem_net_state_dict": twin.state_dict()},
               str(start))
    common = ["--freiburg_root", tree, "--model_root_path", str(root),
              "-checkpoint_name", "src.pth", "--device", "cpu"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(generate_pseudo_label, "val_transform", _tiny_val(T))
        mp.setattr(cal_prototype, "T", _tiny(T))
        for flags in (["-pseudo_type", "soft", "--soft", "true"],
                      ["-pseudo_type", "hard"]):
            generate_pseudo_label.main(["--root", str(root), "-batch_size",
                                        "2", *flags, *common])
        cal_prototype.main(["-root", str(root), "-epochs", "1",
                            "-batch_size", "2", *common])
    return dict(root=str(root), tree=tree, start=str(start))


def _argv(world, name: str, ckpt_dir: str, *extra):
    os.makedirs(ckpt_dir, exist_ok=True)
    if not os.path.exists(os.path.join(ckpt_dir, "src.pth")):
        shutil.copy(world["start"], ckpt_dir)
    return ["--root", world["root"], "--freiburg_root", world["tree"],
            "--model_root_path", ckpt_dir, "-checkpoint_name", "src.pth",
            "-new_checkpoint_name", name, "-translation_name", "translation",
            "--epochs", "1", "-max_steps", "2", "--val_interval", "1",
            "--resize", "128", "--rcrop", "128", "64", "-batch_size", "2",
            "--layers", "1,1,1,1", *extra]


@pytest.fixture
def tiny_port(monkeypatch, tmp_path):
    monkeypatch.chdir(tmp_path)          # logs/ is relative
    monkeypatch.setattr(self_train_main, "val_transform", _tiny_val(T))
    monkeypatch.setattr(self_train_main, "train_transform", _tiny_train(T))
    monkeypatch.setattr(aspp, "DROPRATE", 0.0)


def test_self_train_cli_matches_jax_cli(world, tiny_port, tmp_path,
                                        monkeypatch, capsys):
    import thermal_semantic_segmentation_tpu.parallel.mesh as pmesh

    want_val = []
    jax_validate = jax_st.seg_validate

    def recording_validate(*args, **kwargs):
        scores = jax_validate(*args, **kwargs)
        want_val.append(scores)
        return scores

    monkeypatch.setattr(jax_st, "seg_validate", recording_validate)
    monkeypatch.setattr(pmesh, "make_mesh", lambda *a, **k: pmesh.Mesh(
        np.asarray(jax.devices()[:1]), ("data",)))
    monkeypatch.setattr(jax_st, "val_transform", _tiny_val(JT))
    monkeypatch.setattr(jax_st, "train_transform", _tiny_train(JT))
    jax_dir = str(tmp_path / "jax")
    with fnn.intercept_methods(no_dropout):
        jax_st.main(_argv(world, "jax.pth", jax_dir, *MOVING))
    capsys.readouterr()

    port_dir = str(tmp_path / "port")
    state, history = self_train_main.main(
        _argv(world, "port.pth", port_dir, *MOVING, "--device", "cpu"))
    out = capsys.readouterr().out
    assert state.step == 2 and len(history) == 1
    record = history[0]
    assert record["epoch"] == 1 and record["steps"] == 2
    assert record["target_images"] == 4 and len(record["losses"]) == 2
    assert all(np.isfinite(record["losses"]).ravel())
    assert out.count("target test dataset mean iou score: ") == 2

    got = [(v["mean_iu"], v["val_loss"]) for v in record["validations"]]
    want = [(float(m), float(v)) for m, v, _ in want_val]
    print(f"port (mean_iu, val_loss) {got}, JAX {want}")
    assert len(got) == len(want) == 2
    np.testing.assert_allclose([g[0] for g in got], [w[0] for w in want],
                               rtol=0, atol=MEAN_IU_ATOL)
    np.testing.assert_allclose([g[1] for g in got], [w[1] for w in want],
                               rtol=VAL_LOSS_RTOL)

    # the port's checkpoints beside the JAX CLI's, each read by the other
    # package's loader too
    best = max(w[0] for w in want)
    for tag in ("best", "last"):
        sd, meta = _common.load_seg_checkpoint(
            os.path.join(port_dir, tag + "port.pth"))
        _, their_meta = _common.load_seg_checkpoint(
            os.path.join(jax_dir, tag + "jax.pth"))
        _, meta_in_jax = jax_common.load_seg_checkpoint(
            os.path.join(port_dir, tag + "port.pth"))
        assert {"epoch", "highest_mean_iu", "objective_vectors"} <= set(meta)
        assert "val_loss" not in meta
        assert int(meta["epoch"]) == int(their_meta["epoch"]) == 1
        np.testing.assert_allclose(float(meta["highest_mean_iu"]), best,
                                   rtol=0, atol=MEAN_IU_ATOL)
        np.testing.assert_allclose(
            np.asarray(meta["objective_vectors"]),
            np.asarray(their_meta["objective_vectors"]), rtol=0,
            atol=PROTO_ATOL)
        np.testing.assert_array_equal(
            np.asarray(meta_in_jax["objective_vectors"]),
            meta["objective_vectors"].numpy())
    for k, v in state.model.state_dict().items():
        assert torch.equal(sd[k], v), k
    assert sorted(os.listdir(os.path.join(world["root"], "predictions",
                                          "port"))) == [
        "0_groundtruth.png", "0_image.png", "0_prediction_0.png",
        "0_prediction_1.png"]


@pytest.mark.parametrize("source", ["port", "jax"])
def test_self_train_cli_resumes_with_its_prototypes(world, tiny_port,
                                                    tmp_path, source):
    """A resume from a self-training checkpoint (the port's .pth or the
    JAX CLI's msgpack file) takes its moving prototypes and best mean_iu,
    not the offline prototype file, and continues at its epoch + 1."""
    ckpt_dir = str(tmp_path / "ck")
    if source == "port":
        self_train_main.main(_argv(world, "a.pth", ckpt_dir, "-max_steps",
                                   "1", "--device", "cpu"))
    else:
        _, variables, _ = jax_deeplab_with_twin(14)
        os.makedirs(ckpt_dir)
        protos = np.random.default_rng(5).random((13, 256)).astype(
            np.float32)
        jax_common.save_seg_checkpoint(
            os.path.join(ckpt_dir, "lasta.pth"), variables, epoch=3,
            highest_mean_iu=0.75, objective_vectors=protos,
            layers=[1, 1, 1, 1], num_channels=1, num_classes=13)
    _, saved = _common.load_seg_checkpoint(os.path.join(ckpt_dir,
                                                        "lasta.pth"))
    pl = os.path.join(world["root"], "pseudo_labels")
    argv = _argv(world, "b.pth", ckpt_dir, "-max_steps", "1",
                 "--moving_prototype", "false", "--path_soft",
                 os.path.join(pl, "soft", "src"), "--path_lp",
                 os.path.join(pl, "hard", "src"), "--device", "cpu")
    argv[argv.index("-checkpoint_name") + 1] = "lasta.pth"
    state, history = self_train_main.main(argv)
    assert history[0]["epoch"] == int(saved["epoch"]) + 1
    assert history[0]["best_at_start"] == float(saved["highest_mean_iu"])
    np.testing.assert_array_equal(state.prototypes.numpy(),
                                  np.asarray(saved["objective_vectors"]))
    assert np.all(state.proto_counts.numpy() == 0)


def test_self_train_cli_preempts_to_a_resumable_checkpoint(
        world, tiny_port, tmp_path, monkeypatch):
    """A shutdown requested after the first step: the loop stops, writes
    ``preempt_p.pth`` (the moving prototypes included) with the epoch
    before the interrupted one and not ``lastp.pth``; a resume from it
    redoes that epoch."""
    from tests.test_torch_preempt import StopAfter
    monkeypatch.setattr(self_train_main, "GracefulShutdown", StopAfter)
    ckpt_dir = str(tmp_path / "ck")
    _, history = self_train_main.main(_argv(world, "p.pth", ckpt_dir,
                                            "--device", "cpu"))
    epoch = history[0]["epoch"]       # the start checkpoint's epoch + 1
    assert [(h["steps"], h["preempted"]) for h in history] == [(1, True)]
    _, meta = _common.load_seg_checkpoint(os.path.join(ckpt_dir,
                                                       "preempt_p.pth"))
    assert meta["epoch"] == epoch - 1 and "objective_vectors" in meta
    assert not os.path.exists(os.path.join(ckpt_dir, "lastp.pth"))
    pl = os.path.join(world["root"], "pseudo_labels")
    argv = _argv(world, "q.pth", ckpt_dir, "--device", "cpu", "--path_soft",
                 os.path.join(pl, "soft", "src"), "--path_lp",
                 os.path.join(pl, "hard", "src"))
    argv[argv.index("-checkpoint_name") + 1] = "preempt_p.pth"
    monkeypatch.setattr(self_train_main, "GracefulShutdown",
                        lambda: StopAfter(after=10 ** 6))
    _, history = self_train_main.main(argv)
    assert [(h["epoch"], h["preempted"]) for h in history] == [
        (epoch, False)]
    assert os.path.exists(os.path.join(ckpt_dir, "lastq.pth"))


def test_self_train_cli_refuses_a_missing_prototype_file(world, tiny_port,
                                                         tmp_path):
    argv = _argv(world, "c.pth", str(tmp_path / "ck"), "--device", "cpu")
    argv[argv.index("--root") + 1] = str(tmp_path)
    with pytest.raises(FileNotFoundError):
        self_train_main.main(argv)


@pytest.mark.parametrize("flag", ["distributed", "data_parallel"])
def test_self_train_cli_accepts_multi_device_flags(world, tiny_port,
                                                   tmp_path, monkeypatch,
                                                   one_process_group, flag):
    """``--distributed true`` as one gloo process, and ``--data_parallel
    true`` validating over two CPU replicas: the one-device run's losses
    and validations (mean_iu exactly, val_loss rtol 1e-6) and weights.
    (Two processes: tests/test_torch_dist_train.py.)"""
    from thermal_semantic_segmentation_torch.parallel import mesh as pmesh
    monkeypatch.setattr(pmesh, "default_devices",
                        lambda: [torch.device("cpu")] * 2)
    runs = {}
    for name, extra in (("one", []), ("flag", one_process_group
                                      if flag == "distributed"
                                      else ["--data_parallel", "true"])):
        runs[name] = self_train_main.main(_argv(
            world, f"{name}.pth", str(tmp_path / name), "--device", "cpu",
            *extra))
    (want_state, want), (got_state, got) = runs["one"], runs["flag"]
    assert pmesh.process_count() == 1
    assert got[0]["losses"] == want[0]["losses"]
    for g, w in zip(got[0]["validations"], want[0]["validations"]):
        assert g["mean_iu"] == w["mean_iu"] and g["saved"] == w["saved"]
        np.testing.assert_allclose(g["val_loss"], w["val_loss"], rtol=1e-6)
    for k, v in want_state.model.state_dict().items():
        assert torch.equal(got_state.model.state_dict()[k], v), k
