"""The port's pseudo-label and prototype CLIs (cli/generate_pseudo_label.py,
cli/cal_prototype.py, cli/options.py, data/simple.py) against the JAX CLIs
on one synthetic Freiburg tree, from one set of weights saved both as a
reference ``.pth`` and as a JAX msgpack checkpoint.

The JAX CLIs run once, from the ``.pth``; the port's from each checkpoint.
The same files under the same tree: hard ids equal outside near-ties,
confidences within one float16 ulp, soft maps within 5e-4; prototypes within
5e-4 and counts exact, and each package's prototype file read by the other's
``load_checkpoint`` into the arrays its CLI computed. The transforms shrink
to 64x128 in both packages, as tests/test_cli_chain.py shrinks them.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from PIL import Image  # noqa: E402

from tests.synthetic import make_freiburg_tree  # noqa: E402
from tests.test_torch_deeplab import jax_deeplab_with_twin  # noqa: E402
from tests.test_torch_pseudo import (assert_pseudo_dirs_match,  # noqa: E402
                                     decided_pixels)
from thermal_semantic_segmentation_tpu.cli import (  # noqa: E402
    _common as jax_common, cal_prototype as jax_cp,
    generate_pseudo_label as jax_gp)
from thermal_semantic_segmentation_tpu.core.checkpoint import (  # noqa: E402
    load_checkpoint as jax_load_checkpoint)
from thermal_semantic_segmentation_tpu.data import (  # noqa: E402
    list_files as jax_list_files, simple as jax_simple,
    transforms as JT)
from thermal_semantic_segmentation_torch.cli import (  # noqa: E402
    cal_prototype, generate_pseudo_label)
from thermal_semantic_segmentation_torch.core.checkpoint import (  # noqa: E402
    load_checkpoint)
from thermal_semantic_segmentation_torch.data import (  # noqa: E402
    list_files, simple, transforms as T)
from thermal_semantic_segmentation_torch.data.loader import (  # noqa: E402
    DataLoader)

N_TRAIN = 5           # batch 4 leaves a tail of 1; batch 2 drops one
MODES = {"hard": ["--soft", "false"], "soft": ["--soft", "true"],
         "hard_flip": ["--soft", "false", "--flip", "true"]}
CHECKPOINTS = ("tiny.pth", "native.ckpt")


def _tiny(transforms):
    """``transforms`` with Resize((512, 256)) shrunk to 64x128."""
    class Tiny:
        def __getattr__(self, name):
            return getattr(transforms, name)

        @staticmethod
        def Resize(size):
            return transforms.Resize((128, 64))
    return Tiny()


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The tree, both checkpoints and the JAX CLIs' artifacts."""
    root = tmp_path_factory.mktemp("world")
    tree = make_freiburg_tree(str(root / "freiburg"), n_train=N_TRAIN,
                              n_test=0)
    model, variables, twin = jax_deeplab_with_twin(13)
    ckpt = root / "ckpt"
    ckpt.mkdir()
    torch.save({"epoch": 0, "sem_net_state_dict": twin.state_dict()},
               str(ckpt / "tiny.pth"))
    jax_common.save_seg_checkpoint(str(ckpt / "native.ckpt"), variables,
                                   epoch=0, layers=[1, 1, 1, 1],
                                   num_channels=1, num_classes=13)
    jax_root = root / "jax"
    common = ["--freiburg_root", tree, "--model_root_path", str(ckpt),
              "-checkpoint_name", "tiny.pth", "--layers", "1,1,1,1"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_gp, "val_transform",
                   lambda: JT.Compose([JT.Resize((128, 64)), JT.ToArray()]))
        mp.setattr(jax_cp, "T", _tiny(JT))
        for ptype, flags in MODES.items():
            jax_gp.main(["--root", str(jax_root), "-pseudo_type", ptype,
                         "-batch_size", "4", *flags, *common])
        protos = jax_cp.calc_prototype(jax_cp.calc_proto_parse().parse_args(
            ["-root", str(jax_root), "-epochs", "2", "-batch_size", "2",
             *common]))
    images = [b for b in DataLoader(
        jax_common.build_seg_dataset(
            jax_gp.pseudo_generation_parse().parse_args(
                ["--freiburg_root", tree]),
            JT.Compose([JT.Resize((128, 64)), JT.ToArray()])), 5,
        drop_last=False)]
    return dict(tree=tree, ckpt=str(ckpt), jax_root=jax_root, model=model,
                variables=variables, images=images, jax_protos=protos)


@pytest.fixture
def tiny_port_transforms(monkeypatch):
    monkeypatch.setattr(generate_pseudo_label, "val_transform",
                        lambda: T.Compose([T.Resize((128, 64)),
                                           T.ToArray()]))
    monkeypatch.setattr(cal_prototype, "T", _tiny(T))


def _common(world, checkpoint):
    return ["--freiburg_root", world["tree"], "--model_root_path",
            world["ckpt"], "-checkpoint_name", checkpoint, "--device", "cpu"]


@pytest.mark.parametrize("checkpoint", CHECKPOINTS)
@pytest.mark.parametrize("ptype", list(MODES))
def test_pseudo_label_cli_matches_jax(world, tiny_port_transforms, tmp_path,
                                      capsys, checkpoint, ptype):
    n = generate_pseudo_label.main(
        ["--root", str(tmp_path), "-pseudo_type", ptype, "-batch_size", "4",
         *MODES[ptype], *_common(world, checkpoint)])
    save_path = os.path.join(str(tmp_path), "pseudo_labels", ptype,
                             checkpoint.replace(".pth", ""))
    assert n == N_TRAIN
    assert capsys.readouterr().out.splitlines()[-1] == (
        f"wrote pseudo labels for {N_TRAIN} images to {save_path}")
    assert os.listdir(tmp_path) == ["pseudo_labels"]
    decided = decided_pixels(world["model"], world["variables"],
                             world["images"], ptype == "hard_flip")
    assert sorted(decided) == [f"{i:04d}.png" for i in range(N_TRAIN)]
    assert_pseudo_dirs_match(
        tmp_path / "pseudo_labels" / ptype / checkpoint.replace(".pth", ""),
        world["jax_root"] / "pseudo_labels" / ptype / "tiny", decided,
        ptype == "soft")


@pytest.mark.parametrize("checkpoint", CHECKPOINTS)
def test_prototype_cli_matches_jax(world, tiny_port_transforms, tmp_path,
                                   checkpoint):
    protos, counts = cal_prototype.main(
        ["-root", str(tmp_path), "-epochs", "2", "-batch_size", "2",
         *_common(world, checkpoint)])
    stem = checkpoint.replace(".pth", "")
    port_file = tmp_path / "prototypes" / f"prototypes_on_freiburg_ir_from_{stem}"
    jax_file = (world["jax_root"] / "prototypes"
                / "prototypes_on_freiburg_ir_from_tiny")
    assert os.listdir(tmp_path / "prototypes") == [port_file.name]
    # the port's file, read by the JAX package: the arrays the port computed
    from_jax = jax_load_checkpoint(str(port_file))
    assert sorted(from_jax) == ["counts", "objective_vectors"]
    np.testing.assert_array_equal(from_jax["objective_vectors"], protos)
    np.testing.assert_array_equal(from_jax["counts"], counts)
    # the JAX file, read by the port: the JAX CLI's arrays
    jax_ckpt = load_checkpoint(str(jax_file))
    np.testing.assert_array_equal(jax_ckpt["objective_vectors"],
                                  world["jax_protos"])
    assert protos.shape == (13, 256) and counts.dtype == np.float32
    np.testing.assert_array_equal(counts, jax_ckpt["counts"])
    assert counts.sum() > 0
    np.testing.assert_allclose(protos, jax_ckpt["objective_vectors"], rtol=0,
                               atol=5e-4)


def test_flir_train_matches_jax(tmp_path):
    rng = np.random.default_rng(5)
    root = tmp_path / "flir"
    for i in range(3):
        os.makedirs(root / "train" / f"{i % 2}", exist_ok=True)
        Image.fromarray(rng.integers(0, 256, (30, 50)).astype(np.uint8)).save(
            root / "train" / f"{i % 2}" / f"{i:05d}.jpeg")
    got_list = list_files.flir_list(str(root), "train")
    assert open(got_list).read() == open(
        jax_list_files.flir_list(str(root), "train")).read()
    assert len(open(got_list).read().splitlines()) == 3
    tf = T.Compose([T.Resize((64, 32)), T.ToArray()])
    jtf = JT.Compose([JT.Resize((64, 32)), JT.ToArray()])
    got = simple.FlirTrain(str(root), tf)
    want = jax_simple.FlirTrain(str(root), jtf)
    assert len(got) == len(want) == 3
    for i in range(3):
        g, w = got.get(i, None), want.get(i, None)
        assert g.keys() == w.keys() == {"image"}
        assert g["image"].shape == (32, 64, 1)
        np.testing.assert_array_equal(g["image"], w["image"])


def test_unknown_prototype_dataset_is_refused():
    with pytest.raises(ValueError, match="does not exist"):
        cal_prototype.main(["-dataset", "kitti", "--device", "cpu"])
