"""The port's training data path (data/transforms.py random transforms,
data/list_files.cityscapes_list, data/freiburg.Freiburg,
data/cityscapes.py, cli/_common.train_transform and the train branches of
build_seg_dataset) against the JAX package on synthetic trees.

Every array must be equal, and both generators must stand in the same state
after a transform (the same draws in the same order).
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from PIL import Image  # noqa: E402

from tests.synthetic import (make_cityscapes_tree,  # noqa: E402
                             make_freiburg_tree)
from thermal_semantic_segmentation_tpu.cli import (  # noqa: E402
    _common as jax_common)
from thermal_semantic_segmentation_tpu.core.prng import (  # noqa: E402
    host_rng as jax_host_rng)
from thermal_semantic_segmentation_tpu.data import (  # noqa: E402
    cityscapes as jax_cityscapes, list_files as jax_list_files,
    transforms as jax_T)
from thermal_semantic_segmentation_torch.cli import _common  # noqa: E402
from thermal_semantic_segmentation_torch.cli.options import (  # noqa: E402
    seg_parse)
from thermal_semantic_segmentation_torch.core.prng import (  # noqa: E402
    host_rng)
from thermal_semantic_segmentation_torch.data import (  # noqa: E402
    cityscapes, list_files, transforms as T)

TRANSLATION = "fr_translation"


def _pipelines(mod):
    """name -> a transform of ``mod`` (the port's or the JAX package's)."""
    return {
        "random_crop": mod.RandomCrop((50, 30)),
        "random_crop_larger_than_image": mod.RandomCrop((200, 100)),
        "flip": mod.RandomHorizontalFlip(),
        "flip_always": mod.RandomHorizontalFlip(p=1.0),
        "resized_crop": mod.RandomResizedCrop((32, 64), ratio=(1.5, 8 / 3.),
                                              scale=(0.5, 1.0)),
        # no try can fit: the central-crop fallback
        "resized_crop_fallback": mod.RandomResizedCrop(
            (16, 16), scale=(2.0, 3.0), ratio=(0.2, 0.3)),
        "choice": mod.RandomChoice([mod.RandomHorizontalFlip(p=1.0),
                                    mod.RandomCrop((40, 20)),
                                    mod.Resize((33, 17))]),
        "apply": mod.RandomApply([mod.RandomCrop((60, 30)),
                                  mod.RandomHorizontalFlip()], p=0.5),
        "jitter": mod.ColorJitter(brightness=0.4, contrast=0.3,
                                  saturation=0.2),
        "multiple": mod.MultipleApply([
            mod.Compose([mod.RandomCrop((64, 32)), mod.ToArray()]),
            mod.Compose([mod.RandomHorizontalFlip(), mod.ToArray()])]),
        "normalize": mod.Compose([mod.ToArray(),
                                  mod.Normalize((0.4, 0.5, 0.6),
                                                (0.2, 0.25, 0.3))]),
        "bgr_mean": mod.Compose([mod.ToArray(), mod.BGRMeanSubtract()]),
    }


def _pair(seed: int):
    rng = np.random.default_rng(seed)
    image = Image.fromarray(rng.integers(0, 256, (40, 120, 3)).astype(
        np.uint8))
    label = Image.fromarray(rng.integers(0, 13, (40, 120)).astype(np.uint8),
                            mode="L")
    return image, label


def _arrays(out):
    return [np.asarray(v) for v in (out if isinstance(out, list) else [out])]


@pytest.mark.parametrize("name", sorted(_pipelines(T)))
def test_random_transforms_match_jax(name):
    ours, theirs = _pipelines(T)[name], _pipelines(jax_T)[name]
    for seed in range(12):
        image, label = _pair(seed)
        rng_a, rng_b = host_rng(3, seed), jax_host_rng(3, seed)
        got_img, got_lab = ours(rng_a, image, label)
        want_img, want_lab = theirs(rng_b, image, label)
        for g, w in zip(_arrays(got_img), _arrays(want_img)):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(np.asarray(got_lab),
                                      np.asarray(want_lab))
        assert rng_a.random() == rng_b.random(), "draw order differs"


def test_train_transform_matches_jax():
    ours, theirs = _common.train_transform(), jax_common.train_transform()
    for seed in range(8):
        image, label = _pair(seed)
        g_img, g_lab = ours(host_rng(0, 1, seed), image, label)
        w_img, w_lab = theirs(jax_host_rng(0, 1, seed), image, label)
        assert g_img.shape == (256, 512, 3) and g_img.dtype == np.float32
        np.testing.assert_array_equal(g_img, w_img)
        np.testing.assert_array_equal(np.asarray(g_lab), np.asarray(w_lab))


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    base = tmp_path_factory.mktemp("trees")
    fr = make_freiburg_tree(str(base / "fr"), n_train=4, n_test=2,
                            translation_name=TRANSLATION)
    cs = make_cityscapes_tree(str(base / "cs"), n=3)
    make_cityscapes_tree(str(base / "cs"), n=3, data_folder="translation",
                         seed=2)
    return fr, cs


def _args(trees, dataset, grayscale=False):
    fr, cs = trees
    return seg_parse().parse_args(
        ["-dataset", dataset, "--freiburg_root", fr, "--source_root", cs,
         "-translation_name", TRANSLATION, "-grayscale", str(grayscale)])


@pytest.mark.parametrize("dataset,grayscale", [
    ("freiburg_ir", False), ("freiburg_rgb", False), ("freiburg_rgb", True),
    ("freiburg_translation", False), ("cityscapes", False),
    ("cityscapes_translation", False)])
def test_train_datasets_match_jax(trees, dataset, grayscale):
    args = _args(trees, dataset, grayscale)
    got = _common.build_seg_dataset(args, _common.train_transform())
    want = jax_common.build_seg_dataset(args, jax_common.train_transform())
    assert type(got).__name__ == type(want).__name__
    assert len(got) == len(want) == 4 - (dataset.startswith("city"))
    assert got.data_list == want.data_list
    assert got.label_list == want.label_list
    for i in range(len(got)):
        for epoch in range(2):
            g = got.get(i, host_rng(args.seed, epoch, i))
            w = want.get(i, jax_host_rng(args.seed, epoch, i))
            assert g.keys() == w.keys()
            assert g["image"].shape[:2] == (256, 512)
            assert g["label"].dtype == w["label"].dtype == np.int64
            for key in g:
                np.testing.assert_array_equal(g[key], w[key], err_msg=key)


def test_freiburg_native_decode_batches(trees):
    """``native_decode=True``: ``get_batch`` decodes the batch natively
    (where the library builds) and gives the JAX package's samples; the
    PIL path (``native_decode`` off) has no batch path."""
    from thermal_semantic_segmentation_torch.data import native_loader
    from thermal_semantic_segmentation_torch.data.freiburg import Freiburg
    from thermal_semantic_segmentation_tpu.data.freiburg import (
        Freiburg as JaxFreiburg)
    got = Freiburg(trees[0], "train", "IR", native_decode=True,
                   transforms=_common.val_transform()).get_batch(
        [0, 1], [host_rng(0), host_rng(1)])
    if native_loader.available():
        want = JaxFreiburg(trees[0], "train", "IR", native_decode=True,
                           transforms=jax_common.val_transform()).get_batch(
            [0, 1], [jax_host_rng(0), jax_host_rng(1)])
        assert len(got) == len(want) == 2
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g["image"], w["image"])
            np.testing.assert_array_equal(g["label"], w["label"])
    else:
        assert got is None
    # self-training mode is ported (tests/test_torch_self_train_data.py),
    # and the translator's mode (tests/test_torch_gan_cli.py)
    assert Freiburg(trees[0], "train", "RGB",
                    translation_mode=True).translation_mode
    assert Freiburg(trees[0], "train", "IR", self_train=True).self_train
    ds = Freiburg(trees[0], "train", "IR",
                  transforms=_common.train_transform())
    assert ds.get_batch([0, 1], [host_rng(0), host_rng(1)]) is None


def test_unlabelled_and_untrained_samples_match_jax(trees):
    fr, cs = trees
    from thermal_semantic_segmentation_tpu.data.freiburg import (
        Freiburg as JaxFreiburg)
    from thermal_semantic_segmentation_torch.data.freiburg import Freiburg
    g = Freiburg(fr, "train", "RGB", transforms=_common.val_transform(),
                 with_label=False).get(2, None)
    w = JaxFreiburg(fr, "train", "RGB", transforms=jax_common.val_transform(),
                    with_label=False).get(2, None)
    assert g.keys() == w.keys() == {"image", "img_path"}
    np.testing.assert_array_equal(g["image"], w["image"])
    g = cityscapes.Cityscapes(cs, transforms=_common.val_transform(),
                              train_mode=False).get(1, None)
    w = jax_cityscapes.Cityscapes(cs, transforms=jax_common.val_transform(),
                                  train_mode=False).get(1, None)
    assert g["img_path"] == w["img_path"]
    np.testing.assert_array_equal(g["image"], w["image"])


@pytest.mark.parametrize("data_folder", [
    "leftImg8bit", "translation", "gtFine_labelIds"])
def test_cityscapes_list_matches_jax(trees, tmp_path, data_folder):
    got = list_files.cityscapes_list(trees[1], data_folder, "train",
                                     list_root=str(tmp_path / "a"))
    want = jax_list_files.cityscapes_list(trees[1], data_folder, "train",
                                          list_root=str(tmp_path / "b"))
    assert os.path.basename(got) == os.path.basename(want)
    with open(got) as f, open(want) as g:
        assert f.read() == g.read()


def test_remap_label_matches_jax():
    ids = np.arange(-3, 300).reshape(3, 101)
    np.testing.assert_array_equal(cityscapes.remap_label(ids),
                                  jax_cityscapes.remap_label(ids))
    assert cityscapes.remap_label(np.uint8([7, 33, 0])).tolist() == [0, 11, 12]
