"""The port's self-training data path (data/self_train_aug.py,
Freiburg(self_train=True) in data/freiburg.py) and its PIL-free validation
dumps (data/png.py, data/palette.py, eval/validate.py) against the JAX
package and PIL.

Tolerances: the recorded ``weak_params`` equal; images, masks and hard ids
exact (the same PIL operations); soft maps 1e-6 (the port resamples them
with 2-tap gathers, the JAX package with dense matrices, both from float64
source coordinates in float32). PNG files decode in PIL to the pixels (and
palette) of the files PIL writes itself.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from PIL import Image  # noqa: E402

from tests.synthetic import make_freiburg_tree  # noqa: E402
from thermal_semantic_segmentation_tpu.data import (  # noqa: E402
    freiburg as jax_freiburg, palette as jax_palette)
from thermal_semantic_segmentation_tpu.data import (  # noqa: E402
    self_train_aug as jax_aug)
from thermal_semantic_segmentation_torch.data import (  # noqa: E402
    freiburg, palette, png, self_train_aug)
from thermal_semantic_segmentation_torch.eval.validate import (  # noqa: E402
    seg_validate)
from thermal_semantic_segmentation_torch.models.deeplab import (  # noqa: E402
    create_deeplab)
from thermal_semantic_segmentation_torch.train.seg import (  # noqa: E402
    build_seg_eval_step)

C, IGNORE = 13, 12
SOFT_ATOL = 1e-6
N_TRAIN = 3


def _assert_same_sample(got: dict, want: dict):
    assert got.keys() == want.keys()
    for key in want:
        if key == "weak_params":
            assert got[key].keys() == want[key].keys()
            for k, v in want[key].items():
                assert got[key][k].dtype == v.dtype, k
                np.testing.assert_array_equal(got[key][k], v, err_msg=k)
        elif key == "label_soft":
            assert got[key].dtype == want[key].dtype
            np.testing.assert_allclose(got[key], want[key], rtol=0,
                                       atol=SOFT_ATOL)
        elif key == "img_path":
            assert got[key] == want[key]
        else:
            assert got[key].dtype == want[key].dtype, key
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)


@pytest.mark.parametrize("hw", [(33, 65), (320, 700), (5, 9)])
def test_interp_soft_matches_jax(hw):
    soft = np.random.default_rng(0).random((C, 33, 65)).astype(np.float32)
    got = self_train_aug.interp_soft(soft, *hw)
    want = jax_aug._interp_soft(soft, *hw)
    assert got.dtype == want.dtype == np.float32 and got.shape == (C, *hw)
    np.testing.assert_allclose(got, want, rtol=0, atol=SOFT_ATOL)


@pytest.mark.parametrize("args", [(600, (256, 128), 0.5),
                                  (100, (256, 128), 0.5),   # undersized
                                  (400, (128, 64), 1.0)])
def test_self_train_augment_matches_jax(args):
    rng = np.random.default_rng(1)
    img = Image.fromarray(rng.random((320, 700), dtype=np.float32))
    mask = rng.integers(0, 13, (320, 700)).astype(np.uint8)
    hard = rng.integers(0, 13, (256, 512)).astype(np.uint8)
    soft = rng.random((C, 33, 65)).astype(np.float32)
    flips = set()
    for seed in range(4):
        got = self_train_aug.SelfTrainAugment(*args)(
            np.random.default_rng(seed), img, mask, hard, soft)
        want = jax_aug.SelfTrainAugment(*args)(
            np.random.default_rng(seed), img, mask, hard, soft)
        names = ("image", "label", "label_hard", "label_soft")
        _assert_same_sample(dict(zip(names, got[:4]), weak_params=got[4]),
                            dict(zip(names, want[:4]), weak_params=want[4]))
        tw, th = args[1]
        assert got[0].shape == (th, tw) and got[3].shape == (C, th, tw)
        flips.add(bool(got[4]["flip"]))
    assert flips == ({True} if args[2] == 1.0 else {True, False})
    if args[0] == 100:
        np.testing.assert_array_equal(got[4]["crop"], [0, 128, 0, 256])


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """A Freiburg tree and, for its train frames, hard pseudo-label PNGs at
    256x512 with float16 confidences and soft maps at 33x65, as
    generate_pseudo_label writes them."""
    root = tmp_path_factory.mktemp("st_data")
    fr = make_freiburg_tree(str(root / "freiburg"), n_train=N_TRAIN,
                            n_test=0)
    rng = np.random.default_rng(2)
    for sub in ("hard", "soft"):
        os.makedirs(root / sub)
    for i in range(N_TRAIN):
        ids = rng.integers(0, C, (256, 512)).astype(np.uint8)
        Image.fromarray(ids).save(root / "hard" / f"{i:04d}.png")
        np.save(root / "hard" / f"{i:04d}_conf.npy",
                rng.random((256, 512)).astype(np.float16))
        soft = rng.random((C, 33, 65)).astype(np.float32)
        np.save(root / "soft" / f"{i:04d}.npy", soft / soft.sum(0))
    return fr, str(root / "soft"), str(root / "hard")


@pytest.mark.parametrize("threshold,proto_rectify", [
    (0.3, True), (0.0, True), (0.3, False)])
def test_freiburg_self_train_matches_jax(tree, threshold, proto_rectify):
    fr, soft, hard = tree
    kw = dict(segmentation_mode=True, self_train=True, path_soft=soft,
              path_lp=hard, threshold=threshold, ignore_index=IGNORE,
              proto_rectify=proto_rectify)
    got_ds = freiburg.Freiburg(fr, "train", "IR", augmentations=(
        self_train_aug.SelfTrainAugment(600, (256, 128), 0.5)), **kw)
    want_ds = jax_freiburg.Freiburg(fr, "train", "IR", augmentations=(
        jax_aug.SelfTrainAugment(600, (256, 128), 0.5)), **kw)
    assert len(got_ds) == len(want_ds) == N_TRAIN
    for i in range(N_TRAIN):
        got = got_ds.get(i, np.random.default_rng(i))
        want = want_ds.get(i, np.random.default_rng(i))
        _assert_same_sample(got, want)
        assert got["image_full"].shape == (320, 700, 1)
        assert got["image"].shape == (128, 256, 1)
        assert ("label_soft" in got) == proto_rectify
        kept = set(np.unique(got["label_hard"]).tolist())
        assert kept <= ({5, 11, IGNORE} if threshold else set(range(C)))


def test_freiburg_self_train_mode_has_no_native_path(tree):
    """``native_decode`` is taken, and self-training mode, like the JAX
    package's, has no native batch path: ``get_batch`` gives None and the
    loader reads sample by sample."""
    ds = freiburg.Freiburg(tree[0], "train", "IR", native_decode=True,
                           self_train=True)
    assert ds.native_decode
    assert ds.get_batch([0, 1], [np.random.default_rng(0)] * 2) is None
    # the translator's mode is ported (tests/test_torch_gan_cli.py)
    assert freiburg.Freiburg(tree[0], "train", "RGB",
                             translation_mode=True).translation_mode


def test_png_writers_match_pil(tmp_path):
    rng = np.random.default_rng(3)
    rgb = rng.integers(0, 256, (37, 51, 3)).astype(np.uint8)
    png.write_rgb_png(str(tmp_path / "rgb.png"), rgb)
    got = Image.open(tmp_path / "rgb.png")
    assert got.mode == "RGB"
    np.testing.assert_array_equal(np.asarray(got), rgb)
    ids = rng.integers(0, 256, (37, 51))
    with open(tmp_path / "pal.png", "wb") as f:
        f.write(palette.colorize_prediction(ids))
    got = Image.open(tmp_path / "pal.png")
    want = jax_palette.colorize_prediction(ids)
    assert got.mode == want.mode == "P"
    assert got.getpalette() == want.getpalette()
    np.testing.assert_array_equal(np.asarray(got.convert("RGB")),
                                  np.asarray(want.convert("RGB")))
    for bad in (rgb[..., :2], rgb[:, :, 0]):
        with pytest.raises(ValueError):
            png.write_rgb_png(str(tmp_path / "bad.png"), bad)


@pytest.mark.parametrize("channels", [1, 3])
def test_validation_dumps_match_pil(tmp_path, channels):
    """seg_validate's save_all dumps, written without PIL, decode to what
    the JAX package's PIL dumps hold for the same prediction, label and
    image."""
    model = create_deeplab(0, device="cpu", num_channels=channels,
                           layers=(1, 1, 1, 1))
    rng = np.random.default_rng(4)
    batches = [{"image": rng.random((2, 32, 64, channels), dtype=np.float32),
                "label": rng.integers(0, 13, (2, 32, 64))} for _ in range(2)]
    batches[0]["label"][0, :4] = 255
    step = build_seg_eval_step(num_classes=C, ignore_index=IGNORE,
                               device="cpu")
    preds = []

    def recording_step(model, image, label):
        out = step(model, image, label)
        preds.append(out[2])
        return out

    seg_validate(model, batches, eval_step=recording_step, device="cpu",
                 visualize="save_all", save_root=str(tmp_path))
    assert sorted(os.listdir(tmp_path)) == [
        f"{i}_{kind}.png" for i in range(2)
        for kind in ("groundtruth", "image", "prediction")]
    for i, batch in enumerate(batches):
        for kind, ids in (("prediction", preds[i][0].numpy()),
                          ("groundtruth", batch["label"][0])):
            got = Image.open(tmp_path / f"{i}_{kind}.png")
            want = jax_palette.colorize_prediction(ids)
            assert got.mode == "P" and got.getpalette() == want.getpalette()
            np.testing.assert_array_equal(np.asarray(got.convert("RGB")),
                                          np.asarray(want.convert("RGB")))
        img8 = np.clip(batch["image"][0] * 255.0, 0, 255).astype(np.uint8)
        got = Image.open(tmp_path / f"{i}_image.png")
        assert got.mode == ("L" if channels == 1 else "RGB")
        np.testing.assert_array_equal(
            np.asarray(got), img8[..., 0] if channels == 1 else img8)
