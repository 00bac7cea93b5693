"""The port's eval data path and CLI (data/list_files.py, transforms.py,
freiburg.py, loader.py, cli/_common.py, cli/segmentation_evaluate.py)
against the JAX package on one synthetic Freiburg tree and one ``.pth``.

Arrays and orders must be equal; the CLIs' ``mean_iu`` and each ``cls_iu``
within 1e-6 and ``val_loss`` within 1e-5 (relative). The JAX CLI runs at
``-val_batch_size 1``, the reference's protocol; the port gives the same
scores at any batch size.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from PIL import Image  # noqa: E402

from tests.synthetic import make_freiburg_tree  # noqa: E402
from tests.test_torch_deeplab import jax_deeplab_with_twin  # noqa: E402
from thermal_semantic_segmentation_tpu.cli import (  # noqa: E402
    _common as jax_common, segmentation_evaluate as jax_cli)
from thermal_semantic_segmentation_tpu.data import (  # noqa: E402
    list_files as jax_list_files, loader as jax_loader)
from thermal_semantic_segmentation_torch.cli import (  # noqa: E402
    _common, segmentation_evaluate)
from thermal_semantic_segmentation_torch.cli.options import (  # noqa: E402
    evaluation_parse)
from thermal_semantic_segmentation_torch.data import (  # noqa: E402
    list_files, loader)

N_TEST = 5
TIE_GAP = 1e-5


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """A Freiburg tree with IR train and test frames, plus RGB test frames
    (the synthetic tree has none) beside the IR ones."""
    root = make_freiburg_tree(str(tmp_path_factory.mktemp("data") / "fr"),
                              n_train=2, n_test=N_TEST)
    rng = np.random.default_rng(1)
    rgb_dir = os.path.join(root, "test", "day", "ImagesRGB")
    os.makedirs(rgb_dir)
    for i in range(3):
        Image.fromarray(rng.integers(0, 256, (40, 120, 3)).astype(np.uint8)
                        ).save(os.path.join(rgb_dir, f"{i:04d}_rgb.png"))
    return root


@pytest.mark.parametrize("split,domain", [
    ("test", "IR"), ("test", "RGB"), ("train", "IR"), ("train", "RGB")])
def test_freiburg_pairs_match_jax(tree, split, domain):
    got = list_files.freiburg_pairs(tree, split, domain)
    assert got and got == jax_list_files.freiburg_pairs(tree, split, domain)


def _dataset_args(tree, domain, grayscale):
    name = "freiburg_ir" if domain == "IR" else "freiburg_rgb"
    return evaluation_parse().parse_args(
        ["-dataset", name, "--freiburg_root", tree,
         "-grayscale", str(grayscale)])


@pytest.mark.parametrize("domain,grayscale", [
    ("IR", False), ("RGB", False), ("RGB", True)])
def test_freiburg_test_samples_match_jax(tree, domain, grayscale):
    args = _dataset_args(tree, domain, grayscale)
    got = _common.build_seg_dataset(args, _common.val_transform(),
                                    for_eval=True)
    want = jax_common.build_seg_dataset(args, jax_common.val_transform(),
                                        for_eval=True)
    assert len(got) == len(want) > 0
    for i in range(len(got)):
        g, w = got.get(i, None), want.get(i, None)
        assert g.keys() == w.keys() == {"image", "label"}
        assert g["image"].shape == (256, 512, 1 if domain == "IR"
                                    or grayscale else 3)
        assert g["image"].dtype == w["image"].dtype == np.float32
        assert g["label"].dtype == w["label"].dtype == np.int64
        np.testing.assert_array_equal(g["image"], w["image"])
        np.testing.assert_array_equal(g["label"], w["label"])


def test_unlabelled_test_samples_match_jax(tree):
    from thermal_semantic_segmentation_tpu.data.freiburg import (
        FreiburgTest as JaxFreiburgTest)
    from thermal_semantic_segmentation_torch.data.freiburg import (
        FreiburgTest)

    got = FreiburgTest(tree, "test", "IR", transforms=_common.val_transform(),
                       with_label=False).get(1, None)
    want = JaxFreiburgTest(tree, "test", "IR",
                           transforms=jax_common.val_transform(),
                           with_label=False).get(1, None)
    assert got.keys() == want.keys() == {"image"}
    np.testing.assert_array_equal(got["image"], want["image"])


@pytest.mark.parametrize("loader_name,frame", [
    ("load_ir_image", "fl_ir_aligned"), ("load_rgb_image", "fl_rgb"),
    ("load_label", "fl_rgb_labels")])
def test_frame_decoders_match_jax(tree, loader_name, frame):
    from thermal_semantic_segmentation_tpu.data import freiburg as jax_fr
    from thermal_semantic_segmentation_torch.data import freiburg, image

    # the port's frames are numpy arrays in the JAX package's PIL modes
    path = os.path.join(tree, "train", "seq_00_day", "00", frame, "0001.png")
    got = getattr(freiburg, loader_name)(path)
    want = getattr(jax_fr, loader_name)(path)
    assert image.mode_of(got) == want.mode
    assert image.size(got) == want.size == (700, 320)
    np.testing.assert_array_equal(got, np.asarray(want))
    if loader_name == "load_rgb_image":
        gray = freiburg.load_rgb_image(path, grayscale=True)
        assert image.mode_of(gray) == "L"
        np.testing.assert_array_equal(
            np.asarray(gray), np.asarray(jax_fr.load_rgb_image(path, True)))


@pytest.mark.parametrize("data_split", [False, True])
def test_loader_batches_match_jax(tmp_path, data_split):
    """The same images in the same order, split and shuffled or not."""
    root = make_freiburg_tree(str(tmp_path / "fr"), n_train=0, n_test=10)
    args = _dataset_args(root, "IR", False)
    ds = _common.build_seg_dataset(args, _common.val_transform(),
                                   for_eval=True)
    jds = jax_common.build_seg_dataset(args, jax_common.val_transform(),
                                       for_eval=True)
    kw = dict(drop_last=False, seed=3)
    if data_split:
        _, val_idx = loader.split_indices(len(ds), 0.2, seed=42)
        assert val_idx == jax_loader.split_indices(len(ds), 0.2, seed=42)[1]
        kw.update(shuffle=True, indices=val_idx)
    got = list(loader.DataLoader(ds, 3, **kw))
    want = list(jax_loader.DataLoader(jds, 3, **kw))
    assert len(got) == len(want) == -(-(2 if data_split else 10) // 3)
    for g, w in zip(got, want):
        for key in ("image", "label"):
            np.testing.assert_array_equal(g[key], w[key])


class _Flaky:
    """In-memory samples; index 2 cannot be read."""

    def __len__(self):
        return 6

    def get(self, index, rng):
        if index == 2:
            raise OSError("truncated file")
        return {"i": np.int64(index), "draw": rng.random()}


def test_loader_substitutes_unreadable_samples_as_jax(caplog):
    kw = dict(drop_last=False, shuffle=True, seed=5)
    got = list(loader.DataLoader(_Flaky(), 4, **kw))
    want = list(jax_loader.DataLoader(_Flaky(), 4, **kw))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["i"], w["i"])
        np.testing.assert_array_equal(g["draw"], w["draw"])
    assert 2 not in np.concatenate([g["i"] for g in got])
    assert "substituting" in caplog.text
    with pytest.raises(OSError):
        list(loader.DataLoader(_Flaky(), 4, corrupt_retries=0))


def _ignore_near_ties(tree, model, variables):
    """Label 255 every source pixel that lands on a pixel whose JAX top-2
    upsampled logit gap is below TIE_GAP, so that neither confusion matrix
    counts a genuine near-tie (float32 reassociation may flip its argmax).
    Returns the number of such pixels."""
    import jax.numpy as jnp
    from thermal_semantic_segmentation_tpu.ops.resize import upsample_logits

    ds = jax_common.build_seg_dataset(_dataset_args(tree, "IR", False),
                                      jax_common.val_transform(),
                                      for_eval=True)
    n_ties = 0
    for i, path in enumerate(ds.label_list):
        image = ds.get(i, None)["image"]
        out = model.apply(variables, jnp.asarray(image[None]), train=False)
        top2 = np.sort(np.asarray(upsample_logits(out["out"], 256, 512))[0],
                       axis=-1)[..., -2:]
        ties = (top2[..., 1] - top2[..., 0]) < TIE_GAP
        n_ties += int(ties.sum())
        # the source pixel of each sample pixel, through the label chain
        label = np.load(path)
        src = []
        for axis in (0, 1):
            np.save(path, np.indices(label.shape)[axis].astype(np.uint8))
            src.append(ds.get(i, None)["label"])
        label[src[0][ties], src[1][ties]] = 255
        np.save(path, label)
    return n_ties


@pytest.fixture(scope="module")
def checkpoint(tree, tmp_path_factory):
    """A reference-schema .pth of a tiny DeepLabV2 with random weights; the
    tree's test labels ignore its near-ties."""
    root = tmp_path_factory.mktemp("ckpt")
    model, variables, twin = jax_deeplab_with_twin(4)
    torch.save({"epoch": 2, "sem_net_state_dict": twin.state_dict()},
               str(root / "tiny.pth"))
    assert _ignore_near_ties(tree, model, variables) < 1000
    return str(root)


def _argv(tree, checkpoint, out_root, batch_size):
    return ["-dataset", "freiburg_ir", "-checkpoint_name", "tiny.pth",
            "--model_root_path", checkpoint, "--freiburg_root", tree,
            "-val_batch_size", str(batch_size), "--root", str(out_root),
            "-visualize_prediction", "save_all"]


@pytest.fixture(scope="module")
def jax_scores(tree, checkpoint, tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_out")
    args = jax_cli.evaluation_parse().parse_args(
        _argv(tree, checkpoint, out, 1) + ["--layers", "1,1,1,1"])
    return jax_cli.seg_evaluation(args), out


@pytest.mark.parametrize("batch_size", [1, 4])
def test_eval_cli_matches_jax_cli(tree, checkpoint, jax_scores, tmp_path,
                                  batch_size, capsys):
    (want_miou, want_loss, want_cls), jax_out = jax_scores
    capsys.readouterr()
    got_miou, got_loss, got_cls = segmentation_evaluate.main(
        _argv(tree, checkpoint, tmp_path, batch_size) + ["--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "evaluating..."
    assert f"mean iou score: [{got_miou}]. val_loss: [{got_loss}]" in lines
    assert [ln for ln in lines if ln.startswith("target set class")] == [
        f"target set class {k}: {v}" for k, v in got_cls.items()]
    np.testing.assert_allclose(got_miou, want_miou, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got_loss, want_loss, rtol=1e-5)
    assert list(got_cls) == list(want_cls) and len(got_cls) == 12
    np.testing.assert_allclose(list(got_cls.values()),
                               list(want_cls.values()), rtol=0, atol=1e-6)
    # the palette dumps: one set per batch, under the same names
    got_dir = tmp_path / "predictions" / "tiny"
    want_dir = jax_out / "predictions" / "tiny"
    n_batches = -(-N_TEST // batch_size)
    names = sorted(f"{i}_{kind}.png" for i in range(n_batches)
                   for kind in ("prediction", "groundtruth", "image"))
    assert sorted(os.listdir(got_dir)) == names
    for i in range(n_batches):         # batch i begins with image i * bs
        for kind in ("groundtruth", "image"):
            g = Image.open(got_dir / f"{i}_{kind}.png")
            w = Image.open(want_dir / f"{i * batch_size}_{kind}.png")
            assert g.mode == w.mode
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


@pytest.mark.parametrize("flags,save_root", [
    (["-baseline", "true"],
     "baseline_predictions/apply_Grayscale_image_on_Thermal_domain_model"),
    (["-generator_type", "t2s"], "predictions/t2s/tiny")])
def test_eval_cli_save_roots_follow_jax(tree, checkpoint, tmp_path,
                                        monkeypatch, flags, save_root):
    """-baseline and -generator_type t2s dump under the JAX CLI's paths,
    relative to the working directory; -visualize_prediction save_one
    dumps the first batch only."""
    monkeypatch.chdir(tmp_path)
    segmentation_evaluate.main(
        _argv(tree, checkpoint, tmp_path, 2)[:-1] + ["save_one", "--device",
                                                     "cpu", *flags])
    assert sorted(os.listdir(tmp_path / save_root)) == [
        "0_groundtruth.png", "0_image.png", "0_prediction_0.png"]


def test_unknown_dataset_is_refused():
    with pytest.raises(ValueError, match="does not exist"):
        segmentation_evaluate.main(["-dataset", "kitti", "--device", "cpu"])
