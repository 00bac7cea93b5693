"""The eval CLI on the datasets of translated data (data/cityscapes.py,
data/freiburg.FreiburgTranslationPairs, cli/_common.build_seg_dataset)
against the JAX eval CLI: ``cityscapes``, ``cityscapes_translation``,
``freiburg_translation`` (the JPEG pairs under
``translations/test_<checkpoint>/``) and ``freiburg_t2s`` (under
``translations/t2s/<-t2s_folder>``), on trees of PIL-written frames at
the eval size (256x512), so that a label pixel is its prediction's pixel.

Each dataset's frames go to a tiny DeepLabV2 of their channel count (a
reference ``.pth``). Pixels whose JAX top-2 upsampled logit gap is under
1e-5 are labelled 255 in both packages (the Cityscapes id table maps 255
to 255 here: the ids it maps leave none outside the scored range), so
float32 reassociation cannot flip a counted argmax. mIoU and each class
IoU within 1e-6, val_loss rel 1e-5; the samples equal.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from PIL import Image  # noqa: E402

from tests.test_torch_deeplab import jax_deeplab_with_twin  # noqa: E402
from thermal_semantic_segmentation_tpu.cli import (  # noqa: E402
    _common as jax_common, segmentation_evaluate as jax_cli)
from thermal_semantic_segmentation_tpu.data import (  # noqa: E402
    cityscapes as jax_cityscapes)
from thermal_semantic_segmentation_tpu.ops.resize import (  # noqa: E402
    upsample_logits as jax_upsample_logits)
from thermal_semantic_segmentation_torch.cli import (  # noqa: E402
    _common, segmentation_evaluate)
from thermal_semantic_segmentation_torch.cli.options import (  # noqa: E402
    evaluation_parse, seg_parse)
from thermal_semantic_segmentation_torch.data import (  # noqa: E402
    cityscapes)

HW = (256, 512)
N = 2
TIE_GAP = 1e-5
T2S_FOLDER = "test_t2s_run/"
# dataset -> (frame channels, checkpoint)
DATASETS = {"cityscapes": (3, "c3_segmentation.pth"),
            "cityscapes_translation": (1, "c1_segmentation.pth"),
            "freiburg_translation": (1, "c1_segmentation.pth"),
            "freiburg_t2s": (3, "c3_segmentation.pth")}


@pytest.fixture(autouse=True)
def cityscapes_keeps_255(monkeypatch):
    for module in (cityscapes, jax_cityscapes):
        lut = np.array(module._LUT)
        lut[255] = 255
        monkeypatch.setattr(module, "_LUT", lut)


def _frame(rng, channels):
    shape = HW if channels == 1 else (*HW, 3)
    return Image.fromarray(rng.integers(0, 256, shape).astype(np.uint8))


def _argv(world, dataset):
    channels, ckpt = DATASETS[dataset]
    return ["-dataset", dataset, "-checkpoint_name", ckpt,
            "--model_root_path", world["ckpt"], "--freiburg_root",
            world["freiburg"], "--source_root", world["cityscapes"],
            "-t2s_folder", T2S_FOLDER, "-net_mode",
            "one_channel" if channels == 1 else "three_channels"]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The trees, the two checkpoints and the JAX models; every label
    ignores its JAX near-ties."""
    root = tmp_path_factory.mktemp("eval_datasets")
    rng = np.random.default_rng(11)
    city, fr = root / "cityscapes", root / "freiburg"
    for folder, c in (("leftImg8bit", 3), ("translation", 1)):
        for i in range(N):
            img = city / folder / "train" / "cityA" / \
                f"cityA_{i:06d}_{folder}.png"
            lbl = city / "gtFine_labelIds" / "train" / "cityA" / \
                f"cityA_{i:06d}_gtFine_labelIds.png"
            img.parent.mkdir(parents=True, exist_ok=True)
            lbl.parent.mkdir(parents=True, exist_ok=True)
            _frame(rng, c).save(img)
            if not lbl.exists():
                Image.fromarray(rng.integers(0, 34, HW).astype(np.uint8),
                                mode="L").save(lbl)
    for folder, c in (("translations/test_c1", 1),
                      (f"translations/t2s/{T2S_FOLDER}", 3)):
        (fr / folder).mkdir(parents=True)
        for i in range(N):
            _frame(rng, c).save(fr / folder / f"{i:04d}_translation.jpg",
                                quality=90)
            Image.fromarray(rng.integers(0, 13, HW).astype(np.uint8),
                            mode="L").save(fr / folder /
                                           f"{i:04d}_groundtruth.png")
    ckpt = root / "ckpt"
    ckpt.mkdir()
    models = {}
    for c in (1, 3):
        model, variables, twin = jax_deeplab_with_twin(40 + c,
                                                       num_channels=c)
        torch.save({"epoch": 1, "sem_net_state_dict": twin.state_dict()},
                   str(ckpt / f"c{c}_segmentation.pth"))
        models[c] = (jax.jit(lambda v, x, m=model: m.apply(
            v, x, train=False)["out"]), variables)
    world = dict(cityscapes=str(city), freiburg=str(fr), ckpt=str(ckpt))
    ties = {}
    for dataset, (c, _) in DATASETS.items():
        args = evaluation_parse().parse_args(_argv(world, dataset))
        ds = jax_common.build_seg_dataset(args, jax_common.val_transform(),
                                          for_eval=True)
        assert len(ds) == N
        ties[dataset] = 0
        for i in range(N):
            apply, variables = models[c]
            image = ds.get(i, None)["image"]
            assert image.shape == (*HW, c)
            out = apply(variables, jnp.asarray(image[None]))
            top2 = np.sort(np.asarray(jax_upsample_logits(out, *HW))[0],
                           axis=-1)[..., -2:]
            tied = (top2[..., 1] - top2[..., 0]) < TIE_GAP
            path = ds.label_list[i] if dataset.startswith("cityscapes") \
                else ds.translation_files[i].replace("_translation.jpg",
                                                     "_groundtruth.png")
            label = np.array(Image.open(path))
            label[tied] = 255
            Image.fromarray(label, mode="L").save(path)
            ties[dataset] += int(tied.sum())
    world["ties"] = ties
    return world


@pytest.mark.parametrize("dataset", list(DATASETS))
def test_eval_cli_on_translated_datasets_matches_jax(world, dataset,
                                                     tmp_path, capsys):
    """The samples of both packages' datasets, then both CLIs' scores
    (JAX at -val_batch_size 1, the port at 2)."""
    args = evaluation_parse().parse_args(_argv(world, dataset))
    got_ds = _common.build_seg_dataset(args, _common.val_transform(),
                                       for_eval=True)
    want_ds = jax_common.build_seg_dataset(args, jax_common.val_transform(),
                                           for_eval=True)
    assert type(got_ds).__name__ == type(want_ds).__name__
    for i in range(N):
        g, w = got_ds.get(i, None), want_ds.get(i, None)
        assert g.keys() == w.keys() == {"image", "label"}
        assert g["label"].dtype == w["label"].dtype == np.int64
        for key in g:
            np.testing.assert_array_equal(g[key], w[key], err_msg=key)
    assert world["ties"][dataset] < 1000, world["ties"]   # of 262,144
    jax_args = jax_cli.evaluation_parse().parse_args(
        _argv(world, dataset) + ["-val_batch_size", "1", "--layers",
                                 "1,1,1,1"])
    want_miou, want_loss, want_cls = jax_cli.seg_evaluation(jax_args)
    got_miou, got_loss, got_cls = segmentation_evaluate.main(
        _argv(world, dataset) + ["-val_batch_size", "2", "--device",
                                 "cpu"])
    capsys.readouterr()
    print(f"{dataset}: mIoU {got_miou} vs {want_miou}, val_loss {got_loss} "
          f"vs {want_loss}; {world['ties'][dataset]} near-tie pixels "
          f"ignored")
    np.testing.assert_allclose(got_miou, want_miou, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got_loss, want_loss, rtol=1e-5)
    assert list(got_cls) == list(want_cls)
    np.testing.assert_allclose(list(got_cls.values()),
                               list(want_cls.values()), rtol=0, atol=1e-6)


def test_train_dataset_freiburg_t2s_matches_jax(world):
    """The train CLI's freiburg_t2s: the same pairs through the train
    augmentation, from the same per-sample draws."""
    from thermal_semantic_segmentation_tpu.core.prng import host_rng as jrng

    from thermal_semantic_segmentation_torch.core.prng import host_rng

    args = seg_parse().parse_args(
        ["-dataset", "freiburg_t2s", "--freiburg_root", world["freiburg"],
         "-t2s_folder", T2S_FOLDER])
    got = _common.build_seg_dataset(args, _common.train_transform())
    want = jax_common.build_seg_dataset(args, jax_common.train_transform())
    assert len(got) == len(want) == N
    for i in range(N):
        g = got.get(i, host_rng(3, 0, i))
        w = want.get(i, jrng(3, 0, i))
        assert g["image"].shape == (*HW, 3)
        for key in ("image", "label"):
            np.testing.assert_array_equal(g[key], w[key], err_msg=key)
