"""The port's translation-distance eval (ops/ssim.py, eval/distance.py,
data/simple.DistanceDataset, cli/distance_evaluate.py) against the JAX
package on the same numpy-seeded inputs.

Tolerances: SSIM within 1e-5 absolute (the convolutions sum in another
order); the L1 rel 1e-6; the per-class L1 rel 1e-5 with the same nan
positions; dataset samples equal. In the CLIs the JAX package's float32
sums run over 448,000 pixels (the L1) and ~35,000 a class: its L1 lies
2.2e-6 and its road class 1.6e-5 (relative) from float64, the port's
(float64 sums) within 1e-7. There the port is held to a float64
recomputation at rel 1e-6, and to the JAX CLI at rel 1e-5 (L1) and 1e-4
(per class).
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from PIL import Image  # noqa: E402

from tests.synthetic import make_freiburg_tree  # noqa: E402
from thermal_semantic_segmentation_tpu.cli import (  # noqa: E402
    distance_evaluate as jax_cli)
from thermal_semantic_segmentation_tpu.data.simple import (  # noqa: E402
    DistanceDataset as JaxDistanceDataset)
from thermal_semantic_segmentation_tpu.eval.distance import (  # noqa: E402
    evaluate_distance as jax_evaluate_distance)
from thermal_semantic_segmentation_tpu.ops.ssim import (  # noqa: E402
    ssim as jax_ssim)
from thermal_semantic_segmentation_torch.cli import (  # noqa: E402
    distance_evaluate)
from thermal_semantic_segmentation_torch.data.freiburg import (  # noqa: E402
    load_ir_image)
from thermal_semantic_segmentation_torch.data.loader import (  # noqa: E402
    split_indices)
from thermal_semantic_segmentation_torch.data.simple import (  # noqa: E402
    DistanceDataset)
from thermal_semantic_segmentation_torch.eval.distance import (  # noqa: E402
    evaluate_distance)
from thermal_semantic_segmentation_torch.ops.ssim import ssim  # noqa: E402

SSIM_ATOL, L1_RTOL, CLASS_RTOL = 1e-5, 1e-6, 1e-5
CLI_L1_RTOL, CLI_CLASS_RTOL = 1e-5, 1e-4
K = 13


@pytest.mark.parametrize("size_average", [True, False],
                         ids=["mean", "per_image"])
@pytest.mark.parametrize("channels", [1, 3])
def test_ssim_matches_jax(channels, size_average):
    rng = np.random.default_rng(channels)
    x = rng.uniform(0, 1, (3, 40, 60, channels)).astype(np.float32)
    y = np.clip(x + rng.normal(0, 0.1, x.shape), 0, 1).astype(np.float32)
    want = np.asarray(jax_ssim(jnp.asarray(x), jnp.asarray(y),
                               size_average=size_average))
    got = ssim(torch.from_numpy(x), torch.from_numpy(y),
               size_average=size_average).numpy()
    assert got.shape == want.shape == (() if size_average else (3,))
    np.testing.assert_allclose(got, want, rtol=0, atol=SSIM_ATOL)


def _batches(seed=0):
    """Batches of 3, 3 and 2 pairs (the SSIM mean is over batches); the
    labels hold every class but one (nan) and some out-of-range ids."""
    rng = np.random.default_rng(seed)
    out = []
    for n in (3, 3, 2):
        ori = rng.uniform(0, 1, (n, 32, 48, 1)).astype(np.float32)
        trans = np.clip(ori + rng.normal(0, 0.2, ori.shape), 0, 1).astype(
            np.float32)
        label = rng.integers(0, K - 1, (n, 32, 48)).astype(np.int32)
        label[:, :4] = 255
        out.append({"original": ori, "translated": trans, "label": label})
    return out


@pytest.mark.parametrize("num_classes", [None, K], ids=["global",
                                                        "per_class"])
def test_evaluate_distance_matches_jax(num_classes):
    want = jax_evaluate_distance(_batches(), num_classes=num_classes)
    got = evaluate_distance(_batches(), num_classes=num_classes,
                            device="cpu")
    assert len(got) == len(want) == (2 if num_classes is None else 3)
    np.testing.assert_allclose(got[0], want[0], rtol=L1_RTOL)
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=SSIM_ATOL)
    if num_classes is not None:
        assert got[2].shape == (K,)
        assert np.isnan(got[2][K - 1]) and np.isnan(want[2][K - 1])
        np.testing.assert_array_equal(np.isnan(got[2]), np.isnan(want[2]))
        np.testing.assert_allclose(got[2], want[2], rtol=CLASS_RTOL)


def test_evaluate_distance_of_nothing_is_nan():
    l1, s = evaluate_distance([], device="cpu")
    assert np.isnan(l1) and np.isnan(s)
    l1, s, per_class = evaluate_distance([], num_classes=K, device="cpu")
    assert np.isnan(l1) and np.isnan(s)
    assert per_class.shape == (K,) and np.isnan(per_class).all()
    # one process: the reduction adds nothing, an empty shard stays nan
    l1, s, per_class = evaluate_distance([], num_classes=K, device="cpu",
                                         reduce_processes=True)
    assert np.isnan(l1) and np.isnan(s) and np.isnan(per_class).all()


def _translate(root, name, images):
    """Write ``images`` (uint8 (320, 700)) as the translations of the
    tree's train IR frames under ``name``, in the list's order."""
    base = os.path.join(root, name, "seq_00_day", "00", "fl_rgb")
    os.makedirs(base, exist_ok=True)
    for i, img in enumerate(images):
        Image.fromarray(img, mode="L").save(os.path.join(base,
                                                         f"{i:04d}.png"))


def test_distance_dataset_matches_jax(tmp_path):
    """The pairs, with labels, equal; a near-black uint8 translation (every
    pixel <= 1) is scaled by 1/255 all the same."""
    root = make_freiburg_tree(str(tmp_path / "fr"), n_train=3, n_test=0)
    rng = np.random.default_rng(4)
    images = [rng.integers(0, 256, (320, 700)).astype(np.uint8)
              for _ in range(2)] + [np.ones((320, 700), np.uint8)]
    _translate(root, "t_gate", images)
    got = DistanceDataset(root, "t_gate", with_label=True)
    want = JaxDistanceDataset(root, "t_gate", with_label=True)
    assert len(got) == len(want) == 3
    for i in range(3):
        g, w = got.get(i, None), want.get(i, None)
        assert g.keys() == w.keys() == {"original", "translated", "label"}
        for key in g:
            assert g[key].dtype == w[key].dtype, key
            np.testing.assert_array_equal(g[key], w[key], err_msg=key)
    dark = got.get(2, None)["translated"]
    assert dark.shape == (320, 700, 1) and dark.max() == np.float32(1 / 255)


def _cli_lines(out: str) -> dict:
    vals = {}
    for line in out.splitlines():
        if ": " in line and not line.startswith("Model"):
            name, v = line.rsplit(": ", 1)
            vals[name] = float(v)
    return vals


@pytest.mark.parametrize("per_class", [False, True],
                         ids=["global", "per_class"])
def test_distance_cli_matches_jax_cli(tmp_path, capsys, per_class):
    """Both CLIs on one tree of 10 frames (a split of 2, one batch at
    -batch_size 2): the same printed lines within the tolerances, the L1
    also against float64."""
    root = make_freiburg_tree(str(tmp_path / "fr"), n_train=10, n_test=0,
                              hw=(320, 960))
    rng = np.random.default_rng(5)
    _translate(root, "t_gate", [np.clip(
        np.asarray(load_ir_image(path)) * 255
        + rng.normal(0, 20, (320, 700)), 0, 255).astype(np.uint8)
        for path in DistanceDataset(root, "t_gate").data_list])
    argv = ["-checkpoint_name", "t_gate.pth", "--freiburg_root", root,
            "-batch_size", "2", "--per_class", str(per_class).lower()]
    jax_cli.main(argv)
    want = _cli_lines(capsys.readouterr().out)
    got_l1, got_ssim = distance_evaluate.main(argv + ["--device", "cpu"])
    out = capsys.readouterr().out
    assert out.splitlines()[0] == "Model: t_gate"
    got = _cli_lines(out)
    assert got.keys() == want.keys()
    assert len(got) == (2 + K if per_class else 2)
    assert got["L1 distance"] == got_l1 and got["SSIM score"] == got_ssim
    ds = DistanceDataset(root, "t_gate", with_label=True)
    pairs = [ds.get(i, None) for i in split_indices(len(ds), 0.2, 42)[1]]
    assert len(pairs) == 2
    diff = np.stack([np.abs(p["original"].astype(np.float64)
                            - p["translated"])[..., 0] for p in pairs])
    labels = np.stack([p["label"] for p in pairs])
    np.testing.assert_allclose(got["L1 distance"], diff.mean(), rtol=L1_RTOL)
    np.testing.assert_allclose(got["L1 distance"], want["L1 distance"],
                               rtol=CLI_L1_RTOL)
    np.testing.assert_allclose(got["SSIM score"], want["SSIM score"],
                               rtol=0, atol=SSIM_ATOL)
    names = [n for n in got if n.startswith("translation per-class L1")]
    for k, name in enumerate(names):
        assert np.isnan(got[name]) == np.isnan(want[name]), name
        in_k = labels == k
        want64 = diff[in_k].mean() if in_k.any() else np.nan
        np.testing.assert_allclose(got[name], want64, rtol=L1_RTOL,
                                   err_msg=name)
        np.testing.assert_allclose(got[name], want[name],
                                   rtol=CLI_CLASS_RTOL, err_msg=name)
