"""The port's class prototypes (ops/class_means.py, train/prototypes.py)
against the JAX package on the same inputs and weights.

masked_class_means: vectors within 5e-4, valid exact; fold_prototypes in
its three regimes across the 100 and 3000 count thresholds: within 1e-6,
counts exact; the per-process merge's arithmetic against numpy;
calc_prototypes over one loader: prototypes within 5e-4, counts exact.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from tests.test_torch_deeplab import HW, jax_deeplab_with_twin  # noqa: E402
from thermal_semantic_segmentation_tpu.ops import (  # noqa: E402
    class_means as jax_class_means)
from thermal_semantic_segmentation_tpu.train.prototypes import (  # noqa: E402
    calc_prototypes as jax_calc_prototypes)
from thermal_semantic_segmentation_torch.kernels.upsample_argmax import (  # noqa: E402
    upsample_argmax)
from thermal_semantic_segmentation_torch.ops.class_means import (  # noqa: E402
    MAX_PROTOTYPE_COUNT, fold_prototypes, masked_class_means)
from thermal_semantic_segmentation_torch.train.prototypes import (  # noqa: E402
    calc_prototypes, merge_process_prototypes)

C = 13


@pytest.mark.parametrize("thresh", [None, 0.2])
@pytest.mark.parametrize("with_labels", [False, True])
def test_masked_class_means_match_jax(thresh, with_labels):
    rng = np.random.default_rng(0)
    n, h, w, f = 3, 9, 17, 16
    feat = rng.standard_normal((n, h, w, f)).astype(np.float32)
    # class 0 favoured, so some classes pass min_pixels and some do not
    logits = (rng.standard_normal((n, h, w, C)) * 2).astype(np.float32)
    logits[..., 0] += 1.5
    labels = None
    if with_labels:
        labels = np.where(rng.random((n, h, w)) < 0.5,
                          logits.argmax(-1), rng.integers(0, C, (n, h, w)))
        labels[rng.random((n, h, w)) < 0.05] = 255
    kw = dict(num_classes=C, thresh=thresh, min_pixels=10)
    want_v, want_ok = jax_class_means.masked_class_means(
        jnp.asarray(feat), jnp.asarray(logits),
        labels=None if labels is None else jnp.asarray(labels), **kw)
    # the port takes the classes from the kernel, as its prototype step does
    pred, conf = upsample_argmax(torch.from_numpy(logits), h, w)
    got_v, got_ok = masked_class_means(
        torch.from_numpy(feat), pred, conf,
        labels=None if labels is None else torch.from_numpy(labels), **kw)
    want_ok = np.asarray(want_ok)
    assert got_v.shape == (n, C, f) and got_v.dtype == torch.float32
    np.testing.assert_array_equal(got_ok.numpy(), want_ok)
    assert 0 < want_ok.sum() < want_ok.size
    np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v), rtol=0,
                               atol=5e-4)


@pytest.mark.parametrize("mode,start_mean", [
    ("mean", True), ("moving_average", False), ("moving_average", True)])
def test_fold_prototypes_matches_jax(mode, start_mean):
    rng = np.random.default_rng(1)
    n, f = 6, 8
    protos = rng.standard_normal((C, f)).astype(np.float32)
    # start counts on both sides of the 100 (start_mean) and 3000 (cap)
    # thresholds, so the steps cross them
    counts = np.array([0, 1, 97, 98, 99, 100, 101, 2996, 2997, 2998, 2999,
                       3000, 50], np.float32)
    vectors = rng.standard_normal((n, C, f)).astype(np.float32)
    vectors[2, 5] = 0.0                         # all-zero vectors are skipped
    vectors[4, :3] = 0.0
    valid = rng.random((n, C)) < 0.8
    kw = dict(momentum=0.01, mode=mode, start_mean=start_mean)
    want_p, want_n = jax_class_means.fold_prototypes(
        jnp.asarray(protos), jnp.asarray(counts), jnp.asarray(vectors),
        jnp.asarray(valid), **kw)
    got_p, got_n = fold_prototypes(
        torch.from_numpy(protos), torch.from_numpy(counts),
        torch.from_numpy(vectors), torch.from_numpy(valid), **kw)
    np.testing.assert_array_equal(got_n.numpy(), np.asarray(want_n))
    assert got_n.max() == MAX_PROTOTYPE_COUNT and got_n[0] > 0
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), rtol=0,
                               atol=1e-6)
    assert not np.allclose(got_p.numpy(), protos)


def test_fold_refuses_an_unknown_mode():
    with pytest.raises(ValueError, match="update mode"):
        fold_prototypes(torch.zeros(C, 2), torch.zeros(C),
                        torch.zeros(1, C, 2), torch.ones(1, C, dtype=bool),
                        mode="ema")


def test_merge_process_prototypes_arithmetic():
    rng = np.random.default_rng(2)
    all_p = rng.standard_normal((3, C, 5)).astype(np.float32)
    all_n = rng.integers(0, 1500, (3, C)).astype(np.float32)
    all_n[:, 4] = 0                                   # a class nobody saw
    got_p, got_n = merge_process_prototypes(all_p, all_n)
    total = all_n.astype(np.float64).sum(0)
    want = (all_p.astype(np.float64) * all_n[..., None]).sum(0) \
        / np.maximum(total, 1.0)[:, None]
    np.testing.assert_allclose(got_p, want, rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(got_n, np.minimum(total, 3000.0))
    assert got_p.dtype == got_n.dtype == np.float32
    assert got_n.max() == 3000.0 and np.all(got_p[4] == 0.0)
    one_p, one_n = merge_process_prototypes(all_p[:1], all_n[:1])
    np.testing.assert_array_equal(one_p, all_p[0])   # one process: as is
    np.testing.assert_array_equal(one_n, all_n[0])


class ImageLoader:
    """Seeded images in batches of 3; each iteration is one epoch."""

    def __len__(self):
        return 2

    def __iter__(self):
        rng = np.random.default_rng(3)
        for _ in range(2):
            yield {"image": rng.uniform(0, 1, (3, *HW, 1)).astype(np.float32)}


@pytest.mark.parametrize("epochs,max_steps", [(1, 0), (2, 1)])
def test_calc_prototypes_matches_jax(epochs, max_steps):
    model, variables, twin = jax_deeplab_with_twin(12)
    want_p, want_n = jax_calc_prototypes(model, variables, ImageLoader(),
                                         num_classes=C, epochs=epochs,
                                         max_steps=max_steps)
    got_p, got_n = calc_prototypes(twin, ImageLoader(), num_classes=C,
                                   epochs=epochs, max_steps=max_steps,
                                   device="cpu")
    assert got_p.shape == (C, 256) and got_n.shape == (C,)
    assert got_p.dtype == got_n.dtype == np.float32
    np.testing.assert_array_equal(got_n, want_n)
    assert got_n.sum() > 0
    np.testing.assert_allclose(got_p, want_p, rtol=0, atol=5e-4)


@pytest.mark.parametrize("kw", [pytest.param({"wire": "packed_bf16"},
                                             id="kw1")])
def test_calc_prototypes_takes_the_bf16_wire(kw):
    """``wire='packed_bf16'`` folds the images' bfloat16 values, as JAX's
    run with the same wire does: counts exact, prototypes within 5e-4 (the
    forward's tolerance), and not the float32 images' prototypes."""
    model, variables, twin = jax_deeplab_with_twin(12)
    want_p, want_n = jax_calc_prototypes(model, variables, ImageLoader(),
                                         num_classes=C, **kw)
    got_p, got_n = calc_prototypes(twin, ImageLoader(), num_classes=C,
                                   device="cpu", **kw)
    np.testing.assert_array_equal(got_n, want_n)
    np.testing.assert_allclose(got_p, want_p, rtol=0, atol=5e-4)
    f32_p, _ = calc_prototypes(twin, ImageLoader(), num_classes=C,
                               device="cpu")
    assert not np.array_equal(got_p, f32_p)
