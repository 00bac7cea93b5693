"""The port's device augmentation (``ops/augment.py``) against the JAX
package's, on the CPU.

The resampler is given JAX's own crop parameters (its ``_sample_crop_params``
and flip draw from the same key as its ``random_resized_crop_flip``), so the
two must agree: images within 1e-5 (float32 sums of two-tap lerps in another
order), labels exactly. The port's sampler draws from a ``torch.Generator``
and JAX's from a key, so it is held to its rule (hypothesis) and to JAX's
distribution: the means of area share, aspect and flips over 4096 draws
within 3 standard errors of JAX's.
"""

import math

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from thermal_semantic_segmentation_torch.ops import augment as port
from thermal_semantic_segmentation_tpu.ops import augment as ref

RATIO = (1.5, 8.0 / 3.0)
SCALE = (0.5, 1.0)


def _jax_params(key, b, in_hw, scale=SCALE, ratio=RATIO, flip_p=0.5):
    """The crop parameters and flips JAX's ``random_resized_crop_flip``
    draws from ``key`` for a batch of ``b``, as numpy arrays."""
    @jax.jit
    def draw(key):
        keys = jax.random.split(key, b + 1)
        crops = jax.vmap(lambda k: ref._sample_crop_params(
            k, in_hw, scale, ratio))(keys[:b])
        return (*crops, jax.random.uniform(keys[b], (b,)) < flip_p)
    top, left, h, w, flip = draw(key)
    return {"top": np.asarray(top), "left": np.asarray(left),
            "h": np.asarray(h), "w": np.asarray(w),
            "flip": np.asarray(flip)}


@pytest.mark.parametrize("b,in_hw,out_hw,seed", [
    (3, (40, 90), (32, 64), 0),
    (2, (320, 700), (256, 512), 1),     # the loader's frames -> 256x512
    (4, (33, 47), (20, 30), 2),
])
def test_resampler_matches_jax_at_jax_params(b, in_hw, out_hw, seed):
    """Images within 1e-5 of JAX's ``random_resized_crop_flip``, labels
    exact; the normalisation is ``(x - mean) / std`` of those images."""
    rng = np.random.default_rng(seed)
    images = rng.random((b, *in_hw, 1), dtype=np.float32)
    labels = rng.integers(0, 13, (b, *in_hw)).astype(np.int32)
    key = jax.random.key(seed)
    want, want_lab = jax.jit(ref.random_resized_crop_flip,
                             static_argnames="out_hw")(
        key, jnp.asarray(images), labels=jnp.asarray(labels), out_hw=out_hw)
    params = {k: torch.from_numpy(np.array(v))
              for k, v in _jax_params(key, b, in_hw).items()}
    got, got_lab = port.resized_crop_flip(
        torch.from_numpy(images), params, out_hw,
        labels=torch.from_numpy(labels))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)
    np.testing.assert_array_equal(got_lab.numpy(), np.asarray(want_lab))
    assert got_lab.dtype == torch.int32
    normed, _ = port.resized_crop_flip(
        torch.from_numpy(images), params, out_hw, mean=torch.tensor([0.5]),
        std=torch.tensor([0.25]))
    torch.testing.assert_close(normed, (got - 0.5) / 0.25, rtol=0, atol=0)


def test_identity_crop_and_flip_recover_the_input():
    """scale (1, 1) at the input's own aspect and size is the identity
    (half-pixel centres), and a certain flip mirrors it (exact to 1e-6)."""
    images = torch.rand((2, 32, 64, 1), generator=torch.Generator()
                        .manual_seed(0))
    for flip_p, want in ((0.0, images), (1.0, images.flip(2))):
        out, _ = port.random_resized_crop_flip(
            torch.Generator().manual_seed(1), images, out_hw=(32, 64),
            scale=(1.0, 1.0), ratio=(2.0, 2.0), flip_p=flip_p)
        torch.testing.assert_close(out, want, rtol=0, atol=1e-6)


@settings(max_examples=60, deadline=None)
@given(h=st.integers(8, 400), w=st.integers(8, 400),
       scale_lo=st.floats(0.05, 1.0), scale_span=st.floats(0.0, 1.0),
       ratio_lo=st.floats(0.2, 4.0), ratio_span=st.floats(1.0, 3.0),
       seed=st.integers(0, 2**31 - 1))
def test_sampler_rule(h, w, scale_lo, scale_span, ratio_lo, ratio_span,
                      seed):
    """Every crop lies inside the frame; a sampled crop's area share and
    aspect lie in the ranges up to the rounding of h and w (each within
    0.5 of its real value); otherwise it is exactly JAX's central-crop
    fallback."""
    scale = (scale_lo, min(scale_lo + scale_span, 1.0))
    ratio = (ratio_lo, ratio_lo * ratio_span)
    p = port.sample_crop_params(torch.Generator().manual_seed(seed), 64,
                                (h, w), scale, ratio)
    top, left, ch, cw = (p[k].double().numpy()
                         for k in ("top", "left", "h", "w"))
    assert (ch >= 1).all() and (cw >= 1).all()
    assert (top >= 0).all() and (left >= 0).all()
    assert (top + ch <= h).all() and (left + cw <= w).all()
    assert (top == np.floor(top)).all() and (left == np.floor(left)).all()
    in_ratio = w / h
    if in_ratio < min(ratio):
        fw, fh = w, round(w / min(ratio))
    elif in_ratio > max(ratio):
        fh, fw = h, round(h * max(ratio))
    else:
        fw, fh = w, h
    fallback = ((ch == fh) & (cw == fw) & (top == (h - fh) // 2)
                & (left == (w - fw) // 2))
    area, eps = h * w, 1e-4
    sampled = ~fallback
    hi_area = (cw + 0.5) * (ch + 0.5)
    lo_area = (cw - 0.5) * (ch - 0.5)
    assert (hi_area[sampled] >= scale[0] * area * (1 - eps)).all()
    assert (lo_area[sampled] <= scale[1] * area * (1 + eps)).all()
    assert ((cw + 0.5)[sampled] / (ch - 0.5)[sampled]
            >= ratio[0] * (1 - eps)).all()
    assert ((cw - 0.5)[sampled] / (ch + 0.5)[sampled]
            <= ratio[1] * (1 + eps)).all()


def test_sampler_falls_back_to_the_central_crop():
    """No candidate can fit (aspect 10 on a square): every sample is the
    central crop of JAX's fallback, aspect clamped to 10."""
    p = port.sample_crop_params(torch.Generator().manual_seed(0), 5,
                                (100, 100), (1.0, 1.0), (10.0, 10.0))
    assert p["h"].tolist() == [10.0] * 5 and p["w"].tolist() == [100.0] * 5
    assert p["top"].tolist() == [45.0] * 5 and p["left"].tolist() == [0.0] * 5
    want = ref._sample_crop_params(jax.random.key(0), (100, 100), (1.0, 1.0),
                                   (10.0, 10.0))
    assert [float(x) for x in want] == [45.0, 0.0, 10.0, 100.0]


def test_sampler_distribution_matches_jax():
    """Over 4096 draws at the train recipe's ranges on the loader's 320x700
    frames, the means of the area share, the aspect and the flips lie
    within 3 standard errors (of the two means' difference) of JAX's."""
    n, in_hw = 4096, (320, 700)
    p = port.sample_crop_params(torch.Generator().manual_seed(0), n, in_hw)
    j = _jax_params(jax.random.key(0), n, in_hw)

    def stats(h, w, flip):
        h, w = np.asarray(h, np.float64), np.asarray(w, np.float64)
        return {"area": h * w / (in_hw[0] * in_hw[1]), "aspect": w / h,
                "flip": np.asarray(flip, np.float64)}

    got = stats(p["h"].numpy(), p["w"].numpy(), p["flip"].numpy())
    want = stats(j["h"], j["w"], j["flip"])
    for k in got:
        se = math.sqrt(got[k].var(ddof=1) / n + want[k].var(ddof=1) / n)
        assert abs(got[k].mean() - want[k].mean()) <= 3 * se, (
            k, got[k].mean(), want[k].mean(), se)


def test_ir_window_normalize_is_exact():
    raw = np.random.default_rng(3).integers(20000, 27000, (4, 33, 47))
    raw = raw.astype(np.float32)
    raw.flat[:5] = [20000.0, 21800.0, 23400.0, 25000.0, 30000.0]
    got = port.ir_window_normalize(torch.from_numpy(raw)).numpy()
    want = np.asarray(ref.ir_window_normalize(jnp.asarray(raw)))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got.flat[:5], [0.0, 0.0, 0.5, 1.0, 1.0],
                               atol=1e-6)
