"""The port's ``data/triple_transforms.py`` against the JAX package's: the
same (image, label, contour) triples from the same numpy generator, exactly
(both run the same PIL resamples on the same draws), and the reference's
first-element normalisation of a 1-channel contour."""

import numpy as np
import pytest
from PIL import Image

from thermal_semantic_segmentation_torch.data import triple_transforms as TT
from thermal_semantic_segmentation_tpu.data import (
    triple_transforms as JTT)


def _pipeline(tt):
    return tt.TripleCompose([
        tt.Resize((200, 100)),
        tt.RandomResizedCrop((64, 128), scale=(0.5, 1.0), ratio=(1.5, 8 / 3)),
        tt.RandomCrop((120, 60)),
        tt.RandomHorizontalFlip(),
        tt.ToArray(),
        tt.GeneralNormalize((0.5, 0.4, 0.3), (0.25, 0.2, 0.1)),
    ])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_triples_equal_jax(seed):
    rng = np.random.default_rng(seed)
    image = Image.fromarray(rng.integers(0, 256, (90, 170, 3))
                            .astype(np.uint8))
    label = Image.fromarray(rng.integers(0, 13, (90, 170)).astype(np.uint8),
                            mode="L")
    contour = Image.fromarray(rng.integers(0, 256, (90, 170))
                              .astype(np.uint8), mode="L")
    got = _pipeline(TT)(np.random.default_rng(seed + 10), image, label,
                        contour)
    want = _pipeline(JTT)(np.random.default_rng(seed + 10), image, label,
                          contour)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    img, lab, con = got
    assert img.shape == (60, 120, 3) and con.shape == (60, 120, 1)
    assert np.asarray(lab).shape == (60, 120)


def test_contour_rides_the_image_path():
    """A contour equal to the image stays equal to it through the random
    geometry (one draw shared), and a missing contour stays None."""
    rng = np.random.default_rng(4)
    arr = rng.integers(0, 256, (50, 80)).astype(np.uint8)
    image = Image.fromarray(arr, mode="L")
    tf = TT.TripleCompose([TT.RandomResizedCrop((32, 48)),
                           TT.RandomHorizontalFlip(), TT.ToArray()])
    img, lab, con = tf(np.random.default_rng(1), image, None,
                       Image.fromarray(arr, mode="L"))
    np.testing.assert_array_equal(img, con)
    assert lab is None
    assert tf(np.random.default_rng(1), image)[2] is None
