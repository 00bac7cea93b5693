"""The port's PIL operations on arrays (``data/image.py``) against Pillow,
bit for bit: ``resize`` (BICUBIC, BILINEAR, NEAREST in 'L', 'RGB', 'I;16'
and 'F', each axis reduced and enlarged, one axis unchanged), the 'I;16'
overshoot rule, ``convert``, ``crop`` (also outside the image),
``flip_left_right`` and the three ``ImageEnhance`` blends."""

import io

import numpy as np
import pytest
from PIL import Image, ImageEnhance

from thermal_semantic_segmentation_torch.data import image as im
from thermal_semantic_segmentation_torch.data import png
from thermal_semantic_segmentation_torch.data.freiburg import RAW_SIZE

PIL_FILTER = {im.BICUBIC: Image.BICUBIC, im.BILINEAR: Image.BILINEAR,
              im.NEAREST: Image.NEAREST}
MODES = ("L", "RGB", "I;16", "F")
SRC_HW = (23, 41)
# (out_h, out_w): each axis reduced and enlarged, mixed, one unchanged
OUT_HW = [(11, 17), (47, 90), (11, 90), (47, 17), (23, 64), (9, 41),
          (1, 3)]


def _image(mode: str, hw, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if mode == "L":
        return rng.integers(0, 256, hw).astype(np.uint8)
    if mode == "RGB":
        return rng.integers(0, 256, (*hw, 3)).astype(np.uint8)
    if mode == "I;16":
        return rng.integers(0, 65536, hw).astype(np.uint16)
    return (rng.random(hw) * 4 - 1.5).astype(np.float32)


def _pil_resize(arr, out_wh, resample):
    return np.asarray(Image.fromarray(arr).resize(out_wh,
                                                  PIL_FILTER[resample]))


def _same(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("out_hw", OUT_HW, ids=lambda hw: f"{hw[0]}x{hw[1]}")
@pytest.mark.parametrize("resample", [im.BICUBIC, im.BILINEAR, im.NEAREST])
@pytest.mark.parametrize("mode", MODES)
def test_resize_matches_pil(mode, resample, out_hw):
    arr = _image(mode, SRC_HW)
    assert im.mode_of(arr) == Image.fromarray(arr).mode
    out_wh = (out_hw[1], out_hw[0])
    _same(im.resize(arr, out_wh, resample), _pil_resize(arr, out_wh,
                                                        resample))


def test_i16_overshoot_keeps_the_low_byte():
    """PIL's 'I;16' BICUBIC stores a rounded sum over 65535 as its low
    byte under a saturated high byte (68189 -> 0xFF5D = 65373), and a
    negative sum as 0: not the float result clipped."""
    edge = np.zeros((6, 12), np.uint16)
    edge[:, 6:] = 65535
    edge[:, 9:] = 20000
    out_wh = (31, 6)
    got = im.resize(edge, out_wh, im.BICUBIC)
    _same(got, _pil_resize(edge, out_wh, im.BICUBIC))
    xmin, _, w = im.coefficients(12, 31, im.BICUBIC)
    idx = np.minimum(xmin[:, None] + np.arange(w.shape[1]), 11)
    total = (edge[0][idx] * w).sum(1)
    exact = np.trunc(total + np.copysign(0.5, total))  # half away from 0
    over = exact > 65535
    assert over.any() and (exact < 0).any()
    np.testing.assert_array_equal(
        got[0][over], 0xFF00 | (exact[over].astype(np.int64) & 0xFF))
    assert (got[0][exact < 0] == 0).all()
    assert (got[0][over] < 65535).any()     # not a clip


@pytest.mark.parametrize("src_hw", [(320, 960), (256, 640), (330, 1000)])
def test_raw_size_resize_of_ir_frames(src_hw):
    """``load_ir_image``'s resize to RAW_SIZE: a 320x960 frame (the
    identity) and frames that reduce or enlarge."""
    arr = _image("I;16", src_hw, seed=1) // 3 + 20000
    _same(im.resize(arr, RAW_SIZE, im.BICUBIC),
          _pil_resize(arr, RAW_SIZE, im.BICUBIC))


@pytest.mark.parametrize("src,mode", [("RGB", "L"), ("RGBA", "L"),
                                      ("RGBA", "RGB"), ("LA", "L"),
                                      ("LA", "RGB"), ("L", "RGB"),
                                      ("1", "L"), ("1", "RGB"),
                                      ("P", "RGB"), ("P", "L"),
                                      ("RGB", "RGB")])
def test_convert_matches_pil(src, mode):
    rng = np.random.default_rng(2)
    shape = {"RGB": (9, 13, 3), "RGBA": (9, 13, 4), "LA": (9, 13, 2)}.get(
        src, (9, 13))
    palette = None
    if src == "1":
        arr = rng.integers(0, 2, shape).astype(bool)
        pil = Image.fromarray(arr)
    elif src == "P":        # through a PNG of 5 colours, indices past them
        idx = rng.integers(0, 8, shape).astype(np.uint8)
        pal = rng.integers(0, 256, 15).astype(np.uint8)
        data = png.palette_png_bytes(idx, pal)
        pil = Image.open(io.BytesIO(data))
        arr, palette = png.read_png(data)
    else:
        arr = rng.integers(0, 256, shape).astype(np.uint8)
        pil = Image.fromarray(arr, mode=src)
    _same(im.convert(arr, mode, palette), np.asarray(pil.convert(mode)))


@pytest.mark.parametrize("box", [(0, 0, 10, 10), (5, 3, 40, 22),
                                 (-3, -2, 7, 9), (30, 15, 45, 30),
                                 (50, 40, 60, 45), (4, 4, 4, 9)])
@pytest.mark.parametrize("mode", ["L", "RGB", "F"])
def test_crop_and_flip_match_pil(mode, box):
    arr = _image(mode, SRC_HW, seed=3)
    _same(im.crop(arr, box), np.asarray(Image.fromarray(arr).crop(box)))
    _same(im.flip_left_right(arr), np.asarray(
        Image.fromarray(arr).transpose(Image.FLIP_LEFT_RIGHT)))


ENHANCERS = {"brightness": (im.enhance_brightness, ImageEnhance.Brightness),
             "contrast": (im.enhance_contrast, ImageEnhance.Contrast),
             "color": (im.enhance_color, ImageEnhance.Color)}


@pytest.mark.parametrize("name", sorted(ENHANCERS))
@pytest.mark.parametrize("mode", ["L", "RGB"])
def test_enhancers_match_pil(mode, name):
    """Interpolating (0 < f < 1) and extrapolating (f > 1, clipped)
    factors, the identity 1 and the degenerate image 0."""
    ours, theirs = ENHANCERS[name]
    arr = _image(mode, SRC_HW, seed=4)
    for f in (0.0, 0.3, 0.6123456789, 1.0, 1.2, 1.4, 1.7, 2.5):
        _same(ours(arr, f),
              np.asarray(theirs(Image.fromarray(arr)).enhance(f)))


def test_open_image_reads_png_and_names_non_png(tmp_path):
    """``open_image`` reads PNG itself (converted on request) and leaves
    other formats to PIL."""
    rgb = _image("RGB", SRC_HW, seed=5)
    path = tmp_path / "a.png"
    Image.fromarray(rgb).save(path)
    _same(im.open_image(str(path)), rgb)
    _same(im.open_image(str(path), "L"), np.asarray(
        Image.fromarray(rgb).convert("L")))
    jpg = tmp_path / "a.jpg"
    Image.fromarray(rgb).save(jpg)
    _same(im.open_image(str(jpg)), np.asarray(Image.open(jpg)))


@pytest.mark.parametrize("in_size,out_size", [(512, 700), (700, 512),
                                              (41, 41)])
def test_weight_matrix_is_the_float_pass(in_size, out_size):
    """``weight_matrix`` lays ``coefficients`` out dense: each row sums to
    1 and an 'F' pass equals its product within float32 rounding."""
    m = im.weight_matrix(in_size, out_size)
    np.testing.assert_allclose(m.sum(1), 1.0, rtol=0, atol=1e-12)
    x = np.random.default_rng(7).random((3, in_size)).astype(np.float32)
    np.testing.assert_allclose(im.resize(x, (out_size, 3)), x @ m.T,
                               rtol=0, atol=1e-6)
