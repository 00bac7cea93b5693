"""Seeded synthetic Freiburg trees for the accuracy gates, written with the
port's PNG writers (``data/png.py``, no PIL).

The counterparts of the JAX repo's ``tests/synthetic.py`` tree makers
(``make_learnable_freiburg_tree``, ``make_selftrain_freiburg_tree``,
``make_gan_freiburg_tree``): from the same arguments and seed they write
the same files, whose pixels decode equal (tests/test_torch_gates.py).
The random draws are the same numpy calls in the same order.

Layout (the reference directory grammar):
  train/seq_00_day/00/fl_ir_aligned/NNNN.png   (16-bit IR)
  train/seq_00_day/00/fl_rgb/NNNN.png          (RGB)
  train/seq_00_day/00/fl_rgb_labels/NNNN.png   (8-bit class ids)
  test/day/ImagesIR/NNNN_ir.png + test/day/SegmentationClass/NNNN_rgb.npy
"""

from __future__ import annotations

import os

import numpy as np

from ..data.png import write_gray16_png, write_gray_png, write_rgb_png

IR_MIN, IR_MAX = 21800.0, 25000.0      # the radiometric window (data/freiburg)


def _write(path: str, pixels: np.ndarray) -> None:
    """``pixels`` as PIL's ``Image.fromarray(pixels).save(path)`` would
    store them: uint16 (H, W) as a 16-bit grey PNG, uint8 (H, W) grey,
    uint8 (H, W, 3) RGB."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    if pixels.dtype == np.uint16:
        write_gray16_png(path, pixels)
    elif pixels.ndim == 3:
        write_rgb_png(path, pixels)
    else:
        write_gray_png(path, pixels)


def _save_rgb(path, rng, shape=(40, 120)):
    _write(path, rng.integers(0, 255, size=(*shape, 3)).astype(np.uint8))


def _save_test_label(root: str, i: int, label: np.ndarray) -> None:
    path = os.path.join(root, "test", "day", "SegmentationClass",
                        f"{i:04d}_rgb.npy")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.save(path, label)


def _test_ir_path(root: str, i: int) -> str:
    return os.path.join(root, "test", "day", "ImagesIR", f"{i:04d}_ir.png")


def _banded_class_map(rng, shape, n_classes=13, n_bands=6,
                      boundary_ignore=10, ignore_index=12, classes=None,
                      alphas=None):
    """(label, bands): piecewise-constant vertical class bands (distinct
    classes, random order and widths unless ``classes`` fixes the order),
    and the label with an ``ignore_index`` strip over each interior
    boundary. The protocol's resizes interpolate across a boundary into
    other classes' intensity slots; the strip keeps those pixels out of
    the loss and the confusion matrix."""
    h, w = shape
    if classes is not None:
        order = np.asarray(classes)
    else:
        order = rng.choice(n_classes, size=min(n_bands, n_classes),
                           replace=False)
    if alphas is None:
        alphas = np.full(len(order), 5.0)
    widths = rng.dirichlet(alphas) * w
    edges = np.concatenate([[0], np.round(np.cumsum(widths))]).astype(int)
    edges[-1] = w
    bands = np.zeros((h, w), np.uint8)
    for k, cls in enumerate(order):
        bands[:, edges[k]:edges[k + 1]] = cls
    label = bands.copy()
    half = boundary_ignore // 2
    for e in edges[1:-1]:
        label[:, max(e - half, 0):e + half] = ignore_index
    return label, bands


def _ir_from_classes(rng, label, n_classes=13, noise=30.0):
    """Class k -> a raw IR value at the centre of slot k of the radiometric
    window, plus N(0, noise): the windowed pixel value (k + 0.5) /
    n_classes identifies the class."""
    span = (IR_MAX - IR_MIN) / n_classes
    raw = IR_MIN + (label.astype(np.float32) + 0.5) * span
    raw = raw + rng.normal(0, noise, size=label.shape).astype(np.float32)
    return np.clip(raw, IR_MIN, IR_MAX).astype(np.uint16)


def make_learnable_freiburg_tree(root: str, n_train: int = 24,
                                 n_test: int = 8, seed: int = 0,
                                 hw=(320, 960), n_classes: int = 13,
                                 n_bands: int = 6) -> str:
    """A tree whose labels follow from the IR intensity (the convergence
    gate's): a segmenter must reach ~1.0 mIoU on it. The default ``hw`` is
    the loader's raw size, so the loader's resize is the identity. Every
    class appears in the test labels (a class absent from them but
    predicted scores IoU 0)."""
    rng = np.random.default_rng(seed)
    base = os.path.join(root, "train", "seq_00_day", "00")
    for i in range(n_train):
        label, bands = _banded_class_map(rng, hw, n_classes, n_bands)
        _write(os.path.join(base, "fl_ir_aligned", f"{i:04d}.png"),
               _ir_from_classes(rng, bands, n_classes))
        _save_rgb(os.path.join(base, "fl_rgb", f"{i:04d}.png"), rng, hw)
        _write(os.path.join(base, "fl_rgb_labels", f"{i:04d}.png"), label)
    for i in range(n_test):
        cls = [(n_bands * i + j) % n_classes for j in range(n_bands)]
        label, bands = _banded_class_map(rng, hw, n_classes, n_bands,
                                         classes=rng.permutation(cls))
        _write(_test_ir_path(root, i), _ir_from_classes(rng, bands,
                                                        n_classes))
        _save_test_label(root, i, label)
    return root


def make_selftrain_freiburg_tree(root: str, n_train: int = 256,
                                 n_test: int = 8, seed: int = 0,
                                 hw=(320, 960), n_classes: int = 13,
                                 n_bands: int = 3,
                                 translation_name: str =
                                 "synthetic_translation",
                                 source_noise_u8: float = 2.0,
                                 target_shift_slots: float = 0.35,
                                 target_noise_slots: float = 0.25) -> str:
    """A tree with a constructed domain gap (the self-training gate's).

    SOURCE: "translated" 8-bit frames under
    ``<translation_name>/seq_00_day/00/fl_rgb/``, class k at intensity
    (k + 0.5) / n_classes * 255 with small noise, in the post-crop
    geometry (columns 150:850 of the 960-wide raw) the translator writes.
    TARGET: the IR frames of the train and test splits, the same rule with
    every band shifted by ``target_shift_slots`` of a class slot and
    ``target_noise_slots`` of per-pixel noise: a source-trained model
    degrades on the target, and self-training has to move its boundaries.
    """
    rng = np.random.default_rng(seed)
    slot = (IR_MAX - IR_MIN) / n_classes

    def target_ir(bands):
        raw = IR_MIN + (bands.astype(np.float32) + 0.5
                        + target_shift_slots) * slot
        raw = raw + rng.normal(0, target_noise_slots * slot,
                               size=bands.shape).astype(np.float32)
        return np.clip(raw, IR_MIN, IR_MAX).astype(np.uint16)

    def source_u8(bands):
        val = (bands.astype(np.float32) + 0.5) * (255.0 / n_classes)
        val = val + rng.normal(0, source_noise_u8, size=bands.shape)
        return np.clip(np.round(val), 0, 255).astype(np.uint8)

    base = os.path.join(root, "train", "seq_00_day", "00")
    tbase = os.path.join(root, translation_name, "seq_00_day", "00")
    for i in range(n_train):
        label, bands = _banded_class_map(rng, hw, n_classes, n_bands)
        _write(os.path.join(base, "fl_ir_aligned", f"{i:04d}.png"),
               target_ir(bands))
        _write(os.path.join(base, "fl_rgb_labels", f"{i:04d}.png"), label)
        _save_rgb(os.path.join(base, "fl_rgb", f"{i:04d}.png"), rng, hw)
        c0, c1 = round(150 * hw[1] / 960), round(850 * hw[1] / 960)
        _write(os.path.join(tbase, "fl_rgb", f"{i:04d}.png"),
               source_u8(bands[:, c0:c1]))
    for i in range(n_test):
        cls = [(n_bands * i + j) % n_classes for j in range(n_bands)]
        label, bands = _banded_class_map(rng, hw, n_classes, n_bands,
                                         classes=rng.permutation(cls))
        _write(_test_ir_path(root, i), target_ir(bands))
        _save_test_label(root, i, label)
    return root


# distinct saturated hues, one per band index (the GAN gate's tree)
GAN_PALETTE = np.array([[200, 40, 40], [40, 200, 40], [40, 80, 220],
                        [220, 200, 40], [160, 40, 200]], np.float32)


def _gan_band_frame(rng, hw, n_bands, alphas):
    """(label, bands) of one GAN-gate frame: the band layout is drawn over
    the columns every Freiburg path keeps (150:850 of 960 after the
    resize, data/freiburg.py), and the outermost bands are extended into
    the cropped margins, so no class is cropped away."""
    h, w = hw
    c0 = int(round(w * 150 / 960))
    c1 = int(round(w * 850 / 960))
    label_v, bands_v = _banded_class_map(rng, (h, c1 - c0),
                                         n_classes=n_bands, n_bands=n_bands,
                                         classes=np.arange(n_bands),
                                         alphas=alphas)

    def extend(a):
        return np.hstack([np.repeat(a[:, :1], c0, axis=1), a,
                          np.repeat(a[:, -1:], w - c1, axis=1)])

    return extend(label_v), extend(bands_v)


def _gan_ir(rng, bands, hw, span, noise_slots):
    raw = (IR_MIN + (bands.astype(np.float32) + 0.5) * span
           + rng.normal(0, noise_slots * span, hw).astype(np.float32))
    return np.clip(raw, IR_MIN, IR_MAX).astype(np.uint16)


def make_gan_freiburg_tree(root: str, n_train: int = 512, n_test: int = 0,
                           seed: int = 0, hw=(320, 960), n_bands: int = 5,
                           noise_slots: float = 0.15,
                           rgb_noise: float = 3.0) -> str:
    """A tree of pixel-aligned RGB/IR pairs whose colour-to-intensity map
    an unpaired CycleGAN must recover (the GAN gate's).

    Every frame is vertical bands in the fixed class order 0..n_bands-1:
    RGB paints band k in palette colour k, IR at intensity slot k. Band
    k's expected width grows with k (dirichlet alphas 4 + 2k): that
    width-to-brightness law survives the training flip and breaks the
    permutation symmetry the unpaired losses cannot see, so the aligned
    map is the only optimum. The optional test split is built the same way
    from ``seed + 1``, labelled with the band classes."""
    rng = np.random.default_rng(seed)
    base = os.path.join(root, "train", "seq_00_day", "00")
    span = (IR_MAX - IR_MIN) / n_bands
    alphas = 4.0 + 2.0 * np.arange(n_bands)
    for i in range(n_train):
        label, bands = _gan_band_frame(rng, hw, n_bands, alphas)
        ir = _gan_ir(rng, bands, hw, span, noise_slots)
        rgb = (GAN_PALETTE[bands]
               + rng.normal(0, rgb_noise, (*hw, 3)).astype(np.float32))
        rgb = np.clip(rgb, 0, 255).astype(np.uint8)
        for sub, arr in (("fl_ir_aligned", ir), ("fl_rgb", rgb),
                         ("fl_rgb_labels", label)):
            _write(os.path.join(base, sub, f"{i:04d}.png"), arr)
    rng_t = np.random.default_rng(seed + 1)
    for i in range(n_test):
        label, bands = _gan_band_frame(rng_t, hw, n_bands, alphas)
        _write(_test_ir_path(root, i),
               _gan_ir(rng_t, bands, hw, span, noise_slots))
        _save_test_label(root, i, label)
    return root
