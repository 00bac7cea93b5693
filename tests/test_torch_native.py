"""The port's native C++ IO (``data/native_loader.py``, ``csrc/tss_io.cpp``)
against the JAX package's, on the CPU.

Both libraries are built from the same source (the port keeps its own copy
and builds it into its own ``_build/``), so every decoded array and every
encoded file must be byte-equal; the datasets and writers that take the
native path give what the JAX package's give (decoded frames equal) or what
the port's Python writers give (the same pixels). Skipped, as the JAX
package's tests are, where the library cannot be built.
"""

import ctypes
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from thermal_semantic_segmentation_torch.data import native_loader as nl
from thermal_semantic_segmentation_tpu.data import native_loader as jnl

pytestmark = pytest.mark.skipif(not (nl.available() and jnl.available()),
                                reason="native decoder not buildable here")

PORT_SOURCE = nl.SOURCE
JAX_SOURCE = Path(jnl._SRC)


@pytest.fixture(scope="module")
def frames(tmp_path_factory):
    """16-bit IR PNGs, RGB PNGs and a JPEG, from a seed."""
    d = tmp_path_factory.mktemp("frames")
    rng = np.random.default_rng(0)
    out = {"ir": [], "rgb": [], "jpg": []}
    for i in range(3):
        p = str(d / f"ir_{i}.png")
        Image.fromarray(rng.integers(20500, 26500, (41, 123))
                        .astype(np.uint16)).save(p)
        out["ir"].append(p)
        p = str(d / f"rgb_{i}.png")
        Image.fromarray(rng.integers(0, 256, (37, 111, 3))
                        .astype(np.uint8)).save(p)
        out["rgb"].append(p)
    p = str(d / "c.jpg")
    Image.fromarray(rng.integers(0, 256, (24, 31, 3)).astype(np.uint8)).save(
        p, format="JPEG")
    out["jpg"].append(p)
    return out


def test_the_port_builds_its_own_copy_of_the_source():
    """The same C++ source, built into the port's ``_build/`` (not the JAX
    package's ``native/libtss_io.so``) and loaded from there."""
    assert PORT_SOURCE.read_bytes() == JAX_SOURCE.read_bytes()
    lib = nl._load()
    assert Path(lib._name) == nl.library_path()
    assert nl.library_path().parent == nl.BUILD_DIR
    assert "thermal_semantic_segmentation_tpu" not in str(nl.library_path())
    assert isinstance(lib, ctypes.CDLL)


def test_decode_raw_equals_jax_and_pil(frames):
    """Exact: the port's, JAX's and PIL's pixels (the JPEG: the port's and
    JAX's, one libjpeg)."""
    for p in frames["ir"] + frames["rgb"] + frames["jpg"]:
        got = nl.decode_raw(p)
        np.testing.assert_array_equal(got, jnl.decode_raw(p))
        if p.endswith(".png"):
            pil = np.asarray(Image.open(p))
            np.testing.assert_array_equal(got.reshape(pil.shape), pil)


@pytest.mark.parametrize("resize_wh,crop", [((960, 320), (150, 850)),
                                            ((128, 64), (10, 100))])
def test_batch_decodes_equal_jax(frames, resize_wh, crop):
    """Bit-equal float32 IR windows and uint8 RGB crops, at the Freiburg
    sizes and at another, on 1 and 3 threads."""
    for threads in (1, 3):
        got = nl.decode_ir_batch(frames["ir"], resize_wh=resize_wh,
                                 crop=crop, n_threads=threads)
        want = jnl.decode_ir_batch(frames["ir"], resize_wh=resize_wh,
                                   crop=crop, n_threads=threads)
        assert got.dtype == np.float32 and got.shape == want.shape
        np.testing.assert_array_equal(got.view(np.uint32),
                                      want.view(np.uint32))
        got = nl.decode_rgb_batch(frames["rgb"], resize_wh=resize_wh,
                                  crop=crop, n_threads=threads)
        np.testing.assert_array_equal(
            got, jnl.decode_rgb_batch(frames["rgb"], resize_wh=resize_wh,
                                      crop=crop, n_threads=threads))


def test_missing_file_raises(tmp_path):
    with pytest.raises(IOError):
        nl.decode_ir_batch([str(tmp_path / "nope.png")])


@pytest.mark.parametrize("suffix,resize_wh", [(".png", None),
                                              (".png", (70, 32)),
                                              (".jpg", (128, 64)),
                                              (".jpg", None)])
@pytest.mark.parametrize("channels", [1, 3])
def test_encoded_files_equal_jax(tmp_path, suffix, resize_wh, channels):
    """Byte-equal files; a lossless file decodes to the input."""
    rng = np.random.default_rng(1)
    imgs = rng.integers(0, 256, (3, 24, 31, channels)).astype(np.uint8)
    if channels == 1:
        imgs = imgs[..., 0]
    port = [str(tmp_path / f"p{i}{suffix}") for i in range(3)]
    ref = [str(tmp_path / f"j{i}{suffix}") for i in range(3)]
    nl.encode_batch(port, imgs, resize_wh=resize_wh)
    jnl.encode_batch(ref, imgs, resize_wh=resize_wh)
    for a, b, img in zip(port, ref, imgs):
        assert Path(a).read_bytes() == Path(b).read_bytes()
        if suffix == ".png" and resize_wh is None:
            np.testing.assert_array_equal(np.asarray(Image.open(a)), img)


def test_palette_files_equal_jax(tmp_path):
    from thermal_semantic_segmentation_torch.data.palette import (
        freiburg_palette)
    rng = np.random.default_rng(2)
    idx = rng.integers(0, 13, (2, 20, 30)).astype(np.uint8)
    pal = np.asarray(freiburg_palette(), np.uint8).reshape(-1, 3)
    port = [str(tmp_path / f"p{i}.png") for i in range(2)]
    ref = [str(tmp_path / f"j{i}.png") for i in range(2)]
    nl.encode_pal8_batch(port, idx, pal)
    jnl.encode_pal8_batch(ref, idx, pal)
    for a, b, ids in zip(port, ref, idx):
        assert Path(a).read_bytes() == Path(b).read_bytes()
        im = Image.open(a)
        assert im.mode == "P"
        np.testing.assert_array_equal(np.asarray(im), ids)


def test_freiburg_batch_path_equals_jax(tmp_path):
    """``Freiburg(native_decode=True)``: ``get_batch`` and the loader's
    batches equal the JAX package's (the same decoded frames, the same
    transforms and draws); modes without a native path give None."""
    from tests.synthetic import make_freiburg_tree
    from thermal_semantic_segmentation_torch.data import transforms as T
    from thermal_semantic_segmentation_torch.data.freiburg import Freiburg
    from thermal_semantic_segmentation_torch.data.loader import DataLoader
    from thermal_semantic_segmentation_tpu.data import transforms as JT
    from thermal_semantic_segmentation_tpu.data.freiburg import (
        Freiburg as JaxFreiburg)
    from thermal_semantic_segmentation_tpu.data.loader import (
        DataLoader as JaxDataLoader)

    root = make_freiburg_tree(str(tmp_path / "fr"), n_train=5)
    for domain in ("IR", "RGB"):
        ds = Freiburg(root, "train", domain, transforms=T.Compose(
            [T.RandomResizedCrop((128, 64)), T.ToArray()]),
            native_decode=True)
        jds = JaxFreiburg(root, "train", domain, transforms=JT.Compose(
            [JT.RandomResizedCrop((128, 64)), JT.ToArray()]),
            native_decode=True)
        rngs = lambda: [np.random.default_rng(i) for i in range(3)]  # noqa
        got, want = ds.get_batch([0, 2, 4], rngs()), jds.get_batch(
            [0, 2, 4], rngs())
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g["image"], w["image"])
            np.testing.assert_array_equal(g["label"], w["label"])
        batches = list(DataLoader(ds, 2, shuffle=True, drop_last=False,
                                  seed=1))
        want = list(JaxDataLoader(jds, 2, shuffle=True, drop_last=False,
                                  seed=1))
        assert [b["image"].shape for b in batches] == [
            b["image"].shape for b in want]
        for g, w in zip(batches, want):
            np.testing.assert_array_equal(g["image"], w["image"])
    assert Freiburg(root, "train", "IR", transforms=T.ToArray(),
                    native_decode=True, segmentation_mode=True).get_batch(
        [0], [np.random.default_rng(0)]) is None


def test_native_pseudo_label_files_equal_the_python_writer(tmp_path):
    """``generate_pseudo_labels(native_encode=True)``: the id PNG, the
    palette PNG and the confidences decode to what the Python writers
    wrote."""
    from thermal_semantic_segmentation_torch.models.deeplab import (
        create_deeplab)
    from thermal_semantic_segmentation_torch.train.pseudo import (
        generate_pseudo_labels)
    model = create_deeplab(0, device="cpu", layers=(1, 1, 1, 1))
    rng = np.random.default_rng(8)
    batches = [{"image": rng.random((2, 32, 64, 1), dtype=np.float32),
                "img_path": [f"im_{i}_{k}.png" for k in range(2)]}
               for i in range(2)]
    for native, sub in ((False, "py"), (True, "nat")):
        assert generate_pseudo_labels(model, batches,
                                      save_path=str(tmp_path / sub),
                                      native_encode=native,
                                      device="cpu") == 4
    for name in (f"im_{i}_{k}" for i in range(2) for k in range(2)):
        for f in (f"{name}.png", f"{name}_color.png"):
            a, b = (Image.open(tmp_path / s / f) for s in ("py", "nat"))
            assert a.mode == b.mode
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
            np.testing.assert_array_equal(np.asarray(a.convert("RGB")),
                                          np.asarray(b.convert("RGB")))
        np.testing.assert_array_equal(
            np.load(tmp_path / "py" / f"{name}_conf.npy"),
            np.load(tmp_path / "nat" / f"{name}_conf.npy"))


def test_native_translator_frames_equal_the_python_writer(tmp_path):
    """``translate_batches(native_encode=True)``: PNG frames that decode to
    the Python writer's pixels."""
    from thermal_semantic_segmentation_torch.cli.translator import (
        translate_batches)
    from thermal_semantic_segmentation_torch.models import factory
    g = factory.init_gan_net(factory.unet_32(ngf=4, output_nc=1), 0,
                             device="cpu")
    rng = np.random.default_rng(0)
    images = rng.uniform(-1, 1, (3, 32, 64, 3)).astype(np.float32)
    for native, sub in ((False, "py"), (True, "nat")):
        batches = [{"image": images, "img_path": [
            str(tmp_path / sub / f"{k}.png") for k in range(3)]}]
        s = translate_batches(g, batches, denormalize=[0.5],
                              save_hw=(40, 72), suffix="", device="cpu",
                              native_encode=native)
        assert s["images"] == 3
    for k in range(3):
        a, b = (np.asarray(Image.open(tmp_path / s / f"{k}.png"))
                for s in ("py", "nat"))
        assert a.shape == (40, 72)
        np.testing.assert_array_equal(a, b)
