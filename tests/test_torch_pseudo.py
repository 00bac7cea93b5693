"""The port's pseudo-label generation (train/pseudo.py, data/png.py and the
kernel's plain version at the logits' own size) against the JAX package's
``generate_pseudo_labels`` on the same images and weights.

5 images at batch 4: JAX pads its tail batch to 4, the port runs it at its
own size. The same files are written; hard ids equal outside logit
near-ties (top-2 gap < 1e-5), decoded by PIL from both packages' PNGs, and
the colour PNGs hold the same palette; confidences within one float16 ulp;
soft maps within 5e-4, the forward's tolerance.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from PIL import Image  # noqa: E402

from tests.test_torch_deeplab import (FORWARD_ATOL, HW,  # noqa: E402
                                      jax_deeplab_with_twin)
from thermal_semantic_segmentation_tpu.ops.resize import (  # noqa: E402
    resize_bilinear as jax_resize_bilinear)
from thermal_semantic_segmentation_tpu.train.pseudo import (  # noqa: E402
    generate_pseudo_labels as jax_generate)
from thermal_semantic_segmentation_torch.data.palette import (  # noqa: E402
    freiburg_palette)
from thermal_semantic_segmentation_torch.data.png import (  # noqa: E402
    write_gray_png, write_palette_png)
from thermal_semantic_segmentation_torch.kernels.upsample_argmax import (  # noqa: E402,E501
    launch_plan, upsample_argmax, upsample_argmax_reference)
from thermal_semantic_segmentation_torch.train.pseudo import (  # noqa: E402
    generate_pseudo_labels)

TIE_GAP = 1e-5
BATCHES = (4, 1)


class RaggedLoader:
    """5 seeded images in batches of 4 and 1."""

    def __len__(self):
        return len(BATCHES)

    def __iter__(self):
        rng = np.random.default_rng(11)
        for i, bs in enumerate(BATCHES):
            yield {"image": rng.uniform(0, 1, (bs, *HW, 1)).astype(np.float32),
                   "img_path": [f"dir/im_{i}_{k}.png" for k in range(bs)]}


@pytest.fixture(scope="module")
def tiny():
    return jax_deeplab_with_twin(9)


def _top2_gap(x):
    top2 = np.sort(x, axis=-1)[..., -2:]
    return top2[..., 1] - top2[..., 0]


def decided_pixels(model, variables, batches, flip):
    """Per image name, the pixels whose JAX top-2 gap is at least TIE_GAP:
    of the stride-8 logits, or with ``flip`` of the mirrored-average
    probabilities at input size."""
    out = {}
    for batch in batches:
        x = jnp.asarray(batch["image"])
        if flip:
            def probs(im):
                logits = model.apply(variables, im, train=False)["out"]
                return jax_resize_bilinear(jax.nn.softmax(logits, axis=-1),
                                           *im.shape[1:3])
            score = (probs(x) + probs(x[:, :, ::-1])[:, :, ::-1]) / 2.0
        else:
            score = model.apply(variables, x, train=False)["out"]
        for name, gap in zip(batch["img_path"], _top2_gap(np.asarray(score))):
            out[os.path.basename(name)] = gap >= TIE_GAP
    return out


def assert_pseudo_dirs_match(port_dir, jax_dir, decided, soft):
    """The same files; soft maps within the forward's tolerance; hard ids
    (and the colour PNGs' indices) equal where ``decided``, the colour
    PNGs' palettes equal, confidences within one float16 ulp."""
    names = sorted(os.listdir(jax_dir))
    assert sorted(os.listdir(port_dir)) == names
    assert len(names) == len(decided) * (1 if soft else 3)
    if soft:
        for name in names:
            g, w = np.load(port_dir / name), np.load(jax_dir / name)
            assert g.shape == w.shape and g.shape[0] == 13
            assert g.dtype == w.dtype == np.float32
            np.testing.assert_allclose(g, w, rtol=0, atol=FORWARD_ATOL)
        return
    n_decided = n_pixels = 0
    for name, ok in decided.items():
        stem = name[:-4]
        g, w = Image.open(port_dir / name), Image.open(jax_dir / name)
        assert g.mode == w.mode == "L" and g.size == w.size == ok.shape[::-1]
        ids = np.asarray(g)
        np.testing.assert_array_equal(ids[ok], np.asarray(w)[ok])
        n_decided += int(ok.sum())
        n_pixels += ok.size
        gc = Image.open(port_dir / f"{stem}_color.png")
        wc = Image.open(jax_dir / f"{stem}_color.png")
        assert gc.mode == wc.mode == "P"
        assert gc.getpalette() == wc.getpalette()
        np.testing.assert_array_equal(np.asarray(gc), ids)
        np.testing.assert_array_equal(np.asarray(gc)[ok], np.asarray(wc)[ok])
        gf = np.load(port_dir / f"{stem}_conf.npy")
        wf = np.load(jax_dir / f"{stem}_conf.npy")
        assert gf.dtype == wf.dtype == np.float16 and gf.shape == ok.shape
        ulp = np.spacing(wf).astype(np.float32)
        assert np.all(np.abs(gf.astype(np.float32) - wf.astype(np.float32))
                      <= ulp)
    assert n_decided > 0.9 * n_pixels      # the comparison is not vacuous


@pytest.mark.parametrize("mode", ["hard", "soft", "flip"])
def test_pseudo_labels_match_jax(tiny, tmp_path, mode):
    model, variables, twin = tiny
    soft, flip = mode == "soft", mode == "flip"
    jax_dir, port_dir = tmp_path / "jax", tmp_path / "port"
    n_jax = jax_generate(model, variables, RaggedLoader(),
                         save_path=str(jax_dir), soft=soft, flip=flip,
                         pad_to_batch=4)
    n_port = generate_pseudo_labels(twin, RaggedLoader(),
                                    save_path=str(port_dir), soft=soft,
                                    flip=flip, device="cpu")
    assert n_jax == n_port == 5
    decided = decided_pixels(model, variables, RaggedLoader(), flip)
    assert next(iter(decided.values())).shape == (HW if flip else (9, 17))
    assert_pseudo_dirs_match(port_dir, jax_dir, decided, soft)
    if soft:
        assert np.load(port_dir / "im_1_0.npy").shape == (13, 9, 17)


@pytest.mark.parametrize("shape", [(4, 33, 65, 13), (3, 9, 17, 13)])
def test_identity_size_upsample_argmax_is_softmax_argmax(shape):
    """At out_hw == in_hw the kernel's function is the argmax and the
    max-softmax of the logits themselves (its 2-tap tables are lo = i,
    w_hi = 0); the card's launch at the pseudo-label and prototype shape
    stages 65 columns x pitch 20 per row, 9 rows a block."""
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        shape).astype(np.float32))
    n, h, w, c = shape
    pred, conf = upsample_argmax(x, h, w)          # CPU: the plain version
    want_pred, want_conf = upsample_argmax_reference(x, h, w)
    assert torch.equal(pred, want_pred) and torch.equal(conf, want_conf)
    assert torch.equal(pred, x.argmax(dim=-1).to(torch.int32))
    assert torch.equal(conf, torch.softmax(x, dim=-1).amax(dim=-1))
    if (h, w) == (33, 65):
        plan = launch_plan(n, w, c, h, w)
        assert (plan.tile_w, plan.span, plan.pitch, plan.tile_h) == (
            68, 65, 20, 9)
        assert plan.span * plan.pitch * 4 == 5200 and plan.grid == (1, 4, n)


def test_png_writers_decode_in_pil(tmp_path):
    rng = np.random.default_rng(4)
    ids = rng.integers(0, 256, (37, 300)).astype(np.uint8)
    write_gray_png(str(tmp_path / "g.png"), ids)
    write_palette_png(str(tmp_path / "p.png"), ids % 13, freiburg_palette())
    g, p = Image.open(tmp_path / "g.png"), Image.open(tmp_path / "p.png")
    assert g.mode == "L" and p.mode == "P"
    np.testing.assert_array_equal(np.asarray(g), ids)
    np.testing.assert_array_equal(np.asarray(p), ids % 13)
    assert p.getpalette() == freiburg_palette()
    with pytest.raises(ValueError):
        write_gray_png(str(tmp_path / "bad.png"), np.full((2, 2), 300))
    with pytest.raises(ValueError):
        write_palette_png(str(tmp_path / "bad.png"), ids, [0, 0])


def test_failed_writes_fail_the_run(tiny, tmp_path):
    _, _, twin = tiny
    (tmp_path / "im_0_0.png").mkdir(parents=True)   # a directory in the way
    with pytest.raises(IsADirectoryError):
        generate_pseudo_labels(twin, RaggedLoader(), save_path=str(tmp_path),
                               device="cpu")


class Bf16RaggedLoader(RaggedLoader):
    """RaggedLoader's images rounded to bfloat16 values (float32), as the
    packed_bf16 wire delivers them."""

    def __iter__(self):
        for batch in super().__iter__():
            image = torch.from_numpy(batch["image"]).bfloat16().float()
            yield dict(batch, image=image.numpy())


@pytest.mark.parametrize("kw", [
    pytest.param({"native_encode": True}, id="kw1"),
    pytest.param({"wire": "packed_bf16"}, id="kw2")])
def test_native_encode_and_bf16_wire_match_jax(tiny, tmp_path, kw):
    """``native_encode`` (the C++ encoder's PNGs, or the Python writers
    where it is unavailable) and ``wire='packed_bf16'`` (the images'
    bfloat16 values) against the JAX package's run with the same mode:
    the files of ``test_pseudo_labels_match_jax``, to its tolerances, the
    near-ties taken from the images the model sees."""
    model, variables, twin = tiny
    jax_dir, port_dir = tmp_path / "jax", tmp_path / "port"
    assert jax_generate(model, variables, RaggedLoader(),
                        save_path=str(jax_dir), pad_to_batch=4, **kw) == 5
    assert generate_pseudo_labels(twin, RaggedLoader(),
                                  save_path=str(port_dir), device="cpu",
                                  **kw) == 5
    seen = Bf16RaggedLoader() if "wire" in kw else RaggedLoader()
    decided = decided_pixels(model, variables, seen, False)
    assert_pseudo_dirs_match(port_dir, jax_dir, decided, False)
