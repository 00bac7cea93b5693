"""The convergence gate's CPU slice on the port: the counterpart of the
JAX package's ``tests/test_convergence.py``.

The seg train step learns a learnable-by-construction tree
(``recipes/synthetic_trees.make_learnable_freiburg_tree``: labels are a
function of pixel intensity) from two fixed batches of 4 at 64x128
(layers 1,1,1,1, lr 3e-3, 80 steps), then ``seg_validate`` scores the same
images through the eval protocol (align-corners upsample -> argmax ->
confusion matrix -> nanmean(iu[:11])). The port's step and the JAX step
run side by side: the same batches (the port's dataset and transforms give
the JAX package's arrays on the same tree), the same initial weights (the
JAX test's, ``jax.random.key(0)``, converted), dropout off in both (their
dropout draws cannot be shared). Both are held to the JAX test's bounds,
last loss < 0.2 and mIoU >= 0.8, and the port's mIoU to the JAX run's
within 0.05.

The eval-mode mIoU after 80 steps rests on BatchNorm running statistics
folded from two 4-image batches, and moves with the float summation order
(the thread count) and the initial draw by more than the bound's margin,
while the last loss stays near 0.01: the test pins 4 torch threads, where
the JAX run reads 0.896 and the port 0.894. It takes about two minutes
here and is marked slow, as the JAX test is.

The full-resolution gate runs on the card (``python -m
thermal_semantic_segmentation_torch.recipes.gates convergence --layers
3,4,23,3 --lr 0.001``). Here the full-width step's first gradients are
held to JAX's: in float64, where the two must agree to rounding (JAX
under ``JAX_ENABLE_X64`` in a process of its own, the loss head written
out in float64 because the JAX package's upsample and cross-entropy
compute in float32), and in float32, where either package lands up to a
few hundredths of a tensor's largest value off the float64 step's, so the
tolerance is JAX's own float32 error (a few minutes, marked slow).
"""

import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import flax.linen as fnn  # noqa: E402
import jax  # noqa: E402
from flax import traverse_util  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tests.test_torch_train import (  # noqa: E402
    as_state_dict, jax_grads, no_dropout)
from thermal_semantic_segmentation_tpu.data import (  # noqa: E402
    freiburg as jax_freiburg, transforms as jax_T)
from thermal_semantic_segmentation_tpu.eval.validate import (  # noqa: E402
    seg_validate as jax_seg_validate)
from thermal_semantic_segmentation_tpu.models.deeplab import (  # noqa: E402
    create_deeplab as jax_create_deeplab)
from thermal_semantic_segmentation_tpu.train.seg import (  # noqa: E402
    create_seg_state as jax_create_seg_state,
    make_seg_train_step as jax_make_seg_train_step)
from thermal_semantic_segmentation_torch.data import (  # noqa: E402
    transforms as T)
from thermal_semantic_segmentation_torch.data.freiburg import (  # noqa: E402
    Freiburg)
from thermal_semantic_segmentation_torch.eval.validate import (  # noqa: E402
    seg_validate)
from thermal_semantic_segmentation_torch.models.convert import (  # noqa: E402
    jax_variables_to_state_dict)
from thermal_semantic_segmentation_torch.models.deeplab import (  # noqa: E402
    create_deeplab)
from thermal_semantic_segmentation_torch.recipes.synthetic_trees import (  # noqa: E402,E501
    make_learnable_freiburg_tree)
from thermal_semantic_segmentation_torch.train.seg import (  # noqa: E402
    create_seg_state, make_seg_train_step)

HW = (64, 128)
STEPS, LR = 80, 3e-3
THREADS = 4
MIOU_ATOL = 0.05
FULL_WIDTH, FULL_LR = (3, 4, 23, 3), 1e-3
LOSS_RTOL = 1e-5
GRAD64_RTOL = 1e-7
GRAD32_SLACK = 2.5
OWN_SLACK = 1.25
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def pinned_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    yield
    torch.set_num_threads(before)


def _samples(dataset, transforms, root):
    ds = dataset(root, "train", "IR", transforms=transforms, with_label=True)
    rng = np.random.default_rng(0)
    return [ds.get(i, rng) for i in range(8)]


class _Batches:
    def __init__(self, batches):
        self.batches = batches

    def __iter__(self):
        for im, lab in self.batches:
            yield {"image": im, "label": lab}


@pytest.mark.slow
def test_seg_train_learns_learnable_tree_to_high_miou(tmp_path,
                                                      pinned_threads):
    root = make_learnable_freiburg_tree(str(tmp_path / "freiburg"),
                                        n_train=8, n_test=2, seed=3,
                                        n_bands=3)
    samples = _samples(Freiburg, T.Compose([T.Resize((HW[1], HW[0])),
                                            T.ToArray()]), root)
    jax_samples = _samples(jax_freiburg.Freiburg, jax_T.Compose(
        [jax_T.Resize((HW[1], HW[0])), jax_T.ToArray()]), root)
    for got, want in zip(samples, jax_samples):
        for key in ("image", "label"):
            np.testing.assert_array_equal(got[key], want[key])
    batches = [
        (np.stack([s["image"] for s in samples[k:k + 4]]),
         np.stack([s["label"] for s in samples[k:k + 4]]))
        for k in (0, 4)]

    # the JAX test's model and schedule, dropout off
    model, variables = jax_create_deeplab(
        jax.random.key(0), num_classes=13, num_channels=1,
        layers=(1, 1, 1, 1), image_size=HW)
    # the port's copy first: the JAX step donates the weights' buffers
    start = jax_variables_to_state_dict(jax.tree.map(np.asarray, variables))
    jax_state = jax_create_seg_state(model, variables, learning_rate=LR)
    jax_step = jax_make_seg_train_step(ignore_index=12, label_hw=HW,
                                       base_lr=LR)
    jax_losses = []
    with fnn.intercept_methods(no_dropout):
        for n in range(STEPS):
            im, lab = batches[n % 2]
            jax_state, loss = jax_step(jax_state, jnp.asarray(im),
                                       jnp.asarray(lab))
            jax_losses.append(float(loss))
    jax_miou, _, _ = jax_seg_validate(
        model, jax_state.variables, _Batches(batches), num_classes=13,
        ignore_index=12, label_hw=HW, pad_to_batch=4)

    # the port from the same weights
    net = create_deeplab(0, device="cpu", layers=(1, 1, 1, 1))
    net.load_state_dict(start, strict=True)
    net.layer5.head[0].p = 0.0
    state = create_seg_state(net, learning_rate=LR, device="cpu")
    step = make_seg_train_step(ignore_index=12, label_hw=HW, base_lr=LR,
                               device="cpu")
    tensors = [(torch.from_numpy(im), torch.from_numpy(lab).long())
               for im, lab in batches]
    losses = [float(step(state, *tensors[n % 2])) for n in range(STEPS)]
    miou, val_loss, cls_iu = seg_validate(
        net, _Batches(batches), num_classes=13, ignore_index=12,
        device="cpu")
    print(f"last losses port {losses[-3:]} JAX {jax_losses[-3:]}; mIoU "
          f"port {miou} JAX {jax_miou}")
    assert np.isfinite(val_loss)
    assert jax_losses[-1] < 0.2 and jax_miou >= 0.8
    assert losses[-1] < 0.2, losses[-5:]
    assert miou >= 0.8, (miou, cls_iu, losses[-5:])
    assert abs(miou - jax_miou) <= MIOU_ATOL



def _float64_taps(in_size, out_size):
    """The (out, in) align-corners bilinear matrix, in float64."""
    src = np.arange(out_size) * ((in_size - 1) / (out_size - 1))
    lo = np.clip(np.floor(src).astype(np.int64), 0, in_size - 1)
    hi = np.minimum(lo + 1, in_size - 1)
    m = np.zeros((out_size, in_size))
    np.add.at(m, (np.arange(out_size), lo), 1.0 - (src - lo))
    np.add.at(m, (np.arange(out_size), hi), src - lo)
    return m


def jax_float64_grads(src, dst):
    """The JAX model's first-step gradients in float64, from the float32
    weights, image, label and layers in ``src`` (an ``.npz``) into
    ``dst``; run
    in a process of its own with ``JAX_ENABLE_X64=1``. The JAX package's
    upsample and cross-entropy compute in float32 whatever their input,
    so the loss head is written out here: the align-corners bilinear
    upsample and the mean cross-entropy over the non-ignored pixels."""
    assert jax.config.jax_enable_x64
    data = dict(np.load(src))
    image, label = data.pop("image"), data.pop("label")
    layers = tuple(int(n) for n in data.pop("layers"))
    variables = traverse_util.unflatten_dict(
        {k: v.astype(np.float64) for k, v in data.items()}, sep="/")
    model, _ = jax_create_deeplab(
        jax.random.key(0), num_classes=13, num_channels=1,
        layers=layers, image_size=HW, dtype=jnp.float64, abstract=True)
    valid = (label != 12) & (label >= 0) & (label < 13)

    def loss_fn(params):
        out, _ = model.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            jnp.asarray(image, jnp.float64), train=True,
            mutable=["batch_stats"])
        logits = out["out"]
        up = jnp.einsum("oh,nhwc->nowc",
                        _float64_taps(logits.shape[1], HW[0]), logits)
        up = jnp.einsum("pw,nowc->nopc",
                        _float64_taps(logits.shape[2], HW[1]), up)
        logp = jax.nn.log_softmax(up, axis=-1)
        nll = -jnp.take_along_axis(
            logp, np.where(valid, label, 0)[..., None], axis=-1)[..., 0]
        return jnp.sum(jnp.where(valid, nll, 0.0)) / max(valid.sum(), 1)

    with fnn.intercept_methods(no_dropout):
        loss, grads = jax.jit(jax.value_and_grad(loss_fn))(
            variables["params"])
    flat = traverse_util.flatten_dict(jax.tree.map(np.asarray, grads),
                                      sep="/")
    np.savez(dst, loss=np.asarray(loss), **flat)


def _as_float64_state_dict(params, batch_stats):
    """``as_state_dict`` of float64 ``params``: the converter keeps float32,
    so the float32 value and its float32 remainder cross apart (the
    conversion only moves values) and are summed again."""
    hi = jax.tree.map(lambda a: a.astype(np.float32), params)
    lo = jax.tree.map(lambda a, h: (a - h).astype(np.float32), params, hi)
    return {k: v.astype(np.float64) + r.astype(np.float64)
            for (k, v), r in zip(as_state_dict(hi, batch_stats).items(),
                                 as_state_dict(lo, batch_stats).values())}


@pytest.mark.slow
def test_full_width_gradients_match_jax(tmp_path, pinned_threads):
    """The full-width first step, held to JAX's: from the same weights at
    the gate's lr, dropout off, two images of the learnable tree.

    - The port's float64 gradients agree with JAX's float64 ones (run
      under ``JAX_ENABLE_X64`` in a process of their own), tensor by
      tensor, within 1e-7 of the tensor's largest value, and its float64
      loss with JAX's within 1e-12.
    - Its float32 loss is within 1e-5 of JAX's.
    - Its float32 gradients, against JAX's float32 ones: the median and
      the worst over the tensors within 2.5 times those of JAX's own
      float32 error against JAX's float64 (each tensor's gap is at most
      the sum of the two packages' errors).
    - Its own float32 error against JAX's float64, median and worst,
      within 1.25 times JAX's.
    """
    root = make_learnable_freiburg_tree(str(tmp_path / "freiburg"),
                                        n_train=8, n_test=2, seed=3,
                                        n_bands=3)
    samples = _samples(Freiburg, T.Compose([T.Resize((HW[1], HW[0])),
                                            T.ToArray()]), root)[:2]
    image = np.stack([s["image"] for s in samples])
    label = np.stack([s["label"] for s in samples])
    model, variables = jax_create_deeplab(
        jax.random.key(0), num_classes=13, num_channels=1,
        layers=FULL_WIDTH, image_size=HW)
    variables = jax.tree.map(np.asarray, variables)
    np.savez(tmp_path / "in.npz", image=image, label=label,
             layers=np.asarray(FULL_WIDTH),
             **traverse_util.flatten_dict(variables, sep="/"))
    subprocess.run(
        [sys.executable, "-c",
         "import sys; from tests.test_torch_convergence import "
         "jax_float64_grads; jax_float64_grads(*sys.argv[1:])",
         str(tmp_path / "in.npz"), str(tmp_path / "out.npz")],
        cwd=REPO, check=True, timeout=1800,
        env={**os.environ, "JAX_ENABLE_X64": "1", "JAX_PLATFORMS": "cpu"})
    out = dict(np.load(tmp_path / "out.npz"))
    jax64_loss = float(out.pop("loss"))
    jax64 = _as_float64_state_dict(
        traverse_util.unflatten_dict(out, sep="/"), variables["batch_stats"])
    jax32 = as_state_dict(jax_grads(model, variables, image, label, 1),
                          variables["batch_stats"])
    start = jax_variables_to_state_dict(variables)
    jax_step = jax_make_seg_train_step(ignore_index=12, label_hw=HW,
                                       base_lr=FULL_LR)
    with fnn.intercept_methods(no_dropout):
        _, jax_loss = jax_step(
            jax_create_seg_state(model, variables, learning_rate=FULL_LR),
            jnp.asarray(image), jnp.asarray(label))

    grads, losses = {}, {}
    for dtype in (torch.float32, torch.float64):
        net = create_deeplab(0, device="cpu", layers=FULL_WIDTH)
        net.load_state_dict(start, strict=True)
        net.layer5.head[0].p = 0.0
        net = net.to(dtype)
        state = create_seg_state(net, learning_rate=FULL_LR, device="cpu")
        state.lr_scale = 0.0          # the gradients, no parameter moved
        losses[dtype] = float(make_seg_train_step(
            ignore_index=12, label_hw=HW, base_lr=FULL_LR, device="cpu")(
            state, torch.from_numpy(image).to(dtype),
            torch.from_numpy(label).long()))
        grads[dtype] = {k: p.grad.double().numpy()
                        for k, p in net.named_parameters()}
    np.testing.assert_allclose(losses[torch.float64], jax64_loss,
                               rtol=1e-12)
    np.testing.assert_allclose(losses[torch.float32], float(jax_loss),
                               rtol=LOSS_RTOL)
    assert set(grads[torch.float64]) <= set(jax64)
    err64, err32, port_err, jax_err = {}, {}, {}, {}
    for k in grads[torch.float64]:
        exact = jax64[k]
        scale = np.abs(exact).max() + 1e-30
        err64[k] = np.abs(grads[torch.float64][k] - exact).max() / scale
        err32[k] = np.abs(grads[torch.float32][k] - jax32[k]).max() / scale
        port_err[k] = np.abs(grads[torch.float32][k] - exact).max() / scale
        jax_err[k] = np.abs(jax32[k] - exact).max() / scale
    stats = {name: (np.median(list(e.values())), max(e.values()))
             for name, e in (("port float64 - JAX float64", err64),
                             ("port float32 - JAX float32", err32),
                             ("port float32 - JAX float64", port_err),
                             ("JAX float32 - JAX float64", jax_err))}
    print("first-step gradients, of each tensor's largest (median, max): "
          + "; ".join(f"{k} {m:.3e} {x:.3e}" for k, (m, x) in stats.items()))
    assert max(err64.values()) <= GRAD64_RTOL, max(err64, key=err64.get)
    jax_median, jax_max = stats["JAX float32 - JAX float64"]
    median, worst = stats["port float32 - JAX float32"]
    assert median <= GRAD32_SLACK * jax_median
    assert worst <= GRAD32_SLACK * jax_max
    median, worst = stats["port float32 - JAX float64"]
    assert median <= OWN_SLACK * jax_median
    assert worst <= OWN_SLACK * jax_max
