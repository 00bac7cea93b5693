"""The port's self-training step and its ops (train/self_train.py,
ops/resize.resize_nearest and sample_bilinear_at, losses
.reverse_cross_entropy, ops/class_means on the kernel's classes) against
the JAX package, on the same numpy-seeded inputs.

The step runs on a tiny DeepLabV2 (layers 1,1,1,1) at label_hw (64, 128),
from one set of weights (crossed with ``models/convert``), dropout off on
both sides; the oracle is the JAX step with ``fused_student=False`` (its
sequential student passes, which ``test_self_train.py`` holds equal to the
fused form). Its gradients come out of the JAX step itself, recorded by a
transform chained ahead of Adam. Tolerances: ``resize_nearest`` exact;
``sample_bilinear_at``, ``full2weak_coords`` (a flipped sample included)
and ``prototype_weights`` 1e-6; RCE rtol 1e-5; the step's losses rtol 1e-5,
gradients 5e-4, parameters inside one step's lr envelope wherever the
gradient is at least 1e-4 (elsewhere float noise can flip the sign of
Adam's first step: at most 5e-4 of them outside, none by more than 2 x
lr, as chip_smoke.py holds the train step), the student's and the EMA
teacher's BatchNorm buffers 5e-4, the EMA weights (decay 0.5, so the teacher
moves by lr / 2) within a tenth of that move where the gradient is at least
1e-4 and within twice it elsewhere, prototypes 5e-4, counts exact.
"""

import contextlib
from typing import Any, NamedTuple

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import flax.linen as fnn  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from tests.test_torch_deeplab import jax_deeplab_with_twin  # noqa: E402
from tests.test_torch_train import (as_state_dict, no_dropout,  # noqa: E402
                                    port_twin)
from thermal_semantic_segmentation_tpu.losses import (  # noqa: E402
    reverse_cross_entropy as jax_rce)
from thermal_semantic_segmentation_tpu.ops import (  # noqa: E402
    class_means as jax_class_means, resize as jax_resize)
from thermal_semantic_segmentation_tpu.train import (  # noqa: E402
    self_train as jax_st)
from thermal_semantic_segmentation_torch.kernels.upsample_argmax import (  # noqa: E402
    upsample_argmax)
from thermal_semantic_segmentation_torch.losses import (  # noqa: E402
    reverse_cross_entropy)
from thermal_semantic_segmentation_torch.ops.class_means import (  # noqa: E402
    masked_class_means)
from thermal_semantic_segmentation_torch.ops.resize import (  # noqa: E402
    resize_nearest, sample_bilinear_at)
from thermal_semantic_segmentation_torch.train import (  # noqa: E402
    self_train)

C, IGNORE = 13, 12
HW = (64, 128)                  # label_hw; pseudo labels at 16 x 32
FULL_HW = (80, 176)             # the teacher's frame: features 10 x 22
LR = 1e-4
PROTO_MOMENTUM = 0.5            # large, so the fold's result is visible
EMA_DECAY = 0.5                 # small, so the teacher moves by lr / 2
LOSS_RTOL, GRAD_ATOL, STATE_ATOL = 1e-5, 5e-4, 5e-4
GRAD_DECIDED = 1e-4             # a gradient whose sign float noise cannot flip
WEAK_PARAMS = {"resized_hw": np.array([[96, 160], [120, 200]], np.int32),
               "crop": np.array([[8, 72, 16, 144], [4, 68, 8, 136]],
                                np.int32),
               "flip": np.array([True, False])}


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    """Two intra-op threads: the suite runs several test processes on a
    few cores, where more threads only wait on each other. Float32 matmuls
    at full precision, whatever an earlier test in the process left set:
    the 1e-6 tolerances hold only then (a bfloat16 matmul is off by ~3e-5
    in the prototype weights)."""
    before = torch.get_num_threads(), torch.get_float32_matmul_precision()
    torch.set_num_threads(2)
    torch.set_float32_matmul_precision("highest")
    yield
    torch.set_num_threads(before[0])
    torch.set_float32_matmul_precision(before[1])


def _t(tree):
    return jax.tree.map(torch.from_numpy, tree)


@pytest.mark.parametrize("dtype", [np.float32, np.int64])
@pytest.mark.parametrize("out_hw", [(16, 32), (64, 128), (7, 300)])
def test_resize_nearest_matches_jax(dtype, out_hw):
    x = np.random.default_rng(0).integers(0, 13, (2, 40, 120, 3)).astype(
        dtype)
    want = np.asarray(jax_resize.resize_nearest(jnp.asarray(x), *out_hw))
    got = resize_nearest(torch.from_numpy(x), *out_hw).numpy()
    assert got.dtype == x.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("flip", [(True, False), (False, True)])
def test_full2weak_sample_matches_jax(flip):
    """The coordinates (a flipped sample included) and the features
    sampled at them; the sample also equals the resize-crop-flip it
    stands for."""
    feat = np.random.default_rng(1).standard_normal(
        (2, 20, 44, 16)).astype(np.float32)
    wp = dict(WEAK_PARAMS, flip=np.array(flip))
    rows, cols = self_train.full2weak_coords(_t(wp), feat_hw=(20, 44),
                                             out_hw=(16, 32))
    jrows, jcols = jax_st.full2weak_coords(jax.tree.map(jnp.asarray, wp),
                                           feat_hw=(20, 44), out_hw=(16, 32))
    np.testing.assert_allclose(rows.numpy(), np.asarray(jrows), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(cols.numpy(), np.asarray(jcols), rtol=0,
                               atol=1e-6)
    got = sample_bilinear_at(torch.from_numpy(feat), rows, cols).numpy()
    want = np.asarray(jax_resize.sample_bilinear_at(
        jnp.asarray(feat), jrows, jcols))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    for b in range(2):
        h4, w4 = wp["resized_hw"][b] // 4
        y1, x1 = wp["crop"][b, 0] // 4, wp["crop"][b, 2] // 4
        resized = torch.nn.functional.interpolate(
            torch.from_numpy(feat[b:b + 1]).permute(0, 3, 1, 2),
            size=(int(h4), int(w4)), mode="bilinear", align_corners=True)
        view = resized[0].permute(1, 2, 0)[y1:y1 + 16, x1:x1 + 32].numpy()
        np.testing.assert_allclose(got[b], view[:, ::-1] if flip[b] else view,
                                   rtol=0, atol=1e-5)


def _prototype_weights_f64(feat, protos, temperature):
    f, p = feat.astype(np.float64), protos.astype(np.float64)
    d = np.sqrt(np.maximum((f * f).sum(-1, keepdims=True) - 2 * f @ p.T
                           + (p * p).sum(-1), 1e-12))
    z = -(d - d.min(-1, keepdims=True)) * temperature
    e = np.exp(z - z.max(-1, keepdims=True))
    return e / e.sum(-1, keepdims=True)


@contextlib.contextmanager
def _pinned_numerics(threads: int = 2):
    """The numerics the 1e-6 tolerance relies on, set here whatever an
    earlier test in the process left: ``threads`` intra-op threads, float32
    matmuls at full precision on both sides (torch's ``highest``, JAX's
    ``jax.default_matmul_precision('highest')``) and no CPU autocast."""
    before = torch.get_num_threads(), torch.get_float32_matmul_precision()
    torch.set_num_threads(threads)
    torch.set_float32_matmul_precision("highest")
    try:
        with torch.autocast("cpu", enabled=False), \
                jax.default_matmul_precision("highest"):
            yield
    finally:
        torch.set_num_threads(before[0])
        torch.set_float32_matmul_precision(before[1])


def test_prototype_weights_match_jax():
    rng = np.random.default_rng(2)
    feat = (rng.standard_normal((2, 16, 32, 256)) * 0.1).astype(np.float32)
    protos = (rng.standard_normal((C, 256)) * 0.1).astype(np.float32)
    with _pinned_numerics():
        got = self_train.prototype_weights(
            torch.from_numpy(feat), torch.from_numpy(protos), 0.5).numpy()
        want = np.asarray(jax_st.prototype_weights(
            jnp.asarray(feat), jnp.asarray(protos), 0.5))
        state = (torch.get_float32_matmul_precision(),
                 torch.is_autocast_enabled("cpu"), torch.get_num_threads())
    # which side drifted, if one does: each against float64
    exact = _prototype_weights_f64(feat, protos, 0.5)
    np.testing.assert_allclose(
        got, want, rtol=0, atol=1e-6,
        err_msg=f"torch matmul precision, CPU autocast, threads: {state}; "
                f"max error from float64: port "
                f"{np.abs(got - exact).max():.3g}, JAX "
                f"{np.abs(want - exact).max():.3g}")
    np.testing.assert_allclose(got.sum(-1), 1.0, rtol=1e-5)


@pytest.mark.parametrize("ignored", [0.0, 0.6, 1.0])
def test_reverse_cross_entropy_matches_jax(ignored):
    rng = np.random.default_rng(3)
    logits = (rng.standard_normal((2, 16, 32, C)) * 3).astype(np.float32)
    labels = rng.integers(0, C, (2, 16, 32))
    labels[rng.random(labels.shape) < ignored] = IGNORE
    got = float(reverse_cross_entropy(torch.from_numpy(logits),
                                      torch.from_numpy(labels),
                                      num_classes=C, ignore_index=IGNORE))
    want = float(jax_rce(jnp.asarray(logits), jnp.asarray(labels),
                         num_classes=C, ignore_index=IGNORE))
    if ignored == 1.0:
        assert got == want == 0.0
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5)
        assert got > 0


@pytest.mark.parametrize("thresh", [None, 0.3])
def test_masked_class_means_at_feature_size_match_jax(thresh):
    """The moving prototypes' means: the port takes the kernel's classes of
    the stride-8 logits at the features' full/4 size, where the JAX step
    argmaxes its bilinearly resized logits."""
    rng = np.random.default_rng(4)
    feat = rng.standard_normal((2, 20, 44, 16)).astype(np.float32)
    logits = rng.standard_normal((2, 10, 22, C)).astype(np.float32)
    logits[..., 0] += 2.0
    logits[:, 2:6, 3:9, 5] += 4.0     # a region, over min_pixels
    logits[:, 7, 15, 9] += 4.0        # a point, under min_pixels
    want_v, want_ok = jax_class_means.masked_class_means(
        jnp.asarray(feat), jax_resize.resize_bilinear(jnp.asarray(logits),
                                                      20, 44),
        num_classes=C, thresh=thresh)
    pred, conf = upsample_argmax(torch.from_numpy(logits), 20, 44)
    got_v, got_ok = masked_class_means(torch.from_numpy(feat), pred, conf,
                                       num_classes=C, thresh=thresh)
    want_ok = np.asarray(want_ok)
    np.testing.assert_array_equal(got_ok.numpy(), want_ok)
    assert 0 < want_ok.sum() < want_ok.size
    np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v), rtol=0,
                               atol=STATE_ATOL)


def test_hard_ids_resized_bilinearly_invent_classes():
    """Without proto_rectify the JAX step resizes the integer hard ids
    bilinearly and truncates them (its train/self_train.py:179-182), which
    the port follows: on a map of road (0) left of a diagonal and ignore
    (12) right of it, the boundary takes ids of neither class, and inside
    an all-ignore map the float32 interpolation lands just under 12 at some
    pixels, which truncate to class 11. Pins the JAX reference's fault
    (ROADMAP.md §3)."""
    r, c = np.mgrid[0:HW[0], 0:HW[1]]
    hard = np.stack([np.where(r + c < 100, 0, IGNORE),
                     np.full(HW, IGNORE)]).astype(np.int64)
    want = np.asarray(jax_resize.resize_bilinear(
        jnp.asarray(hard[..., None].astype(np.float32)), 16, 32))[
            ..., 0].astype(np.int32)
    got = self_train.pseudo_labels(
        None, None, None, torch.from_numpy(hard), {}, out_hw=(16, 32),
        ignore_index=IGNORE, proto_rectify=False).numpy()
    np.testing.assert_array_equal(got, want)
    invented = sorted(set(np.unique(got[0]).tolist()) - {0, IGNORE})
    n_11 = int((got[1] == 11).sum())
    print(f"ids invented between road (0) and ignore (12): {invented}; "
          f"class 11 at {n_11} of {got[1].size} pixels of an all-ignore map")
    assert invented == [1, 3, 4, 5, 7, 9, 10]
    assert n_11 > 0 and set(np.unique(got[1]).tolist()) == {11, IGNORE}


def _batch(seed: int):
    """The step's inputs, as numpy: hard labels mostly ignore with blobs of
    the kept classes 5 and 11, soft maps summing to 1."""
    rng = np.random.default_rng(seed)
    b = 2
    hard = np.full((b, *HW), IGNORE, np.int64)
    hard[0, 10:30, 20:60] = 5
    hard[1, 40:60, 90:120] = 11
    soft = rng.random((b, C, *HW)).astype(np.float32) ** 4
    soft /= soft.sum(1, keepdims=True)
    label = rng.integers(0, C, (b, *HW))
    label[rng.random(label.shape) < 0.05] = 255
    return dict(
        source_image=rng.uniform(0, 1, (b, *HW, 1)).astype(np.float32),
        source_label=label,
        target_image=rng.uniform(0, 1, (b, *HW, 1)).astype(np.float32),
        target_image_full=rng.uniform(0, 1, (b, *FULL_HW, 1)).astype(
            np.float32),
        target_lp_soft=soft, target_lp_hard=hard, weak_params=WEAK_PARAMS)


class _Grads(NamedTuple):
    grads: Any


def _adam_recording_grads(learning_rate):
    """optax Adam with a transform ahead of it that keeps the gradients it
    is given in its state."""
    record = optax.GradientTransformation(
        lambda params: _Grads(jax.tree.map(jnp.zeros_like, params)),
        lambda updates, state, params=None: (updates, _Grads(updates)))
    return optax.chain(record, optax.adam(learning_rate))


@pytest.mark.parametrize("proto_rectify", [True, False])
def test_self_train_step_matches_jax(proto_rectify):
    model, variables, twin = jax_deeplab_with_twin(8)
    state_dict = {k: v.clone() for k, v in twin.state_dict().items()}
    protos = (np.random.default_rng(9).standard_normal((C, 256)) * 0.1
              ).astype(np.float32)
    batch = _batch(10)
    if not proto_rectify:
        # hard ids (every class, ignore included) at the pseudo labels' own
        # size: the bilinear resize is the identity, whose truncation no
        # rounding can move (the resize itself:
        # test_hard_ids_resized_bilinearly_invent_classes)
        batch["target_lp_hard"] = np.random.default_rng(11).integers(
            0, C, (2, HW[0] // 4, HW[1] // 4))
    kw = dict(num_classes=C, ignore_index=IGNORE, base_lr=LR,
              train_thred=0.1, label_hw=HW, proto_rectify=proto_rectify,
              proto_momentum=PROTO_MOMENTUM, ema_decay=EMA_DECAY)

    tx = optax.inject_hyperparams(_adam_recording_grads)(learning_rate=LR)
    jstate = jax_st.create_self_train_state(
        model, jax.tree.map(jnp.asarray, variables), prototypes=protos,
        learning_rate=LR)
    jstate = jstate.replace(tx=tx, opt_state=tx.init(jstate.params))
    jstep = jax_st.make_self_train_step(model, fused_student=False, **kw)
    jbatch = {k: jax.tree.map(jnp.asarray, v) for k, v in batch.items()}
    if not proto_rectify:
        jbatch["target_lp_soft"] = None
    with fnn.intercept_methods(no_dropout):
        jstate, jlp, jls = jstep(jstate, **jbatch)
    jstate = jax.device_get(jstate)

    student = port_twin(state_dict)
    state = self_train.create_self_train_state(
        student, prototypes=protos, learning_rate=LR, device="cpu")
    step = self_train.make_self_train_step(device="cpu", **kw)
    tbatch = {k: _t(v) for k, v in batch.items()}
    if not proto_rectify:
        tbatch["target_lp_soft"] = None
    stages = []
    lp, ls = step(state, **tbatch, mark=stages.append)
    assert stages == ["teacher_forward", "rectify", "student_source",
                      "student_target", "backward", "adam", "prototypes",
                      "ema"]
    assert state.step == 1 and lp.dim() == ls.dim() == 0
    print(f"proto_rectify={proto_rectify}: losses port {float(lp)}, "
          f"{float(ls)} JAX {float(jlp)}, {float(jls)}")
    np.testing.assert_allclose([float(lp), float(ls)],
                               [float(jlp), float(jls)], rtol=LOSS_RTOL)

    names = dict(student.named_parameters())
    want_g = as_state_dict(jstate.opt_state.inner_state[0].grads,
                           jstate.batch_stats)
    for name, p in names.items():
        np.testing.assert_allclose(p.grad.numpy(), want_g[name], rtol=0,
                                   atol=GRAD_ATOL, err_msg=name)
    want = as_state_dict(jstate.params, jstate.batch_stats)
    want_ema = as_state_dict(jstate.ema_params, jstate.ema_stats)
    outside = total = decided = 0
    worst = worst_ema = 0.0
    for (k, got), (_, got_ema) in zip(student.state_dict().items(),
                                      state.teacher.state_dict().items()):
        if k.endswith("num_batches_tracked"):
            assert int(got) == int(got_ema) == 2   # source, then target
            continue
        if k in names:
            ratio = np.abs(got.numpy() - want[k]) / LR
            worst = max(worst, float(ratio.max()))
            outside += int((ratio > 1.0).sum())
            total += ratio.size
            # where the gradient stands clear of float noise, Adam's first
            # step (lr times its sign) must agree
            sure = np.abs(want_g[k]) >= GRAD_DECIDED
            decided += int(sure.sum())
            assert (ratio[sure] <= 1.0).all(), k
            # the teacher moved by (1 - decay) x the student's step: there it
            # agrees to a tenth of that move, and within twice it elsewhere
            # (a skipped EMA, another decay or a copy of the student is off
            # by about lr / 2 where the gradient is decided)
            ema_ratio = (np.abs(got_ema.numpy() - want_ema[k])
                         / ((1.0 - EMA_DECAY) * LR))
            worst_ema = max(worst_ema, float(ema_ratio[sure].max(initial=0)))
            assert (ema_ratio[sure] <= 0.1).all(), k
            assert (ema_ratio <= 2.0).all(), k
        else:
            np.testing.assert_allclose(got.numpy(), want[k], rtol=0,
                                       atol=STATE_ATOL, err_msg=k)
            np.testing.assert_allclose(got_ema.numpy(), want_ema[k], rtol=0,
                                       atol=STATE_ATOL, err_msg=k)
    print(f"{outside} of {total} parameters outside the lr envelope, "
          f"worst {worst:.3f} of it; all {decided} with a gradient of at "
          f"least {GRAD_DECIDED} inside it; the EMA teacher's weights there "
          f"within {worst_ema:.2e} of its move")
    assert outside <= 5e-4 * total and worst <= 2.0 and decided > 0.01 * total

    np.testing.assert_array_equal(state.proto_counts.numpy(),
                                  np.asarray(jstate.proto_counts))
    assert state.proto_counts.sum() > 0
    np.testing.assert_allclose(state.prototypes.numpy(),
                               np.asarray(jstate.prototypes), rtol=0,
                               atol=STATE_ATOL)
    assert not np.allclose(state.prototypes.numpy(), protos)
