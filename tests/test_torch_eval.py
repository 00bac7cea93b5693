"""The port's eval path (ops/confmat.py, eval/metrics.py, losses, train/seg.py
``build_seg_eval_step``, data/device_pipeline.py, eval/validate.py) against
the JAX package on the same seeded inputs and the same weights.

Tolerances: confusion matrices exact (outside logit near-ties, top-2 gap
below 1e-5, where the eval step's argmax may flip); scores 1e-12 (the same
float64 arithmetic); cross entropy 1e-6; the eval step's loss and
``val_loss`` 1e-5 relative; mIoU 1e-6.

Tests marked gpu run the eval step on the card against its CPU run:

    python -m pytest --noconftest tests/test_torch_eval.py -m gpu
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from thermal_semantic_segmentation_torch.data.device_pipeline import (  # noqa: E402
    device_prefetch)
from thermal_semantic_segmentation_torch.data.loader import (  # noqa: E402
    DataLoader)
from thermal_semantic_segmentation_torch.eval import metrics  # noqa: E402
from thermal_semantic_segmentation_torch.eval.validate import (  # noqa: E402
    seg_validate)
from thermal_semantic_segmentation_torch.losses import (  # noqa: E402
    cross_entropy)
from thermal_semantic_segmentation_torch.ops.confmat import (  # noqa: E402
    confusion_matrix)
from thermal_semantic_segmentation_torch.train import seg  # noqa: E402

HW = (64, 128)
TIE_GAP = 1e-5


@pytest.fixture(scope="module")
def jx():
    """The JAX oracle, imported here so that the card's machine, which has
    no JAX, can still run this file's gpu tests."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from thermal_semantic_segmentation_tpu import losses
    from thermal_semantic_segmentation_tpu.data.loader import (
        DataLoader as JaxDataLoader)
    from thermal_semantic_segmentation_tpu.eval import metrics as jmetrics
    from thermal_semantic_segmentation_tpu.eval.validate import (
        seg_validate as jax_seg_validate)
    from thermal_semantic_segmentation_tpu.ops import confmat, resize
    from thermal_semantic_segmentation_tpu.train.seg import (
        build_seg_eval_step)
    return dict(jax=jax, jnp=jnp, losses=losses, metrics=jmetrics,
                confmat=confmat, resize=resize, DataLoader=JaxDataLoader,
                seg_validate=jax_seg_validate,
                build_seg_eval_step=build_seg_eval_step)


@pytest.fixture(scope="module")
def tiny(jx):
    from tests.test_torch_deeplab import jax_deeplab_with_twin
    return jax_deeplab_with_twin(5)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _labels(rng, shape, num_classes):
    """Labels in [0, C) with some 12 (the Freiburg ignore id), 255 and -1."""
    label = rng.integers(0, num_classes, shape)
    odd = rng.random(shape)
    label[odd < 0.05] = 255
    label[(odd >= 0.05) & (odd < 0.08)] = -1
    label[(odd >= 0.08) & (odd < 0.12)] = 12
    return label.astype(np.int64)


@pytest.mark.parametrize("num_classes,shape", [
    (13, (2, *HW)), (13, (1, 7, 9)), (19, (3, 16, 32))])
def test_confusion_matrix_matches_jax(jx, num_classes, shape):
    rng = np.random.default_rng(num_classes + shape[0])
    pred = rng.integers(0, num_classes, shape)
    label = _labels(rng, shape, num_classes)
    want = np.asarray(jx["confmat"].confusion_matrix(
        jx["jnp"].asarray(pred), jx["jnp"].asarray(label), num_classes))
    got = confusion_matrix(torch.from_numpy(pred).int(),
                           torch.from_numpy(label), num_classes)
    assert got.dtype == torch.int64 and got.shape == (num_classes,) * 2
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    # the ignore id 12 has its own row (it lies inside [0, 13))
    assert int(got[12].sum()) == int((label == 12).sum())
    assert int(got.sum()) == int(((label >= 0) & (label < num_classes)).sum())


def _assert_scores_equal(got, want):
    g, w = got.astuple(), want.astuple()
    np.testing.assert_allclose(g[:4], w[:4], rtol=1e-12, equal_nan=True)
    assert list(g[4]) == list(w[4])
    np.testing.assert_allclose(list(g[4].values()), list(w[4].values()),
                               rtol=1e-12, equal_nan=True)


@pytest.mark.parametrize("num_classes", [13, 19])
def test_scores_from_hist_matches_jax(jx, num_classes):
    rng = np.random.default_rng(num_classes)
    hist = rng.integers(0, 500, (num_classes, num_classes))
    hist[3, :] = 0            # class 3 never labelled ...
    hist[:, 3] = 0            # ... nor predicted: IoU nan
    hist[5, :] = 0            # class 5 predicted, never labelled: IoU 0
    got = metrics.scores_from_hist(hist)
    assert np.isnan(got.cls_iu[list(got.cls_iu)[3]])
    _assert_scores_equal(got, jx["metrics"].scores_from_hist(hist))


def test_scores_from_hist_refuses_other_class_counts(jx):
    with pytest.raises(ValueError, match="invalid dataset"):
        metrics.scores_from_hist(np.ones((5, 5)))


def test_evaluate_matches_jax(jx):
    rng = np.random.default_rng(3)
    preds = [rng.integers(0, 13, HW) for _ in range(3)]
    gts = [_labels(rng, HW, 13) for _ in range(3)]
    got = metrics.evaluate(preds, gts, 13)
    want = jx["metrics"].evaluate(preds, gts, 13)
    _assert_scores_equal(metrics.SegScores(*got), metrics.SegScores(*want))


@pytest.mark.parametrize("case", ["mixed", "all_ignored", "default_ignore"])
def test_cross_entropy_matches_jax(jx, case):
    rng = np.random.default_rng(11)
    logits = rng.standard_normal((2, 16, 32, 13)).astype(np.float32) * 3
    label = _labels(rng, (2, 16, 32), 13)
    label[0, 0, :4] = 13                       # out of range above
    kw = {} if case == "default_ignore" else {"ignore_index": 12}
    if case == "all_ignored":
        label[...] = np.where(rng.random(label.shape) < 0.5, 12, 255)
    want = float(jx["losses"].cross_entropy(
        jx["jnp"].asarray(logits), jx["jnp"].asarray(label), **kw))
    got = cross_entropy(torch.from_numpy(logits), torch.from_numpy(label),
                        **kw)
    assert got.dtype == torch.float32 and got.dim() == 0
    if case == "all_ignored":
        assert float(got) == want == 0.0
    np.testing.assert_allclose(float(got), want, rtol=1e-6, atol=1e-6)


def test_cross_entropy_has_zero_grads_when_all_ignored():
    logits = torch.randn(1, 4, 4, 13, requires_grad=True)
    cross_entropy(logits, torch.full((1, 4, 4), 12), ignore_index=12).backward()
    assert torch.equal(logits.grad, torch.zeros_like(logits))


def _decided(jx, model, variables, image):
    """Pixels whose JAX top-2 upsampled logit gap is at least TIE_GAP."""
    out = model.apply(variables, jx["jnp"].asarray(image), train=False)
    up = np.asarray(jx["resize"].upsample_logits(out["out"], *HW))
    top2 = np.sort(up, axis=-1)[..., -2:]
    return (top2[..., 1] - top2[..., 0]) >= TIE_GAP


def test_eval_step_matches_jax(jx, tiny, monkeypatch):
    model, variables, twin = tiny
    rng = np.random.default_rng(21)
    image = rng.uniform(0, 1, (2, *HW, 1)).astype(np.float32)
    label = _labels(rng, (2, *HW), 13)
    jax_step = jx["build_seg_eval_step"](model, num_classes=13,
                                         ignore_index=12)
    want_hist, want_loss, want_pred = (np.asarray(a) for a in jax_step(
        variables, jx["jnp"].asarray(image), jx["jnp"].asarray(label)))

    calls = []
    kernel = seg.upsample_argmax
    monkeypatch.setattr(seg, "upsample_argmax",
                        lambda *a: calls.append(a[1:]) or kernel(*a))
    step = seg.build_seg_eval_step(num_classes=13, ignore_index=12,
                                   device="cpu")
    hist, loss, pred = step(twin, torch.from_numpy(image),
                            torch.from_numpy(label))
    assert calls == [HW]      # pred comes from the fused kernel's wrapper
    assert hist.dtype == torch.int64 and pred.shape == (2, *HW)
    decided = _decided(jx, model, variables, image)
    np.testing.assert_array_equal(pred.numpy()[decided], want_pred[decided])
    # the batch's hist is the confusion matrix of its preds; outside
    # near-ties it equals the JAX one exactly
    np.testing.assert_array_equal(
        hist.numpy(), confusion_matrix(pred, torch.from_numpy(label), 13))
    masked = np.where(decided, label, -1)
    np.testing.assert_array_equal(
        confusion_matrix(pred, torch.from_numpy(masked), 13).numpy(),
        np.asarray(jx["confmat"].confusion_matrix(
            jx["jnp"].asarray(want_pred), jx["jnp"].asarray(masked), 13)))
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)


def test_bf16_eval_step_scores_a_batch(tiny):
    """--bf16 runs the forward under bfloat16 autocast; the logits reach
    the loss and the kernel as float32."""
    rng = np.random.default_rng(22)
    image = torch.from_numpy(rng.uniform(0, 1, (2, *HW, 1)).astype(np.float32))
    label = torch.from_numpy(_labels(rng, (2, *HW), 13))
    hist, loss, pred = seg.build_seg_eval_step(
        num_classes=13, ignore_index=12, device="cpu", bf16=True)(
        tiny[2], image, label)
    assert hist.dtype == torch.int64 and int(hist.sum()) == int(
        ((label >= 0) & (label < 13)).sum())
    assert loss.dtype == torch.float32 and bool(torch.isfinite(loss))
    assert pred.shape == (2, *HW) and int(pred.max()) < 13


def test_device_prefetch_on_the_cpu_passes_batches_through():
    batches = [{"image": np.full((2, 3), i, np.float32), "name": f"b{i}"}
               for i in range(5)]
    out = list(device_prefetch(iter(batches), "cpu", size=2))
    assert [b["name"] for b in out] == [f"b{i}" for i in range(5)]
    for i, b in enumerate(out):
        assert isinstance(b["image"], torch.Tensor)
        assert torch.equal(b["image"], torch.full((2, 3), float(i)))


@pytest.mark.gpu
def test_device_prefetch_on_the_card_delivers_every_batch(cuda_device):
    batches = [{"image": np.random.default_rng(i).random((4, 64, 64, 1),
                                                          dtype=np.float32),
                "label": np.full((4, 64, 64), i, np.int64)}
               for i in range(5)]
    for want, got in zip(batches, device_prefetch(iter(batches), cuda_device)):
        assert got["image"].device.type == "cuda"
        doubled = got["image"] * 2       # used on the current stream
        np.testing.assert_array_equal(doubled.cpu().numpy(),
                                      want["image"] * 2)
        np.testing.assert_array_equal(got["label"].cpu().numpy(),
                                      want["label"])


class _Images:
    """An in-memory dataset (``len``, ``get(index, rng)``)."""

    def __init__(self, images, labels):
        self.images, self.labels = images, labels

    def __len__(self):
        return len(self.images)

    def get(self, index, rng):
        return {"image": self.images[index], "label": self.labels[index]}


def _biased_to_class_0(jx, model, variables):
    """``variables`` with a constant added to the class-0 logit: one
    bottleneck channel becomes its GroupNorm bias (scale 0) and feeds only
    class 0 of the head, so the logit gains exactly that bias. It is set so
    that a zero image predicts class 0 at half of its pixels. (A tiny random
    model answers nearly the same map for any input, so the real images
    predict class 0 at about half of theirs as well.)"""
    params = jx["jax"].tree.map(np.array, variables["params"])
    params["layer5"]["bottleneck_gn"]["scale"][0] = 0.0
    params["layer5"]["bottleneck_gn"]["bias"][0] = 0.0
    params["layer5"]["head_conv"]["kernel"][0, 0, 0, :] = 0.0
    params["layer5"]["head_conv"]["kernel"][0, 0, 0, 0] = 1.0
    biased = {"params": params, "batch_stats": variables["batch_stats"]}
    out = np.asarray(model.apply(
        biased, jx["jnp"].zeros((1, *HW, 1)), train=False)["out"])
    params["layer5"]["bottleneck_gn"]["bias"][0] = np.median(
        out[..., 1:].max(-1) - out[..., 0])
    return biased


def test_tail_batch_scores_equal_batch_one_where_jax_padding_does_not(
        jx, tiny):
    """The port runs a ragged tail batch at its own size. The JAX package's
    ``pad_to_batch`` pads it with zero images labelled 12, which its
    confusion matrix counts in row 12: their class-0 predictions enter
    class 0's column sum and lower its IoU."""
    from thermal_semantic_segmentation_torch.models.convert import (
        jax_variables_to_state_dict)
    from thermal_semantic_segmentation_torch.models.deeplab import DeepLabV2

    model, variables, _ = tiny
    rng = np.random.default_rng(31)
    images = rng.uniform(0, 1, (5, *HW, 1)).astype(np.float32)
    variables = _biased_to_class_0(jx, model, variables)
    twin = DeepLabV2(num_channels=1, num_classes=13, layers=(1, 1, 1, 1))
    twin.load_state_dict(jax_variables_to_state_dict(variables), strict=True)
    twin = twin.to(memory_format=torch.channels_last).eval()
    up = np.asarray(jx["resize"].upsample_logits(model.apply(
        variables, jx["jnp"].asarray(images), train=False)["out"], *HW))
    pred = up.argmax(-1)
    labels = rng.integers(0, 12, (5, *HW))
    labels[(pred == 0) & (rng.random(pred.shape) < 0.5)] = 0
    assert 0.2 < (pred == 0).mean() < 0.8
    data = _Images(images, labels)

    def jax_run(batch_size, **kw):
        return jx["seg_validate"](
            model, variables, jx["DataLoader"](data, batch_size,
                                               drop_last=False),
            num_classes=13, ignore_index=12, label_hw=HW, **kw)

    want = jax_run(1)
    padded = jax_run(4, pad_to_batch=4)
    got = seg_validate(twin, DataLoader(data, 4, drop_last=False),
                       num_classes=13, ignore_index=12, device="cpu")
    np.testing.assert_allclose(got[0], want[0], rtol=1e-6)     # mean_iu
    np.testing.assert_allclose(got[1], want[1], rtol=1e-5)     # val_loss
    np.testing.assert_allclose(list(got[2].values()),
                               list(want[2].values()), rtol=1e-6,
                               equal_nan=True)
    # the padded JAX run scores class 0 lower, and so the mean
    road = metrics.FREIBURG_CLASS_NAMES[0]
    for name, scores in (("JAX batch 1", want), ("JAX pad_to_batch 4", padded),
                         ("port batch 4", got)):
        print(f"{name}: mean_iu {scores[0]!r}, road IoU {scores[2][road]!r}")
    assert padded[2][road] < want[2][road] - 1e-3
    assert padded[0] < want[0] - 1e-4
    np.testing.assert_allclose(padded[1], want[1], rtol=1e-5)  # loss agrees


def test_float32_confusion_matrix_stops_counting_past_2_24(jx):
    """A fault of the JAX reference, pinned: JAX ``seg_validate`` keeps the
    confusion matrix in float32 (eval/validate.py:63, 75), so a cell past
    2**24 pixels loses counts when a batch adds an odd number; the port's
    int64 matrix counts them all. 20 batches of 2**20 + 1 pixels, every
    one (road, road), accumulated as ``seg_validate`` does."""
    n, batches = 2 ** 20 + 1, 20
    pred = np.zeros(n, np.int32)
    label = np.zeros(n, np.int64)
    jnp = jx["jnp"]
    bhist = jx["confmat"].confusion_matrix(jnp.asarray(pred),
                                           jnp.asarray(label), 13)
    hist = jnp.zeros((13, 13), jnp.float32)
    port_bhist = confusion_matrix(torch.from_numpy(pred),
                                  torch.from_numpy(label), 13)
    port = torch.zeros((13, 13), dtype=torch.int64)
    for _ in range(batches):
        hist = hist + bhist
        port = port + port_bhist
    exact = n * batches
    jax_count = int(np.asarray(hist)[0, 0])
    print(f"(road, road) after {batches} batches of {n}: port "
          f"{int(port[0, 0])}, JAX {jax_count}, exact {exact}")
    assert int(port[0, 0]) == exact == 20_971_540
    assert jax_count < exact
    assert int(port.sum()) == exact


def test_seg_validate_refuses_multi_gpu(tiny):
    """One process over several devices (a ``LocalMesh``, here two CPU
    replicas) gives the one-device scores of a batch of 3 (2 + 1 rows);
    the cross-process reduction with one process changes nothing
    (tests/test_torch_dist.py runs it over two, and
    tests/test_torch_data_parallel.py holds the mesh to JAX's)."""
    from thermal_semantic_segmentation_torch.parallel.mesh import (
        local_data_mesh)
    rng = np.random.default_rng(3)
    three = [{"image": rng.uniform(0, 1, (3, 16, 32, 1)).astype(np.float32),
              "label": rng.integers(0, 13, (3, 16, 32))}]
    want = seg_validate(tiny[2], three, device="cpu")
    got = seg_validate(tiny[2], three, device="cpu",
                       mesh=local_data_mesh(devices=["cpu", "cpu"]))
    assert got[0] == want[0] and got[2] == want[2]
    np.testing.assert_allclose(got[1], want[1], rtol=1e-6)
    batches = [{"image": np.zeros((1, 16, 32, 1), np.float32),
                "label": np.zeros((1, 16, 32), np.int64)}]
    assert seg_validate(tiny[2], batches, device="cpu",
                        reduce_processes=True)[1] == seg_validate(
        tiny[2], batches, device="cpu")[1]


@pytest.mark.gpu
def test_eval_step_on_the_card_matches_the_cpu(cuda_device):
    """The eval step on the card (the CUDA kernel supplies pred) against the
    same step on the CPU (the kernel's plain version)."""
    from thermal_semantic_segmentation_torch.models.deeplab import (
        create_deeplab)

    twin = create_deeplab(5, device="cpu", layers=(1, 1, 1, 1))
    rng = np.random.default_rng(41)
    image = torch.from_numpy(rng.uniform(0, 1, (3, *HW, 1)).astype(np.float32))
    label = torch.from_numpy(_labels(rng, (3, *HW), 13))
    cpu = seg.build_seg_eval_step(num_classes=13, ignore_index=12,
                                  device="cpu")(twin, image, label)
    card_model = create_deeplab(5, device=cuda_device, layers=(1, 1, 1, 1))
    before = seg.upsample_argmax.launches
    hist, loss, pred = seg.build_seg_eval_step(
        num_classes=13, ignore_index=12, device=cuda_device)(
        card_model, image.to(cuda_device), label.to(cuda_device))
    assert seg.upsample_argmax.launches == before + 1
    assert hist.device.type == "cuda" and hist.dtype == torch.int64
    with torch.no_grad():
        logits = twin(image.permute(0, 3, 1, 2))["out"].permute(0, 2, 3, 1)
    top2 = seg.upsample_logits(logits, *HW).topk(2, dim=-1).values
    decided = (top2[..., 0] - top2[..., 1]) > TIE_GAP
    assert torch.equal(pred.cpu()[decided], cpu[2][decided])
    masked = torch.where(decided, label, -1)
    assert torch.equal(confusion_matrix(pred.cpu(), masked, 13),
                       confusion_matrix(cpu[2], masked, 13))
    torch.testing.assert_close(loss.cpu(), cpu[1], rtol=1e-5, atol=1e-6)
