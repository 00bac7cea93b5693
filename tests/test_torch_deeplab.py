"""The port's DeepLabV2 (models/deeplab.py, nn/, ops/pool.py, ops/resize.py)
against the JAX package on the same inputs and the same weights.

Weights cross from JAX to the port through the port's own
``models/convert.jax_variables_to_state_dict`` and load with
``strict=True``. Tolerance on the forward: 5e-4 absolute (PARITY.md).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from thermal_semantic_segmentation_tpu.models.deeplab import (  # noqa: E402
    create_deeplab as jax_create_deeplab)
from thermal_semantic_segmentation_tpu.ops.pool import (  # noqa: E402
    max_pool_ceil as jax_max_pool_ceil)
from thermal_semantic_segmentation_tpu.ops.resize import (  # noqa: E402
    resize_bilinear as jax_resize_bilinear)
from thermal_semantic_segmentation_torch.models.convert import (  # noqa: E402
    jax_legacy_variables_to_state_dict, jax_variables_to_state_dict)
from thermal_semantic_segmentation_torch.models.deeplab import (  # noqa: E402
    DeepLabV2, LegacyDeepLabV2, create_deeplab)
from thermal_semantic_segmentation_torch.ops.pool import (  # noqa: E402
    max_pool_ceil)
from thermal_semantic_segmentation_torch.ops.resize import (  # noqa: E402
    resize_bilinear)

FORWARD_ATOL = 5e-4
TRUNCATED_TAIL = 2.3     # |w| / std of a normal cut at 2 of its stds <= 2.28
TINY = dict(num_classes=13, layers=(1, 1, 1, 1))
HW = (64, 128)


def jax_deeplab_with_twin(seed: int, *, num_channels: int = 1,
                          bn_clr: bool = False):
    """(jax model, jax variables, port model): a tiny JAX DeepLabV2 with
    randomised BatchNorm statistics, and the port's model loaded strictly
    with the same weights (CPU, eval mode)."""
    model, variables = jax_create_deeplab(
        jax.random.key(seed), num_channels=num_channels, bn_clr=bn_clr,
        image_size=HW, **TINY)
    variables = jax.tree.map(np.asarray, variables)
    rng = np.random.default_rng(seed)
    stats = jax.tree_util.tree_map_with_path(
        lambda p, v: (rng.normal(0, 0.05, v.shape) if p[-1].key == "mean"
                      else rng.uniform(0.8, 1.2, v.shape)).astype(np.float32),
        variables["batch_stats"])
    variables = {"params": variables["params"], "batch_stats": stats}
    twin = DeepLabV2(num_channels=num_channels, bn_clr=bn_clr, **TINY)
    twin.load_state_dict(jax_variables_to_state_dict(variables), strict=True)
    twin = twin.to(memory_format=torch.channels_last).eval()
    return model, variables, twin


@pytest.mark.parametrize("num_channels", [1, 3])
@pytest.mark.parametrize("bn_clr", [False, True])
def test_forward_matches_jax(num_channels, bn_clr):
    model, variables, twin = jax_deeplab_with_twin(
        num_channels + 10 * bn_clr, num_channels=num_channels, bn_clr=bn_clr)
    x = np.random.default_rng(7).uniform(
        0, 1, (2, *HW, num_channels)).astype(np.float32)
    want = model.apply(variables, jnp.asarray(x), train=False)
    with torch.no_grad():
        got = twin(torch.from_numpy(x).permute(0, 3, 1, 2))
    for key in ("out", "feat"):
        g = got[key].permute(0, 2, 3, 1).numpy()
        w = np.asarray(want[key])
        assert g.shape == w.shape, (key, g.shape, w.shape)
        np.testing.assert_allclose(g, w, rtol=0, atol=FORWARD_ATOL,
                                   err_msg=key)


@pytest.mark.parametrize("bn_clr", [False, True])
def test_initial_weights_follow_the_jax_distributions(bn_clr):
    """Every tensor of the port's seeded init is drawn as the JAX init
    draws its twin: the same constants, and for a tensor of 1,000 values
    or more the same mean and spread (within 10% of the spread) and no
    value past the JAX truncation (a normal cut at two of its standard
    deviations is within 2.28 of its own) where JAX's tensor is cut."""
    _, variables = jax_create_deeplab(jax.random.key(3), bn_clr=bn_clr,
                                      image_size=HW, **TINY)
    want = jax_variables_to_state_dict(jax.tree.map(np.asarray, variables))
    got = create_deeplab(3, device="cpu", bn_clr=bn_clr, **TINY).state_dict()
    checked = truncated = 0
    for key, w in want.items():
        g, w = got[key].double(), w.double()
        if w.numel() < 1000 or float(w.std()) == 0.0:
            if float(w.std()) == 0.0:
                torch.testing.assert_close(g, w, rtol=0, atol=0, msg=key)
            continue
        sw, sg = float(w.std()), float(g.std())
        assert abs(sg / sw - 1) < 0.1, (key, sg, sw)
        assert abs(float(g.mean() - w.mean())) < 0.1 * sw, key
        if float(w.abs().max()) <= TRUNCATED_TAIL * sw:    # JAX truncates
            assert float(g.abs().max()) <= TRUNCATED_TAIL * sg, key
            truncated += 1
        checked += 1
    assert checked > 10 and truncated >= 8


def test_converter_refuses_unknown_variables():
    _, variables, _ = jax_deeplab_with_twin(0)
    variables["params"]["layer5"]["extra_conv"] = {
        "kernel": np.zeros((1, 1, 256, 13), np.float32)}
    with pytest.raises(ValueError, match="extra_conv"):
        jax_variables_to_state_dict(variables)


@pytest.mark.parametrize("hw", [(128, 256), (65, 129), (7, 9), (33, 17)])
def test_max_pool_ceil_matches_jax(hw):
    """Ceil mode: 128 rows pool to 65, and odd sizes keep the reference's
    trailing-window rule."""
    x = np.random.default_rng(1).standard_normal((2, *hw, 3)).astype(np.float32)
    want = np.asarray(jax_max_pool_ceil(jnp.asarray(x), 3, 2, 1))
    got = max_pool_ceil(torch.from_numpy(x), 3, 2, 1).numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape,out_hw,align_corners", [
    ((2, 33, 65, 3), (256, 512), True),
    ((1, 9, 17, 5), (61, 127), True),
    ((1, 9, 17, 5), (61, 127), False),
    ((1, 64, 128, 2), (33, 17), True),
])
def test_resize_bilinear_matches_jax(shape, out_hw, align_corners):
    x = np.random.default_rng(2).standard_normal(shape).astype(np.float32)
    want = np.asarray(jax_resize_bilinear(jnp.asarray(x), *out_hw,
                                          align_corners=align_corners))
    got = resize_bilinear(torch.from_numpy(x), *out_hw,
                          align_corners=align_corners).numpy()
    # F.interpolate derives its weights from a float32 scale, JAX from a
    # float64 one: the JAX package holds the same pair to 1e-4
    # (tests/test_ops_resize.py)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_create_deeplab_is_seeded_channels_last_and_shaped():
    a = create_deeplab(3, device="cpu", **TINY)
    b = create_deeplab(torch.Generator().manual_seed(3), device="cpu", **TINY)
    for (ka, va), (kb, vb) in zip(a.state_dict().items(),
                                  b.state_dict().items()):
        assert ka == kb
        torch.testing.assert_close(va, vb, rtol=0, atol=0)
    assert not a.training
    x = torch.zeros(2, 1, *HW).contiguous(memory_format=torch.channels_last)
    with torch.no_grad():
        out = a(x)
    assert out["out"].shape == (2, 13, 9, 17)      # stride 8, ceil pool
    assert out["feat"].shape == (2, 256, 9, 17)
    assert out["out"].is_contiguous(memory_format=torch.channels_last)


def test_aspp_branches_split_large_batches_with_the_same_result(monkeypatch):
    """Past MAX_BRANCH_PIXELS the ASPP branches run on parts of the batch
    (each image alone through them), so the forward is the same."""
    from thermal_semantic_segmentation_torch.nn import aspp

    model = create_deeplab(3, device="cpu", **TINY)
    x = torch.rand(5, 1, *HW, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        want = model(x)
    calls = []
    model.layer5.conv2d_list[1].register_forward_hook(
        lambda m, i, o: calls.append(o.shape[0]))
    monkeypatch.setattr(aspp, "MAX_BRANCH_PIXELS", 2 * 9 * 17)
    with torch.no_grad():
        got = model(x)
    assert calls == [2, 2, 1]
    for key in ("out", "feat"):
        torch.testing.assert_close(got[key], want[key], rtol=0, atol=1e-5)


def jax_legacy_deeplab_with_twin(seed: int, *, num_channels: int = 3,
                                 layers=(1, 1, 1, 1)):
    """(jax model, jax variables, port model): a JAX
    ``DeepLabV2(head='legacy')`` of 19 classes with randomised BatchNorm
    statistics, and the port's ``LegacyDeepLabV2`` loaded strictly through
    ``jax_legacy_variables_to_state_dict`` (CPU, eval mode)."""
    model, variables = jax_create_deeplab(
        jax.random.key(seed), num_classes=19, num_channels=num_channels,
        head="legacy", layers=layers, image_size=HW)
    variables = jax.tree.map(np.asarray, variables)
    rng = np.random.default_rng(seed)
    stats = jax.tree_util.tree_map_with_path(
        lambda p, v: (rng.normal(0, 0.05, v.shape) if p[-1].key == "mean"
                      else rng.uniform(0.8, 1.2, v.shape)).astype(np.float32),
        variables["batch_stats"])
    variables = {"params": variables["params"], "batch_stats": stats}
    twin = LegacyDeepLabV2(num_classes=19, num_channels=num_channels,
                           layers=layers)
    twin.load_state_dict(jax_legacy_variables_to_state_dict(variables),
                         strict=True)
    return model, variables, twin.to(memory_format=torch.channels_last).eval()


@pytest.mark.parametrize("num_channels", [1, 3])
def test_legacy_forward_matches_jax(num_channels):
    """The legacy model on the GAN's legacy input scale (BGR
    mean-subtracted [0, 255])."""
    model, variables, twin = jax_legacy_deeplab_with_twin(
        20 + num_channels, num_channels=num_channels)
    x = (np.random.default_rng(8).uniform(0, 255, (2, *HW, num_channels))
         - 116.7).astype(np.float32)
    want = model.apply(variables, jnp.asarray(x), train=False)
    with torch.no_grad():
        got = twin(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert got["out"].shape == (2, 19, 9, 17)
    assert got["feat"].shape == (2, 2048, 9, 17)
    for key in ("out", "feat"):
        np.testing.assert_allclose(got[key].permute(0, 2, 3, 1).numpy(),
                                   np.asarray(want[key]), rtol=0,
                                   atol=FORWARD_ATOL, err_msg=key)


def test_legacy_keys_round_trip_through_jax():
    """The port's legacy state_dict carries the reference legacy keys: the
    JAX package's ``torch_legacy_state_dict_to_flax`` turns its keys and
    arrays back into the JAX variables exactly."""
    from thermal_semantic_segmentation_tpu.models.torch_convert import (
        torch_legacy_state_dict_to_flax)

    _, variables, twin = jax_legacy_deeplab_with_twin(5)
    sd = twin.state_dict()
    assert {k.split(".")[0] for k in sd} == {"backbone", "classifier"}
    assert sorted(k for k in sd if k.startswith("classifier")) == sorted(
        f"classifier.conv2d_list.{i}.{w}" for i in range(4)
        for w in ("weight", "bias"))
    back = torch_legacy_state_dict_to_flax(sd)
    assert jax.tree.structure(back) == jax.tree.structure(variables)
    for got, want in zip(jax.tree.leaves(back), jax.tree.leaves(variables)):
        np.testing.assert_array_equal(got, want)


def test_legacy_factories_are_seeded_full_width_nets():
    """``deeplabv2_resnet101`` (RGB) and ``_thermal`` (1 channel): the
    ResNet-101 with the 19-class legacy head, seeded, eval mode; the head
    drawn from N(0, 0.01) with zero biases. The legacy branches split
    past MAX_BRANCH_PIXELS with the same result."""
    from thermal_semantic_segmentation_torch.models.factory import (
        deeplabv2_resnet101, deeplabv2_resnet101_thermal)
    from thermal_semantic_segmentation_torch.nn import aspp

    rgb = deeplabv2_resnet101(device="cpu", seed=1)
    thermal = deeplabv2_resnet101_thermal(device="cpu", seed=1)
    for net, c in ((rgb, 3), (thermal, 1)):
        assert isinstance(net, LegacyDeepLabV2) and not net.training
        assert net.backbone.conv1.weight.shape[1] == c
        assert [len(getattr(net.backbone, f"layer{i}"))
                for i in (1, 2, 3, 4)] == [3, 4, 23, 3]
        heads = net.classifier.conv2d_list
        assert [m.dilation for m in heads] == [(d, d) for d in (6, 12, 18,
                                                                24)]
        assert all(m.weight.shape == (19, 2048, 3, 3) for m in heads)
        assert all(not m.bias.any() for m in heads)
        assert abs(float(heads[0].weight.std()) - 0.01) < 5e-4
    again = deeplabv2_resnet101_thermal(device="cpu", seed=1)
    for k, v in thermal.state_dict().items():
        assert torch.equal(v, again.state_dict()[k]), k
    del rgb, again

    head = LegacyDeepLabV2(num_classes=19, layers=(1, 1, 1, 1)).classifier
    head.init_weights_(torch.Generator().manual_seed(0))
    x = torch.rand(5, 2048, 9, 17, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        want = head(x)
    calls = []
    head.conv2d_list[1].register_forward_hook(
        lambda m, i, o: calls.append(o.shape[0]))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(aspp, "MAX_BRANCH_PIXELS", 2 * 9 * 17)
        with torch.no_grad():
            got = head(x)
    assert calls == [2, 2, 1]
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="LegacyDeepLabV2"):
        DeepLabV2(head="legacy", **TINY)
