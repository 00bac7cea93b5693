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
    jax_variables_to_state_dict)
from thermal_semantic_segmentation_torch.models.deeplab import (  # noqa: E402
    DeepLabV2, create_deeplab)
from thermal_semantic_segmentation_torch.ops.pool import (  # noqa: E402
    max_pool_ceil)
from thermal_semantic_segmentation_torch.ops.resize import (  # noqa: E402
    resize_bilinear)

FORWARD_ATOL = 5e-4
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


def test_legacy_head_is_not_yet_ported():
    with pytest.raises(NotImplementedError, match="not yet ported"):
        DeepLabV2(head="legacy", **TINY)
