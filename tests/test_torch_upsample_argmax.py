"""The port's fused upsample + argmax (kernels/upsample_argmax.py) against
the JAX package's Pallas kernel (interpret mode) and its XLA composite, the
kernel's host-side launch plan (tiles, staged spans, shared memory), and
(tests marked gpu) the CUDA kernel against its plain version on the card:

    python -m pytest --noconftest tests/test_torch_upsample_argmax.py -m gpu

Tolerances: ``pred`` exact except where the JAX top-2 logit gap is below
1e-5 (float32 reassociation may flip a genuine near-tie); ``conf`` within
rtol 1e-4, atol 1e-5 (the JAX package's own kernel tolerance).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from thermal_semantic_segmentation_torch.kernels.upsample_argmax import (  # noqa: E402
    SMEM_LIMIT, TARGET_THREADS, VEC, launch_plan, upsample_argmax,
    upsample_argmax_reference)
from thermal_semantic_segmentation_torch.ops.resize import (  # noqa: E402
    interp_taps_np, upsample_logits)

TIE_GAP = 1e-5
CONF_RTOL, CONF_ATOL = 1e-4, 1e-5

# (N, h, w, C) -> (out_h, out_w) cases that exercise the kernel's tiling:
# the serving shape, several row tiles with a ragged last tile in both axes,
# downsampling, a single output row or column, a runtime class count above 13
TILING_CASES = [
    ((8, 33, 65, 13), (256, 512)),
    ((2, 33, 65, 13), (250, 509)),
    ((1, 40, 70, 13), (17, 31)),
    ((2, 9, 17, 13), (1, 128)),
    ((2, 9, 17, 13), (64, 1)),
    ((2, 9, 17, 19), (64, 128)),
    # the logits' own size: hard pseudo-labels (batch 4), prototypes (64)
    ((4, 33, 65, 13), (33, 65)),
    ((64, 33, 65, 13), (33, 65)),
]


@pytest.fixture(scope="module")
def jax_ref():
    """The JAX oracle, imported here so that the card's machine, which has
    no JAX, can still run this file's gpu tests."""
    jax = pytest.importorskip("jax")
    from thermal_semantic_segmentation_tpu.ops import pallas_kernels, resize
    return jax, pallas_kernels.upsample_argmax, resize


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _logits(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _assert_matches(pred, conf, want_pred, want_conf, up_ref):
    top2 = np.sort(np.asarray(up_ref), axis=-1)[..., -2:]
    decided = (top2[..., 1] - top2[..., 0]) >= TIE_GAP
    pred, want_pred = np.asarray(pred), np.asarray(want_pred)
    assert pred.shape == want_pred.shape
    np.testing.assert_array_equal(pred[decided], want_pred[decided])
    np.testing.assert_allclose(np.asarray(conf), np.asarray(want_conf),
                               rtol=CONF_RTOL, atol=CONF_ATOL)


@pytest.mark.parametrize("shape,out_hw,tile_h", [
    ((2, 33, 65, 13), (256, 512), 64),
    ((1, 9, 17, 13), (64, 128), 32),
])
def test_plain_version_matches_jax_pallas_kernel(jax_ref, shape, out_hw,
                                                 tile_h):
    jax, jax_upsample_argmax, resize = jax_ref
    x = _logits(shape, seed=sum(shape))
    want_pred, want_conf = jax_upsample_argmax(jax.numpy.asarray(x), *out_hw,
                                               tile_h=tile_h, interpret=True)
    up = resize.resize_bilinear(jax.numpy.asarray(x), *out_hw)
    before = upsample_argmax.launches
    pred, conf = upsample_argmax(torch.from_numpy(x), *out_hw)
    assert upsample_argmax.launches == before   # a CPU tensor: no kernel
    assert pred.dtype == torch.int32 and conf.dtype == torch.float32
    _assert_matches(pred.numpy(), conf.numpy(), want_pred, want_conf, up)


def test_plain_version_matches_jax_composite_at_ragged_size(jax_ref):
    """61x127 is no multiple of the TPU kernel's row tile: hold the port to
    the XLA composite (resize_bilinear, argmax, max softmax) there."""
    jax, _, resize = jax_ref
    x = _logits((3, 9, 17, 13), seed=5)
    up = resize.resize_bilinear(jax.numpy.asarray(x), 61, 127)
    want_pred = jax.numpy.argmax(up, -1)
    want_conf = jax.numpy.max(jax.nn.softmax(up, -1), -1)
    pred, conf = upsample_argmax_reference(torch.from_numpy(x), 61, 127)
    _assert_matches(pred.numpy(), conf.numpy(), want_pred, want_conf, up)


@pytest.mark.parametrize("in_size,out_size", [
    (33, 256), (65, 512), (9, 61), (17, 127), (5, 5), (1, 4), (7, 1),
    (12, 5)])
def test_interp_taps_rebuild_the_jax_matrix_exactly(jax_ref, in_size,
                                                    out_size):
    """The kernel's 2-tap tables carry the JAX weights bit for bit."""
    _, _, resize = jax_ref
    lo, hi, w_hi = interp_taps_np(in_size, out_size)
    m = np.zeros((out_size, in_size), np.float32)
    rows = np.arange(out_size)
    m[rows, lo] += np.float32(1.0) - w_hi
    m[rows, hi] += w_hi
    np.testing.assert_array_equal(
        m, resize._interp_matrix_np(in_size, out_size, True))


def _tiles(size, tile, count):
    return [range(t * tile, min((t + 1) * tile, size)) for t in range(count)]


@pytest.mark.parametrize("shape,out_hw", TILING_CASES)
def test_launch_plan_tiles_cover_the_output_and_fit(shape, out_hw):
    n, h, w, c = shape
    out_h, out_w = out_hw
    plan = launch_plan(n, w, c, out_h, out_w)
    assert plan.grid[2] == n
    # every output row and column falls in exactly one non-empty tile
    for size, tile, count in ((out_h, plan.tile_h, plan.grid[1]),
                              (out_w, plan.tile_w, plan.grid[0])):
        tiles = _tiles(size, tile, count)
        assert all(len(t) for t in tiles)
        assert sorted(i for t in tiles for i in t) == list(range(size))
    # each column tile's staged span [lo of its first column, + span)
    # covers both taps of every column in it
    lo, hi, _ = interp_taps_np(w, out_w)
    for cols in _tiles(out_w, plan.tile_w, plan.grid[0]):
        c0 = lo[cols[0]]
        assert all(c0 <= lo[x] and hi[x] < c0 + plan.span for x in cols)
    assert plan.span <= w
    # staged columns hold every class, as float4s, spread over bank groups
    assert plan.pitch >= c and plan.pitch % 4 == 0 and plan.pitch // 4 % 2
    assert plan.tile_w % VEC == 0 and plan.threads <= TARGET_THREADS
    assert 1 <= plan.block_h <= plan.tile_h
    assert plan.smem_bytes <= SMEM_LIMIT


def test_launch_plan_rejects_rows_over_shared_memory():
    with pytest.raises(ValueError, match="shared"):
        launch_plan(1, 17, 8000, 64, 128)


def test_wrapper_rejects_non_4d_input():
    with pytest.raises(ValueError, match="expected"):
        upsample_argmax(torch.zeros(9, 17, 13), 64, 128)


@pytest.mark.gpu
@pytest.mark.parametrize("shape,out_hw,layout", [
    ((8, 33, 65, 13), (256, 512), "nhwc"),
    ((3, 9, 17, 13), (61, 127), "nhwc"),
    ((2, 33, 65, 13), (256, 512), "nchw"),     # strided NHWC view
    ((2, 9, 17, 5), (64, 128), "nhwc"),        # runtime class count
] + [(shape, out_hw, "nhwc") for shape, out_hw in TILING_CASES[1:]] + [
    ((2, 33, 65, 19), (250, 509), "nchw"),     # strided, runtime C, ragged
])
def test_kernel_matches_plain_version_on_card(cuda_device, shape, out_hw,
                                              layout):
    x = torch.from_numpy(_logits(shape, seed=1)).to(cuda_device)
    if layout == "nchw":
        x = x.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
    before = upsample_argmax.launches
    pred, conf = upsample_argmax(x, *out_hw)
    torch.cuda.synchronize()
    assert upsample_argmax.launches == before + 1
    want_pred, want_conf = upsample_argmax_reference(x, *out_hw)
    up = upsample_logits(x, *out_hw)
    _assert_matches(pred.cpu().numpy(), conf.cpu().numpy(),
                    want_pred.cpu().numpy(), want_conf.cpu().numpy(),
                    up.cpu().numpy())


@pytest.mark.gpu
def test_kernel_rejects_non_float32_on_card(cuda_device):
    with pytest.raises(TypeError, match="float32"):
        upsample_argmax(torch.zeros(1, 9, 17, 13, dtype=torch.float16,
                                    device=cuda_device), 64, 128)
