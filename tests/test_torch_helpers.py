"""The port's small helpers against the JAX package's: ``ops/pool.
global_avg_pool``, the Cityscapes class names, colours and
``decode_target`` (data/cityscapes.py), the profiler trace and its spans
and the numeric sanitizer (utils/observability.py), and
``core/prng.split_for_step`` against its contract (threefry's bits cannot
be drawn by torch).

Tolerances: the pool rtol 1e-6 (JAX tests/test_pool.py's); everything
else exact.
"""

import glob
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from thermal_semantic_segmentation_tpu.data import (  # noqa: E402
    cityscapes as jax_cityscapes)
from thermal_semantic_segmentation_tpu.ops import pool as jax_pool  # noqa: E402
from thermal_semantic_segmentation_tpu.utils import (  # noqa: E402
    observability as jax_obs)
from thermal_semantic_segmentation_torch.core.prng import (  # noqa: E402
    split_for_step)
from thermal_semantic_segmentation_torch.data import cityscapes  # noqa: E402
from thermal_semantic_segmentation_torch.ops.pool import (  # noqa: E402
    global_avg_pool)
from thermal_semantic_segmentation_torch.train.seg import (  # noqa: E402
    augment_generator)
from thermal_semantic_segmentation_torch.utils import observability  # noqa: E402,E501


@pytest.mark.parametrize("shape", [(2, 4, 4, 3), (3, 33, 65, 13), (1, 1, 7, 2)])
def test_global_avg_pool_matches_jax(shape):
    x = np.random.default_rng(len(shape) + shape[1]).standard_normal(
        shape).astype(np.float32)
    if shape == (2, 4, 4, 3):       # JAX tests/test_pool.py's input
        x = np.arange(np.prod(shape), dtype=np.float32).reshape(shape)
    got = global_avg_pool(torch.from_numpy(x))
    assert got.shape == (shape[0], shape[3])
    np.testing.assert_allclose(got.numpy(), np.asarray(
        jax_pool.global_avg_pool(jnp.asarray(x))), rtol=1e-6, atol=1e-7)


def test_cityscapes_classes_and_colours_equal_jax():
    assert cityscapes.CLASSES == jax_cityscapes.CLASSES
    assert len(cityscapes.CLASSES) == 19
    np.testing.assert_array_equal(cityscapes.TRAIN_ID_TO_COLOR,
                                  jax_cityscapes.TRAIN_ID_TO_COLOR)
    assert cityscapes.TRAIN_ID_TO_COLOR.dtype == np.uint8


@pytest.mark.parametrize("ids", [
    np.arange(13).reshape(1, 13),
    np.array([[-5, 0, 12, 13, 255]]),
    np.random.default_rng(5).integers(-3, 20, (2, 9, 11)),
], ids=["every_id", "out_of_range", "random"])
def test_decode_target_matches_jax(ids):
    got = cityscapes.decode_target(ids)
    want = jax_cityscapes.decode_target(ids)
    assert got.shape == ids.shape + (3,) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


def test_profiler_trace_holds_the_step_annotation(tmp_path):
    """A Chrome trace in ``logdir`` whose events name the span; with
    ``enabled=False`` nothing is written."""
    logdir = str(tmp_path / "trace")
    with observability.profiler_trace(logdir, device="cpu"):
        with observability.step_annotation("ckpt_io_span"):
            torch.ones(8).cumsum(0)
    files = glob.glob(os.path.join(logdir, "*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "ckpt_io_span" in names
    off = str(tmp_path / "off")
    with observability.profiler_trace(off, enabled=False, device="cpu"):
        torch.ones(2).sum()
    assert not os.path.exists(off)


def _nan(lib):
    return lib.log(lib.asarray(-1.0) if lib is jnp else torch.tensor(-1.0))


def _inf(lib):
    return (lib.asarray([1.0]) if lib is jnp else torch.tensor([1.0])) / 0.0


def _finite(lib):
    return lib.exp(lib.asarray(2.0) if lib is jnp else torch.tensor(2.0))


def _grad_inf(lib):
    """An Inf made only in the backward: the derivative of x ** 0.5 at 0
    (both packages compute 0.5 * x ** -0.5)."""
    if lib is jnp:
        return jax.grad(lambda x: x ** 0.5)(0.0)
    x = torch.tensor(0.0, requires_grad=True)
    (x ** 0.5).backward()
    return x.grad


OPS = {"nan": _nan, "inf": _inf, "finite": _finite, "grad_inf": _grad_inf}


def _raises(fn, lib) -> bool:
    try:
        out = fn(lib)
        if lib is jnp:
            jax.block_until_ready(out)
    except FloatingPointError:
        return True
    return False


@pytest.mark.parametrize("nans,infs", [(True, False), (False, True),
                                       (True, True)])
def test_debug_mode_raises_where_jax_does(nans, infs):
    """Under ``enable_debug_mode(nans, infs)`` each operation raises
    ``FloatingPointError`` exactly where JAX under ``jax_debug_nans`` /
    ``jax_debug_infs`` does; off again, nothing raises."""
    got, want = {}, {}
    try:
        observability.enable_debug_mode(nans, infs)
        got = {k: _raises(fn, torch) for k, fn in OPS.items()}
    finally:
        observability.enable_debug_mode(False, False)
    try:
        jax_obs.enable_debug_mode(nans, infs)
        # the flags reach operations compiled before they were set (an
        # earlier test's) only through a fresh dispatch
        jax.clear_caches()
        want = {k: _raises(fn, jnp) for k, fn in OPS.items()}
    finally:
        jax.config.update("jax_debug_nans", False)
        jax.config.update("jax_debug_infs", False)
        jax.clear_caches()
    print(f"port {got}, JAX {want}")
    assert got == want
    assert got["nan"] == nans and got["inf"] == got["grad_inf"] == infs
    assert not got["finite"]
    assert not any(_raises(fn, torch) for fn in OPS.values())


def test_split_for_step_contract():
    """The same (seed, step, key) gives the same draws on a fresh
    generator; another step, seed or key others; the device augmentation's
    generator is ``split_for_step`` at ``dropout_seed + 1``."""
    def draws(*a):
        return torch.rand(64, generator=split_for_step("cpu", *a))

    assert torch.equal(draws(3, 0), draws(3, 0))
    assert torch.equal(draws(3, 5, 1), draws(3, 5, 1))
    streams = [draws(3, 0), draws(3, 1), draws(4, 0), draws(3, 0, 1),
               draws(3, 5, 2)]
    for i, a in enumerate(streams):
        assert not any(torch.equal(a, b) for b in streams[i + 1:])
    gen = split_for_step(torch.device("cpu"), 7, 2)
    assert isinstance(gen, torch.Generator) and gen.device.type == "cpu"
    assert torch.equal(
        torch.rand(16, generator=augment_generator(torch.device("cpu"), 6, 2,
                                                   1)),
        torch.rand(16, generator=split_for_step("cpu", 7, 2, 1)))
