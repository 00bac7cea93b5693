"""``--wire packed_bf16`` in the port (``data/device_pipeline.py``,
``cli/_common.resolve_wire``) against the JAX package's wire format, on the
CPU.

A float32 array comes back float32 with the bfloat16 value JAX's
``unpack_batch(pack_batch(..., float_wire='bfloat16'))`` gives it, bit for
bit (both round to nearest even); integers, booleans and other floats keep
their values. ``resolve_wire`` downgrades to 'packed' where JAX's does.
"""

import logging
from argparse import Namespace

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from thermal_semantic_segmentation_torch.cli._common import (
    resolve_wire as port_resolve_wire)
from thermal_semantic_segmentation_torch.data.device_pipeline import (
    device_prefetch)
from thermal_semantic_segmentation_tpu.cli._common import (
    resolve_wire as jax_resolve_wire)
from thermal_semantic_segmentation_tpu.data.wire import (pack_batch,
                                                          unpack_batch)


def _batch(seed=0, b=4):
    rng = np.random.default_rng(seed)
    image = rng.standard_normal((b, 16, 24, 1)).astype(np.float32) * 100
    # values that round differently: ties to even, the largest float32,
    # infinities, subnormals, signed zeros
    image.flat[:10] = np.array(
        [1.00390625, 1.01171875, -1.00390625, 3.4028235e38, np.inf, -np.inf,
         1e-40, -1e-42, 0.0, -0.0], np.float32)
    return {
        "image": image,
        "label": rng.integers(0, 13, (b, 16, 24)).astype(np.int64),
        "weak_params": {
            "crop": rng.integers(-4, 4000, (b, 4)).astype(np.int64),
            "flip": rng.integers(0, 2, (b,)).astype(bool)},
        "img_path": [f"img_{i}.png" for i in range(b)],
    }


def _bits(x: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(x, np.float32).view(np.uint32)


@pytest.mark.parametrize("seed", [0, 1])
def test_packed_bf16_equals_jax_wire_bit_for_bit(seed):
    """Floats bit-equal to JAX's bf16 wire (float32 out); the other arrays
    equal in value to what JAX's wire restores, in their own dtypes;
    strings untouched."""
    batch = _batch(seed)
    host, packed, spec = pack_batch(batch, float_wire="bfloat16")
    want = unpack_batch(jnp.asarray(packed), host, spec)
    got, = device_prefetch([batch], "cpu", wire="packed_bf16")
    assert got["image"].dtype == torch.float32
    np.testing.assert_array_equal(_bits(got["image"].numpy()),
                                  _bits(np.asarray(want["image"])))
    assert not np.array_equal(got["image"].numpy(), batch["image"])
    np.testing.assert_array_equal(got["label"].numpy(),
                                  np.asarray(want["label"]))
    assert got["label"].dtype == torch.int64
    for k in ("crop", "flip"):
        np.testing.assert_array_equal(got["weak_params"][k].numpy(),
                                      np.asarray(want["weak_params"][k]))
    assert got["img_path"] == batch["img_path"]


@pytest.mark.parametrize("wire", [None, "none", "packed"])
def test_lossless_wires_keep_every_value(wire):
    batch = _batch()
    got, = device_prefetch([batch], "cpu", wire=wire)
    np.testing.assert_array_equal(_bits(got["image"].numpy()),
                                  _bits(batch["image"]))
    assert torch.equal(got["label"], torch.from_numpy(batch["label"]))


def test_packed_bf16_keeps_float64_and_refuses_unknown_wires():
    """Only float32 travels as bfloat16 (a float64 array is not a float32
    one); an unknown mode is an error, as in JAX's device_prefetch."""
    x = np.linspace(0, 1, 7)
    got, = device_prefetch([{"x": x}], "cpu", wire="packed_bf16")
    assert got["x"].dtype == torch.float64
    np.testing.assert_array_equal(got["x"].numpy(), x)
    with pytest.raises(ValueError, match="unknown wire mode"):
        list(device_prefetch([{"x": x}], "cpu", wire="bf16"))


@pytest.mark.parametrize("wire", ["none", "packed", "packed_bf16"])
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("bf16_compute", [None, False, True])
def test_resolve_wire_downgrades_as_jax(wire, bf16, bf16_compute, caplog):
    """The same mode as JAX's ``resolve_wire`` for every flag combination,
    and its warning exactly when packed_bf16 falls back to packed."""
    args = Namespace(wire=wire, bf16=bf16)
    with caplog.at_level(logging.WARNING):
        got = port_resolve_wire(args, bf16_compute=bf16_compute)
    warned = [r for r in caplog.records if "packed_bf16" in r.getMessage()]
    caplog.clear()
    with caplog.at_level(logging.WARNING):
        want = jax_resolve_wire(args, bf16_compute=bf16_compute)
    want_warned = [r for r in caplog.records
                   if "packed_bf16" in r.getMessage()]
    assert got == want
    assert [r.getMessage() for r in warned] == [
        r.getMessage() for r in want_warned]
