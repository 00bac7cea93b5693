"""The port's flax-format checkpoints (core/checkpoint.py: written at once
or in the background by ``AsyncCheckpointer``) and its loading of the JAX
package's msgpack seg checkpoints (cli/_common.py) against flax and the
JAX package.

The port writes the bytes ``flax.serialization.msgpack_serialize`` writes
for the tree the JAX ``save_checkpoint`` makes, reads flax's files into the
same arrays, dtypes and scalars, and a JAX msgpack seg checkpoint loads into
a model whose forward is within 5e-4 of the JAX model's.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import msgpack  # noqa: E402
from flax import serialization  # noqa: E402

from tests.test_torch_deeplab import (FORWARD_ATOL, HW,  # noqa: E402
                                      jax_deeplab_with_twin)
from thermal_semantic_segmentation_tpu.cli import (  # noqa: E402
    _common as jax_common)
from thermal_semantic_segmentation_tpu.core import (  # noqa: E402
    checkpoint as jax_checkpoint)
from thermal_semantic_segmentation_torch.cli._common import (  # noqa: E402
    apply_model_meta, build_deeplab, load_seg_checkpoint)
from thermal_semantic_segmentation_torch.cli.options import (  # noqa: E402
    evaluation_parse)
from thermal_semantic_segmentation_torch.core import checkpoint  # noqa: E402


def _payload(rng):
    """A tree like the JAX package's checkpoints: nested dicts of arrays of
    several dtypes and shapes, Python and numpy scalars, a list, None."""
    return {
        "variables": {"params": {"w": rng.standard_normal((3, 4, 2)).astype(
            np.float32), "b": rng.standard_normal(5)},
            "batch_stats": {"mean": rng.integers(-9, 9, (7,)).astype(np.int8),
                            "empty": np.zeros((0, 3), np.uint16)}},
        "epoch": 12, "val_loss": 0.25, "best": np.float32(0.5),
        "step": np.int64(-300), "layers": [3, 4, 23, 3], "done": True,
        "objective_vectors": rng.standard_normal((13, 256)).astype(
            np.float32),
        "counts": rng.integers(0, 3000, 13).astype(np.float32),
        "mask": rng.random((2, 2)) > 0.5, "big": np.arange(70000, dtype=np.int32),
        "nothing": None,
    }


def _assert_trees_equal(got, want):
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want)
        for k in want:
            _assert_trees_equal(got[k], want[k])
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want)
        for g, w in zip(got, want):
            _assert_trees_equal(g, w)
    elif want is None:
        assert got is None
    else:
        g, w = np.asarray(got), np.asarray(want)
        assert type(got) is type(want), (type(got), type(want))
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def test_port_writes_the_bytes_flax_writes(tmp_path):
    payload = _payload(np.random.default_rng(0))
    want = serialization.msgpack_serialize(jax.tree.map(np.asarray, payload))
    assert checkpoint.checkpoint_bytes(payload) == want
    # tensors are leaves too
    with_tensors = dict(payload, objective_vectors=torch.from_numpy(
        payload["objective_vectors"]))
    assert checkpoint.checkpoint_bytes(with_tensors) == want
    checkpoint.save_checkpoint(str(tmp_path / "sub" / "p"), payload)
    assert os.listdir(tmp_path / "sub") == ["p"]     # no temporary left
    restored = serialization.msgpack_restore((tmp_path / "sub" / "p"
                                              ).read_bytes())
    _assert_trees_equal(restored, jax.tree.map(np.asarray, payload))


@pytest.mark.parametrize("kind", ["arrays", "tensors"])
def test_async_checkpointer_keeps_the_last_save(tmp_path, kind):
    """JAX tests/test_checkpoint.py's case: three saves in a row, then
    ``wait``; the file holds the last, byte for byte what JAX's
    ``AsyncCheckpointer`` writes for the same saves (numpy leaves, or
    tensors on the port's side)."""
    ours, theirs = checkpoint.AsyncCheckpointer(), \
        jax_checkpoint.AsyncCheckpointer()
    for i in range(3):
        v = np.full(8, float(i))
        ours.save(str(tmp_path / "a"), {"step": i, "v": torch.from_numpy(v)
                                        if kind == "tensors" else v})
        theirs.save(str(tmp_path / "j"), {"step": i, "v": v})
    ours.wait()
    theirs.wait()
    back = checkpoint.load_checkpoint(str(tmp_path / "a"))
    assert back["step"] == 2
    np.testing.assert_array_equal(back["v"], np.full(8, 2.0))
    assert (tmp_path / "a").read_bytes() == (tmp_path / "j").read_bytes()


def test_async_file_is_the_jax_save_checkpoint_file(tmp_path):
    """Every kind of leaf of the flax-format tests: the background write is
    the file JAX's synchronous ``save_checkpoint`` writes."""
    payload = _payload(np.random.default_rng(3))
    ck = checkpoint.AsyncCheckpointer()
    ck.save(str(tmp_path / "a"), payload)
    jax_checkpoint.save_checkpoint(str(tmp_path / "j"), payload)
    ck.wait()
    assert (tmp_path / "a").read_bytes() == (tmp_path / "j").read_bytes()


def test_async_save_snapshots_before_it_returns(tmp_path, monkeypatch):
    """A CPU tensor and a numpy array changed in place as soon as ``save``
    returns (the writer held back until then) read back as they were at
    the save: ``save`` copies them, where ``detach().cpu()`` and
    ``np.asarray`` would not."""
    import threading
    go = threading.Event()
    real = checkpoint.save_checkpoint

    def held(path, payload):
        assert go.wait(30)
        real(path, payload)

    monkeypatch.setattr(checkpoint, "save_checkpoint", held)
    t = torch.arange(6, dtype=torch.float32)
    a = np.arange(4, dtype=np.int64)
    ck = checkpoint.AsyncCheckpointer()
    ck.save(str(tmp_path / "a"), {"t": t, "nested": {"a": a}})
    t.add_(100.0)
    a *= -1
    go.set()
    ck.wait()
    back = checkpoint.load_checkpoint(str(tmp_path / "a"))
    np.testing.assert_array_equal(back["t"], np.arange(6, dtype=np.float32))
    np.testing.assert_array_equal(back["nested"]["a"], np.arange(4))


@pytest.mark.parametrize("then", ["wait", "save"])
def test_async_write_error_is_raised(tmp_path, then):
    """A write that fails in the background (its directory cannot be made:
    a file is in the way) raises from ``wait``, or from the next ``save``,
    once; JAX's daemon thread loses it."""
    (tmp_path / "file").write_bytes(b"")
    ck = checkpoint.AsyncCheckpointer()
    ck.save(str(tmp_path / "file" / "ck"), {"v": np.ones(2)})
    with pytest.raises(OSError):
        if then == "wait":
            ck.wait()
        else:
            ck.save(str(tmp_path / "ok"), {"v": np.ones(2)})
    ck.save(str(tmp_path / "ok"), {"v": np.zeros(2)})
    ck.wait()
    np.testing.assert_array_equal(
        checkpoint.load_checkpoint(str(tmp_path / "ok"))["v"], np.zeros(2))


def test_port_reads_jax_checkpoints(tmp_path):
    payload = _payload(np.random.default_rng(1))
    jax_checkpoint.save_checkpoint(str(tmp_path / "j"), payload)
    got = checkpoint.load_checkpoint(str(tmp_path / "j"))
    _assert_trees_equal(got, jax_checkpoint.load_checkpoint(
        str(tmp_path / "j")))
    # numpy scalars as flax packs them on their own (ext type 3)
    raw = serialization.msgpack_serialize({"s": np.float16(1.5),
                                           "i": np.uint8(7)})
    _assert_trees_equal(checkpoint.checkpoint_from_bytes(raw),
                        serialization.msgpack_restore(raw))


def test_chunked_arrays_both_ways(tmp_path, monkeypatch):
    """Arrays over the chunk size travel as __msgpack_chunked_array__ dicts
    (flax's chunk size made small here)."""
    rng = np.random.default_rng(2)
    payload = {"w": rng.standard_normal((5, 7)).astype(np.float32),
               "nested": {"v": np.arange(11, dtype=np.int64)},
               "small": np.ones(2, np.float32)}
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 24)
    monkeypatch.setattr(checkpoint, "MAX_CHUNK_SIZE", 24)
    raw = serialization.msgpack_serialize(jax.tree.map(np.asarray, payload))
    assert b"__msgpack_chunked_array__" in raw
    _assert_trees_equal(checkpoint.checkpoint_from_bytes(raw),
                        serialization.msgpack_restore(raw))
    _assert_trees_equal(checkpoint.checkpoint_from_bytes(raw),
                        jax.tree.map(np.asarray, payload))
    assert checkpoint.checkpoint_bytes(payload) == raw


def test_bfloat16_reads_as_a_bfloat16_tensor(tmp_path):
    values = np.array([[1.5, -2.25], [3.0, 1e-3]], np.float32)
    jax_checkpoint.save_checkpoint(str(tmp_path / "bf"), {
        "x": jnp.asarray(values, jnp.bfloat16)})
    got = checkpoint.load_checkpoint(str(tmp_path / "bf"))["x"]
    assert got.dtype == torch.bfloat16 and got.shape == (2, 2)
    want = torch.from_numpy(values).to(torch.bfloat16)
    assert torch.equal(got, want)
    # and back: a bfloat16 tensor is written as flax writes a bfloat16 array
    raw = checkpoint.checkpoint_bytes({"x": want})
    assert raw == serialization.msgpack_serialize(
        {"x": np.asarray(jnp.asarray(values, jnp.bfloat16))})


@pytest.mark.parametrize("obj", [
    {"ints": [0, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32,
              2**64 - 1, -1, -32, -33, -128, -129, -2**15, -2**15 - 1,
              -2**31, -2**31 - 1, -2**63]},
    {"floats": [0.0, -1.5, 1e300, float("inf")], "flags": [True, False],
     "nil": None},
    {"str": ["", "x" * 31, "y" * 32, "z" * 255, "w" * 256, "é" * 40000]},
    {"bin": [b"", b"a" * 255, b"b" * 256, b"c" * 70000]},
    {"list": list(range(15)), "list16": list(range(16)),
     "map16": {str(i): i for i in range(16)}, "deep": [[{"a": [1]}]]},
], ids=["ints", "floats", "str", "bin", "containers"])
def test_msgpack_subset_matches_msgpack(obj):
    raw = msgpack.packb(obj)
    assert checkpoint.checkpoint_from_bytes(raw) == msgpack.unpackb(raw)
    out = []
    checkpoint._pack(out, obj)
    assert b"".join(out) == raw


@pytest.mark.parametrize("data", [
    b"", b"\x82\xa1a", b"\xc1", b"\x81\xa1a\xd4\x05\x00", b"\x90\x90"],
    ids=["empty", "truncated", "never-used-byte", "foreign-ext",
         "trailing"])
def test_malformed_bytes_are_refused(data):
    with pytest.raises(ValueError):
        checkpoint.checkpoint_from_bytes(data)


@pytest.fixture(scope="module")
def jax_seg_checkpoint(tmp_path_factory):
    """A JAX msgpack seg checkpoint with its architecture meta, written by
    the JAX package's own save_seg_checkpoint."""
    root = tmp_path_factory.mktemp("seg")
    model, variables, _ = jax_deeplab_with_twin(5)
    jax_common.save_seg_checkpoint(str(root / "s.pth"), variables, epoch=4,
                                   val_loss=0.75, layers=[1, 1, 1, 1],
                                   num_channels=1, num_classes=13)
    return root / "s.pth", model, variables


def test_jax_seg_checkpoint_loads_and_forwards_as_jax(jax_seg_checkpoint):
    path, model, variables = jax_seg_checkpoint
    state_dict, meta = load_seg_checkpoint(str(path))
    assert int(meta["epoch"]) == 4 and float(meta["val_loss"]) == 0.75
    assert meta["layers"] == [1, 1, 1, 1] and meta["num_classes"] == 13
    args = evaluation_parse().parse_args(["--device", "cpu"])
    apply_model_meta(args, meta)
    assert args.layers == (1, 1, 1, 1) and args.net_mode == "one_channel"
    twin = build_deeplab(args, device="cpu")
    twin.load_state_dict(state_dict, strict=True)
    x = np.random.default_rng(6).uniform(0, 1, (2, *HW, 1)).astype(np.float32)
    want = model.apply(variables, jnp.asarray(x), train=False)
    with torch.no_grad():
        got = twin(torch.from_numpy(x).permute(0, 3, 1, 2))
    for key in ("out", "feat"):
        np.testing.assert_allclose(got[key].permute(0, 2, 3, 1).numpy(),
                                   np.asarray(want[key]), rtol=0,
                                   atol=FORWARD_ATOL, err_msg=key)


def test_files_that_are_no_seg_checkpoint_are_refused(tmp_path):
    (tmp_path / "junk").write_bytes(b"\x92\x01\x02")
    with pytest.raises(ValueError, match="without the seg checkpoint"):
        load_seg_checkpoint(str(tmp_path / "junk"))
    (tmp_path / "text").write_bytes(b"not a checkpoint at all")
    with pytest.raises(ValueError, match="neither a torch .pth nor"):
        load_seg_checkpoint(str(tmp_path / "text"))
