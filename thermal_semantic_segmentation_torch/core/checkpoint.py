"""Checkpoints in the JAX package's format, read and written without flax or
msgpack (counterpart of the JAX ``core/checkpoint.py``).

The JAX package writes every checkpoint (seg weights, prototypes, GAN
state) as ``flax.serialization.msgpack_serialize`` of a tree of dicts whose
leaves it first turns into numpy arrays. That format is msgpack
(``packb(tree, strict_types=True)``) with two extension types:

- ext 1, an ndarray: the msgpack bytes of ``(shape, dtype.name,
  row-major buffer)``;
- ext 3, a numpy scalar: the same bytes of a 0-d array.

An array of more than ``MAX_CHUNK_SIZE`` bytes held in a dict is stored as
``{'__msgpack_chunked_array__': True, 'shape': {'0': d0, ...}, 'chunks':
{'0': flat_chunk, ...}}`` (msgpack objects stop at 2**31 - 1 bytes).
'bfloat16' has no numpy dtype: such a leaf reads back as a
``torch.bfloat16`` tensor.

This module implements the msgpack subset that flax emits (maps, arrays,
str, bin, int, float, bool, nil and ext), so a file written here is the file
flax writes for the same tree, and flax's files read here.

``AsyncCheckpointer`` writes those files from a background thread. The
sharded checkpoints of a process group (``save_sharded``, ``load_sharded``)
are ``torch.distributed.checkpoint`` directories, where the JAX package
writes orbax ones: each rank writes only its own shards.
"""

from __future__ import annotations

import os
import struct
import tempfile
import threading
from collections.abc import Mapping
from typing import Any, Dict, Optional

import numpy as np
import torch

MAX_CHUNK_SIZE = 2**30      # flax's MAX_CHUNK_SIZE
_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3
_CHUNKED = "__msgpack_chunked_array__"
_FIXEXT = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}


class _Leaf:
    """An array leaf to write: its numpy buffer and its dtype's name (which
    differs from ``array.dtype.name`` only for bfloat16, held as int16)."""

    __slots__ = ("array", "dtype_name")

    def __init__(self, array: np.ndarray, dtype_name: str):
        self.array, self.dtype_name = array, dtype_name


def _leaf(x) -> _Leaf:
    """A leaf as the JAX package's ``_to_numpy`` leaves it: every scalar,
    numpy value and tensor becomes an ndarray (0-d for a scalar)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            return _Leaf(x.contiguous().view(torch.int16).numpy(), "bfloat16")
        x = x.numpy()
    a = np.asarray(x)
    if a.dtype.hasobject or a.dtype.isalignedstruct:
        raise TypeError(f"cannot store a {a.dtype} array in a checkpoint")
    return _Leaf(a, a.dtype.name)


def _chunk(leaf: _Leaf) -> dict:
    """flax's ``_chunk``: the flat array in pieces of MAX_CHUNK_SIZE bytes."""
    a = leaf.array
    size = max(1, int(MAX_CHUNK_SIZE / a.dtype.itemsize))
    flat = a.reshape(-1)
    return {_CHUNKED: True,
            "shape": {str(i): d for i, d in enumerate(a.shape)},
            "chunks": {str(i): _Leaf(flat[s:s + size], leaf.dtype_name)
                       for i, s in enumerate(range(0, flat.size, size))}}


def _prepare(tree, top: bool = True):
    """The tree flax would pack: containers kept (dict keys sorted, as
    ``jax.tree.map`` rebuilds them), leaves as ``_Leaf``, and the arrays
    held in a dict (or at the top) over MAX_CHUNK_SIZE chunked."""
    if isinstance(tree, Mapping):
        out = {}
        for k in sorted(tree):
            if not isinstance(k, str):
                raise TypeError(f"checkpoint keys must be str, got {k!r}")
            v = _prepare(tree[k], top=False)
            if isinstance(v, _Leaf) and v.array.nbytes > MAX_CHUNK_SIZE:
                v = _chunk(v)
            out[k] = v
        return out
    if isinstance(tree, (list, tuple)):
        return [_prepare(v, top=False) for v in tree]
    if tree is None:
        return None
    leaf = _leaf(tree)
    return _chunk(leaf) if top and leaf.array.nbytes > MAX_CHUNK_SIZE else leaf


def _pack_len(out: list, n: int, fix: int | None, fix_max: int,
              codes: tuple) -> None:
    """A length header: the fix form below ``fix_max``, else the 8/16/32-bit
    form of ``codes`` (None where the format has no such form)."""
    if fix is not None and n < fix_max:
        out.append(bytes((fix | n,)))
        return
    for code, fmt, limit in zip(codes, ("B", ">H", ">I"),
                                (0xFF, 0xFFFF, 0xFFFFFFFF)):
        if code is not None and n <= limit:
            out.append(bytes((code,)) + struct.pack(fmt, n))
            return
    raise ValueError(f"msgpack cannot hold an object of length {n}")


def _pack_int(out: list, x: int) -> None:
    if 0 <= x < 0x80 or -32 <= x < 0:
        out.append(struct.pack("b" if x < 0 else "B", x))
        return
    forms = ((0xCC, ">B", 0, 0xFF), (0xCD, ">H", 0, 0xFFFF),
             (0xCE, ">I", 0, 0xFFFFFFFF), (0xCF, ">Q", 0, 2**64 - 1),
             (0xD0, ">b", -0x80, -1), (0xD1, ">h", -0x8000, -1),
             (0xD2, ">i", -2**31, -1), (0xD3, ">q", -2**63, -1))
    for code, fmt, lo, hi in forms:
        if lo <= x <= hi:
            out.append(bytes((code,)) + struct.pack(fmt, x))
            return
    raise OverflowError(f"integer {x} does not fit in 64 bits")


def _pack_ext(out: list, code: int, pieces: list) -> None:
    """An ext object whose data is the concatenation of ``pieces``
    (appended as they are, not joined)."""
    n = sum(len(p) for p in pieces)
    if n in _FIXEXT:
        out.append(bytes((_FIXEXT[n], code)))
    else:
        _pack_len(out, n, None, 0, (0xC7, 0xC8, 0xC9))
        out.append(bytes((code,)))
    out.extend(pieces)


def _buffer(a: np.ndarray) -> memoryview:
    """The row-major bytes of ``a`` (``a.tobytes("C")``) as a view of its
    memory, copied only where ``a`` is not C-contiguous."""
    return memoryview(np.ascontiguousarray(a).reshape(-1).view(np.uint8))


def _pack(out: list, x) -> None:
    """Append the msgpack bytes of ``x`` to ``out``, as ``msgpack.packb``
    with its defaults (``use_bin_type=True``, doubles) encodes it."""
    if x is None:
        out.append(b"\xc0")
    elif x is True or x is False:
        out.append(b"\xc3" if x else b"\xc2")
    elif isinstance(x, _Leaf):
        inner: list = []
        _pack(inner, [list(x.array.shape), x.dtype_name,
                      _buffer(x.array)])
        _pack_ext(out, _EXT_NDARRAY, inner)
    elif isinstance(x, int):
        _pack_int(out, x)
    elif isinstance(x, float):
        out.append(b"\xcb" + struct.pack(">d", x))
    elif isinstance(x, str):
        data = x.encode("utf-8")
        _pack_len(out, len(data), 0xA0, 32, (0xD9, 0xDA, 0xDB))
        out.append(data)
    elif isinstance(x, (bytes, bytearray, memoryview)):
        _pack_len(out, len(x), None, 0, (0xC4, 0xC5, 0xC6))
        out.append(x)
    elif isinstance(x, dict):
        _pack_len(out, len(x), 0x80, 16, (None, 0xDE, 0xDF))
        for k, v in x.items():
            _pack(out, k)
            _pack(out, v)
    elif isinstance(x, list):
        _pack_len(out, len(x), 0x90, 16, (None, 0xDC, 0xDD))
        for v in x:
            _pack(out, v)
    else:
        raise TypeError(f"cannot pack {type(x).__name__}")


def _pieces(payload: Dict[str, Any]) -> list:
    """The msgpack bytes of ``payload``'s checkpoint tree as a list of
    bytes objects and views of the arrays' memory, in order."""
    out: list = []
    _pack(out, _prepare(payload))
    return out


def checkpoint_bytes(payload: Dict[str, Any]) -> bytes:
    """The bytes ``flax.serialization.msgpack_serialize`` gives for the tree
    the JAX package's ``save_checkpoint`` makes of ``payload``."""
    return b"".join(_pieces(payload))


def save_checkpoint(path: str, payload: Dict[str, Any]) -> None:
    """Atomically write a dict of trees and scalars to ``path``: into a
    temporary file beside it, then ``os.replace``. Leaves may be numpy
    arrays, numpy or Python scalars, or tensors (copied to the host). The
    file is ``checkpoint_bytes(payload)``, written piece by piece from the
    arrays' own memory (no joined copy; the interpreter's lock is free
    while the file takes them)."""
    pieces = _pieces(payload)
    directory = os.path.dirname(os.path.abspath(path))
    os.makedirs(directory, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            f.writelines(pieces)
        os.replace(tmp, path)
    except BaseException:
        os.unlink(tmp)
        raise


class _Reader:
    """Decodes one msgpack object at a time from ``buf``; raises ValueError
    on bytes that are not the subset flax writes."""

    def __init__(self, buf):
        self.buf = memoryview(buf)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("truncated msgpack data")
        view = self.buf[self.pos:self.pos + n]
        self.pos += n
        return view

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def read(self):
        b = self.take(1)[0]
        if b < 0x80:
            return b
        if b >= 0xE0:
            return b - 0x100
        if b < 0x90:
            return self.map(b & 0x0F)
        if b < 0xA0:
            return self.array(b & 0x0F)
        if b < 0xC0:
            return str(self.take(b & 0x1F), "utf-8")
        if b == 0xC0:
            return None
        if b in (0xC2, 0xC3):
            return b == 0xC3
        sized = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I",      # bin
                 0xD9: ">B", 0xDA: ">H", 0xDB: ">I",      # str
                 0xDC: ">H", 0xDD: ">I", 0xDE: ">H", 0xDF: ">I"}
        if b in sized:
            n = self.unpack(sized[b])
            if b <= 0xC6:
                return bytes(self.take(n))
            if b <= 0xDB:
                return str(self.take(n), "utf-8")
            return self.array(n) if b <= 0xDD else self.map(n)
        numbers = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H",
                   0xCE: ">I", 0xCF: ">Q", 0xD0: ">b", 0xD1: ">h",
                   0xD2: ">i", 0xD3: ">q"}
        if b in numbers:
            return self.unpack(numbers[b])
        if 0xD4 <= b <= 0xD8:
            n = 1 << (b - 0xD4)
        elif b in (0xC7, 0xC8, 0xC9):
            n = self.unpack({0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}[b])
        else:
            raise ValueError(f"msgpack type byte 0x{b:02x} is not in the "
                             f"subset flax writes")
        code = self.unpack(">b")
        return _ext(code, self.take(n))

    def array(self, n: int) -> list:
        return [self.read() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.read()
            out[key] = self.read()
        return out


def _ext(code: int, data: memoryview):
    """flax's ``_msgpack_ext_unpack`` for ndarrays and numpy scalars."""
    if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
        raise ValueError(f"msgpack ext type {code} is not an array")
    inner = _Reader(data)
    shape, name, buf = inner.read()
    if inner.pos != len(data):
        raise ValueError("trailing bytes in an array's encoding")
    name = name.decode() if isinstance(name, bytes) else name
    shape = tuple(shape)
    if name == "bfloat16":
        a = np.frombuffer(buf, np.int16).reshape(shape).copy()
        return torch.from_numpy(a).view(torch.bfloat16)
    try:
        dtype = np.dtype(name)
    except TypeError as e:
        raise ValueError(f"unknown array dtype {name!r}") from e
    a = np.frombuffer(buf, dtype).reshape(shape).copy()
    return a[()] if code == _EXT_NPSCALAR else a


def _unchunk(tree):
    """flax's ``_unchunk_array_leaves_in_place``: chunked dicts back into
    arrays, through nested dicts."""
    if not isinstance(tree, dict):
        return tree
    if _CHUNKED in tree:
        shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        if isinstance(chunks[0], torch.Tensor):
            return torch.cat(chunks).reshape(shape)
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def checkpoint_from_bytes(data) -> Any:
    """The tree ``flax.serialization.msgpack_restore`` gives for ``data``:
    dicts, lists, Python scalars, numpy arrays and scalars (and bfloat16
    tensors)."""
    reader = _Reader(data)
    tree = reader.read()
    if reader.pos != len(reader.buf):
        raise ValueError("trailing bytes after the msgpack object")
    return _unchunk(tree)


def load_checkpoint(path: str) -> Dict[str, Any]:
    with open(path, "rb") as f:
        return checkpoint_from_bytes(f.read())


class _Snapshot:
    """Copies of a payload's leaves on the host, made by ``take``: CUDA
    tensors by ``non_blocking`` copies into page-locked buffers (one a
    dtype, kept for the next snapshot of the same sizes), each device's
    copies followed by an event that ``ready`` waits for; CPU tensors,
    numpy arrays and bytearrays copied at once; other leaves kept (they
    are immutable). The buffers are reused by the next ``take``, so a
    snapshot is read (``ready``, then the tree) before the next one is
    taken."""

    def __init__(self):
        self.pinned = {}            # dtype -> flat page-locked buffer
        self.offsets = {}           # dtype -> next free element of it
        self.devices = set()        # the devices copied from
        self.events = []

    def take(self, payload):
        need = {}
        for t in self._leaves(payload):
            if isinstance(t, torch.Tensor) and t.is_cuda:
                need[t.dtype] = need.get(t.dtype, 0) + t.numel()
        for dtype, n in need.items():
            buf = self.pinned.get(dtype)
            if buf is None or buf.numel() < n:
                self.pinned[dtype] = torch.empty(n, dtype=dtype,
                                                 pin_memory=True)
        self.offsets = dict.fromkeys(need, 0)
        self.devices = set()
        tree = self._copy(payload)
        self.events = []
        for dev in self.devices:
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(dev))
            self.events.append(event)
        return tree

    def ready(self) -> None:
        """Wait for the device-to-host copies of the last ``take``."""
        for event in self.events:
            event.synchronize()

    def _leaves(self, tree):
        if isinstance(tree, Mapping):
            for v in tree.values():
                yield from self._leaves(v)
        elif isinstance(tree, (list, tuple)):
            for v in tree:
                yield from self._leaves(v)
        else:
            yield tree

    def _copy(self, tree):
        if isinstance(tree, Mapping):
            return {k: self._copy(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return [self._copy(v) for v in tree]
        if isinstance(tree, torch.Tensor):
            t = tree.detach()
            if not t.is_cuda:
                return t.clone()
            at = self.offsets[t.dtype]
            self.offsets[t.dtype] = at + t.numel()
            host = self.pinned[t.dtype][at:at + t.numel()].view(t.shape)
            host.copy_(t, non_blocking=True)
            self.devices.add(t.device)
            return host
        if isinstance(tree, np.ndarray):
            return tree.copy()
        if isinstance(tree, bytearray):
            return bytes(tree)
        return tree


class AsyncCheckpointer:
    """Checkpoint writes in a background thread (JAX ``AsyncCheckpointer``):
    ``save`` waits for the write before it, copies the payload to the host
    (``_Snapshot``) and starts one thread that writes it with
    ``save_checkpoint``, so at most one write is in flight and the file is
    the one ``save_checkpoint`` writes. The caller may change its tensors
    as soon as ``save`` returns: a CPU tensor or array is copied before,
    and a CUDA tensor's copy is queued on its device's current stream
    before anything the caller queues after (the thread waits for it
    before reading). The checkpointer keeps page-locked host buffers as
    large as the CUDA leaves for the next save.

    ``wait`` joins the write and raises its exception, if it failed; so
    does the next ``save``. (The JAX package's daemon thread loses a failed
    write's exception.) The thread is a daemon, as JAX's: call ``wait``
    before the process ends, or the last write may be lost (never torn: the
    write is atomic)."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._snapshot = _Snapshot()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        error, self._error = self._error, None
        if error is not None:
            raise error

    def save(self, path: str, payload: Dict[str, Any]) -> None:
        self.wait()
        host = self._snapshot.take(payload)

        def write():
            try:
                self._snapshot.ready()
                save_checkpoint(path, host)
            except BaseException as e:      # handed to wait()
                self._error = e

        self._thread = threading.Thread(target=write, daemon=True)
        self._thread.start()


def _dcp(fn, tree, path: str) -> None:
    """``torch.distributed.checkpoint``'s ``fn`` (save or load) of ``tree``
    at ``path``: over the process group, or in this process alone without
    one (without its warning that it assumes so)."""
    import warnings

    import torch.distributed as dist

    alone = not (dist.is_available() and dist.is_initialized())
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", "torch.distributed is disabled")
        fn(tree, checkpoint_id=path, no_dist=alone)


def save_sharded(path: str, payload: Any) -> None:
    """Write ``payload`` (a dict of trees of tensors, ``DTensor`` s and
    scalars) as a ``torch.distributed.checkpoint`` directory at ``path``
    (made absolute, as JAX does). Every rank of the process group calls
    it; each writes only its own shards of each ``DTensor`` (its file
    ``__<rank>_0.distcp``), no rank gathers, and a replicated leaf (a
    ``Replicate()`` DTensor or a plain tensor) is written once. Rank 0
    writes ``.metadata``, the index of every shard. Without a process group
    one process writes everything. Files of an earlier save with more
    ranks stay, unread (JAX's orbax call deletes the directory first)."""
    import torch.distributed.checkpoint as dcp

    _dcp(dcp.save, payload, os.path.abspath(path))


def abstract_like(tree, sharding=None):
    """Empty tensors shaped like ``tree``'s, to load a sharded checkpoint
    into (JAX ``abstract_like``): each keeps its dtype, device and, for a
    ``DTensor``, its mesh and placements, unless ``sharding``, a
    ``(DeviceMesh, placements)`` pair (the counterpart of a
    ``NamedSharding``), overrides them. Other leaves are kept."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor import empty as dtensor_empty

    def leaf(x):
        if not isinstance(x, torch.Tensor):
            return x
        mesh, placements = sharding if sharding is not None else (
            (x.device_mesh, x.placements) if isinstance(x, DTensor)
            else (None, None))
        if mesh is None:
            return torch.empty(x.shape, dtype=x.dtype, device=x.device)
        return dtensor_empty(*x.shape, dtype=x.dtype, device_mesh=mesh,
                             placements=placements)

    def walk(t):
        if isinstance(t, Mapping):
            return {k: walk(v) for k, v in t.items()}
        return leaf(t)

    return walk(tree)


# files that mark a directory as an orbax checkpoint (the JAX package's
# ``save_sharded`` format)
_ORBAX_MARKERS = ("_CHECKPOINT_METADATA", "manifest.ocdbt", "_METADATA")


def load_sharded(path: str, target: Any) -> Any:
    """Fill ``target`` (from ``abstract_like``) from the sharded checkpoint
    at ``path`` and return it: each rank reads the bytes of the shards its
    tensors hold, whatever the placements they were saved with (a leaf
    saved ``Shard(0)`` loads into a ``Replicate()`` target). An orbax
    directory (the JAX package's) is refused: the formats differ."""
    import torch.distributed.checkpoint as dcp

    path = os.path.abspath(path)
    if not os.path.exists(os.path.join(path, ".metadata")):
        orbax = [m for m in _ORBAX_MARKERS
                 if os.path.exists(os.path.join(path, m))]
        if orbax:
            raise ValueError(
                f"{path} is an orbax checkpoint (it holds {orbax}), which "
                f"the JAX package writes; the port reads only its own "
                f"torch.distributed.checkpoint directories (with "
                f".metadata)")
        raise FileNotFoundError(f"no sharded checkpoint at {path} (no "
                                f".metadata)")
    _dcp(dcp.load, target, path)
    return target
