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
"""

from __future__ import annotations

import os
import struct
import tempfile
from collections.abc import Mapping
from typing import Any, Dict

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


def _pack_ext(out: list, code: int, data: bytes) -> None:
    if len(data) in _FIXEXT:
        out.append(bytes((_FIXEXT[len(data)], code)))
    else:
        _pack_len(out, len(data), None, 0, (0xC7, 0xC8, 0xC9))
        out.append(bytes((code,)))
    out.append(data)


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
                      x.array.tobytes("C")])
        _pack_ext(out, _EXT_NDARRAY, b"".join(inner))
    elif isinstance(x, int):
        _pack_int(out, x)
    elif isinstance(x, float):
        out.append(b"\xcb" + struct.pack(">d", x))
    elif isinstance(x, str):
        data = x.encode("utf-8")
        _pack_len(out, len(data), 0xA0, 32, (0xD9, 0xDA, 0xDB))
        out.append(data)
    elif isinstance(x, (bytes, bytearray)):
        _pack_len(out, len(x), None, 0, (0xC4, 0xC5, 0xC6))
        out.append(bytes(x))
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


def checkpoint_bytes(payload: Dict[str, Any]) -> bytes:
    """The bytes ``flax.serialization.msgpack_serialize`` gives for the tree
    the JAX package's ``save_checkpoint`` makes of ``payload``."""
    out: list = []
    _pack(out, _prepare(payload))
    return b"".join(out)


def save_checkpoint(path: str, payload: Dict[str, Any]) -> None:
    """Atomically write a dict of trees and scalars to ``path``: into a
    temporary file beside it, then ``os.replace``. Leaves may be numpy
    arrays, numpy or Python scalars, or tensors (copied to the host)."""
    data = checkpoint_bytes(payload)
    directory = os.path.dirname(os.path.abspath(path))
    os.makedirs(directory, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
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
