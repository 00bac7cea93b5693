"""Byte-bounded decoded-frame cache: an in-RAM LRU and an optional disk tier
(counterpart of the JAX ``data/cache.py``).

PNG decode is most of the host loader's cost per sample, and the training
recipes read the same frames every epoch, so an LRU of decoded (resized,
windowed) arrays takes decode out of every epoch after the first. The
reference has no counterpart (its DataLoader decodes every epoch).

Off by default (``max_bytes = 0``). ``set_decode_cache(mb)`` turns it on for
the process, as the CLIs' ``--decode_cache_mb`` does at parse time. A
Freiburg-IR frame is ~0.9 MiB decoded (700x320 float32), a label ~0.2 MiB;
~12 GiB holds the whole ~10k-frame train split, and a smaller bound evicts
the coldest frames.

The optional disk tier (``disk_dir``, ``--decode_cache_dir``) keeps decoded
frames as ``.npy`` files named by a hash of the key (kind, path, ...), so a
fresh process's first epoch loads at the warm rate without decoding. Writes
are atomic (a temporary file, then a rename); reads feed the RAM tier. The
directory is unbounded (a decoded mirror of the dataset, ~1.3x the PNG
bytes). An entry whose source file is newer than it (translations written
again after the GAN was retrained) is a miss and is decoded again; deleting
the directory drops everything.

Thread-safe (the loader decodes on a thread pool). Entries are read-only
numpy arrays; callers wrap them anew for each use.
"""

from __future__ import annotations

import hashlib
import os
import threading
from collections import OrderedDict
from typing import Callable, Hashable, Optional

import numpy as np


class DecodeCache:
    def __init__(self, max_bytes: int = 0, disk_dir: Optional[str] = None):
        self.max_bytes = max_bytes
        self.disk_dir = disk_dir
        self._entries: OrderedDict[Hashable, np.ndarray] = OrderedDict()
        self._bytes = 0
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.disk_hits = 0

    @staticmethod
    def _src_path(key: Hashable) -> Optional[str]:
        # cache-key convention (data/freiburg.py): (kind, source_path, ...)
        if isinstance(key, tuple) and len(key) > 1 and isinstance(key[1], str):
            return key[1]
        return None

    def _disk_path(self, key: Hashable) -> str:
        h = hashlib.sha1(repr(key).encode()).hexdigest()
        return os.path.join(self.disk_dir, f"{h}.npy")

    def _disk_load(self, key: Hashable) -> Optional[np.ndarray]:
        # EOFError covers a zero-byte file left by a crash between
        # os.replace and the data reaching disk (no fsync, by design) —
        # without it one corrupt file would crash every later run
        path = self._disk_path(key)
        src = self._src_path(key)
        if src is not None:
            try:
                stale = os.path.getmtime(src) > os.path.getmtime(path)
            except OSError:
                stale = False  # source/entry unstat-able: can't validate
            if stale:
                # source regenerated since the decode was persisted (e.g. the
                # translator re-wrote its PNGs after GAN retraining): serving
                # the stale decode would silently train on the OLD data
                try:
                    os.unlink(path)
                except OSError:
                    pass
                return None
        try:
            arr = np.load(path, allow_pickle=False)
            self.disk_hits += 1
            return arr
        except (OSError, ValueError, EOFError):
            try:  # drop the corrupt file so the re-decode below repairs it
                os.unlink(path)
            except OSError:
                pass
            return None

    def _disk_store(self, key: Hashable, arr: np.ndarray) -> None:
        try:
            os.makedirs(self.disk_dir, exist_ok=True)
            path = self._disk_path(key)
            tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
            with open(tmp, "wb") as f:   # np.save(str) would append '.npy'
                np.save(f, arr)
            os.replace(tmp, path)  # atomic: concurrent writers both win
        except OSError:
            pass  # disk tier is best-effort (full disk, permissions, ...)

    def get_or_decode(self, key: Hashable, decode: Callable[[], np.ndarray]
                      ) -> np.ndarray:
        """Return the cached array for ``key``, decoding (outside the lock)
        and inserting on miss. The returned array must be treated read-only."""
        if self.max_bytes <= 0 and not self.disk_dir:
            return decode()
        if self.max_bytes > 0:
            with self._lock:
                arr = self._entries.get(key)
                if arr is not None:
                    self._entries.move_to_end(key)
                    self.hits += 1
                    return arr
                self.misses += 1
        arr = None
        if self.disk_dir:
            arr = self._disk_load(key)
        if arr is None:
            arr = decode()
            if self.disk_dir:
                self._disk_store(key, arr)
        nbytes = arr.nbytes
        if self.max_bytes <= 0 or nbytes > self.max_bytes:
            return arr  # no RAM tier / larger than the whole cache
        # enforce the read-only contract: an accidental in-place mutation by a
        # caller raises instead of silently corrupting every later epoch
        arr.setflags(write=False)
        with self._lock:
            if key not in self._entries:
                self._entries[key] = arr
                self._bytes += nbytes
                while self._bytes > self.max_bytes:
                    _, old = self._entries.popitem(last=False)
                    self._bytes -= old.nbytes
            return self._entries[key]

    def resize(self, max_bytes: int):
        with self._lock:
            self.max_bytes = max_bytes
            while self._bytes > max(max_bytes, 0) and self._entries:
                _, old = self._entries.popitem(last=False)
                self._bytes -= old.nbytes

    def clear(self):
        with self._lock:
            self._entries.clear()
            self._bytes = 0

    @property
    def nbytes(self) -> int:
        return self._bytes


_GLOBAL = DecodeCache(0)
_UNSET = object()


def set_decode_cache(max_mb: float, disk_dir=_UNSET) -> DecodeCache:
    """Configure the process-global decode cache: RAM bound in MiB (0
    disables the RAM tier and clears it) and optional persistent disk tier.
    Shrinking evicts immediately so the new bound holds right away.
    ``disk_dir`` left unset keeps any previously configured disk tier (a
    resize-only call must not silently disable persistence); pass ``None``
    explicitly to clear it."""
    _GLOBAL.resize(int(max_mb * 2**20))
    if disk_dir is not _UNSET:
        _GLOBAL.disk_dir = disk_dir or None
    return _GLOBAL


def decode_cache() -> DecodeCache:
    return _GLOBAL
