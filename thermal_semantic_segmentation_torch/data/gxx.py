"""Build a C++ source of ``csrc/`` into a shared library with ``g++``.

The host-side C++ (the PNG unfilter, the native batch IO) is compiled at
first use with ``g++ -O3 -shared -fPIC -std=c++17`` into the package's
``_build/`` directory (gitignored, shared with the CUDA kernels). The
library's file name carries a hash of the source, the flags and the
libraries, so an edited source is rebuilt and a stale library never loads.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Callable, Optional, Sequence

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_loaded: dict = {}


def library_path(source: Path, libs: Sequence[str] = ()) -> Path:
    digest = hashlib.sha256(source.read_bytes()
                            + " ".join((*GXX_FLAGS, *libs)).encode()
                            ).hexdigest()[:16]
    return BUILD_DIR / f"lib{source.stem}-{digest}.so"


def build(source: Path, libs: Sequence[str] = ()) -> Path:
    """Compile ``source`` unless its library exists; returns the library's
    path. Raises ``RuntimeError`` with the compiler's output when the build
    fails."""
    out = library_path(source, libs)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so.tmp")
    os.close(fd)
    cmd = ["g++", *GXX_FLAGS, str(source), *libs, "-o", tmp]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        os.unlink(tmp)
        raise RuntimeError(f"g++ could not run: {e}") from e
    if proc.returncode != 0:
        os.unlink(tmp)
        log = proc.stderr.strip()
        first = next((line for line in log.splitlines() if "error" in line),
                     log.splitlines()[0] if log else "")
        raise RuntimeError(f"g++ failed for csrc/{source.name} (exit "
                           f"{proc.returncode}): {first}\n{log}")
    os.replace(tmp, out)    # atomic: a reader never sees a partial library
    return out


def load(source: Path, bind: Optional[Callable[[ctypes.CDLL], None]] = None
         ) -> ctypes.CDLL:
    """The library of ``source`` (standard library only), built at the
    first call and loaded with ctypes, whose calls release the GIL;
    ``bind`` sets its functions' types. A build or load failure raises:
    the callers have no other path."""
    lib = _loaded.get(source)
    if lib is None:
        with _lock:
            lib = _loaded.get(source)
            if lib is None:
                lib = ctypes.CDLL(str(build(source)))
                if bind is not None:
                    bind(lib)
                _loaded[source] = lib
    return lib
