"""Result encoders and the streaming wire codec (counterpart of the JAX
``serving/codec.py``).

Stream framing (``/segment_stream``): request bodies are
``8-byte big-endian length || image bytes`` frames; responses are HTTP
chunked, one ``1 status byte || 8-byte length || payload`` frame per input in
request order (status 0 ok, 1 bad frame, 2 inference error).
:func:`stream_segment` is the reference client.
"""

from __future__ import annotations

import json
import struct

import numpy as np

from ..data.palette import colorize_prediction
from ..data.png import gray_png_bytes


def encode_result(pred: np.ndarray, fmt: str, palette) -> tuple:
    """(H, W) uint8 class ids -> (payload bytes, content type) per ``fmt``."""
    if fmt == "json":
        ids, counts = np.unique(pred, return_counts=True)
        body = json.dumps({
            "class_counts": {int(i): int(c) for i, c in zip(ids, counts)},
            "shape": list(pred.shape)}).encode()
        return body, "application/json"
    if fmt == "ids":
        return gray_png_bytes(pred.astype(np.uint8)), "image/png"
    return colorize_prediction(pred, palette), "image/png"


def _read_exact(fp, n: int) -> bytes:
    parts = []
    while n:
        chunk = fp.read(n)
        if not chunk:
            raise EOFError(f"stream truncated ({n} bytes short)")
        parts.append(chunk)
        n -= len(chunk)
    return b"".join(parts)


def stream_segment(url: str, images, timeout: float = 300.0):
    """Reference client for ``POST /segment_stream``.

    ``images`` is an iterable of encoded image bytes; yields
    (status, payload) per input in order -- status 0 ok, 1 bad frame,
    2 inference error."""
    import urllib.request

    body = b"".join(struct.pack(">Q", len(b)) + b for b in images)
    req = urllib.request.Request(url, data=body, method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        while True:
            head = resp.read(1)
            if not head:
                return
            (length,) = struct.unpack(">Q", _read_exact(resp, 8))
            yield head[0], _read_exact(resp, length)
