"""Result encoders and the streaming wire codec (counterpart of the JAX
``serving/codec.py``).

Stream framing (``/segment_stream`` and ``/translate_stream``): request
bodies are ``8-byte big-endian length || image bytes`` frames; responses
are HTTP chunked, one ``1 status byte || 8-byte length || payload`` frame
per input in request order (status 0 ok, 1 bad frame, 2 inference error).
:func:`stream_segment` is the reference client.
"""

from __future__ import annotations

import json
import struct

import numpy as np
import torch

from ..data.palette import colorize_prediction
from ..data.png import gray_png_bytes, rgb_png_bytes
from ..models.forward import generator_forward
from .batcher import HW, _decode_resized


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


def make_translation_fns(*, channels: int, normalize, denormalize, hw=HW,
                         bf16: bool = False, forward=None):
    """(preprocess_fn, predict_fn, encode) for serving a GAN generator, the
    online counterpart of ``cli/translator.py`` (JAX ``serving/codec.py``):

    - preprocess: 16-bit IR through ``load_ir_image``'s radiometric window
      (1-channel only), 8-bit input converted to RGB or L, resized BICUBIC
      to ``hw`` and divided by 255 (``batcher.preprocess``'s decode: PNG
      without PIL); then ``(x - m) / m`` with ``m`` =
      ``normalize`` (its first value for 1-channel input);
    - predict ``(net, x)``: ``forward(net, x)``, by default the server's
      replica ``net``'s eval forward (``models/forward.generator_forward``,
      bfloat16 autocast with ``bf16``; an artifact's server passes its
      program's call), then ``clip((y * d + d) * 255)`` cast to uint8 on the
      device, ``d`` = ``denormalize``;
    - encode: a gray or RGB PNG of the (H, W, C) uint8 frame.
    """
    mean = np.asarray(normalize, np.float32)
    if channels == 1 and mean.size > 1:
        mean = mean[:1]
    if forward is None:
        def forward(net, x):
            return generator_forward(net, x, bf16)
    d = torch.tensor(denormalize, dtype=torch.float32)
    on_device = {}      # one upload of ``d`` a device, not one a batch

    def preprocess_fn(image_bytes: bytes) -> np.ndarray:
        # 16-bit thermal input goes through the Freiburg IR window, as the
        # seg kind preprocesses it (a plain convert('L') saturates it to
        # white)
        arr = _decode_resized(image_bytes, hw, channels)
        if arr.shape[-1] != channels:
            raise ValueError(f"expected {channels}-channel input, got "
                             f"{arr.shape[-1]} (16-bit IR is 1-channel)")
        return (arr - mean) / mean

    def predict_fn(net, x: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            y = forward(net, x)
            dd = on_device.get(y.device)
            if dd is None:
                dd = on_device[y.device] = d.to(y.device)
            # uint8 on the device: 4x fewer bytes on the copy back
            return ((y * dd + dd) * 255.0).clamp(0.0, 255.0).to(torch.uint8)

    return preprocess_fn, predict_fn, encode_frame


def encode_frame(pred: np.ndarray, fmt: str) -> tuple:
    """(H, W, C) uint8 translated frame -> (PNG bytes, content type): gray
    for C = 1, RGB for C = 3; ``fmt`` ('palette' or 'png') means PNG
    either way."""
    if pred.shape[-1] == 1:
        return gray_png_bytes(pred[..., 0]), "image/png"
    return rgb_png_bytes(pred), "image/png"


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
