"""Inference serving: micro-batcher, wire codec, HTTP endpoints.

The CLI front end lives in ``cli/serve.py``; these modules hold the
reusable pieces: :mod:`.batcher` (request coalescing into batches),
:mod:`.codec` (result encoding, the streaming wire format and its client),
:mod:`.endpoints` (the HTTP handler).
"""

from .batcher import HW, InferenceError, InferenceServer, preprocess
from .codec import encode_result, make_translation_fns, stream_segment
from .endpoints import make_handler

__all__ = ["HW", "InferenceError", "InferenceServer", "preprocess",
           "encode_result", "make_translation_fns", "stream_segment",
           "make_handler"]
