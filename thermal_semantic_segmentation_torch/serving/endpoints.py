"""HTTP endpoint handler for the inference server (counterpart of the JAX
``serving/endpoints.py``).

``make_handler`` builds a BaseHTTPRequestHandler serving the health,
one-shot and streaming endpoints over an
:class:`~.batcher.InferenceServer`, with the same status codes and framing
as the JAX server. HTTP/1.1 keep-alive safe: bodies are drained, or the
connection closed, on every early exit.
"""

from __future__ import annotations

import json
import queue
import struct
from http.server import BaseHTTPRequestHandler

from .batcher import InferenceError, InferenceServer
from .codec import _read_exact, encode_result



def make_handler(server: InferenceServer, model_info: dict, *,
                 encode=None, endpoints=("/segment", "/segment_stream"),
                 formats=("palette", "ids", "json")):
    """The handler class. ``encode(pred, fmt)`` -> (bytes, content type)
    replaces the class-id encoders; ``endpoints`` are the one-shot and the
    stream paths (every other path answers 404); ``formats`` the ``format=``
    values they take."""
    from ..data.palette import freiburg_palette

    palette = freiburg_palette()
    encode = encode or (lambda pred, fmt: encode_result(pred, fmt, palette))
    one_path, stream_path = endpoints
    allowed_formats = frozenset(formats)

    class Handler(BaseHTTPRequestHandler):
        # HTTP/1.1 enables chunked responses for /segment_stream (and
        # keep-alive for the fixed-length endpoints, which all set
        # Content-Length)
        protocol_version = "HTTP/1.1"

        def log_message(self, *a):  # quiet
            pass

        def _send(self, code: int, body: bytes, ctype: str):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _drain_body(self):
            # under HTTP/1.1 keep-alive, a response sent with the request
            # body still unread leaves those bytes to be parsed as the NEXT
            # request line; drain (or, if the length is unknowable, close)
            # before replying on any early-exit path
            if ("Content-Length" not in self.headers
                    and self.headers.get("Transfer-Encoding")):
                self.close_connection = True
                return
            try:
                n = int(self.headers.get("Content-Length", "0"))
            except ValueError:
                self.close_connection = True
                return
            while n > 0:
                chunk = self.rfile.read(min(n, 1 << 16))
                if not chunk:
                    self.close_connection = True
                    return
                n -= len(chunk)

        def do_GET(self):
            if self.path.split("?")[0] == "/healthz":
                info = dict(model_info, status="ok",
                            batches_run=server.batches_run,
                            requests_served=server.requests_served)
                self._send(200, json.dumps(info).encode(), "application/json")
            else:
                self._drain_body()
                self._send(404, b"not found", "text/plain")

        def do_POST(self):
            path, _, query = self.path.partition("?")
            fmt = "palette"
            for part in query.split("&"):
                if part.startswith("format="):
                    fmt = part.split("=", 1)[1]
            if path in (one_path, stream_path) and fmt not in allowed_formats:
                # an unsupported format must not come back as a silently
                # different payload -- refuse before any inference runs
                self._drain_body()
                self._send(400, f"unsupported format {fmt!r}; one of "
                                f"{sorted(allowed_formats)}".encode(), "text/plain")
            elif path == one_path:
                self._segment_one(fmt)
            elif path == stream_path:
                self._segment_stream(fmt)
            else:
                self._drain_body()
                self._send(404, b"not found", "text/plain")

        def _length_required(self, path):
            # a chunked body would be read as empty and its unread bytes
            # parsed as the next keep-alive request line: require a length
            self.close_connection = True
            self._send(411, f"length required: {path} needs Content-Length "
                            f"(chunked upload unsupported)".encode(),
                       "text/plain")

        def _segment_one(self, fmt):
            if "Content-Length" not in self.headers:
                self._length_required(one_path)
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
                data = self.rfile.read(length)
            except Exception as e:
                self.close_connection = True  # body state unknown
                self._send(400, f"bad request: {e}".encode(), "text/plain")
                return
            try:
                pred = server.segment(data)
            except InferenceError as e:
                self._send(500, f"inference failed: {e}".encode(), "text/plain")
                return
            except Exception as e:
                # body fully read above: the connection stays reusable
                self._send(400, f"bad request: {e}".encode(), "text/plain")
                return
            body, ctype = encode(pred, fmt)
            self._send(200, body, ctype)

        def _segment_stream(self, fmt):
            # Read `8-byte len || image` frames, submitting each to the
            # micro-batcher AS IT ARRIVES, then stream per-frame results back
            # in order via chunked encoding. Per-frame failures travel
            # in-band (status byte) so one bad image doesn't fail the request.
            #
            # Memory bound: at most MAX_PENDING decoded frames are in flight;
            # beyond that the oldest frame is finalized (inference awaited,
            # result encoded, arrays freed) before reading more. Results are
            # not written before the body is fully read: a single-threaded
            # client that uploads everything before reading would deadlock.
            max_pending = 4 * server.batch_size

            def finalize(item):
                if isinstance(item, queue.Queue):
                    result = item.get()
                    if isinstance(result, Exception):
                        return 2, str(result).encode()
                    return 0, encode(result, fmt)[0]
                return item

            if "Content-Length" not in self.headers:
                self._length_required(stream_path)
                return
            remaining = int(self.headers.get("Content-Length", 0))
            done = []     # finalized (status, payload), in request order
            pending = []  # (result queue | (status, payload)) per frame
            try:
                while remaining:
                    if remaining < 8:
                        raise ValueError("truncated frame header")
                    (length,) = struct.unpack(">Q",
                                              _read_exact(self.rfile, 8))
                    remaining -= 8
                    if length > remaining:
                        raise ValueError("frame length exceeds body")
                    data = _read_exact(self.rfile, length)
                    remaining -= length
                    try:
                        arr = server._preprocess(data)
                    except Exception as e:  # bad frame: report in-band
                        pending.append((1, f"bad frame: {e}".encode()))
                        continue
                    pending.append(server.submit(arr))
                    while len(pending) > max_pending:
                        done.append(finalize(pending.pop(0)))
            except Exception as e:
                # malformed framing: nothing streamed yet -> plain 400. The
                # body was not fully read, so the connection cannot be reused
                self.close_connection = True
                for item in pending:
                    if isinstance(item, queue.Queue):
                        item.get()  # drain; device work is already queued
                self._send(400, f"bad request: {e}".encode(), "text/plain")
                return
            self.send_response(200)
            self.send_header("Content-Type", "application/octet-stream")
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()
            for status, payload in done:
                self._write_stream_frame(status, payload)
            for item in pending:
                status, payload = finalize(item)
                self._write_stream_frame(status, payload)
            self.wfile.write(b"0\r\n\r\n")

        def _write_stream_frame(self, status, payload):
            frame = bytes([status]) + struct.pack(">Q",
                                                  len(payload)) + payload
            self.wfile.write(f"{len(frame):X}\r\n".encode() + frame
                             + b"\r\n")

    return Handler
