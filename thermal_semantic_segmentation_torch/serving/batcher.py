"""Micro-batching inference engine (counterpart of the JAX
``serving/batcher.py``).

:class:`InferenceServer` coalesces concurrent requests into fixed-size padded
device batches, up to a latency budget, and answers each with its (H, W)
uint8 class ids: model forward, then the fused ``upsample_argmax`` kernel,
then a cast to uint8 on the device before the copy back to the host. Its
``predict_fn`` and ``preprocess_fn`` hooks swap the forward and the request
decoding (the translation kind, an exported artifact) and keep the batcher.
"""

from __future__ import annotations

import queue
import threading
import time

import numpy as np
import torch

from ..device import resolve_device
from ..models.forward import seg_forward
from ..ops.batching import pad_rows
from ..parallel import mesh as pmesh

HW = (256, 512)


class InferenceError(RuntimeError):
    """A server-side (device/model) failure -- maps to HTTP 500, while
    request decode/preprocess errors stay 400."""


def preprocess(image_bytes: bytes, hw=HW, channels: int = 1) -> np.ndarray:
    """Decode request bytes -> (H, W, channels) float32.

    16-bit input follows the Freiburg IR protocol (``data/freiburg.py``
    ``load_ir_image``: resize to RAW_SIZE BICUBIC, column crop, radiometric
    window), then the eval resize to ``hw``; 8-bit input (grayscale, RGB,
    RGBA or palette) converts to L or RGB and scales to [0, 1]. PNG bodies
    are read without PIL (``data/image.py``); a JPEG body needs PIL, and
    without it is refused (a ``ValueError``: HTTP 400)."""
    arr = _decode_resized(image_bytes, hw, channels)
    if arr.shape[-1] != channels:
        raise ValueError(f"expected {channels}-channel input, got "
                         f"{arr.shape[-1]} (16-bit IR is 1-channel)")
    return arr


def _decode_resized(image_bytes: bytes, hw, channels: int) -> np.ndarray:
    """Request bytes -> (H, W, C) float32 at ``hw``: a 16-bit frame through
    the IR window (C = 1), an 8-bit one converted to RGB (``channels`` 3)
    or L and divided by 255."""
    from ..data import image as im
    from ..data.freiburg import ir_frame

    pixels, palette = im.read_image(image_bytes, name="request body")
    if pixels.dtype == np.uint16:
        return im.resize(ir_frame(pixels), (hw[1], hw[0]), im.BICUBIC)[
            ..., None]
    img = im.convert(pixels, "RGB" if channels == 3 else "L", palette)
    arr = im.resize(img, (hw[1], hw[0]), im.BICUBIC).astype(np.float32) / 255.0
    return arr[..., None] if arr.ndim == 2 else arr


class InferenceServer:
    """Micro-batching wrapper around the segmentation forward.

    Requests enqueue (array, result queue); one worker thread drains up to
    ``batch_size`` of them (waiting at most ``max_wait_ms`` for stragglers
    after the first), pads the tail to the fixed batch shape and runs one
    device step. ``device`` defaults to the CUDA device (raises without
    one); ``bf16`` runs the forward under bfloat16 autocast, and the logits
    reach the kernel as float32.

    ``mesh`` (``parallel/mesh.LocalMesh``, ``--data_parallel``): the model
    is copied onto each of its devices for the server's lifetime, and each
    coalesced batch's rows are split over the copies, ``batch_size /
    mesh.size`` each; ``batch_size`` must divide over the mesh, as the JAX
    server requires.

    ``predict_fn(model, x)`` replaces the segmentation forward: it takes a
    replica (None for each when ``model`` is None, as for an exported
    artifact, whose ``predict_fn`` picks the program of ``x``'s device) and
    one share ``x`` of the batch, (rows, H, W, ``channels``) float32 on the
    replica's device, and returns its uint8 rows on that device.
    ``preprocess_fn(bytes)`` replaces ``preprocess``.
    """

    def __init__(self, model, *, batch_size: int = 8,
                 max_wait_ms: float = 10.0, label_hw=HW, channels: int = 1,
                 bf16: bool = False, device=None, mesh=None,
                 predict_fn=None, preprocess_fn=None):
        if mesh is not None and batch_size % mesh.size:
            raise ValueError(
                f"batch_size {batch_size} must divide evenly over the "
                f"{mesh.size}-device mesh (each device gets an equal share)")
        self.device = resolve_device(device)
        self.batch_size = batch_size
        self.max_wait = max_wait_ms / 1e3
        self.label_hw = tuple(label_hw)
        self.channels = channels
        self.bf16 = bf16
        # weights live on the device for the server's lifetime
        self.mesh = pmesh.LocalMesh.of(mesh, self.device)
        if model is None:
            self.model = None
            self.replicas = [None] * self.mesh.size
        else:
            self.model = model.to(device=self.device,
                                  memory_format=torch.channels_last).eval()
            self.replicas = pmesh.replicate(self.mesh, self.model)
        self._predict_rows = predict_fn or self._ids
        self._preprocess = preprocess_fn or (
            lambda data: preprocess(data, self.label_hw, self.channels))
        # one pinned host buffer per server: each batch is copied into it and
        # sent with a non_blocking copy. Reuse is safe because every batch
        # ends in a device->host copy that waits for the stream.
        self._host = torch.empty(
            (batch_size, *self.label_hw, channels), dtype=torch.float32,
            pin_memory=self.device.type == "cuda")
        self._queue: queue.Queue = queue.Queue()
        self._stop = threading.Event()
        # serializes submit()'s stop-check-then-put against stop()'s final
        # drain: without it a submit could check, lose the CPU, and enqueue
        # after both shutdown drains ran -- its waiter would never be answered
        self._submit_lock = threading.Lock()
        self._worker = threading.Thread(target=self._run, daemon=True)
        self.batches_run = 0
        self.requests_served = 0

    def _predict(self, images: np.ndarray) -> np.ndarray:
        """(batch, H, W, C) float32 -> the forward's uint8 rows ((batch, H,
        W) class ids for the segmentation kind)."""
        self._host.numpy()[...] = images
        # each copy's launches queue on its own device before any result
        # is read back
        shares = [self._host[rows].to(dev, non_blocking=True)
                  for dev, rows in zip(self.mesh.devices, pmesh.split_rows(
                      self.mesh, self.batch_size))]
        return pmesh.map_shares(self._predict_rows, self.replicas, "cpu",
                                shares).numpy()

    def _ids(self, model, x: torch.Tensor) -> torch.Tensor:
        """One model's uint8 class ids of the NHWC batch ``x``, on its
        device (``models/forward.seg_forward``)."""
        with torch.inference_mode():
            return seg_forward(model, x, self.label_hw, "ids", self.bf16)

    def warmup(self):
        """One forward at the serving shape, so the first request does not
        pay cuDNN's algorithm selection or the kernel's build."""
        self._predict(np.zeros((self.batch_size, *self.label_hw,
                                self.channels), np.float32))

    def start(self):
        self._worker.start()

    def stop(self):
        self._stop.set()
        self._queue.put(None)
        if self._worker.ident is not None:  # started
            self._worker.join(timeout=5)
        # final drain under the submit lock: every submit either enqueued
        # before this drain (and gets failed here) or observes _stop set
        # inside the lock (and fails itself) -- no waiter can be orphaned
        with self._submit_lock:
            while True:
                try:
                    item = self._queue.get_nowait()
                except queue.Empty:
                    return
                if item is not None:
                    item[1].put(InferenceError("server stopped"))

    def submit(self, arr: np.ndarray) -> "queue.Queue":
        """Enqueue one (H, W, C) image; returns a single-item result queue."""
        out: queue.Queue = queue.Queue(maxsize=1)
        with self._submit_lock:
            if self._stop.is_set():
                out.put(InferenceError("server stopped"))
                return out
            self._queue.put((arr, out))
        return out

    def segment(self, image_bytes: bytes) -> np.ndarray:
        """Blocking helper: bytes in, the forward's per-image uint8 output
        out ((H, W) class ids for the segmentation kind)."""
        result = self.submit(self._preprocess(image_bytes)).get()
        if isinstance(result, Exception):
            raise InferenceError(str(result))
        return result

    def _run(self):
        try:
            if self.device.type == "cuda":
                torch.cuda.set_device(self.device)
            self._run_loop()
        finally:
            # deliver a failure to any request still queued (enqueued after
            # the stop sentinel or mid-shutdown) so no segment() call blocks
            # forever on its result queue
            while True:
                try:
                    item = self._queue.get_nowait()
                except queue.Empty:
                    break
                if item is not None:
                    item[1].put(InferenceError("server stopped"))

    def _run_loop(self):
        while not self._stop.is_set():
            item = self._queue.get()
            if item is None:
                return
            batch = [item]
            deadline = time.monotonic() + self.max_wait
            while len(batch) < self.batch_size:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    nxt = self._queue.get(timeout=remaining)
                except queue.Empty:
                    break
                if nxt is None:
                    self._stop.set()
                    break
                batch.append(nxt)
            try:
                images = pad_rows(np.stack([b[0] for b in batch]),
                                  self.batch_size)
                preds = self._predict(images)
                self.batches_run += 1
                for (_, out), pred in zip(batch, preds):
                    out.put(pred)
                    self.requests_served += 1
            except Exception as e:  # deliver the failure to every waiter
                for _, out in batch:
                    out.put(e)
