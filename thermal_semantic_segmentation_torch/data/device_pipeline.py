"""Host -> device batch streaming (counterpart of the JAX
``data/device_pipeline.py``).

Each batch's arrays are staged in pinned host memory and copied to the card
with ``non_blocking`` copies on a side stream, ``size`` batches ahead, so the
next batch's copy runs under the current batch's compute. With a
``LocalMesh`` (``--data_parallel``) each replica's rows go to its own
device, on that device's side stream.

``wire`` (``--wire``, JAX ``data/wire.py``): 'packed' (the default) and
'none' or None are one path here, a lossless pinned copy per array; the
JAX package's packed buffer exists for a slow host link. 'packed_bf16'
casts each float32 array to bfloat16 on the host (round to nearest even),
copies the half-size pinned buffer and restores float32 on the device, so
a float comes back float32 with a bfloat16 value, as JAX's
``unpack_batch(pack_batch(..., float_wire='bfloat16'))`` gives it. Other
arrays travel unchanged. Meant for runs that compute in bfloat16
(``cli/_common.resolve_wire``).
"""

from __future__ import annotations

from typing import Iterable, Iterator

import numpy as np
import torch


WIRES = (None, "none", "packed", "packed_bf16")


def device_prefetch(batches: Iterable[dict], device, *, size: int = 2,
                    mesh=None, wire: str | None = "packed"
                    ) -> Iterator[dict]:
    """Yield ``batches`` with their numpy arrays as tensors on ``device``
    (nested dicts of arrays too, such as self-training's ``weak_params``;
    other values pass through), ``size`` copies in flight. On a CUDA
    device, a yielded batch is ready for the current stream.

    With ``mesh`` (``parallel/mesh.LocalMesh``) each array becomes a list
    of its replicas' shares (``split_rows``), each on its replica's
    device, and ``device`` is not used. ``wire`` as the module docstring
    says."""
    from ..parallel.mesh import LocalMesh, split_rows

    if wire not in WIRES:
        raise ValueError(f"unknown wire mode {wire!r}")
    bf16_wire = wire == "packed_bf16"
    shares = LocalMesh.of(mesh, device)
    streams = {d: torch.cuda.Stream(d) for d in set(shares.devices)
               if d.type == "cuda"}

    def one(x: np.ndarray, dev):
        t = torch.from_numpy(np.ascontiguousarray(x))
        narrow = bf16_wire and t.dtype == torch.float32
        if narrow:
            t = t.to(torch.bfloat16)
        if dev.type != "cuda":
            return t.float() if narrow else t
        with torch.cuda.stream(streams[dev]):
            t = t.pin_memory().to(dev, non_blocking=True)
            return t.float() if narrow else t

    def to_device(v):
        if isinstance(v, dict):
            return {k: to_device(x) for k, x in v.items()}
        if not isinstance(v, np.ndarray):
            return v
        parts = [one(v[rows], dev) for dev, rows in zip(
            shares.devices, split_rows(shares, v.shape[0]))]
        return parts if mesh is not None else parts[0]

    def tensors(v):
        if isinstance(v, dict):
            for x in v.values():
                yield from tensors(x)
        elif isinstance(v, list):
            for x in v:
                yield from tensors(x)
        elif isinstance(v, torch.Tensor):
            yield v

    def put(batch):
        out = to_device(batch)
        return out, {d: st.record_event() for d, st in streams.items()}

    def take(item):
        batch, ready = item
        for dev, event in ready.items():
            torch.cuda.current_stream(dev).wait_event(event)
        for v in tensors(batch):
            if v.device.type == "cuda":
                # made on a side stream, used on the current one: the
                # allocator must not reuse it before that stream is done
                v.record_stream(torch.cuda.current_stream(v.device))
        return batch

    it = iter(batches)
    buf = []
    for batch in it:
        buf.append(put(batch))
        if len(buf) > size:
            yield take(buf.pop(0))
    while buf:
        yield take(buf.pop(0))
