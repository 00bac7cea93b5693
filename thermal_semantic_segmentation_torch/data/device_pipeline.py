"""Host -> device batch streaming (counterpart of the JAX
``data/device_pipeline.py``).

Each batch's arrays are staged in pinned host memory and copied to the card
with ``non_blocking`` copies on a side stream, ``size`` batches ahead, so the
next batch's copy runs under the current batch's compute. The JAX package's
packed wire format (``data/wire.py``) exists for a slow host link; the port
has no wire format: a pinned copy is already one lossless DMA per array.
"""

from __future__ import annotations

from typing import Iterable, Iterator

import numpy as np
import torch


def device_prefetch(batches: Iterable[dict], device, *,
                    size: int = 2) -> Iterator[dict]:
    """Yield ``batches`` with their numpy arrays as tensors on ``device``
    (nested dicts of arrays too, such as self-training's ``weak_params``;
    other values pass through), ``size`` copies in flight. On a CUDA
    device, a yielded batch is ready for the current stream."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    stream = torch.cuda.Stream(device) if cuda else None

    def to_device(v):
        if isinstance(v, dict):
            return {k: to_device(x) for k, x in v.items()}
        if not isinstance(v, np.ndarray):
            return v
        if not cuda:
            return torch.from_numpy(v)
        return torch.from_numpy(v).pin_memory().to(device, non_blocking=True)

    def tensors(v):
        if isinstance(v, dict):
            for x in v.values():
                yield from tensors(x)
        elif isinstance(v, torch.Tensor):
            yield v

    def put(batch):
        if not cuda:
            return to_device(batch), None
        with torch.cuda.stream(stream):
            out = to_device(batch)
            ready = stream.record_event()
        return out, ready

    def take(item):
        batch, ready = item
        if ready is not None:
            current = torch.cuda.current_stream(device)
            current.wait_event(ready)
            for v in tensors(batch):
                # made on the side stream, used on this one: the
                # allocator must not reuse it before this stream is done
                v.record_stream(current)
        return batch

    it = iter(batches)
    buf = []
    for batch in it:
        buf.append(put(batch))
        if len(buf) > size:
            yield take(buf.pop(0))
    while buf:
        yield take(buf.pop(0))
