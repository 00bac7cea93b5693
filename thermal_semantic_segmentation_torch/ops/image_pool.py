"""Replay buffer of generated images (counterpart of the JAX
``ops/image_pool.py``; reference utils/misc.py:135-183).

The discriminator sees a history of fakes: while the pool fills, each
incoming image is stored and returned as it is; once full, each is
returned as it is with probability 0.5, or swapped with (and replaced by)
a random stored image with probability 0.5, image by image in order.

- ``ImagePool``: the host pool, on numpy with ``default_rng(seed)``, so it
  makes the JAX ``ImagePool``'s draws (``-host_pool true``). Each query
  copies the batch to the host and back.
- ``DevicePool``: the same semantics as a ring of images on the device
  with a count and its own device ``torch.Generator``; a query is tensor
  indexing and never waits for the device.
"""

from __future__ import annotations

import numpy as np
import torch


class ImagePool:
    def __init__(self, pool_size: int, seed: int = 0):
        self.pool_size = pool_size
        self.rng = np.random.default_rng(seed)
        self.num_imgs = 0
        self.images: list[np.ndarray] = []

    def query(self, images: torch.Tensor) -> torch.Tensor:
        """images: (N, ...) fresh fakes -> the batch to feed D, on their
        device."""
        if self.pool_size == 0:
            return images
        out = []
        for image in images.detach().cpu().numpy():
            if self.num_imgs < self.pool_size:
                self.num_imgs += 1
                self.images.append(image.copy())
                out.append(image)
            elif self.rng.uniform() > 0.5:
                rid = int(self.rng.integers(0, self.pool_size))
                out.append(self.images[rid].copy())
                self.images[rid] = image.copy()
            else:
                out.append(image)
        return torch.from_numpy(np.stack(out)).to(images.device)


class DevicePool:
    """(pool_size, *image_shape) ring buffer on ``device``; ``pool_size``
    0 makes ``query`` a pass-through."""

    def __init__(self, pool_size: int, image_shape, *, device,
                 dtype=torch.float32, seed: int = 0):
        self.pool_size = pool_size
        self.buffer = torch.zeros((max(pool_size, 1), *image_shape),
                                  dtype=dtype, device=device)
        self.count = torch.zeros((), dtype=torch.long, device=device)
        self.generator = torch.Generator(device=device).manual_seed(seed)

    def query(self, images: torch.Tensor) -> torch.Tensor:
        """images: (N, *image_shape) -> the pooled batch. Per image, in
        order: while the pool is not full, store it in the next slot and
        return it; once full, draw a coin and a slot, and on heads return
        the stored image and store this one in its place."""
        if self.pool_size == 0:
            return images
        n, dev = images.shape[0], images.device
        coins = torch.rand((n,), generator=self.generator, device=dev)
        slots = torch.randint(0, self.pool_size, (n,),
                              generator=self.generator, device=dev)
        out = []
        for i in range(n):
            img = images[i]
            not_full = self.count < self.pool_size
            swap = coins[i] > 0.5
            idx = torch.where(not_full, self.count, slots[i]).reshape(1)
            stored = self.buffer.index_select(0, idx)[0]
            out.append(torch.where(~not_full & swap, stored.to(img.dtype),
                                   img))
            keep = torch.where(not_full | swap, img.to(self.buffer.dtype),
                               stored)
            self.buffer.index_copy_(0, idx, keep.unsqueeze(0))
            self.count = torch.where(not_full, self.count + 1, self.count)
        return torch.stack(out)
