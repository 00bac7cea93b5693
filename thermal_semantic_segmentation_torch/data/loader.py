"""Batched, prefetching data loader (counterpart of the JAX
``data/loader.py``).

A thread-pool loader: per-sample deterministic RNG (seed, epoch, index),
numpy collation, optional subset sampling (the reference's 80/20 split), and
batches decoded ahead so host decode overlaps device compute. The same
streams and shuffle order as the JAX package, so a split scores the same
images in the same order. ``shard`` gives each process its slice of every
epoch (``parallel/mesh.host_shard``). A dataset that asks for batch
decoding (``native_decode``) is read a batch at a time through its
``get_batch``, whose None or failure falls back to sample by sample.
"""

from __future__ import annotations

import concurrent.futures as cf
import logging
from typing import Callable, Iterator, Optional, Sequence

import numpy as np

from ..core.prng import host_rng


def default_collate(samples: Sequence[dict]) -> dict:
    out = {}
    for key in samples[0]:
        vals = [s[key] for s in samples]
        if isinstance(vals[0], dict):
            out[key] = default_collate(vals)
        elif isinstance(vals[0], (str, bytes)):
            out[key] = list(vals)
        else:
            out[key] = np.stack([np.asarray(v) for v in vals])
    return out


def split_indices(n: int, validation_split: float = 0.2, seed: int = 42):
    """The reference's 80/20 split: a seed-42 shuffle, then a slice.
    Returns (train_indices, val_indices)."""
    indices = np.arange(n)
    np.random.RandomState(seed).shuffle(indices)
    split = int(np.floor(validation_split * n))
    return indices[split:].tolist(), indices[:split].tolist()


class DataLoader:
    """Iterates ``dataset`` (``len`` and ``get(index, rng)``) in batches of
    collated dicts; each iteration is one epoch.

    ``shard=(r, n)``: process ``r`` of ``n`` takes ``order[r::n]`` of the
    (shuffled) epoch order, as the JAX loader does. With ``shard_lockstep``
    (the trainers') every slice is cut to ``len // n``, so the processes
    run the same number of batches and meet at every collective; without
    it (the offline CLIs, whose processes meet only after their loops) the
    slices partition the set exactly."""

    def __init__(self, dataset, batch_size: int, *, shuffle: bool = False,
                 indices: Optional[Sequence[int]] = None,
                 drop_last: bool = True, seed: int = 0, num_threads: int = 8,
                 collate: Callable = default_collate, prefetch: int = 2,
                 corrupt_retries: int = 4, shard: Optional[tuple] = None,
                 shard_lockstep: bool = True):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.indices = (list(indices) if indices is not None
                        else list(range(len(dataset))))
        self.drop_last = drop_last
        self.shard = tuple(shard) if shard else None
        self.shard_lockstep = shard_lockstep
        if self.shard is not None and not 0 <= self.shard[0] < self.shard[1]:
            raise ValueError(f"shard {self.shard} is not (r, n) with "
                             f"0 <= r < n")
        self.seed = seed
        self.num_threads = num_threads
        self.collate = collate
        self.prefetch = prefetch
        # an unreadable sample is replaced by a deterministic substitute
        # instead of aborting the epoch; 0 disables and re-raises
        self.corrupt_retries = corrupt_retries
        self.epoch = 0

    def __len__(self) -> int:
        n = len(self.indices)
        if self.shard is not None:
            sid, nsh = self.shard
            n = n // nsh if self.shard_lockstep else -(-(n - sid) // nsh)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _batches(self):
        order = list(self.indices)
        if self.shuffle:
            host_rng(self.seed, self.epoch).shuffle(order)
        if self.shard is not None:
            sid, nsh = self.shard
            order = order[sid::nsh]
            if self.shard_lockstep:
                order = order[:len(self.indices) // nsh]
        bs = self.batch_size
        limit = len(order) - (len(order) % bs) if self.drop_last else len(order)
        for start in range(0, limit, bs):
            yield order[start:start + bs]

    def __iter__(self) -> Iterator[dict]:
        epoch = self.epoch
        self.epoch += 1

        def fetch(idx: int) -> dict:
            for attempt in range(self.corrupt_retries + 1):
                # deterministic substitute chain: the same (seed, epoch, idx)
                # always gives the same replacement sample
                use = idx if attempt == 0 else self.indices[
                    (idx * 1009 + attempt * 9176) % len(self.indices)]
                try:
                    return self.dataset.get(use, host_rng(self.seed, epoch, use))
                except Exception:
                    if attempt == self.corrupt_retries:
                        raise
                    logging.getLogger(__name__).warning(
                        "failed to load sample %d (attempt %d); substituting",
                        use, attempt + 1, exc_info=True)

        def fetch_batch(batch_idx):
            """The dataset's whole-batch path (the native decoder); None or
            an error falls back to ``fetch``, which substitutes unreadable
            samples."""
            try:
                rngs = [host_rng(self.seed, epoch, i) for i in batch_idx]
                samples = self.dataset.get_batch(batch_idx, rngs)
            except Exception:
                logging.getLogger(__name__).warning(
                    "get_batch failed; falling back to per-sample loads",
                    exc_info=True)
                samples = None
            return (samples if samples is not None
                    else [fetch(i) for i in batch_idx])

        # only where the dataset asks for it: the fallback above reads its
        # samples in turn, so per-sample loads keep the pool's parallelism
        use_batch = (hasattr(self.dataset, "get_batch")
                     and getattr(self.dataset, "native_decode", False))
        with cf.ThreadPoolExecutor(max_workers=self.num_threads) as pool:
            pending = []
            batch_iter = self._batches()

            def submit_next():
                batch_idx = next(batch_iter, None)
                if batch_idx is None:
                    return False
                pending.append(pool.submit(fetch_batch, batch_idx)
                               if use_batch else
                               [pool.submit(fetch, i) for i in batch_idx])
                return True

            for _ in range(self.prefetch + 1):
                if not submit_next():
                    break
            while pending:
                item = pending.pop(0)
                samples = (item.result() if use_batch
                           else [f.result() for f in item])
                submit_next()
                yield self.collate(samples)
