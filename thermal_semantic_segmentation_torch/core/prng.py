"""Random streams (counterpart of the JAX ``core/prng.py``, which the port
may not import: that module imports JAX).

Host-side sampling uses ``numpy.random.Generator`` instances derived from
(seed, epoch, sample index), so any sample's draws are reproducible whatever
the loader's thread schedule, and equal to the JAX package's. Device-side
draws of a step come from a ``torch.Generator`` derived from (seed, step)
(``split_for_step``).
"""

from __future__ import annotations

import numpy as np
import torch


def host_rng(seed: int, *stream: int) -> np.random.Generator:
    """A numpy Generator for a (seed, *stream) tuple, e.g. (seed, epoch, idx)."""
    return np.random.default_rng(np.random.SeedSequence([seed, *stream]))


def split_for_step(device, seed: int, step: int, *key: int
                   ) -> torch.Generator:
    """The generator of one step's device draws: on ``device``, seeded from
    ``np.random.SeedSequence([seed, step, *key])``. The same (seed, step,
    key) gives the same draws and any other step others, as JAX's
    ``fold_in(key, step)`` does; the bits differ from threefry's, which
    torch cannot draw."""
    state = np.random.SeedSequence([seed, step, *key]).generate_state(
        1, np.uint64)[0]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(state))
    return gen
