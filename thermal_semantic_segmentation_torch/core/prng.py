"""Host-side random streams (counterpart of ``host_rng`` in the JAX
``core/prng.py``, which the port may not import: that module imports JAX).

Host-side sampling uses ``numpy.random.Generator`` instances derived from
(seed, epoch, sample index), so any sample's draws are reproducible whatever
the loader's thread schedule, and equal to the JAX package's.
"""

from __future__ import annotations

import numpy as np


def host_rng(seed: int, *stream: int) -> np.random.Generator:
    """A numpy Generator for a (seed, *stream) tuple, e.g. (seed, epoch, idx)."""
    return np.random.default_rng(np.random.SeedSequence([seed, *stream]))
