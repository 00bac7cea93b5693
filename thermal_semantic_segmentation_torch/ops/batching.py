"""Leading-axis padding to a fixed batch shape (counterpart of the JAX
``ops/batching.py``): the server pads a coalesced tail batch up to its fixed
batch size so every forward sees one input shape."""

from __future__ import annotations

import numpy as np


def pad_rows(arr: np.ndarray, n: int) -> np.ndarray:
    """Pad ``arr`` with zero rows on axis 0 up to ``n`` rows (no-op when it
    already has ``n`` or more)."""
    pad = n - arr.shape[0]
    if pad <= 0:
        return arr
    return np.concatenate([arr, np.zeros((pad, *arr.shape[1:]), arr.dtype)])
