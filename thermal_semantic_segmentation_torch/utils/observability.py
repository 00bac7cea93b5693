"""The JSONL metric stream of the training CLIs (``MetricsLogger`` of the
JAX ``utils/observability.py``; its profiler and sanitizer hooks are
JAX's own and have no counterpart here)."""

from __future__ import annotations

import json
import os
import time
from typing import Dict


class MetricsLogger:
    """Append-only JSONL metric stream: one record per log call."""

    def __init__(self, path: str):
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self.path = path
        self._start = time.time()

    def log(self, step: int, metrics: Dict[str, float], **extra) -> None:
        rec = {"step": int(step), "t": round(time.time() - self._start, 3),
               **{k: float(v) for k, v in metrics.items()}, **extra}
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")
