"""The JSONL metric stream of the training CLIs and the GAN CLI's live
visdom panels (``MetricsLogger`` and ``VisdomPlotter`` of the JAX
``utils/observability.py``; its profiler and sanitizer hooks are JAX's own
and have no counterpart here)."""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional


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


class VisdomPlotter:
    """Live loss lines and image panels (reference train.py:241-260);
    inert without visdom or without a reachable server, and inert from the
    first failed post on (a server that drops mid-run must not end the
    training)."""

    def __init__(self, env: str = "thermal semantic segmentation"):
        # visdom.Visdom() does not raise when no server is reachable: gate
        # on an actual connection
        try:
            import visdom  # type: ignore
            vis = visdom.Visdom(env=env, raise_exceptions=True)
            self.vis = vis if vis.check_connection() else None
        except Exception:
            self.vis = None

    def _post(self, fn, *args, **kwargs) -> None:
        try:
            fn(*args, **kwargs)
        except Exception as e:  # visdom raises ConnectionError subclasses
            print(f"visdom post failed ({e!r}); live panels disabled")
            self.vis = None

    def plot_loss(self, epoch_counter_ratio, losses: Dict[str, list]) -> None:
        if self.vis is None:
            return
        import numpy as np
        legend = list(losses.keys())
        self._post(
            self.vis.line, X=np.array(epoch_counter_ratio),
            Y=np.array([losses[k] for k in legend]).transpose(),
            opts={"title": " loss over time", "legend": legend,
                  "xlabel": "epoch", "ylabel": "loss"},
            win="loss")

    def images(self, tensor, win: str, title: Optional[str] = None) -> None:
        if self.vis is None:
            return
        self._post(self.vis.images, tensor, win=win, padding=2,
                   opts=dict(title=title or win, caption=title or win))
