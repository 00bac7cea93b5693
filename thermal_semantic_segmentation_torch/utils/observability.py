"""Observability (counterpart of the JAX ``utils/observability.py``): the
JSONL metric stream of the training CLIs, the GAN CLI's live visdom panels,
a profiler trace around a region with named spans in it, and a numeric
sanitizer.

``profiler_trace`` is ``torch.profiler`` where JAX starts
``jax.profiler``; ``step_annotation`` a ``record_function`` span where JAX
opens a ``TraceAnnotation``; ``enable_debug_mode`` raises
``FloatingPointError`` at the first operation whose floating output holds a
NaN (or an Inf), where JAX sets ``jax_debug_nans`` (``jax_debug_infs``).
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from ..device import resolve_device


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


@contextlib.contextmanager
def profiler_trace(logdir: str, enabled: bool = True, device=None):
    """``torch.profiler`` around the block, its Chrome trace written into
    ``logdir`` (``<host>_<pid>.<time>.pt.trace.json``, which TensorBoard's
    profiler plugin reads) when the block ends. It records the host's
    operations and, on a CUDA ``device`` (the default; raises without
    one), the card's kernels. ``enabled=False`` records nothing."""
    if not enabled:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if resolve_device(device).type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(logdir)):
        yield


def step_annotation(name: str):
    """A named span in the profiler's trace for a host-side phase (data
    wait, checkpoint IO, ...): ``with step_annotation("data"): ...``."""
    return torch.profiler.record_function(name)


class _NumericCheck(TorchDispatchMode):
    """Checks the floating outputs of every operation dispatched while it
    is on the mode stack."""

    def __init__(self, nans: bool, infs: bool):
        super().__init__()
        self.nans, self.infs = nans, infs

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out):
            if not isinstance(t, torch.Tensor) or t.device.type == "meta" \
                    or not (t.is_floating_point() or t.is_complex()):
                continue
            if self.nans and bool(torch.isnan(t).any()):
                raise FloatingPointError(
                    f"invalid value (nan) encountered in {func}")
            if self.infs and bool(torch.isinf(t).any()):
                raise FloatingPointError(
                    f"invalid value (inf) encountered in {func}")
        return out


# the check that ``enable_debug_mode`` put on the mode stack
_debug_check = {}


def enable_debug_mode(nans: bool = True, infs: bool = False) -> None:
    """Development mode that fails fast: every operation that makes a NaN
    (``nans``) or an Inf (``infs``) in a floating output raises
    ``FloatingPointError``, forward and backward. Each check waits for the
    device, so the mode is slow. ``enable_debug_mode(False, False)`` turns
    it off. It holds in the calling thread and in the autograd threads of
    its backward passes."""
    check = _debug_check.pop("mode", None)
    if check is not None:
        check.__exit__(None, None, None)
    if nans or infs:
        check = _NumericCheck(nans, infs)
        check.__enter__()
        _debug_check["mode"] = check
