"""Graceful preemption of long training runs (counterpart of the JAX
``utils/preempt.py``).

A scheduler that reclaims a machine sends SIGTERM and waits a short grace
window before SIGKILL. Every training CLI polls a ``GracefulShutdown`` once
a step; on a signal its loop finishes the step in flight, writes a
``preempt_<name>`` checkpoint in its usual resumable schema and returns, so
``-load_model true -checkpoint_name preempt_<name>`` continues the run (the
interrupted epoch is redone in full).

The first signal asks for a graceful stop; a second restores the handler
the process had and delivers the signal again, so a stuck run still dies
to the usual double Ctrl-C.
"""

from __future__ import annotations

import signal
from typing import Optional, Sequence

import torch

from ..parallel import mesh


class GracefulShutdown:
    """Context manager turning SIGTERM/SIGINT into a pollable flag.

    >>> with GracefulShutdown() as stop:
    ...     for batch in loader:
    ...         if stop.requested:
    ...             break  # the caller saves a preempt checkpoint, returns
    """

    def __init__(self, signals: Sequence[int] = (signal.SIGTERM,
                                                 signal.SIGINT)):
        self._signals = tuple(signals)
        self._previous: dict = {}
        self.requested = False
        self.signum: Optional[int] = None

    def _handler(self, signum, frame):
        if self.requested:
            # the second signal: restore the disposition the process had
            # (one installed outside Python reads as None: the default
            # then) and deliver it again
            signal.signal(signum, self._previous.get(signum) or signal.SIG_DFL)
            signal.raise_signal(signum)
            return
        self.requested = True
        self.signum = signum
        print(f"[preempt] caught signal {signum}: finishing the current "
              f"step, then saving a resumable checkpoint", flush=True)

    def __enter__(self) -> "GracefulShutdown":
        for s in self._signals:
            try:
                self._previous[s] = signal.signal(s, self._handler)
            except ValueError:
                # not the main thread: stay pollable, never signalled
                pass
        return self

    def __exit__(self, *exc) -> None:
        for s, prev in self._previous.items():
            signal.signal(s, prev if prev is not None else signal.SIG_DFL)
        self._previous.clear()


class NullShutdown:
    """Never requested: lets a step loop poll unconditionally."""

    requested = False
    signum = None


class CrossProcessShutdown:
    """Every rank's answer to "stop?" at the same poll.

    A scheduler may signal only some ranks. A signalled rank that left its
    loop alone would leave the others blocked at their next collective, and
    if it is not rank 0 the process-0 preempt checkpoint would never be
    written. Reading ``requested`` all-reduces the local flag with MAX
    over a gloo group (``mesh.host_group``: the poll never waits for the
    card), so all ranks leave together and rank 0 saves. The answer
    latches once true. Every rank must poll at the same points, as
    lockstep loops do.
    """

    def __init__(self, inner):
        self._inner = inner
        self._agreed = False

    @property
    def requested(self) -> bool:
        if not self._agreed:
            flag = torch.tensor([int(bool(self._inner.requested))])
            self._agreed = bool(mesh.all_reduce(
                flag, "max", group=mesh.host_group()).item())
        return self._agreed

    @property
    def signum(self):
        # None on a rank that saw no signal of its own
        return self._inner.signum


def cross_process(shutdown):
    """``shutdown`` wrapped for agreement across ranks; itself with one
    process, and for ``NullShutdown``, whose flag is false on every rank
    (a collective a step would buy nothing)."""
    if isinstance(shutdown, NullShutdown) or mesh.process_count() == 1:
        return shutdown
    return CrossProcessShutdown(shutdown)
