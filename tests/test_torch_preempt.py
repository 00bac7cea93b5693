"""The port's preemption handling (utils/preempt.py) against the JAX
package's behaviour (tests/test_preempt.py): a signal becomes a pollable
flag and the handlers are restored, a second signal escalates, and with
one process the cross-process wrapper is the flag itself. The trainers'
preempt checkpoints: tests/test_torch_dist.py (the train CLI over two
ranks), tests/test_torch_self_train_cli.py and tests/test_torch_gan_cli.py,
which use ``StopAfter`` in place of a real signal."""

import signal

import pytest

pytest.importorskip("torch")

from thermal_semantic_segmentation_torch.utils.preempt import (  # noqa: E402
    CrossProcessShutdown, GracefulShutdown, NullShutdown, cross_process)


class StopAfter:
    """A ``GracefulShutdown`` stand-in: requested from the poll after the
    ``after``-th on, as a SIGTERM between two steps would be."""

    def __init__(self, after: int = 1):
        self.after, self.polls, self.signum = after, 0, signal.SIGTERM

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        pass

    @property
    def requested(self) -> bool:
        self.polls += 1
        return self.polls > self.after


def test_graceful_shutdown_flag_and_restore():
    before = signal.getsignal(signal.SIGTERM)
    with GracefulShutdown() as stop:
        assert not stop.requested
        signal.raise_signal(signal.SIGTERM)   # delivered synchronously
        assert stop.requested and stop.signum == signal.SIGTERM
    assert signal.getsignal(signal.SIGTERM) is before


def test_graceful_shutdown_second_signal_escalates():
    hits = []
    old = signal.signal(signal.SIGUSR1, lambda signum, frame:
                        hits.append(signum))
    try:
        with GracefulShutdown(signals=(signal.SIGUSR1,)) as stop:
            signal.raise_signal(signal.SIGUSR1)
            assert stop.requested and not hits
            signal.raise_signal(signal.SIGUSR1)   # the previous handler's
            assert hits == [signal.SIGUSR1]
    finally:
        signal.signal(signal.SIGUSR1, old)


def test_one_process_polls_its_own_flag():
    null = NullShutdown()
    assert null.requested is False and cross_process(null) is null
    with GracefulShutdown() as stop:
        assert cross_process(stop) is stop
        assert not isinstance(cross_process(stop), CrossProcessShutdown)
