"""Preemption-safe shutdown: SIGTERM/SIGINT -> stop at the next step
boundary (counterpart: the JAX package's ``faults/preemption.py``, which
needs no JAX; the port keeps its own copy).

Clusters preempt (maintenance, spot reclamation) with a SIGTERM and a
short grace window. The Trainer installs ``GracefulShutdown`` around its
epoch loop: the handler only sets a flag (async-signal-safe), the loop
notices at the next step boundary, writes an emergency checkpoint inside
the grace window, emits a ``preemption`` record and exits with
``RESUMABLE_EXIT_CODE``: not a crash, so a supervisor (``cli/launch.py``,
a restart loop) requeues the job without spending a restart, and the
in-process ``run_with_restarts`` lets it through instead of retrying on a
host that is going away.
"""

from __future__ import annotations

import signal
import threading

from pytorch_distributed_training_tpu_torch.utils.logging import get_logger

#: EX_TEMPFAIL, "transient, resubmit": the exit code of a preempted run
#: that checkpointed. Supervisors restart it without counting it against
#: the restart budget.
RESUMABLE_EXIT_CODE = 75

logger = get_logger(__name__)


class Preempted(SystemExit):
    """Raised at the step boundary after a shutdown signal; carries
    ``RESUMABLE_EXIT_CODE`` so the exit status says "resumable"."""

    def __init__(self, signum: int, step: int | None = None):
        super().__init__(RESUMABLE_EXIT_CODE)
        self.signum = signum
        self.step = step

    def __str__(self) -> str:  # SystemExit.__str__ prints the bare code
        name = signal.Signals(self.signum).name if self.signum else "?"
        return f"preempted by {name} (resumable, exit {RESUMABLE_EXIT_CODE})"


class GracefulShutdown:
    """Flag-setting SIGTERM/SIGINT handlers with install/uninstall. The
    handler only records the signal (no I/O, no raise), so it is safe
    anywhere in the run, a kernel launch included. A second SIGINT
    restores Python's default handler first, so a user who means it gets
    a KeyboardInterrupt at once instead of waiting out a checkpoint."""

    def __init__(self, *, handle_sigint: bool = True):
        self._signals = [signal.SIGTERM] + (
            [signal.SIGINT] if handle_sigint else [])
        self._previous: dict[int, object] = {}
        self._requested: int | None = None
        self.installed = False

    def install(self) -> "GracefulShutdown":
        if threading.current_thread() is not threading.main_thread():
            # signal.signal works on the main thread only: a Trainer run
            # from a worker thread loses preemption handling, loudly
            logger.warning("graceful-shutdown handlers not installed (not "
                           "on the main thread)")
            return self
        for sig in self._signals:
            self._previous[sig] = signal.signal(sig, self._handle)
        self.installed = True
        return self

    def uninstall(self) -> None:
        for sig, prev in self._previous.items():
            try:
                signal.signal(sig, prev)
            except (ValueError, TypeError):  # pragma: no cover - teardown
                pass
        self._previous.clear()
        self.installed = False

    def __enter__(self) -> "GracefulShutdown":
        return self.install()

    def __exit__(self, *exc) -> None:
        self.uninstall()

    def _handle(self, signum, frame) -> None:
        self._requested = signum
        if signum == signal.SIGINT:
            # the next Ctrl-C is an ordinary KeyboardInterrupt
            signal.signal(signal.SIGINT, self._previous.get(
                signal.SIGINT, signal.default_int_handler))

    @property
    def requested(self) -> int | None:
        """The signal number received, or None. Polled at step
        boundaries."""
        return self._requested
