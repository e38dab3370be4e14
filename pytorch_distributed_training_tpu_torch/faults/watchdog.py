"""Hung-step watchdog: catch the failure that never raises (counterpart:
the JAX package's ``faults/watchdog.py``, which needs no JAX; the port
keeps its own copy).

A dead rank crashes; a wedged one (stuck in a collective, a checkpoint
write waiting on a filesystem that went away, a device queue that stopped
draining) hangs every peer, and no exception reaches the supervisor. The
watchdog is a monitor thread armed around each blocking section (the
train step in ``train/loop.py``, the checkpoint saves in
``train/checkpoint.py``):

- after ``stall_factor`` x the rolling median duration of that section
  (at least ``min_stall_s``) it emits a ``watchdog_stall`` record with
  every thread's stack;
- past ``hard_timeout_s`` it emits ``watchdog_abort``, flushes the
  telemetry stream and ends the process with ``WATCHDOG_EXIT_CODE``, so
  the supervisor restarts from a checkpoint;
- a section that finishes after a stall emits ``watchdog_recovered``.

Guards nest; the monitor watches the innermost armed section. Stalls and
aborts call the flight-recorder hook (``dump_flight``): a serving engine's
recorder registers there (``telemetry/flight.register``), so a serve-side
hang leaves its tick timeline beside the stacks.
"""

from __future__ import annotations

import contextlib
import os
import sys
import threading
import time
import traceback
from collections import deque

from pytorch_distributed_training_tpu_torch.telemetry.registry import (
    get_registry,
)
from pytorch_distributed_training_tpu_torch.utils.logging import get_logger

#: Exit status of a watchdog abort: a failure (a restart spends a budget
#: slot), told apart from a crash.
WATCHDOG_EXIT_CODE = 84

_STACK_LIMIT_CHARS = 8000

logger = get_logger(__name__)

#: callables run with the reason on a stall or an abort
#: (``telemetry/flight.dump_all`` once a recorder registers)
FLIGHT_DUMPS: list = []


def _all_stacks() -> str:
    """Every thread's current stack, newest frame last."""
    lines = []
    frames = sys._current_frames()
    for thread in threading.enumerate():
        frame = frames.get(thread.ident)
        if frame is None:
            continue
        lines.append(f"--- thread {thread.name} ({thread.ident}) ---")
        lines.extend(line.rstrip() for line in traceback.format_stack(frame))
    text = "\n".join(lines)
    if len(text) > _STACK_LIMIT_CHARS:
        text = text[-_STACK_LIMIT_CHARS:]
    return text


def dump_flight(reason: str) -> None:
    """Run every registered flight-recorder dump; never raises (the
    monitor must go on)."""
    for dump in list(FLIGHT_DUMPS):
        try:
            dump(reason)
        except Exception:  # pragma: no cover - failure-path best effort
            pass


class Watchdog:
    """One monitor thread per Trainer; ``guard`` is the call-site API.
    ``hard_timeout_s=0`` never aborts (stall records only). ``_exit`` is
    injectable so tests can see the abort without dying."""

    def __init__(self, *, stall_factor: float = 10.0,
                 min_stall_s: float = 60.0, hard_timeout_s: float = 1800.0,
                 _exit=os._exit):
        if stall_factor <= 0 or min_stall_s < 0 or hard_timeout_s < 0:
            raise ValueError(
                f"watchdog thresholds must be positive (stall_factor="
                f"{stall_factor}, min_stall_s={min_stall_s}, "
                f"hard_timeout_s={hard_timeout_s})")
        self.stall_factor = stall_factor
        self.min_stall_s = min_stall_s
        self.hard_timeout_s = hard_timeout_s
        self._exit = _exit
        self._cond = threading.Condition()
        # armed sections, outermost first; the monitor watches the last
        self._armed: list[dict] = []
        self._closed = False
        self._history: dict[str, deque] = {}
        self._thread: threading.Thread | None = None

    def stall_after_s(self, what: str) -> float:
        with self._cond:
            hist = self._history.get(what)
            if not hist:
                return self.min_stall_s
            med = sorted(hist)[len(hist) // 2]
        return max(self.min_stall_s, self.stall_factor * med)

    def observe(self, what: str, seconds: float) -> None:
        with self._cond:
            self._history.setdefault(what, deque(maxlen=32)).append(
                float(seconds))

    @contextlib.contextmanager
    def guard(self, what: str, *, step: int | None = None):
        """Arm around a section that blocks on the device, peers or the
        filesystem."""
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._monitor, name="pdt-watchdog", daemon=True)
            self._thread.start()
        t0 = time.monotonic()
        entry = {
            "what": what, "step": step, "t0": t0,
            "stall_deadline": t0 + self.stall_after_s(what),
            "hard_deadline": (t0 + self.hard_timeout_s
                              if self.hard_timeout_s else None),
            "stalled": False,
        }
        with self._cond:
            self._armed.append(entry)
            self._cond.notify_all()
        try:
            yield
        finally:
            duration = time.monotonic() - t0
            with self._cond:
                stalled = entry["stalled"]
                if entry in self._armed:
                    self._armed.remove(entry)
                self._cond.notify_all()
            self.observe(what, duration)
            if stalled:
                get_registry().emit({
                    "record": "watchdog_recovered", "section": what,
                    "step": step, "duration_s": duration,
                })
                logger.warning("watchdog: section %r recovered after %.1fs",
                               what, duration)

    def close(self) -> None:
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def _monitor(self) -> None:
        while True:
            with self._cond:
                if self._closed:
                    return
                entry = self._armed[-1] if self._armed else None
                if entry is None:
                    self._cond.wait()
                    continue
                now = time.monotonic()
                fire_hard = (entry["hard_deadline"] is not None
                             and now >= entry["hard_deadline"])
                fire_stall = (not fire_hard and not entry["stalled"]
                              and now >= entry["stall_deadline"])
                if not (fire_hard or fire_stall):
                    pending = [d for d in (
                        None if entry["stalled"] else entry["stall_deadline"],
                        entry["hard_deadline"]) if d is not None and d > now]
                    # nothing pending (stalled, no abort): sleep until the
                    # section disarms or another arms
                    self._cond.wait(
                        timeout=min(pending) - now if pending else None)
                    continue
                entry["stalled"] = True
            waited = time.monotonic() - entry["t0"]
            if not fire_hard:
                get_registry().emit({
                    "record": "watchdog_stall", "section": entry["what"],
                    "step": entry["step"], "waited_s": waited,
                    "stall_after_s": self.stall_after_s(entry["what"]),
                    "hard_timeout_s": self.hard_timeout_s,
                    "stacks": _all_stacks(),
                })
                dump_flight("watchdog_stall")
                logger.error(
                    "watchdog: section %r blocked for %.1fs (threshold "
                    "%.1fs): possible hung collective or device; stacks "
                    "recorded%s", entry["what"], waited,
                    self.stall_after_s(entry["what"]),
                    f"; aborting at {self.hard_timeout_s:.0f}s"
                    if self.hard_timeout_s else "")
                continue
            self._abort(entry, waited)
            return

    def _abort(self, entry: dict, waited: float) -> None:
        reg = get_registry()
        reg.emit({
            "record": "watchdog_abort", "section": entry["what"],
            "step": entry["step"], "waited_s": waited,
            "hard_timeout_s": self.hard_timeout_s,
            "exit_code": WATCHDOG_EXIT_CODE, "stacks": _all_stacks(),
        })
        dump_flight("watchdog_abort")
        if reg.sink is not None:
            try:
                reg.sink.flush(fsync=True)
            except Exception:  # pragma: no cover - best effort on the way out
                pass
        logger.critical(
            "watchdog: section %r blocked for %.1fs > hard timeout %.1fs: "
            "aborting (exit %d) so the supervisor can restart from a "
            "checkpoint", entry["what"], waited, self.hard_timeout_s,
            WATCHDOG_EXIT_CODE)
        self._exit(WATCHDOG_EXIT_CODE)


_current: Watchdog | None = None


def set_watchdog(watchdog: Watchdog | None) -> Watchdog | None:
    """Install the process-wide watchdog (the Trainer, for its run);
    returns the previous one."""
    global _current
    prev = _current
    _current = watchdog
    return prev


def get_watchdog() -> Watchdog | None:
    return _current


@contextlib.contextmanager
def watchdog_guard(what: str, *, step: int | None = None):
    """Guard a blocking section under the installed watchdog, if any (for
    layers with no Trainer handle: the checkpoint saves)."""
    wd = _current
    if wd is None:
        yield
    else:
        with wd.guard(what, step=step):
            yield
