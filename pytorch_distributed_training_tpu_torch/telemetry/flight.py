"""Engine flight recorder: the last N tick summaries, dumped post-mortem
(counterpart: the JAX package's ``telemetry/flight.py``; the port keeps
its own copy).

The engine appends one bounded summary a busy or eventful tick (phase
mix, slots, pages, tick ms, swap and brownout events) into a fixed-size
ring, and the ring is dumped as one ``flight_dump`` record when something
goes wrong:

- **watchdog stall or abort**: ``register`` puts ``dump_all`` in
  ``faults/watchdog.FLIGHT_DUMPS``, which the watchdog's monitor runs, so
  the dump's last entries are the stalled tick's run-up;
- **fatal tick** (``serve/server.py``'s loop failure path);
- **SIGTERM drain** (``cli/serve_lm.py``);
- **on demand**: ``GET /debug/flight`` on a live replica.

The engine thread writes; the watchdog monitor, HTTP handler threads and
the drain thread dump; the ring sits behind the registry's
``telemetry.flight`` lock (``analysis/concurrency``).
"""

from __future__ import annotations

import time
from collections import deque

from pytorch_distributed_training_tpu_torch.analysis import concurrency
from pytorch_distributed_training_tpu_torch.telemetry.registry import (
    get_registry,
)


#: default ring capacity — enough run-up to see a stall pattern, small
#: enough that a dump record stays one readable JSONL line
DEFAULT_CAPACITY = 256

#: entries included verbatim in a ``flight_dump`` record (the full ring is
#: available via ``snapshot()``/``/debug/flight``; the emitted record keeps
#: the tail, which is where the evidence lives)
DUMP_TAIL = 64


class FlightRecorder:
    """Bounded ring of tick summaries with one-call post-mortem dumps."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY, *,
                 component: str = "engine", registry=None):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        if registry is None:
            registry = get_registry()
        self._registry = registry
        self.component = component
        self.capacity = capacity
        # engine thread records; watchdog/HTTP/drain threads dump
        self._lock = concurrency.lock("telemetry.flight")
        self._ring: deque = deque(maxlen=capacity)
        self._seq = 0
        self.recorded = 0
        self.dumps = 0
        self.last_dump_reason = None

    def record(self, **entry) -> None:
        """Append one tick summary (engine thread, once per busy/eventful
        tick). Entries get a monotonic sequence number so a dump shows
        gaps (idle stretches) honestly."""
        with self._lock:
            self._seq += 1
            self._ring.append({"seq": self._seq, **entry})
            self.recorded += 1

    def snapshot(self) -> list:
        """The current ring contents, oldest first (any thread)."""
        with self._lock:
            return [dict(e) for e in self._ring]

    def dump(self, reason: str, *, attrs: dict = None) -> dict:
        """Emit the ring as one ``flight_dump`` record and return it."""
        with self._lock:
            entries = [dict(e) for e in self._ring]
            self.dumps += 1
            self.last_dump_reason = reason
            dumps = self.dumps
        record = {
            "record": "flight_dump",
            "component": self.component,
            "reason": reason,
            "capacity": self.capacity,
            "depth": len(entries),
            "dropped": max(0, self._seq - len(entries)),
            "dumps": dumps,
            "dumped_at": time.time(),
            "entries": entries[-DUMP_TAIL:],
            **(attrs or {}),
        }
        self._registry.emit(record)
        return record

    def stats(self) -> dict:
        with self._lock:
            return {
                "flight_capacity": self.capacity,
                "flight_depth": len(self._ring),
                "flight_recorded": self.recorded,
                "flight_dumps": self.dumps,
                "flight_last_dump": self.last_dump_reason,
            }


# ----------------------------------------------------- process-wide hookup
#
# The watchdog monitor (faults/watchdog.py) fires in layers that hold no
# engine handle; recorders register here so ``dump_all`` can reach every
# live ring in the process without plumbing.

_registered: list = []
_reg_lock = concurrency.lock("telemetry.flight.registry")


def register(recorder: FlightRecorder) -> FlightRecorder:
    """Add ``recorder`` to the rings ``dump_all`` dumps, and ``dump_all``
    to the watchdog's stall and abort hooks (once)."""
    from pytorch_distributed_training_tpu_torch.faults.watchdog import (
        FLIGHT_DUMPS,
    )

    with _reg_lock:
        if recorder not in _registered:
            _registered.append(recorder)
        if dump_all not in FLIGHT_DUMPS:
            FLIGHT_DUMPS.append(dump_all)
    return recorder


def unregister(recorder: FlightRecorder) -> None:
    with _reg_lock:
        if recorder in _registered:
            _registered.remove(recorder)


def registered() -> list:
    with _reg_lock:
        return list(_registered)


def dump_all(reason: str) -> int:
    """Dump every registered recorder (watchdog stall/abort path); returns
    how many dumps were emitted. Never raises — this runs on failure paths
    that must keep making progress."""
    n = 0
    for recorder in registered():
        try:
            recorder.dump(reason)
            n += 1
        except Exception:  # pragma: no cover - failure-path best effort
            pass
    return n
