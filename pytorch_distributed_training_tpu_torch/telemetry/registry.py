"""Metric primitives: counters, gauges, timer histograms, one registry
(counterpart: the JAX package's ``telemetry/registry.py``, which needs no
JAX; the port keeps its own copy).

Instrumentation sites record into whatever registry is installed, cheap
enough to stay on; the Trainer snapshots it per epoch. With a sink
attached (``sink.JsonlSink``), ``emit`` forwards event records through it
(rank-0-gated inside the sink, so call sites never branch on rank). A
module-level default registry lets layers with no Trainer handle (the
checkpointer, the supervisor, the fault hooks) record; the Trainer
installs its own as the default for its run.
"""

from __future__ import annotations

import contextlib
import threading
import time

import numpy as np


class TimerStat:
    """Observations of one timed quantity (seconds); summarizes on demand."""

    __slots__ = ("values",)

    def __init__(self):
        self.values: list[float] = []

    def observe(self, seconds: float) -> None:
        self.values.append(float(seconds))

    def summary(self) -> dict:
        v = np.asarray(self.values, np.float64)
        if v.size == 0:
            return {"count": 0, "total_s": 0.0}
        return {
            "count": int(v.size),
            "total_s": float(v.sum()),
            "mean_s": float(v.mean()),
            "min_s": float(v.min()),
            "max_s": float(v.max()),
            "p50_s": float(np.percentile(v, 50)),
            "p95_s": float(np.percentile(v, 95)),
        }


class MetricsRegistry:
    """Counters (``inc``), gauges (``gauge``) and timers (``observe`` or
    the ``timer(name)`` context manager, in seconds, summarized to
    count/total/mean/min/max/p50/p95), with an optional JSONL sink.
    ``snapshot(reset=True)`` returns the window and clears it (the Trainer
    resets per epoch)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: dict[str, float] = {}
        self._gauges: dict[str, float] = {}
        self._timers: dict[str, TimerStat] = {}
        self._sink = None

    def inc(self, name: str, n: float = 1) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + n

    def gauge(self, name: str, value: float) -> None:
        with self._lock:
            self._gauges[name] = float(value)

    def observe(self, name: str, seconds: float) -> None:
        with self._lock:
            stat = self._timers.get(name)
            if stat is None:
                stat = self._timers[name] = TimerStat()
            stat.observe(seconds)

    @contextlib.contextmanager
    def timer(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.observe(name, time.perf_counter() - t0)

    def attach_sink(self, sink) -> None:
        self._sink = sink

    @property
    def sink(self):
        return self._sink

    def emit(self, record: dict) -> None:
        """Forward an event record to the attached sink (no-op without
        one; the sink gates on rank 0)."""
        if self._sink is not None:
            self._sink.emit(record)

    def snapshot(self, *, reset: bool = False) -> dict:
        with self._lock:
            out = {
                "counters": dict(self._counters),
                "gauges": dict(self._gauges),
                "timers": {k: s.summary() for k, s in self._timers.items()},
            }
            if reset:
                self._counters.clear()
                self._gauges.clear()
                self._timers.clear()
        return out


_DEFAULT: MetricsRegistry | None = None
_DEFAULT_LOCK = threading.Lock()


def get_registry() -> MetricsRegistry:
    """The process-wide default registry (created lazily)."""
    global _DEFAULT
    with _DEFAULT_LOCK:
        if _DEFAULT is None:
            _DEFAULT = MetricsRegistry()
        return _DEFAULT


def set_registry(registry: MetricsRegistry | None) -> MetricsRegistry | None:
    """Install ``registry`` as the process default; returns the previous
    one (pass it back to restore)."""
    global _DEFAULT
    with _DEFAULT_LOCK:
        prev = _DEFAULT
        _DEFAULT = registry
        return prev
