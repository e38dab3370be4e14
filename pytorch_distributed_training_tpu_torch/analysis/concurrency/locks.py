"""Runtime lock registry: instrumented locks, order inversions, contention
(counterpart: the JAX package's ``analysis/concurrency/locks.py``, which
imports no JAX; the port keeps its own copy, with JAX's record types and
keys, so ``scripts/summarize_metrics.py``'s "locks" section reads the
port's stream unchanged).

- ``lock(name)`` / ``rlock(name)`` are drop-in ``threading.Lock/RLock``
  factories. Mode ``off`` (``PDT_TPU_GUARDS``) returns the plain stdlib
  object — zero overhead. In ``record``/``strict`` they return a
  ``TracedLock`` that feeds the process-wide ``LockRegistry``:

  - per-lock **wait time** (acquire call -> acquired), **hold time**
    (acquired -> released) and a **contention** counter (the lock was
    held by someone else when we arrived) — in-memory only; nothing is
    emitted per acquire, so instrumenting the telemetry sink's own lock
    cannot recurse;
  - a **lock-order graph** over the orders actually observed at runtime
    (thread-local held-stack; acquiring B while holding A records the
    edge A->B). An acquisition that would close a cycle is a
    **lock-order inversion**: a ``lock_order_violation`` record (+
    counter) in record mode, a raised ``LockOrderViolation`` — *before*
    the lock is taken — in strict mode;
  - ``held_lock_names()`` and ``check_device_boundary`` let
    device-boundary code flag work dispatched **while holding a lock**
    (a kernel launch or a device-to-host copy under a lock serializes
    every thread needing it behind the card); the runtime guards
    (``analysis/guards.py``) call it at every guarded call and
    ``transfer_scope``.

- ``summary_record()`` shapes the registry into one ``lock_summary``
  telemetry record (per-lock acquires/contention/wait/hold percentiles,
  keyed by pid so multi-process fleet streams merge).

Names are call-site stable (``"serve.queue"``, ``"serve.router.breaker.r0"``),
shared by every instance created at that site, so fleet-wide aggregation
is by role, not by object identity. The module imports no torch (the
fleet's coordinator process locks too).
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Optional

_MODES = ("off", "record", "strict")

#: bounded per-lock sample reservoirs — a week of serving must not grow
#: an unbounded list per hot lock; percentiles are over the recent window
_SAMPLES = 2048


class LockOrderViolation(RuntimeError):
    """Acquiring this lock here inverts an order already observed live —
    two threads interleaving the two orders deadlock (strict mode)."""


def _mode_from_env(default: str = "record") -> str:
    mode = os.environ.get("PDT_TPU_GUARDS", default)
    return mode if mode in _MODES else default


_tls = threading.local()    # .held: list[str], .quiet: int (re-entrancy)


def _held() -> list:
    held = getattr(_tls, "held", None)
    if held is None:
        held = _tls.held = []
    return held


def held_lock_names() -> tuple:
    """Traced locks the CURRENT thread holds right now (outermost first)."""
    return tuple(_held())


class LockStats:
    """In-memory accounting for one lock name (all instances)."""

    __slots__ = (
        "acquires", "contentions", "wait_total_s", "wait_max_s",
        "hold_total_s", "hold_max_s", "waits", "holds",
    )

    def __init__(self):
        self.acquires = 0
        self.contentions = 0
        self.wait_total_s = 0.0
        self.wait_max_s = 0.0
        self.hold_total_s = 0.0
        self.hold_max_s = 0.0
        self.waits: deque = deque(maxlen=_SAMPLES)
        self.holds: deque = deque(maxlen=_SAMPLES)

    @staticmethod
    def _pct(samples: deque, p: float) -> Optional[float]:
        if not samples:
            return None
        vals = sorted(samples)
        return vals[min(len(vals) - 1, int(p / 100.0 * len(vals)))]

    def summary(self) -> dict:
        return {
            "acquires": self.acquires,
            "contentions": self.contentions,
            "wait_total_s": self.wait_total_s,
            "wait_max_s": self.wait_max_s,
            "wait_p99_s": self._pct(self.waits, 99),
            "hold_total_s": self.hold_total_s,
            "hold_max_s": self.hold_max_s,
            "hold_p99_s": self._pct(self.holds, 99),
        }


class LockRegistry:
    """Process-wide lock accounting + the observed lock-order graph.

    Internal state is guarded by ONE plain (un-instrumented) lock —
    instrumenting the instrumentation would recurse — and held only for
    dict updates, never while emitting telemetry or raising."""

    def __init__(self, mode: Optional[str] = None, registry=None):
        self.mode = mode if mode in _MODES else _mode_from_env()
        self._registry = registry
        self._internal = threading.Lock()
        self._stats: dict[str, LockStats] = {}
        self._edges: dict[str, set] = {}        # observed A-held -> B
        self.order_violations = 0
        self.device_boundary_holds = 0

    # ------------------------------------------------------------ telemetry

    def _telemetry(self):
        if self._registry is not None:
            return self._registry
        from pytorch_distributed_training_tpu_torch.telemetry.registry import (
            get_registry,
        )

        return get_registry()

    def _stats_for(self, name: str) -> LockStats:
        with self._internal:
            stats = self._stats.get(name)
            if stats is None:
                stats = self._stats[name] = LockStats()
            return stats

    # ----------------------------------------------------------- order graph

    def _path_exists(self, src: str, dst: str) -> bool:
        """DFS over the observed order graph (caller holds _internal)."""
        seen = set()
        stack = [src]
        while stack:
            n = stack.pop()
            if n == dst:
                return True
            if n in seen:
                continue
            seen.add(n)
            stack.extend(self._edges.get(n, ()))
        return False

    def before_acquire(self, name: str) -> None:
        """Record order edges held->name; detect an inversion BEFORE the
        lock is taken (strict raises with nothing new held)."""
        held = _held()
        if not held or getattr(_tls, "quiet", 0):
            return
        inversion_from = None
        with self._internal:
            for h in held:
                if h == name:
                    continue    # re-entrant same-name (rlock) is not an edge
                # would held->name close a cycle (name ~> held observed)?
                if inversion_from is None and self._path_exists(name, h):
                    inversion_from = h
                self._edges.setdefault(h, set()).add(name)
        if inversion_from is not None:
            with self._internal:
                self.order_violations += 1
            _tls.quiet = getattr(_tls, "quiet", 0) + 1
            try:
                reg = self._telemetry()
                reg.inc("locks/order_violations")
                reg.emit({
                    "record": "lock_order_violation",
                    "acquiring": name,
                    "holding": list(held),
                    "inverts": f"{name} -> {inversion_from}",
                })
            finally:
                _tls.quiet -= 1
            if self.mode == "strict":
                raise LockOrderViolation(
                    f"acquiring lock {name!r} while holding {held} inverts "
                    f"the observed order ({name} was taken before "
                    f"{inversion_from!r} elsewhere) — two threads "
                    f"interleaving these orders deadlock"
                )

    # ------------------------------------------------------- device boundary

    def check_device_boundary(self, boundary: str) -> list:
        """Called at kernel-launch / device-to-host copy boundaries: locks
        held across them serialize every waiter behind the card. Returns
        the held names (caller decides record vs strict)."""
        held = list(_held())
        if held and not getattr(_tls, "quiet", 0):
            with self._internal:
                self.device_boundary_holds += 1
            _tls.quiet = getattr(_tls, "quiet", 0) + 1
            try:
                reg = self._telemetry()
                reg.inc("locks/device_boundary_holds")
                reg.emit({
                    "record": "lock_across_device",
                    "boundary": boundary,
                    "holding": held,
                })
            finally:
                _tls.quiet -= 1
        return held

    # --------------------------------------------------------------- summary

    def summary_record(self) -> dict:
        with self._internal:
            locks = {n: s.summary() for n, s in self._stats.items()}
            edges = {a: sorted(b) for a, b in self._edges.items()}
        return {
            "record": "lock_summary",
            "pid": os.getpid(),
            "mode": self.mode,
            "order_violations": self.order_violations,
            "device_boundary_holds": self.device_boundary_holds,
            "order_edges": edges,
            "locks": locks,
        }

    def emit_summary(self, registry=None) -> dict:
        rec = self.summary_record()
        (registry if registry is not None else self._telemetry()).emit(rec)
        return rec


class PeriodicSummary:
    """Background ``lock_summary`` emission on a fixed cadence.

    Shutdown-only summaries have a blind spot: a wedged process never
    reaches shutdown, so the run that most needs its lock stats reports
    none. This thread emits the same ``lock_summary`` record every
    ``interval_s`` seconds while the process lives (daemon — it must never
    block exit; the final shutdown emission still happens on the main
    thread). Created via ``start_periodic_summary``; ``stop()`` is
    idempotent and bounded."""

    def __init__(self, lock_registry: "LockRegistry", interval_s: float,
                 registry=None):
        if interval_s <= 0:
            raise ValueError(
                f"interval_s must be > 0, got {interval_s} (use no periodic "
                "summary at all instead of a zero cadence)"
            )
        self._lock_registry = lock_registry
        self._interval_s = float(interval_s)
        self._registry = registry
        self._stop = threading.Event()
        self.emitted = 0
        self._thread = threading.Thread(
            target=self._run, name="lock-summary", daemon=True
        )

    def start(self) -> "PeriodicSummary":
        self._thread.start()
        return self

    def _run(self) -> None:
        # bounded wait per cycle; stop() wakes it immediately
        while not self._stop.wait(self._interval_s):
            try:
                self._lock_registry.emit_summary(self._registry)
                self.emitted += 1
            except Exception:  # pragma: no cover - sink failure
                # periodic observability must never kill the process it
                # observes; the shutdown-path summary still gets a chance
                pass

    def stop(self, timeout: float = 5.0) -> None:
        self._stop.set()
        if self._thread.is_alive():
            self._thread.join(timeout=timeout)


def start_periodic_summary(interval_s: float, *, registry=None,
                           lock_registry: Optional["LockRegistry"] = None
                           ) -> PeriodicSummary:
    """Start in-run ``lock_summary`` emission every ``interval_s`` seconds
    (the ``--lock-summary-s`` cadence in serve_lm/fleet_lm). Returns the
    running ``PeriodicSummary``; call ``.stop()`` at shutdown."""
    return PeriodicSummary(
        lock_registry if lock_registry is not None else get_lock_registry(),
        interval_s, registry,
    ).start()


class TracedLock:
    """Instrumented wrapper over one ``threading.Lock``/``RLock``.

    Implements the lock protocol (``acquire``/``release``/context
    manager/``locked``) plus the delegation ``threading.Condition`` needs,
    so ``Condition(lock("x"))`` keeps working — Condition's fallback path
    re-acquires through THIS wrapper, which keeps the held-stack honest
    across ``cond.wait()`` (the wait releases the lock and the stack
    reflects it)."""

    __slots__ = ("name", "_inner", "_registry", "_stats")

    def __init__(self, name: str, inner, registry: "LockRegistry"):
        self.name = name
        self._inner = inner
        self._registry = registry
        self._stats = registry._stats_for(name)

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        quiet = getattr(_tls, "quiet", 0)
        if not quiet:
            self._registry.before_acquire(self.name)
        # uncontended fast path doubles as the contention probe
        got = self._inner.acquire(False)
        contended = not got
        waited = 0.0
        if not got:
            if not blocking:
                return False
            t0 = time.monotonic()
            got = self._inner.acquire(True, timeout)
            waited = time.monotonic() - t0
            if not got:
                return False
        _held().append(self.name)
        stats = self._stats
        with self._registry._internal:
            stats.acquires += 1
            if contended:
                stats.contentions += 1
                stats.wait_total_s += waited
                stats.wait_max_s = max(stats.wait_max_s, waited)
                stats.waits.append(waited)
        # hold timing rides the held-stack entry; keep it thread-local
        starts = getattr(_tls, "starts", None)
        if starts is None:
            starts = _tls.starts = {}
        starts.setdefault(self.name, []).append(time.monotonic())
        return True

    def release(self) -> None:
        held = _held()
        # remove the NEWEST occurrence (out-of-order release keeps the
        # rest of the stack intact)
        for i in range(len(held) - 1, -1, -1):
            if held[i] == self.name:
                del held[i]
                break
        starts = getattr(_tls, "starts", {}).get(self.name)
        if starts:
            hold = time.monotonic() - starts.pop()
            stats = self._stats
            with self._registry._internal:
                stats.hold_total_s += hold
                stats.hold_max_s = max(stats.hold_max_s, hold)
                stats.holds.append(hold)
        self._inner.release()

    def locked(self) -> bool:
        return self._inner.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def __repr__(self):
        return f"<TracedLock {self.name!r} {self._inner!r}>"

    # Condition support: delegate the RLock-only protocol when the inner
    # lock has it (a plain Lock falls back to Condition's acquire/release
    # path, which routes through the instrumented methods above).
    def _is_owned(self):
        if hasattr(self._inner, "_is_owned"):
            return self._inner._is_owned()
        if self._inner.acquire(False):
            self._inner.release()
            return False
        return True


# ------------------------------------------------------------- module state

_default: Optional[LockRegistry] = None
_default_guard = threading.Lock()


def get_lock_registry() -> LockRegistry:
    global _default
    with _default_guard:
        if _default is None:
            _default = LockRegistry()
        return _default


def set_lock_registry(registry: Optional[LockRegistry]):
    """Install (or clear) the process default; returns the previous one —
    tests swap in a fresh registry so graphs/stats don't leak across."""
    global _default
    with _default_guard:
        prev = _default
        _default = registry
        return prev


def lock(name: str, registry: Optional[LockRegistry] = None):
    """A named lock: plain ``threading.Lock`` in mode off, instrumented
    otherwise. The name is the aggregation key — use a stable call-site
    role (``"serve.queue"``), not per-object identities."""
    reg = registry if registry is not None else get_lock_registry()
    if reg.mode == "off":
        return threading.Lock()
    return TracedLock(name, threading.Lock(), reg)


def rlock(name: str, registry: Optional[LockRegistry] = None):
    """``lock()`` for re-entrant use (same-thread re-acquire is not a
    contention and not an order edge)."""
    reg = registry if registry is not None else get_lock_registry()
    if reg.mode == "off":
        return threading.RLock()
    return TracedLock(name, threading.RLock(), reg)
