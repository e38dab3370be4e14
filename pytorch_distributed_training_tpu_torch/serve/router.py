"""Health-checked request router over a pool of serving replicas.

One replica (serve/server.py) is one failure domain: a crash, a wedged
device or a preemption takes out every request on it. The router is the
piece that turns N such replicas into one service where a dead replica
degrades CAPACITY instead of AVAILABILITY:

- **Health**: a poll thread GETs every replica's ``/healthz`` on an
  interval. ``ready`` feeds the load view (queue depth + slot occupancy —
  the gauges the engine already exports); ``draining`` pulls the replica
  out of rotation immediately (a SIGTERM'd replica advertises draining
  BEFORE it dies, so the router stops sending first); anything else —
  ``unhealthy``, a timeout, a refused connection — is a breaker failure.
- **Circuit breaker** (per replica): ``consecutive-failure threshold``
  consecutive failures open the circuit; after a cooldown the breaker goes
  half-open and admits exactly ONE probe (the next health poll); a probe
  success closes it, a probe failure re-opens it. Open/half-open replicas
  take no traffic, so a flapping replica can't eat a retry budget.
- **Load balancing**: among closed+ready replicas, least-loaded first
  (queue depth plus occupied slots from the latest health sample),
  round-robin on ties — telemetry-driven, not blind round-robin.
- **Retries**: a request that fails BEFORE its first streamed byte is
  idempotent from the client's point of view; the router retries it on a
  different replica (bounded attempts, decorrelated-jitter backoff — the
  same policy as utils/supervisor.py restarts). Once a byte has streamed,
  a replica failure surfaces as an explicit terminal ``error`` event with
  ``"retryable": true`` — never a silent hang, never a duplicated stream.
- **Hedging** (optional): if the chosen replica produces no first byte
  within ``hedge_s``, the router launches the same request on a second
  replica and streams whichever answers first, abandoning the loser — the
  classic tail-latency-at-scale move. Off by default: it duplicates work.
- **Fail-fast**: when every replica is open-circuit, draining or down,
  ``POST /generate`` answers 503 with ``Retry-After`` derived from the
  earliest breaker reopen — the client learns WHEN to come back instead
  of hanging into a dead pool.

The router speaks the same JSONL-over-HTTP protocol as the replicas, so a
client cannot tell one replica from a routed fleet — except that the fleet
keeps answering. Telemetry: ``router_request`` per request (replica,
attempts, hedged, ttfb, status), ``router_breaker`` per transition,
``router_failover`` per failover, plus counters; the fleet section of
``scripts/summarize_metrics.py`` folds them. Counterpart: the JAX
package's ``serve/router.py``, with the same policy, records and keys. The
router is pure host code and imports no torch: it runs in a process that
never touches the card.
"""

from __future__ import annotations

import dataclasses
import http.client
import json
import random
import threading
import time
import uuid
from typing import Optional

from pytorch_distributed_training_tpu_torch.analysis import concurrency
from pytorch_distributed_training_tpu_torch.telemetry.registry import (
    get_registry,
)
from pytorch_distributed_training_tpu_torch.telemetry.spans import Tracer
from pytorch_distributed_training_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

_UNSET = object()   # distinguishes "never sampled" from a None weights_step


@dataclasses.dataclass
class RouterConfig:
    """Routing policy knobs (timeouts in seconds)."""

    health_interval_s: float = 0.25     # /healthz poll period
    health_timeout_s: float = 1.0       # per-poll HTTP timeout
    breaker_threshold: int = 3          # consecutive failures -> open
    breaker_cooldown_s: float = 1.0     # open -> half-open delay
    connect_timeout_s: float = 2.0      # per-attempt connect budget
    ttfb_timeout_s: float = 30.0        # attempt start -> first event line
    max_retries: int = 2                # extra attempts on OTHER replicas
    retry_backoff_s: float = 0.05       # decorrelated-jitter base
    retry_backoff_max_s: float = 0.5
    hedge_s: float = 0.0                # 0 = hedging off

    def __post_init__(self):
        if self.breaker_threshold < 1:
            raise ValueError(
                f"breaker_threshold must be >= 1, got {self.breaker_threshold}"
            )
        if self.max_retries < 0:
            raise ValueError(
                f"max_retries must be >= 0, got {self.max_retries}"
            )


class CircuitBreaker:
    """Per-replica consecutive-failure breaker with half-open probes.

    Thread-safe; time is injectable (``now_fn``) so the state machine is
    unit-testable without sleeps. ``on_transition(old, new)`` fires outside
    the lock for telemetry.
    """

    CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"

    def __init__(
        self,
        *,
        threshold: int = 3,
        cooldown_s: float = 1.0,
        now_fn=time.monotonic,
        on_transition=None,
        name: str = "",
    ):
        self.threshold = threshold
        self.cooldown_s = cooldown_s
        self._now = now_fn
        self._on_transition = on_transition
        self._lock = concurrency.lock(
            f"serve.router.breaker.{name}" if name else "serve.router.breaker"
        )
        self.state = self.CLOSED
        self.failures = 0
        self.opened_t: Optional[float] = None
        self.transitions = 0

    def _set(self, new: str) -> None:
        old, self.state = self.state, new
        if old != new:
            self.transitions += 1
            if self._on_transition is not None:
                self._on_transition(old, new)

    def allow_probe(self) -> bool:
        """True when traffic (or a health poll) may hit the replica now.
        An OPEN breaker past its cooldown transitions to HALF_OPEN and
        admits this one call as the probe."""
        with self._lock:
            if self.state == self.CLOSED:
                return True
            if self.state == self.OPEN:
                if self._now() - self.opened_t >= self.cooldown_s:
                    self._set(self.HALF_OPEN)
                    return True
                return False
            return True     # HALF_OPEN: the poll loop is the single prober

    def record_success(self) -> None:
        with self._lock:
            self.failures = 0
            self._set(self.CLOSED)

    def record_failure(self) -> None:
        with self._lock:
            self.failures += 1
            if self.state == self.HALF_OPEN or (
                self.state == self.CLOSED and self.failures >= self.threshold
            ):
                self.opened_t = self._now()
                self._set(self.OPEN)

    def reopen_in(self) -> Optional[float]:
        """Seconds until the breaker would half-open (None unless OPEN)."""
        with self._lock:
            if self.state != self.OPEN:
                return None
            return max(
                0.0, self.cooldown_s - (self._now() - self.opened_t)
            )


class Replica:
    """The router's view of one replica endpoint."""

    def __init__(self, name: str, host: str, port: int, *,
                 breaker: CircuitBreaker):
        self.name = name
        self.host = host
        self.port = port
        self.breaker = breaker
        self.draining = False
        self.health: dict = {}
        self.last_ready_t: Optional[float] = None
        self.requests = 0
        self.errors = 0

    @property
    def weights_step(self):
        """The checkpoint step this replica last reported serving (None
        until a health sample carried one)."""
        return self.health.get("weights_step")

    #: load penalty while a replica reports a weight swap in flight: the
    #: checkpoint restore competes with its decode loop for CPU, so new
    #: traffic prefers its peers for the duration. Deliberately MODEST
    #: (worth ~2 queued requests): a hard steer would dogpile the
    #: remaining replicas past their slot capacity, trading a slightly
    #: slow answer for a queued one — the swapping replica still takes
    #: overflow, and a 1-replica pool serves straight through its swap
    SWAPPING_LOAD_PENALTY = 2.0

    def load(self) -> float:
        """Outstanding work from the latest health sample: queued requests
        plus occupied slots (both already exported by the engine), plus a
        large soft penalty while the replica is mid-swap."""
        h = self.health
        return (
            float(h.get("queue_depth", 0))
            + float(h.get("slot_occupancy", 0.0))
            * float(h.get("num_slots", 1))
            + (self.SWAPPING_LOAD_PENALTY if h.get("swapping") else 0.0)
        )

    def available(self) -> bool:
        # last_ready_t gates readiness: a freshly-registered replica is NOT
        # in rotation until its first successful health check (replica boot
        # includes a torch import + model init — seconds of refused
        # connections that must not count as request failures)
        return (
            self.breaker.state == CircuitBreaker.CLOSED
            and not self.draining
            and self.last_ready_t is not None
        )

    def describe(self) -> dict:
        return {
            "name": self.name,
            "port": self.port,
            "breaker": self.breaker.state,
            "draining": self.draining,
            "load": self.load(),
            "weights_step": self.weights_step,
            "requests": self.requests,
            "errors": self.errors,
            "health": self.health,
        }


class _Attempt:
    """One streaming POST to one replica, pumped on its own thread into a
    local event queue so the router can time TTFB, hedge and abandon."""

    def __init__(self, replica: Replica, body: bytes, rid: str,
                 cfg: RouterConfig,
                 parent_span_id: Optional[str] = None):
        import queue as _q

        self.replica = replica
        self.events: _q.Queue = _q.Queue()
        self.abandoned = threading.Event()
        self.status: Optional[int] = None
        self._conn = http.client.HTTPConnection(
            replica.host, replica.port, timeout=cfg.ttfb_timeout_s,
        )
        self._body = body
        self._rid = rid
        self._parent_span_id = parent_span_id
        self._thread = threading.Thread(
            target=self._pump, name=f"router-attempt-{replica.name}",
            daemon=True,
        )
        self._thread.start()

    def _pump(self) -> None:
        try:
            headers = {"X-Request-Id": self._rid,
                       "Content-Type": "application/json"}
            if self._parent_span_id:
                # trace context: the replica parents its serve span under
                # this attempt/hedge span, keeping retried and hedged
                # attempts inside ONE trace tree
                headers["X-Parent-Span"] = self._parent_span_id
            self._conn.request(
                "POST", "/generate", body=self._body, headers=headers,
            )
            resp = self._conn.getresponse()
            self.status = resp.status
            if resp.status != 200:
                body = resp.read()
                self.events.put(("reject", resp.status, body,
                                 resp.getheader("Retry-After")))
                return
            while True:
                line = resp.readline()
                if not line:
                    break
                if self.abandoned.is_set():
                    return
                self.events.put(("line", line))
            self.events.put(("eof",))
        except Exception as e:  # connect refused/reset/timeout mid-stream
            self.events.put(("error", e))
        finally:
            self.close()

    def close(self) -> None:
        self.abandoned.set()
        try:
            self._conn.close()
        except Exception:  # pragma: no cover - socket teardown
            pass


class Router:
    """Routes streaming generate requests over a replica pool.

    ``endpoints`` is a list of ``(name, host, port)``. Construction is
    cheap; ``start()`` launches the health-poll thread. The transport-level
    entry point is ``route_generate`` (used by the HTTP front-end below and
    callable directly from tests with any ``write_line`` sink).
    """

    def __init__(self, endpoints, config: Optional[RouterConfig] = None,
                 *, registry=None, slo_monitor=None,
                 _rng: Optional[random.Random] = None):
        self.config = config or RouterConfig()
        if registry is None:
            registry = get_registry()
        self._registry = registry
        # router-side spans: request (root) -> attempt -> hedge; replicas
        # parent their serve spans under the attempt via X-Parent-Span
        self.tracer = Tracer(registry=registry, component="router")
        # optional burn-rate monitor: fed availability outcomes per routed
        # request (rejections count against the tier's availability)
        self.slo_monitor = slo_monitor
        self._rng = _rng or random.Random()
        self.replicas = [
            Replica(
                name, host, port,
                breaker=CircuitBreaker(
                    threshold=self.config.breaker_threshold,
                    cooldown_s=self.config.breaker_cooldown_s,
                    on_transition=self._breaker_transition_cb(name),
                    name=name,
                ),
            )
            for name, host, port in endpoints
        ]
        if not self.replicas:
            raise ValueError("router needs at least one replica endpoint")
        # request counters and the round-robin cursor are bumped from every
        # HTTP handler thread at once; the health thread owns the weights
        # view — one stats lock keeps the increments from losing updates
        # (linter: unlocked-rmw / thread-shared-mutable)
        self._lock = concurrency.lock("serve.router.stats")
        self._rr = 0
        self._stop = threading.Event()
        self._health_thread: Optional[threading.Thread] = None
        self.routed = 0
        self.failovers = 0
        self.hedges = 0
        self.rejected = 0
        self._last_weights: dict = {}       # replica -> last seen step
        self._last_skew_sig: Optional[tuple] = None
        # optional pool-state callback (wired by ServeFleet): folded into
        # /stats and the fail-fast 503 body so "pool degraded, restart
        # budget exhausted" is diagnosable from the rejection itself
        self.pool_status_fn = None

    # ------------------------------------------------------- dynamic pool

    def _pool(self):
        """Lock-guarded snapshot of the replica list. Mutators REPLACE the
        list under the lock (copy-on-write), never mutate it in place, so
        the returned reference is a stable snapshot safe to iterate without
        holding the lock."""
        with self._lock:
            return self.replicas

    def _make_replica(self, name: str, host: str, port: int) -> Replica:
        return Replica(
            name, host, port,
            breaker=CircuitBreaker(
                threshold=self.config.breaker_threshold,
                cooldown_s=self.config.breaker_cooldown_s,
                on_transition=self._breaker_transition_cb(name),
                name=name,
            ),
        )

    def add_endpoint(self, name: str, host: str, port: int) -> Replica:
        """Register a new replica endpoint (autoscaler scale-up). The
        replica enters rotation only after its first successful health
        probe (``last_ready_t`` gate) — registering a still-booting process
        is safe. The pool list is replaced atomically, so concurrent
        readers (pick/health/stats) see either the old or the new list."""
        replica = self._make_replica(name, host, port)
        with self._lock:
            if any(r.name == name for r in self.replicas):
                raise ValueError(f"endpoint {name!r} already registered")
            self.replicas = self.replicas + [replica]
            size = len(self.replicas)
        self._registry.emit({
            "record": "router_pool",
            "action": "add",
            "replica": name,
            "port": port,
            "size": size,
        })
        return replica

    def remove_endpoint(self, name: str) -> bool:
        """Deregister a replica endpoint (autoscaler scale-down, after its
        drain completed). Refuses to empty the pool."""
        with self._lock:
            keep = [r for r in self.replicas if r.name != name]
            if len(keep) == len(self.replicas):
                return False
            if not keep:
                raise ValueError("cannot remove the last replica endpoint")
            self.replicas = keep
        self._registry.emit({
            "record": "router_pool",
            "action": "remove",
            "replica": name,
            "size": len(keep),
        })
        return True

    def update_endpoint_port(self, name: str, port: int) -> bool:
        """A replica rebound to a fresh port (bind-race retry in the spawn
        path). Readiness resets so the next health probe re-qualifies the
        new address before it takes traffic."""
        for replica in self._pool():
            if replica.name == name:
                replica.port = port
                replica.last_ready_t = None
                self._registry.emit({
                    "record": "router_pool",
                    "action": "rebind",
                    "replica": name,
                    "port": port,
                })
                return True
        return False

    # -------------------------------------------------------------- health

    def _breaker_transition_cb(self, name: str):
        def cb(old: str, new: str) -> None:
            logger.warning("replica %s breaker: %s -> %s", name, old, new)
            self._registry.inc("router/breaker_transitions")
            self._registry.emit({
                "record": "router_breaker",
                "replica": name,
                "from": old,
                "to": new,
            })

        return cb

    def start(self) -> "Router":
        if self._health_thread is not None:
            raise RuntimeError("router already started")
        self._health_thread = threading.Thread(
            target=self._health_loop, name="router-health", daemon=True
        )
        self._health_thread.start()
        return self

    def close(self) -> None:
        self._stop.set()
        thread, self._health_thread = self._health_thread, None
        if thread is not None:
            thread.join(5.0)

    def _health_loop(self) -> None:
        while not self._stop.wait(self.config.health_interval_s):
            for replica in self._pool():
                if not replica.breaker.allow_probe():
                    continue        # open circuit, cooldown not yet over
                self.check_replica(replica)

    def check_replica(self, replica: Replica) -> None:
        """One health probe; drives the breaker and the load/drain view."""
        try:
            conn = http.client.HTTPConnection(
                replica.host, replica.port,
                timeout=self.config.health_timeout_s,
            )
            try:
                conn.request("GET", "/healthz")
                resp = conn.getresponse()
                payload = json.loads(resp.read() or b"{}")
            finally:
                conn.close()
        except Exception:
            self._health_result(replica, None, {})
            return
        self._health_result(replica, resp.status, payload)

    def _health_result(self, replica: Replica, status: Optional[int],
                       payload: dict) -> None:
        state = payload.get("state")
        was_draining = replica.draining
        if status == 200 and state == "ready":
            replica.health = payload
            replica.draining = False
            replica.last_ready_t = time.monotonic()
            replica.breaker.record_success()
        elif state == "draining":
            # alive and finishing work: out of rotation, but NOT a breaker
            # failure — the breaker is for replicas that stopped answering
            replica.health = payload
            replica.draining = True
            replica.breaker.record_success()
        else:
            replica.breaker.record_failure()
        if replica.draining != was_draining:
            self._registry.emit({
                "record": "router_replica_state",
                "replica": replica.name,
                "draining": replica.draining,
            })
        self._track_weights(replica)

    def _track_weights(self, replica: Replica) -> None:
        """Version-skew telemetry: record each replica's weights-step
        change, and the pool-wide skew whenever the distinct-version set
        shifts — the rollout window IS the span where skew > 0, which the
        summarize_metrics swap section folds into a duration."""
        ws = replica.weights_step
        with self._lock:
            changed = self._last_weights.get(replica.name, _UNSET) != ws
            if changed:
                self._last_weights[replica.name] = ws
        if changed:
            self._registry.emit({
                "record": "router_weights",
                "replica": replica.name,
                "weights_step": ws,
            })
        sig = tuple(
            sorted(
                (r.name, r.weights_step) for r in self._pool()
                if r.weights_step is not None
            )
        )
        with self._lock:
            skew_changed = sig != self._last_skew_sig
            if skew_changed:
                self._last_skew_sig = sig
        if skew_changed:
            skew = self.version_skew()
            self._registry.gauge("router/version_skew", skew)
            self._registry.emit({
                "record": "router_skew",
                "weights": {
                    r.name: r.weights_step for r in self._pool()
                },
                "skew": skew,
            })

    def version_skew(self) -> int:
        """Distinct weights versions across replicas reporting one, minus
        one — 0 means the pool is converged on a single checkpoint step."""
        steps = {
            r.weights_step for r in self._pool()
            if r.weights_step is not None
        }
        return max(0, len(steps) - 1)

    # ------------------------------------------------------------- routing

    def pick(self, exclude: frozenset = frozenset()) -> Optional[Replica]:
        """Least-loaded available replica (round-robin on ties), or None."""
        candidates = [
            r for r in self._pool()
            if r.name not in exclude and r.available()
        ]
        if not candidates:
            return None
        best = min(r.load() for r in candidates)
        tied = [r for r in candidates if r.load() <= best]
        with self._lock:
            self._rr += 1
            return tied[self._rr % len(tied)]

    def retry_after_s(self) -> int:
        """Advice for a rejected client: the earliest moment the pool could
        look different — a breaker half-opening, or the next health poll."""
        waits = [r.breaker.reopen_in() for r in self._pool()]
        waits = [w for w in waits if w is not None]
        best = min(waits) if waits else self.config.health_interval_s
        return max(1, int(best + 0.999))

    def route_generate(self, body: bytes, rid: str, write_line) -> dict:
        """Stream one generate request to a replica, with failover/hedging.

        ``write_line(bytes)`` receives every event line exactly once. The
        return dict describes the outcome: ``{"status": "ok" | "rejected" |
        "error_midstream", "replica", "attempts", "hedged", "code",
        "retry_after"}`` — the HTTP front-end maps ``rejected`` onto 503/429
        before any line is written, and ``error_midstream`` onto a terminal
        retryable error event (headers are long gone by then).
        """
        t0 = time.monotonic()
        with self._lock:
            self.routed += 1
        root = self.tracer.begin(rid, "request")
        attempts = 0
        hedged = False
        streamed = False
        tried: set = set()
        outcome: dict = {}
        backoff = self.config.retry_backoff_s

        while True:
            replica = self.pick(exclude=frozenset(tried))
            if replica is None or attempts > self.config.max_retries:
                with self._lock:
                    self.rejected += 1
                self._registry.inc("router/rejected")
                outcome = {
                    "status": "rejected",
                    "code": outcome.get("code") or 503,
                    "retry_after": outcome.get("retry_after")
                    or self.retry_after_s(),
                }
                break
            attempts += 1
            tried.add(replica.name)
            with self._lock:
                replica.requests += 1
            if attempts > 1:
                with self._lock:
                    self.failovers += 1
                self._registry.inc("router/failovers")
                self._registry.emit({
                    "record": "router_failover",
                    "id": rid,
                    "to": replica.name,
                    "attempt": attempts,
                })
                # decorrelated jitter, capped: don't stampede the survivor
                backoff = min(
                    self._rng.uniform(self.config.retry_backoff_s,
                                      backoff * 3),
                    self.config.retry_backoff_max_s,
                )
                time.sleep(backoff)
            aspan = self.tracer.begin(
                rid, "attempt", parent=root.span,
                attrs={"replica": replica.name, "attempt": attempts},
            )
            result = self._stream_attempt(
                replica, body, rid, write_line, parent_span=aspan,
            )
            self.tracer.end(aspan, attrs={
                "ok": result["ok"],
                "streamed": result.get("streamed", False),
                "rejected": result.get("rejected", False),
            })
            streamed = streamed or result.get("streamed", False)
            if result["ok"]:
                outcome = {"status": "ok", "replica": replica.name}
                if result.get("hedge_replica"):
                    outcome["replica"] = result["hedge_replica"]
                hedged = hedged or result.get("hedged", False)
                break
            with self._lock:
                replica.errors += 1
            hedged = hedged or result.get("hedged", False)
            if result.get("streamed"):
                # bytes already reached the client: NOT idempotent anymore.
                # Terminal explicit error — the client retries with a new
                # request id if it wants to.
                self._registry.inc("router/midstream_errors")
                write_line((json.dumps({
                    "id": rid,
                    "event": "error",
                    "error": (
                        f"replica {replica.name} failed mid-stream"
                    ),
                    "retryable": True,
                }) + "\n").encode())
                outcome = {"status": "error_midstream",
                           "replica": replica.name}
                break
            if result.get("rejected"):
                # the replica answered (429 busy / 503 draining): alive,
                # just not taking work — try elsewhere without breaker harm
                outcome = {
                    "code": result.get("code", 503),
                    "retry_after": result.get("retry_after"),
                }
                continue
            replica.breaker.record_failure()
            self._registry.inc("router/attempt_errors")

        total_s = time.monotonic() - t0
        self.tracer.end(root, attrs={
            "status": outcome.get("status"),
            "replica": outcome.get("replica"),
            "attempts": attempts,
            "hedged": hedged,
        })
        if self.slo_monitor is not None:
            try:
                tier = json.loads(body or b"{}").get("tier", "interactive")
            except (json.JSONDecodeError, AttributeError):
                tier = "interactive"
            self.slo_monitor.observe(
                tier, available=outcome.get("status") == "ok",
            )
        served_by = next(
            (r for r in self._pool() if r.name == outcome.get("replica")),
            None,
        )
        self._registry.emit({
            "record": "router_request",
            "id": rid,
            "status": outcome.get("status"),
            "replica": outcome.get("replica"),
            # weights version of the serving replica (health-sample view):
            # every routed answer stays attributable through a rollout
            "weights_step": (
                served_by.weights_step if served_by is not None else None
            ),
            "attempts": attempts,
            "hedged": hedged,
            "total_s": total_s,
        })
        outcome.setdefault("replica", None)
        outcome["attempts"] = attempts
        outcome["hedged"] = hedged
        return outcome

    def _stream_attempt(self, replica: Replica, body: bytes, rid: str,
                        write_line, *, parent_span=None) -> dict:
        """Run one attempt (plus an optional hedge) to completion."""
        cfg = self.config
        parent_id = parent_span.span if parent_span is not None else None
        primary = _Attempt(replica, body, rid, cfg,
                           parent_span_id=parent_id)
        attempt, hedged, hedge_name = primary, False, None
        if cfg.hedge_s > 0:
            first = self._first_event(primary, cfg.hedge_s)
            if first is None:
                # slow first byte: hedge on a different replica, race them
                hedge_replica = self.pick(exclude=frozenset({replica.name}))
                if hedge_replica is not None:
                    hedged = True
                    with self._lock:
                        self.hedges += 1
                    self._registry.inc("router/hedges")
                    self._registry.emit({
                        "record": "router_hedge",
                        "id": rid,
                        "primary": replica.name,
                        "hedge": hedge_replica.name,
                    })
                    with self._lock:
                        hedge_replica.requests += 1
                    # hedge span: child of the SAME attempt, so both
                    # replicas' serve spans land in one trace tree
                    hspan = self.tracer.begin(
                        rid, "hedge", parent=parent_id,
                        attrs={"primary": replica.name,
                               "hedge": hedge_replica.name},
                    )
                    hedge = _Attempt(hedge_replica, body, rid, cfg,
                                     parent_span_id=hspan.span)
                    attempt, first = self._race(
                        primary, hedge, cfg.ttfb_timeout_s
                    )
                    if attempt is hedge:
                        hedge_name = hedge_replica.name
                    self.tracer.end(hspan, attrs={
                        "won": attempt is hedge,
                    })
                else:
                    first = self._first_event(
                        primary, max(0.0, cfg.ttfb_timeout_s - cfg.hedge_s)
                    )
        else:
            first = self._first_event(primary, cfg.ttfb_timeout_s)

        if first is None:           # no first byte inside the TTFB budget
            attempt.close()
            return {"ok": False, "streamed": False, "hedged": hedged}
        return self._drain_attempt(
            attempt, first, write_line, hedged=hedged, hedge_name=hedge_name
        )

    @staticmethod
    def _first_event(attempt: _Attempt, timeout: float):
        import queue as _q

        try:
            return attempt.events.get(timeout=max(0.0, timeout))
        except _q.Empty:
            return None

    def _race(self, primary: _Attempt, hedge: _Attempt, timeout: float):
        """First attempt to produce an event wins; the loser is abandoned."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            for attempt in (primary, hedge):
                ev = self._first_event(attempt, 0.01)
                if ev is not None:
                    loser = hedge if attempt is primary else primary
                    loser.close()
                    return attempt, ev
        primary.close()
        hedge.close()
        return primary, None

    def _drain_attempt(self, attempt: _Attempt, first, write_line, *,
                       hedged: bool, hedge_name) -> dict:
        """Forward events from ``attempt`` to the client until EOF/error.

        A crashed replica's socket often closes CLEANLY (FIN, not RST), so
        a bare EOF is indistinguishable from normal end-of-stream at the
        transport level — completeness is judged by protocol instead:
        the stream is complete only if a terminal ``done`` event line was
        forwarded. EOF without one is a mid-stream failure."""
        streamed = False
        saw_done = False
        ev = first
        while True:
            if ev is None:          # inter-event gap exceeded the budget
                attempt.close()
                return {"ok": False, "streamed": streamed, "hedged": hedged}
            kind = ev[0]
            if kind == "reject":
                _, code, _body, retry_after = ev
                return {
                    "ok": False, "streamed": streamed, "rejected": True,
                    "code": code, "hedged": hedged,
                    "retry_after": (
                        int(retry_after) if retry_after else None
                    ),
                }
            if kind == "error":
                return {"ok": False, "streamed": streamed, "hedged": hedged}
            if kind == "eof":
                return {
                    "ok": saw_done, "streamed": streamed, "hedged": hedged,
                    "hedge_replica": hedge_name,
                }
            # kind == "line"
            write_line(ev[1])
            streamed = True
            try:
                if json.loads(ev[1]).get("event") == "done":
                    saw_done = True
            except (json.JSONDecodeError, AttributeError):
                pass
            ev = self._first_event(attempt, self.config.ttfb_timeout_s)

    # --------------------------------------------------------------- stats

    def available_count(self) -> int:
        return sum(1 for r in self._pool() if r.available())

    def pool_status(self) -> Optional[dict]:
        """The fleet's pool view (None for a router without a fleet)."""
        fn = self.pool_status_fn
        return fn() if fn is not None else None

    def stats(self) -> dict:
        stats = {
            "replicas": [r.describe() for r in self._pool()],
            "available": self.available_count(),
            "routed": self.routed,
            "failovers": self.failovers,
            "hedges": self.hedges,
            "rejected": self.rejected,
            "weights": {r.name: r.weights_step for r in self._pool()},
            "version_skew": self.version_skew(),
        }
        pool = self.pool_status()
        if pool is not None:
            stats["pool"] = pool
        return stats


# ---------------------------------------------------------------- http


def make_router_http_server(router: Router, host: str = "127.0.0.1",
                            port: int = 0):
    """The fleet's public front-end: same protocol as a single replica
    (``POST /generate`` streaming JSONL, ``GET /healthz``, ``GET /stats``)
    so clients and tests can point at either interchangeably."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.0"

        def log_message(self, fmt, *args):
            logger.debug("router http: " + fmt, *args)

        def _json(self, code: int, obj: dict, headers: dict = None) -> None:
            body = (json.dumps(obj) + "\n").encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            for k, v in (headers or {}).items():
                self.send_header(k, str(v))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                n = router.available_count()
                if n > 0:
                    self._json(200, {"state": "ready", "available": n})
                else:
                    self._json(503, {"state": "unavailable", "available": 0},
                               headers={
                                   "Retry-After": router.retry_after_s(),
                               })
            elif self.path == "/stats":
                self._json(200, router.stats())
            else:
                self._json(404, {"error": f"no route {self.path}"})

        def do_POST(self):
            if self.path != "/generate":
                self._json(404, {"error": f"no route {self.path}"})
                return
            n = int(self.headers.get("Content-Length", "0"))
            body = self.rfile.read(n) or b"{}"
            rid = self.headers.get("X-Request-Id")
            if rid is None:
                try:
                    rid = json.loads(body).get("id")
                except (json.JSONDecodeError, AttributeError):
                    rid = None
            rid = rid or uuid.uuid4().hex[:12]

            headers_sent = threading.Event()

            def write_line(line: bytes) -> None:
                if not headers_sent.is_set():
                    self.send_response(200)
                    self.send_header("Content-Type", "application/jsonl")
                    self.send_header("X-Request-Id", rid)
                    self.end_headers()
                    headers_sent.set()
                self.wfile.write(line)
                self.wfile.flush()

            outcome = router.route_generate(body, rid, write_line)
            if outcome["status"] == "rejected" and not headers_sent.is_set():
                code = outcome.get("code") or 503
                reject = {
                    "error": "no replica available"
                    if code == 503 else "all replicas busy",
                    "id": rid,
                }
                # a degraded pool changes the advice: no amount of client
                # backoff revives a replica whose restart budget is gone,
                # so say it in the rejection instead of burying it in logs
                pool = router.pool_status()
                if pool is not None and pool.get("degraded"):
                    reject["pool"] = pool
                    reject["error"] += f" ({pool.get('reason')})"
                self._json(code, reject, headers={
                    "Retry-After": outcome.get("retry_after")
                    or router.retry_after_s(),
                    "X-Request-Id": rid,
                })

    httpd = ThreadingHTTPServer((host, port), Handler)
    return httpd
