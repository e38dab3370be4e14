"""Admission queue for the serving engine (counterpart: the JAX package's
``serve/queue.py``): backpressure, deadlines, prompt-length buckets, tier
lanes and tenants.

- **Backpressure**: ``submit`` raises ``BackpressureError`` the moment the
  queue holds ``max_depth`` requests: rejected in O(1), never hung.
- **Deadlines**: ``deadline_s`` (relative to submit); ``expire_overdue``
  sweeps queued requests past it, and the engine applies the same check
  to running slots between ticks.
- **FIFO within bucket**: requests are grouped by prompt-length bucket;
  across buckets the earliest-submitted head goes first.
- **SLO tier lanes**: every request carries a tier (``interactive`` |
  ``batch``) and each tier is its own lane of buckets. ``pop_ready``
  picks a lane by deterministic weighted round-robin (default 4:1 for
  interactive), falling through to the other lane when the scheduled one
  is empty: a weighted share under contention, every pop to the busy lane
  when the other is idle.
- **No bypass, per (lane, tenant)**: ``pop_ready``'s ``accept`` predicate
  (the engine's page budget and tenant quota) rejects a tenant's earliest
  request in a lane, and no later request of that tenant in that lane is
  tried; other tenants' heads, and the other lane, still get their turn.
  Traffic without tenants is one candidate a lane, the lane's head.

``BrownoutController`` also lives here: the fixed, reversible overload
ladder (shed batch -> clamp output budgets -> fail-fast interactive) that
the engine's tick drives from queue pressure and the HTTP front end
enforces at admission. ``emit_expiry`` records a deadline expiry by where
the request died (queued or running).
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Callable, Optional

import numpy as np

from pytorch_distributed_training_tpu_torch.analysis import concurrency


class BackpressureError(RuntimeError):
    """The queue is at ``max_depth``: resubmit later."""


#: the service tiers the queue schedules as lanes
TIERS = ("interactive", "batch")

#: the default weighted-round-robin share a lane: under contention 4
#: interactive requests pop for every batch request
DEFAULT_TIER_WEIGHTS = {"interactive": 4, "batch": 1}


def emit_expiry(registry, request: "GenRequest", phase: str) -> None:
    """Record one deadline expiry by where the request died: ``queued``
    (admission never came: overload) or ``running`` (decode fell behind:
    a slow replica). Counters ``serve/expired`` and
    ``serve/expired_<phase>`` and a ``serve_expired`` record."""
    assert phase in ("queued", "running"), phase
    registry.inc("serve/expired")
    registry.inc(f"serve/expired_{phase}")
    registry.emit({
        "record": "serve_expired",
        "id": request.id,
        "phase": phase,
        "bucket": request.bucket,
        "deadline_s": request.deadline_s,
        "waited_s": time.monotonic() - request.submit_t,
        "new_tokens": len(request.tokens),
    })


@dataclasses.dataclass
class GenRequest:
    """One generation request plus its runtime bookkeeping.

    The submitting thread owns construction; after ``submit`` the engine
    thread owns all mutable state until ``done.set()``. Timing fields are
    ``time.monotonic()`` stamps.
    """

    id: str
    prompt_ids: np.ndarray                  # [prompt_len] int32
    max_new_tokens: int
    temperature: float = 0.0                # 0 = greedy
    top_k: int = 0
    tier: str = "interactive"               # SLO lane: interactive | batch
    # the tenant (None: single-tenant traffic): scopes the page quota and
    # the queue's per-tenant no-bypass rule
    tenant: Optional[str] = None
    eot_id: Optional[int] = None
    seed: int = 0                           # per-request sampling stream
    deadline_s: Optional[float] = None      # relative to submit
    stream: Optional[Callable] = None       # stream(req, token_id) per token
    on_finish: Optional[Callable] = None    # on_finish(req) at terminal state
    # speculative decoding opt-in/out; None defers to the engine default
    # (on whenever EngineConfig.spec_k > 0). Spec and non-spec slots emit
    # the same stream, so this is a latency knob, not a quality one.
    spec: Optional[bool] = None
    # the router's parent span id (X-Parent-Span): the replica's ``serve``
    # span nests under it
    trace_parent: Optional[str] = None
    # brownout clamp provenance: max_new_tokens before the overload clamp
    # rewrote it (None: never clamped)
    clamped_from: Optional[int] = None

    # ---- engine-owned runtime state
    status: str = "new"      # new -> queued -> running -> done|expired|cancelled|error
    finish_reason: Optional[str] = None     # length | eot | deadline | cancelled
    tokens: list = dataclasses.field(default_factory=list)
    bucket: int = 0
    submit_t: float = 0.0
    admit_t: Optional[float] = None
    # the KV-page reservation stamp: the ``admission`` span is admit_t ->
    # reserve_t
    reserve_t: Optional[float] = None
    first_token_t: Optional[float] = None
    finish_t: Optional[float] = None
    decode_ticks: int = 0    # decode or verify dispatches that advanced it
    chunks: int = 0          # chunked-prefill dispatches consumed
    prefix_hit: bool = False  # admission mapped shared prefix pages
    cached_tokens: int = 0   # prompt tokens served from the prefix cache
    drafted: int = 0         # speculative tokens drafted for it
    accepted: int = 0        # speculative tokens accepted for it
    done: threading.Event = dataclasses.field(default_factory=threading.Event)

    @property
    def prompt_len(self) -> int:
        return int(self.prompt_ids.shape[0])

    def overdue(self, now: float) -> bool:
        return (
            self.deadline_s is not None
            and now - self.submit_t > self.deadline_s
        )

    def result(self, timeout: Optional[float] = None) -> list:
        """Block until the request is terminal; its generated token ids
        (cut short on a deadline or a cancel)."""
        if not self.done.wait(timeout):
            raise TimeoutError(f"request {self.id} still in flight")
        return list(self.tokens)


class RequestQueue:
    """Bounded, bucketed, deadline-aware FIFO feeding the decode engine,
    one lane of buckets a tier."""

    def __init__(self, *, max_depth: int, prompt_buckets: tuple,
                 max_new_tokens: int, tier_weights: Optional[dict] = None):
        if max_depth < 1:
            raise ValueError(f"max_depth must be >= 1, got {max_depth}")
        if not prompt_buckets or list(prompt_buckets) != sorted(
            set(int(b) for b in prompt_buckets)
        ):
            raise ValueError(
                f"prompt_buckets must be sorted unique positive lengths, "
                f"got {prompt_buckets!r}"
            )
        weights = dict(tier_weights or DEFAULT_TIER_WEIGHTS)
        if set(weights) != set(TIERS) or any(
                int(w) < 1 for w in weights.values()):
            raise ValueError(
                f"tier_weights needs a positive weight per tier {TIERS}, "
                f"got {weights!r}"
            )
        self.max_depth = max_depth
        self.prompt_buckets = tuple(int(b) for b in prompt_buckets)
        self.max_new_tokens = max_new_tokens
        self.tier_weights = {t: int(weights[t]) for t in TIERS}
        self._lanes: dict[str, dict[int, deque]] = {
            tier: {b: deque() for b in self.prompt_buckets} for tier in TIERS
        }
        # the round-robin schedule is the weights expanded (I,I,I,I,B at
        # 4:1); the cursor moves one slot a successful pop
        self._schedule = tuple(tier for tier in TIERS
                               for _ in range(self.tier_weights[tier]))
        self._cursor = 0
        self._lock = concurrency.lock("serve.queue")
        self._work = threading.Condition(self._lock)
        self._closed = False

    def bucket_for(self, prompt_len: int) -> int:
        """Smallest configured bucket that fits ``prompt_len``."""
        for b in self.prompt_buckets:
            if prompt_len <= b:
                return b
        raise ValueError(
            f"prompt length {prompt_len} exceeds the largest bucket "
            f"{self.prompt_buckets[-1]}"
        )

    def submit(self, request: GenRequest) -> GenRequest:
        """Admit ``request`` or raise (``BackpressureError`` when full;
        ``ValueError`` for requests the engine could never serve)."""
        if request.prompt_len < 1:
            raise ValueError("empty prompt")
        if not 1 <= request.max_new_tokens <= self.max_new_tokens:
            raise ValueError(
                f"max_new_tokens {request.max_new_tokens} outside "
                f"[1, {self.max_new_tokens}]"
            )
        if request.top_k < 0:
            raise ValueError(f"top_k must be >= 0, got {request.top_k}")
        if not np.isfinite(request.temperature):
            raise ValueError(
                f"temperature must be finite, got {request.temperature}"
            )
        if request.tier not in TIERS:
            raise ValueError(
                f"tier must be one of {TIERS}, got {request.tier!r}")
        if request.tenant is not None and (
                not isinstance(request.tenant, str) or not request.tenant):
            raise ValueError(
                f"tenant must be None or a non-empty string, got "
                f"{request.tenant!r}"
            )
        bucket = self.bucket_for(request.prompt_len)
        with self._lock:
            if self._closed:
                raise RuntimeError("queue is closed to new requests")
            if self.depth() >= self.max_depth:
                raise BackpressureError(
                    f"queue at max depth {self.max_depth}; retry later"
                )
            request.bucket = bucket
            request.status = "queued"
            request.submit_t = time.monotonic()
            self._lanes[request.tier][bucket].append(request)
            self._work.notify_all()
        return request

    def _queues(self):
        return (dq for lane in self._lanes.values() for dq in lane.values())

    def depth(self) -> int:
        """Queued-request count (deque lengths are atomic reads)."""
        return sum(len(dq) for dq in self._queues())

    def depth_by_tier(self) -> dict:
        """Queued-request count a lane."""
        return {tier: sum(len(dq) for dq in lane.values())
                for tier, lane in self._lanes.items()}

    def expire_overdue(self, now: Optional[float] = None) -> list:
        """Remove and return every queued request past its deadline."""
        now = time.monotonic() if now is None else now
        expired = []
        with self._lock:
            for dq in self._queues():
                keep = deque()
                while dq:
                    req = dq.popleft()
                    (expired if req.overdue(now) else keep).append(req)
                dq.extend(keep)
        return expired

    def _lane_candidates(self, tier: str) -> list:
        """``[(request, deque)]``, earliest first: each tenant's earliest
        queued request in the lane (the first of that tenant in each
        bucket, the earliest across buckets). Traffic without tenants is
        one candidate, the lane's head."""
        best: dict = {}
        for dq in self._lanes[tier].values():
            seen = set()
            for req in dq:
                if req.tenant in seen:
                    continue  # FIFO within (bucket, tenant)
                seen.add(req.tenant)
                cur = best.get(req.tenant)
                if cur is None or req.submit_t < cur[0].submit_t:
                    best[req.tenant] = (req, dq)
        return sorted(best.values(), key=lambda rd: rd[0].submit_t)

    def pop_ready(self, accept=None, defer=None) -> Optional[GenRequest]:
        """A lane by weighted round-robin, then the earliest of its
        tenants' candidates that ``accept`` takes; None when idle, when
        ``defer`` holds the lane's first candidate, or when ``accept``
        takes none.

        The schedule advances only on a pop, so the share holds under
        contention, and an empty lane takes no turn. ``defer`` is a
        transient hold checked before ``accept``: True leaves everything in
        place with no side effect (the engine holds admissions while
        ``prefill_concurrency`` prompts stream in; the hold is not page
        exhaustion). ``accept`` is the engine's admission predicate (the
        page budget, the tenant quota); a rejected candidate blocks its
        own tenant in its lane, not the others (see the module
        docstring)."""
        with self._lock:
            tried = set()
            for offset in range(len(self._schedule)):
                tier = self._schedule[
                    (self._cursor + offset) % len(self._schedule)]
                if tier in tried:
                    continue
                tried.add(tier)
                candidates = self._lane_candidates(tier)
                if not candidates:
                    continue
                if defer is not None and defer(candidates[0][0]):
                    return None
                for req, dq in candidates:
                    if accept is not None and not accept(req):
                        continue  # this tenant's head is held; the next
                    self._cursor = (self._cursor + offset + 1) % len(
                        self._schedule)
                    if dq[0] is req:
                        dq.popleft()
                    else:  # past held heads of other tenants only
                        dq.remove(req)
                    return req
            return None

    def wait_for_work(self, timeout: float) -> bool:
        """Engine-side idle wait; True when work may be available."""
        with self._lock:
            if self.depth() or self._closed:
                return True
            return self._work.wait(timeout)

    def close(self) -> None:
        """Refuse new submissions (queued requests stay drainable)."""
        with self._lock:
            self._closed = True
            self._work.notify_all()

    @property
    def closed(self) -> bool:
        return self._closed

    def drain_pending(self) -> list:
        """Remove and return every queued request."""
        with self._lock:
            out = []
            for dq in self._queues():
                out.extend(dq)
                dq.clear()
        return out


# ------------------------------------------------------------------ brownout


#: the fixed degradation ladder, in escalation order. Every transition is
#: one step at a time and reversible — recovery retraces the ladder down.
BROWNOUT_LEVELS = ("normal", "shed_batch", "clamp", "fail_fast")


class BrownoutController:
    """Reversible overload ladder driven by sustained queue pressure.

    The engine's tick loop feeds ``observe(pressure)`` (pressure = queue
    depth / max depth); the controller escalates one level at a time after
    the pressure holds above ``high_watermark`` for ``escalate_hold_s``,
    and de-escalates one level at a time after it holds below
    ``low_watermark`` for ``deescalate_hold_s`` — hysteresis plus hold
    times, so a flapping gauge cannot flap the policy. The HTTP front-end
    enforces the current level at admission:

    - level >= 1 (``shed_batch``): new batch-tier requests are rejected
      (429 + honest Retry-After). Interactive traffic is untouched.
    - level >= 2 (``clamp``): newly admitted requests have their output
      budget clamped to ``clamp_max_new`` — shorter answers for everyone
      beats no answers for some. Already-running requests keep their
      budget (the clamp is admission-time, hence trivially reversible).
    - level >= 3 (``fail_fast``): even interactive requests are rejected
      (503 + honest Retry-After) — the queue can no longer meet the
      interactive deadline, so an explicit fast "come back later" is the
      only honest answer left. Never a silent stall.

    ``now_fn`` is injectable; tests drive the ladder with a fake clock.
    Mutations happen on the engine thread under a lock; the policy
    queries read ``level`` once (an atomic int read) from any thread.
    """

    def __init__(
        self,
        *,
        high_watermark: float = 0.8,
        low_watermark: float = 0.3,
        escalate_hold_s: float = 0.5,
        deescalate_hold_s: float = 1.0,
        clamp_max_new: int = 16,
        now_fn=None,
        registry=None,
        slo_monitor=None,
        slo_burn_high: float = 0.0,
    ):
        if not 0.0 < low_watermark < high_watermark:
            raise ValueError(
                f"need 0 < low_watermark < high_watermark, got "
                f"{low_watermark} / {high_watermark}"
            )
        if clamp_max_new < 1:
            raise ValueError(
                f"clamp_max_new must be >= 1, got {clamp_max_new}"
            )
        self.high_watermark = high_watermark
        self.low_watermark = low_watermark
        self.escalate_hold_s = escalate_hold_s
        self.deescalate_hold_s = deescalate_hold_s
        self.clamp_max_new = clamp_max_new
        self._now = now_fn if now_fn is not None else time.monotonic
        self._registry = registry
        # optional SLO burn coupling: with a BurnRateMonitor attached and
        # slo_burn_high > 0, a burn rate at or above it reads as
        # high-watermark pressure whatever the queue depth (off by
        # default)
        self.slo_monitor = slo_monitor
        self.slo_burn_high = float(slo_burn_high)
        self.level = 0
        self.escalations = 0
        self.deescalations = 0
        self._above_t: Optional[float] = None
        self._below_t: Optional[float] = None
        self._lock = concurrency.lock("serve.brownout")

    # ------------------------------------------------------------- observe

    def observe(self, pressure: float) -> int:
        """One pressure sample (engine thread, once per tick); returns the
        current level. Crossing back into the hysteresis band resets both
        hold timers — only SUSTAINED pressure moves the ladder."""
        now = self._now()
        if (
            self.slo_monitor is not None
            and self.slo_burn_high > 0.0
            and self.slo_monitor.max_burn() >= self.slo_burn_high
        ):
            pressure = max(pressure, self.high_watermark)
        with self._lock:
            if pressure >= self.high_watermark:
                self._below_t = None
                if self._above_t is None:
                    self._above_t = now
                if (
                    self.level < len(BROWNOUT_LEVELS) - 1
                    and now - self._above_t >= self.escalate_hold_s
                ):
                    self._transition(self.level + 1, pressure)
                    self._above_t = now     # next level needs its own hold
            elif pressure <= self.low_watermark:
                self._above_t = None
                if self._below_t is None:
                    self._below_t = now
                if (
                    self.level > 0
                    and now - self._below_t >= self.deescalate_hold_s
                ):
                    self._transition(self.level - 1, pressure)
                    self._below_t = now
            else:
                self._above_t = None
                self._below_t = None
            return self.level

    def _transition(self, new_level: int, pressure: float) -> None:
        old = self.level
        self.level = new_level
        if new_level > old:
            self.escalations += 1
        else:
            self.deescalations += 1
        if self._registry is not None:
            self._registry.inc(
                "serve/brownout_escalations"
                if new_level > old
                else "serve/brownout_deescalations"
            )
            self._registry.gauge("serve/brownout_level", new_level)
            self._registry.emit({
                "record": "brownout_transition",
                "from": BROWNOUT_LEVELS[old],
                "to": BROWNOUT_LEVELS[new_level],
                "level": new_level,
                "pressure": pressure,
            })

    # ------------------------------------------------------ policy queries

    def level_name(self) -> str:
        return BROWNOUT_LEVELS[self.level]

    def sheds(self, tier: str) -> bool:
        """Is a NEW request of ``tier`` rejected at the current level?
        Batch sheds from level 1; interactive only at the final level —
        the ordering the acceptance tests pin."""
        level = self.level
        if tier == "batch":
            return level >= 1
        return level >= 3

    def clamp(self, max_new_tokens: int) -> int:
        """The admitted output budget at the current level (identity below
        the clamp level)."""
        if self.level >= 2:
            return min(max_new_tokens, self.clamp_max_new)
        return max_new_tokens

    def stats(self) -> dict:
        return {
            "level": self.level,
            "level_name": self.level_name(),
            "escalations": self.escalations,
            "deescalations": self.deescalations,
        }
