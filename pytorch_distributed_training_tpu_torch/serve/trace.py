"""Seeded open-loop traffic traces (counterpart: the JAX package's
``serve/trace.py``; the same ``TraceConfig`` and seed give the same events
bit for bit).

A closed-loop client waits for its answer before sending the next request,
so the offered load self-throttles the moment the pool slows down and
overload never accumulates. This module generates an OPEN-LOOP arrival
trace instead — requests fire at their scheduled offsets whether or not
earlier ones finished — so a burst genuinely queues and backpressure,
brownout and the autoscaler are exercised.

Shape of the traffic (all replayable from one integer seed):

- **Poisson base load**: exponential inter-arrival times at
  ``base_rate_rps``.
- **Burst episodes**: inside each ``(start_s, duration_s)`` window in
  ``bursts`` the arrival rate switches to ``burst_rate_rps``.
- **Heavy-tailed sizes**: prompt lengths and output budgets are drawn from
  clamped log-normal distributions (most requests small, a fat tail of
  big ones).
- **SLO tiers**: each request is ``interactive`` (shed LAST) or ``batch``
  (shed FIRST) with distinct deadlines, drawn with
  ``interactive_fraction``.

``generate_trace`` is pure (same config -> identical event list);
``replay`` is the open-loop driver: it sleeps to each event's offset and
hands it to a ``fire`` callback which must NOT block (spawn a client
thread per event). Pure Python, host only: the trace is the workload, not
the work.
"""

from __future__ import annotations

import dataclasses
import math
import random
import time
from typing import Callable, Optional

#: the two service tiers the queue schedules as lanes (serve/queue.py) and
#: the brownout ladder degrades in order (batch first, interactive last)
TIERS = ("interactive", "batch")


@dataclasses.dataclass(frozen=True)
class TraceConfig:
    """One replayable workload. ``seed`` fixes everything: arrivals, tier
    draws, prompt/output sizes and per-request sampling seeds."""

    seed: int = 0
    duration_s: float = 10.0
    base_rate_rps: float = 4.0
    burst_rate_rps: float = 24.0
    #: burst episodes as (start_s, duration_s) windows within the trace
    bursts: tuple = ((3.0, 2.0),)
    interactive_fraction: float = 0.7
    #: log-normal prompt lengths: ln-space mean/sigma, clamped to bounds
    prompt_len_median: float = 12.0
    prompt_len_sigma: float = 0.6
    prompt_len_min: int = 2
    prompt_len_max: int = 64
    #: log-normal output budgets, clamped to bounds
    output_tokens_median: float = 12.0
    output_tokens_sigma: float = 0.8
    output_tokens_min: int = 2
    output_tokens_max: int = 64
    interactive_deadline_s: float = 30.0
    batch_deadline_s: float = 120.0
    #: multi-tenant shared-system-prompt mix: 0 keeps
    #: the legacy single-tenant trace BIT-IDENTICAL (no extra rng draws).
    #: With N tenants, each event is assigned a tenant uniformly and its
    #: prompt becomes [tenant's shared prefix of ``shared_prefix_len``
    #: tokens] + [log-normal private tail] — the workload where serving
    #: the prefix once is the dominant win.
    tenants: int = 0
    shared_prefix_len: int = 0

    def __post_init__(self):
        if self.duration_s <= 0:
            raise ValueError(f"duration_s must be > 0, got {self.duration_s}")
        if self.base_rate_rps <= 0 or self.burst_rate_rps <= 0:
            raise ValueError("arrival rates must be > 0")
        if not 0.0 <= self.interactive_fraction <= 1.0:
            raise ValueError(
                f"interactive_fraction must be in [0, 1], got "
                f"{self.interactive_fraction}"
            )
        for start, dur in self.bursts:
            if start < 0 or dur <= 0:
                raise ValueError(
                    f"burst episodes need start >= 0 and duration > 0, "
                    f"got ({start}, {dur})"
                )
        if self.tenants < 0:
            raise ValueError(f"tenants must be >= 0, got {self.tenants}")
        if self.shared_prefix_len < 0:
            raise ValueError(
                f"shared_prefix_len must be >= 0, got "
                f"{self.shared_prefix_len}"
            )
        if self.tenants > 0 and self.shared_prefix_len == 0:
            raise ValueError(
                "tenants > 0 needs shared_prefix_len > 0 (a tenant mix "
                "without shared prefixes is just the plain trace)"
            )


@dataclasses.dataclass(frozen=True)
class TraceEvent:
    """One scheduled arrival: fire at ``t_s`` seconds after replay start."""

    index: int
    t_s: float
    tier: str
    prompt_len: int
    max_new_tokens: int
    deadline_s: float
    seed: int
    #: True when the arrival fell inside a burst episode (labels the storm
    #: window in telemetry without re-deriving it from timestamps)
    burst: bool
    #: multi-tenant mix (cfg.tenants > 0): which tenant sent this request,
    #: and how many leading prompt tokens are that tenant's SHARED system
    #: prefix (prompt_len includes them). None/0 on single-tenant traces.
    tenant: Optional[str] = None
    prefix_len: int = 0


def _in_burst(cfg: TraceConfig, t: float) -> bool:
    return any(start <= t < start + dur for start, dur in cfg.bursts)


def _clamped_lognormal(rng: random.Random, median: float, sigma: float,
                       lo: int, hi: int) -> int:
    # median parameterization: ln-space mean = ln(median), so the knob
    # reads in tokens instead of nats
    value = math.exp(rng.gauss(math.log(median), sigma))
    return max(lo, min(hi, int(round(value))))


def generate_trace(cfg: TraceConfig) -> list:
    """The full arrival schedule for one replay, sorted by ``t_s``.

    Arrivals are a piecewise-constant-rate Poisson process: exponential
    inter-arrival gaps at the rate of the CURRENT position (base or burst).
    Drawing the gap at the pre-gap position slightly smears episode edges;
    that's fine — bursts are scenarios, not calibrated stochastics — and it
    keeps generation single-pass and obviously deterministic."""
    rng = random.Random(cfg.seed)
    events = []
    t = 0.0
    index = 0
    while True:
        rate = (
            cfg.burst_rate_rps if _in_burst(cfg, t) else cfg.base_rate_rps
        )
        t += rng.expovariate(rate)
        if t >= cfg.duration_s:
            break
        tier = (
            "interactive"
            if rng.random() < cfg.interactive_fraction
            else "batch"
        )
        prompt_len = _clamped_lognormal(
            rng, cfg.prompt_len_median, cfg.prompt_len_sigma,
            cfg.prompt_len_min, cfg.prompt_len_max,
        )
        max_new_tokens = _clamped_lognormal(
            rng, cfg.output_tokens_median, cfg.output_tokens_sigma,
            cfg.output_tokens_min, cfg.output_tokens_max,
        )
        seed = rng.randrange(2**31)
        # tenant draws come AFTER every legacy draw and only when the mix
        # is on: a tenants=0 trace consumes the identical rng stream as
        # before this field existed (determinism pin extended, not moved)
        tenant = None
        prefix_len = 0
        if cfg.tenants > 0:
            tenant = f"tenant{rng.randrange(cfg.tenants)}"
            prefix_len = cfg.shared_prefix_len
            # the log-normal draw becomes the PRIVATE tail; the shared
            # system prefix rides in front (total still bounded, with at
            # least one private token so streams can diverge)
            prompt_len = min(
                prefix_len + prompt_len,
                max(cfg.prompt_len_max, prefix_len + 1),
            )
        events.append(TraceEvent(
            index=index,
            t_s=t,
            tier=tier,
            prompt_len=prompt_len,
            max_new_tokens=max_new_tokens,
            deadline_s=(
                cfg.interactive_deadline_s
                if tier == "interactive"
                else cfg.batch_deadline_s
            ),
            seed=seed,
            burst=_in_burst(cfg, t),
            tenant=tenant,
            prefix_len=prefix_len,
        ))
        index += 1
    return events


def trace_stats(events: list) -> dict:
    """Small summary of a generated trace (its provenance record)."""
    by_tier = {tier: 0 for tier in TIERS}
    for ev in events:
        by_tier[ev.tier] += 1
    by_tenant: dict = {}
    for ev in events:
        if ev.tenant is not None:
            by_tenant[ev.tenant] = by_tenant.get(ev.tenant, 0) + 1
    return {
        "events": len(events),
        "by_tier": by_tier,
        "burst_events": sum(1 for ev in events if ev.burst),
        "span_s": events[-1].t_s if events else 0.0,
        "prompt_len_max": max((ev.prompt_len for ev in events), default=0),
        "output_tokens_max": max(
            (ev.max_new_tokens for ev in events), default=0
        ),
        "by_tenant": by_tenant,
    }


def replay(
    events: list,
    fire: Callable,
    *,
    now_fn: Callable = time.monotonic,
    sleep_fn: Callable = time.sleep,
    stop: Optional[Callable] = None,
) -> dict:
    """Open-loop replay: call ``fire(event)`` at each event's scheduled
    offset, never waiting for completions. ``fire`` must return quickly
    (spawn a thread / enqueue); blocking in it turns the replay closed-loop
    and defeats the whole point.

    Falling behind schedule (a slow ``fire``, a descheduled replayer) is
    not hidden: late events still fire immediately, and the returned dict
    reports ``max_lag_s`` so a load driver can assert its own integrity.
    ``now_fn``/``sleep_fn`` are injectable for deterministic tests; an
    optional ``stop()`` predicate aborts the replay early."""
    t0 = now_fn()
    max_lag = 0.0
    fired = 0
    for ev in events:
        if stop is not None and stop():
            break
        while True:
            lag = (now_fn() - t0) - ev.t_s
            if lag >= 0.0:
                break
            sleep_fn(min(-lag, 0.05))
        max_lag = max(max_lag, lag)
        fire(ev)
        fired += 1
    return {"fired": fired, "max_lag_s": max_lag}
