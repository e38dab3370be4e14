"""Per-tier multi-window SLO burn-rate monitors (counterpart: the JAX
package's ``telemetry/slo.py``; the port keeps its own copy of the
burn-rate math).

Burn rate is the error-budget view of a tier over each window:

    burn = (1 - good_ratio) / (1 - objective)

burn 1.0 spends the budget exactly at the rate the objective allows.
Two good ratios are tracked per tier:

- **deadline-met**: of finished requests that carried a deadline, the
  fraction that completed instead of expiring (the engine's finish path);
- **availability**: the fraction of requests served at all (errors and
  brownout sheds count against it; the engine and the HTTP front end
  feed it).

``BurnRateMonitor`` emits an ``slo_burn`` record (at most one a
``emit_interval_s``) and a ``slo/max_burn`` gauge. The brownout
controller takes the monitor as an optional input (``slo_burn_high``,
off by default). The clock is an argument (``now_fn``), so tests drive
the windows without sleeping. Events sit behind the registry's
``telemetry.slo`` lock: the engine thread and HTTP threads observe at
once.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Optional

from pytorch_distributed_training_tpu_torch.analysis import concurrency
from pytorch_distributed_training_tpu_torch.telemetry.registry import (
    get_registry,
)


#: default burn windows: the fast window catches an active incident, the
#: slow one keeps a lingering simmer visible after the spike passes
DEFAULT_WINDOWS_S = (300.0, 3600.0)


@dataclasses.dataclass(frozen=True)
class SloConfig:
    """Objectives + windows + emission cadence."""

    windows_s: tuple = DEFAULT_WINDOWS_S
    #: objective on the deadline-met ratio of deadline-carrying requests
    deadline_objective: float = 0.99
    #: objective on the served-at-all ratio
    availability_objective: float = 0.999
    #: min seconds between ``slo_burn`` records (0 = every observe)
    emit_interval_s: float = 5.0

    def __post_init__(self):
        if not self.windows_s or list(self.windows_s) != sorted(
            float(w) for w in self.windows_s
        ):
            raise ValueError(
                f"windows_s must be sorted positive seconds, got "
                f"{self.windows_s!r}"
            )
        for obj in (self.deadline_objective, self.availability_objective):
            if not 0.0 < obj < 1.0:
                raise ValueError(
                    f"objectives must sit in (0, 1), got {obj}"
                )


def burn_rate(good: int, total: int, objective: float) -> float:
    """Error-budget burn for one window (0.0 when the window is empty —
    no traffic burns no budget)."""
    if total <= 0:
        return 0.0
    bad_ratio = 1.0 - good / total
    return bad_ratio / (1.0 - objective)


class BurnRateMonitor:
    """Sliding-window burn accounting per tier."""

    def __init__(self, config: Optional[SloConfig] = None, *,
                 tiers=("interactive", "batch"), registry=None,
                 now_fn=None):
        self.config = config or SloConfig()
        self.tiers = tuple(tiers)
        if registry is None:
            registry = get_registry()
        self._registry = registry
        self._now = now_fn if now_fn is not None else time.monotonic
        # events arrive from the engine thread and HTTP handler threads at
        # once
        self._lock = concurrency.lock("telemetry.slo")
        # per tier: deque of (t, deadline_met: bool|None, available: bool)
        self._events: dict[str, deque] = {t: deque() for t in self.tiers}
        self._last_emit_t: Optional[float] = None
        self.observed = 0

    # -------------------------------------------------------------- feeding

    def observe(self, tier: str, *, available: bool,
                deadline_met: Optional[bool] = None,
                now: Optional[float] = None) -> None:
        """One request outcome. ``deadline_met=None`` means the request
        carried no deadline (it never touches the deadline ratio)."""
        if tier not in self._events:
            tier = self.tiers[0]
        now = self._now() if now is None else now
        horizon = now - self.config.windows_s[-1]
        with self._lock:
            dq = self._events[tier]
            dq.append((now, deadline_met, bool(available)))
            while dq and dq[0][0] < horizon:
                dq.popleft()
            self.observed += 1
            emit = (
                self._last_emit_t is None
                or now - self._last_emit_t >= self.config.emit_interval_s
            )
            if emit:
                self._last_emit_t = now
        if emit:
            self.emit_now(now=now)

    # ------------------------------------------------------------- queries

    def burn_rates(self, now: Optional[float] = None) -> dict:
        """``{tier: {window_label: {requests, deadline_met,
        availability, deadline_burn, availability_burn}}}``."""
        cfg = self.config
        now = self._now() if now is None else now
        with self._lock:
            events = {t: list(dq) for t, dq in self._events.items()}
        out: dict[str, dict] = {}
        for tier, evs in events.items():
            tier_out: dict[str, dict] = {}
            for window in cfg.windows_s:
                cut = now - window
                in_win = [e for e in evs if e[0] >= cut]
                dl = [e for e in in_win if e[1] is not None]
                dl_good = sum(1 for e in dl if e[1])
                av_good = sum(1 for e in in_win if e[2])
                label = f"{int(window)}s"
                tier_out[label] = {
                    "requests": len(in_win),
                    "deadline_requests": len(dl),
                    "deadline_met": (
                        dl_good / len(dl) if dl else None
                    ),
                    "availability": (
                        av_good / len(in_win) if in_win else None
                    ),
                    "deadline_burn": burn_rate(
                        dl_good, len(dl), cfg.deadline_objective
                    ),
                    "availability_burn": burn_rate(
                        av_good, len(in_win), cfg.availability_objective
                    ),
                }
            out[tier] = tier_out
        return out

    def max_burn(self, now: Optional[float] = None) -> float:
        """Worst burn across tiers, windows and both ratios — the single
        gauge the autoscaler/brownout coupling keys on."""
        worst = 0.0
        for windows in self.burn_rates(now).values():
            for w in windows.values():
                worst = max(
                    worst, w["deadline_burn"], w["availability_burn"]
                )
        return worst

    # ------------------------------------------------------------- emission

    def emit_now(self, now: Optional[float] = None) -> dict:
        """Emit one ``slo_burn`` record + the ``slo/max_burn`` gauge."""
        now = self._now() if now is None else now
        tiers = self.burn_rates(now)
        worst = 0.0
        for windows in tiers.values():
            for w in windows.values():
                worst = max(
                    worst, w["deadline_burn"], w["availability_burn"]
                )
        record = {
            "record": "slo_burn",
            "windows_s": [float(w) for w in self.config.windows_s],
            "deadline_objective": self.config.deadline_objective,
            "availability_objective": self.config.availability_objective,
            "tiers": tiers,
            "max_burn": worst,
        }
        self._registry.gauge("slo/max_burn", worst)
        self._registry.emit(record)
        return record

    def stats(self) -> dict:
        with self._lock:
            return {
                "slo_observed": self.observed,
                "slo_windows_s": list(self.config.windows_s),
            }
