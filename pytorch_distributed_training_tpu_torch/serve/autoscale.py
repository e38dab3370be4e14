"""Queue-driven autoscaling for the serving fleet: grow on pressure,
shrink by drain, never flap.

The ``Autoscaler`` watches the signals the pool already exports — per-
replica queue depth and KV page occupancy from the router's health samples,
plus breaker state — and turns ``ServeFleet``'s two pool knobs:

- **scale-up** (``fleet.scale_up()``): a new replica through the normal
  spawn machinery. It takes traffic only once the router's health poll
  qualifies it, and the autoscaler measures that spawn->ready latency into
  an ``autoscale_ready`` record.
- **scale-down** (``fleet.retire_replica()``): SIGTERM -> drain -> exit 75,
  the established graceful path — no in-flight request dies, and the
  measured drain time lands in the ``fleet_scale`` record.

Flap resistance is structural, not tuned: a scale signal must HOLD for
``up_hold_s``/``down_hold_s`` before it acts (an oscillating gauge resets
the hold timer every time it leaves the band), and each action starts a
cooldown (``up_cooldown_s``/``down_cooldown_s``) during which no further
action fires in any direction — so the pool changes at most once per
cooldown no matter how noisy the signals. Scale-up and scale-down
thresholds are separated by a wide dead band for the same reason.

``now_fn`` is injectable and ``step()`` is directly callable, so tests
drive the whole state machine with a fake clock and a fake fleet — no
subprocesses, no sleeps. ``start()`` runs the same ``step()`` on a
background thread for production use. Counterpart: the JAX package's
``serve/autoscale.py``; like the rest of the fleet layer it imports no
torch.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Optional

from pytorch_distributed_training_tpu_torch.analysis import concurrency
from pytorch_distributed_training_tpu_torch.telemetry.registry import (
    get_registry,
)
from pytorch_distributed_training_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)


@dataclasses.dataclass(frozen=True)
class AutoscaleConfig:
    """Pool bounds + the pressure/hold/cooldown policy."""

    min_replicas: int = 1
    max_replicas: int = 4
    #: scale up when mean queue depth per AVAILABLE replica holds at/above
    #: this (queued work the current pool is not absorbing)
    scale_up_queue_depth: float = 6.0
    #: scale down when mean queue depth per available replica holds at/
    #: below this (dead band between the two absorbs normal jitter)
    scale_down_queue_depth: float = 1.0
    #: scale up when any replica's KV page pool holds at/above this
    #: fraction (admission is about to block on pages)
    page_occupancy_high: float = 0.85
    #: how long the scale-up signal must persist before acting
    up_hold_s: float = 1.0
    #: how long the idle signal must persist before retiring capacity
    #: (deliberately longer: adding late costs latency, removing early
    #: costs a respawn)
    down_hold_s: float = 5.0
    #: no further action (either direction) for this long after a scale-up
    up_cooldown_s: float = 5.0
    #: no further action for this long after a scale-down
    down_cooldown_s: float = 10.0
    #: background thread cadence (start()); step() callers pick their own
    poll_interval_s: float = 0.5
    #: optional SLO coupling: when a BurnRateMonitor is attached to the
    #: Autoscaler and its worst burn rate holds at/above this, the pool is
    #: overloaded regardless of instantaneous queue depth (and is never
    #: idle while burning). 0.0 = off — the default keeps queue/page
    #: signals the sole policy.
    slo_burn_high: float = 0.0

    def __post_init__(self):
        if not 1 <= self.min_replicas <= self.max_replicas:
            raise ValueError(
                f"need 1 <= min_replicas <= max_replicas, got "
                f"{self.min_replicas}/{self.max_replicas}"
            )
        if self.scale_down_queue_depth >= self.scale_up_queue_depth:
            raise ValueError(
                "scale_down_queue_depth must be below scale_up_queue_depth "
                "(the dead band is the flap resistance)"
            )


class Autoscaler:
    """Hysteresis + cooldown state machine over a ``ServeFleet``.

    ``fleet`` needs: ``.router.replicas`` (health views), ``.replicas``
    (process states), ``.scale_up()`` and ``.retire_replica()`` — the
    test fake implements exactly that surface.
    """

    def __init__(self, fleet, config: Optional[AutoscaleConfig] = None, *,
                 now_fn=None, registry=None, slo_monitor=None):
        self.fleet = fleet
        self.config = config or AutoscaleConfig()
        # optional burn-rate input (telemetry/slo.py): read-only; only
        # consulted when config.slo_burn_high > 0
        self.slo_monitor = slo_monitor
        self._now = now_fn if now_fn is not None else time.monotonic
        if registry is None:
            registry = get_registry()
        self._registry = registry
        self.scale_ups = 0
        self.scale_downs = 0
        self.last_action: Optional[str] = None
        self._up_t: Optional[float] = None      # scale-up signal onset
        self._down_t: Optional[float] = None    # idle signal onset
        self._cooldown_until: float = -float("inf")
        self._ever_ready = False    # don't scale a pool still booting
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # step() runs on the poll thread; stats() on HTTP/control threads
        self._lock = concurrency.lock("serve.autoscale")

    # -------------------------------------------------------------- signals

    def signals(self) -> dict:
        """One snapshot of the pressure inputs, from the router's health
        samples (no extra probes — the health poll already pays for them)."""
        views = list(self.fleet.router.replicas)
        available = [r for r in views if r.available()]
        depths = [
            float(r.health.get("queue_depth", 0)) for r in available
        ]
        pages = [
            float(r.health.get("page_occupancy", 0.0)) for r in available
        ]
        live = sum(
            1 for r in self.fleet.replicas
            if r.state in ("starting", "up")
        )
        return {
            "available": len(available),
            "live": live,
            "mean_queue_depth": (
                sum(depths) / len(depths) if depths else 0.0
            ),
            "max_page_occupancy": max(pages) if pages else 0.0,
            "breakers_open": sum(
                1 for r in views if r.breaker.state != "closed"
            ),
            "slo_burn": (
                self.slo_monitor.max_burn()
                if self.slo_monitor is not None else 0.0
            ),
        }

    # ----------------------------------------------------------------- step

    def step(self) -> Optional[str]:
        """One evaluation: read signals, advance hold timers, maybe act.
        Returns ``"up"``, ``"down"`` or None. Deterministic under an
        injected clock — the whole hysteresis/cooldown contract is tested
        through this method alone."""
        cfg = self.config
        now = self._now()
        sig = self.signals()
        with self._lock:
            if sig["available"] > 0:
                self._ever_ready = True
            if not self._ever_ready or sig["available"] == 0:
                # a booting pool (or one with zero qualified replicas) has
                # no trustworthy pressure reading; scaling on it would
                # race the first health qualification
                self._up_t = None
                self._down_t = None
                return None

            burning = (
                cfg.slo_burn_high > 0.0
                and sig["slo_burn"] >= cfg.slo_burn_high
            )
            overloaded = (
                sig["mean_queue_depth"] >= cfg.scale_up_queue_depth
                or sig["max_page_occupancy"] >= cfg.page_occupancy_high
                or burning
            )
            idle = (
                sig["mean_queue_depth"] <= cfg.scale_down_queue_depth
                and sig["max_page_occupancy"] < cfg.page_occupancy_high
                and sig["breakers_open"] == 0
                and not burning
            )

            # hold timers: onset is remembered, leaving the band resets it
            self._up_t = (self._up_t or now) if overloaded else None
            self._down_t = (self._down_t or now) if idle else None

            if now < self._cooldown_until:
                return None

            if (
                overloaded
                and sig["live"] < cfg.max_replicas
                and now - self._up_t >= cfg.up_hold_s
            ):
                action = "up"
            elif (
                idle
                and sig["live"] > cfg.min_replicas
                and now - self._down_t >= cfg.down_hold_s
            ):
                action = "down"
            else:
                return None

        # act OUTSIDE the lock: scale_up/retire touch fleet/router locks
        if action == "up":
            return self._scale_up(now, sig)
        return self._scale_down(now, sig)

    def _scale_up(self, now: float, sig: dict) -> Optional[str]:
        replica = self.fleet.scale_up()
        with self._lock:
            self.scale_ups += 1
            self.last_action = "up"
            self._cooldown_until = now + self.config.up_cooldown_s
            self._up_t = None
        self._registry.inc("autoscale/scale_ups")
        self._emit_event("up", replica.name, sig)
        self._watch_ready(replica)
        return "up"

    def _scale_down(self, now: float, sig: dict) -> Optional[str]:
        name = self.fleet.retire_replica()
        if name is None:        # nothing retirable (raced a failure)
            return None
        with self._lock:
            self.scale_downs += 1
            self.last_action = "down"
            self._cooldown_until = now + self.config.down_cooldown_s
            self._down_t = None
        self._registry.inc("autoscale/scale_downs")
        self._emit_event("down", name, sig)
        return "down"

    def _emit_event(self, action: str, replica: str, sig: dict) -> None:
        logger.info("autoscale %s: %s (signals %s)", action, replica, sig)
        self._registry.gauge("autoscale/pool_size", sig["live"] +
                             (1 if action == "up" else -1))
        self._registry.emit({
            "record": "autoscale_event",
            "action": action,
            "replica": replica,
            **sig,
        })

    def _watch_ready(self, replica, timeout: float = 120.0) -> None:
        """Measure the scale-up's spawn->in-rotation latency on a side
        thread (``autoscale_ready`` record). Uses the real clock: this is
        measurement, not policy, and it must not block step()."""
        t0 = time.monotonic()

        def _wait() -> None:
            deadline = t0 + timeout
            while time.monotonic() < deadline and not self._stop.is_set():
                view = next(
                    (r for r in self.fleet.router.replicas
                     if r.name == replica.name), None,
                )
                if view is not None and view.available():
                    self._registry.emit({
                        "record": "autoscale_ready",
                        "replica": replica.name,
                        "ready_s": time.monotonic() - t0,
                    })
                    return
                time.sleep(0.05)
            logger.warning(
                "autoscale: replica %s not in rotation after %.0fs",
                replica.name, timeout,
            )

        threading.Thread(
            target=_wait, name=f"autoscale-ready-{replica.name}",
            daemon=True,
        ).start()

    # ------------------------------------------------------------ lifecycle

    def start(self) -> "Autoscaler":
        if self._thread is not None:
            raise RuntimeError("autoscaler already started")
        self._thread = threading.Thread(
            target=self._loop, name="autoscaler", daemon=True
        )
        self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.wait(self.config.poll_interval_s):
            try:
                self.step()
            except Exception:   # a scale attempt must not kill the loop
                logger.exception("autoscaler step failed; continuing")

    def close(self) -> None:
        self._stop.set()
        thread, self._thread = self._thread, None
        if thread is not None:
            thread.join(5.0)

    def stats(self) -> dict:
        with self._lock:
            return {
                "scale_ups": self.scale_ups,
                "scale_downs": self.scale_downs,
                "last_action": self.last_action,
                "cooling_down": self._now() < self._cooldown_until,
            }
