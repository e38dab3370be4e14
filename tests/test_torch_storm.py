"""Port parity, load shaping and the pool's state machines: the seeded
open-loop trace (``serve/trace.py``) bit-equal to JAX's events and stats,
``replay`` under an injected clock, the autoscaler's decisions
(``serve/autoscale.py``) equal to JAX's over the same gauge sequences on a
fake fleet, the replica's bind-race port retry and the pool's exhausted
restart budget (``serve/fleet.py``) against JAX's, and
``scripts/summarize_metrics.py``'s storm and fleet sections read from the
port's records."""

import dataclasses
import importlib.util
import os
import threading
import time
import types

import pytest

from pytorch_distributed_training_tpu.serve import autoscale as jax_autoscale
from pytorch_distributed_training_tpu.serve import fleet as jax_fleet
from pytorch_distributed_training_tpu.serve import queue as jax_queue
from pytorch_distributed_training_tpu.serve import trace as jax_trace
from pytorch_distributed_training_tpu.telemetry.registry import (
    MetricsRegistry as JaxMetricsRegistry,
)
from pytorch_distributed_training_tpu_torch.serve import (
    autoscale,
    fleet,
    queue,
    trace,
)
from pytorch_distributed_training_tpu_torch.serve.server import wait_until
from pytorch_distributed_training_tpu_torch.telemetry.registry import (
    MetricsRegistry,
)

pytestmark = [pytest.mark.serve, pytest.mark.storm]

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

IMPLS = {
    "port": types.SimpleNamespace(trace=trace, autoscale=autoscale,
                                  fleet=fleet, queue=queue,
                                  metrics=MetricsRegistry),
    "jax": types.SimpleNamespace(trace=jax_trace, autoscale=jax_autoscale,
                                 fleet=jax_fleet, queue=jax_queue,
                                 metrics=JaxMetricsRegistry),
}


class ListSink:
    """In-memory sink; ``ts`` is the emission index, so the timeline
    orders by emission and two runs compare equal."""

    def __init__(self):
        self.records = []
        self._lock = threading.Lock()

    def emit(self, record):
        with self._lock:
            rec = dict(record)
            rec["ts"] = float(len(self.records))
            self.records.append(rec)

    def flush(self, **kw):
        pass

    def of(self, kind):
        with self._lock:
            return [r for r in self.records if r.get("record") == kind]


def _registry(impl):
    reg, sink = IMPLS[impl].metrics(), ListSink()
    reg.attach_sink(sink)
    return reg, sink


class FakeClock:
    def __init__(self, t: float = 100.0):
        self.t = t

    def __call__(self) -> float:
        return self.t


# --------------------------------------------------------------- traces


TRACES = [
    dict(seed=7, duration_s=20.0),
    dict(seed=1, duration_s=12.0, base_rate_rps=2.0, burst_rate_rps=30.0,
         bursts=((4.0, 2.0),)),
    dict(seed=3, duration_s=15.0, interactive_fraction=0.4, tenants=3,
         shared_prefix_len=24, bursts=((2.0, 1.0), (8.0, 3.0))),
]


@pytest.mark.parametrize("kw", TRACES, ids=["seed7", "seed1", "seed3"])
def test_trace_events_and_stats_equal_jax(kw):
    got = trace.generate_trace(trace.TraceConfig(**kw))
    want = jax_trace.generate_trace(jax_trace.TraceConfig(**kw))
    assert len(got) > 10
    # every field bit for bit: arrival floats, tiers, sizes, seeds
    assert [dataclasses.astuple(e) for e in got] == [
        dataclasses.astuple(e) for e in want]
    assert trace.trace_stats(got) == jax_trace.trace_stats(want)
    assert trace.TIERS == jax_trace.TIERS
    cfg = trace.TraceConfig(**kw)
    for ev in got:
        assert cfg.prompt_len_min <= ev.prompt_len
        assert ev.deadline_s == (cfg.interactive_deadline_s
                                 if ev.tier == "interactive"
                                 else cfg.batch_deadline_s)


@pytest.mark.parametrize("bad", [dict(duration_s=0), dict(base_rate_rps=0),
                                 dict(interactive_fraction=1.5),
                                 dict(bursts=((-1.0, 1.0),)),
                                 dict(tenants=-1), dict(tenants=2)])
def test_trace_config_errors_match_jax(bad):
    for mod in (trace, jax_trace):
        with pytest.raises(ValueError):
            mod.TraceConfig(**bad)


def _replay(mod, events, stop_after=None):
    clock = FakeClock(0.0)
    sleeps, fired = [], []

    def sleep(s):
        sleeps.append(s)
        clock.t += s

    def fire(ev):
        fired.append((ev.index, clock.t))
        clock.t += 0.03         # a slow fire: the replay falls behind

    stop = None if stop_after is None else (lambda: len(fired) >= stop_after)
    out = mod.replay(events, fire, now_fn=clock, sleep_fn=sleep, stop=stop)
    return out, fired, sleeps


def test_replay_with_injected_clock_matches_jax():
    events = trace.generate_trace(trace.TraceConfig(seed=5, duration_s=6.0))
    jevents = jax_trace.generate_trace(jax_trace.TraceConfig(seed=5,
                                                             duration_s=6.0))
    got = _replay(trace, events)
    assert got == _replay(jax_trace, jevents)
    out, fired, sleeps = got
    assert out["fired"] == len(events)
    assert [i for i, _ in fired] == list(range(len(events)))
    # open loop: each fire at or after its offset, sleeps capped at 50 ms
    assert all(t >= ev.t_s for (_, t), ev in zip(fired, events))
    assert max(sleeps) <= 0.05 and out["max_lag_s"] > 0.0
    early = _replay(trace, events, stop_after=3)
    assert early[0]["fired"] == 3
    assert early == _replay(jax_trace, jevents, stop_after=3)


# ----------------------------------------------------------- autoscaler


class FakeFleet:
    """The surface the autoscaler reads: router health views, process
    states, ``scale_up`` and ``retire_replica``."""

    def __init__(self, n=2):
        self.retired = []
        self._n = 0
        self.router = types.SimpleNamespace(replicas=[])
        self.replicas = []
        for _ in range(n):
            self._add()
        self.depth = 0.0
        self.occupancy = 0.0

    def _add(self):
        name = f"r{self._n}"
        self._n += 1
        fake = self

        class View:
            def __init__(self):
                self.name = name
                self.breaker = types.SimpleNamespace(state="closed")
                self.ready = True

            @property
            def health(self):
                return {"queue_depth": fake.depth,
                        "page_occupancy": fake.occupancy}

            def available(self):
                return self.ready

        self.router.replicas.append(View())
        proc = types.SimpleNamespace(name=name, state="up")
        self.replicas.append(proc)
        return proc

    def scale_up(self):
        return self._add()

    def retire_replica(self):
        live = [r for r in self.replicas if r.state in ("starting", "up")]
        if len(live) <= 1:
            return None
        victim = live[-1]
        self.replicas.remove(victim)
        self.router.replicas = [v for v in self.router.replicas
                                if v.name != victim.name]
        self.retired.append(victim.name)
        return victim.name


def _oscillating(fleet_, clock, auto):
    out = []
    for i in range(100):
        fleet_.depth = 20.0 if i % 2 == 0 else 0.0
        out.append(auto.step())
        clock.t += 0.6
    return out


def _scale_up_then_cooldown(fleet_, clock, auto):
    out = []
    fleet_.depth = 12.0
    for dt in (0.0, 1.1, 2.0, 3.5, 10.0, 1.1):
        clock.t += dt
        out.append(auto.step())
    return out


def _scale_down_and_min(fleet_, clock, auto):
    out = []
    fleet_.depth = 0.0
    for dt in (0.0, 2.0, 3.5, 6.0, 5.0, 30.0, 5.5):
        clock.t += dt
        out.append(auto.step())
    return out


def _breaker_and_occupancy(fleet_, clock, auto):
    out = []
    fleet_.occupancy = 0.95
    out.append(auto.step())
    clock.t += 1.1
    out.append(auto.step())
    fleet_.occupancy = 0.0
    fleet_.router.replicas[0].breaker.state = "open"
    for dt in (10.0, 6.0):
        clock.t += dt
        out.append(auto.step())
    fleet_.router.replicas[0].breaker.state = "closed"
    for dt in (0.0, 5.5):
        clock.t += dt
        out.append(auto.step())
    return out


def _booting_pool(fleet_, clock, auto):
    for view in fleet_.router.replicas:
        view.ready = False
    fleet_.depth = 50.0
    out = []
    for _ in range(20):
        out.append(auto.step())
        clock.t += 1.0
    return out


def _slo_burn(fleet_, clock, auto):
    burn = types.SimpleNamespace(value=0.0)
    auto.slo_monitor = types.SimpleNamespace(max_burn=lambda: burn.value)
    out = []
    burn.value = 20.0            # shallow queue, burning budget
    for dt in (0.0, 1.1, 12.0, 6.0):
        clock.t += dt
        out.append(auto.step())
    burn.value = 0.0
    for dt in (0.0, 5.5):
        clock.t += dt
        out.append(auto.step())
    return out


SEQUENCES = {
    "oscillating": (2, {}, _oscillating),
    "scale_up_then_cooldown": (2, {}, _scale_up_then_cooldown),
    "scale_down_and_min": (3, {}, _scale_down_and_min),
    "breaker_and_occupancy": (2, {}, _breaker_and_occupancy),
    "booting_pool": (2, {}, _booting_pool),
    "slo_burn": (2, {"slo_burn_high": 14.4}, _slo_burn),
}


def _drive(impl, name):
    n, extra, script = SEQUENCES[name]
    mod = IMPLS[impl].autoscale
    fleet_, clock = FakeFleet(n), FakeClock()
    reg, sink = _registry(impl)
    cfg = mod.AutoscaleConfig(**{
        "min_replicas": 1, "max_replicas": 4,
        "scale_up_queue_depth": 6.0, "scale_down_queue_depth": 1.0,
        "up_hold_s": 1.0, "down_hold_s": 5.0,
        "up_cooldown_s": 5.0, "down_cooldown_s": 10.0, **extra})
    auto = mod.Autoscaler(fleet_, cfg, now_fn=clock, registry=reg)
    try:
        decisions = script(fleet_, clock, auto)
    finally:
        auto.close()
    events = [{k: v for k, v in r.items() if k != "ts"}
              for r in sink.of("autoscale_event")]
    return {"decisions": decisions, "pool": [r.name for r in fleet_.replicas],
            "retired": fleet_.retired, "events": events,
            "stats": auto.stats(), "counters": reg.snapshot()["counters"]}


@pytest.mark.parametrize("name", sorted(SEQUENCES))
def test_autoscaler_decisions_equal_jax(name):
    got = _drive("port", name)
    assert got == _drive("jax", name)
    want = {
        "oscillating": [None] * 100,
        "scale_up_then_cooldown": [None, "up", None, "up", None, None],
        "scale_down_and_min": [None, None, "down", None, "down", None, None],
        "breaker_and_occupancy": [None, "up", None, None, None, "down"],
        "booting_pool": [None] * 20,
        "slo_burn": [None, "up", None, "up", None, "down"],
    }[name]
    assert got["decisions"] == want


def test_autoscale_config_errors_match_jax():
    for bad in (dict(min_replicas=0), dict(min_replicas=5, max_replicas=4),
                dict(scale_down_queue_depth=6.0)):
        for mod in (autoscale, jax_autoscale):
            with pytest.raises(ValueError):
                mod.AutoscaleConfig(**bad)


# ------------------------------------------- port retry + restart budget


class FakeProc:
    def __init__(self, rc):
        self.pid = 4242
        self._rc = rc

    def wait(self, timeout=None):
        return self._rc

    def poll(self):
        return self._rc


def _port_retry(impl, monkeypatch, rcs, max_retries=None):
    mod = IMPLS[impl].fleet
    rcs = list(rcs)
    spawned = []

    def fake_popen(argv, env=None, stdout=None, stderr=None):
        spawned.append(list(argv))
        return FakeProc(rcs.pop(0))

    monkeypatch.setattr(mod.subprocess, "Popen", fake_popen)
    if max_retries is not None:
        monkeypatch.setattr(mod, "MAX_PORT_RETRIES", max_retries)
    reg, sink = _registry(impl)
    replica = mod.ReplicaProcess(
        0, 50_000, mod.FleetConfig(num_replicas=1, max_restarts=1), reg)
    rebinds = []
    replica.on_port_change = lambda r: rebinds.append(r.port)
    try:
        replica._spawn_and_wait(0)
        raised = None
    except BaseException as e:  # noqa: BLE001 - the outcome is the result
        raised = type(e).__name__
    d = replica.describe()
    return {
        "raised": raised,
        "describe": {k: d[k] for k in ("port_retries", "restarts_used",
                                       "restart_budget_remaining", "spawns",
                                       "state")},
        "spawned": len(spawned),
        "module": spawned[0][spawned[0].index("-m") + 1],
        "rebinds": len(rebinds), "fresh": all(p != 50_000 for p in rebinds),
        "records": [(r["record"], r.get("try"), r.get("old_port") == 50_000,
                     r.get("rc"), r.get("graceful"))
                    for r in sink.records if r["record"] != "replica_spawn"],
        "counters": reg.snapshot()["counters"],
    }


@pytest.mark.parametrize("rcs", [(76, 76, 0), (76, 23), (76, 75)],
                         ids=["retried", "then_crash", "then_drain"])
def test_replica_port_retry_burns_no_restart(rcs, monkeypatch):
    got = _port_retry("port", monkeypatch, rcs)
    want = _port_retry("jax", monkeypatch, rcs)
    assert got["module"] == "pytorch_distributed_training_tpu_torch.cli."\
        "serve_lm"
    assert want["module"] == "pytorch_distributed_training_tpu.cli.serve_lm"
    got.pop("module"), want.pop("module")
    assert got == want
    assert got["describe"]["restarts_used"] == 0     # the race burned none
    assert got["describe"]["port_retries"] == len(rcs) - 1
    assert got["raised"] == {0: None, 23: "ReplicaCrashed",
                             75: "Preempted"}[rcs[-1]]
    assert got["fresh"] and got["rebinds"] == len(rcs) - 1


def test_repeated_bind_losses_fall_through_to_the_crash_path(monkeypatch):
    got = _port_retry("port", monkeypatch, (76, 76, 76), max_retries=2)
    want = _port_retry("jax", monkeypatch, (76, 76, 76), max_retries=2)
    got.pop("module"), want.pop("module")
    assert got == want and got["raised"] == "ReplicaCrashed"
    assert got["describe"]["port_retries"] == 2


def _pool_status(impl):
    mod = IMPLS[impl].fleet
    reg, _ = _registry(impl)
    fl = mod.ServeFleet(mod.FleetConfig(num_replicas=2, max_restarts=2),
                        registry=reg)       # never started
    try:
        before = fl.pool_status()
        fl.replicas[1].state = "failed"
        fl.replicas[1].restarts_used = 2
        after = fl.pool_status()
        return before, after, fl.router.pool_status() == after
    finally:
        fl.router.close()


def test_pool_status_reports_exhausted_restart_budget():
    got = _pool_status("port")
    assert got == _pool_status("jax")
    before, after, routed = got
    assert before["degraded"] is False and before["reason"] is None
    assert before["restart_budget_remaining"] == {"r0": 2, "r1": 2}
    assert after["degraded"] is True and after["failed"] == ["r1"]
    assert "restart budget exhausted" in after["reason"]
    assert after["restart_budget_remaining"]["r1"] == 0 and routed


def test_fleet_config_and_argv_match_jax():
    for mod in (fleet, jax_fleet):
        with pytest.raises(ValueError):
            mod.FleetConfig(num_replicas=0)
    cfg = fleet.FleetConfig(replica_args=("--device", "cpu"),
                            replica_extra_args={0: ("--replica-name", "a")},
                            fault_env={0: "replica_crash:3"},
                            replica_env={"X_ONE": "1"})
    replica = fleet.ReplicaProcess(0, 1234, cfg, MetricsRegistry())
    argv = replica._argv()
    assert argv[1:3] == ["-m",
                         "pytorch_distributed_training_tpu_torch.cli.serve_lm"]
    assert argv[3:] == ["--http-port", "1234", "--http-host", "127.0.0.1",
                        "--drain-timeout-s", "10.0", "--device", "cpu",
                        "--replica-name", "a"]
    jax_argv = jax_fleet.ReplicaProcess(
        0, 1234, jax_fleet.FleetConfig(**{
            k: getattr(cfg, k) for k in ("replica_args",
                                         "replica_extra_args", "fault_env",
                                         "replica_env")}),
        JaxMetricsRegistry())._argv()
    assert argv[3:] == jax_argv[3:]
    env = replica._env()
    assert env["PDT_TPU_FAULT"] == "replica_crash:3" and env["X_ONE"] == "1"
    # a --tp replica's ranks each run serve_lm itself (serve/fleet.py's
    # RankGroup sets their process-group environment), as JAX's replica
    # is one serve_lm process: no launcher in front of it
    tp = fleet.ReplicaProcess(0, 1, fleet.FleetConfig(tp=2),
                              MetricsRegistry())._argv()
    assert tp[1:3] == ["-m",
                       "pytorch_distributed_training_tpu_torch.cli.serve_lm"]


# ------------------------------------------------ summarize_metrics


def _summarize_module():
    spec = importlib.util.spec_from_file_location(
        "summarize_metrics", os.path.join(REPO, "scripts",
                                          "summarize_metrics.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _storm_stream(impl, monkeypatch):
    """A stream from one package's own components: a bind-race retry, an
    autoscaler scale-up (qualified by the router) and drained scale-down
    over a ``ServeFleet`` whose processes are stubbed, and a brownout
    ladder up and back down."""
    ns = IMPLS[impl]
    reg, sink = _registry(impl)
    rcs = [76, 0]
    monkeypatch.setattr(ns.fleet.subprocess, "Popen",
                        lambda argv, **kw: FakeProc(rcs.pop(0)))
    ns.fleet.ReplicaProcess(0, 50_000, ns.fleet.FleetConfig(
        num_replicas=1), reg)._spawn_and_wait(0)
    for name in ("start", "stop", "join"):
        monkeypatch.setattr(ns.fleet.ReplicaProcess, name,
                            lambda self, *a, **kw: self)
    fl = ns.fleet.ServeFleet(ns.fleet.FleetConfig(num_replicas=2),
                             registry=reg)
    clock = FakeClock()
    auto = ns.autoscale.Autoscaler(fl, ns.autoscale.AutoscaleConfig(
        up_hold_s=1.0, down_hold_s=5.0, up_cooldown_s=5.0,
        down_cooldown_s=10.0), now_fn=clock, registry=reg)
    try:
        for view in fl.router.replicas:
            view.last_ready_t = time.monotonic()
            view.health = {"queue_depth": 12}
        for dt in (0.0, 1.1):
            clock.t += dt
            step = auto.step()
        assert step == "up"
        fl.router.replicas[-1].last_ready_t = time.monotonic()
        assert wait_until(lambda: sink.of("autoscale_ready"), timeout=10)
        for view in fl.router.replicas:
            view.health = {"queue_depth": 0}
        for dt in (10.0, 5.5):
            clock.t += dt
            step = auto.step()
        assert step == "down"
        assert wait_until(lambda: any(r["action"] == "down"
                                      for r in sink.of("fleet_scale")),
                          timeout=10)
    finally:
        auto.close()
        fl.router.close()
    bclock = FakeClock()
    brown = ns.queue.BrownoutController(
        high_watermark=0.8, low_watermark=0.3, escalate_hold_s=0.5,
        deescalate_hold_s=1.0, now_fn=bclock, registry=reg)
    for pressure in (0.9,) * 4 + (0.1,) * 8:
        brown.observe(pressure)
        bclock.t += 0.6
    return sink.records


def _timeless(obj):
    """``obj`` without measured durations (wall clock) and OS-assigned
    ports."""
    if isinstance(obj, dict):
        return {k: _timeless(v) for k, v in obj.items()
                if k not in ("ready_s", "drain_s", "scale_up_ready_s",
                             "scale_down_drain_s", "total_s", "new_port")}
    if isinstance(obj, list):
        return [_timeless(v) for v in obj]
    return obj


def test_summarize_storm_and_fleet_sections_read_port_records(monkeypatch):
    mod = _summarize_module()
    got = _storm_stream("port", monkeypatch)
    want = _storm_stream("jax", monkeypatch)
    kinds = [r["record"] for r in got]
    assert kinds == [r["record"] for r in want]
    storm, fleet_view = mod.summarize_storm(got), mod.summarize_fleet(got)
    assert _timeless(storm) == _timeless(mod.summarize_storm(want))
    assert _timeless(fleet_view) == _timeless(mod.summarize_fleet(want))
    assert storm["scale_ups"] == 1 and storm["scale_downs"] == 1
    assert storm["port_retries"] == 1
    assert storm["scale_up_ready_s"]["p50"] > 0
    assert storm["scale_down_drain_s"]["p50"] >= 0
    assert storm["brownout"]["escalations"] >= 1
    assert storm["brownout"]["final_level"] == 0
    assert [e["event"] for e in storm["timeline"]] == [
        "port_retry", "scale_up", "replica_ready", "scale_down"]
    assert fleet_view["replicas"]["r0"]["spawns"] == 2
    assert "storm:" in mod.render_storm_table(storm)
