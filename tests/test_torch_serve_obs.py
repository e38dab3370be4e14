"""Port parity, serving observability: the span tree a served request
emits, the flight recorder and its dumps (watchdog stall, ``GET
/debug/flight``), the SLO burn-rate math and monitor, the brownout ladder,
the ``serve_request`` records and the stream ``scripts/summarize_metrics.py``
reads, each against the JAX package on the same inputs, weights and
injected clock (``--device cpu``)."""

import http.client
import importlib.util
import json
import os
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_training_tpu.models.gpt2 import GPT2LMModel as JaxGPT2
from pytorch_distributed_training_tpu.serve import (
    EngineConfig as JaxEngineConfig,
)
from pytorch_distributed_training_tpu.serve import (
    InferenceServer as JaxServer,
)
from pytorch_distributed_training_tpu.serve.queue import (
    BrownoutController as JaxBrownout,
)
from pytorch_distributed_training_tpu.serve.server import wait_until
from pytorch_distributed_training_tpu.telemetry import flight as jax_flight
from pytorch_distributed_training_tpu.telemetry import slo as jax_slo
from pytorch_distributed_training_tpu.telemetry.registry import (
    MetricsRegistry as JaxRegistry,
)
from pytorch_distributed_training_tpu.utils.config import (
    model_preset as jax_preset,
)
from pytorch_distributed_training_tpu_torch.data.bpe import ByteTokenizer
from pytorch_distributed_training_tpu_torch.faults import watchdog
from pytorch_distributed_training_tpu_torch.faults.inject import (
    FaultPlan,
    set_plan,
)
from pytorch_distributed_training_tpu_torch.models.convert import (
    params_from_jax,
)
from pytorch_distributed_training_tpu_torch.models.gpt2 import GPT2LMModel
from pytorch_distributed_training_tpu_torch.serve import (
    EngineConfig,
    InferenceServer,
    make_http_server,
)
from pytorch_distributed_training_tpu_torch.serve.queue import (
    BROWNOUT_LEVELS,
    BrownoutController,
)
from pytorch_distributed_training_tpu_torch.telemetry import flight
from pytorch_distributed_training_tpu_torch.telemetry.registry import (
    MetricsRegistry,
    set_registry,
)
from pytorch_distributed_training_tpu_torch.telemetry.slo import (
    BurnRateMonitor,
    SloConfig,
    burn_rate,
)
from pytorch_distributed_training_tpu_torch.telemetry.spans import (
    REQUEST_PHASES,
    spans_by_trace,
    trace_coverage,
    trace_summary,
)
from pytorch_distributed_training_tpu_torch.utils.config import model_preset

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class ListSink:
    """In-memory telemetry sink (``JsonlSink.emit``'s contract)."""

    def __init__(self):
        self.records = []
        self._lock = threading.Lock()

    def emit(self, record):
        rec = dict(record)
        rec.setdefault("ts", time.time())
        with self._lock:
            self.records.append(rec)

    def flush(self, **kw):
        pass

    def of(self, kind):
        with self._lock:
            return [r for r in self.records if r.get("record") == kind]


class FakeClock:
    def __init__(self, t: float = 100.0):
        self.t = t

    def __call__(self) -> float:
        return self.t


def _registry(cls=MetricsRegistry):
    reg, sink = cls(), ListSink()
    reg.attach_sink(sink)
    return reg, sink


@pytest.fixture(scope="module")
def lms():
    """The JAX gpt2-tiny (fp32) and the port's model on the same weights."""
    cfg = jax_preset(
        "gpt2-tiny", compute_dtype="float32", attention_impl="reference",
        hidden_dropout=0.0, attention_dropout=0.0,
    )
    jmodel = JaxGPT2(cfg)
    params = jmodel.init(jax.random.key(0), jnp.ones((2, 16), jnp.int32))[
        "params"]
    model = GPT2LMModel(model_preset("gpt2-tiny", compute_dtype="float32"))
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    return (jmodel, params), model


@pytest.fixture(autouse=True)
def _clean_fault_state():
    yield
    set_plan(None)
    watchdog.set_watchdog(None)


def _prompts(lengths, seed=3, vocab=1024):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, n).astype(np.int32) for n in lengths]


def _serve_both(lms, config_kw, requests, *, T):
    """The same requests through the port's and the JAX server, all
    submitted before the loop starts (so both schedule them alike); each
    side's requests and records."""
    (jmodel, params), model = lms
    out = []
    for side in ("port", "jax"):
        if side == "port":
            reg, sink = _registry()
            server = InferenceServer(model, EngineConfig(**config_kw),
                                     device="cpu", queue_depth=16,
                                     registry=reg)
        else:
            reg, sink = _registry(JaxRegistry)
            server = JaxServer(jmodel, params, JaxEngineConfig(**config_kw),
                               queue_depth=16, registry=reg)
        reqs = [server.submit(p, max_new_tokens=T, request_id=f"q{i}", **kw)
                for i, (p, kw) in enumerate(requests)]
        server.start()
        try:
            assert wait_until(lambda: all(r.done.is_set() for r in reqs),
                              timeout=120)
        finally:
            server.close()
        out.append((reqs, sink, server))
    return out


def _tree(spans):
    """A trace's structure without ids and stamps: (name, parent's name,
    attrs) a span, sorted."""
    by_id = {s["span"]: s["name"] for s in spans}
    return sorted((s["name"], by_id.get(s["parent"]),
                   json.dumps(s["attrs"], sort_keys=True)) for s in spans)


# ------------------------------------------------------------------ spans


def test_span_tree_matches_jax_mixed_greedy_spec(lms):
    """Greedy and speculative requests in one batch: each yields one
    complete tree whose queue/prefill/decode phases tile submit to finish
    exactly, with JAX's names, parents and attributes."""
    T = 6
    flags = [(False, "interactive"), (True, "batch"), (False, "interactive"),
             (True, "batch")]
    requests = [(p, {"spec": s, "tier": t})
                for p, (s, t) in zip(_prompts([4, 6, 5, 7]), flags)]
    cfg = dict(num_slots=2, prompt_buckets=(8,), max_new_tokens=T,
               spec_k=3)
    (preqs, psink, _), (jreqs, jsink, _) = _serve_both(lms, cfg, requests,
                                                       T=T)
    assert [r.tokens for r in preqs] == [r.tokens for r in jreqs]
    cov = trace_coverage(psink.records, accepted_ids=[r.id for r in preqs])
    assert cov["traces"] == 4 and cov["coverage"] == 1.0, cov
    assert cov["orphan_spans"] == 0 and cov["phase_sum_bad"] == []
    ptraces = spans_by_trace(psink.records)
    jtraces = spans_by_trace(jsink.records)
    for req, (spec, tier) in zip(preqs, flags):
        spans = {s["name"]: s for s in ptraces[req.id]}
        assert {"serve", "admission", *REQUEST_PHASES} <= set(spans)
        assert spans["serve"]["parent"] is None
        assert spans["queue"]["t0_s"] == spans["serve"]["t0_s"]
        assert spans["queue"]["t1_s"] == spans["prefill"]["t0_s"]
        assert spans["prefill"]["t1_s"] == spans["decode"]["t0_s"]
        assert spans["decode"]["t1_s"] == spans["serve"]["t1_s"]
        assert trace_summary(ptraces[req.id])["phase_sum_ok"] is True
        assert spans["admission"]["parent"] == spans["prefill"]["span"]
        assert spans["serve"]["attrs"]["tier"] == tier
        assert (spans["decode"]["attrs"]["drafted"] > 0) == spec
        assert _tree(ptraces[req.id]) == _tree(jtraces[req.id])
    keys = {k for r in psink.of("span") for k in r} - {"ts"}
    assert keys == {k for r in jsink.of("span") for k in r} - {"ts"}


def test_serve_request_records_counters_and_stats_keys_match_jax(lms):
    """``serve_request`` records with JAX's keys and values (but the
    timings), the counters JAX's engine bumps, and the ``stats()`` keys of
    the JAX engine's observability block."""
    T = 4
    requests = [(p, {"tier": t}) for p, t in zip(
        _prompts([3, 9], seed=5), ("interactive", "batch"))]
    cfg = dict(num_slots=1, prompt_buckets=(8, 16), max_new_tokens=T)
    (preqs, psink, pserver), (jreqs, jsink, jserver) = _serve_both(
        lms, cfg, requests, T=T)
    timed = {"queue_wait_s", "ttft_s", "tpot_s", "total_s", "ts"}

    def strip(rec):
        return {k: v for k, v in rec.items() if k not in timed}

    prec, jrec = psink.of("serve_request"), jsink.of("serve_request")
    assert [strip(r) for r in prec] == [strip(r) for r in jrec]
    assert set(prec[0]) == set(jrec[0])
    pc = pserver.engine._registry.snapshot()["counters"]
    jc = jserver.engine._registry.snapshot()["counters"]
    assert pc == jc
    # the drain-rate gauge comes with the first window of 1 s or more
    clocked = {"serve/drain_rate_rps"}
    assert set(pserver.engine._registry.snapshot()["gauges"]) - clocked == (
        set(jserver.engine._registry.snapshot()["gauges"]) - clocked)
    obs_keys = {"page_occupancy", "drain_rate_rps", "brownout",
                "spans_emitted", "flight_capacity", "flight_depth",
                "flight_recorded", "flight_dumps", "flight_last_dump",
                "swaps", "swap_rollbacks", "swap_pending", "weights_step"}
    pstats, jstats = pserver.stats(), jserver.stats()
    assert obs_keys <= set(pstats) and obs_keys <= set(jstats)
    for k in obs_keys - {"drain_rate_rps", "flight_dumps"}:
        assert pstats[k] == jstats[k], k


def test_summarize_metrics_reads_the_port_stream_as_jax(lms, tmp_path):
    """``scripts/summarize_metrics.py``'s ``summarize`` folds the port's
    serve stream (written by the port's ``JsonlSink``) into the same
    sections, with the same keys, as the JAX engine's stream."""
    from pytorch_distributed_training_tpu_torch.telemetry.sink import (
        JsonlSink,
    )

    path = os.path.join(REPO, "scripts", "summarize_metrics.py")
    spec = importlib.util.spec_from_file_location("summarize_metrics", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    T = 4
    requests = [(p, {}) for p in _prompts([4, 6, 5], seed=9)]
    cfg = dict(num_slots=2, prompt_buckets=(8,), max_new_tokens=T)
    (_, psink, pserver), (_, jsink, jserver) = _serve_both(lms, cfg,
                                                           requests, T=T)
    disk = JsonlSink(str(tmp_path))
    for rec in psink.records:
        disk.emit(rec)
    disk.emit({"record": "serve_summary", **pserver.stats()})
    disk.close()
    pflight = pserver.engine.flight
    jflight = jserver.engine.flight
    pflight._registry.attach_sink(disk := JsonlSink(str(tmp_path)))
    pflight.dump("drill")
    disk.close()
    jsink.emit({"record": "serve_summary", **jserver.stats()})
    jflight.dump("drill")
    got = mod.summarize(mod.load_records(str(tmp_path)))
    want = mod.summarize(jsink.records)
    # the JAX engine's runtime guards (their records) are not ported
    sections = {k for k, v in want.items()
                if v not in (None, [], {}) and k != "guards"}
    assert sections >= {"serve", "spans", "flight"}
    assert {k for k, v in got.items() if v not in (None, [], {})} == sections
    for name in sections:
        if isinstance(want[name], dict):
            assert set(got[name]) == set(want[name]), name
    assert got["spans"]["coverage"] == want["spans"]["coverage"] == 1.0
    assert got["serve"]["requests"] == want["serve"]["requests"] == 3


# ----------------------------------------------------------------- flight


def test_flight_recorder_ring_dump_and_registry_match_jax():
    """The ring keeps the newest entries with JAX's sequence numbers; a
    dump is JAX's record; registered rings answer ``dump_all`` and the
    watchdog's ``dump_flight``, unregistered ones do not."""
    out = []
    for mod, cls in ((flight, MetricsRegistry), (jax_flight, JaxRegistry)):
        reg, sink = _registry(cls)
        fr = mod.FlightRecorder(4, component="unit", registry=reg)
        for i in range(10):
            fr.record(tick=i, payload=i * 2)
        rec = dict(fr.dump("unit_test", attrs={"extra": 1}))
        rec.pop("dumped_at")
        out.append((fr.snapshot(), rec, fr.stats()))
        with pytest.raises(ValueError):
            mod.FlightRecorder(0)
    assert out[0] == out[1]
    snap, rec, _ = out[0]
    assert [e["seq"] for e in snap] == [7, 8, 9, 10]
    assert rec["depth"] == 4 and rec["dropped"] == 6 and rec["extra"] == 1

    reg, sink = _registry()
    fr = flight.FlightRecorder(2, registry=reg)
    fr.record(tick=1)
    flight.register(fr)
    try:
        assert flight.dump_all in watchdog.FLIGHT_DUMPS
        watchdog.dump_flight("drill")
        assert fr.dumps == 1 and sink.of("flight_dump")[-1]["reason"] == (
            "drill")
    finally:
        flight.unregister(fr)
    watchdog.dump_flight("after_unregister")
    assert fr.dumps == 1


def test_watchdog_stall_dumps_flight_with_stalled_tick(lms):
    """``replica_hang`` under an installed watchdog: a ``watchdog_stall``
    on ``serve_tick`` and a ``flight_dump`` whose last entry is the
    stalled busy tick."""
    _, model = lms
    reg, sink = _registry()
    prev_reg = set_registry(reg)
    server = InferenceServer(
        model, EngineConfig(num_slots=1, prompt_buckets=(8,),
                            max_new_tokens=12),
        device="cpu", queue_depth=8, registry=reg).start()
    wd = None
    try:
        warm = server.submit(_prompts([4], seed=1)[0], max_new_tokens=12)
        assert wait_until(warm.done.is_set, timeout=120)
        hang_tick = server.engine.busy_ticks + 3
        # the margin between an ordinary eager CPU tick (which can pass
        # 0.1 s on a loaded host) and the injected hang: a 1 s floor
        # under a 3 s hang
        wd = watchdog.Watchdog(stall_factor=5.0, min_stall_s=1.0,
                               hard_timeout_s=0)
        watchdog.set_watchdog(wd)
        set_plan(FaultPlan.parse(f"replica_hang:{hang_tick}:3.0"))
        req = server.submit(_prompts([4], seed=2)[0], max_new_tokens=8)
        assert wait_until(req.done.is_set, timeout=120)
        assert req.status == "done"
        assert wait_until(lambda: sink.of("flight_dump"), timeout=10)
    finally:
        if wd is not None:
            wd.close()
        server.close(drain=False)
        set_registry(prev_reg)
    stalls = sink.of("watchdog_stall")
    assert stalls and stalls[0]["section"] == "serve_tick"
    dumps = [r for r in sink.of("flight_dump")
             if r["reason"] == "watchdog_stall"]
    assert dumps and dumps[0]["entries"][-1]["busy_tick"] == hang_tick
    assert dumps[0]["component"] == "engine"
    assert any(r.get("fault") == "replica_hang"
               for r in sink.of("fault_injected"))


def test_debug_flight_endpoint(lms):
    """``GET /debug/flight`` returns the ring and leaves a
    ``flight_dump`` record."""
    _, model = lms
    reg, sink = _registry()
    server = InferenceServer(
        model, EngineConfig(num_slots=1, prompt_buckets=(8,),
                            max_new_tokens=4),
        device="cpu", queue_depth=4, registry=reg).start()
    httpd = make_http_server(server, ByteTokenizer())
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        req = server.submit(_prompts([4], seed=5)[0], max_new_tokens=4)
        assert wait_until(req.done.is_set, timeout=120)
        c = http.client.HTTPConnection("127.0.0.1", httpd.server_address[1],
                                       timeout=30)
        c.request("GET", "/debug/flight")
        resp = c.getresponse()
        assert resp.status == 200
        body = json.loads(resp.read())
        c.close()
    finally:
        httpd.shutdown()
        httpd.server_close()
        server.close(drain=False)
    assert body["entries"] and body["flight_dumps"] >= 1
    assert any(r["reason"] == "debug_endpoint"
               for r in sink.of("flight_dump"))


# -------------------------------------------------------------------- SLO


@pytest.mark.parametrize("good,total,objective", [
    (100, 100, 0.99), (99, 100, 0.99), (90, 100, 0.99), (0, 0, 0.99),
    (7, 11, 0.999), (0, 5, 0.5)])
def test_burn_rate_formula_matches_jax(good, total, objective):
    assert burn_rate(good, total, objective) == jax_slo.burn_rate(
        good, total, objective)


def test_burn_rate_formula():
    assert burn_rate(100, 100, 0.99) == 0.0
    assert burn_rate(99, 100, 0.99) == pytest.approx(1.0)
    assert burn_rate(90, 100, 0.99) == pytest.approx(10.0)
    assert burn_rate(0, 0, 0.99) == 0.0


def _monitor_run(mon_cls, cfg_cls, reg_cls):
    clock = FakeClock(1000.0)
    reg, sink = _registry(reg_cls)
    mon = mon_cls(cfg_cls(windows_s=(60.0, 600.0), deadline_objective=0.99,
                          availability_objective=0.999, emit_interval_s=5.0),
                  tiers=("interactive", "batch"), registry=reg,
                  now_fn=clock)
    seen = []
    for _ in range(10):
        mon.observe("interactive", available=True, deadline_met=True)
    mon.observe("interactive", available=False, deadline_met=None)
    mon.observe("batch", available=True, deadline_met=False)
    seen.append((mon.burn_rates(), mon.max_burn()))
    for dt in (3.0, 120.0, 600.0):
        clock.t += dt
        mon.observe("interactive", available=True)
        seen.append((mon.burn_rates(), mon.max_burn()))
    mon.observe("mystery", available=True)
    seen.append(mon.stats())
    records = [{k: v for k, v in r.items() if k != "ts"}
               for r in sink.of("slo_burn")]
    return seen, records, reg.snapshot()["gauges"]


def test_burn_rate_monitor_windows_prune_and_throttle_match_jax():
    """The same outcomes on the same injected clock: equal burn rates in
    every window, equal pruning, the same throttled ``slo_burn`` records
    and gauge."""
    got = _monitor_run(BurnRateMonitor, SloConfig, MetricsRegistry)
    want = _monitor_run(jax_slo.BurnRateMonitor, jax_slo.SloConfig,
                        JaxRegistry)
    assert got == want
    first = got[0][0][0]["interactive"]["60s"]
    assert first["requests"] == 11 and first["deadline_requests"] == 10
    assert first["availability_burn"] == pytest.approx((1 / 11) / 0.001)
    assert len(got[1]) == 3  # throttled: at 1000, 1123 and 1723
    with pytest.raises(ValueError):
        SloConfig(windows_s=(600.0, 60.0))


# --------------------------------------------------------------- brownout


def _ladder(cls, pressures, dts, reg_cls=None, **kw):
    clock = FakeClock()
    reg, sink = _registry(reg_cls) if reg_cls else (None, None)
    br = cls(now_fn=clock, registry=reg, **kw)
    levels = []
    for p, dt in zip(pressures, dts):
        levels.append(br.observe(p))
        clock.t += dt
    trans = [] if sink is None else [
        {k: v for k, v in r.items() if k != "ts"}
        for r in sink.of("brownout_transition")]
    return levels, trans, br.stats(), br.clamp(64), [
        br.sheds(t) for t in ("batch", "interactive")]


LADDERS = {
    "escalate-recover": ([0.9] * 8 + [0.1] * 14, [0.55] * 8 + [1.05] * 14,
                         dict(high_watermark=0.8, low_watermark=0.3,
                              escalate_hold_s=1.0, deescalate_hold_s=2.0,
                              clamp_max_new=8)),
    "walk-up": ([1.0] * 8, [0.6] * 8,
                dict(escalate_hold_s=0.5, deescalate_hold_s=0.5)),
    "flapping": ([0.9, 0.5, 0.9, 0.5, 0.9, 0.1, 0.5, 0.1] * 3, [0.4] * 24,
                 dict(escalate_hold_s=1.0, deescalate_hold_s=1.0)),
    "clamp": ([1.0] * 4 + [0.0] * 4, [0.6] * 8,
              dict(escalate_hold_s=0.5, deescalate_hold_s=0.5,
                   clamp_max_new=16)),
}


@pytest.mark.parametrize("name", sorted(LADDERS))
def test_brownout_ladder_matches_jax(name):
    """The port's controller and JAX's on the same pressure sequence and
    clock: the same level every sample, the same transition records,
    stats, clamp and shed answers."""
    pressures, dts, kw = LADDERS[name]
    got = _ladder(BrownoutController, pressures, dts, MetricsRegistry, **kw)
    want = _ladder(JaxBrownout, pressures, dts, JaxRegistry, **kw)
    assert got == want
    if name == "escalate-recover":
        assert got[0][:8] == [0, 0, 1, 1, 2, 2, 3, 3] and got[0][-1] == 0
        assert [(t["from"], t["to"]) for t in got[1]] == [
            ("normal", "shed_batch"), ("shed_batch", "clamp"),
            ("clamp", "fail_fast"), ("fail_fast", "clamp"),
            ("clamp", "shed_batch"), ("shed_batch", "normal")]
    if name == "flapping":
        assert set(got[0]) == {0}


def test_brownout_batch_sheds_before_any_interactive_rejection():
    clock = FakeClock()
    br = BrownoutController(escalate_hold_s=0.5, deescalate_hold_s=0.5,
                            now_fn=clock)
    seen = [(br.level_name(), br.sheds("batch"), br.sheds("interactive"))]
    while br.level < len(BROWNOUT_LEVELS) - 1:
        prev = br.level
        br.observe(1.0)
        clock.t += 0.6
        if br.level != prev:
            seen.append((br.level_name(), br.sheds("batch"),
                         br.sheds("interactive")))
    assert seen == [("normal", False, False), ("shed_batch", True, False),
                    ("clamp", True, False), ("fail_fast", True, True)]
    with pytest.raises(ValueError):
        BrownoutController(high_watermark=0.3, low_watermark=0.5)
    with pytest.raises(ValueError):
        BrownoutController(clamp_max_new=0)


def test_slo_coupling_is_default_off_and_opt_in_as_jax():
    """A burning monitor moves the ladder only with ``slo_burn_high > 0``,
    as JAX's."""
    import types

    out = []
    for cls in (BrownoutController, JaxBrownout):
        burning = types.SimpleNamespace(max_burn=lambda now=None: 50.0)
        clock = FakeClock()
        off = cls(high_watermark=0.8, low_watermark=0.3, escalate_hold_s=0.5,
                  deescalate_hold_s=0.5, now_fn=clock, slo_monitor=burning)
        on = cls(high_watermark=0.8, low_watermark=0.3, escalate_hold_s=0.5,
                 deescalate_hold_s=0.5, now_fn=clock, slo_monitor=burning,
                 slo_burn_high=2.0)
        levels = []
        for _ in range(3):
            levels.append((off.observe(0.0), on.observe(0.0)))
            clock.t += 0.6
        burning.max_burn = lambda now=None: 0.0
        for _ in range(3):
            levels.append((off.observe(0.0), on.observe(0.0)))
            clock.t += 0.6
        out.append(levels)
    assert out[0] == out[1]
    assert max(o for o, _ in out[0]) == 0 and max(n for _, n in out[0]) >= 1
    assert out[0][-1] == (0, 0)
