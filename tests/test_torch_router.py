"""Port parity, the router (``serve/router.py``) and the fleet's fault
routing: the circuit breaker's transitions against JAX's under an
injected clock, ``split_fault_specs`` against JAX's, and every routing
scenario of the JAX package's fleet tests run against both routers over
the same stub replicas — tiny in-test HTTP servers whose failure is a
switch (refused, reset before a byte, death mid-stream, busy, slow first
byte, unhealthy, draining). Status codes, ``Retry-After``, request ids,
failovers, hedges, picks and breaker states must agree."""

import http.client
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

from pytorch_distributed_training_tpu.serve import fleet as jax_fleet
from pytorch_distributed_training_tpu.serve import router as jax_router
from pytorch_distributed_training_tpu.telemetry.registry import (
    MetricsRegistry as JaxMetricsRegistry,
)
from pytorch_distributed_training_tpu_torch.serve import fleet, router
from pytorch_distributed_training_tpu_torch.serve.server import wait_until
from pytorch_distributed_training_tpu_torch.telemetry.registry import (
    MetricsRegistry,
)

pytestmark = [pytest.mark.serve, pytest.mark.chaos]

IMPLS = {"port": (router, fleet, MetricsRegistry),
         "jax": (jax_router, jax_fleet, JaxMetricsRegistry)}


class ListSink:
    def __init__(self):
        self.records = []
        self._lock = threading.Lock()

    def emit(self, record):
        with self._lock:
            self.records.append(dict(record))

    def flush(self, **kw):
        pass

    def of(self, kind):
        with self._lock:
            return [r for r in self.records if r.get("record") == kind]


def _registry(impl):
    reg, sink = IMPLS[impl][2](), ListSink()
    reg.attach_sink(sink)
    return reg, sink


class FakeClock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


# ------------------------------------------------------------ breaker


def _breaker_script(mod):
    clock = FakeClock()
    seen = []
    br = mod.CircuitBreaker(threshold=3, cooldown_s=2.0, now_fn=clock,
                            on_transition=lambda a, b: seen.append((a, b)))
    out = [br.allow_probe()]
    for _ in range(3):
        br.record_failure()
        out.append((br.state, br.failures))
    out += [br.allow_probe(), br.reopen_in()]
    clock.t += 2.5
    out += [br.allow_probe(), br.state]
    br.record_failure()                 # the half-open probe failed
    out += [br.state, br.allow_probe(), br.reopen_in()]
    clock.t += 2.1
    out += [br.allow_probe(), br.state]
    br.record_success()
    out += [br.state, br.failures, br.transitions, br.reopen_in()]
    return out, seen


def test_breaker_transitions_match_jax():
    got, want = _breaker_script(router), _breaker_script(jax_router)
    assert got == want
    assert got[1] == [("closed", "open"), ("open", "half_open"),
                      ("half_open", "open"), ("open", "half_open"),
                      ("half_open", "closed")]
    assert got[0][-4:] == ["closed", 0, 5, None]


SPECS = [
    "replica_crash:5@1,replica_slow:2:4x,crash_at_step:3,"
    "replica_hang:1:0.2@1",
    None, "", "  ", "crash_at_step:3",
    "corrupt_ckpt_swap:2,swap_crash:0,swap_slow:3:0.5",
    "corrupt_ckpt_swap:2@0,corrupt_ckpt_swap:2@1,swap_slow:3@2",
    "replica_crash:3@0, ,replica_hang:2:1.0@0,sigterm_at_step:4@1",
]


@pytest.mark.parametrize("spec", SPECS)
def test_split_fault_specs_matches_jax(spec):
    got = fleet.split_fault_specs(spec)
    assert got == jax_fleet.split_fault_specs(spec)
    if spec and spec.startswith("replica_crash:5@1"):
        assert got == {1: "replica_crash:5,replica_hang:1:0.2",
                       0: "replica_slow:2:4x"}


# ------------------------------------------------------- stub replicas


class StubReplica:
    """A replica-shaped HTTP server whose behaviour is a switch.

    ``mode``: "ok" (stream ``tokens`` then done), "reset" (close before
    any byte), "mid_stream" (2 tokens then close, no done), "busy" (429 +
    Retry-After), "slow" (sleep ``ttfb_s`` then stream). ``health``:
    "ready" | "draining" | "unhealthy" | "dead" (nothing listening)."""

    def __init__(self, *, mode="ok", health="ready", tokens=3, ttfb_s=0.0,
                 queue_depth=0):
        stub = self
        self.mode, self.health, self.tokens = mode, health, tokens
        self.ttfb_s, self.queue_depth = ttfb_s, queue_depth
        self.generate_hits = 0
        self.rids = []

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.0"

            def log_message(self, fmt, *args):
                pass

            def _json(self, code, obj, headers=None):
                body = (json.dumps(obj) + "\n").encode()
                self.send_response(code)
                self.send_header("Content-Length", str(len(body)))
                for k, v in (headers or {}).items():
                    self.send_header(k, str(v))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                self._json(200 if stub.health == "ready" else 503, {
                    "state": stub.health, "queue_depth": stub.queue_depth,
                    "slot_occupancy": 0.0, "num_slots": 1})

            def do_POST(self):
                stub.generate_hits += 1
                rid = self.headers.get("X-Request-Id", "?")
                stub.rids.append(rid)
                if stub.mode == "reset":
                    self.wfile.close()
                    return
                if stub.mode == "busy":
                    self._json(429, {"error": "full"},
                               headers={"Retry-After": 1})
                    return
                if stub.mode == "slow":
                    time.sleep(stub.ttfb_s)
                self.send_response(200)
                self.end_headers()
                n = 2 if stub.mode == "mid_stream" else stub.tokens
                for i in range(n):
                    self.wfile.write((json.dumps({
                        "id": rid, "event": "token", "token_id": i,
                    }) + "\n").encode())
                    self.wfile.flush()
                if stub.mode == "mid_stream":
                    self.wfile.close()
                    return
                self.wfile.write((json.dumps({
                    "id": rid, "event": "done", "status": "done",
                    "new_tokens": n}) + "\n").encode())

        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.port = self.httpd.server_address[1]
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        daemon=True)
        if health != "dead":
            self._thread.start()

    def close(self):
        if self._thread.is_alive():
            self.httpd.shutdown()
        self.httpd.server_close()


def _make_router(impl, stubs, registry, **cfg_kw):
    mod = IMPLS[impl][0]
    cfg = mod.RouterConfig(**{
        "health_interval_s": 0.03, "health_timeout_s": 0.5,
        "breaker_threshold": 3, "breaker_cooldown_s": 0.25,
        "retry_backoff_s": 0.01, "retry_backoff_max_s": 0.05,
        "ttfb_timeout_s": 5.0, **cfg_kw})
    return mod.Router(
        [(f"s{i}", "127.0.0.1", s.port) for i, s in enumerate(stubs)],
        cfg, registry=registry)


def _route(rt, rid):
    lines = []
    out = rt.route_generate(json.dumps({"prompt": "x"}).encode(), rid,
                            lambda b: lines.append(json.loads(b)))
    return out, lines


def _in_rotation(rt, n):
    assert wait_until(lambda: rt.available_count() >= n, timeout=10), (
        rt.stats())


def _post(port, body, headers=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    conn.request("POST", "/generate", body=json.dumps(body),
                 headers=headers or {})
    resp = conn.getresponse()
    raw = resp.read()
    conn.close()
    return resp, raw


def _get(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    conn.request("GET", path)
    resp = conn.getresponse()
    raw = resp.read()
    conn.close()
    return resp, json.loads(raw)


def scenario_all_down(impl):
    """Nothing listening: breakers open fast and a request fails fast
    with 503 + Retry-After and the request id, never a hang."""
    mod, fleet_mod, _ = IMPLS[impl]
    reg, sink = _registry(impl)
    rt = mod.Router(
        [("a", "127.0.0.1", fleet_mod.find_free_port()),
         ("b", "127.0.0.1", fleet_mod.find_free_port())],
        mod.RouterConfig(health_interval_s=0.03, health_timeout_s=0.3,
                         breaker_threshold=2, breaker_cooldown_s=30.0),
        registry=reg).start()
    httpd = mod.make_router_http_server(rt)
    port = httpd.server_address[1]
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        assert wait_until(lambda: all(r.breaker.state == "open"
                                      for r in rt.replicas), timeout=10)
        t0 = time.monotonic()
        resp, raw = _post(port, {"prompt": "hi"},
                          {"X-Request-Id": "down-1"})
        elapsed = time.monotonic() - t0
        hz, hz_body = _get(port, "/healthz")
        return {
            "status": resp.status, "fast": elapsed < 5.0,
            "retry_after": int(resp.getheader("Retry-After")),
            "rid": resp.getheader("X-Request-Id"),
            "body": json.loads(raw),
            "healthz": (hz.status, hz_body, int(hz.getheader("Retry-After"))),
            "last": sink.of("router_request")[-1]["status"],
            "rejected": rt.rejected,
            "breakers": sorted(r["to"] for r in sink.of("router_breaker")),
        }
    finally:
        httpd.shutdown()
        httpd.server_close()
        rt.close()


def _two(impl, a_kw, b_kw, rid, **cfg_kw):
    reg, sink = _registry(impl)
    a, b = StubReplica(**a_kw), StubReplica(**b_kw)
    rt = _make_router(impl, [a, b], reg, **cfg_kw).start()
    try:
        _in_rotation(rt, 2)
        t0 = time.monotonic()
        out, lines = _route(rt, rid)
        elapsed = time.monotonic() - t0
        return {
            "out": out, "lines": lines, "failovers": rt.failovers,
            "hedges": rt.hedges, "hits": (a.generate_hits,
                                          b.generate_hits > 0),
            "breakers": [r.breaker.state for r in rt.replicas],
            "failover_records": [{k: v for k, v in r.items() if k != "ts"}
                                 for r in sink.of("router_failover")],
            "hedge_records": [{k: v for k, v in r.items() if k != "ts"}
                              for r in sink.of("router_hedge")],
            "request": {k: v for k, v in sink.of("router_request")[-1].items()
                        if k not in ("ts", "total_s")},
            "counters": reg.snapshot()["counters"],
            "fast": elapsed < 2.5,
        }
    finally:
        rt.close()
        a.close()
        b.close()


def scenario_failover_before_first_byte(impl):
    return _two(impl, dict(mode="reset", queue_depth=0),
                dict(mode="ok", tokens=3, queue_depth=5), "req-1")


def scenario_mid_stream_error(impl):
    return _two(impl, dict(mode="mid_stream", queue_depth=0),
                dict(mode="ok", queue_depth=5), "req-2")


def scenario_busy_retry(impl):
    return _two(impl, dict(mode="busy", queue_depth=0),
                dict(mode="ok", queue_depth=5), "req-3")


def scenario_hedge(impl):
    return _two(impl, dict(mode="slow", ttfb_s=3.0, queue_depth=0),
                dict(mode="ok", tokens=2, queue_depth=5), "req-4",
                hedge_s=0.1)


def scenario_breaker_trip_and_recover(impl):
    reg, sink = _registry(impl)
    a = StubReplica()
    rt = _make_router(impl, [a], reg, breaker_cooldown_s=0.2).start()
    try:
        _in_rotation(rt, 1)
        a.health = "unhealthy"
        assert wait_until(lambda: rt.replicas[0].breaker.state == "open",
                          timeout=10)
        out = rt.pick()
        a.health = "ready"
        assert wait_until(lambda: rt.replicas[0].breaker.state == "closed",
                          timeout=10)
        seq = {(r["from"], r["to"]) for r in sink.of("router_breaker")}
        return {"pick_open": out, "pick_closed": rt.pick().name,
                "seen": seq >= {("closed", "open"), ("open", "half_open"),
                                ("half_open", "closed")}}
    finally:
        rt.close()
        a.close()


def scenario_draining(impl):
    reg, sink = _registry(impl)
    a = StubReplica()
    rt = _make_router(impl, [a], reg).start()
    try:
        _in_rotation(rt, 1)
        a.health = "draining"
        assert wait_until(lambda: rt.replicas[0].draining, timeout=10)
        states = sink.of("router_replica_state")
        return {"pick": rt.pick(), "breaker": rt.replicas[0].breaker.state,
                "last_state": {k: v for k, v in states[-1].items()
                               if k != "ts"},
                "available": rt.available_count()}
    finally:
        rt.close()
        a.close()


def scenario_pick_least_loaded(impl):
    stubs = [StubReplica(queue_depth=d) for d in (0, 4, 0)]
    rt = _make_router(impl, stubs, _registry(impl)[0])
    try:
        for i, r in enumerate(rt.replicas):     # hand-fed health samples
            r.health = {"queue_depth": [0, 4, 0][i], "slot_occupancy": 0.0,
                        "num_slots": 1}
            r.last_ready_t = time.monotonic()
        picks = [rt.pick().name for _ in range(8)]
        return {"picks": picks,
                "excluded": rt.pick(exclude=frozenset({"s0", "s2"})).name,
                "none": rt.pick(exclude=frozenset({"s0", "s1", "s2"})),
                "loads": [r.load() for r in rt.replicas]}
    finally:
        for s in stubs:
            s.close()


def scenario_request_id_over_http(impl):
    """The router's HTTP front end: the client's X-Request-Id reaches the
    replica, every streamed event and the response header; /stats
    carries the counters."""
    mod = IMPLS[impl][0]
    reg, sink = _registry(impl)
    a = StubReplica(tokens=2)
    rt = _make_router(impl, [a], reg).start()
    httpd = mod.make_router_http_server(rt)
    port = httpd.server_address[1]
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        _in_rotation(rt, 1)
        resp, raw = _post(port, {"prompt": "x"}, {"X-Request-Id": "rid-7"})
        events = [json.loads(line) for line in raw.decode().splitlines()]
        resp2, raw2 = _post(port, {"prompt": "y", "id": "body-id"})
        stats = _get(port, "/stats")[1]
        return {"status": resp.status, "header": resp.getheader(
                    "X-Request-Id"), "ids": [e["id"] for e in events],
                "stub_rids": a.rids, "body_id": resp2.getheader(
                    "X-Request-Id"),
                "stats": {k: stats[k] for k in ("available", "routed",
                                                "failovers", "hedges",
                                                "rejected",
                                                "version_skew")},
                "stats_keys": sorted(stats),
                "records": len(sink.of("router_request"))}
    finally:
        httpd.shutdown()
        httpd.server_close()
        rt.close()
        a.close()


SCENARIOS = {f.__name__[len("scenario_"):]: f for f in (
    scenario_all_down, scenario_failover_before_first_byte,
    scenario_mid_stream_error, scenario_busy_retry, scenario_hedge,
    scenario_breaker_trip_and_recover, scenario_draining,
    scenario_pick_least_loaded, scenario_request_id_over_http)}

EXPECT = {
    "all_down": lambda g: (
        g["status"] == 503 and g["fast"] and g["retry_after"] >= 1
        and g["rid"] == "down-1" and g["body"]["error"] ==
        "no replica available" and g["healthz"][0] == 503
        and g["healthz"][1] == {"state": "unavailable", "available": 0}
        and g["last"] == "rejected"),
    "failover_before_first_byte": lambda g: (
        g["out"]["status"] == "ok" and g["out"]["replica"] == "s1"
        and g["out"]["attempts"] == 2 and g["lines"][-1]["event"] == "done"
        and len([x for x in g["lines"] if x["event"] == "token"]) == 3
        and g["failovers"] == 1 and g["failover_records"][0]["to"] == "s1"
        and g["request"]["attempts"] == 2),
    "mid_stream_error": lambda g: (
        g["out"]["status"] == "error_midstream"
        and g["out"]["attempts"] == 1 and g["lines"][-1]["event"] == "error"
        and g["lines"][-1]["retryable"] is True
        and [x["event"] for x in g["lines"][:-1]] == ["token", "token"]
        and g["hits"] == (1, False)),
    "busy_retry": lambda g: (
        g["out"]["status"] == "ok" and g["out"]["replica"] == "s1"
        and g["breakers"] == ["closed", "closed"]),
    "hedge": lambda g: (
        g["out"]["status"] == "ok" and g["out"]["hedged"] is True
        and g["out"]["replica"] == "s1" and g["fast"] and g["hedges"] == 1
        and g["hedge_records"][0]["primary"] == "s0"),
    "breaker_trip_and_recover": lambda g: (
        g["pick_open"] is None and g["pick_closed"] == "s0" and g["seen"]),
    "draining": lambda g: (
        g["pick"] is None and g["breaker"] == "closed"
        and g["last_state"]["draining"] is True),
    "pick_least_loaded": lambda g: (
        set(g["picks"]) == {"s0", "s2"} and g["excluded"] == "s1"
        and g["none"] is None),
    "request_id_over_http": lambda g: (
        g["status"] == 200 and g["header"] == "rid-7"
        and set(g["ids"]) == {"rid-7"} and g["stub_rids"][0] == "rid-7"
        and g["body_id"] == "body-id" and g["stats"]["routed"] == 2),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_router_scenario_matches_jax(name):
    got = SCENARIOS[name]("port")
    want = SCENARIOS[name]("jax")
    assert EXPECT[name](got), got
    assert got == want
