"""Port parity, the serving fleet end to end (``serve/fleet.py``,
``serve/router.py``, ``cli/fleet_lm.py``): real ``serve_lm`` replicas of
the port (gpt2-tiny, random weights from the seed, ``--device cpu``)
under the fleet supervisor. ``replica_crash`` kills one mid-load: every
request ends ``done`` or with an explicit retryable error, every ``done``
stream equals a single port server's for the same prompt, the router
records the failover, the dead replica respawns with one restart burned
and ``summarize_metrics`` folds the stream. SIGTERM to a streaming
replica finishes the stream, exits 75 and burns no restart; so does a
``--tp 2`` replica (two gloo ranks the fleet spawns, its exit status the
leader's), whose lost bind race is a port retry. ``fleet_lm`` and
``serve_lm`` parse JAX's options with JAX's defaults."""

import http.client
import json
import os
import socket
import subprocess
import sys
import threading

import chip_smoke
import pytest

from pytorch_distributed_training_tpu.cli.fleet_lm import (
    build_parser as jax_fleet_parser,
)
from pytorch_distributed_training_tpu.cli.serve_lm import (
    build_parser as jax_serve_parser,
)
from pytorch_distributed_training_tpu_torch.cli import fleet_lm, serve_lm
from pytorch_distributed_training_tpu_torch.serve import make_http_server
from pytorch_distributed_training_tpu_torch.serve.fleet import (
    FleetConfig,
    ServeFleet,
    split_fault_specs,
)
from pytorch_distributed_training_tpu_torch.serve.router import (
    RouterConfig,
    make_router_http_server,
)
from pytorch_distributed_training_tpu_torch.serve.server import wait_until
from pytorch_distributed_training_tpu_torch.telemetry.registry import (
    MetricsRegistry,
)

pytestmark = [pytest.mark.serve, pytest.mark.chaos]

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

REPLICA_ARGS = (
    "--model", "gpt2-tiny", "--device", "cpu", "--num-slots", "2",
    "--prompt-buckets", "16,32", "--max-new-tokens-cap", "64",
    "--queue-depth", "16", "--stall-timeout-s", "10",
)


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


def _registry():
    reg, sink = MetricsRegistry(), ListSink()
    reg.attach_sink(sink)
    return reg, sink


@pytest.fixture(autouse=True)
def _one_thread_replicas(monkeypatch):
    # each replica process, and the in-process reference, on few threads
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.delenv("PDT_TPU_FAULT", raising=False)


def _fleet(num_replicas, registry, fault_env=None):
    return ServeFleet(
        FleetConfig(num_replicas=num_replicas, replica_args=REPLICA_ARGS,
                    fault_env=fault_env or {}, max_restarts=1,
                    backoff_s=0.2, drain_timeout_s=20.0),
        RouterConfig(health_interval_s=0.05, health_timeout_s=1.0,
                     breaker_threshold=3, breaker_cooldown_s=0.5,
                     retry_backoff_s=0.02, retry_backoff_max_s=0.1,
                     ttfb_timeout_s=60.0),
        registry=registry)


def _serve_http(httpd):
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd.server_address[1]


def _post_generate(port, prompt, max_new, rid, timeout=120):
    """One client request; a dict classifying the outcome (never raises,
    never hangs past ``timeout``)."""
    try:
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
        conn.request("POST", "/generate", body=json.dumps(
            {"prompt": prompt, "max_new_tokens": max_new}),
            headers={"X-Request-Id": rid})
        resp = conn.getresponse()
        if resp.status != 200:
            retry_after = resp.getheader("Retry-After")
            resp.read()
            conn.close()
            return {"outcome": "rejected", "status": resp.status,
                    "retry_after": retry_after}
        events = [json.loads(x) for x in resp.read().decode().splitlines()]
        conn.close()
        last = events[-1] if events else {}
        tokens = [e["token_id"] for e in events if e["event"] == "token"]
        if last.get("event") == "done":
            return {"outcome": "done", "tokens": tokens}
        if last.get("event") == "error" and last.get("retryable"):
            return {"outcome": "retryable_error", "tokens": tokens}
        return {"outcome": "bad", "events": events}
    except Exception as e:  # noqa: BLE001 - drill diagnostics
        return {"outcome": "exception", "error": repr(e)}


def _reference_streams(prompts, max_new):
    """The same prompts through one in-process port server built as a
    replica builds its own (``serve_lm.build_server``: same seed, same
    weights), over HTTP."""
    args = serve_lm.build_parser().parse_args(list(REPLICA_ARGS))
    server, tok = serve_lm.build_server(args)
    server.start()
    httpd = make_http_server(server, tok)
    port = _serve_http(httpd)
    try:
        return [_post_generate(port, p, max_new, f"ref-{i}")["tokens"]
                for i, p in enumerate(prompts)]
    finally:
        httpd.shutdown()
        httpd.server_close()
        server.close(drain=False)


def test_fleet_replica_crash_mid_load_fails_over(tmp_path):
    reg, sink = _registry()
    fleet = _fleet(2, reg, fault_env={0: "replica_crash:6"}).start()
    prompts = [f"request number {i}" for i in range(8)]
    httpd = None
    try:
        assert fleet.wait_ready(timeout=120), fleet.stats()
        httpd = make_router_http_server(fleet.router)
        port = _serve_http(httpd)
        results = [None] * len(prompts)

        def run(i):
            results[i] = _post_generate(port, prompts[i], 8, f"drill-{i}")

        threads = [threading.Thread(target=run, args=(i,), daemon=True)
                   for i in range(len(prompts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(180)
        # zero hung waiters, every outcome terminal and explicit
        assert not any(t.is_alive() for t in threads)
        outcomes = [r["outcome"] for r in results]
        assert all(o in ("done", "retryable_error", "rejected")
                   for o in outcomes), results
        assert outcomes.count("done") >= 1
        crashes = [r for r in sink.of("replica_exit") if not r["graceful"]]
        assert crashes and crashes[0]["replica"] == "r0"
        assert crashes[0]["rc"] == 23       # REPLICA_CRASH_EXIT_CODE
        counters = reg.snapshot()["counters"]
        assert (counters.get("router/failovers", 0)
                + counters.get("router/midstream_errors", 0)) >= 1, counters
        # supervision: r0 respawned, one restart burned, the pool back
        assert wait_until(
            lambda: fleet.replica(0).describe()["restarts_used"] == 1,
            timeout=60)
        assert fleet.wait_ready(timeout=120, min_replicas=2)
        post = _post_generate(port, "after recovery", 4, "drill-post")
        assert post["outcome"] == "done", post
    finally:
        if httpd is not None:
            httpd.shutdown()
            httpd.server_close()
        fleet.stop(drain=False)
    # every done stream is the single server's stream, token for token
    want = _reference_streams(prompts + ["after recovery"], 8)
    for i, r in enumerate(results + [post]):
        if r["outcome"] == "done":
            assert r["tokens"] == want[i][:len(r["tokens"])], i
            assert len(r["tokens"]) == (4 if i == len(prompts) else 8)
    assert post["tokens"] == want[-1][:4]

    stream = tmp_path / "metrics.jsonl"
    stream.write_text("".join(json.dumps(r) + "\n" for r in sink.records))
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts",
                                      "summarize_metrics.py"),
         str(stream), "--json"], capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr[-2000:]
    view = json.loads(proc.stdout)["fleet"]
    assert view["routed"] >= 9
    assert view["failovers"] + view["midstream_errors"] >= 1
    assert view["replicas"]["r0"]["crashes"] >= 1
    assert view["replicas"]["r0"]["spawns"] == 2


def test_fleet_failover_window_is_replica_1s_held_tick():
    """``chip_smoke.py``'s fleet wave and fault plan (replica 1's first
    busy tick held ``FLEET_HOLD_S``, then the replica killed) over the
    CPU, with a slow host's lag: 3 s between seeing the hold and the next
    request. A request still reaches replica 1 behind its held tick and
    fails over; every primer ends ``done`` with the first prompt's first
    token, every outcome is ``done`` or a retryable error, every ``done``
    stream the single server's; replica 1 exits 23."""
    reg, sink = _registry()
    # health polls as _fleet's, with a timeout a loaded host's replica
    # answers within (the window is the held tick, not the poll)
    fleet = ServeFleet(
        FleetConfig(num_replicas=2, replica_args=REPLICA_ARGS,
                    fault_env=split_fault_specs(chip_smoke.FLEET_FAULT),
                    max_restarts=1, backoff_s=0.2, drain_timeout_s=20.0),
        RouterConfig(health_interval_s=0.05, health_timeout_s=5.0,
                     breaker_threshold=3, breaker_cooldown_s=0.5,
                     retry_backoff_s=0.02, retry_backoff_max_s=0.1,
                     ttfb_timeout_s=60.0),
        registry=reg).start()
    prompts = [f"request number {i}" for i in range(12)]
    httpd = None
    try:
        assert fleet.wait_ready(timeout=120), fleet.stats()
        httpd = make_router_http_server(fleet.router)
        primers, outs = chip_smoke.fleet_wave(_serve_http(httpd), prompts,
                                              16, stall_s=3.0)
        assert wait_until(lambda: sink.of("replica_exit"), timeout=60)
        counters = reg.snapshot()["counters"]
    finally:
        if httpd is not None:
            httpd.shutdown()
            httpd.server_close()
        fleet.stop(drain=False)
    assert all(o["outcome"] in ("done", "retryable") for o in outs), outs
    assert counters.get("router/failovers", 0) >= 1, counters
    first_exit = sink.of("replica_exit")[0]
    assert (first_exit["replica"], first_exit["rc"]) == ("r1", 23)
    want = _reference_streams(prompts, 16)
    assert 1 <= len(primers) <= 2, primers
    assert all(o["outcome"] == "done" and o["tokens"] == want[0][:1]
               for o in primers), primers
    done = [i for i, o in enumerate(outs) if o["outcome"] == "done"]
    assert len(done) >= len(prompts) - 2, outs
    assert all(outs[i]["tokens"] == want[i] for i in done)


def test_fleet_sigterm_drains_in_flight_and_exits_75():
    reg, sink = _registry()
    fleet = _fleet(1, reg).start()
    httpd = None
    try:
        assert fleet.wait_ready(timeout=120), fleet.stats()
        httpd = make_router_http_server(fleet.router)
        port = _serve_http(httpd)
        events, client_done = [], threading.Event()

        def client():
            try:
                conn = http.client.HTTPConnection("127.0.0.1", port,
                                                  timeout=120)
                conn.request("POST", "/generate", body=json.dumps({
                    "prompt": "a long drain drill request",
                    "max_new_tokens": 64}),
                    headers={"X-Request-Id": "drain-1"})
                resp = conn.getresponse()
                while True:
                    line = resp.readline()
                    if not line:
                        break
                    events.append(json.loads(line))
                conn.close()
            finally:
                client_done.set()

        threading.Thread(target=client, daemon=True).start()
        replica = fleet.replica(0)
        first_pid = replica.proc.pid
        assert wait_until(lambda: len(events) >= 2, timeout=60), events
        replica.sigterm()
        # the in-flight stream completes: a drain finishes, never cancels
        assert client_done.wait(120)
        assert events[-1]["event"] == "done", events[-3:]
        assert events[-1]["new_tokens"] == 64
        assert wait_until(lambda: sink.of("replica_exit"), timeout=30)
        exit_rec = sink.of("replica_exit")[0]
        assert exit_rec["graceful"] is True and exit_rec["rc"] == 75
        assert sink.of("replica_drain")[0]["drain_s"] > 0
        # the router saw draining before the process left
        assert any(s["draining"] for s in sink.of("router_replica_state"))
        # no restart burned; the replica respawns as fresh capacity
        assert wait_until(
            lambda: fleet.replica(0).describe()["alive"]
            and fleet.replica(0).proc.pid != first_pid, timeout=90)
        d = fleet.replica(0).describe()
        assert d["restarts_used"] == 0 and d["graceful_exits"] == 1
        assert fleet.wait_ready(timeout=120)
    finally:
        if httpd is not None:
            httpd.shutdown()
            httpd.server_close()
        fleet.stop(drain=False)


def test_fleet_tp2_replica_port_retry_then_graceful_drain():
    """A ``--tp 2`` replica (gpt2-tiny, two gloo ranks): its first port is
    taken, so the leader exits 76 and the fleet retries on a fresh port
    (``replica_port_retry``, no restart burned); it serves a request; on
    SIGTERM (sent to both ranks) the leader drains and exits 75 —
    ``graceful: true``, no restart burned — and no rank is left behind."""
    reg, sink = _registry()
    fleet = ServeFleet(
        FleetConfig(num_replicas=1, replica_args=REPLICA_ARGS + ("--tp", "2"),
                    tp=2, max_restarts=1, backoff_s=0.2,
                    drain_timeout_s=20.0),
        RouterConfig(health_interval_s=0.05, health_timeout_s=1.0,
                     ttfb_timeout_s=60.0),
        registry=reg)
    replica = fleet.replica(0)
    taken = socket.socket()
    taken.bind(("127.0.0.1", replica.port))
    taken.listen(1)
    httpd = None
    try:
        fleet.start()
        assert wait_until(lambda: sink.of("replica_port_retry"),
                          timeout=120), sink.records
        taken.close()
        assert fleet.wait_ready(timeout=120), fleet.stats()
        httpd = make_router_http_server(fleet.router)
        out = _post_generate(_serve_http(httpd), "tensor parallel", 4, "tp")
        assert out["outcome"] == "done" and len(out["tokens"]) == 4, out
        group = replica.proc
        assert len(group.procs) == 2
        replica.sigterm()
        assert wait_until(lambda: sink.of("replica_exit"), timeout=90)
        (exit_rec,) = sink.of("replica_exit")[:1]
        assert exit_rec["graceful"] is True and exit_rec["rc"] == 75
        assert all(p.poll() is not None for p in group.procs)
        d = replica.describe()
        assert d["restarts_used"] == 0 and d["graceful_exits"] == 1
        assert d["port_retries"] >= 1
        retry = sink.of("replica_port_retry")[0]
        assert retry["replica"] == "r0" and retry["new_port"] != retry[
            "old_port"]
    finally:
        taken.close()
        if httpd is not None:
            httpd.shutdown()
            httpd.server_close()
        fleet.stop(drain=False)
    assert all(p.poll() is not None for p in replica.proc.procs)


def _options(parser):
    return {opt: (a.default, a.choices, a.type, a.nargs)
            for a in parser._actions for opt in a.option_strings}


def test_fleet_lm_and_serve_lm_parse_jax_options():
    got, want = _options(fleet_lm.build_parser()), _options(
        jax_fleet_parser())
    assert set(got) - set(want) == {"--device"}
    assert got["--device"][:2] == ("cuda", ("cuda", "cpu"))
    del got["--device"]
    assert got == want
    assert len([o for o in got if o.startswith("--")]) == 37 + 6 + 1
    got, want = _options(serve_lm.build_parser()), _options(
        jax_serve_parser())
    # --prefill-concurrency came to the port's serve_lm with chunked
    # prefill; --device is the port's own
    assert set(got) - set(want) == {"--device", "--prefill-concurrency"}
    for opt in ("--device", "--prefill-concurrency"):
        del got[opt]
    assert got == want
    assert got["--guards"][:2] == (None, ("off", "record", "strict"))
    assert got["--lock-summary-s"][0] == 0.0
