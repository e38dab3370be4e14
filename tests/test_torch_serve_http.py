"""Port parity, the serving front end: drain, the HTTP server (streamed
``/generate`` against the JAX server's events, 400/429/503 with
``Retry-After`` and ``X-Request-Id``, ``/healthz`` states and the stall
rule, brownout admission), ``retry_after_estimate``, deadline expiries by
phase, the watchdog sections, warm-up that leaves no trace (a warmed
engine's streams equal a cold one's), the twenty ``serve_lm`` service
flags with JAX's defaults, and ``serve_lm`` as a subprocess: the SIGTERM
drain (exit 75) and the ``replica_crash`` / ``replica_hang`` /
``replica_slow`` faults with JAX's exit codes and records
(``--device cpu``)."""

import contextlib
import http.client
import io
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_training_tpu.cli.serve_lm import (
    build_parser as jax_parser,
)
from pytorch_distributed_training_tpu.data.bpe import (
    ByteTokenizer as JaxByteTokenizer,
)
from pytorch_distributed_training_tpu.models.gpt2 import GPT2LMModel as JaxGPT2
from pytorch_distributed_training_tpu.serve import (
    EngineConfig as JaxEngineConfig,
)
from pytorch_distributed_training_tpu.serve import (
    InferenceServer as JaxServer,
)
from pytorch_distributed_training_tpu.serve import (
    make_http_server as jax_http,
)
from pytorch_distributed_training_tpu.serve import server as jax_server_mod
from pytorch_distributed_training_tpu.serve.server import wait_until
from pytorch_distributed_training_tpu.utils.config import (
    model_preset as jax_preset,
)
from pytorch_distributed_training_tpu_torch.cli.serve_lm import build_parser
from pytorch_distributed_training_tpu_torch.data.bpe import ByteTokenizer
from pytorch_distributed_training_tpu_torch.faults import watchdog
from pytorch_distributed_training_tpu_torch.faults.inject import (
    REPLICA_CRASH_EXIT_CODE,
    FaultPlan,
    set_plan,
)
from pytorch_distributed_training_tpu_torch.faults.preemption import (
    RESUMABLE_EXIT_CODE,
)
from pytorch_distributed_training_tpu_torch.models.convert import (
    params_from_jax,
)
from pytorch_distributed_training_tpu_torch.models.gpt2 import GPT2LMModel
from pytorch_distributed_training_tpu_torch.serve import (
    BrownoutController,
    EngineConfig,
    InferenceServer,
    make_http_server,
)
from pytorch_distributed_training_tpu_torch.serve import server as server_mod
from pytorch_distributed_training_tpu_torch.telemetry.registry import (
    MetricsRegistry,
)
from pytorch_distributed_training_tpu_torch.utils.config import model_preset

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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


@pytest.fixture(scope="module")
def lms():
    cfg = jax_preset("gpt2-tiny", compute_dtype="float32",
                     attention_impl="reference", hidden_dropout=0.0,
                     attention_dropout=0.0)
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


def _prompts(lengths, seed=0, vocab=1024):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, n).astype(np.int32) for n in lengths]


def _server(model, reg=None, **kw):
    engine = dict(num_slots=1, prompt_buckets=(8, 16), max_new_tokens=8)
    engine.update(kw.pop("engine", {}))
    return InferenceServer(model, EngineConfig(**engine), device="cpu",
                           queue_depth=kw.pop("queue_depth", 4),
                           registry=reg, **kw)


def _http(server, tok=None, factory=make_http_server):
    httpd = factory(server, tok or ByteTokenizer())
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, httpd.server_address[1]


def _request(port, method, path, body=None, headers=None, timeout=60):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    conn.request(method, path,
                 body=None if body is None else json.dumps(body),
                 headers=headers or {})
    resp = conn.getresponse()
    raw = resp.read().decode()
    conn.close()
    return resp, raw


# ------------------------------------------------------------ in process


def test_drain_shutdown_finishes_in_flight(lms):
    _, model = lms
    server = _server(model).start()
    reqs = [server.submit(p, max_new_tokens=8)
            for p in _prompts([4, 4, 4], seed=9)]
    server.close(drain=True)
    assert all(r.done.is_set() and r.status == "done" for r in reqs)
    assert all(len(r.tokens) == 8 for r in reqs)
    assert server.health()["state"] == "draining"
    with pytest.raises(RuntimeError):
        server.submit(_prompts([4])[0], max_new_tokens=2)


def test_http_front_end_matches_jax(lms):
    """``/healthz``, 429 on a full queue, 400 on a bad prompt, and a
    streamed ``/generate`` whose event lines equal the JAX server's."""
    (jmodel, params), model = lms
    cfg = dict(num_slots=1, prompt_buckets=(16,), max_new_tokens=8)
    port_server = InferenceServer(model, EngineConfig(**cfg), device="cpu",
                                  queue_depth=1)
    jax_server = JaxServer(jmodel, params, JaxEngineConfig(**cfg),
                           queue_depth=1)
    streams = []
    for server, tok, factory in (
            (port_server, ByteTokenizer(), make_http_server),
            (jax_server, JaxByteTokenizer(), jax_http)):
        httpd, port = _http(server, tok, factory)
        try:
            assert _request(port, "GET", "/healthz")[0].status == 200
            filler = server.submit(np.arange(1, 5, dtype=np.int32),
                                   max_new_tokens=2)
            resp, _ = _request(port, "POST", "/generate", {"prompt": "hi"})
            assert resp.status == 429 and resp.getheader("Retry-After")
            assert resp.getheader("X-Request-Id")
            resp, _ = _request(port, "POST", "/generate", {"prompt": 123})
            assert resp.status == 400
            resp, _ = _request(port, "POST", "/generate",
                               {"prompt": "hi", "tier": "bulk"})
            assert resp.status == 400
            while not filler.done.is_set():
                server.engine.tick()
            server.start()
            resp, raw = _request(port, "POST", "/generate",
                                 {"prompt": "hello", "max_new_tokens": 3},
                                 headers={"X-Request-Id": "trace-me"})
            assert resp.status == 200
            assert resp.getheader("X-Request-Id") == "trace-me"
            streams.append([json.loads(line) for line in raw.splitlines()])
            resp, raw = _request(port, "GET", "/stats")
            assert json.loads(raw)["num_slots"] == 1
            resp, _ = _request(port, "GET", "/nope")
            assert resp.status == 404
        finally:
            httpd.shutdown()
            httpd.server_close()
            server.close(drain=False)
    assert streams[0] == streams[1]
    assert streams[0][-1]["event"] == "done"
    assert streams[0][-1]["new_tokens"] == 3
    assert all(e["id"] == "trace-me" for e in streams[0])


def test_healthz_states_and_the_stall_rule(lms):
    """``ready``; 503 ``draining`` with ``Retry-After`` once admissions
    stop; ``unhealthy`` when the loop dies, and while a ``replica_hang``
    holds the heartbeat past ``stall_timeout_s``, ``ready`` after."""
    _, model = lms
    server = _server(model)
    httpd, port = _http(server)
    try:
        resp, raw = _request(port, "GET", "/healthz")
        payload = json.loads(raw)
        assert resp.status == 200 and payload["state"] == "ready"
        for key in ("queue_depth", "slot_occupancy", "num_slots",
                    "queue_capacity", "page_occupancy", "kv_pages_shared",
                    "kv_pages_free", "brownout_level", "weights_step",
                    "swapping"):
            assert key in payload
        server.queue.close()
        resp, raw = _request(port, "GET", "/healthz")
        assert resp.status == 503 and json.loads(raw)["state"] == "draining"
        assert resp.getheader("Retry-After") is not None
        resp, _ = _request(port, "POST", "/generate", {"prompt": "hi"})
        assert resp.status == 503
    finally:
        httpd.shutdown()
        httpd.server_close()
        server.close(drain=False)

    reg, sink = _registry()
    dead = _server(model, reg)

    def boom():
        raise RuntimeError("injected tick failure")

    dead.engine.tick = boom
    dead.start()
    assert wait_until(lambda: dead.queue.closed, timeout=30)
    assert dead.health()["state"] == "unhealthy" and dead.loop_dead()
    assert [r["reason"] for r in sink.of("flight_dump")] == ["fatal_tick"]
    dead.close(drain=False)

    server = _server(model, stall_timeout_s=0.25).start()
    try:
        warm = server.submit(_prompts([4], seed=3)[0], max_new_tokens=3)
        assert wait_until(warm.done.is_set, timeout=120)
        assert server.health()["state"] == "ready"
        set_plan(FaultPlan.parse(
            f"replica_hang:{server.engine.busy_ticks + 2}:1.0"))
        req = server.submit(_prompts([4], seed=4)[0], max_new_tokens=8)
        assert wait_until(lambda: server.health()["state"] == "unhealthy",
                          timeout=10)
        assert wait_until(req.done.is_set, timeout=120)
        assert req.status == "done"
        assert wait_until(lambda: server.health()["state"] == "ready",
                          timeout=10)
    finally:
        server.close(drain=False)


def test_brownout_admission_over_http(lms):
    """At level 1 batch requests shed (429), at level 2 output budgets
    clamp (``clamped_from`` and a ``brownout_clamp`` span), at level 3
    interactive requests fail fast (503); sheds count against the SLO."""
    from pytorch_distributed_training_tpu_torch.telemetry.slo import (
        BurnRateMonitor,
    )

    _, model = lms
    reg, sink = _registry()
    brownout = BrownoutController(clamp_max_new=2, registry=reg)
    slo = BurnRateMonitor(registry=reg)
    server = _server(model, reg, brownout=brownout, slo=slo).start()
    httpd, port = _http(server)
    try:
        brownout.level = 1
        resp, raw = _request(port, "POST", "/generate",
                             {"prompt": "hi", "tier": "batch"})
        assert resp.status == 429 and json.loads(raw)["brownout"] == (
            "shed_batch")
        assert resp.getheader("Retry-After")
        brownout.level = 2
        resp, raw = _request(port, "POST", "/generate",
                             {"prompt": "hello", "max_new_tokens": 6},
                             headers={"X-Request-Id": "clamped"})
        assert resp.status == 200
        done = [json.loads(line) for line in raw.splitlines()][-1]
        assert done["new_tokens"] == 2
        brownout.level = 3
        resp, _ = _request(port, "POST", "/generate", {"prompt": "hi"})
        assert resp.status == 503
    finally:
        httpd.shutdown()
        httpd.server_close()
        server.close(drain=False)
    assert [r["tier"] for r in sink.of("serve_shed")] == ["batch",
                                                          "interactive"]
    counters = reg.snapshot()["counters"]
    assert counters["serve/shed_batch"] == 1
    assert counters["serve/brownout_clamped"] == 1
    clamp = [s for s in sink.of("span") if s["name"] == "brownout_clamp"]
    assert clamp and clamp[0]["trace"] == "clamped"
    assert clamp[0]["attrs"] == {"from_max_new": 6, "to_max_new": 2}
    assert slo.stats()["slo_observed"] == 3


def _fake_server(depth, rate):
    return types.SimpleNamespace(
        engine=types.SimpleNamespace(drain_rate=rate),
        queue=types.SimpleNamespace(depth=lambda: depth))


@pytest.mark.parametrize("depth,rate,floor", [
    (10, 0.0, 5), (12, 2.0, 1), (1, 10.0, 5), (10_000, 0.5, 1),
    (7, 3.0, 1), (0, 4.0, 5)])
def test_retry_after_estimate_matches_jax(depth, rate, floor):
    got = server_mod.retry_after_estimate(_fake_server(depth, rate),
                                          floor=floor)
    assert got == jax_server_mod.retry_after_estimate(
        _fake_server(depth, rate), floor=floor)
    assert floor <= got <= server_mod.RETRY_AFTER_CEILING_S


def test_expired_telemetry_split_queued_vs_running(lms):
    _, model = lms
    reg, sink = _registry()
    server = _server(model, reg)
    q = server.submit(_prompts([4], seed=1)[0], max_new_tokens=4,
                      deadline_s=0.01)
    time.sleep(0.05)
    server.engine.tick()
    assert q.done.is_set() and q.status == "expired"
    r = server.submit(_prompts([4], seed=2)[0], max_new_tokens=8,
                      deadline_s=60.0)
    while r.admit_t is None:
        server.engine.tick()
    r.deadline_s = 1e-4
    while not r.done.is_set():
        server.engine.tick()
    assert r.status == "expired" and len(r.tokens) > 0
    recs = sink.of("serve_expired")
    assert [x["phase"] for x in recs] == ["queued", "running"]
    assert [x["id"] for x in recs] == [q.id, r.id]
    counters = reg.snapshot()["counters"]
    assert counters["serve/expired_queued"] == 1
    assert counters["serve/expired_running"] == 1
    assert counters["serve/expired"] == 2
    server.close(drain=False)


def test_tier_deadlines_fall_back_to_the_default(lms):
    _, model = lms
    server = _server(model, default_deadline_s=9.0,
                     tier_deadlines={"batch": 3.0})
    a = server.submit(_prompts([4])[0], max_new_tokens=2)
    b = server.submit(_prompts([4])[0], max_new_tokens=2, tier="batch")
    c = server.submit(_prompts([4])[0], max_new_tokens=2, tier="batch",
                      deadline_s=1.0)
    assert (a.deadline_s, b.deadline_s, c.deadline_s) == (9.0, 3.0, 1.0)
    server.close(drain=False)
    with pytest.raises(ValueError, match="unknown tiers"):
        _server(model, tier_deadlines={"bulk": 1.0})


def test_engine_arms_watchdog_sections(lms):
    """Prefill, decode and the whole tick run under the installed
    watchdog, as JAX's."""

    class StubWatchdog:
        def __init__(self):
            self.sections = []

        @contextlib.contextmanager
        def guard(self, what, step=None):
            self.sections.append(what)
            yield

    _, model = lms
    stub = StubWatchdog()
    watchdog.set_watchdog(stub)
    server = _server(model)
    req = server.submit(_prompts([4], seed=11)[0], max_new_tokens=3)
    while not req.done.is_set():
        server.engine.tick()
    server.close(drain=False)
    assert {"serve_prefill", "serve_decode", "serve_tick"} <= set(
        stub.sections)


WARM_CONFIGS = {
    "paged": {},
    "dense": dict(kv_layout="dense"),
    "host": dict(sampling="host", kv_layout="dense"),
    "spec-chunk-prefix": dict(spec_k=2, prefill_chunk=4, prefix_cache=True,
                              page_size=4),
    "prefix-int8": dict(prefix_cache=True, page_size=4,
                        weights_dtype="int8", kv_dtype="int8"),
}


@pytest.mark.parametrize("name", sorted(WARM_CONFIGS))
def test_warmed_engine_streams_equal_a_cold_ones(lms, name):
    """``warmup``: every shape runs once at build and leaves no trace: no
    page held, the prefix cache empty, and the streams, greedy and
    sampled, equal a cold engine's token for token."""
    _, model = lms
    engine = dict(num_slots=2, prompt_buckets=(8, 16), max_new_tokens=6,
                  **WARM_CONFIGS[name])
    prompts = _prompts([3, 9, 5, 12], seed=13)
    out = []
    for warm in (False, True):
        server = _server(model, engine=dict(engine, warmup=warm),
                         queue_depth=8)
        stats = server.stats()
        assert stats["admitted"] == 0 and stats["ticks"] == 0
        if stats["kv_pages_used"] is not None:
            assert stats["kv_pages_used"] == 0
        if stats["prefix_cache"] is not None:
            assert stats["prefix_cache"]["prefix_cached_pages"] == 0
        reqs = [server.submit(p, max_new_tokens=6, temperature=t, top_k=k,
                              seed=i)
                for i, (p, t, k) in enumerate(zip(
                    prompts, (0.0, 0.8, 0.0, 1.2), (0, 5, 0, 0)))]
        server.start()
        try:
            assert wait_until(lambda: all(r.done.is_set() for r in reqs),
                              timeout=120)
        finally:
            server.close()
        out.append([list(r.tokens) for r in reqs])
    assert out[0] == out[1]


def test_serve_lm_flags_take_jax_defaults():
    """The twenty service flags of ``serve_lm``, with JAX's defaults."""
    flags = ("warmup", "interactive_deadline_s", "batch_deadline_s",
             "brownout_high", "brownout_low", "brownout_clamp",
             "brownout_escalate_hold_s", "brownout_deescalate_hold_s",
             "http_port", "http_host", "drain_timeout_s", "stall_timeout_s",
             "hotswap_poll_s", "hotswap_verify", "metrics_dir",
             "flight_capacity", "slo_windows", "slo_emit_s", "slo_burn_high",
             "replica_name")
    got = vars(build_parser().parse_args([]))
    want = vars(jax_parser().parse_args([]))
    assert len(flags) == 20
    assert {f: got[f] for f in flags} == {f: want[f] for f in flags}
    with pytest.raises(SystemExit):
        build_parser().parse_args(["--hotswap-verify", "off"])


def test_serve_lm_stdio_metrics_stream(tmp_path):
    """``serve_lm --metrics-dir`` in stdio mode: JAX's ``serve_meta``
    header, a ``serve_request`` and spans a request, and the
    ``serve_summary`` at exit, which ``summarize_metrics`` folds."""
    import importlib.util

    from pytorch_distributed_training_tpu_torch.cli.serve_lm import main
    from pytorch_distributed_training_tpu_torch.telemetry.registry import (
        set_registry,
    )

    mdir = tmp_path / "metrics"
    prev = set_registry(MetricsRegistry())
    try:
        inp = io.StringIO("\n".join(json.dumps(
            {"prompt": p, "max_new_tokens": 3, "id": i})
            for i, p in (("a", "hello world"), ("b", "quick brown"))) + "\n")
        out = io.StringIO()
        stats = main(["--model", "gpt2-tiny", "--device", "cpu",
                      "--num-slots", "2", "--prompt-buckets", "16,32",
                      "--max-new-tokens-cap", "8", "--warmup",
                      "--metrics-dir", str(mdir)], in_stream=inp,
                     out_stream=out)
    finally:
        reg = set_registry(prev)
        if reg.sink is not None:
            reg.sink.close()
    assert stats["finished"] == 2
    spec = importlib.util.spec_from_file_location(
        "summarize_metrics", os.path.join(REPO, "scripts",
                                          "summarize_metrics.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    records = mod.load_records(str(mdir))
    kinds = [r["record"] for r in records]
    # JAX's order at exit: the engine's summary, then the lock registry's
    assert kinds[0] == "serve_meta" and kinds[-2:] == ["serve_summary",
                                                       "lock_summary"]
    assert kinds.count("serve_request") == 2 and "span" in kinds
    summary = mod.summarize(records)
    assert summary["serve"]["done"] == 2 and summary["serve"]["tokens"] == 6
    assert summary["spans"]["coverage"] == 1.0


# ------------------------------------------------------------ subprocess


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _replica(tmp_path, name, fault=None):
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1",
               CUDA_VISIBLE_DEVICES="")
    env.pop("PDT_TPU_FAULT", None)
    if fault:
        env["PDT_TPU_FAULT"] = fault
    mdir = str(tmp_path / name)
    proc = subprocess.Popen(
        [sys.executable, "-m",
         "pytorch_distributed_training_tpu_torch.cli.serve_lm",
         "--model", "gpt2-tiny", "--device", "cpu", "--num-slots", "2",
         "--prompt-buckets", "16,32", "--max-new-tokens-cap", "64",
         "--http-port", str(port), "--stall-timeout-s", "0.5",
         "--drain-timeout-s", "30", "--metrics-dir", mdir,
         "--replica-name", name], cwd=REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    return proc, port, mdir


def _up(proc, port, timeout=120):
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        if proc.poll() is not None:
            raise AssertionError(proc.stderr.read()[-3000:])
        try:
            resp, _ = _request(port, "GET", "/healthz", timeout=2)
            if resp.status == 200:
                return
        except OSError:
            pass
        time.sleep(0.1)
    raise AssertionError("replica never came up")


def _records(mdir):
    with open(os.path.join(mdir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f if line.strip()]


def test_serve_lm_subprocess_drain_and_replica_faults(tmp_path):
    """A real ``serve_lm --http-port``: ``replica_hang`` turns
    ``/healthz`` unhealthy until the hang ends, ``replica_slow`` stays
    armed; SIGTERM during a stream lets it finish and exits 75 with a
    ``sigterm_drain`` flight dump and a ``preemption`` record. A second
    replica with ``replica_crash`` dies with exit 23 and its
    ``fault_injected`` record on disk."""
    faulty, fport, fdir = _replica(
        tmp_path, "replica-0", "replica_hang:2:2.0,replica_slow:4:2x")
    crash, cport, cdir = _replica(tmp_path, "replica-1", "replica_crash:2")
    try:
        _up(faulty, fport)
        _up(crash, cport)
        resp, raw = _request(cport, "POST", "/generate",
                             {"prompt": "hello", "max_new_tokens": 8})
        assert crash.wait(60) == REPLICA_CRASH_EXIT_CODE
        assert any(r.get("fault") == "replica_crash"
                   for r in _records(cdir))

        seen = {}

        def generate(key, body):
            seen[key] = _request(fport, "POST", "/generate", body,
                                 timeout=120)

        t = threading.Thread(target=generate, args=(
            "hang", {"prompt": "hello there", "max_new_tokens": 6}))
        t.start()
        assert wait_until(lambda: json.loads(_request(
            fport, "GET", "/healthz")[1])["state"] == "unhealthy", 20)
        t.join(120)
        assert seen["hang"][0].status == 200
        assert wait_until(lambda: _request(fport, "GET", "/healthz")[
            0].status == 200, 20)
        # SIGTERM mid-stream: the stream completes, the process exits 75
        conn = http.client.HTTPConnection("127.0.0.1", fport, timeout=120)
        conn.request("POST", "/generate", body=json.dumps(
            {"prompt": "a long answer", "max_new_tokens": 48}))
        resp = conn.getresponse()
        first = resp.readline().decode()   # the stream is live
        faulty.send_signal(signal.SIGTERM)
        events = [json.loads(line) for line in
                  (first + resp.read().decode()).splitlines()]
        conn.close()
        assert resp.status == 200 and events[-1]["event"] == "done"
        assert events[-1]["new_tokens"] == 48
        assert faulty.wait(60) == RESUMABLE_EXIT_CODE
    finally:
        for p in (faulty, crash):
            if p.poll() is None:
                p.kill()
            p.communicate()
    records = _records(fdir)
    faults = {r["fault"]: r for r in records
              if r["record"] == "fault_injected"}
    assert faults["replica_hang"]["seconds"] == 2.0
    assert faults["replica_slow"]["factor"] == 2.0
    dumps = [r for r in records if r["record"] == "flight_dump"]
    assert [d["reason"] for d in dumps] == ["sigterm_drain"]
    assert dumps[0]["component"] == "replica-0"
    assert any(r["record"] == "preemption" and r["scope"] == "serve"
               for r in records)
    assert records[0]["record"] == "serve_meta"
    assert [r["record"] for r in records[-2:]] == ["serve_summary",
                                                   "lock_summary"]
