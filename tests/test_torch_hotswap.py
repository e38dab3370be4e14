"""Port parity, live weight hot-swap (``serve/hotswap.py`` and the
engine's swap protocol): the checkpoint watcher's admission rules run on
the port's and the JAX package's watcher alike (hand-built sealed steps),
an asynchronous save's step is admitted only once its join seals it,
post-swap streams equal a fresh engine's on the new weights and the JAX
engine's on bridged weights, a shape mismatch touches nothing, a failing
first tick rolls back, fp32 <-> int8 coercion and the prefix-cache flush,
``HotSwapManager`` with ``POST /swap`` and its fault drills, and the swap
under ``tp 2`` over gloo against tp 1's (``--device cpu``)."""

import http.client
import json
import os
import socket
import subprocess
import sys
import textwrap
import threading
import time
import types

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
from pytorch_distributed_training_tpu.serve import hotswap as jax_hotswap
from pytorch_distributed_training_tpu.serve.server import wait_until
from pytorch_distributed_training_tpu.telemetry.registry import (
    MetricsRegistry as JaxRegistry,
)
from pytorch_distributed_training_tpu.train import manifest as jax_manifest
from pytorch_distributed_training_tpu.utils.config import (
    model_preset as jax_preset,
)
from pytorch_distributed_training_tpu_torch.data.bpe import ByteTokenizer
from pytorch_distributed_training_tpu_torch.faults.inject import (
    FaultPlan,
    set_plan,
)
from pytorch_distributed_training_tpu_torch.models.convert import (
    params_from_jax,
)
from pytorch_distributed_training_tpu_torch.models.gpt2 import GPT2LMModel
from pytorch_distributed_training_tpu_torch.ops.quant import (
    dequantize_serve_params,
    quantize_serve_params,
)
from pytorch_distributed_training_tpu_torch.serve import (
    EngineConfig,
    HotSwapManager,
    InferenceServer,
    make_http_server,
    publish_params_checkpoint,
)
from pytorch_distributed_training_tpu_torch.serve import hotswap
from pytorch_distributed_training_tpu_torch.telemetry.registry import (
    MetricsRegistry,
)
from pytorch_distributed_training_tpu_torch.train import manifest
from pytorch_distributed_training_tpu_torch.utils.config import model_preset

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T = 6


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


def _registry(cls=MetricsRegistry):
    reg, sink = cls(), ListSink()
    reg.attach_sink(sink)
    return reg, sink


@pytest.fixture(autouse=True)
def _clean_fault_state():
    yield
    set_plan(None)


# ---------------------------------------------------------------- watcher

IMPLS = {
    "port": types.SimpleNamespace(
        CheckpointWatcher=hotswap.CheckpointWatcher,
        scan_step_dirs=hotswap.scan_step_dirs,
        manifest_digest=hotswap.manifest_digest, manifest=manifest,
        registry=MetricsRegistry),
    "jax": types.SimpleNamespace(
        CheckpointWatcher=jax_hotswap.CheckpointWatcher,
        scan_step_dirs=jax_hotswap.scan_step_dirs,
        manifest_digest=jax_hotswap.manifest_digest, manifest=jax_manifest,
        registry=JaxRegistry),
}


@pytest.fixture(params=sorted(IMPLS))
def impl(request):
    return IMPLS[request.param]


def _publish_fake(impl, directory, step: int, payload: bytes) -> str:
    """A minimal sealed step: one data file and a real manifest."""
    path = os.path.join(str(directory), str(step))
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "weights.bin"), "wb") as f:
        f.write(payload)
    impl.manifest.write_manifest(path, impl.manifest.build_manifest(path,
                                                                    step))
    return path


class Applier:
    def __init__(self, fail_steps=()):
        self.calls = []
        self.fail_steps = set(fail_steps)

    def __call__(self, step: int) -> bool:
        self.calls.append(step)
        return step not in self.fail_steps


def _watcher(impl, directory, apply_fn, reg, **kw):
    kw.setdefault("verify_level", "digest")
    kw.setdefault("start_step", 0)
    return impl.CheckpointWatcher(str(directory), apply_fn, registry=reg,
                                  **kw)


def test_scan_step_dirs_ignores_non_steps(impl, tmp_path):
    _publish_fake(impl, tmp_path, 3, b"three")
    _publish_fake(impl, tmp_path, 10, b"ten")
    os.makedirs(tmp_path / ".tmp-12")
    (tmp_path / "metrics.jsonl").write_text("{}\n")
    assert impl.scan_step_dirs(str(tmp_path)) == [3, 10]
    assert impl.scan_step_dirs(str(tmp_path / "missing")) == []


def test_watcher_admits_newest_verified_once(impl, tmp_path):
    reg, sink = _registry(impl.registry)
    apply = Applier()
    w = _watcher(impl, tmp_path, apply, reg)
    assert w.poll_once() is None
    _publish_fake(impl, tmp_path, 1, b"v1")
    _publish_fake(impl, tmp_path, 2, b"v2")
    assert w.poll_once() == 2 and apply.calls == [2]
    assert w.current_step == 2
    assert w.poll_once() is None and apply.calls == [2]
    _publish_fake(impl, tmp_path, 5, b"v5")
    assert w.poll_once() == 5
    assert [r["step"] for r in sink.of("swap_admitted")] == [2, 5]


def test_watcher_baseline_without_applying(impl, tmp_path):
    reg, sink = _registry(impl.registry)
    _publish_fake(impl, tmp_path, 4, b"v4")
    apply = Applier()
    w = _watcher(impl, tmp_path, apply, reg, start_step=None)
    assert w.poll_once() is None
    assert w.current_step == 4 and apply.calls == []
    assert sink.of("swap_baseline")[0]["step"] == 4
    _publish_fake(impl, tmp_path, 6, b"v6")
    assert w.poll_once() == 6


def test_watcher_skips_partial_publish_then_admits(impl, tmp_path):
    reg, _ = _registry(impl.registry)
    apply = Applier()
    w = _watcher(impl, tmp_path, apply, reg)
    path = os.path.join(str(tmp_path), "3")
    os.makedirs(path)
    with open(os.path.join(path, "weights.bin"), "wb") as f:
        f.write(b"partial")
    assert w.poll_once() is None and 3 not in w.blocklist
    impl.manifest.write_manifest(path, impl.manifest.build_manifest(path, 3))
    with open(os.path.join(path, "weights.bin"), "r+b") as f:
        f.write(b"PARTIAL")
    assert w.poll_once() is None and 3 not in w.blocklist
    with open(os.path.join(path, "weights.bin"), "r+b") as f:
        f.write(b"partial")
    assert w.poll_once() == 3 and apply.calls == [3]


def test_watcher_rejects_out_of_order_older_step(impl, tmp_path):
    reg, sink = _registry(impl.registry)
    apply = Applier()
    _publish_fake(impl, tmp_path, 5, b"v5")
    w = _watcher(impl, tmp_path, apply, reg)
    assert w.poll_once() == 5
    _publish_fake(impl, tmp_path, 3, b"v3-late")
    assert w.poll_once() is None and apply.calls == [5]
    rejects = sink.of("swap_rejected")
    assert [r["step"] for r in rejects] == [3]
    assert "older" in rejects[0]["reason"]
    assert w.poll_once() is None
    assert [r["step"] for r in sink.of("swap_rejected")] == [3]


def test_watcher_ignores_preexisting_retention_history(impl, tmp_path):
    reg, sink = _registry(impl.registry)
    for step in (2, 4, 6):
        _publish_fake(impl, tmp_path, step, f"v{step}".encode())
    apply = Applier()
    w = _watcher(impl, tmp_path, apply, reg, start_step=4)
    assert w.poll_once() == 6 and w.poll_once() is None
    assert apply.calls == [6] and sink.of("swap_rejected") == []


def test_watcher_rejects_republished_step_with_different_digests(impl,
                                                                  tmp_path):
    reg, sink = _registry(impl.registry)
    apply = Applier()
    w = _watcher(impl, tmp_path, apply, reg)
    _publish_fake(impl, tmp_path, 2, b"sealed-once")
    assert w.poll_once() == 2
    _publish_fake(impl, tmp_path, 2, b"sealed-TWICE-different")
    assert w.poll_once() is None and apply.calls == [2]
    assert any(r["step"] == 2 and "republished" in r["reason"]
               for r in sink.of("swap_rejected"))
    assert 2 in w.blocklist and w.current_step == 2


def test_watcher_blocklists_failed_apply_and_recovers(impl, tmp_path):
    reg, sink = _registry(impl.registry)
    apply = Applier(fail_steps={2})
    w = _watcher(impl, tmp_path, apply, reg)
    _publish_fake(impl, tmp_path, 2, b"poisoned")
    assert w.poll_once() is None and apply.calls == [2]
    assert 2 in w.blocklist
    assert sink.of("swap_blocklisted")[0]["step"] == 2
    assert w.poll_once() is None and apply.calls == [2]
    _publish_fake(impl, tmp_path, 3, b"good")
    assert w.poll_once() == 3 and apply.calls == [2, 3]


def test_watcher_manifest_digest_distinguishes_content(impl, tmp_path):
    a = _publish_fake(impl, tmp_path, 1, b"content-a")
    b = _publish_fake(impl, tmp_path, 2, b"content-b")
    da = impl.manifest_digest(impl.manifest.read_manifest(a))
    assert da != impl.manifest_digest(impl.manifest.read_manifest(b))
    assert da == impl.manifest_digest(impl.manifest.read_manifest(a))


def test_watcher_clean_shutdown_with_poll_in_flight(impl, tmp_path):
    reg, _ = _registry(impl.registry)
    started, release, calls = threading.Event(), threading.Event(), []

    def slow_apply(step):
        calls.append(step)
        started.set()
        release.wait(5.0)
        return True

    w = _watcher(impl, tmp_path, slow_apply, reg, poll_interval_s=0.01)
    _publish_fake(impl, tmp_path, 1, b"v1")
    w.start()
    assert started.wait(10.0)
    closer = threading.Thread(target=w.close, daemon=True)
    closer.start()
    time.sleep(0.05)
    release.set()
    closer.join(10.0)
    assert not closer.is_alive()
    assert calls == [1] and w.current_step == 1
    time.sleep(0.05)
    assert w.polls >= 1 and calls == [1]


def test_watcher_admits_an_async_save_only_after_its_join(tmp_path):
    """An asynchronous save's step is a hidden ``.tmp-<step>`` until the
    join: the watcher sees nothing, then admits the sealed step."""
    from pytorch_distributed_training_tpu_torch.train import checkpoint
    from pytorch_distributed_training_tpu_torch.train.loop import Trainer
    from pytorch_distributed_training_tpu_torch.utils.config import (
        TrainConfig,
    )

    trainer = Trainer(
        model_preset("tiny", compute_dtype="float32", hidden_dropout=0.0,
                     attention_dropout=0.0),
        TrainConfig(num_epochs=1, train_size=32, eval_size=16,
                    global_batch_size=16, log_every=0, bf16=False),
        task="synthetic", device="cpu")
    reg, _ = _registry()
    apply = Applier()
    w = hotswap.CheckpointWatcher(str(tmp_path), apply, registry=reg,
                                  start_step=-1)
    saver = checkpoint.Checkpointer(str(tmp_path))
    saver.save(trainer.state)
    assert w.poll_once() is None and apply.calls == []
    saver.close()  # joins: the step commits and is sealed
    assert w.poll_once() == 0 and apply.calls == [0]


# ---------------------------------------------------------------- engines


@pytest.fixture(scope="module")
def lm():
    """JAX gpt2-tiny weights A (key 0) and B (key 1), and the port's model
    on each."""
    cfg = jax_preset("gpt2-tiny", compute_dtype="float32",
                     attention_impl="reference", hidden_dropout=0.0,
                     attention_dropout=0.0)
    jmodel = JaxGPT2(cfg)
    ones = jnp.ones((2, 16), jnp.int32)
    pa = jmodel.init(jax.random.key(0), ones)["params"]
    pb = jmodel.init(jax.random.key(1), ones)["params"]
    models = []
    for params in (pa, pb):
        m = GPT2LMModel(model_preset("gpt2-tiny", compute_dtype="float32"))
        m.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
        models.append(m)
    return (jmodel, pa, pb), models


def _cfg(**kw):
    return dict(dict(num_slots=2, prompt_buckets=(8, 16),
                     max_new_tokens=32), **kw)


def _server(model, reg=None, weights_step=1, **kw):
    return InferenceServer(model, EngineConfig(**_cfg(**kw)), device="cpu",
                           queue_depth=8, registry=reg,
                           weights_step=weights_step)


def _prompts(n=3, seed=0, vocab=1024):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, 3 + 2 * i).astype(np.int32)
            for i in range(n)]


def _streams(server, prompts, n=T):
    reqs = [server.submit(p, max_new_tokens=n) for p in prompts]
    assert wait_until(lambda: all(r.done.is_set() for r in reqs),
                      timeout=120)
    assert all(r.status == "done" for r in reqs), [r.status for r in reqs]
    return [list(r.tokens) for r in reqs]


def _fresh(model, prompts, **kw):
    server = _server(model, **kw).start()
    try:
        return _streams(server, prompts)
    finally:
        server.close()


def _weights(engine):
    return {k: v.clone() for k, v in engine.params.items()}


def test_swap_is_token_identical_to_fresh_and_jax(lm):
    """After a live swap the streams equal a fresh engine's on the new
    weights and the JAX engine's on the bridged ones; a request in flight
    across the swap finishes; records name the weights step."""
    (jmodel, _pa, pb), (ma, mb) = lm
    prompts = _prompts()
    reg, sink = _registry()
    server = _server(ma, reg).start()
    try:
        before = _streams(server, prompts)
        long = server.submit(_prompts(1, seed=3)[0], max_new_tokens=24)
        assert wait_until(lambda: len(long.tokens) >= 3, timeout=120)
        ticket = server.engine.request_swap(mb.state_dict(), 2)
        assert ticket.done.wait(30) and ticket.ok
        assert wait_until(long.done.is_set, timeout=120)
        assert long.status == "done" and len(long.tokens) == 24
        after = _streams(server, prompts)
        stats = server.stats()
    finally:
        server.close(drain=False)
    assert before == _fresh(ma, prompts) and before != after
    assert after == _fresh(mb, prompts)
    jserver = JaxServer(jmodel, pb, JaxEngineConfig(**_cfg()), queue_depth=8)
    jserver.start()
    try:
        assert after == _streams(jserver, prompts)
    finally:
        jserver.close()
    assert stats["weights_step"] == 2 and stats["swaps"] == 1
    assert stats["swap_rollbacks"] == 0 and not stats["swap_pending"]
    steps = [r["weights_step"] for r in sink.of("serve_request")]
    assert steps[:3] == [1, 1, 1] and steps[-3:] == [2, 2, 2]
    assert sink.of("swap_applied")[0]["version"] == 2
    assert sink.of("swap_committed")[0]["version"] == 2
    assert any(s["name"] == "swap_overlap" and s["trace"] == long.id
               for s in sink.of("span"))


def test_swap_rejects_shape_mismatch_without_touching_weights(lm):
    _, (ma, mb) = lm
    server = _server(ma)
    engine = server.engine
    before = _weights(engine)
    bad = {k: v[..., :1] for k, v in mb.state_dict().items()}
    with pytest.raises(ValueError, match="shape mismatch"):
        engine.request_swap(bad, 2)
    with pytest.raises(ValueError, match="names"):
        engine.request_swap({"nope": torch.zeros(1)}, 2)
    with pytest.raises(ValueError, match="shape mismatch"):
        engine.swap_params(bad, 2)
    assert engine.weights_step == 1 and not engine.stats()["swap_pending"]
    assert all(torch.equal(before[k], v) for k, v in engine.params.items())
    server.close(drain=False)


def test_swap_trial_rollback_on_first_post_swap_tick_failure(lm):
    """A failing first tick after a swap copies the previous weights back,
    records the failure, and the engine serves the old weights."""
    _, (ma, mb) = lm
    reg, sink = _registry()
    server = _server(ma, reg)
    engine = server.engine
    before = _weights(engine)
    real_expire = server.queue.expire_overdue
    boom = {"armed": False}

    def expire(*a, **kw):
        if boom["armed"]:
            boom["armed"] = False
            raise RuntimeError("injected trial-tick failure")
        return real_expire(*a, **kw)

    server.queue.expire_overdue = expire
    ticket = engine.request_swap(mb.state_dict(), 2)
    boom["armed"] = True
    assert engine.tick() is True
    assert ticket.done.is_set() and ticket.ok is False
    assert ticket.stage == "tick"
    assert engine.weights_step == 1
    assert engine.swap_rollbacks == 1 and engine.swaps == 0
    assert all(torch.equal(before[k], v) for k, v in engine.params.items())
    assert sink.of("swap_failed")[0]["stage"] == "tick"
    rb = sink.of("swap_rollback")[0]
    assert rb["from_version"] == 2 and rb["to_version"] == 1
    prompt = _prompts(1)[0]
    req = server.submit(prompt, max_new_tokens=4)
    while not req.done.is_set():
        engine.tick()
    assert list(req.tokens) == _fresh(ma, [prompt])[0][:4]
    server.close(drain=False)


@pytest.mark.parametrize("resident,published", [("int8", "fp32"),
                                                ("float32", "int8")])
def test_variant_coercion_and_prefix_cache_flush(lm, resident, published):
    """An fp32 publish into an int8 engine is quantized, an int8 one into
    an fp32 engine dequantized; the streams equal a fresh engine's on the
    coerced weights, and the swap flushes the prefix cache."""
    _, (ma, mb) = lm
    reg, sink = _registry()
    kw = dict(weights_dtype=resident, prefix_cache=True, page_size=4)
    new = mb.state_dict()
    if published == "int8":
        new = quantize_serve_params(new)
    server = _server(ma, reg, **kw).start()
    prompts = _prompts(2, seed=4) + [np.arange(1, 11, dtype=np.int32)]
    try:
        _streams(server, prompts)
        assert server.stats()["prefix_cache"]["prefix_cached_pages"] > 0
        ticket = server.engine.request_swap(new, 2)
        assert ticket.done.wait(30) and ticket.ok
        assert server.stats()["prefix_cache"]["prefix_cached_pages"] == 0
        after = _streams(server, prompts)
        assert server.stats()["variant"] == (
            "int8" if resident == "int8" else "fp32")
    finally:
        server.close(drain=False)
    assert sink.of("swap_applied")[0]["variant"] == published
    assert reg.snapshot()["counters"]["serve/prefix_invalidations"] == 1
    ref = GPT2LMModel(model_preset("gpt2-tiny", compute_dtype="float32"))
    ref.load_state_dict(mb.state_dict() if published == "fp32"
                        else dequantize_serve_params(new))
    assert after == _fresh(ref, prompts, **kw)


def _post(port, path, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    conn.request("POST" if body is not None else "GET", path,
                 body=None if body is None else json.dumps(body))
    resp = conn.getresponse()
    payload = json.loads(resp.read())
    conn.close()
    return resp.status, payload


def test_hotswap_manager_and_http_swap_endpoint(lm, tmp_path):
    """``POST /swap`` to a published step serves it (200); a missing step
    or one whose load fails (``corrupt_ckpt_swap``) answers 409 and keeps
    the old weights."""
    _, (ma, mb) = lm
    ckpt = str(tmp_path / "ckpt")
    publish_params_checkpoint(ckpt, 1, ma.state_dict())
    reg, sink = _registry()
    server = _server(ma, reg).start()
    server.attach_hotswap(HotSwapManager(server, ckpt, registry=reg,
                                         start_step=1))
    httpd = make_http_server(server, ByteTokenizer())
    port = httpd.server_address[1]
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    prompts = _prompts()
    try:
        status, out = _post(port, "/swap", {"step": 9})
        assert status == 409 and out["stage"] == "load"
        assert out["weights_step"] == 1
        publish_params_checkpoint(ckpt, 2, mb.state_dict())
        status, out = _post(port, "/swap", {"step": 2})
        assert status == 200 and out["ok"] and out["weights_step"] == 2
        assert out["load_s"] > 0
        assert _post(port, "/healthz")[1]["weights_step"] == 2
        status, out = _post(port, "/swap", {"step": 2})
        assert status == 200 and out.get("noop") is True
        publish_params_checkpoint(ckpt, 3, ma.state_dict())
        set_plan(FaultPlan.parse("corrupt_ckpt_swap:3"))
        status, out = _post(port, "/swap", {"step": 3})
        assert status == 409 and "corrupt" in out["error"]
        assert out["weights_step"] == 2
        assert _streams(server, prompts) == _fresh(mb, prompts)
        stats = server.stats()
        assert stats["swap_failures"] == 2 and stats["swap_attempts"] == 3
        assert [r["version"] for r in sink.of("swap_failed")] == [9, 3]
        assert len(sink.of("swap_rollback")) == 2
        assert _post(port, "/swap", {"nope": 1})[0] == 400
    finally:
        httpd.shutdown()
        httpd.server_close()
        server.close(drain=False)


def test_hotswap_manager_watcher_polls_new_steps(lm, tmp_path):
    """``--hotswap-poll-s``: the manager's own watcher takes up a newly
    published step (here an int8 publish into the fp32 engine)."""
    _, (ma, mb) = lm
    ckpt = str(tmp_path / "ckpt")
    publish_params_checkpoint(ckpt, 1, ma.state_dict())
    server = _server(ma).start()
    server.attach_hotswap(HotSwapManager(
        server, ckpt, poll_interval_s=0.05, start_step=1).start())
    try:
        publish_params_checkpoint(ckpt, 2, mb.state_dict(), variant="int8")
        assert wait_until(lambda: server.engine.weights_step == 2, 60)
        stats = server.stats()
        assert stats["swaps"] == 1 and stats["swap_watching"]
    finally:
        server.close(drain=False)


def test_load_swap_params_relayouts_a_scanned_step(lm, tmp_path):
    """A scanned-trunk step loads unstacked for the engine, which serves
    a block a module, restricted to the served model's names."""
    from pytorch_distributed_training_tpu_torch.models.relayout import (
        stack_layer_params,
    )

    _, (ma, mb) = lm
    per_layer = mb.state_dict()
    publish_params_checkpoint(str(tmp_path), 5,
                              stack_layer_params(per_layer))
    got = hotswap.load_swap_params(str(tmp_path), 5,
                                   current_params=ma.state_dict())
    assert set(got) == set(per_layer)
    assert all(torch.equal(got[k], per_layer[k]) for k in per_layer)


# -------------------------------------------------------------- tp over gloo

_TP_SCRIPT = textwrap.dedent("""
import json, sys
import torch
from pytorch_distributed_training_tpu_torch.comms.bootstrap import (
    initialize, shutdown)
from pytorch_distributed_training_tpu_torch.comms.mesh import build_mesh
from pytorch_distributed_training_tpu_torch.models.gpt2 import GPT2LMModel
from pytorch_distributed_training_tpu_torch.serve import (
    EngineConfig, HotSwapManager, InferenceServer, run_follower)
from pytorch_distributed_training_tpu_torch.utils.config import (
    MeshConfig, model_preset)

out, spec = sys.argv[1], json.loads(sys.argv[2])
info = initialize(torch.device("cpu"))
shard = build_mesh(MeshConfig(data=1, model=2), rank=info.rank,
                   world_size=2).shard("model")
model = GPT2LMModel(model_preset("gpt2-tiny", compute_dtype="float32"))
model.load_state_dict(torch.load(spec["weights"]))
cfg = EngineConfig(**spec["config"])
if shard.index:
    run_follower(model, cfg, device="cpu", shard=shard)
else:
    server = InferenceServer(model, cfg, device="cpu", queue_depth=16,
                             shard=shard, weights_step=1).start()
    mgr = HotSwapManager(server, spec["ckpt"], start_step=1)
    res = {"swaps": [mgr.swap_to(s) for s in spec["steps"]]}
    reqs = [server.submit(p, max_new_tokens=spec["T"])
            for p in spec["prompts"]]
    for r in reqs:
        r.done.wait(120)
    res["streams"] = [list(r.tokens) for r in reqs]
    res["weights_step"] = server.engine.weights_step
    server.close()
    with open(out, "w") as f:
        json.dump(res, f)
shutdown()
""")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_tp2_swap_over_gloo_equals_tp1(lm, tmp_path):
    """A replica of two gloo ranks swaps to step 2 (each rank loading its
    own slice) and its streams equal tp 1's after the same swap; a step
    whose load fails on the follower alone (``corrupt_ckpt_swap:3@1``)
    installs on no rank."""
    _, (ma, mb) = lm
    ckpt = str(tmp_path / "ckpt")
    publish_params_checkpoint(ckpt, 2, mb.state_dict())
    publish_params_checkpoint(ckpt, 3, ma.state_dict())
    weights = str(tmp_path / "a.pt")
    torch.save(ma.state_dict(), weights)
    prompts = _prompts()
    spec = dict(weights=weights, ckpt=ckpt, steps=[2, 3], T=T,
                prompts=[p.tolist() for p in prompts],
                config=_cfg(tp=2, prefix_cache=True, page_size=4))
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(_free_port()), WORLD_SIZE="2",
               GLOO_SOCKET_IFNAME="lo", PYTHONPATH=REPO, OMP_NUM_THREADS="1",
               PDT_TPU_FAULT="corrupt_ckpt_swap:3@1")
    out = str(tmp_path / "tp.json")
    procs = [subprocess.Popen(
        [sys.executable, "-c", _TP_SCRIPT, out, json.dumps(spec)], cwd=REPO,
        env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    # meanwhile, tp 1: the same swap in this process
    server = _server(ma, prefix_cache=True, page_size=4).start()
    try:
        mgr = HotSwapManager(server, ckpt, start_step=1)
        assert mgr.swap_to(2)["ok"]
        want = _streams(server, prompts)
    finally:
        server.close()
    errs = []
    for p in procs:
        try:
            _, err = p.communicate(timeout=240)
        finally:
            p.kill()
        errs.append(err[-3000:])
    assert all(p.returncode == 0 for p in procs), errs
    with open(out) as f:
        res = json.load(f)
    ok, failed = res["swaps"]
    assert ok["ok"] and ok["weights_step"] == 2
    assert not failed["ok"] and failed["stage"] == "apply"
    assert res["weights_step"] == 2
    assert res["streams"] == want == _fresh(mb, prompts)


def test_a_scanned_model_serves_unstacked_also_at_int8(lm):
    """The engine unstacks a scanned trunk at build, as JAX's does, so a
    scanned checkpoint serves int8 weights too; its streams equal the
    per-layer model's."""
    import dataclasses

    from pytorch_distributed_training_tpu_torch.models.relayout import (
        stack_layer_params,
    )

    _, (ma, _) = lm
    scanned = GPT2LMModel(dataclasses.replace(ma.config, scan_layers=True))
    scanned.load_state_dict(stack_layer_params(ma.state_dict()))
    prompts = _prompts()
    for weights in ("float32", "int8"):
        got = _fresh(scanned, prompts, weights_dtype=weights)
        assert got == _fresh(ma, prompts, weights_dtype=weights)
