"""Port parity, the runtime lock registry (``analysis/concurrency``): the
port's registry against JAX's on the same scripted acquisition sequences
(records, counters, order edges, per-lock acquires and contentions),
strict mode raising before the acquire, the plain lock under ``off``, a
condition over a traced lock, the device-boundary record, the periodic
summary, ``guard_mode_from_env``, ``summary_record``'s keys, and one
tiny ``InferenceServer`` request in each package under ``record``: the
two summary records name the same locks."""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_training_tpu.analysis import concurrency as jax_cc
from pytorch_distributed_training_tpu.analysis.guards import (
    guard_mode_from_env as jax_guard_mode_from_env,
)
from pytorch_distributed_training_tpu.telemetry.registry import (
    MetricsRegistry as JaxMetricsRegistry,
)
from pytorch_distributed_training_tpu_torch.analysis import concurrency
from pytorch_distributed_training_tpu_torch.telemetry.registry import (
    MetricsRegistry,
)

pytestmark = pytest.mark.concurrency

torch.set_num_threads(2)

PAIRS = {"port": (concurrency, MetricsRegistry),
         "jax": (jax_cc, JaxMetricsRegistry)}


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


def _registries(which, mode="record"):
    cc, metrics = PAIRS[which]
    telemetry, sink = metrics(), ListSink()
    telemetry.attach_sink(sink)
    return cc, cc.LockRegistry(mode=mode, registry=telemetry), telemetry, sink


def _in_thread(fn):
    out = []

    def run():
        try:
            fn()
            out.append("ok")
        except Exception as e:  # noqa: BLE001 - the outcome is the result
            out.append(type(e).__name__)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(10)
    return out


def _script(which, mode):
    """One scripted sequence: A->B nested, an rlock re-entered, B->A in a
    thread (an inversion), a contended acquire, a device boundary under a
    lock. Returns everything that does not depend on timing."""
    cc, reg, telemetry, sink = _registries(which, mode)
    a, b = cc.lock("A", registry=reg), cc.lock("B", registry=reg)
    r = cc.rlock("R", registry=reg)
    with a:
        with b:
            assert cc.held_lock_names() == ("A", "B")
    with r:
        with r:
            with a:
                pass

    def invert():
        with b:
            with a:
                pass

    inverted = _in_thread(invert)
    # after a strict raise neither lock is left held
    held_after = b.acquire(timeout=2)
    if held_after:
        b.release()
    release, holding = threading.Event(), threading.Event()

    def holder():
        with a:
            holding.set()
            release.wait(5)

    t = threading.Thread(target=holder, daemon=True)
    t.start()
    assert holding.wait(5)
    contender = threading.Thread(target=lambda: a.acquire() and a.release(),
                                 daemon=True)
    contender.start()
    time.sleep(0.05)
    release.set()
    t.join(5)
    contender.join(5)
    with a:
        boundary = reg.check_device_boundary("tick")
    rec = reg.summary_record()
    return {
        "inverted": inverted,
        "b_free_after": held_after,
        "boundary": boundary,
        "violations": reg.order_violations,
        "boundary_holds": reg.device_boundary_holds,
        "edges": rec["order_edges"],
        "keys": sorted(rec),
        "lock_keys": {n: sorted(s) for n, s in rec["locks"].items()},
        "counts": {n: (s["acquires"], s["contentions"] > 0)
                   for n, s in rec["locks"].items()},
        "records": [{k: v for k, v in x.items() if k != "ts"}
                    for x in sink.records],
        "counters": telemetry.snapshot()["counters"],
        "mode": rec["mode"],
    }


@pytest.mark.parametrize("mode", ["record", "strict"])
def test_scripted_sequence_matches_jax(mode):
    got, want = _script("port", mode), _script("jax", mode)
    assert got == want
    assert got["violations"] == 1 and got["b_free_after"]
    assert got["inverted"] == (["ok"] if mode == "record"
                               else ["LockOrderViolation"])
    assert got["edges"] == {"A": ["B"], "B": ["A"], "R": ["A"]}
    [violation, boundary] = got["records"]
    assert violation == {"record": "lock_order_violation", "acquiring": "A",
                         "holding": ["B"], "inverts": "A -> B"}
    assert boundary == {"record": "lock_across_device", "boundary": "tick",
                        "holding": ["A"]}
    assert got["counters"] == {"locks/order_violations": 1,
                               "locks/device_boundary_holds": 1}
    # A: under itself, under R, the holder, the contender, the boundary
    # (+ the inverted thread's in record mode; strict raised before it)
    assert got["counts"]["A"] == (5 if mode == "strict" else 6, True)


def test_strict_raises_before_the_acquire():
    for which in PAIRS:
        cc, reg, _, _ = _registries(which, "strict")
        a, b = cc.lock("A", registry=reg), cc.lock("B", registry=reg)
        with a:
            with b:
                pass
        with b:
            with pytest.raises(cc.LockOrderViolation):
                a.acquire()
            assert cc.held_lock_names() == ("B",)
            assert not a.locked()
        assert cc.held_lock_names() == ()


def test_mode_off_is_a_plain_lock():
    for which in PAIRS:
        cc, reg, _, _ = _registries(which, "off")
        for make in (cc.lock, cc.rlock):
            lk = make("x", registry=reg)
            assert not isinstance(lk, cc.TracedLock)
            with lk:
                assert cc.held_lock_names() == ()
        assert reg.summary_record()["locks"] == {}


def test_condition_over_traced_lock_keeps_held_stack_honest():
    for which in PAIRS:
        cc, reg, _, _ = _registries(which)
        lk = cc.lock("t.cond", registry=reg)
        cond = threading.Condition(lk)
        observed = []

        def waiter():
            with cond:
                observed.append(("pre-wait", cc.held_lock_names()))
                cond.wait(timeout=5)
                observed.append(("post-wait", cc.held_lock_names()))

        t = threading.Thread(target=waiter, daemon=True)
        t.start()
        time.sleep(0.05)
        # while the waiter sleeps inside cond.wait it does not hold the lock
        assert lk.acquire(timeout=2)
        lk.release()
        with cond:
            cond.notify_all()
        t.join(5)
        assert observed == [("pre-wait", ("t.cond",)),
                            ("post-wait", ("t.cond",))], which


def test_periodic_summary_and_record_keys():
    keys = {}
    for which in PAIRS:
        cc, reg, telemetry, sink = _registries(which)
        with cc.lock("p", registry=reg):
            pass
        with pytest.raises(ValueError):
            cc.start_periodic_summary(0, registry=telemetry,
                                      lock_registry=reg)
        periodic = cc.start_periodic_summary(0.02, registry=telemetry,
                                             lock_registry=reg)
        deadline = time.monotonic() + 5
        while periodic.emitted < 2 and time.monotonic() < deadline:
            time.sleep(0.01)
        periodic.stop()
        assert periodic.emitted >= 2
        rec = sink.of("lock_summary")[0]
        keys[which] = (sorted(rec), sorted(rec["locks"]["p"]))
        assert rec["mode"] == "record" and rec["locks"]["p"]["acquires"] == 1
        emitted = reg.emit_summary(telemetry)
        assert emitted["record"] == "lock_summary"
    assert keys["port"] == keys["jax"]


@pytest.mark.parametrize("value", [None, "off", "record", "strict", "loud"])
def test_guard_mode_from_env_matches_jax(value, monkeypatch):
    if value is None:
        monkeypatch.delenv("PDT_TPU_GUARDS", raising=False)
    else:
        monkeypatch.setenv("PDT_TPU_GUARDS", value)
    outs = []
    for fn in (concurrency.guard_mode_from_env, jax_guard_mode_from_env):
        try:
            outs.append(fn(default="strict"))
        except ValueError as e:
            outs.append(type(e))
    assert outs[0] == outs[1]
    # the registry's own reading never raises: an unknown word is record
    assert concurrency.LockRegistry().mode == jax_cc.LockRegistry().mode


# -------------------------------------------- one request in each package


def _serve_one(which, tmp_path):
    """Serve one request through a tiny ``InferenceServer`` of package
    ``which`` with a JSONL sink, under a fresh ``record`` registry; the
    lock names of its summary record."""
    prompt = np.arange(1, 6, dtype=np.int32)
    if which == "jax":
        from pytorch_distributed_training_tpu.models.gpt2 import GPT2LMModel
        from pytorch_distributed_training_tpu.serve import (
            EngineConfig,
            InferenceServer,
        )
        from pytorch_distributed_training_tpu.serve.server import wait_until
        from pytorch_distributed_training_tpu.telemetry.sink import JsonlSink
        from pytorch_distributed_training_tpu.utils.config import (
            model_preset,
        )

        model = GPT2LMModel(model_preset(
            "gpt2-tiny", compute_dtype="float32",
            attention_impl="reference", hidden_dropout=0.0,
            attention_dropout=0.0))
        params = model.init(jax.random.key(0), jnp.ones((1, 8), jnp.int32))[
            "params"]
        args = (model, params)
        cc = jax_cc
    else:
        from pytorch_distributed_training_tpu_torch.models.gpt2 import (
            GPT2LMModel,
        )
        from pytorch_distributed_training_tpu_torch.serve import (
            EngineConfig,
            InferenceServer,
        )
        from pytorch_distributed_training_tpu_torch.serve.server import (
            wait_until,
        )
        from pytorch_distributed_training_tpu_torch.telemetry.sink import (
            JsonlSink,
        )
        from pytorch_distributed_training_tpu_torch.utils.config import (
            model_preset,
        )

        args = (GPT2LMModel(model_preset("gpt2-tiny",
                                         compute_dtype="float32")),)
        cc = concurrency
    _, metrics = PAIRS[which]
    lock_reg = cc.LockRegistry(mode="record")
    prev = cc.set_lock_registry(lock_reg)
    try:
        telemetry = metrics()
        sink = JsonlSink(str(tmp_path / which), process_index=0)
        telemetry.attach_sink(sink)
        kw = {} if which == "jax" else {"device": "cpu"}
        server = InferenceServer(
            *args, EngineConfig(num_slots=1, prompt_buckets=(8,),
                                max_new_tokens=4),
            registry=telemetry, **kw).start()
        try:
            req = server.submit(prompt, max_new_tokens=3)
            assert wait_until(req.done.is_set, timeout=120)
            assert req.status == "done"
        finally:
            server.close(drain=True)
        rec = lock_reg.emit_summary(telemetry)
        sink.close()
    finally:
        cc.set_lock_registry(prev)
    assert rec["order_violations"] == 0
    return set(rec["locks"])


def test_one_request_takes_the_same_locks_as_jax(tmp_path):
    got = _serve_one("port", tmp_path)
    assert got == _serve_one("jax", tmp_path)
    assert {"serve.queue", "serve.engine.swap", "telemetry.sink",
            "telemetry.spans", "telemetry.flight"} <= got
