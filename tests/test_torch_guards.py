"""Port parity, the runtime guards (``analysis/guards.py``): the recompile
detector's counters, records and modes against JAX's on the same
scripted call sequences (a jitted function in the JAX package, an eager
one in the port: a new shape after warm-up is a recompile in both), the
build accounting, the implicit-transfer detector's routing by thread
(driven through the warning torch raises, which the CPU build cannot
raise itself) and its no-op on the CPU, the lock boundary, the sharding
audit over FSDP2 on two gloo ranks against JAX's on its 8-device CPU
mesh (the same leaves, the same record fields), and the acceptance
runs: a strict 3-step CPU train run and a strict two-bucket serve
session with zero violations, and a forced serve recompile that fails
the strict loop closed. Every comparison is exact (counts, records)."""

import json
import os
import subprocess
import sys
import threading
import time
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_training_tpu.analysis import guards as jax_guards
from pytorch_distributed_training_tpu.telemetry.registry import (
    MetricsRegistry as JaxRegistry,
)
from pytorch_distributed_training_tpu_torch.analysis import concurrency
from pytorch_distributed_training_tpu_torch.analysis import guards
from pytorch_distributed_training_tpu_torch.analysis.guards import (
    GuardedCall,
    GuardSet,
    GuardViolation,
    RecompileError,
    TransferGuardError,
    explicit_transfer,
    guard_mode_from_env,
)
from pytorch_distributed_training_tpu_torch.ops import _build
from pytorch_distributed_training_tpu_torch.telemetry.registry import (
    MetricsRegistry,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class ListSink:
    def __init__(self):
        self.records = []

    def emit(self, record):
        self.records.append(dict(record))

    def flush(self, **kw):
        pass

    def of(self, kind):
        return [r for r in self.records if r.get("record") == kind]


def _guards(mode, jax_side=False):
    reg = JaxRegistry() if jax_side else MetricsRegistry()
    sink = ListSink()
    reg.attach_sink(sink)
    cls = jax_guards.GuardSet if jax_side else GuardSet
    return cls(mode=mode, registry=reg), sink


def _script(gs, wrap, make, shapes):
    """Call ``wrap("f", fn)`` on ``make(shape)`` for each shape; the
    outcome of each call (its value's sum, or the error's class)."""
    f = wrap("f", gs)
    out = []
    for shape in shapes:
        try:
            out.append(float(np.asarray(f(make(shape))).sum()))
        except GuardViolation as e:
            out.append(type(e).__name__)
        except jax_guards.GuardViolation as e:
            out.append(type(e).__name__)
    return out


def _jax_f(name, gs):
    return gs.wrap_jit(name, jax.jit(lambda x: x * 2))


def _port_f(name, gs):
    return gs.wrap(name, lambda x: x * 2)


SEQUENCES = {
    "warm-then-new-shape": ((2,), (2,), (3,), (3,), (2,)),
    "one-shape": ((4,), (4,), (4,)),
    "every-call-new": ((1,), (2,), (3,), (4,)),
}


@pytest.mark.parametrize("mode", ["strict", "record", "off"])
@pytest.mark.parametrize("seq", sorted(SEQUENCES))
def test_recompile_counts_records_and_modes_match_jax(mode, seq):
    """Exact: each call's outcome, the violation counters, the registry's
    counters and the ``recompile`` records (name, calls, recompiles)
    equal JAX's."""
    shapes = SEQUENCES[seq]
    jgs, jsink = _guards(mode, jax_side=True)
    pgs, psink = _guards(mode)
    jout = _script(jgs, _jax_f, lambda s: jnp.ones(s), shapes)
    pout = _script(pgs, _port_f, lambda s: torch.ones(s), shapes)
    assert pout == jout
    assert (pgs.recompile_violations, pgs.transfer_violations) == (
        jgs.recompile_violations, jgs.transfer_violations)
    assert pgs.registry.snapshot()["counters"] == (
        jgs.registry.snapshot()["counters"])
    # ``traces``: JAX counts the jaxprs a retrace makes (one or two here:
    # the function, and the multiply at a new weak type), the port one
    # for a new signature (and one a kernel build): compared as >= 1
    def untraced(records):
        return [{k: v for k, v in r.items() if k != "traces"}
                for r in records]

    assert untraced(psink.records) == untraced(jsink.records)
    assert all(r["traces"] >= 1 for r in psink.records + jsink.records)
    assert pgs.wrapped["f"].calls == jgs.wrapped["f"].calls


def test_recompile_strict_raises_and_records():
    gs, sink = _guards("strict")
    f = gs.wrap("f", lambda x: x * 2)
    f(torch.ones(2))
    f(torch.ones(2))
    assert gs.violations == 0 and not sink.of("recompile")
    with pytest.raises(RecompileError, match="retraced after warm-up"):
        f(torch.ones(3))
    (rec,) = sink.of("recompile")
    assert rec["name"] == "f" and rec["calls"] == 3
    assert gs.registry.snapshot()["counters"]["guards/recompiles"] == 1


def test_signature_covers_dtype_device_values_and_nesting():
    sig = guards.call_signature
    a = ({"x": torch.ones(2, 3)}, [np.zeros(4, np.int32)], 7, "k")
    assert sig(a, {}) == sig(({"x": torch.zeros(2, 3)},
                             [np.ones(4, np.int32)], 7, "k"), {})
    for b in (({"x": torch.ones(2, 3, dtype=torch.float64)},
               [np.zeros(4, np.int32)], 7, "k"),
              ({"x": torch.ones(2, 3)}, [np.zeros(4, np.int64)], 7, "k"),
              ({"x": torch.ones(2, 3)}, [np.zeros(4, np.int32)], 8, "k"),
              ({"y": torch.ones(2, 3)}, [np.zeros(4, np.int32)], 7, "k")):
        assert sig(b, {}) != sig(a, {})
    # a float's value and an object's contents are data, not the program
    assert sig((1.5, object()), {}) == sig((2.5, object()), {})


def test_kernel_build_in_a_warm_call_is_a_recompile():
    """A library compiled inside a warm call (the port's "retrace") is a
    violation; inside the warm-up call it is expected."""
    gs, sink = _guards("record")
    builds = iter([1, 0, 2])

    def step(x):
        for _ in range(next(builds)):
            _build.note_build()
        return x

    f = gs.wrap("step", step)
    f(torch.ones(1))            # warm-up builds one: fine
    f(torch.ones(1))
    f(torch.ones(1))            # two builds after warm-up
    (rec,) = sink.of("recompile")
    assert (rec["calls"], rec["traces"], rec["recompiles"]) == (3, 2, 1)
    assert gs.recompile_violations == 1


def test_guard_off_is_passthrough_and_wrap_is_idempotent():
    gs, sink = _guards("off")
    f = gs.wrap("f", lambda x: x + 1)
    f(torch.ones(2))
    f(torch.ones(7))
    assert gs.violations == 0 and sink.records == []
    gs, _ = _guards("record")
    g = gs.wrap("g", np.add)
    assert gs.wrap("g", g) is g
    assert isinstance(g, GuardedCall) and not g.warm


def test_guard_mode_from_env_matches_jax(monkeypatch):
    for value in (None, "off", "record", "strict", "nope"):
        if value is None:
            monkeypatch.delenv("PDT_TPU_GUARDS", raising=False)
        else:
            monkeypatch.setenv("PDT_TPU_GUARDS", value)
        got = want = None
        for fn in (guard_mode_from_env, jax_guards.guard_mode_from_env):
            try:
                res = ("ok", fn())
            except ValueError as e:
                res = ("err", str(e))
            got, want = (res, want) if got is None else (got, res)
        assert got == want
    assert concurrency.guard_mode_from_env is guard_mode_from_env
    with pytest.raises(ValueError, match="guards mode"):
        GuardSet(mode="nope")


# ----------------------------------------------------- transfer detector


@pytest.fixture
def fake_sync_mode(monkeypatch):
    """torch's sync debug mode on a CPU build: the setter recorded, the
    sync warning raised by hand (``sync``) as torch raises it."""
    calls = []
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", lambda: 0)
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode",
                        lambda mode: calls.append(mode))
    monkeypatch.setattr(guards, "_cuda_live", lambda: True)
    saved = warnings.showwarning, list(warnings.filters)
    monkeypatch.setattr(guards, "_DETECTOR", guards._SyncDetector())
    yield calls
    warnings.showwarning = saved[0]
    warnings.filters[:] = saved[1]


def sync():
    warnings.warn("called a synchronizing CUDA operation", UserWarning)


def test_transfer_scope_strict_raises_on_its_own_thread_only(
        fake_sync_mode):
    gs, sink = _guards("strict")
    with pytest.raises(TransferGuardError, match="implicit transfer"):
        with gs.transfer_scope("tick"):
            sync()
    (rec,) = sink.of("implicit_transfer")
    assert rec["name"] == "tick" and "synchronizing" in rec["error"]
    # another thread's sync while this one is armed: no raise, no count
    errors = []

    def other():
        try:
            sync()
        except Exception as e:  # noqa: BLE001 - the assertion below
            errors.append(e)

    with gs.transfer_scope("tick"):
        t = threading.Thread(target=other)
        t.start()
        t.join(30)
        with explicit_transfer():
            sync()          # an intended copy is not a violation
    assert errors == [] and gs.transfer_violations == 1
    # the mode went to warn while armed and back after each scope
    assert fake_sync_mode == ["warn", 0, "warn", 0]
    sync()                  # unarmed: nothing counted
    assert gs.transfer_violations == 1


def test_transfer_record_counts_and_warm_calls_arm(fake_sync_mode):
    gs, sink = _guards("record")

    def step(x):
        sync()
        return x

    f = gs.wrap("step", step)
    f(torch.ones(2))            # the warm-up call is not armed
    f(torch.ones(2))            # armed: recorded, not raised
    f(torch.ones(2))
    assert gs.transfer_violations == 2
    assert [r["name"] for r in sink.of("implicit_transfer")] == ["step"] * 2
    assert gs.registry.snapshot()["counters"][
        "guards/implicit_transfers"] == 2
    # other warnings still reach the previous handler
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        warnings.warn("something else", UserWarning)
    assert [str(w.message) for w in seen] == ["something else"]


def test_detector_is_a_no_op_on_the_cpu(monkeypatch):
    """No CUDA in this process: arming does nothing and never calls into
    ``torch.cuda``."""
    def boom(*a, **k):
        raise AssertionError("touched torch.cuda")

    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", boom)
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", boom)
    gs, sink = _guards("strict")
    f = gs.wrap("f", lambda x: x.sum().item())
    f(torch.ones(3))
    f(torch.ones(3))
    with gs.transfer_scope("tick"):
        torch.ones(2).sum().item()
    assert gs.violations == 0 and sink.records == []


def test_lock_held_across_a_device_boundary():
    reg = concurrency.LockRegistry(mode="record")
    prev = concurrency.set_lock_registry(reg)
    try:
        lk = concurrency.lock("test.guards.boundary", registry=reg)
        for mode in ("record", "strict"):
            gs, _ = _guards(mode)
            f = gs.wrap("f", lambda x: x)
            with lk:
                if mode == "strict":
                    with pytest.raises(GuardViolation, match="holding"):
                        f(torch.ones(1))
                    with pytest.raises(GuardViolation, match="holding"):
                        with gs.transfer_scope("tick"):
                            pass
                else:
                    f(torch.ones(1))
        assert reg.device_boundary_holds == 3
    finally:
        concurrency.set_lock_registry(prev)


# ------------------------------------------------------- sharding audit


_AUDIT_CHILD = r"""
import json, sys, torch, torch.distributed as dist
rank, port, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        rank=rank, world_size=2)
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.fsdp import fully_shard
from pytorch_distributed_training_tpu_torch.analysis.guards import (
    GuardViolation, sharding_audit)
from pytorch_distributed_training_tpu_torch.comms.mesh import build_mesh
from pytorch_distributed_training_tpu_torch.utils.config import MeshConfig

class Params(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.big = torch.nn.Parameter(torch.zeros(64, 64))
        self.small = torch.nn.Parameter(torch.zeros(4))

class Model(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.p = Params()
        self.sharded = torch.nn.Linear(64, 64, bias=False)

model = Model()
fully_shard(model.sharded, mesh=init_device_mesh("cpu", (2,)))
names = {"p.big": "big", "p.small": "small", "sharded.weight": "sharded"}
params = [(names[n], t) for n, t in model.named_parameters()]
res = {}
mesh = build_mesh(MeshConfig(data=1, fsdp=2), rank=rank, world_size=2)
res["record"] = sharding_audit(params, mesh, min_bytes=1024)
try:
    sharding_audit(params, mesh, min_bytes=1024, mode="strict")
except GuardViolation as e:
    res["strict"] = str(e)
dp = build_mesh(MeshConfig(data=2), rank=rank, world_size=2)
res["dp"] = sharding_audit(params, dp, min_bytes=1024, mode="strict")
if rank == 0:
    json.dump(res, open(out, "w"))
dist.destroy_process_group()
"""


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_sharding_audit_fsdp2_two_gloo_ranks_matches_jax(eight_devices,
                                                         tmp_path):
    """The leaves of JAX's ``test_sharding_audit_flags_replicated_on_
    sharded_mesh``: a 64x64 float32 leaf whole, a small one whole, a
    64x64 one sharded over fsdp. JAX on its 8-device mesh (data 4, fsdp
    2), the port over FSDP2 on two gloo ranks (fsdp 2): the same flagged
    leaf and bytes, the same record fields, strict raises in both, and a
    data-only mesh audits clean in both."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from pytorch_distributed_training_tpu.comms.mesh import (
        build_mesh as jax_mesh,
    )
    from pytorch_distributed_training_tpu.utils.config import (
        MeshConfig as JaxMeshConfig,
    )

    out = str(tmp_path / "audit.json")
    port = str(_free_port())
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1",
               GLOO_SOCKET_IFNAME="lo")
    procs = [subprocess.Popen([sys.executable, "-c", _AUDIT_CHILD, str(r),
                               port, out], env=env, cwd=REPO)
             for r in range(2)]
    assert [p.wait(120) for p in procs] == [0, 0]
    got = json.load(open(out))

    mesh = jax_mesh(JaxMeshConfig(data=4, fsdp=2))
    params = {
        "big": jax.device_put(jnp.zeros((64, 64), jnp.float32),
                              NamedSharding(mesh, P())),
        "small": jax.device_put(jnp.zeros((4,), jnp.float32),
                                NamedSharding(mesh, P())),
        "sharded": jax.device_put(jnp.zeros((64, 64), jnp.float32),
                                  NamedSharding(mesh, P("fsdp"))),
    }
    reg = JaxRegistry()
    want = jax_guards.sharding_audit(params, mesh, min_bytes=1024,
                                     registry=reg)
    rec = got["record"]
    assert set(rec) == set(want)
    assert [f["path"] for f in rec["flagged"]] == ["big"]
    assert [f["path"] for f in want["flagged"]] == ["['big']"]
    assert [f["bytes"] for f in rec["flagged"]] == [
        f["bytes"] for f in want["flagged"]] == [16384]
    for key in ("record", "name", "min_bytes", "replicated_bytes", "ok"):
        assert rec[key] == want[key], key
    assert rec["mesh_shape"]["fsdp"] == want["mesh_shape"]["fsdp"] == 2
    with pytest.raises(jax_guards.GuardViolation, match="sharding audit"):
        jax_guards.sharding_audit(params, mesh, min_bytes=1024,
                                  registry=reg, mode="strict")
    assert "sharding audit 'params'" in got["strict"]
    assert got["dp"]["ok"] and got["dp"]["flagged"] == []


# ------------------------------------------------ trainer acceptance


def _tiny_trainer(tmp_path, **kw):
    from pytorch_distributed_training_tpu_torch.train.loop import Trainer
    from pytorch_distributed_training_tpu_torch.utils.config import (
        TrainConfig,
        model_preset,
    )

    cfg = dict(num_epochs=1, global_batch_size=32, micro_batch_size=16,
               eval_batch_size=32, learning_rate=3e-3, warmup_steps=10,
               log_every=0, bf16=False, train_size=96, eval_size=40,
               guards="strict", metrics_dir=str(tmp_path / "m"),
               native_loader="off", prefetch_depth=0)
    cfg.update(kw)
    return Trainer(model_preset("tiny", compute_dtype="float32"),
                   TrainConfig(**cfg), task="synthetic", device="cpu")


def test_train_3_steps_zero_retraces_strict(tmp_path):
    """Acceptance (JAX ``test_train_3_steps_zero_retraces_strict``): 3 steps
    and an eval with a padded last batch under strict guards: no
    recompile, no implicit transfer, the audits ran and passed, the
    compile record before the first step, the guarded steps called."""
    t = _tiny_trainer(tmp_path)
    assert len(t.run()) == 1
    with open(tmp_path / "m" / "metrics.jsonl") as f:
        records = [json.loads(line) for line in f if line.strip()]
    kinds = [r["record"] for r in records]
    assert kinds[0] == "run_meta"
    assert "recompile" not in kinds and "implicit_transfer" not in kinds
    assert t.guards.violations == 0
    assert kinds.index("compile") < kinds.index("step")
    assert len([k for k in kinds if k == "step"]) == 3
    (shard_rec,) = [r for r in records if r["record"] == "sharding_audit"]
    (comm_rec,) = [r for r in records if r["record"] == "comm_audit"]
    assert shard_rec["ok"] and comm_rec["ok"] and comm_rec["count"] == 0
    assert t.guards.wrapped["train_step"].calls == 3
    assert t.guards.wrapped["eval_step"].calls == 2
    assert not any(r.get("compile_inclusive") for r in records
                   if r["record"] == "step")


def test_trainer_guards_off_unwrapped(tmp_path):
    t = _tiny_trainer(tmp_path, guards="off", train_size=32)
    t.run()
    assert not isinstance(t.train_step, GuardedCall)
    assert t.guards.wrapped == {}


# -------------------------------------------------- serve acceptance


def _server(gs, buckets, slots, warmup=False):
    from pytorch_distributed_training_tpu_torch.models.gpt2 import (
        GPT2LMModel,
    )
    from pytorch_distributed_training_tpu_torch.serve import (
        EngineConfig,
        InferenceServer,
    )
    from pytorch_distributed_training_tpu_torch.utils.config import (
        model_preset,
    )

    cfg = model_preset("gpt2-tiny", compute_dtype="float32",
                       attention_impl="reference", hidden_dropout=0.0,
                       attention_dropout=0.0)
    model = GPT2LMModel(cfg, generator=torch.Generator().manual_seed(0))
    return cfg, InferenceServer(
        model, EngineConfig(num_slots=slots, prompt_buckets=buckets,
                            max_new_tokens=4, warmup=warmup),
        device="cpu", queue_depth=16, registry=gs.registry,
        guards=gs).start()


@pytest.mark.parametrize("warmup", [False, True],
                         ids=["cold", "warmed"])
def test_serve_two_bucket_session_zero_retraces_strict(warmup):
    """Acceptance (JAX's twin): a session over two prompt buckets, each
    serving several requests through slot reuse, recompiles nothing after
    each program's warm-up call, under strict guards. A warmed engine
    audits its hot program's collectives once (none on one device); a
    cold one, as JAX's, audits nothing."""
    from pytorch_distributed_training_tpu_torch.serve.server import (
        wait_until,
    )

    gs, sink = _guards("strict")
    cfg, server = _server(gs, (4, 8), 2, warmup)
    try:
        rng = np.random.default_rng(3)
        reqs = [server.submit(rng.integers(1, cfg.vocab_size, n)
                              .astype(np.int32), max_new_tokens=4)
                for n in (3, 6, 2, 7, 4, 5)]
        assert wait_until(lambda: all(r.done.is_set() for r in reqs),
                          timeout=120)
    finally:
        server.close()
    assert all(r.status == "done" for r in reqs)
    stats = server.stats()
    assert stats["prefill_buckets_used"] == [4, 8]
    assert (stats["guard_mode"], stats["guard_recompiles"],
            stats["guard_implicit_transfers"]) == ("strict", 0, 0)
    assert not sink.of("recompile") and not sink.of("implicit_transfer")
    for name in ("serve_prefill_b4", "serve_prefill_b8", "serve_decode"):
        assert gs.wrapped[name].calls >= 2, name
    if not warmup:
        assert not sink.of("comm_audit") and stats["comm_audit"] is None
        return
    (audit,) = sink.of("comm_audit")      # the hot program, once
    assert audit["ok"] and audit["name"] == "serve_decode"
    assert audit["count"] == 0 and stats["comm_audit"] == audit
    assert stats["warmup_dispatches"] == {
        "serve_prefill_b4": 1, "serve_prefill_b8": 1, "serve_decode": 1}


def test_serve_retrace_violation_fails_loop_and_records():
    """Negative (JAX's twin): widen the block table behind the warm
    programs' back, so the next prefill dispatches a new shape: the
    violation is recorded and the strict loop fails closed, every
    waiter's done event still firing."""
    from pytorch_distributed_training_tpu_torch.serve.server import (
        wait_until,
    )

    gs, sink = _guards("strict")
    _, server = _server(gs, (4,), 1)
    prompt = np.arange(1, 4, dtype=np.int32)
    try:
        first = server.submit(prompt, max_new_tokens=4)
        assert wait_until(lambda: first.done.is_set(), timeout=120)
        assert first.status == "done"
        pages = server.engine._pages
        pages.block_table = np.concatenate(
            [pages.block_table, np.zeros_like(pages.block_table[:, :1])], 1)
        second = server.submit(prompt, max_new_tokens=4)
        assert wait_until(lambda: second.done.is_set(), timeout=120)
        assert second.status in ("cancelled", "expired", "error")
        assert gs.recompile_violations >= 1 and sink.of("recompile")
        assert server.loop_dead()
    finally:
        server.close(drain=False)
    time.sleep(0)
