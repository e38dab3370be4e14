"""Port parity, asynchronous checkpoint saves (``train/checkpoint.py``; JAX
saves with orbax's ``enable_async_checkpointing``): a step saved while
training goes on restores bit-equal to the state at its step (in one
process and over gloo at fsdp 2), nothing is listed or sealed before the
join (JAX's ``verify_step`` agrees on the sealed step), a process killed
between submit and join leaves only the hidden ``.tmp-<step>`` and the
restore falls back, a pending step counts as saved, the SIGTERM drill
exits 75 with a sealed step, and ``corrupt_ckpt`` is caught after an
asynchronous save (``--device cpu``)."""

import json
import os
import socket
import subprocess
import sys
import textwrap
import time

import pytest
import torch

from pytorch_distributed_training_tpu.train import manifest as jax_manifest
from pytorch_distributed_training_tpu_torch.faults.inject import (
    FaultPlan,
    set_plan,
)
from pytorch_distributed_training_tpu_torch.faults.preemption import (
    RESUMABLE_EXIT_CODE,
)
from pytorch_distributed_training_tpu_torch.telemetry.registry import (
    MetricsRegistry,
    set_registry,
)
from pytorch_distributed_training_tpu_torch.train import checkpoint as ckpt
from pytorch_distributed_training_tpu_torch.train import manifest
from pytorch_distributed_training_tpu_torch.train.loop import Trainer
from pytorch_distributed_training_tpu_torch.utils.config import (
    TrainConfig,
    model_preset,
)

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NO_DROPOUT = dict(compute_dtype="float32", hidden_dropout=0.0,
                  attention_dropout=0.0)


@pytest.fixture(autouse=True)
def _clean_fault_state():
    yield
    set_plan(None)


def _trainer(tmp=None, **kw) -> Trainer:
    """Tiny BERT on the synthetic task, float32: 8 steps of 16."""
    tcfg = dict(num_epochs=1, train_size=128, eval_size=16,
                global_batch_size=16, micro_batch_size=8, eval_batch_size=16,
                warmup_steps=1, learning_rate=1e-3, log_every=0, bf16=False,
                weight_decay=0.01)
    if tmp is not None:
        tcfg["checkpoint_dir"] = str(tmp)
    tcfg.update(kw)
    return Trainer(model_preset("tiny", **NO_DROPOUT), TrainConfig(**tcfg),
                   task="synthetic", device="cpu")


def _whole(state) -> dict:
    return {k: (v.full_tensor() if hasattr(v, "full_tensor") else v)
            .detach().clone() for k, v in ckpt._saveable(state).items()}


def _snapshot_saves(trainer) -> dict:
    """Wrap the trainer's saves: each step's whole state at its submit."""
    seen, save = {}, trainer.checkpointer.save

    def wrapped(state):
        seen.setdefault(int(state.step), _whole(state))
        return save(state)

    trainer.checkpointer.save = wrapped
    return seen


def _assert_same(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("step", [4, 6])
def test_saved_step_restores_bit_equal_while_training_went_on(tmp_path,
                                                              step):
    """The optimizer updates weights and moments in place after each
    submit; the step on disk is still the state at its step."""
    t = _trainer(tmp_path, checkpoint_every_steps=2)
    seen = _snapshot_saves(t)
    t.run()
    assert ckpt.all_steps(str(tmp_path)) == [4, 6, 8]  # keep 3
    assert not any(n.startswith(".tmp") for n in os.listdir(tmp_path))
    assert all(s["committed"] and s["bytes"] > 0 and s["submit_s"] > 0
               for s in t.checkpointer.saves)
    fresh = _trainer()
    ckpt.Checkpointer(str(tmp_path)).restore(fresh.state, step=step)
    _assert_same(_whole(fresh.state), seen[step])
    assert any(not torch.equal(seen[step][k], v)
               for k, v in _whole(t.state).items())


def test_nothing_sealed_or_listed_before_the_join(tmp_path):
    """Before the join a step is only ``.tmp-<step>``: no listing, no
    manifest; the join renames and seals it, and the JAX package's
    ``verify_step`` passes the sealed step at every level."""
    t = _trainer()
    reg = MetricsRegistry()
    prev = set_registry(reg)
    try:
        c = ckpt.Checkpointer(str(tmp_path), verify="digest")
        c.save(t.state)
        assert c.all_steps() == [] and c.latest_step() is None
        assert os.path.isdir(tmp_path / ".tmp-0")
        assert manifest.read_manifest(str(tmp_path / "0")) is None
        c.wait()
        c.close()
    finally:
        set_registry(prev)
    path = ckpt.step_path(str(tmp_path), 0)
    assert c.all_steps() == [0] and not os.path.exists(tmp_path / ".tmp-0")
    for level in ("size", "digest"):
        assert manifest.verify_step(path, level=level) == (True, "ok")
        assert jax_manifest.verify_step(path, level=level) == (True, "ok")
    snap = reg.snapshot()
    assert snap["counters"]["checkpoint/saves"] == 1
    assert snap["timers"]["checkpoint/save_submit_s"]["count"] == 1
    assert snap["timers"]["checkpoint/join_s"]["count"] == 1
    assert c.saves[0]["join_s"] >= 0 and c.saves[0]["committed"]


def test_a_pending_step_counts_as_saved(tmp_path):
    t = _trainer()
    reg = MetricsRegistry()
    prev = set_registry(reg)
    try:
        c = ckpt.Checkpointer(str(tmp_path))
        c.save(t.state)
        c.save(t.state)          # still in flight: a duplicate, skipped
        assert [s["step"] for s in c.saves] == [0]
        c.close()
        c.save(t.state)          # sealed: verifies, skipped again
    finally:
        set_registry(prev)
    assert reg.snapshot()["counters"]["checkpoint/duplicate_skips"] == 2
    assert [s["step"] for s in c.saves] == [0]


def test_one_shot_save_is_sealed_when_it_returns(tmp_path):
    t = _trainer()
    path = ckpt.save_checkpoint(str(tmp_path), t.state)
    assert manifest.verify_step(path, level="digest") == (True, "ok")
    fresh = _trainer()
    ckpt.restore_checkpoint(str(tmp_path), fresh.state)
    _assert_same(_whole(fresh.state), _whole(t.state))


def test_corrupt_ckpt_after_an_async_save_is_caught(tmp_path):
    """``corrupt_ckpt:latest`` fires at ``close()``, after the join, on a
    sealed step; the next restore falls back to the one before."""
    set_plan(FaultPlan.parse("corrupt_ckpt:latest"))
    t = _trainer(tmp_path, checkpoint_every_steps=4)
    seen = _snapshot_saves(t)
    t.run()
    assert ckpt.all_steps(str(tmp_path)) == [4, 8]
    ok, reason = manifest.verify_step(ckpt.step_path(str(tmp_path), 8),
                                      level="digest")
    assert not ok and "digest" in reason
    fresh = _trainer()
    c = ckpt.Checkpointer(str(tmp_path), verify="digest")
    c.restore(fresh.state)
    assert fresh.state.step == 4
    _assert_same(_whole(fresh.state), seen[4])


# ------------------------------------------------------------ subprocesses

_CRASH = textwrap.dedent("""
    import os, sys
    import torch
    torch.set_num_threads(1)
    from pytorch_distributed_training_tpu_torch.train import checkpoint
    from pytorch_distributed_training_tpu_torch.train.loop import Trainer
    from pytorch_distributed_training_tpu_torch.utils.config import (
        TrainConfig, model_preset)

    t = Trainer(model_preset("tiny", compute_dtype="float32",
                             hidden_dropout=0.0, attention_dropout=0.0),
                TrainConfig(num_epochs=1, train_size=128, eval_size=16,
                            global_batch_size=16, log_every=0, bf16=False,
                            checkpoint_dir=sys.argv[1],
                            checkpoint_every_steps=1),
                task="synthetic", device="cpu")
    submit = t.checkpointer._submit

    def dying(state, step):
        submit(state, step)
        if step == 3:  # killed between the submit and its join
            os._exit(13)

    t.checkpointer._submit = dying
    t.run()
""")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


_FSDP = textwrap.dedent("""
    import json, sys
    import torch
    torch.set_num_threads(1)
    from pytorch_distributed_training_tpu_torch.cli import train_lm
    from pytorch_distributed_training_tpu_torch.comms.bootstrap import (
        shutdown)
    from pytorch_distributed_training_tpu_torch.train import checkpoint

    out, argv = sys.argv[1], json.loads(sys.argv[2])

    def whole(state):
        return {k: (v.full_tensor() if hasattr(v, "full_tensor") else v)
                .detach().clone()
                for k, v in checkpoint._saveable(state).items()}

    t = train_lm.build_trainer(train_lm.build_parser().parse_args(argv))
    seen, save = {}, t.checkpointer.save

    def wrapped(state):
        seen.setdefault(int(state.step), whole(state))
        return save(state)

    t.checkpointer.save = wrapped
    t.run()
    fresh = train_lm.build_trainer(train_lm.build_parser().parse_args(argv))
    fresh.checkpointer.restore(fresh.state, step=2)
    got, want = whole(fresh.state), seen[2]
    same = sorted(got) == sorted(want) and all(
        torch.equal(got[k], want[k]) for k in want)
    moved = any(not torch.equal(v, want[k]) for k, v in whole(t.state).items())
    sharded = sum(hasattr(v, "full_tensor")
                  for v in checkpoint._saveable(t.state).values())
    if t.info.rank == 0:
        with open(out, "w") as f:
            json.dump({"same": same, "moved": moved, "sharded": sharded,
                       "world": t.info.world_size,
                       "steps": checkpoint.all_steps(argv[argv.index(
                           "--checkpoint-dir") + 1])}, f)
    shutdown()
""")


def test_subprocess_drills_crash_sigterm_and_fsdp2_over_gloo(tmp_path):
    """Three processes at once: one killed between the submit of step 3
    and its join (only ``.tmp-3`` is left, and the restore falls back to
    step 2); ``sigterm_at_step:2`` through ``train_dp`` (exit 75, step 2
    sealed, nothing hidden left); and ``train_lm`` at fsdp 2 over gloo,
    whose step 2, restored into a fresh sharded trainer, equals the state
    at step 2 bit for bit."""
    base = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=REPO,
                OMP_NUM_THREADS="1", GLOO_SOCKET_IFNAME="lo",
                MASTER_ADDR="127.0.0.1")
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_PORT",
              "PDT_TPU_FAULT"):
        base.pop(k, None)
    crash_dir, term_dir = str(tmp_path / "crash"), str(tmp_path / "term")
    lm_dir, out = str(tmp_path / "lm"), str(tmp_path / "fsdp.json")
    argv = ["--model", "gpt2-tiny", "--device", "cpu", "--train-size", "64",
            "--eval-size", "16", "--global-batch-size", "16",
            "--micro-batch-size", "4", "--num-epochs", "1", "--seed", "7",
            "--no-bf16", "--warmup-steps", "1", "--learning-rate", "1e-3",
            "--log-every", "0", "--weight-decay", "0.01",
            "--checkpoint-dir", lm_dir, "--checkpoint-every-steps", "1"]
    port = str(_free_port())
    procs = {
        "crash": [subprocess.Popen(
            [sys.executable, "-c", _CRASH, crash_dir], cwd=REPO, env=base,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)],
        "term": [subprocess.Popen(
            [sys.executable, "-m",
             "pytorch_distributed_training_tpu_torch.cli.train_dp",
             "--model", "tiny", "--task", "synthetic", "--device", "cpu",
             "--train-size", "128", "--eval-size", "16",
             "--global-batch-size", "16", "--no-bf16", "--log-every", "0",
             "--checkpoint-dir", term_dir, "--checkpoint-every-steps", "1"],
            cwd=REPO, env=dict(base, PDT_TPU_FAULT="sigterm_at_step:2"),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)],
        "fsdp": [subprocess.Popen(
            [sys.executable, "-c", _FSDP, out, json.dumps(argv)], cwd=REPO,
            env=dict(base, MASTER_PORT=port, WORLD_SIZE="2", RANK=str(r),
                     LOCAL_RANK=str(r)),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for r in range(2)],
    }
    rcs = {}
    try:
        for name, ps in procs.items():
            for p in ps:
                _, err = p.communicate(timeout=240)
                rcs.setdefault(name, []).append((p.returncode, err[-3000:]))
    finally:
        for ps in procs.values():
            for p in ps:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
    assert [rc for rc, _ in rcs["crash"]] == [13], rcs["crash"]
    assert ckpt.all_steps(crash_dir) == [1, 2]
    assert ".tmp-3" in os.listdir(crash_dir)
    t = _trainer(crash_dir, resume=True)
    assert t.state.step == 2

    assert [rc for rc, _ in rcs["term"]] == [RESUMABLE_EXIT_CODE], rcs["term"]
    assert ckpt.all_steps(term_dir)[-1] == 2
    assert manifest.verify_step(ckpt.step_path(term_dir, 2),
                                level="digest") == (True, "ok")
    assert not any(n.startswith(".tmp") for n in os.listdir(term_dir))

    assert [rc for rc, _ in rcs["fsdp"]] == [0, 0], rcs["fsdp"]
    with open(out) as f:
        res = json.load(f)
    assert res["world"] == 2 and res["sharded"] > 0
    assert res["same"] and res["moved"]
    assert res["steps"] == [2, 3, 4]


def test_a_hung_join_aborts_under_the_watchdog(tmp_path):
    """A join that never returns is a stalled ``checkpoint_join``
    section: the watchdog records the stall and aborts with exit 84, as
    for a hung step."""
    from pytorch_distributed_training_tpu_torch.faults import watchdog

    t = _trainer()
    reg = MetricsRegistry()
    sink_records = []
    reg.attach_sink(type("Sink", (), {
        "emit": lambda self, r: sink_records.append(r),
        "flush": lambda self, **kw: None})())
    prev = set_registry(reg)
    exits = []

    def fake_exit(code):
        exits.append(code)

    wd = watchdog.Watchdog(min_stall_s=0.1, hard_timeout_s=0.5,
                           _exit=fake_exit)
    prev_wd = watchdog.set_watchdog(wd)
    try:
        c = ckpt.Checkpointer(str(tmp_path))
        c.save(t.state)
        future = c._pending[0][0]
        real = future.result

        def hung(*a, **kw):
            t0 = time.monotonic()  # wedged until the watchdog has acted
            while not exits and time.monotonic() - t0 < 30:
                time.sleep(0.05)
            return real(*a, **kw)

        future.result = hung
        c.wait()
        c.close()
    finally:
        watchdog.set_watchdog(prev_wd)
        wd.close()
        set_registry(prev)
    assert exits == [watchdog.WATCHDOG_EXIT_CODE]
    kinds = [(r["record"], r.get("section")) for r in sink_records]
    assert ("watchdog_stall", "checkpoint_join") in kinds
    assert ("watchdog_abort", "checkpoint_join") in kinds
