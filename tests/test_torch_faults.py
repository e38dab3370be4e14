"""Port parity, the fault core: the PyTorch package's fault injection,
watchdog, preemption handling and supervisor (``faults/``,
``utils/supervisor.py``, ``cli/__init__.py``), mirroring the JAX
package's ``tests/test_faults.py:124-361, 396-482, 716-881`` on the port's
Trainer, on the CPU.

Parsed specs equal JAX's field for field (and the same strings are
refused); a supervised restart after an injected crash, a resume after a
SIGTERM's emergency checkpoint and a run that fell back past a corrupted
step end on the uninterrupted run's weights and moments bit for bit; the
exit codes are exact (75 preempted, 84 watchdog abort, 13 the hard crash).
"""

import json
import os
import random
import signal
import subprocess
import sys
import threading
import time
from types import SimpleNamespace

import pytest
import torch

from pytorch_distributed_training_tpu.faults import inject as jax_inject
from pytorch_distributed_training_tpu_torch.cli import run_supervised
from pytorch_distributed_training_tpu_torch.faults import inject
from pytorch_distributed_training_tpu_torch.faults.inject import (
    FaultPlan,
    InjectedCrash,
    corrupt_step_dir,
    set_plan,
)
from pytorch_distributed_training_tpu_torch.faults.preemption import (
    RESUMABLE_EXIT_CODE,
    GracefulShutdown,
    Preempted,
)
from pytorch_distributed_training_tpu_torch.faults.watchdog import (
    WATCHDOG_EXIT_CODE,
    Watchdog,
    set_watchdog,
    watchdog_guard,
)
from pytorch_distributed_training_tpu_torch.telemetry.registry import (
    MetricsRegistry,
    set_registry,
)
from pytorch_distributed_training_tpu_torch.telemetry.sink import JsonlSink
from pytorch_distributed_training_tpu_torch.train import checkpoint as ckpt
from pytorch_distributed_training_tpu_torch.train import manifest
from pytorch_distributed_training_tpu_torch.train.loop import Trainer
from pytorch_distributed_training_tpu_torch.utils import supervisor
from pytorch_distributed_training_tpu_torch.utils.config import (
    TrainConfig,
    model_preset,
)
from pytorch_distributed_training_tpu_torch.utils.supervisor import (
    run_with_restarts,
)

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["--model", "tiny", "--task", "synthetic", "--device", "cpu",
        "--train-size", "64", "--eval-size", "16", "--global-batch-size",
        "16", "--micro-batch-size", "8", "--eval-batch-size", "16",
        "--num-epochs", "1", "--log-every", "0", "--max-seq-length", "32",
        "--warmup-steps", "1", "--learning-rate", "1e-3"]


def _trainer(**kw) -> Trainer:
    """Tiny BERT, dropout on: 4 updates of 16 = 2 x 8."""
    tcfg = dict(num_epochs=1, train_size=64, eval_size=16,
                global_batch_size=16, micro_batch_size=8,
                eval_batch_size=16, warmup_steps=1, learning_rate=1e-3,
                log_every=0, max_seq_length=32)
    tcfg.update(kw)
    return Trainer(model_preset("tiny"), TrainConfig(**tcfg),
                   task="synthetic", device="cpu")


def _state(t: Trainer) -> dict:
    return {k: v.detach().clone() for k, v in ckpt._saveable(t.state).items()}


def _same(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def _records(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope="module")
def baseline(tmp_path_factory):
    """The uninterrupted run, saving at steps 2 and 4."""
    d = str(tmp_path_factory.mktemp("baseline") / "ck")
    t = _trainer(checkpoint_dir=d, checkpoint_every_steps=2)
    t.run()
    assert t.state.step == 4
    return _state(t), d


# ----------------------------------------------------------- the parser


SPECS = ["crash_at_step:7", "sigterm_at_step:5@1", "hang_at_step:3",
         "corrupt_ckpt:latest", "corrupt_ckpt:12", "slow_host:2.5x",
         "slow_host:2", "replica_crash:3", "replica_crash:t3.5",
         "replica_hang:3", "replica_hang:3:0.5", "replica_slow:3:4x",
         "replica_slow:t1:2", "corrupt_ckpt_swap:0", "swap_crash:12@2",
         "swap_slow:12", "swap_slow:12:3"]
BAD = ["crash_at_step:0", "crash_at_step:x", "nope:1", "crash_at_step",
       "slow_host:0.5x", "slow_host:fast", "corrupt_ckpt:soon",
       "replica_crash:0", "replica_crash:t0", "replica_crash:3:1",
       "replica_hang:3:0", "replica_hang:3:1:2", "replica_slow:3",
       "replica_slow:3:0.5x", "corrupt_ckpt_swap:-1", "swap_crash:1:2",
       "swap_slow:1:0", "swap_slow:1:2:3"]


@pytest.mark.parametrize("text", SPECS)
def test_fault_spec_parsing_matches_jax(text):
    got, want = inject._parse_spec(text), jax_inject._parse_spec(text)
    for f in ("kind", "step", "at_s", "target", "factor", "rank", "fired"):
        assert getattr(got, f) == getattr(want, f), f
    plan = FaultPlan.parse(f" {text} , crash_at_step:9@1 ")
    assert [s.kind for s in plan.specs] == [
        s.kind for s in jax_inject.FaultPlan.parse(
            f" {text} , crash_at_step:9@1 ").specs]


@pytest.mark.parametrize("bad", BAD)
def test_fault_spec_parsing_rejects_what_jax_rejects(bad):
    with pytest.raises(ValueError):
        jax_inject._parse_spec(bad)
    with pytest.raises(ValueError):
        inject._parse_spec(bad)


def test_crash_fault_fires_exactly_once():
    plan = FaultPlan.parse("crash_at_step:2")
    plan.fire_step_fault(1)
    with pytest.raises(InjectedCrash):
        plan.fire_step_fault(2)
    plan.fire_step_fault(2)  # a restarted attempt does not fire it again
    FaultPlan.parse("crash_at_step:2@1").fire_step_fault(2)  # other rank


def test_slow_host_stays_armed_and_stretches():
    plan = FaultPlan.parse("slow_host:3x")
    t0 = time.perf_counter()
    plan.slow_host_delay(0.02)
    plan.slow_host_delay(0.02)
    assert time.perf_counter() - t0 >= 0.075
    t0 = time.perf_counter()
    FaultPlan.parse("slow_host:100x@1").slow_host_delay(1.0)
    assert time.perf_counter() - t0 < 0.5


def test_get_plan_parses_env_once(monkeypatch):
    prev = set_plan(None)
    try:
        monkeypatch.setenv("PDT_TPU_FAULT", "crash_at_step:11")
        plan = inject.get_plan()
        assert [s.step for s in plan.specs] == [11]
        monkeypatch.setenv("PDT_TPU_FAULT", "crash_at_step:99")
        assert inject.get_plan() is plan
    finally:
        set_plan(prev)


def test_corrupt_step_dir_targets_largest_file_same_size(tmp_path):
    (tmp_path / "small").write_bytes(b"a" * 10)
    (tmp_path / "big").write_bytes(b"b" * 100)
    (tmp_path / manifest.MANIFEST_NAME).write_bytes(b"c" * 1000)
    victim = corrupt_step_dir(str(tmp_path))
    assert victim == str(tmp_path / "big")
    data = (tmp_path / "big").read_bytes()
    assert len(data) == 100 and data[:64] != b"b" * 64
    assert data[64:] == b"b" * 36
    assert (tmp_path / manifest.MANIFEST_NAME).read_bytes() == b"c" * 1000


# ------------------------------------------------------------- watchdog


def _reg_with_sink(tmp_path):
    reg, sink = MetricsRegistry(), JsonlSink(str(tmp_path))
    reg.attach_sink(sink)
    return reg, sink


def test_watchdog_stall_and_recover_records(tmp_path):
    reg, sink = _reg_with_sink(tmp_path)
    prev = set_registry(reg)
    wd = Watchdog(stall_factor=1.0, min_stall_s=0.05, hard_timeout_s=0)
    try:
        with wd.guard("train_step", step=3):
            time.sleep(0.25)
    finally:
        wd.close()
        set_registry(prev)
        sink.close()
    recs = _records(tmp_path / "metrics.jsonl")
    kinds = [r["record"] for r in recs]
    assert kinds == ["watchdog_stall", "watchdog_recovered"]
    stall, rec = recs
    assert stall["section"] == "train_step" and stall["step"] == 3
    assert "thread" in stall["stacks"] and stall["hard_timeout_s"] == 0
    assert rec["duration_s"] >= 0.25


def test_watchdog_hard_timeout_aborts_with_exit_code(tmp_path):
    reg, sink = _reg_with_sink(tmp_path)
    prev = set_registry(reg)
    exits = []
    done = threading.Event()

    def fake_exit(code):
        exits.append(code)
        done.set()

    wd = Watchdog(stall_factor=1.0, min_stall_s=0.05, hard_timeout_s=0.2,
                  _exit=fake_exit)
    try:
        with wd.guard("checkpoint_save", step=4):
            assert done.wait(timeout=10)
    finally:
        wd.close()
        set_registry(prev)
        sink.close()
    assert exits == [WATCHDOG_EXIT_CODE] == [84]
    kinds = [r["record"] for r in _records(tmp_path / "metrics.jsonl")]
    assert kinds[0] == "watchdog_stall" and "watchdog_abort" in kinds


def test_watchdog_threshold_tracks_rolling_median():
    wd = Watchdog(stall_factor=10.0, min_stall_s=1.0)
    assert wd.stall_after_s("s") == 1.0
    for v in (0.2, 0.3, 5.0):
        wd.observe("s", v)
    assert wd.stall_after_s("s") == 3.0  # 10 x the median 0.3


def test_watchdog_rejects_bad_thresholds():
    for kw in (dict(stall_factor=0), dict(min_stall_s=-1),
               dict(hard_timeout_s=-1)):
        with pytest.raises(ValueError, match="thresholds"):
            Watchdog(**kw)


def test_watchdog_guard_without_install_is_noop():
    prev = set_watchdog(None)
    try:
        with watchdog_guard("anything", step=1):
            pass
    finally:
        set_watchdog(prev)


def test_graceful_shutdown_flag_install_uninstall():
    before = signal.getsignal(signal.SIGTERM)
    with GracefulShutdown() as gs:
        assert gs.installed and gs.requested is None
        os.kill(os.getpid(), signal.SIGTERM)
        time.sleep(0.05)
        assert gs.requested == signal.SIGTERM
    assert signal.getsignal(signal.SIGTERM) is before


def test_preempted_carries_resumable_exit_code():
    exc = Preempted(signal.SIGTERM, step=12)
    assert isinstance(exc, SystemExit)
    assert exc.code == RESUMABLE_EXIT_CODE == 75
    assert exc.step == 12
    assert "SIGTERM" in str(exc) and "75" in str(exc)


# ----------------------------------------------------------- supervisor


class _FakeTime:
    """sleep() advances monotonic()."""

    def __init__(self):
        self.now = 0.0
        self.sleeps = []

    def monotonic(self):
        return self.now

    def sleep(self, s):
        self.sleeps.append(s)
        self.now += s


@pytest.fixture
def fake_time(monkeypatch):
    ft = _FakeTime()
    monkeypatch.setattr(supervisor, "time", ft)
    return ft


def test_supervisor_jitter_stays_in_bounds(fake_time):
    calls = []

    def attempt(i):
        calls.append(i)
        if i < 4:
            raise RuntimeError("flaky host")
        return "ok"

    out = run_with_restarts(attempt, max_restarts=4, backoff_s=2.0,
                            backoff_factor=3.0, max_backoff_s=10.0,
                            _rng=random.Random(0))
    assert out == "ok" and calls == [0, 1, 2, 3, 4]
    assert len(fake_time.sleeps) == 4
    assert all(2.0 <= s <= 10.0 for s in fake_time.sleeps)
    assert fake_time.sleeps != [2.0, 6.0, 10.0, 10.0]


def test_supervisor_lifetime_budget_exhausts(fake_time):
    calls = []

    def attempt(i):
        calls.append(i)
        raise RuntimeError("deterministic bug")

    with pytest.raises(RuntimeError, match="deterministic bug"):
        run_with_restarts(attempt, max_restarts=2, backoff_s=1.0,
                          jitter=False)
    assert calls == [0, 1, 2]
    assert fake_time.sleeps == [1.0, 2.0]


def test_supervisor_sliding_window_lets_old_restarts_expire(fake_time):
    calls = []

    def attempt(i):
        calls.append(i)
        if i < 4:
            raise RuntimeError("occasional failure")
        return "done"

    out = run_with_restarts(attempt, max_restarts=2, backoff_s=5.0,
                            backoff_factor=1.0, jitter=False,
                            restart_window_s=8.0)
    assert out == "done" and calls == [0, 1, 2, 3, 4]


def test_supervisor_window_still_stops_a_crash_loop(fake_time):
    calls = []

    def attempt(i):
        calls.append(i)
        raise RuntimeError("tight crash loop")

    with pytest.raises(RuntimeError):
        run_with_restarts(attempt, max_restarts=2, backoff_s=1.0,
                          backoff_factor=1.0, jitter=False,
                          restart_window_s=100.0)
    assert calls == [0, 1, 2]


def test_supervisor_preempted_passes_through(fake_time):
    calls = []

    def attempt(i):
        calls.append(i)
        raise Preempted(signal.SIGTERM, step=3)

    with pytest.raises(Preempted) as exc:
        run_with_restarts(attempt, max_restarts=5, backoff_s=1.0)
    assert exc.value.code == RESUMABLE_EXIT_CODE
    assert calls == [0] and fake_time.sleeps == []


# --------------------------------------------------- end-to-end recovery


def test_crash_supervised_restart_resumes_bitwise(baseline, tmp_path):
    want, _ = baseline
    d = str(tmp_path / "ck")
    mdir = str(tmp_path / "m")
    attempts = []
    prev = set_plan(FaultPlan.parse("crash_at_step:3"))
    try:
        def attempt(i):
            attempts.append(i)
            t = _trainer(checkpoint_dir=d, checkpoint_every_steps=2,
                         resume=i > 0, metrics_dir=mdir)
            t.run()
            return t

        t = run_with_restarts(attempt, max_restarts=1, backoff_s=0.01,
                              jitter=False, checkpoint_dir=d)
    finally:
        set_plan(prev)
    assert attempts == [0, 1] and t.state.step == 4
    _same(_state(t), want)
    recs = _records(os.path.join(mdir, "metrics.jsonl"))
    kinds = [r["record"] for r in recs]
    assert kinds.count("run_meta") == 2
    restart = recs[kinds.index("restart")]
    assert restart["will_retry"] and restart["resume_step"] == 2
    assert restart["error"] == "InjectedCrash"
    assert recs[kinds.index("checkpoint_restore")]["step"] == 2
    assert kinds.index("fault_injected") < kinds.index("restart")


def test_sigterm_emergency_checkpoint_then_equal_resume(baseline, tmp_path):
    want, _ = baseline
    d = str(tmp_path / "ck")
    mdir = str(tmp_path / "m")
    prev = set_plan(FaultPlan.parse("sigterm_at_step:2"))
    try:
        t = _trainer(checkpoint_dir=d, metrics_dir=mdir)
        with pytest.raises(Preempted) as exc:
            t.run()
    finally:
        set_plan(prev)
    assert exc.value.code == RESUMABLE_EXIT_CODE
    assert ckpt.verified_latest_step(d, level="digest") == 2
    recs = _records(os.path.join(mdir, "metrics.jsonl"))
    pre = [r for r in recs if r["record"] == "preemption"]
    assert len(pre) == 1 and pre[0]["signal"] == signal.SIGTERM
    assert pre[0]["saved_step"] == 2 and pre[0]["step"] == 2
    assert pre[0]["save_wall_s"] <= pre[0]["grace_s"]
    assert any(r["record"] == "fault_injected" for r in recs)
    resumed = _trainer(checkpoint_dir=d, resume=True,
                       checkpoint_every_steps=2)
    assert resumed.state.step == 2
    assert len(resumed.run()) == 1 and resumed.state.step == 4
    _same(_state(resumed), want)


def test_corrupt_ckpt_falls_back_then_heals(baseline, tmp_path):
    want, src = baseline
    import shutil

    d = str(tmp_path / "ck")
    shutil.copytree(src, d)
    mdir = str(tmp_path / "m")
    prev = set_plan(FaultPlan.parse("corrupt_ckpt:latest"))
    try:
        ckpt.Checkpointer(d, verify="digest").close()
    finally:
        set_plan(prev)
    step4 = os.path.join(d, "4")
    assert manifest.verify_step(step4, level="digest")[0] is False
    resumed = _trainer(checkpoint_dir=d, checkpoint_every_steps=2,
                       checkpoint_verify="digest", resume=True,
                       metrics_dir=mdir)
    assert resumed.state.step == 2
    resumed.run()
    recs = _records(os.path.join(mdir, "metrics.jsonl"))
    fb = [r for r in recs if r["record"] == "checkpoint_fallback"]
    assert fb and fb[0]["latest_step"] == 4 and fb[0]["fallback_step"] == 2
    assert any(r["record"] == "checkpoint_resave" for r in recs)
    assert manifest.verify_step(step4, level="digest") == (True, "ok")
    _same(_state(resumed), want)


def test_hang_injection_wedges_until_watchdog_abort(tmp_path):
    reg, sink = _reg_with_sink(tmp_path)
    prev_reg = set_registry(reg)
    aborted = threading.Event()
    exits = []

    def fake_exit(code):
        exits.append(code)
        aborted.set()

    wd = Watchdog(stall_factor=1.0, min_stall_s=0.05, hard_timeout_s=0.2,
                  _exit=fake_exit)
    prev_wd = set_watchdog(wd)
    plan = FaultPlan.parse("hang_at_step:2")
    hang = threading.Thread(target=plan.fire_step_fault, args=(2,),
                            daemon=True)
    try:
        hang.start()
        assert aborted.wait(timeout=10)
    finally:
        set_watchdog(prev_wd)
        wd.close()
        set_registry(prev_reg)
        sink.close()
    assert exits == [WATCHDOG_EXIT_CODE]
    recs = _records(tmp_path / "metrics.jsonl")
    assert any(r["record"] == "fault_injected" for r in recs)
    abort = next(r for r in recs if r["record"] == "watchdog_abort")
    assert abort["section"] == "injected_hang" and abort["step"] == 2


@pytest.fixture(scope="module")
def cli_drills(tmp_path_factory):
    """Three train_dp processes at once: SIGTERM after step 2 (exit 75),
    a hang after step 1 under a 2 s watchdog (exit 84), and
    ``--crash-at-step 2`` (exit 13)."""
    root = tmp_path_factory.mktemp("drills")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=REPO)
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "PDT_TPU_FAULT"):
        env.pop(k, None)
    drills = {
        "sigterm": ("sigterm_at_step:2", []),
        "hang": ("hang_at_step:1", ["--watchdog-min-stall-s", "0.5",
                                    "--watchdog-hard-timeout-s", "2"]),
        "crash": ("", ["--crash-at-step", "2"]),
    }
    procs = {}
    for name, (fault, extra) in drills.items():
        argv = TINY + ["--checkpoint-dir", str(root / name / "ck"),
                       "--checkpoint-every-steps", "1",
                       "--metrics-dir", str(root / name / "m"), *extra]
        procs[name] = subprocess.Popen(
            [sys.executable, "-m",
             "pytorch_distributed_training_tpu_torch.cli.train_dp", *argv],
            cwd=REPO, env=dict(env, PDT_TPU_FAULT=fault),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    out = {}
    try:
        for name, p in procs.items():
            stdout, stderr = p.communicate(timeout=180)
            out[name] = (p.returncode, stdout, stderr, root / name)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.communicate()
    return out


def test_cli_sigterm_exits_75_with_an_emergency_checkpoint(cli_drills):
    rc, _, err, root = cli_drills["sigterm"]
    assert rc == RESUMABLE_EXIT_CODE, err[-2000:]
    assert ckpt.verified_latest_step(str(root / "ck")) == 2
    recs = _records(root / "m" / "metrics.jsonl")
    assert [r["saved_step"] for r in recs if r["record"] == "preemption"
            ] == [2]


def test_cli_hang_aborts_with_84(cli_drills):
    rc, _, err, root = cli_drills["hang"]
    assert rc == WATCHDOG_EXIT_CODE, err[-2000:]
    recs = _records(root / "m" / "metrics.jsonl")
    kinds = [r["record"] for r in recs]
    assert "watchdog_stall" in kinds and kinds[-1] == "watchdog_abort"
    assert recs[-1]["section"] == "injected_hang" and recs[-1]["step"] == 1


def test_cli_crash_at_step_hard_exit(cli_drills):
    rc, out, err, root = cli_drills["crash"]
    assert rc == 13, err[-2000:]
    assert "injected crash at step 2 (rank 0)" in out
    assert ckpt.latest_step(str(root / "ck")) == 2


def test_run_supervised_validates_restart_contract(baseline, fake_time):
    _, d = baseline
    args = SimpleNamespace(max_restarts=1, restart_window_s=0.0)
    with pytest.raises(SystemExit, match="checkpoint-dir"):
        run_supervised(args, TrainConfig(), lambda cfg: None)
    with pytest.raises(SystemExit, match="already holds"):
        run_supervised(args, TrainConfig(checkpoint_dir=d), lambda cfg: None)
    seen = []

    def build(cfg):
        seen.append(cfg.resume)
        if len(seen) == 1:
            raise RuntimeError("first attempt dies")
        return SimpleNamespace(run=lambda: "history")

    out = run_supervised(args, TrainConfig(checkpoint_dir=d, resume=True),
                         build)
    assert seen == [True, True] and out.run() == "history"
    assert len(fake_time.sleeps) == 1
    fresh = []
    run_supervised(SimpleNamespace(max_restarts=0, restart_window_s=0.0),
                   TrainConfig(), lambda cfg: fresh.append(cfg.resume)
                   or SimpleNamespace(run=lambda: None))
    assert fresh == [False]
