"""Deterministic fault injection (``PDT_TPU_FAULT``; counterpart: the JAX
package's ``faults/inject.py``, whose parser needs no JAX; the port keeps
its own copy).

One environment variable turns into reproducible failures at exact points
of a run, so CPU tests drive the real recovery paths. Comma-separated
specs, each ``kind:arg`` with an optional ``@rank`` (the rank that fires;
default 0):

- ``crash_at_step:7``    raise ``InjectedCrash`` right after update 7: the
                         failure ``run_with_restarts`` catches, restarts
                         and resumes from a checkpoint (the hard
                         ``os._exit`` kill is ``--crash-at-step``);
- ``sigterm_at_step:5``  send this process SIGTERM after update 5: the
                         preemption path (emergency checkpoint,
                         ``preemption`` record, exit 75);
- ``hang_at_step:3``     block forever after update 3 inside a watchdog
                         guard: stall detection and the abort (exit 84);
- ``corrupt_ckpt:latest`` flip bytes of the newest committed checkpoint
                         when the Checkpointer closes (``corrupt_ckpt:12``
                         targets step 12): manifest verification and the
                         fall-back to a verified step;
- ``slow_host:2x``       stretch this rank's batch assembly by the factor:
                         straggler detection without a slow machine.

Serve-scoped kinds fire from the decode engine's tick (``fire_serve_tick``),
counted in busy ticks (ticks that admitted or decoded work), so idle
spinning never moves the schedule:

- ``replica_crash:3``    hard-kill this replica (``os._exit`` with
                         ``REPLICA_CRASH_EXIT_CODE``, no Python cleanup:
                         streams die mid-token) after busy tick 3;
- ``replica_hang:3:2``   block the serve loop 2 s (default 2) after busy
                         tick 3: the heartbeat goes stale and ``/healthz``
                         says ``unhealthy`` until it ends;
- ``replica_slow:3:4x``  from busy tick 3 on, stretch every tick to 4x its
                         duration (armed for good, as a slow replica is).

They also take a time trigger, ``replica_crash:t3.5``: the first busy tick
3.5 s or more after the plan was armed. A hang and a crash due at the same
tick (``replica_hang:1:5,replica_crash:1``) hold the tick, then kill the
replica: requests that reach it during the hold die queued, before their
first byte (the port's order; JAX's hook fires the crash first).
Swap-scoped kinds fire from the hot-swap loader (``fire_swap_load``,
``serve/hotswap.py``) before any byte of the named checkpoint step is
read: ``corrupt_ckpt_swap:12`` raises
(the swap rolls back, the step is blocklisted), ``swap_crash:12``
hard-kills the replica, ``swap_slow:12:3`` sleeps 3 s (default 2).

Every spec fires at most once per process (a restarted attempt in the
same process does not fire it again; ``slow_host`` stays armed but
records once), so an injected crash converges to recovery.
"""

from __future__ import annotations

import dataclasses
import os
import re
import signal
import time

from pytorch_distributed_training_tpu_torch.telemetry.registry import (
    get_registry,
)
from pytorch_distributed_training_tpu_torch.train.manifest import (
    MANIFEST_NAME,
)
from pytorch_distributed_training_tpu_torch.utils.logging import (
    current_rank,
    get_logger,
)

ENV_VAR = "PDT_TPU_FAULT"

_STEP_KINDS = ("crash_at_step", "sigterm_at_step", "hang_at_step")
_SWAP_KINDS = ("corrupt_ckpt_swap", "swap_crash", "swap_slow")
_SERVE_KINDS = ("replica_crash", "replica_hang", "replica_slow") + _SWAP_KINDS
_KINDS = _STEP_KINDS + ("corrupt_ckpt", "slow_host") + _SERVE_KINDS

#: the exit status of a hard replica kill: neither 0 nor 75, so a
#: supervisor counts it as a crash
REPLICA_CRASH_EXIT_CODE = 23

logger = get_logger(__name__)


class InjectedCrash(RuntimeError):
    """The stand-in for a dying host: raised at an exact step boundary so
    the supervisor's catch, restart and resume run for real."""


@dataclasses.dataclass
class FaultSpec:
    kind: str
    step: int = 0          # *_at_step kinds; serve ticks; swap steps
    at_s: float = 0.0      # replica_* kinds with a t<seconds> trigger
    target: str = ""       # corrupt_ckpt: "latest" or a step number
    factor: float = 1.0    # slow_host, replica_slow; hang/slow seconds
    rank: int = 0          # the rank that fires
    fired: bool = False


def _factor(kind: str, text: str, arg: str) -> float:
    m = re.fullmatch(r"([0-9.]+)x?", text)
    if not m or float(m.group(1)) < 1.0:
        raise ValueError(f"{kind} needs a factor >= 1 (e.g. 2x), got {arg!r}")
    return float(m.group(1))


def _parse_serve(spec: FaultSpec, kind: str, arg: str) -> None:
    parts = arg.split(":")
    if kind not in _SWAP_KINDS and parts[0][:1] == "t":
        spec.at_s = float(parts[0][1:])
        if spec.at_s <= 0:
            raise ValueError(
                f"{kind} needs a positive time offset, got {arg!r}")
    else:
        spec.step = int(parts[0])
        if kind in _SWAP_KINDS:
            if spec.step < 0:  # checkpoint steps start at 0
                raise ValueError(
                    f"{kind} needs a checkpoint step >= 0, got {arg!r}")
        elif spec.step <= 0:  # busy ticks start at 1
            raise ValueError(f"{kind} needs a positive tick, got {arg!r}")
    if kind in ("replica_hang", "swap_slow"):
        if len(parts) > 2:
            raise ValueError(
                f"{kind} takes {'step' if kind == 'swap_slow' else 'tick'}"
                f"[:seconds], got {arg!r}")
        spec.factor = float(parts[1]) if len(parts) == 2 else 2.0
        if spec.factor <= 0:
            raise ValueError(f"{kind} needs a positive duration, got {arg!r}")
    elif kind == "replica_slow":
        if len(parts) != 2:
            raise ValueError(f"{kind} needs tick:factor (e.g. 3:4x), got "
                             f"{arg!r}")
        spec.factor = _factor(kind, parts[1], arg)
    elif len(parts) != 1:
        raise ValueError(f"{kind} takes a bare tick/step, got {arg!r}")


def _parse_spec(text: str) -> FaultSpec:
    text = text.strip()
    rank = 0
    if "@" in text:
        text, rank_s = text.rsplit("@", 1)
        rank = int(rank_s)
    if ":" not in text:
        raise ValueError(f"fault spec {text!r} needs kind:arg")
    kind, arg = text.split(":", 1)
    if kind not in _KINDS:
        raise ValueError(f"unknown fault kind {kind!r}; have {_KINDS}")
    spec = FaultSpec(kind=kind, rank=rank)
    if kind in _STEP_KINDS:
        spec.step = int(arg)
        if spec.step <= 0:
            raise ValueError(f"{kind} needs a positive step, got {arg!r}")
    elif kind in _SERVE_KINDS:
        _parse_serve(spec, kind, arg)
    elif kind == "corrupt_ckpt":
        if arg != "latest" and not arg.isdigit():
            raise ValueError(f"corrupt_ckpt target must be 'latest' or a "
                             f"step, got {arg!r}")
        spec.target = arg
    else:  # slow_host
        spec.factor = _factor("slow_host", arg, arg)
    return spec


def _emit(record: dict) -> None:
    reg = get_registry()
    reg.inc("faults/injected")
    reg.emit({"record": "fault_injected", **record})


class FaultPlan:
    """The parsed schedule of this process. The Trainer (step boundaries),
    the loader (batch assembly), the Checkpointer (close), the decode
    engine (busy ticks) and the hot-swap loader call its hooks; each is a
    no-op when no matching spec is armed."""

    def __init__(self, specs: list[FaultSpec]):
        self.specs = specs
        # the clock of the t<seconds> serve triggers: offsets count from
        # when the plan was armed
        self.armed_t = time.monotonic()

    @classmethod
    def parse(cls, text: str | None) -> "FaultPlan":
        if not text or not text.strip():
            return cls([])
        return cls([_parse_spec(s) for s in text.split(",") if s.strip()])

    def _take(self, kind: str, pred) -> FaultSpec | None:
        """The first unfired spec of ``kind`` matching ``pred`` on this
        rank, marked fired."""
        rank = current_rank()
        for spec in self.specs:
            if (spec.kind == kind and not spec.fired and spec.rank == rank
                    and pred(spec)):
                spec.fired = True
                return spec
        return None

    def fire_step_fault(self, step: int) -> None:
        """Trainer hook, right after completing update ``step``."""
        if self._take("crash_at_step", lambda s: s.step == step):
            _emit({"fault": "crash_at_step", "step": step})
            raise InjectedCrash(f"injected crash after step {step}")
        if self._take("sigterm_at_step", lambda s: s.step == step):
            _emit({"fault": "sigterm_at_step", "step": step})
            logger.warning("injecting SIGTERM after step %d", step)
            os.kill(os.getpid(), signal.SIGTERM)
            return
        if self._take("hang_at_step", lambda s: s.step == step):
            from pytorch_distributed_training_tpu_torch.faults.watchdog import (
                watchdog_guard,
            )

            _emit({"fault": "hang_at_step", "step": step})
            logger.warning("injecting hang after step %d", step)
            with watchdog_guard("injected_hang", step=step):
                while True:  # a stuck collective never returns; the
                    time.sleep(60)  # watchdog's hard timeout ends this

    def fire_serve_tick(self, busy_tick: int, elapsed_s: float) -> None:
        """Decode-engine hook, after busy tick ``busy_tick`` took
        ``elapsed_s`` seconds. A spec matches its busy tick exactly or,
        with a ``t<seconds>`` trigger, on the first busy tick at or after
        its offset from the plan's arming."""
        run_s = time.monotonic() - self.armed_t

        def due(spec: FaultSpec) -> bool:
            if spec.at_s > 0:
                return run_s >= spec.at_s
            return spec.step == busy_tick

        # the hang first: a crash due at the same tick fires after it, so
        # what reached the replica during the hold dies queued, before its
        # first byte (JAX's hook fires the crash first)
        hang = self._take("replica_hang", due)
        if hang is not None:
            _emit({"fault": "replica_hang", "tick": busy_tick,
                   "seconds": hang.factor})
            logger.warning("injecting %.1fs serve-loop hang after busy "
                           "tick %d", hang.factor, busy_tick)
            time.sleep(hang.factor)
        if self._take("replica_crash", due):
            _emit({"fault": "replica_crash", "tick": busy_tick})
            logger.warning("injecting replica crash after busy tick %d",
                           busy_tick)
            self._flush_sink()
            os._exit(REPLICA_CRASH_EXIT_CODE)  # no cleanup: streams die
        if hang is not None:
            return
        rank = current_rank()
        for spec in self.specs:
            if spec.kind == "replica_slow" and spec.rank == rank and (
                    run_s >= spec.at_s if spec.at_s > 0
                    else busy_tick >= spec.step):
                if not spec.fired:
                    # recorded once; the stretch stays armed
                    spec.fired = True
                    _emit({"fault": "replica_slow", "tick": busy_tick,
                           "factor": spec.factor})
                time.sleep(max(0.0, elapsed_s) * (spec.factor - 1.0))
                return

    def fire_swap_load(self, ckpt_step: int) -> None:
        """Hot-swap loader hook, before any byte of checkpoint
        ``ckpt_step`` is read, so the serving state is untouched when it
        fires."""
        if self._take("corrupt_ckpt_swap", lambda s: s.step == ckpt_step):
            _emit({"fault": "corrupt_ckpt_swap", "ckpt_step": ckpt_step})
            logger.warning("injecting corrupt-array failure into swap load "
                           "of checkpoint step %d", ckpt_step)
            raise InjectedCrash(
                f"injected corrupt checkpoint array during swap load of "
                f"step {ckpt_step}")
        if self._take("swap_crash", lambda s: s.step == ckpt_step):
            _emit({"fault": "swap_crash", "ckpt_step": ckpt_step})
            logger.warning("injecting replica crash during swap load of "
                           "checkpoint step %d", ckpt_step)
            self._flush_sink()
            os._exit(REPLICA_CRASH_EXIT_CODE)
        spec = self._take("swap_slow", lambda s: s.step == ckpt_step)
        if spec is not None:
            _emit({"fault": "swap_slow", "ckpt_step": ckpt_step,
                   "seconds": spec.factor})
            logger.warning("injecting %.1fs stall into swap load of "
                           "checkpoint step %d", spec.factor, ckpt_step)
            time.sleep(spec.factor)

    @staticmethod
    def _flush_sink() -> None:
        """Push the telemetry stream to disk before a hard ``os._exit``
        (which skips every writer's cleanup); best effort."""
        try:
            sink = get_registry().sink
            if sink is not None:
                sink.flush(fsync=True)
        except Exception:  # dying anyway
            pass

    def slow_host_delay(self, elapsed_s: float) -> None:
        """Loader hook: stretch this rank's batch work to ``factor`` x its
        real duration (armed for good: a straggler is slow on every
        batch)."""
        rank = current_rank()
        for spec in self.specs:
            if spec.kind == "slow_host" and spec.rank == rank:
                if not spec.fired:
                    spec.fired = True  # record the injection once
                    _emit({"fault": "slow_host", "factor": spec.factor})
                time.sleep(max(0.0, elapsed_s) * (spec.factor - 1.0))
                return

    def corrupt_checkpoint_target(self) -> str | None:
        """Checkpointer hook (at close): the step to corrupt, or None."""
        spec = self._take("corrupt_ckpt", lambda s: True)
        return spec.target if spec is not None else None


def corrupt_step_dir(step_path: str, *, flip_bytes: int = 64) -> str:
    """Corrupt a committed checkpoint step in place: flip the first
    ``flip_bytes`` of its largest data file, its length kept (what a size
    check alone cannot see). Returns the file's path."""
    victim, size = None, -1
    for root, _dirs, files in os.walk(step_path):
        for name in files:
            if name == MANIFEST_NAME:
                continue
            p = os.path.join(root, name)
            s = os.path.getsize(p)
            if s > size:
                victim, size = p, s
    if victim is None:
        raise FileNotFoundError(f"no data files under {step_path}")
    n = min(flip_bytes, size)
    with open(victim, "r+b") as f:
        head = f.read(n)
        f.seek(0)
        f.write(bytes(b ^ 0xFF for b in head))
    logger.warning("corrupted %d bytes of %s", n, victim)
    return victim


_active: FaultPlan | None = None


def get_plan() -> FaultPlan:
    """The process-wide plan, parsed from ``PDT_TPU_FAULT`` once (so each
    spec's fired state survives restarts within the process)."""
    global _active
    if _active is None:
        _active = FaultPlan.parse(os.environ.get(ENV_VAR))
        if _active.specs:
            logger.warning("fault injection armed: %s",
                           os.environ.get(ENV_VAR))
    return _active


def set_plan(plan: FaultPlan | None) -> FaultPlan | None:
    """Install ``plan``; returns the previous one. None parses the
    environment again at the next ``get_plan``."""
    global _active
    prev = _active
    _active = plan
    return prev
