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

The parser also takes the JAX package's serve-scoped kinds
(``replica_crash``, ``replica_hang``, ``replica_slow``, with busy-tick or
``t<seconds>`` triggers) and swap-scoped ones (``corrupt_ckpt_swap``,
``swap_crash``, ``swap_slow``), and refuses what JAX refuses; they fire
from the fleet and hot-swap layers, which wait in ROADMAP.md (queue 1,
items 5 and 7).

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
    the loader (batch assembly) and the Checkpointer (close) call its
    hooks; each is a no-op when no matching spec is armed."""

    def __init__(self, specs: list[FaultSpec]):
        self.specs = specs

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
