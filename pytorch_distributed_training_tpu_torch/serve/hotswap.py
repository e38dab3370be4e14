"""Zero-downtime checkpoint hot-swap: verified live weight reload
(counterpart: the JAX package's ``serve/hotswap.py``).

The trainers publish checkpoints (``train/checkpoint.py``, each step
sealed by ``train/manifest.py`` after its commit); this module lets a
running replica take them up without a restart, so that a bad checkpoint
is a non-event:

- ``CheckpointWatcher`` polls a checkpoint directory and admits only
  steps that pass the manifest verification (``train/manifest.
  verify_step``). Admission is monotonic: a step is never admitted twice
  and the watcher never goes backwards; a step whose swap failed lands on
  a blocklist; a step published again with other digests is rejected.
  A step whose manifest is not written yet (an asynchronous save before
  its join, a publish in flight) is skipped, not blocklisted.
- ``load_swap_params`` reads only the model's tensors of a step
  (``train/checkpoint.restore_params``: the moments are never read), on
  the host, a scanned trunk unstacked (``models/relayout.py``).
- ``HotSwapManager`` is the replica's executor: load (off the serve
  loop), hand the weights to ``DecodeEngine.request_swap`` and wait for
  the engine to apply them between ticks and commit them after the first
  clean tick. A swap that fails anywhere leaves the old weights serving
  (``swap_failed`` and ``swap_rollback`` records), never a dead replica.
- ``publish_params_checkpoint`` is the publisher's half: a weights-only
  step and its sealed manifest, what a fine-tuning job's export (or a
  test) calls to make a step eligible.

Fault drills: ``PDT_TPU_FAULT=corrupt_ckpt_swap:<step>``,
``swap_crash:<step>`` and ``swap_slow:<step>[:s]`` fire inside
``load_swap_params`` (``faults/inject.py``).
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
import time
from typing import Callable, Optional

from pytorch_distributed_training_tpu_torch.faults.inject import get_plan
from pytorch_distributed_training_tpu_torch.telemetry.registry import (
    get_registry,
)
from pytorch_distributed_training_tpu_torch.train import (
    manifest as ckpt_manifest,
)
from pytorch_distributed_training_tpu_torch.train.manifest import (
    read_manifest,
    verify_step,
)
from pytorch_distributed_training_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

SWAP_VERIFY_LEVELS = ("size", "digest")


def scan_step_dirs(directory: str) -> list[int]:
    """Step numbers under ``directory`` (one integer-named directory a
    step), ascending. Other entries (a save in flight's ``.tmp-<step>``,
    metrics, stray files) are ignored."""
    try:
        names = os.listdir(directory)
    except (FileNotFoundError, NotADirectoryError):
        return []
    steps = []
    for name in names:
        if name.isdigit() and os.path.isdir(os.path.join(directory, name)):
            steps.append(int(name))
    return sorted(steps)


def manifest_digest(manifest: dict) -> str:
    """Stable fingerprint of a sealed step's content: the manifest's file
    inventory (sizes + sha256s) hashed in sorted order. Two publishes of
    the same step with different bytes get different fingerprints even
    when sizes match."""
    return hashlib.sha256(
        json.dumps(manifest.get("files", {}), sort_keys=True).encode()
    ).hexdigest()


class CheckpointWatcher:
    """Polls a checkpoint directory and drives ``apply_fn`` for each newly
    published, integrity-verified step.

    ``apply_fn(step) -> bool`` performs the actual swap (load and engine
    swap) and returns True when the step is now serving. False blocklists
    the step — the watcher will NEVER retry it; recovery is the next good
    step.

    Admission rules, in order:
    - a step NEWLY APPEARING at or below ``current_step`` is stale
      (published out of order) — rejected once with a ``swap_rejected``
      record, never applied; older steps already sitting in the directory
      when the watcher first looks (keep=N retention history) are normal
      and ignored silently;
    - a previously-seen step whose manifest digests changed is rejected +
      blocklisted (``reason="republished"``): sealed steps are immutable;
    - a step without a readable manifest, or failing ``verify_step`` at
      ``verify_level``, is simply skipped this poll (an in-flight publish
      finishes eventually; corruption keeps failing verification forever)
      — NOT blocklisted, because "not yet eligible" is not "poisoned";
    - among eligible new steps the NEWEST wins (same semantics as
      ``verified_latest_step``); older eligible ones are only tried when
      the newer admission fails.

    ``start_step`` anchors the baseline (what is already serving). With
    None the first poll records the newest verified step as baseline
    without applying it — the caller booted from it.

    Thread lifecycle: ``start()`` launches the poll thread; ``close()``
    stops it and joins (a poll in flight finishes its apply first — swaps
    are not torn by shutdown). ``poll_once()`` is the synchronous core.
    """

    def __init__(
        self,
        directory: str,
        apply_fn: Callable[[int], bool],
        *,
        poll_interval_s: float = 0.5,
        verify_level: str = "digest",
        registry=None,
        start_step: Optional[int] = None,
        name: str = "ckpt-watcher",
    ):
        if verify_level not in SWAP_VERIFY_LEVELS:
            raise ValueError(
                f"hot-swap verify level must be one of {SWAP_VERIFY_LEVELS},"
                f" got {verify_level!r}"
            )
        self.directory = os.path.abspath(directory)
        self.apply_fn = apply_fn
        self.poll_interval_s = poll_interval_s
        self.verify_level = verify_level
        self.name = name
        self._registry = registry if registry is not None else get_registry()
        # poll state is mutated on the watcher thread but read from others
        # (poll_once is the synchronous entry; the manager's stats() reads
        # current_step/blocklist live) — the lock covers mutations and
        # snapshots, never the apply_fn call
        self._lock = threading.Lock()
        self.current_step: Optional[int] = start_step
        self.blocklist: set[int] = set()
        self._digests: dict[int, str] = {}
        # every step ever observed: "published out of order" means a step
        # NEWLY APPEARING below the serving one — the older steps already
        # sitting in the directory at startup (keep=N retention) are
        # normal history, not a publisher error
        self._seen: set[int] = set()
        self._primed = False
        self.polls = 0
        self.admitted = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------ lifecycle

    def start(self) -> "CheckpointWatcher":
        if self._thread is not None:
            raise RuntimeError("watcher already started")
        self._thread = threading.Thread(
            target=self._loop, name=self.name, daemon=True
        )
        self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.wait(self.poll_interval_s):
            try:
                self.poll_once()
            except Exception:
                # a bad poll (transient IO, racing publisher) must not kill
                # the watcher — the next poll sees a settled directory
                self._registry.inc("swap/watcher_errors")
                logger.exception("%s: poll failed", self.name)

    def close(self, timeout: float = 30.0) -> None:
        """Stop polling; a poll in flight (including its apply) completes
        before the thread exits. Idempotent."""
        self._stop.set()
        thread, self._thread = self._thread, None
        if thread is not None:
            thread.join(timeout)
            if thread.is_alive():  # pragma: no cover - wedged apply_fn
                logger.error(
                    "%s: poll still in flight after %.1fs close timeout",
                    self.name, timeout,
                )

    # ----------------------------------------------------------------- poll

    def _step_path(self, step: int) -> str:
        return os.path.join(self.directory, str(step))

    def _reject(self, step: int, reason: str) -> None:
        logger.warning(
            "%s: rejecting checkpoint step %d (%s)", self.name, step, reason
        )
        self._registry.inc("swap/rejected")
        self._registry.emit({
            "record": "swap_rejected",
            "step": step,
            "reason": reason,
        })

    def _check_republished(self, steps: list[int]) -> None:
        """A sealed step's digests must never change. If a step we already
        fingerprinted reappears with a different inventory, reject it loudly
        and blocklist — silently serving either version would make the
        replica's ``weights_step`` a lie."""
        for step in steps:
            with self._lock:
                old = self._digests.get(step)
            if old is None:
                continue
            manifest = read_manifest(self._step_path(step))
            if not manifest:
                continue
            new = manifest_digest(manifest)
            if new != old:
                with self._lock:
                    self._digests[step] = new  # reject once per re-publish
                    self.blocklist.add(step)
                self._reject(step, "republished with different digests")

    def poll_once(self) -> Optional[int]:
        """One poll: returns the step admitted AND applied this round, or
        None (nothing new, nothing eligible, or the apply failed)."""
        with self._lock:
            self.polls += 1
        steps = scan_step_dirs(self.directory)
        self._check_republished(steps)
        with self._lock:
            new_steps = [s for s in steps if s not in self._seen]
            self._seen.update(steps)
            primed, self._primed = self._primed, True
            current = self.current_step
            blocked = set(self.blocklist)
        if current is None:
            # baseline: the caller is already serving the newest verified
            # step (it booted from it) — record it, don't re-apply it
            base = -1
            for step in sorted(steps, reverse=True):
                ok, _ = verify_step(
                    self._step_path(step), level=self.verify_level
                )
                if ok:
                    base = step
                    break
            with self._lock:
                self.current_step = base
            self._registry.emit({
                "record": "swap_baseline", "step": base,
            })
            return None
        if primed:
            for step in sorted(new_steps):
                if step <= current:
                    self._reject(step, "older than serving step")
        candidates = [
            s for s in sorted(steps, reverse=True)
            if s > current and s not in blocked
        ]
        for step in candidates:
            path = self._step_path(step)
            manifest = read_manifest(path)
            if not manifest:
                # no (readable) manifest yet: a publish in flight — wait,
                # don't blocklist ("not yet sealed" is recoverable)
                continue
            ok, reason = verify_step(path, level=self.verify_level)
            if not ok:
                logger.info(
                    "%s: step %d not admitted (%s)", self.name, step, reason
                )
                continue
            with self._lock:
                self._digests[step] = manifest_digest(manifest)
            self._registry.inc("swap/admitted")
            self._registry.emit({
                "record": "swap_admitted",
                "step": step,
                "from_step": current,
            })
            with self._lock:
                admitted_any = bool(self.admitted)
            if self._stop.is_set() and admitted_any:
                # closing: don't start a NEW rollout mid-shutdown
                return None
            if self.apply_fn(step):
                with self._lock:
                    self.admitted += 1
                    self.current_step = step
                return step
            with self._lock:
                self.blocklist.add(step)
            self._registry.inc("swap/blocklisted")
            self._registry.emit({
                "record": "swap_blocklisted", "step": step,
            })
            # fall through: an OLDER new step may still be good
        return None


# ------------------------------------------------------------------ loading


def _base_name(name: str) -> str:
    """A weight's name with an int8 ``kernel_scale`` folded onto its
    kernel (the names both variants share)."""
    return name[:-len("_scale")] if name.endswith(".kernel_scale") else name


def load_swap_params(directory: str, step: int, *, current_params) -> dict:
    """The weights of checkpoint ``step`` for a live swap: the tensors of
    the served model's names (``current_params``: its ``state_dict``, or
    the names), whole, float32 or int8 as published, on the host, with
    a scanned step's trunk unstacked for the engine, which serves a block
    a module. Raises on any load problem (a missing step, a corrupt
    file); the caller maps that to ``swap_failed`` and a rollback."""
    from pytorch_distributed_training_tpu_torch.models.relayout import (
        has_scanned_trunk,
        unstack_scanned_params,
    )
    from pytorch_distributed_training_tpu_torch.train.checkpoint import (
        restore_params,
    )

    # the chaos hooks fire before any byte is read: corrupt_ckpt_swap
    # raises, swap_crash kills, swap_slow stretches the load
    get_plan().fire_swap_load(step)
    params = restore_params(directory, step=step)
    if has_scanned_trunk(params) and not has_scanned_trunk(current_params):
        params = unstack_scanned_params(params)
    wanted = {_base_name(n) for n in current_params}
    # a training step's other tensors (delayed-int8 amaxes) stay behind;
    # a missing weight fails the engine's check
    return {n: t for n, t in params.items() if _base_name(n) in wanted}


class HotSwapManager:
    """Replica-side hot-swap executor: watcher + loader + engine swap.

    One manager per ``InferenceServer``. ``swap_to(step)`` is synchronous
    and serialized (``POST /swap`` and the local watcher can't tear each
    other); the optional watcher (``poll_interval_s > 0``) drives it on
    its own. A failed swap NEVER touches the serving weights: load/validate
    failures happen before the engine sees anything, and an apply-stage
    failure is rolled back by the engine itself — either way the replica
    stays healthy on its old ``weights_step`` (degraded-version, not dead)
    and the failure is recorded (``swap_failed`` + rollback counters).
    """

    def __init__(
        self,
        server,
        checkpoint_dir: str,
        *,
        poll_interval_s: float = 0.0,
        verify_level: str = "digest",
        registry=None,
        start_step: Optional[int] = None,
        apply_timeout_s: float = 60.0,
    ):
        self._server = server
        self.checkpoint_dir = os.path.abspath(checkpoint_dir)
        self.apply_timeout_s = apply_timeout_s
        self._registry = registry if registry is not None else get_registry()
        # serializes swap_to against the local watcher and POST /swap (a
        # swap holds it for its whole load and apply)
        self._lock = threading.Lock()
        self.attempts = 0
        self.failures = 0
        # advertised on /healthz while a load and apply is in flight: the
        # restore competes with the decode loop for this process's CPU
        self.swapping = False
        self.watcher = CheckpointWatcher(
            checkpoint_dir,
            self._apply_step,
            poll_interval_s=poll_interval_s,
            verify_level=verify_level,
            registry=self._registry,
            start_step=(
                start_step if start_step is not None
                else server.engine.weights_step
            ),
            name="replica-hotswap",
        )
        self._polling = poll_interval_s > 0

    def start(self) -> "HotSwapManager":
        if self._polling:
            self.watcher.start()
        return self

    def close(self) -> None:
        self.watcher.close()

    def _apply_step(self, step: int) -> bool:
        return bool(self.swap_to(step).get("ok"))

    def swap_to(self, step: int) -> dict:
        """Load checkpoint ``step`` and swap it live. Returns a dict with
        ``ok`` plus either the new ``weights_step`` or the failure's
        ``stage``/``error`` (the /swap endpoint returns it verbatim)."""
        step = int(step)
        with self._lock:
            try:
                self.swapping = True
                return self._swap_to_locked(step)
            finally:
                self.swapping = False

    def _swap_to_locked(self, step: int) -> dict:
        engine = self._server.engine
        if engine.weights_step == step:
            return {"ok": True, "weights_step": step, "noop": True}
        self.attempts += 1
        self._registry.emit({
            "record": "swap_begin",
            "version": step,
            "from_version": engine.weights_step,
        })
        t0 = time.monotonic()
        try:
            params = load_swap_params(
                self.checkpoint_dir, step, current_params=engine.params)
        except Exception as e:
            return self._fail(step, "load", e)
        load_s = time.monotonic() - t0
        try:
            ticket = engine.request_swap(
                params, step, source=(self.checkpoint_dir, step))
        except (ValueError, RuntimeError) as e:
            return self._fail(step, "validate", e)
        if not ticket.done.wait(self.apply_timeout_s):
            return self._fail(
                step, "apply",
                TimeoutError(
                    f"swap not applied within {self.apply_timeout_s}s"
                ),
            )
        if not ticket.ok:
            # the engine already rolled back and emitted swap_rollback;
            # count the failure here so replica stats carry it too
            self.failures += 1
            self._registry.inc("serve/swap_failures")
            return {
                "ok": False,
                "stage": ticket.stage or "tick",
                "error": ticket.error,
                "weights_step": engine.weights_step,
            }
        total_s = time.monotonic() - t0
        self._registry.emit({
            "record": "swap_ok",
            "version": step,
            "load_s": load_s,
            "total_s": total_s,
        })
        logger.info(
            "hot-swap: now serving checkpoint step %d (load %.2fs, "
            "total %.2fs)", step, load_s, total_s,
        )
        return {
            "ok": True,
            "weights_step": step,
            "load_s": load_s,
            "total_s": total_s,
        }

    def _fail(self, step: int, stage: str, exc: Exception) -> dict:
        """A swap failure that never reached the serving weights: the old
        params were never replaced, which IS the rollback (counted as one,
        so 'a recorded rollback on every replica' holds for load-stage
        failures too)."""
        self.failures += 1
        err = f"{type(exc).__name__}: {exc}"
        self._registry.inc("serve/swap_failures")
        self._registry.inc("serve/swap_rollbacks")
        self._registry.emit({
            "record": "swap_failed",
            "version": step,
            "stage": stage,
            "error": err,
        })
        self._registry.emit({
            "record": "swap_rollback",
            "from_version": step,
            "to_version": self._server.engine.weights_step,
            "stage": stage,
        })
        logger.warning(
            "hot-swap of step %d failed at %s (%s); staying on step %s",
            step, stage, err, self._server.engine.weights_step,
        )
        return {
            "ok": False,
            "stage": stage,
            "error": err,
            "weights_step": self._server.engine.weights_step,
        }

    def stats(self) -> dict:
        return {
            "swap_attempts": self.attempts,
            "swap_failures": self.failures,
            "swap_blocklist": sorted(self.watcher.blocklist),
            "swap_watching": self._polling,
        }


# --------------------------------------------------------------- publishing


def publish_params_checkpoint(directory: str, step: int, params: dict, *,
                              variant: Optional[str] = None) -> str:
    """Publish a weights-only checkpoint step the hot-swap path admits:
    ``params`` (a model's ``state_dict``) written under the checkpoints'
    ``model.`` names into ``.tmp-<step>``, renamed into place, then sealed
    with the integrity manifest (after the commit), which records the
    published variant. ``variant`` ``"int8"`` quantizes the projections
    (``ops/quant.quantize_serve_params``), ``"fp32"`` dequantizes an int8
    dict, None publishes it as it is. Returns the step's path."""
    import torch.distributed.checkpoint as dcp

    from pytorch_distributed_training_tpu_torch.ops.quant import (
        dequantize_serve_params,
        quantize_serve_params,
        serve_params_variant,
    )
    from pytorch_distributed_training_tpu_torch.train.checkpoint import (
        MODEL,
        step_path,
    )

    if variant is not None:
        if variant not in ("fp32", "int8"):
            raise ValueError(
                f"variant must be fp32/int8/None, got {variant!r}")
        params = (quantize_serve_params(params) if variant == "int8"
                  else dequantize_serve_params(params))
    directory = os.path.abspath(directory)
    path = step_path(directory, step)
    tmp = os.path.join(directory, f".tmp-{step}")
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    saved = {f"{MODEL}.{n}": t.detach().to("cpu").contiguous()
             for n, t in params.items()}
    dcp.save(saved, storage_writer=dcp.FileSystemWriter(tmp), no_dist=True)
    shutil.rmtree(path, ignore_errors=True)
    os.rename(tmp, path)
    ckpt_manifest._fsync_path(directory)
    man = ckpt_manifest.build_manifest(
        path, step, tree=ckpt_manifest.tree_summary(saved))
    man["variant"] = serve_params_variant(params)
    ckpt_manifest.write_manifest(path, man)
    return path
