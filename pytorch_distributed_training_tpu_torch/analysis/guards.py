"""Runtime guard layer: recompiles, implicit transfers, sharding
(counterpart: the JAX package's ``analysis/guards.py``, with its names,
modes, records and counters).

The static linter (``analysis/lint.py``) catches what is visible in
source; this module catches what only shows up live:

- **Recompile detector** — ``GuardSet.wrap(name, fn)`` wraps a callable.
  The port runs eagerly, so a "recompile" after warm-up is one of two
  events: a call whose signature (the operands' shapes, dtypes and
  devices, and the values of plain ``int``/``bool``/``str`` arguments,
  such as the serve engine's dispatch kind and flag) differs from the
  one warm-up call's, or a kernel library compiled during a warm call
  (``ops/_build.build``, the native loader's ``g++``; the count is the
  building thread's). Either is a ``recompile`` record and counter, and a
  ``RecompileError`` in strict mode, raised before the call runs when the
  signature is new. A wrapped callable gets exactly one warm-up signature,
  as a jit gets one trace; a signature once seen is not a violation
  again, as a jit's cache keeps a retraced shape.
- **Implicit-transfer detector** — ``torch.cuda.set_sync_debug_mode``.
  Warm guarded calls and ``GuardSet.transfer_scope(name)`` arm it on the
  calling thread. torch's mode is process-wide and JAX's
  ``transfer_guard`` is thread-local, so the detector keeps torch's mode
  at ``"warn"`` while any thread is armed and routes each sync warning by
  the thread that raised it (torch raises it in the thread whose op
  synchronized): on an armed thread it is a violation (an
  ``implicit_transfer`` record and counter; in strict mode the op raises
  ``TransferGuardError``, the thread-local counterpart of torch's
  ``"error"`` mode), on any other thread it is dropped, so a legitimate
  sync on an HTTP, telemetry or prefetch thread neither raises nor counts
  as the armed region's. Intended copies run under
  ``explicit_transfer()`` (the counterpart of JAX's explicit
  ``device_put``/``device_get``), which the detector does not count: the
  serve engine's operand uploads and token readbacks, the sampler's
  uploads, tensor-parallel serving's control broadcasts and gloo's host
  staging. What it cannot see: syncs on threads that do not hand torch's
  warnings to Python (gloo's worker threads, which stage a card's tensors
  for DDP's reducer under gloo: c10 prints those to stderr while any
  thread is armed; the port's own gloo collectives stage on the calling
  thread), syncs torch does not report (``torch.cuda.synchronize``, an
  event's wait), and syncs whose warning the process's own warning
  filters or a ``warnings.catch_warnings`` block swallow while armed. On
  the CPU there is nothing to detect: the detector does nothing and never
  calls into ``torch.cuda``.
- **Lock boundary** — a guarded call or a ``transfer_scope`` entered while
  this thread holds an instrumented lock (``concurrency.held_lock_names``)
  is reported to the lock registry (``lock_across_device``); strict mode
  raises ``GuardViolation``.
- **Sharding audit** — ``sharding_audit(model, mesh)`` flags parameters
  of at least ``min_bytes`` left whole on a mesh whose fsdp/model/stage
  axes could shard them: neither a ``DTensor`` with a ``Shard`` placement
  (FSDP2) nor a tensor-parallel slice.
- **Collective audit** — ``analysis/spmd``: the collectives a window
  issued, recorded and checked against a ``CommManifest``.

Nothing to port: the donation audit. torch has no buffer donation; a
step updates its state in place.

Modes (``PDT_TPU_GUARDS``, ``TrainConfig.guards``, ``serve_lm --guards``):
``off`` — pass-through; ``record`` (the default) — detect, count, emit
telemetry, never raise; ``strict`` — record and raise.

The module imports no torch at import time (``analysis`` stays importable
in the fleet's coordinator process); torch is imported where a tensor or
the card is touched.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import re
import threading
import warnings
from typing import Any

from pytorch_distributed_training_tpu_torch.analysis.concurrency.locks import (
    get_lock_registry,
    held_lock_names,
)
from pytorch_distributed_training_tpu_torch.ops import _build

_MODES = ("off", "record", "strict")


class GuardViolation(RuntimeError):
    """A runtime correctness guard tripped (strict mode)."""


class RecompileError(GuardViolation):
    """A guarded entry point recompiled after warm-up."""


class TransferGuardError(GuardViolation):
    """An implicit host<->device transfer happened in a guarded region."""


def guard_mode_from_env(default: str = "record") -> str:
    """The guard mode ``PDT_TPU_GUARDS`` names (``default`` when unset); a
    ValueError for any other word."""
    mode = os.environ.get("PDT_TPU_GUARDS", default)
    if mode not in _MODES:
        raise ValueError(
            f"PDT_TPU_GUARDS must be one of {_MODES}, got {mode!r}"
        )
    return mode


def _registry_or_default(registry):
    if registry is not None:
        return registry
    from pytorch_distributed_training_tpu_torch.telemetry.registry import (
        get_registry,
    )

    return get_registry()


# ------------------------------------------------------------- signatures

_BY_VALUE = (bool, int, str, type(None))


def call_signature(args, kwargs) -> tuple:
    """What a call's warm-up fixes: each tensor's or array's shape, dtype
    and device, the value of each plain int/bool/str/None, the type of
    anything else (a train state, a float), through lists, tuples and
    dicts."""

    def sig(a):
        if isinstance(a, _BY_VALUE):
            return a
        if isinstance(a, (list, tuple)):
            return (type(a).__name__, *(sig(b) for b in a))
        if isinstance(a, dict):
            return ("dict", *((k, sig(v)) for k, v in sorted(a.items())))
        shape = getattr(a, "shape", None)
        if shape is not None and hasattr(a, "dtype"):
            return ("array", tuple(shape), str(a.dtype),
                    str(getattr(a, "device", "cpu")))
        return type(a).__name__

    return sig(tuple(args)), sig(dict(kwargs))


# ------------------------------------------------------ transfer detector

_tls = threading.local()    # .scopes: [(GuardSet, name)], .explicit: int
_SYNC_RE = re.compile(r"synchronizing CUDA operation")


@contextlib.contextmanager
def explicit_transfer():
    """An intended host<->device copy: a sync inside is not a violation
    (JAX's explicit ``device_put``/``device_get`` under its guard)."""
    _tls.explicit = getattr(_tls, "explicit", 0) + 1
    try:
        yield
    finally:
        _tls.explicit -= 1


class _SyncDetector:
    """The process's one hook into torch's sync debug mode: ``"warn"``
    while any thread is armed (the mode it found is put back when the last
    disarms), and a ``warnings.showwarning`` that turns a sync warning on
    an armed thread into that thread's violation and drops it elsewhere.
    Installed at the first arming, on the card only, and again at an
    arming that finds it replaced (a ``warnings.catch_warnings`` block
    puts the previous handler back when it ends)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._armed = 0
        self._prev_mode = 0
        self._showwarning = None

    def _install(self) -> None:
        # every sync warns again (the default action shows a location once)
        warnings.filterwarnings("always", message=".*" + _SYNC_RE.pattern,
                                category=UserWarning)
        self._showwarning = warnings.showwarning
        warnings.showwarning = self._route

    def _route(self, message, category, filename, lineno, file=None,
               line=None):
        if not _SYNC_RE.search(str(message)):
            return self._showwarning(message, category, filename, lineno,
                                     file, line)
        scopes = getattr(_tls, "scopes", None)
        if scopes and not getattr(_tls, "explicit", 0):
            guards, name = scopes[-1]
            guards._transfer_violation(name, str(message))
        return None

    @contextlib.contextmanager
    def armed(self, guards: "GuardSet", name: str):
        import torch

        with self._lock:
            if warnings.showwarning != self._route:
                self._install()     # first arming, or a block restored it
            if self._armed == 0:
                self._prev_mode = torch.cuda.get_sync_debug_mode()
                torch.cuda.set_sync_debug_mode("warn")
            self._armed += 1
        scopes = getattr(_tls, "scopes", None)
        if scopes is None:
            scopes = _tls.scopes = []
        scopes.append((guards, name))
        try:
            yield
        finally:
            scopes.pop()
            with self._lock:
                self._armed -= 1
                if self._armed == 0:
                    torch.cuda.set_sync_debug_mode(self._prev_mode)


_DETECTOR = _SyncDetector()


def _cuda_live() -> bool:
    """True once this process has initialized CUDA (a card is in use);
    never initializes it, and False without torch's CUDA build."""
    import sys

    torch = sys.modules.get("torch")
    return torch is not None and torch.cuda.is_initialized()


# ------------------------------------------------------------ the guards


class GuardedCall:
    """Wrapper installed by ``GuardSet.wrap`` around one entry point: the
    call contract unchanged, plus the warm-up signature check,
    build accounting, transfer arming once warm and the lock-boundary
    check. The first call is the warm-up: its signature is the one later
    calls must match; a new one is a violation once."""

    def __init__(self, name: str, fn, guards: "GuardSet"):
        self.name = name
        self.fn = fn
        self.guards = guards
        self.signature = None       # the warm-up call's
        self._seen: set = set()
        self.calls = 0
        self.recompiles = 0

    @property
    def warm(self) -> bool:
        return self.signature is not None

    def __call__(self, *args, **kwargs):
        g = self.guards
        if g.mode == "off":
            return self.fn(*args, **kwargs)
        held = held_lock_names()
        if held:
            g._lock_boundary_violation(self.name, held)
        self.calls += 1
        sig = call_signature(args, kwargs)
        warm = self.signature is not None
        if warm and sig not in self._seen:
            self._seen.add(sig)
            self.recompiles += 1
            g._recompile_violation(self, 1)
        builds = _build.thread_builds()
        if warm:
            with g._transfer_context(self.name):
                out = self.fn(*args, **kwargs)
        else:
            out = self.fn(*args, **kwargs)
            self.signature = sig    # the one expected warm-up
            self._seen.add(sig)
        built = _build.thread_builds() - builds
        if warm and built:
            self.recompiles += 1
            g._recompile_violation(self, built)
        return out


@dataclasses.dataclass
class GuardSet:
    """One guard policy + its wrapped entry points + violation counters."""

    mode: str = "record"
    registry: Any = None

    def __post_init__(self):
        if self.mode not in _MODES:
            raise ValueError(
                f"guards mode must be one of {_MODES}, got {self.mode!r}"
            )
        self.registry = _registry_or_default(self.registry)
        self.wrapped: dict[str, GuardedCall] = {}
        self.recompile_violations = 0
        self.transfer_violations = 0

    # ------------------------------------------------------------- wrapping

    def wrap(self, name: str, fn) -> GuardedCall:
        """Wrap ``fn`` as the entry point ``name``; idempotent."""
        if isinstance(fn, GuardedCall):
            return fn
        wrapped = GuardedCall(name, fn, self)
        self.wrapped[name] = wrapped
        return wrapped

    # ------------------------------------------------------------ transfers

    def _transfer_context(self, name: str):
        if self.mode == "off" or not _cuda_live():
            return contextlib.nullcontext()
        return _DETECTOR.armed(self, name)

    def _lock_boundary_violation(self, name: str, held) -> None:
        """A device call or region entered with instrumented locks held:
        the lock registry records it (``lock_across_device``); strict mode
        raises — the card's latency just became every waiter's."""
        get_lock_registry().check_device_boundary(name)
        if self.mode == "strict":
            raise GuardViolation(
                f"device boundary {name!r} entered while holding "
                f"instrumented lock(s) {list(held)} — dispatching device "
                f"work under a lock serializes every thread needing it"
            )

    @contextlib.contextmanager
    def transfer_scope(self, name: str):
        """Arm the implicit-transfer detector on this thread around a host
        code region (e.g. one serve tick). A sync inside that is not an
        ``explicit_transfer`` emits ``implicit_transfer`` and, in strict
        mode, raises ``TransferGuardError`` from the op. Also checks no
        instrumented lock is held across the scope's entry."""
        held = held_lock_names()
        if held and self.mode != "off":
            self._lock_boundary_violation(name, held)
        with self._transfer_context(name):
            yield

    def _transfer_violation(self, name: str, message: str) -> None:
        self.transfer_violations += 1
        self.registry.inc("guards/implicit_transfers")
        self.registry.emit({
            "record": "implicit_transfer",
            "name": name,
            "error": message.split("\n")[0][:300],
        })
        if self.mode == "strict":
            raise TransferGuardError(
                f"implicit transfer in guarded region {name!r}: "
                f"{message.splitlines()[0]}"
            )

    # ------------------------------------------------------------ recompiles

    def _recompile_violation(self, call: GuardedCall, traced: int) -> None:
        self.recompile_violations += 1
        self.registry.inc("guards/recompiles")
        self.registry.emit({
            "record": "recompile",
            "name": call.name,
            "calls": call.calls,
            "traces": traced,
            "recompiles": call.recompiles,
        })
        if self.mode == "strict":
            raise RecompileError(
                f"entry point {call.name!r} retraced after warm-up (call "
                f"{call.calls}: a new shape/dtype/argument, or {traced} "
                f"kernel build(s)) — a shape/dtype/static-arg is varying "
                f"per call"
            )

    @property
    def violations(self) -> int:
        return self.recompile_violations + self.transfer_violations


# ---------------------------------------------------------------- sharding

_SHARDED_AXES = ("fsdp", "model", "stage")


def is_shard_placed(t) -> bool:
    """A ``DTensor`` with a ``Shard`` placement (FSDP2's)."""
    placements = getattr(t, "placements", None)
    return placements is not None and any(
        type(p).__name__ == "Shard" for p in placements)


def sharding_audit(
    model,
    mesh,
    *,
    min_bytes: int = 1 << 20,
    registry=None,
    mode: str = "record",
    name: str = "params",
    split=(),
) -> dict:
    """Flag parameters of ``model`` (a module, or ``(name, tensor)``
    pairs) of at least ``min_bytes`` left whole on a mesh whose
    fsdp/model/stage axes could shard them: not a ``DTensor`` with a
    ``Shard`` placement and not named in ``split`` (the tensor-parallel
    slices). Data-parallel-only meshes (every non-data axis 1) replicate
    by design and audit clean."""
    registry = _registry_or_default(registry)
    shape = dict(mesh.shape)
    shard_capacity = 1
    for ax in _SHARDED_AXES:
        shard_capacity *= shape.get(ax, 1)
    flagged: list[dict] = []
    if shard_capacity > 1:
        named = (model.named_parameters() if hasattr(model, "named_parameters")
                 else model)
        split = set(split)
        for path, leaf in named:
            nbytes = leaf.numel() * leaf.element_size()
            if nbytes < min_bytes or path in split or is_shard_placed(leaf):
                continue
            flagged.append({"path": path, "bytes": int(nbytes)})
    record = {
        "record": "sharding_audit",
        "name": name,
        "mesh_shape": shape,
        "min_bytes": min_bytes,
        "flagged": flagged,
        "replicated_bytes": sum(f["bytes"] for f in flagged),
        "ok": not flagged,
    }
    registry.emit(record)
    if flagged:
        registry.inc("guards/replicated_large_params", len(flagged))
        if mode == "strict":
            worst = max(flagged, key=lambda f: f["bytes"])
            raise GuardViolation(
                f"sharding audit {name!r}: {len(flagged)} leaf/leaves >= "
                f"{min_bytes}B fully replicated on a "
                f"{shape} mesh (largest: {worst['path']} at "
                f"{worst['bytes']}B) — the sharding policy did not apply"
            )
    return record
