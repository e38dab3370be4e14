"""Sharded checkpoint save, restore and resume on
``torch.distributed.checkpoint`` (counterpart: the JAX package's
``train/checkpoint.py``, orbax there).

A save captures what the next step reads: the optimizer ``step``, the
model's ``state_dict`` (float32 parameters; under FSDP2 the sharded
``DTensor``s, which every rank writes its shards of; the delayed-int8
``amax``/``dy_amax`` buffers when ``quant_delayed`` is on, which JAX keeps
in ``TrainState.quant``), the optimizer's moments ``mu`` and ``nu`` keyed
by parameter name and its update ``count``, and the base
``dropout_seed``. A restore loads into a live state in place and
re-places each tensor on that state's layout, so a run continues the same
trajectory on another topology: FSDP at any size or none (a sharded
tensor is a ``DTensor`` of the parameter's global shape, the moments of
a sharded parameter too), the layer split's stages (each holds the whole
model's names of its layers), and tensor parallelism, whose model-axis
slices are saved whole (gathered over the axis) and cut again on restore
by JAX's ``param_specs`` (``TrainState.tp``). The scanned and per-layer
trunks are different names (``models/relayout.py``). JAX's key-word
buffer and its prng-impl fallback have no counterpart: the port has one
dropout generator, Philox keyed by an integer seed, saved as that
integer.

The moments are keyed by name and made (zero, as AdamW would make them)
before a save or a restore, so no optimizer helper of
``torch.distributed.checkpoint.state_dict`` runs: theirs would step the
optimizer once with zero gradients to make its state, which moves
``AdamW.count`` (the port's AdamW reads ``schedule(count)``, not a group
``"lr"``) and, with weight decay, the weights.

On disk a step is ``<dir>/<step>/`` (orbax's standard name format): the
write goes to the sibling ``<dir>/.tmp-<step>/``, which rank 0 renames
into place after every rank's shards are written, then seals with the
integrity manifest (``train/manifest.py``) and prunes to the newest
``keep`` steps; a crash mid-save leaves only the hidden temporary, which
no step listing counts. Only rank 0 renames, writes manifests and
prunes; the decisions every rank must share (skip a duplicate step,
which steps to try) are rank 0's, broadcast. The format is the port's
own; orbax checkpoints are not read (that needs the JAX stack).

Saves are asynchronous, as JAX's (``enable_async_checkpointing``):
``save`` copies the state to host buffers (pinned on a card, kept and
reused from one save to the next), then submits the write through
``torch.distributed.checkpoint.async_save`` and returns; only the write
to disk overlaps the next steps. The copy completes before ``save``
returns, because the optimizer updates parameters and moments in place.
A submitted step stays pending until a join: the next ``save`` (under
the watchdog's ``checkpoint_join``), ``wait()`` or ``close()``. At the
join, and only then, rank 0 renames, seals and prunes (a step whose
write failed gets no seal). Under a process group the write runs on a
gloo group of its own, so its collectives never interleave with the
training's (NCCL on cards). ``save_checkpoint``, the one-shot, joins
before it returns.

Telemetry, as JAX's: each event is a record of the default registry's
stream (``checkpoint_save``, ``checkpoint_skip_duplicate``,
``checkpoint_resave``, ``checkpoint_fallback``, ``checkpoint_restore``)
beside its ``log0`` line, with its counters and timers: ``submit_s`` and
``checkpoint/save_submit_s`` time what the training loop pays (the host
copy and the submit), ``checkpoint/join_s`` the joins at ``wait()``.
``close()`` joins, then fires the ``corrupt_ckpt`` fault
(``faults/inject.py``): it damages a committed, sealed step so the next
restore must detect it and fall back.
"""

from __future__ import annotations

import contextlib
import os
import shutil
import time
import warnings
from typing import Optional

import torch
import torch.distributed as dist

from pytorch_distributed_training_tpu_torch.faults.inject import (
    corrupt_step_dir,
    get_plan,
)
from pytorch_distributed_training_tpu_torch.faults.watchdog import (
    watchdog_guard,
)
from pytorch_distributed_training_tpu_torch.models.convert import (
    is_quant_name,
)
from pytorch_distributed_training_tpu_torch.telemetry.registry import (
    get_registry,
)
from pytorch_distributed_training_tpu_torch.train import (
    manifest as ckpt_manifest,
)
from pytorch_distributed_training_tpu_torch.train.state import TrainState
from pytorch_distributed_training_tpu_torch.utils.logging import (
    get_logger,
    log0,
)

MODEL, OPTIM = "model", "optim"
# files a rank writes a step in (one a thread): the write takes as long
# with more, but the manifest's sha256 then hashes them in parallel
WRITE_THREADS = 8

logger = get_logger(__name__)


class CheckpointCorruptError(RuntimeError):
    """No step under the directory passed integrity verification (and the
    directory is not a pre-manifest legacy one)."""


# ------------------------------------------------------------- processes


def _distributed() -> bool:
    return (dist.is_available() and dist.is_initialized()
            and dist.get_world_size() > 1)


def _is_main() -> bool:
    return not _distributed() or dist.get_rank() == 0


def _barrier() -> None:
    if _distributed():
        dist.barrier()


@contextlib.contextmanager
def _quiet():
    """Without the warning ``torch.distributed.checkpoint`` gives a
    process with no process group (one process is what it then assumes,
    rightly)."""
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=".*single process")
        yield


def _agree(value):
    """Rank 0's ``value`` on every rank (a picklable object)."""
    if not _distributed():
        return value
    box = [value]
    dist.broadcast_object_list(box, src=0)
    return box[0]


# ----------------------------------------------------------- directories


def all_steps(directory: str) -> list[int]:
    """The committed steps under ``directory``, ascending: its subdirectories
    named by an integer (a save in flight is a hidden ``.tmp-<step>``)."""
    if not os.path.isdir(directory):
        return []
    return sorted(int(name) for name in os.listdir(directory)
                  if name.isdigit()
                  and os.path.isdir(os.path.join(directory, name)))


def step_path(directory: str, step: int) -> str:
    return os.path.join(directory, str(step))


def _read_metadata(path: str):
    from torch.distributed.checkpoint import FileSystemReader

    return FileSystemReader(path).read_metadata()


def saved_names(path: str) -> dict:
    """``{flattened name: (shape, dtype)}`` of every tensor of a committed
    step, read from its metadata only (no tensor bytes)."""
    out = {}
    for name, meta in _read_metadata(path).state_dict_metadata.items():
        size = getattr(meta, "size", None)
        if size is not None:
            out[name] = (tuple(size), meta.properties.dtype)
    return out


def _has_quant(names) -> bool:
    return any(is_quant_name(n) for n in names)


# ------------------------------------------------------------ the state


def _moments(optimizer) -> dict:
    """``{id(param): (mu, nu)}``, made (zero, of the parameter's local
    shape in the moment dtypes, as ``AdamW.step`` makes them) where the
    optimizer has none; saved and restored in their dtype."""
    return {id(p): optimizer.moments(p)
            for group in optimizer.param_groups for p in group["params"]}


def _like(t: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """A moment ``t`` (local) placed as its parameter ``p``: a ``DTensor``
    of ``p``'s global shape over ``p``'s mesh (sharing ``t``'s storage)
    when ``p`` is one, else ``t``."""
    from torch.distributed.tensor import DTensor

    if not isinstance(p, DTensor):
        return t
    return DTensor.from_local(t, p.device_mesh, p.placements,
                              shape=p.shape, stride=p.stride())


def _entries(state: TrainState) -> dict:
    """``{flattened name: live tensor}``: the model's ``state_dict``, the
    moments (placed as their parameters) and nothing else."""
    module = state.module
    moments = _moments(state.optimizer)
    out = {f"{MODEL}.{n}": t for n, t in module.state_dict().items()}
    for name, p in module.named_parameters():
        if id(p) in moments:
            mu, nu = moments[id(p)]
            out[f"{OPTIM}.mu.{name}"] = _like(mu, p)
            out[f"{OPTIM}.nu.{name}"] = _like(nu, p)
    return out


def _tp_dim(state: TrainState, flat_name: str) -> Optional[int]:
    """The dim a tensor is cut on over the model axis (tensor
    parallelism), else None."""
    if state.tp is None:
        return None
    # model.<name> or optim.mu.<name> / optim.nu.<name>
    parts = 2 if flat_name.startswith(OPTIM + ".") else 1
    return state.tp[0].get(flat_name.split(".", parts)[-1])


def _whole(t: torch.Tensor) -> torch.Tensor:
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def _saveable(state: TrainState) -> dict:
    """The saved dict, flat: the entries (model-axis slices gathered
    whole), ``step``, ``dropout_seed`` and ``optim.count``."""
    from pytorch_distributed_training_tpu_torch.models.convert import (
        _gather_model,
    )

    out = {}
    for name, t in _entries(state).items():
        dim = _tp_dim(state, name)
        if dim is not None:
            t = _gather_model(_whole(t).detach(), dim, state.tp[1])
        out[name] = t.detach()
    out.update(_scalars(state))
    return out


def _scalars(state: TrainState) -> dict:
    return {"step": torch.tensor(state.step, dtype=torch.int64),
            "dropout_seed": torch.tensor(state.dropout_seed,
                                         dtype=torch.int64),
            f"{OPTIM}.count": torch.tensor(state.optimizer.count,
                                           dtype=torch.int64)}


def _quant_mismatch(step: int, state: TrainState) -> ValueError:
    on = _has_quant(state.module.state_dict())
    return ValueError(
        f"checkpoint restore failed (step {step}) on the 'quant' "
        f"subtree: this run has quant_delayed {'ON' if on else 'OFF'}, "
        f"and checkpoints carry the delayed-int8 amaxes only when the "
        f"saving run had it ON — save and resume must agree on "
        f"--quant-delayed"
    )


@torch.no_grad()
def _restore_into(path: str, step: int, state: TrainState) -> None:
    """Load the step at ``path`` into ``state`` in place. Whether the
    delayed-int8 amaxes exist is decided from the saved metadata against
    the live model, with JAX's message when save and resume disagree on
    ``--quant-delayed``."""
    import torch.distributed.checkpoint as dcp
    from torch.distributed.tensor import DTensor, distribute_tensor

    from pytorch_distributed_training_tpu_torch.parallel.sharding import (
        cut_model_slice,
    )

    saved = saved_names(path)
    if _has_quant(saved) != _has_quant(state.module.state_dict()):
        raise _quant_mismatch(step, state)
    live = _entries(state)
    targets, cut = {}, {}
    for name, t in live.items():
        dim = _tp_dim(state, name)
        if dim is None:
            targets[name] = t
            continue
        shape = list(t.shape)
        shape[dim] *= state.tp[1].size
        whole = torch.empty(shape, dtype=t.dtype, device=(
            t.to_local() if isinstance(t, DTensor) else t).device)
        targets[name], cut[name] = whole, dim
    scalars = _scalars(state)
    targets.update(scalars)
    with _quiet():
        dcp.load(targets, storage_reader=dcp.FileSystemReader(path))
    for name, dim in cut.items():
        piece = cut_model_slice(targets[name], dim, state.tp[1])
        t = live[name]
        if isinstance(t, DTensor):
            piece = distribute_tensor(piece, t.device_mesh, t.placements,
                                      src_data_rank=None).to_local()
            t = t.to_local()
        t.copy_(piece)
    state.step = int(scalars["step"])
    state.dropout_seed = int(scalars["dropout_seed"])
    state.optimizer.count = int(scalars[f"{OPTIM}.count"])


# ---------------------------------------------------------- the manager


class _HostStager:
    """The host copy a save writes from (``torch.distributed.checkpoint``'s
    ``AsyncStager`` protocol): blocking, so the copy is whole before
    ``save`` returns, into buffers made once and reused by every later
    save of the same names and shapes (pinned when the state lies on a
    card; pinning needs one)."""

    def __init__(self):
        self._buffers = None
        self._layout = None

    @property
    def should_synchronize_after_execute(self) -> bool:
        return False

    def stage(self, state_dict: dict) -> dict:
        from torch.distributed._state_dict_utils import (
            _copy_state_dict,
            _create_cpu_state_dict,
        )

        layout = {k: (tuple(t.shape), t.dtype) for k, t in state_dict.items()}
        if self._buffers is None or layout != self._layout:
            pin = any(t.device.type == "cuda" for t in state_dict.values())
            self._buffers = _create_cpu_state_dict(state_dict,
                                                   pin_memory=pin)
            self._layout = layout
        return _copy_state_dict(state_dict, self._buffers)

    def synchronize_staging(self) -> None:
        """Nothing to wait for: ``stage`` blocks."""

    def close(self) -> None:
        self._buffers = self._layout = None


class Checkpointer:
    """The checkpoint manager of a training run: ``keep`` newest steps
    under ``directory``, each verified at ``verify`` (``"off"``,
    ``"size"``, ``"digest"``) before a restore trusts it. ``saves`` and
    ``restores`` record each one's step and seconds; a save's entry gains
    its join seconds and (rank 0) the bytes written when it commits.
    Build it on every rank (under a process group it makes the saves'
    gloo group)."""

    def __init__(self, directory: str, *, keep: int = 3, verify: str = "size"):
        if verify not in ckpt_manifest.VERIFY_LEVELS:
            raise ValueError(
                f"checkpoint verify level must be one of "
                f"{ckpt_manifest.VERIFY_LEVELS}, got {verify!r}"
            )
        self.directory = os.path.abspath(directory)
        self.keep = keep
        self.verify = verify
        self.saves: list[dict] = []
        self.restores: list[dict] = []
        # submitted steps not yet joined: step -> (future, tree, entry)
        self._pending: dict[int, tuple] = {}
        self._stager = _HostStager()
        # the writes' own group: gloo (async_save needs a CPU backend),
        # apart from the training's collectives
        self._group = (dist.new_group(backend="gloo")
                       if dist.is_available() and dist.is_initialized()
                       else None)
        if _is_main():
            os.makedirs(self.directory, exist_ok=True)
        _barrier()

    def _step_path(self, step: int) -> str:
        return step_path(self.directory, step)

    def all_steps(self) -> list[int]:
        return all_steps(self.directory)

    def save(self, state: TrainState) -> str:
        """Submit ``state``'s step (every rank its shards) and return once
        its host copy is whole; the write runs on, and the step commits
        and is sealed at the next join. A step already saved is skipped
        if it is this manager's pending step or verifies, and deleted and
        saved again if it does not (a run that fell back past a corrupt
        step replaces it when it gets there again)."""
        step = int(state.step)
        path = self._step_path(step)
        reg = get_registry()
        if step in self._pending or step in self.all_steps():
            ok, reason = True, "ok"
            if step not in self._pending and self.verify != "off":
                ok, reason = ckpt_manifest.verify_step(path, level=self.verify)
            ok, reason = _agree((ok, reason))
            if ok:
                reg.inc("checkpoint/duplicate_skips")
                reg.emit({"record": "checkpoint_skip_duplicate",
                          "step": step})
                log0(f"checkpoint skip: step {step} already saved")
                return path
            reg.inc("checkpoint/resaves")
            reg.emit({"record": "checkpoint_resave", "step": step,
                      "reason": reason})
            log0(f"checkpoint step {step} exists but fails verification "
                 f"({reason}); deleting and re-saving")
        t0 = time.perf_counter()
        if self._pending:
            # the write in flight commits before a newer step supersedes it
            with watchdog_guard("checkpoint_join", step=step):
                self._join()
        with watchdog_guard("checkpoint_save", step=step):
            self._submit(state, step)
        submit_s = time.perf_counter() - t0
        self._pending[step][2]["submit_s"] = submit_s
        reg.inc("checkpoint/saves")
        # what the training loop pays: the host copy and the submit
        reg.observe("checkpoint/save_submit_s", submit_s)
        reg.emit({"record": "checkpoint_save", "step": step,
                  "submit_s": submit_s, "path": path})
        log0(f"checkpoint saving: {path} (submitted in {submit_s:.2f} s)")
        return path

    def _submit(self, state: TrainState, step: int) -> None:
        import torch.distributed.checkpoint as dcp

        tmp = os.path.join(self.directory, f".tmp-{step}")
        if _is_main():
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
        _barrier()
        saveable = _saveable(state)
        tree = ckpt_manifest.tree_summary(saveable)
        # a process with no group writes alone; the message saying so
        # comes from the writer's thread
        warnings.filterwarnings("ignore", message=".*single process")
        future = dcp.async_save(
            saveable, storage_writer=dcp.FileSystemWriter(
                tmp, thread_count=WRITE_THREADS),
            process_group=self._group, async_stager=self._stager)
        entry = dict(step=step)
        self.saves.append(entry)
        self._pending[step] = (future, tree, entry)

    def _join(self) -> None:
        """Wait for every submitted write; then rank 0 commits each step
        every rank wrote (rename, seal, prune). A step whose write failed
        on some rank gets no seal, and its temporary goes."""
        pending, self._pending = self._pending, {}
        steps = sorted(pending)
        t0 = time.perf_counter()
        oks = []
        for step in steps:
            try:
                pending[step][0].result()
                oks.append(1)
            except Exception as e:  # the write failed in the background
                logger.error("checkpoint write of step %d failed: %s: %s",
                             step, type(e).__name__, e)
                oks.append(0)
        if self._group is not None and steps:
            flags = torch.tensor(oks)
            dist.all_reduce(flags, op=dist.ReduceOp.MIN, group=self._group)
            oks = flags.tolist()
        for step, ok in zip(steps, oks):
            _, tree, entry = pending[step]
            path = self._step_path(step)
            tmp = os.path.join(self.directory, f".tmp-{step}")
            written = 0
            if _is_main():
                if ok:
                    shutil.rmtree(path, ignore_errors=True)
                    os.rename(tmp, path)
                    ckpt_manifest._fsync_path(self.directory)
                    manifest = ckpt_manifest.build_manifest(path, step,
                                                            tree=tree)
                    ckpt_manifest.write_manifest(path, manifest)
                    written = sum(f["bytes"]
                                  for f in manifest["files"].values())
                    for old in self.all_steps()[:-self.keep]:
                        shutil.rmtree(self._step_path(old),
                                      ignore_errors=True)
                else:
                    shutil.rmtree(tmp, ignore_errors=True)
            _barrier()
            entry.update(join_s=time.perf_counter() - t0, bytes=written,
                         committed=bool(ok))
            if ok:
                log0(f"checkpoint saved: {path} ({written} bytes)")

    def wait(self) -> None:
        """Join every submitted save: its step commits and is sealed."""
        with get_registry().timer("checkpoint/join_s"), watchdog_guard(
                "checkpoint_join"):
            self._join()

    def latest_step(self) -> Optional[int]:
        return latest_step(self.directory)

    def verified_latest_step(self) -> Optional[int]:
        return verified_latest_step(self.directory, level=self.verify)

    def restore(self, state: TrainState, *,
                step: Optional[int] = None) -> TrainState:
        """Load the newest verified step (or ``step``) into ``state`` in
        place and return it; a verified step that fails to load falls
        through to the next one."""
        candidates = [step] if step is not None else _agree(
            _call(lambda: restore_candidates(self.directory,
                                             level=self.verify)))
        if isinstance(candidates, BaseException):
            raise candidates
        from torch.distributed.checkpoint.api import CheckpointException

        reg = get_registry()
        last_exc: BaseException | None = None
        for i, cand in enumerate(candidates):
            t0 = time.perf_counter()
            try:
                _restore_into(self._step_path(cand), cand, state)
            # a verified step that fails to load (damage a size check
            # cannot see); CheckpointException is no Exception subclass
            except (Exception, CheckpointException) as e:
                last_exc = e
                if i + 1 < len(candidates):
                    reg.inc("checkpoint/fallbacks")
                    reg.emit({
                        "record": "checkpoint_fallback",
                        "latest_step": cand,
                        "fallback_step": candidates[i + 1],
                        "reason": f"restore failed: {type(e).__name__}",
                    })
                    log0(
                        f"checkpoint restore of step {cand} failed "
                        f"({type(e).__name__}: {e}); trying step "
                        f"{candidates[i + 1]}"
                    )
                continue
            seconds = time.perf_counter() - t0
            self.restores.append(dict(step=cand, seconds=seconds))
            reg.observe("checkpoint/restore_s", seconds)
            reg.emit({"record": "checkpoint_restore", "step": cand,
                      "restore_s": seconds, "path": self._step_path(cand)})
            log0(f"checkpoint restored: {self._step_path(cand)} "
                 f"({seconds:.2f} s)")
            return state
        assert last_exc is not None
        raise last_exc

    def close(self) -> None:
        """Join the saves in flight and release the host buffers; then the
        ``corrupt_ckpt`` fault, when armed: rank 0 damages the named (or
        newest) committed, sealed step in place."""
        with watchdog_guard("checkpoint_join"):
            self._join()
        self._stager.close()
        target = get_plan().corrupt_checkpoint_target()
        if target is not None and _is_main():
            step = self.latest_step() if target == "latest" else int(target)
            if step is not None:
                corrupt_step_dir(self._step_path(step))
                get_registry().emit({"record": "fault_injected",
                                     "fault": "corrupt_ckpt", "step": step})


def _call(fn):
    """``fn()``, or the exception it raised (so rank 0's failure reaches
    every rank through ``_agree``)."""
    try:
        return fn()
    except Exception as e:  # re-raised on every rank by the caller
        return e


# ------------------------------------------------------ module functions


def save_checkpoint(directory: str, state: TrainState, *, keep: int = 3) -> str:
    """One-shot save, committed and sealed before it returns
    (``Checkpointer`` inside training loops)."""
    t0 = time.perf_counter()
    saver = Checkpointer(directory, keep=keep)
    path = saver.save(state)
    saver.close()
    get_registry().observe("checkpoint/save_s", time.perf_counter() - t0)
    return path


def latest_step(directory: str) -> Optional[int]:
    steps = all_steps(os.path.abspath(directory))
    return steps[-1] if steps else None


def verified_latest_step(directory: str, *,
                         level: str = "size") -> Optional[int]:
    """The newest step under ``directory`` passing verification at
    ``level``: what a restore with no explicit step uses."""
    directory = os.path.abspath(directory)
    for step in reversed(all_steps(directory)):
        ok, _ = ckpt_manifest.verify_step(step_path(directory, step),
                                          level=level)
        if ok:
            return step
    return None


def restore_candidates(directory: str, *,
                       level: str = "size") -> list[int]:
    """Steps to try restoring, best first: verified steps newest first;
    if NONE verifies and none has a manifest (a pre-manifest legacy
    directory) every step newest first; else CheckpointCorruptError."""
    directory = os.path.abspath(directory)
    steps = list(reversed(all_steps(directory)))
    if not steps:
        raise FileNotFoundError(f"no checkpoint under {directory}")
    if level == "off":
        return steps
    verified, reasons, any_manifest = [], {}, False
    for step in steps:
        path = step_path(directory, step)
        if ckpt_manifest.read_manifest(path) is not None:
            any_manifest = True
        ok, reason = ckpt_manifest.verify_step(path, level=level)
        if ok:
            verified.append(step)
        else:
            reasons[step] = reason
    if verified:
        if steps[0] not in verified:
            reg = get_registry()
            reg.inc("checkpoint/fallbacks")
            reg.emit({
                "record": "checkpoint_fallback",
                "latest_step": steps[0],
                "fallback_step": verified[0],
                "reason": reasons.get(steps[0], "unverified"),
            })
            log0(
                f"checkpoint step {steps[0]} failed verification "
                f"({reasons.get(steps[0])}); falling back to verified "
                f"step {verified[0]}"
            )
        return verified
    if not any_manifest:
        log0(
            f"no checkpoint under {directory} carries an integrity "
            f"manifest (legacy save?); restoring latest unverified"
        )
        return steps
    raise CheckpointCorruptError(
        f"no verified checkpoint under {directory}: "
        + "; ".join(f"step {s}: {r}" for s, r in reasons.items())
    )


def _resolve(directory: str, step: Optional[int]) -> tuple[str, int]:
    directory = os.path.abspath(directory)
    step = latest_step(directory) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {directory}")
    return directory, step


def restore_params(directory: str, *, like=None,
                   step: Optional[int] = None) -> dict[str, torch.Tensor]:
    """The model's ``state_dict`` alone from a training checkpoint, as CPU
    tensors (the inference loader, ``cli/generate_lm.py``): the moments
    are never read. ``like`` (names, e.g. a model's ``state_dict``)
    restricts the read to those names; without it, every model tensor."""
    import torch.distributed.checkpoint as dcp

    directory, step = _resolve(directory, step)
    path = step_path(directory, step)
    prefix = MODEL + "."
    targets = {
        name: torch.empty(shape, dtype=dtype)
        for name, (shape, dtype) in saved_names(path).items()
        if name.startswith(prefix)
        and (like is None or name[len(prefix):] in like)
    }
    if like is not None:
        missing = sorted(set(like) - {n[len(prefix):] for n in targets})
        if missing:
            raise KeyError(f"checkpoint {path} lacks {missing[:5]}")
    # each process reads on its own (no collective), whatever group it is in
    dcp.load(targets, storage_reader=dcp.FileSystemReader(path),
             no_dist=True)
    log0(f"params restored: {path}")
    return {name[len(prefix):]: t for name, t in targets.items()}


def saved_params_scanned(directory: str, *,
                         step: Optional[int] = None) -> bool:
    """True if the checkpoint's model uses the stacked ``layers_scan``
    trunk; reads the metadata only, no tensor bytes."""
    from pytorch_distributed_training_tpu_torch.models.relayout import (
        has_scanned_trunk,
    )

    directory, step = _resolve(directory, step)
    names = [n for n in saved_names(step_path(directory, step))
             if n.startswith(MODEL + ".")]
    if not names:
        raise ValueError(f"unrecognized checkpoint metadata under {directory}")
    return has_scanned_trunk(names)


def restore_checkpoint(directory: str, state: TrainState, *,
                       step: Optional[int] = None) -> TrainState:
    """Load ``step`` (default: the latest, unverified) into ``state`` in
    place, on its layout, and return it."""
    directory, step = _resolve(directory, step)
    _restore_into(step_path(directory, step), step, state)
    log0(f"checkpoint restored: {directory}/{step}")
    return state
