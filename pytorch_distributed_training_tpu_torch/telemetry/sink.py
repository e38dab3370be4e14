"""The rank-0 JSONL metrics sink and the run-metadata header
(counterpart: the JAX package's ``telemetry/sink.py``).

One record a line, appended and flushed as they happen, so a crashed or
preempted run leaves a readable stream up to its last completed step.
The record types and keys are the JAX package's, so
``scripts/summarize_metrics.py`` reads the port's stream:

- ``run_meta``: one header per (re)started run: the mesh shape, chip and
  process counts, the resolved model and train configs, JAX's
  ``jax_version`` and ``backend`` keys (None, since no JAX runs, and the
  device type), and the port's own ``rank`` (JAX's process index),
  ``torch_version`` and ``device_name``;
- ``step``: per-step timings (data wait, dispatch, device block) and
  loss; ``compile_inclusive`` marks the first step (its kernel builds);
- ``epoch``: the Trainer's history record, the straggler stats and the
  epoch's timer snapshot;
- ``checkpoint_save`` / ``checkpoint_restore`` / ``checkpoint_fallback``
  / ``checkpoint_skip_duplicate`` / ``checkpoint_resave`` / ``restart``
  / ``preemption`` / ``watchdog_*`` / ``fault_injected``: events.

Every record gains a ``ts`` wall-clock field at write time. The file
opens in append mode: a supervised restart continues the same stream,
with a fresh ``run_meta`` marking the attempt. The sink's lock is the
registry's ``telemetry.sink`` (``analysis/concurrency``). Importing the
module costs no torch (the fleet's coordinator writes through it);
``run_metadata`` imports it when called.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Any

from pytorch_distributed_training_tpu_torch.analysis import concurrency
from pytorch_distributed_training_tpu_torch.utils.logging import current_rank


def _jsonable(x: Any):
    """Best-effort coercion for config values (paths, numpy scalars)."""
    if isinstance(x, (str, int, float, bool)) or x is None:
        return x
    if isinstance(x, dict):
        return {str(k): _jsonable(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_jsonable(v) for v in x]
    try:
        return float(x)
    except (TypeError, ValueError):
        return str(x)


class JsonlSink:
    """Append-mode JSONL writer, active on rank 0 only: build it on every
    process, so call sites never branch on rank."""

    def __init__(self, metrics_dir: str, *, filename: str = "metrics.jsonl",
                 process_index: int | None = None):
        pidx = current_rank() if process_index is None else process_index
        self._file = None
        # a lock keeps each line whole when several threads emit (the
        # watchdog's monitor beside the train loop)
        self._lock = concurrency.lock("telemetry.sink")
        self.path = os.path.join(os.path.abspath(metrics_dir), filename)
        if pidx == 0:
            os.makedirs(os.path.dirname(self.path), exist_ok=True)
            self._file = open(self.path, "a")

    @property
    def active(self) -> bool:
        return self._file is not None

    def emit(self, record: dict) -> None:
        if self._file is None:
            return
        rec = dict(record)
        rec.setdefault("ts", time.time())
        line = json.dumps(_jsonable(rec)) + "\n"
        with self._lock:
            if self._file is None:  # closed while we serialized
                return
            self._file.write(line)
            self._file.flush()

    def flush(self, *, fsync: bool = False) -> None:
        """Push buffered records to the OS, and with ``fsync`` to disk (the
        crash, preemption and watchdog exits call it)."""
        with self._lock:
            if self._file is None:
                return
            self._file.flush()
            if fsync:
                os.fsync(self._file.fileno())

    def close(self) -> None:
        with self._lock:
            if self._file is not None:
                self._file.close()
                self._file = None


def run_metadata(mesh, device: torch.device, model_config=None,
                 train_config=None, **extra) -> dict:
    """The ``run_meta`` header record of a run on ``mesh`` (the port's
    ``comms/mesh.Mesh``) and ``device``."""
    import torch
    import torch.distributed as dist

    world = (dist.get_world_size() if dist.is_available()
             and dist.is_initialized() else 1)
    rec = {
        "record": "run_meta",
        "mesh_shape": {k: int(v) for k, v in mesh.shape.items()},
        "chip_count": world,
        "process_count": world,
        "jax_version": None,
        "backend": device.type,
        "config": {},
        "rank": current_rank(),
        "torch_version": torch.__version__,
        "device_name": (torch.cuda.get_device_name(device)
                        if device.type == "cuda" else "cpu"),
    }
    for key, cfg in (("model", model_config), ("train", train_config)):
        if cfg is not None:
            rec["config"][key] = _jsonable(dataclasses.asdict(cfg))
    rec.update(extra)
    return rec
