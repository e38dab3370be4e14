"""Rank-sharded batching: dataset arrays -> device batches (counterpart: the
JAX package's ``data/pipeline.py`` ``resolve_batch_geometry`` and
``ShardedLoader``, and of ``comms/ingest.py`` ``make_global_batch``: the
trainer passes the batch shard, ``comms/mesh.batch_index`` over (data,
fsdp), and their count as ``rank`` and ``world_size``, in place of
``process_index`` and ``process_count``).

- One seeded permutation per epoch, ``np.random.default_rng((seed,
  epoch))``, identical on every rank; each rank takes its contiguous slice
  of every accumulation-reshaped global batch, as each JAX host does.
- Train batches are ``[accum, micro_local, ...]`` tensors on the device
  (the ragged tail of the epoch is dropped), so one copy per optimizer
  step ships the whole accumulation window.
- Eval keeps every example exactly once: the last batch is padded with
  the last row and carries a ``valid`` mask that zeroes the pad rows out
  of every metric.
- Context parallelism (``seq_index``/``seq_size``, the rank's place on
  the mesh's ``seq`` axis; ``comms/ingest.py``'s ``_leaf_spec``): every
  sequence-bearing leaf (``[..., batch, S]``, one dim more than the
  labels) keeps this rank's ``S / seq_size`` columns; the labels and
  ``valid`` stay whole. ``whole_rows`` (a function of the batch dict, as
  tensors on the CPU) runs on each batch before the cut: the LM step's
  targets are shifted on the whole row (``train/step.py``).
- Each batch's host assembly and device placement are timed into the
  default registry (``data/host_assemble_s`` or ``data/eval_assemble_s``,
  ``data/h2d_place_s``), and the ``slow_host`` fault (``faults/inject.py``)
  stretches them.

The shipping (``_placed`` / ``_ship``: ``whole_rows``, the column cut,
the timers, the fault, the copy) is shared with the C++ engine,
``data/native_loader.py``'s ``NativeShardedLoader``, a subclass that
assembles the same batches on a worker pool. On a card the copy on the
default stream (the step thread's, without prefetch) is a synchronous
``.to(device)``; on a side stream (``data/prefetch.py``'s worker) it goes
through pinned host memory with ``non_blocking=True``. Either way the
host array has been read when ``_ship`` returns. On the CPU a batch is
the assembled array itself unless ``copy`` asks for a copy (the C++
engine's ring slots are reused).
"""

from __future__ import annotations

import math
import time
from typing import Iterator

import numpy as np
import torch

from pytorch_distributed_training_tpu_torch.faults.inject import get_plan
from pytorch_distributed_training_tpu_torch.telemetry.registry import (
    get_registry,
)


def resolve_batch_geometry(*, global_batch_size: int, grad_accum_steps: int,
                           train: bool, rank: int = 0, world_size: int = 1):
    """Validate and derive the per-rank batch geometry.

    Returns (rank, world_size, micro_global, micro_local, local_per_step).
    """
    accum = grad_accum_steps if train else 1
    if global_batch_size % (accum * world_size):
        raise ValueError(
            f"global batch {global_batch_size} must divide by "
            f"accum*ranks ({accum}*{world_size})"
        )
    micro_global = global_batch_size // accum
    micro_local = micro_global // world_size
    return (rank, world_size, micro_global, micro_local,
            global_batch_size // world_size)


class ShardedLoader:
    """Iterates this rank's batches from numpy arrays holding the FULL
    dataset (GLUE scale) on every rank."""

    def __init__(self, data: dict[str, np.ndarray], *, global_batch_size: int,
                 grad_accum_steps: int = 1, train: bool = True,
                 seed: int = 42, rank: int = 0, world_size: int = 1,
                 device=None, seq_index: int = 0, seq_size: int = 1,
                 whole_rows=None):
        self.data = data
        self.seq_index, self.seq_size = seq_index, seq_size
        self.whole_rows = whole_rows
        for k, v in data.items():
            if v.ndim > 1 and v.shape[-1] % seq_size:
                raise ValueError(
                    f"{k}: sequence length {v.shape[-1]} is not divisible "
                    f"by the seq axis of {seq_size}")
        self.train = train
        self.seed = seed
        self.device = torch.device(device if device is not None else "cpu")
        self.global_batch = global_batch_size
        self.accum = grad_accum_steps if train else 1
        self.n = len(next(iter(data.values())))
        (self.rank, self.world_size, _, _,
         self.local_per_step) = resolve_batch_geometry(
            global_batch_size=global_batch_size,
            grad_accum_steps=grad_accum_steps, train=train, rank=rank,
            world_size=world_size,
        )

    @property
    def steps_per_epoch(self) -> int:
        if self.train:
            return self.n // self.global_batch
        return math.ceil(self.n / self.global_batch)

    def first_micro(self, micro_global: int) -> dict:
        """This rank's rows of the dataset's first ``micro_global`` rows in
        order (wrapped on a tiny dataset), shipped as an eval batch is:
        the delayed-int8 calibration batch (JAX ``train/loop.py:255-296``
        builds it from the dataset arrays too, not from the loader)."""
        micro_local = micro_global // self.world_size
        take = np.arange(micro_global) % self.n
        local = take[self.rank * micro_local:(self.rank + 1) * micro_local]
        return self._ship({k: v[local] for k, v in self.data.items()},
                          rank=1)

    def epoch(self, epoch_index: int = 0) -> Iterator[dict]:
        if self.train:
            yield from self._train_epoch(epoch_index)
        else:
            yield from self._eval_epoch()

    def _train_epoch(self, epoch_index: int) -> Iterator[dict]:
        rng = np.random.default_rng((self.seed, epoch_index))
        perm = rng.permutation(self.n)
        micro_global = self.global_batch // self.accum
        micro_local = micro_global // self.world_size
        lo_r = self.rank * micro_local
        for step in range(self.steps_per_epoch):
            t0 = time.perf_counter()
            idx = perm[step * self.global_batch:(step + 1) * self.global_batch]
            idx = idx.reshape(self.accum, micro_global)
            local = idx[:, lo_r:lo_r + micro_local]
            yield self._placed({k: v[local] for k, v in self.data.items()},
                               rank=2, t0=t0, timer="data/host_assemble_s")

    def _eval_epoch(self) -> Iterator[dict]:
        per_rank = self.local_per_step
        lo_r = self.rank * per_rank
        for step in range(self.steps_per_epoch):
            t0 = time.perf_counter()
            lo = step * self.global_batch
            idx_global = np.arange(lo, min(lo + self.global_batch, self.n))
            valid_n = len(idx_global)
            if valid_n < self.global_batch:  # pad the ragged tail
                pad = np.full(self.global_batch - valid_n, self.n - 1,
                              np.int64)
                idx_global = np.concatenate([idx_global, pad])
            local_sel = idx_global[lo_r:lo_r + per_rank]
            batch = {k: v[local_sel] for k, v in self.data.items()}
            valid = (np.arange(self.global_batch) < valid_n).astype(np.int32)
            batch["valid"] = valid[lo_r:lo_r + per_rank]
            yield self._placed(batch, rank=1, t0=t0,
                               timer="data/eval_assemble_s")

    def _placed(self, batch: dict, rank: int, t0: float,
                timer: str | None, copy: bool = False) -> dict:
        """``_ship(batch, rank, copy)``, the assembly since ``t0`` timed
        under ``timer`` (None: not timed) and the placement under
        ``data/h2d_place_s`` in the default registry, then stretched by
        the ``slow_host`` fault when one is armed."""
        t1 = time.perf_counter()
        out = self._ship(batch, rank, copy)
        reg = get_registry()
        if timer is not None:
            reg.observe(timer, t1 - t0)
        reg.observe("data/h2d_place_s", time.perf_counter() - t1)
        get_plan().slow_host_delay(time.perf_counter() - t0)
        return out

    def _ship(self, batch: dict, rank: int, copy: bool = False) -> dict:
        """``batch`` (rows of rank ``rank``: [accum, micro] or [batch]) to
        the device, through ``whole_rows`` and this rank's columns; on the
        CPU a copy when ``copy`` (the arrays are reused later)."""
        batch = {k: torch.from_numpy(np.ascontiguousarray(v))
                 for k, v in batch.items()}
        if self.whole_rows is not None:
            batch = self.whole_rows(batch)
        cuda = self.device.type == "cuda"
        side = cuda and torch.cuda.current_stream(self.device) \
            != torch.cuda.default_stream(self.device)
        cols = {}
        for k, v in batch.items():
            if v.dim() > rank:  # [..., S]: this rank's S / seq_size
                width = v.shape[-1] // self.seq_size
                v = v.narrow(-1, self.seq_index * width, width)
            v = v.contiguous()
            if side:
                v = v.pin_memory().to(self.device, non_blocking=True)
            elif copy and not cuda:
                v = v.clone()
            cols[k] = v.to(self.device)
        return cols

    def close(self) -> None:
        """Release the engine's resources (none for this one)."""
