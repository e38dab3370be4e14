"""Rank-sharded batching: dataset arrays -> device batches (counterpart: the
JAX package's ``data/pipeline.py`` ``resolve_batch_geometry`` and
``ShardedLoader``, with the rank and world size of ``torch.distributed`` in
place of ``process_index`` and ``process_count``).

- One seeded permutation per epoch, ``np.random.default_rng((seed,
  epoch))``, identical on every rank; each rank takes its contiguous slice
  of every accumulation-reshaped global batch, as each JAX host does.
- Train batches are ``[accum, micro_local, ...]`` tensors on the device
  (the ragged tail of the epoch is dropped), so one copy per optimizer
  step ships the whole accumulation window.
- Eval keeps every example exactly once: the last batch is padded with
  the last row and carries a ``valid`` mask that zeroes the pad rows out
  of every metric.
"""

from __future__ import annotations

import math
from typing import Iterator

import numpy as np
import torch


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


def _to_device(batch: dict, device) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items()}


class ShardedLoader:
    """Iterates this rank's batches from numpy arrays holding the FULL
    dataset (GLUE scale) on every rank."""

    def __init__(self, data: dict[str, np.ndarray], *, global_batch_size: int,
                 grad_accum_steps: int = 1, train: bool = True,
                 seed: int = 42, rank: int = 0, world_size: int = 1,
                 device=None):
        self.data = data
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
            idx = perm[step * self.global_batch:(step + 1) * self.global_batch]
            idx = idx.reshape(self.accum, micro_global)
            local = idx[:, lo_r:lo_r + micro_local]
            yield _to_device({k: v[local] for k, v in self.data.items()},
                             self.device)

    def _eval_epoch(self) -> Iterator[dict]:
        per_rank = self.local_per_step
        lo_r = self.rank * per_rank
        for step in range(self.steps_per_epoch):
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
            yield _to_device(batch, self.device)
