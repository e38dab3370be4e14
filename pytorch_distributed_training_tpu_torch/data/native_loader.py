"""The batch loader on the C++ batch assembler (counterpart: the JAX
package's ``data/native_loader.py`` ``NativeShardedLoader``).

The same batches as ``data/pipeline.py``'s ``ShardedLoader`` (it is a
subclass, and ships as it does): train batches ``[accum, micro_local,
...]``, eval batches ``[local_batch, ...]`` with a ``valid`` mask, every
example once and the ragged tail padded. What differs is who assembles:
a pool of two C++ workers (``native/src/batcher.cpp``) gathers the rows
into a ring of four reusable slots ahead of the consumer.

- Order: the train permutation is ``np.random.default_rng((seed,
  epoch)).permutation``, computed here and handed to the C++ side, the
  Python loader's order byte for byte, so the engines are
  interchangeable mid-run (a resume under the other engine skips the
  same batches). Eval's order is the identity padded with the last row
  up to a whole number of batches; the pad rows are masked off by
  ``valid``, built here per step.
- Integer datasets only (a ``TypeError`` otherwise); the arrays are held
  as int32, and each batch is cast back to its array's dtype.
- Slot lifetime: a batch is read out of a ring slot, which the C++
  workers refill once it is released. The shipping copies the slot
  before it returns (to pinned memory or the card, see
  ``data/pipeline.py``; on the CPU a ``clone``), so no batch aliases a
  slot and the slot is released at once, before the batch is yielded.
- ``data/prefetch_wait_s`` times each wait for the next ready slot (~0
  when the workers are ahead), in place of the Python engine's assembly
  timers, as in JAX; ``data/h2d_place_s`` times the copy.
"""

from __future__ import annotations

import ctypes
import time
from typing import Iterator

import numpy as np

from pytorch_distributed_training_tpu_torch.data.pipeline import (
    ShardedLoader,
)
from pytorch_distributed_training_tpu_torch.native import load_batcher_lib
from pytorch_distributed_training_tpu_torch.telemetry.registry import (
    get_registry,
)

_RING_SLOTS = 4
_WORKERS = 2


class NativeShardedLoader(ShardedLoader):
    """``ShardedLoader`` (train or eval) assembled by the C++ workers."""

    def __init__(self, data: dict[str, np.ndarray], **kw):
        for k, v in data.items():
            if not np.issubdtype(np.asarray(v).dtype, np.integer):
                raise TypeError(
                    f"native loader serves integer datasets only; {k!r} is "
                    f"{np.asarray(v).dtype}: use pipeline.ShardedLoader")
        lib = load_batcher_lib()
        if lib is None:
            raise RuntimeError("native batcher unavailable (no C++ "
                               "toolchain?): use pipeline.ShardedLoader")
        super().__init__(data, **kw)
        self._lib = lib
        # int32, C-contiguous copies the C++ side points at; keys sorted
        # for one array order on every rank
        self._keys = sorted(data)
        self._dtypes = [np.asarray(data[k]).dtype for k in self._keys]
        self._arrays = [np.ascontiguousarray(np.asarray(data[k], np.int32))
                        for k in self._keys]
        self._row_elems = [int(np.prod(a.shape[1:], dtype=np.int64))
                           for a in self._arrays]
        self._row_shapes = [a.shape[1:] for a in self._arrays]
        self._micro_local = self.global_batch // self.accum \
            // self.world_size
        # eval pads the ragged tail into a whole last step: the C++ side
        # counts steps from this row count
        gb = self.global_batch
        self._n_epoch_rows = (self.n if self.train
                              else -(-self.n // gb) * gb)
        self._handle = None  # made (and its workers started) per use

    def _open(self):
        """The C++ batcher, made on first use and again after
        ``close()``."""
        if self._handle is None:
            ptrs = (ctypes.c_void_p * len(self._arrays))(
                *[a.ctypes.data_as(ctypes.c_void_p).value
                  for a in self._arrays])
            row_elems = (ctypes.c_int64 * len(self._arrays))(
                *self._row_elems)
            self._handle = self._lib.batcher_create(
                ptrs, row_elems, len(self._arrays), self._n_epoch_rows,
                self.accum, self.global_batch // self.accum,
                self._micro_local, self.rank * self._micro_local,
                _RING_SLOTS, _WORKERS)
        return self._handle

    def epoch(self, epoch_index: int = 0) -> Iterator[dict]:
        if self.train:
            perm = np.random.default_rng(
                (self.seed, epoch_index)).permutation(self.n)
        else:
            perm = np.full(self._n_epoch_rows, self.n - 1, np.int64)
            perm[:self.n] = np.arange(self.n)
        perm = np.ascontiguousarray(perm, np.int64)
        lib = self._lib
        handle = self._open()
        n_steps = lib.batcher_start_epoch(
            handle, perm.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
        out_ptrs = (ctypes.c_void_p * len(self._arrays))()
        reg = get_registry()
        lo = self.rank * self._micro_local
        for step in range(n_steps):
            if self._handle != handle:  # closed while suspended
                return
            t0 = time.perf_counter()
            slot = lib.batcher_next(handle, out_ptrs)
            reg.observe("data/prefetch_wait_s", time.perf_counter() - t0)
            if slot < 0:
                break
            batch = {}
            for i, k in enumerate(self._keys):
                shape = (self.accum, self._micro_local,
                         *self._row_shapes[i])
                n_el = int(np.prod(shape, dtype=np.int64))
                buf = (ctypes.c_int32 * n_el).from_address(out_ptrs[i])
                v = np.frombuffer(buf, np.int32).reshape(shape)
                if self._dtypes[i] != np.int32:
                    v = v.astype(self._dtypes[i])
                batch[k] = v if self.train else v[0]
            if self.train:
                placed = self._placed(batch, rank=2, t0=t0, timer=None,
                                      copy=True)
            else:
                valid_n = min(self.n - step * self.global_batch,
                              self.global_batch)
                valid = (np.arange(self.global_batch)
                         < valid_n).astype(np.int32)
                batch["valid"] = valid[lo:lo + self._micro_local]
                placed = self._placed(batch, rank=1, t0=t0, timer=None,
                                      copy=True)
            lib.batcher_release(handle, slot)  # the batch is a copy
            yield placed

    def close(self) -> None:
        if getattr(self, "_handle", None):
            self._lib.batcher_destroy(self._handle)
            self._handle = None

    def __del__(self):  # best effort; close() is the API
        try:
            self.close()
        except Exception:
            pass
