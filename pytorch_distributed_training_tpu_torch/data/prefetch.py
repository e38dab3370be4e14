"""Prefetch over either loader engine (counterpart: the JAX package's
``data/prefetch.py`` ``PrefetchingIterator`` and ``PrefetchingLoader``).

The loaders assemble a batch and copy it to the device on the thread that
asks for it, so without this the step thread waits for both between
steps. A ``PrefetchingIterator`` runs one epoch's stream on a background
thread into a queue of ``depth`` batches: while step ``i`` runs, batches
``i + 1 … i + depth`` are assembled and copied.

- The order is the loader's, bit for bit: one worker, one FIFO queue (a
  mid-epoch resume's dropped prefix still drops the same batches).
- A worker's error is raised at the consumer's next ``__next__``, after
  the batches queued before it.
- ``close()`` stops the worker, drains the queue, joins the thread and
  closes the inner stream on the worker (the C++ engine releases its
  slots there); it runs once, under the registry's
  ``data.prefetch.close`` lock (``analysis/concurrency``).
- On a card the worker makes its copies on a side stream it enters on its
  own thread (the current stream is per thread) and records an event
  after each batch; the consumer makes its current stream wait for that
  event and marks the batch's tensors as used on it (``record_stream``),
  so the allocator does not hand their memory back to the side stream
  early.

Telemetry (each pop, into the default registry):
``data/prefetch_occupancy`` (batches ready at the pop; the depth when the
loader is fully hidden), and on an empty queue the counter
``data/prefetch_stalls`` and the wait ``data/prefetch_stall_s``.

``PrefetchingLoader`` wraps a loader: each ``epoch(i)`` is a
``PrefetchingIterator`` over the inner loader's epoch, and a new epoch
retires the previous iterator (one left half-read by an exception must not
keep its worker). Every other attribute is the inner loader's.
"""

from __future__ import annotations

import contextlib
import queue
import threading
from time import perf_counter
from typing import Iterator

import torch

from pytorch_distributed_training_tpu_torch.analysis import concurrency
from pytorch_distributed_training_tpu_torch.telemetry.registry import (
    get_registry,
)

_ITEM, _DONE, _ERROR = 0, 1, 2


def _tensors(batch):
    return batch.values() if isinstance(batch, dict) else ()


class PrefetchingIterator:
    """One epoch's batch stream, run ``depth`` batches ahead on a
    background thread."""

    def __init__(self, source: Iterator, depth: int, *, name: str = "batch",
                 device=None):
        if depth < 1:
            raise ValueError(f"prefetch depth must be >= 1, got {depth}")
        self.depth = depth
        self._src = source
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._finished = False  # the consumer saw _DONE or _ERROR
        # close() may race itself (the trainer's finally and __del__)
        self._close_lock = concurrency.lock("data.prefetch.close")
        self._closed = False
        self.last_occupancy = 0
        self.last_wait_s = 0.0
        device = torch.device(device) if device is not None else None
        self._cuda = device if device is not None and \
            device.type == "cuda" else None
        self._thread = threading.Thread(
            target=self._work, name=f"prefetch-{name}", daemon=True)
        self._thread.start()

    # ------------------------------------------------------------ producer

    def _put(self, msg) -> bool:
        """Enqueue, answering close(); False: told to stop."""
        while not self._stop.is_set():
            try:
                self._q.put(msg, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def _work(self) -> None:
        side = (torch.cuda.Stream(self._cuda) if self._cuda is not None
                else None)
        try:
            with (torch.cuda.stream(side) if side is not None
                  else contextlib.nullcontext()):
                for item in self._src:
                    ready = None
                    if side is not None:
                        ready = torch.cuda.Event()
                        ready.record(side)
                    if not self._put((_ITEM, (item, ready))):
                        return
            self._put((_DONE, None))
        except BaseException as e:  # noqa: BLE001 - raised at the consumer
            self._put((_ERROR, e))
        finally:
            # the stream's own finally (slot releases) runs here, on the
            # thread that advanced it
            close = getattr(self._src, "close", None)
            if close is not None:
                try:
                    close()
                except Exception:
                    pass

    # ------------------------------------------------------------ consumer

    def __iter__(self):
        return self

    def __next__(self):
        if self._finished or self._closed:
            raise StopIteration
        reg = get_registry()
        occupancy = self._q.qsize()
        t0 = perf_counter()
        while True:
            try:
                kind, val = self._q.get(timeout=0.1)
                break
            except queue.Empty:
                if self._closed or not self._thread.is_alive():
                    # a worker gone without its sentinel must not hang us
                    if self._q.qsize():
                        continue
                    raise StopIteration from None
        if kind == _ITEM:
            wait = perf_counter() - t0
            self.last_occupancy = occupancy
            self.last_wait_s = wait
            reg.observe("data/prefetch_occupancy", float(occupancy))
            if occupancy == 0:
                reg.inc("data/prefetch_stalls")
                reg.observe("data/prefetch_stall_s", wait)
            item, ready = val
            if ready is not None:
                current = torch.cuda.current_stream(self._cuda)
                current.wait_event(ready)
                for t in _tensors(item):
                    t.record_stream(current)
            return item
        self._finished = True
        if kind == _ERROR:
            raise val
        raise StopIteration

    # ----------------------------------------------------------- lifecycle

    def close(self) -> None:
        """Stop the worker, drain the queue, join; once."""
        with self._close_lock:
            if self._closed:
                return
            self._closed = True
        self._stop.set()
        while True:  # unblock a producer waiting on a full queue
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        self._thread.join(timeout=5.0)

    def __del__(self):  # best effort; close() is the API
        try:
            self.close()
        except Exception:
            pass


class PrefetchingLoader:
    """A loader whose ``epoch()`` is prefetched ``depth`` batches ahead."""

    def __init__(self, inner, *, depth: int = 2):
        if depth < 1:
            raise ValueError(f"prefetch depth must be >= 1, got {depth}")
        self.inner = inner
        self.depth = depth
        self._active: PrefetchingIterator | None = None

    def __getattr__(self, name):
        # steps_per_epoch, first_micro, accum, ...: the inner loader's
        if name in ("inner", "_active"):
            raise AttributeError(name)
        return getattr(self.inner, name)

    @property
    def last_occupancy(self) -> int:
        return self._active.last_occupancy if self._active else 0

    @property
    def last_wait_s(self) -> float:
        return self._active.last_wait_s if self._active else 0.0

    def epoch(self, epoch_index: int = 0) -> PrefetchingIterator:
        self._retire()
        self._active = PrefetchingIterator(
            self.inner.epoch(epoch_index), self.depth,
            name=f"epoch{epoch_index}",
            device=getattr(self.inner, "device", None))
        return self._active

    def _retire(self) -> None:
        if self._active is not None:
            self._active.close()
            self._active = None

    def close(self) -> None:
        self._retire()
        close = getattr(self.inner, "close", None)
        if close is not None:
            close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
