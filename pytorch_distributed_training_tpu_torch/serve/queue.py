"""Admission queue for the serving engine (counterpart: the JAX package's
``serve/queue.py``): backpressure, deadlines, prompt-length buckets.

- **Backpressure**: ``submit`` raises ``BackpressureError`` the moment the
  queue holds ``max_depth`` requests: rejected in O(1), never hung.
- **Deadlines**: ``deadline_s`` (relative to submit); ``expire_overdue``
  sweeps queued requests past it, and the engine applies the same check
  to running slots between ticks.
- **FIFO within bucket**: requests are grouped by prompt-length bucket;
  across buckets the earliest-submitted head goes first. ``pop_ready``'s
  ``accept`` predicate (the engine's page budget) is strict no-bypass: a
  head that does not fit blocks the queue, so it is never starved.

SLO tier lanes, tenants and the brownout ladder are not ported yet.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Callable, Optional

import numpy as np


class BackpressureError(RuntimeError):
    """The queue is at ``max_depth``: resubmit later."""


@dataclasses.dataclass
class GenRequest:
    """One generation request plus its runtime bookkeeping.

    The submitting thread owns construction; after ``submit`` the engine
    thread owns all mutable state until ``done.set()``. Timing fields are
    ``time.monotonic()`` stamps.
    """

    id: str
    prompt_ids: np.ndarray                  # [prompt_len] int32
    max_new_tokens: int
    temperature: float = 0.0                # 0 = greedy
    top_k: int = 0
    eot_id: Optional[int] = None
    seed: int = 0                           # per-request sampling stream
    deadline_s: Optional[float] = None      # relative to submit
    stream: Optional[Callable] = None       # stream(req, token_id) per token
    on_finish: Optional[Callable] = None    # on_finish(req) at terminal state
    # speculative decoding opt-in/out; None defers to the engine default
    # (on whenever EngineConfig.spec_k > 0). Spec and non-spec slots emit
    # the same stream, so this is a latency knob, not a quality one.
    spec: Optional[bool] = None

    # ---- engine-owned runtime state
    status: str = "new"      # new -> queued -> running -> done|expired|cancelled|error
    finish_reason: Optional[str] = None     # length | eot | deadline | cancelled
    tokens: list = dataclasses.field(default_factory=list)
    bucket: int = 0
    submit_t: float = 0.0
    admit_t: Optional[float] = None
    first_token_t: Optional[float] = None
    finish_t: Optional[float] = None
    decode_ticks: int = 0    # decode or verify dispatches that advanced it
    chunks: int = 0          # chunked-prefill dispatches consumed
    prefix_hit: bool = False  # admission mapped shared prefix pages
    cached_tokens: int = 0   # prompt tokens served from the prefix cache
    drafted: int = 0         # speculative tokens drafted for it
    accepted: int = 0        # speculative tokens accepted for it
    done: threading.Event = dataclasses.field(default_factory=threading.Event)

    @property
    def prompt_len(self) -> int:
        return int(self.prompt_ids.shape[0])

    def overdue(self, now: float) -> bool:
        return (
            self.deadline_s is not None
            and now - self.submit_t > self.deadline_s
        )


class RequestQueue:
    """Bounded, bucketed, deadline-aware FIFO feeding the decode engine."""

    def __init__(self, *, max_depth: int, prompt_buckets: tuple,
                 max_new_tokens: int):
        if max_depth < 1:
            raise ValueError(f"max_depth must be >= 1, got {max_depth}")
        if not prompt_buckets or list(prompt_buckets) != sorted(
            set(int(b) for b in prompt_buckets)
        ):
            raise ValueError(
                f"prompt_buckets must be sorted unique positive lengths, "
                f"got {prompt_buckets!r}"
            )
        self.max_depth = max_depth
        self.prompt_buckets = tuple(int(b) for b in prompt_buckets)
        self.max_new_tokens = max_new_tokens
        self._buckets: dict[int, deque] = {b: deque() for b in self.prompt_buckets}
        self._lock = threading.Lock()
        self._work = threading.Condition(self._lock)
        self._closed = False

    def bucket_for(self, prompt_len: int) -> int:
        """Smallest configured bucket that fits ``prompt_len``."""
        for b in self.prompt_buckets:
            if prompt_len <= b:
                return b
        raise ValueError(
            f"prompt length {prompt_len} exceeds the largest bucket "
            f"{self.prompt_buckets[-1]}"
        )

    def submit(self, request: GenRequest) -> GenRequest:
        """Admit ``request`` or raise (``BackpressureError`` when full;
        ``ValueError`` for requests the engine could never serve)."""
        if request.prompt_len < 1:
            raise ValueError("empty prompt")
        if not 1 <= request.max_new_tokens <= self.max_new_tokens:
            raise ValueError(
                f"max_new_tokens {request.max_new_tokens} outside "
                f"[1, {self.max_new_tokens}]"
            )
        if request.top_k < 0:
            raise ValueError(f"top_k must be >= 0, got {request.top_k}")
        if not np.isfinite(request.temperature):
            raise ValueError(
                f"temperature must be finite, got {request.temperature}"
            )
        bucket = self.bucket_for(request.prompt_len)
        with self._lock:
            if self._closed:
                raise RuntimeError("queue is closed to new requests")
            if self.depth() >= self.max_depth:
                raise BackpressureError(
                    f"queue at max depth {self.max_depth}; retry later"
                )
            request.bucket = bucket
            request.status = "queued"
            request.submit_t = time.monotonic()
            self._buckets[bucket].append(request)
            self._work.notify_all()
        return request

    def depth(self) -> int:
        """Queued-request count (deque lengths are atomic reads)."""
        return sum(len(d) for d in self._buckets.values())

    def expire_overdue(self, now: Optional[float] = None) -> list:
        """Remove and return every queued request past its deadline."""
        now = time.monotonic() if now is None else now
        expired = []
        with self._lock:
            for dq in self._buckets.values():
                keep = deque()
                while dq:
                    req = dq.popleft()
                    (expired if req.overdue(now) else keep).append(req)
                dq.extend(keep)
        return expired

    def pop_ready(self, accept=None, defer=None) -> Optional[GenRequest]:
        """The earliest-submitted bucket head, or None when idle, when
        ``defer`` holds it or when ``accept`` rejects it.

        ``defer`` is a transient hold checked before ``accept``: True
        leaves the head in place with no side effect (the engine holds
        admissions while ``prefill_concurrency`` prompts stream in, and the
        hold is not page exhaustion). ``accept`` is the engine's admission
        predicate (the page budget)."""
        with self._lock:
            head = None
            for dq in self._buckets.values():
                if dq and (head is None or dq[0].submit_t < head[0].submit_t):
                    head = dq
            if head is None:
                return None
            if defer is not None and defer(head[0]):
                return None
            if accept is not None and not accept(head[0]):
                return None
            return head.popleft()

    def wait_for_work(self, timeout: float) -> bool:
        """Engine-side idle wait; True when work may be available."""
        with self._lock:
            if self.depth() or self._closed:
                return True
            return self._work.wait(timeout)

    def close(self) -> None:
        """Refuse new submissions (queued requests stay drainable)."""
        with self._lock:
            self._closed = True
            self._work.notify_all()

    def drain_pending(self) -> list:
        """Remove and return every queued request."""
        with self._lock:
            out = []
            for dq in self._buckets.values():
                out.extend(dq)
                dq.clear()
        return out
