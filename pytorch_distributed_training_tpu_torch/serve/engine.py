"""Continuous-batching decode engine: paged KV cache + on-device sampling
(counterpart: the JAX package's ``serve/engine.py``, the path
``kv_layout="paged"``, ``sampling="device"``).

- **KV layout**: K/V lives in fixed-size pages, ``[num_pages, page_size,
  heads, head_dim]`` pools per attention layer, addressed through a
  per-slot block table that ``serve/paged_cache.py`` allocates on admit
  and frees on evict (page 0 is the null page idle slots park on). The
  pools are tensors this engine owns; the model writes them in place.
- **Prefill into a slot**: one batch-1 forward per request at its prompt
  bucket. The prompt is right-padded to the bucket and all bucket
  positions are scattered into the slot's pages; pad positions are
  overwritten by generated tokens one step before the length mask would
  first expose them, so they are never read.
- **Decode**: one batch-``num_slots`` forward per tick, per-slot
  ``position_ids``/``context_len``; idle slots read and write the null
  page and their outputs are ignored.
- **Sampling** on the device (``serve/sampling.py``); each tick moves one
  ``[slots]`` vector of token ids to the host.

Weights are cast to the compute dtype once at build (``GPT2LMModel.
cast_for_serving``), which gives the values flax's per-call cast gives.

Ported options: ``kv_layout="paged"``, ``sampling="device"``,
``spec_k=0``, ``prefill_chunk=0``, ``prefix_cache=False``, ``tp=1``,
float32 weights and KV. Every other value raises ``NotImplementedError``
naming its ROADMAP.md item. Telemetry records, spans, the flight recorder,
brownout, hot-swap and the runtime guards of the JAX engine are not
ported yet.
"""

from __future__ import annotations

import copy
import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from pytorch_distributed_training_tpu_torch.models.bert import PagedKV
from pytorch_distributed_training_tpu_torch.serve.paged_cache import (
    PageAllocator,
)
from pytorch_distributed_training_tpu_torch.serve.queue import (
    GenRequest,
    RequestQueue,
)
from pytorch_distributed_training_tpu_torch.serve.sampling import device_sample
from pytorch_distributed_training_tpu_torch.utils.device import resolve_device
from pytorch_distributed_training_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

# ROADMAP.md items for the options this slice does not port
_NOT_PORTED = {
    "kv_layout": ("paged", "the dense KV layout (queue 1, slice 4)"),
    "sampling": ("device", "host sampling (queue 1, slice 4)"),
    "spec_k": (0, "speculative decoding (queue 1, slice 4; queue 2 kernel 13)"),
    "prefill_chunk": (0, "chunked prefill (queue 1, slice 4; queue 2 kernel 13)"),
    "prefix_cache": (False, "the prefix cache (queue 1, slice 4)"),
    "tp": (1, "tensor-parallel serving (queue 1, slice 5)"),
    "weights_dtype": ("float32", "int8 weights (queue 1, slice 4)"),
    "kv_dtype": ("float32", "int8 KV pools (queue 1, slice 4)"),
}


@dataclasses.dataclass
class EngineConfig:
    """Decode-engine shape knobs.

    ``cache_len`` (largest bucket + ``max_new_tokens``) bounds every
    request. A request admitted at bucket ``b`` holds ``ceil((b +
    max_new_tokens) / page_size)`` pages for its whole life. ``num_pages=0``
    sizes the pool so every slot can hold a worst-case request (plus the
    null page); set it lower to trade concurrency for KV memory.
    """

    num_slots: int = 4
    prompt_buckets: tuple = (16, 32, 64)
    max_new_tokens: int = 64
    kv_layout: str = "paged"
    page_size: int = 16
    num_pages: int = 0          # total pages incl. null page; 0 = auto
    sampling: str = "device"
    spec_k: int = 0
    prefill_chunk: int = 0
    prefix_cache: bool = False
    tp: int = 1
    weights_dtype: str = "float32"
    kv_dtype: str = "float32"

    def __post_init__(self):
        for name, (ported, item) in _NOT_PORTED.items():
            if getattr(self, name) != ported:
                raise NotImplementedError(
                    f"{name}={getattr(self, name)!r} is not ported yet: "
                    f"{item} in ROADMAP.md"
                )
        if self.num_slots < 1:
            raise ValueError(f"num_slots must be >= 1, got {self.num_slots}")
        if self.max_new_tokens < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1, got {self.max_new_tokens}"
            )
        self.prompt_buckets = tuple(
            sorted(set(int(b) for b in self.prompt_buckets))
        )
        if not self.prompt_buckets or self.prompt_buckets[0] < 1:
            raise ValueError(
                f"prompt_buckets must be positive lengths, got "
                f"{self.prompt_buckets!r}"
            )
        if self.page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {self.page_size}")
        if self.num_pages > 0 and self.num_pages < self.pages_per_slot + 1:
            raise ValueError(
                f"num_pages {self.num_pages} cannot hold even one "
                f"worst-case request ({self.pages_per_slot} pages + the "
                f"reserved null page)"
            )

    @property
    def cache_len(self) -> int:
        return self.prompt_buckets[-1] + self.max_new_tokens

    @property
    def pages_per_slot(self) -> int:
        """Block-table row width: pages covering one worst-case request."""
        return -(-(self.cache_len + self.spec_k) // self.page_size)

    @property
    def total_pages(self) -> int:
        """Pool size including the reserved null page 0."""
        if self.num_pages > 0:
            return self.num_pages
        return self.num_slots * self.pages_per_slot + 1


@dataclasses.dataclass
class _Slot:
    """Engine-private per-slot state between ticks."""

    request: GenRequest
    pending_token: int          # sampled, not yet fed through decode
    steps_done: int = 0         # generated tokens already fed into the KV


class DecodeEngine:
    """Slotted continuous-batching decode over a causal LM.

    Single-threaded by contract: ``tick``/``cancel_all`` run on the serve
    loop thread (serve/server.py); construction may happen anywhere.
    ``model`` is a ``models.gpt2.GPT2LMModel``; the engine serves a copy
    of it on ``device`` with its weights cast once to the compute dtype.
    """

    def __init__(self, model, config: EngineConfig, queue: RequestQueue, *,
                 device="cuda"):
        cfg = model.config
        if not cfg.causal:
            raise ValueError("DecodeEngine needs a causal model")
        if config.cache_len > cfg.max_position_embeddings:
            raise ValueError(
                f"cache_len {config.cache_len} (= largest bucket "
                f"{config.prompt_buckets[-1]} + max_new_tokens "
                f"{config.max_new_tokens}) exceeds max_position_embeddings "
                f"{cfg.max_position_embeddings}"
            )
        self.config = config
        self.device = resolve_device(device)
        serving = copy.deepcopy(model).to(self.device)
        serving.cast_for_serving()
        serving.eval().requires_grad_(False)
        self._model = serving
        pool_dtype = getattr(torch, cfg.compute_dtype)
        shape = (config.total_pages, config.page_size, cfg.num_heads,
                 cfg.head_dim)
        self._pools = [
            (torch.zeros(shape, dtype=pool_dtype, device=self.device),
             torch.zeros(shape, dtype=pool_dtype, device=self.device))
            for _ in range(cfg.num_layers)
        ]
        self._pages = PageAllocator(
            config.total_pages, config.page_size, config.pages_per_slot,
            config.num_slots,
        )
        self._queue = queue
        self._slots: list[Optional[_Slot]] = [None] * config.num_slots
        self._prefill_buckets: set[int] = set()
        self.ticks = 0
        self.busy_ticks = 0
        self.admitted = 0
        self.finished = 0
        self.page_exhausted = 0     # ticks the FIFO head waited on pages
        self._page_blocked = False  # scratch flag for the admission pass
        self.prefill_tokens = 0
        self.decode_dispatches = 0
        self.decode_tokens = 0
        # host seconds in prefill / decode dispatches, each ending in the
        # token-id copy to the host (which waits for the device)
        self.prefill_s = 0.0
        self.decode_s = 0.0
        self.last_tick_t = time.monotonic()

    # ------------------------------------------------------------- programs

    def _to_device(self, array: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(array)).to(self.device)

    def _prefill(self, req: GenRequest, slot: int) -> int:
        """Prefill ``req`` into ``slot``'s pages; its first token."""
        bucket = req.bucket
        padded = np.zeros((1, bucket), np.int64)
        padded[0, : req.prompt_len] = req.prompt_ids
        # fresh sequence: context_len 0, K/V scattered straight into the
        # slot's pages through its block-table row
        paged = PagedKV(
            self._pools,
            self._to_device(self._pages.block_table[slot : slot + 1]),
            torch.zeros((1,), dtype=torch.int32, device=self.device),
        )
        logits = self._model(
            self._to_device(padded),
            position_ids=torch.arange(bucket, device=self.device)[None],
            paged=paged,
        )
        last = logits[0, req.prompt_len - 1][None]
        token = device_sample(last, [req.seed], [0], [req.temperature],
                              [req.top_k])
        self._prefill_buckets.add(bucket)
        return int(token[0])     # the prefill's one device-to-host copy

    def _decode(self, tokens, ctx, seeds, steps, temps, top_ks) -> np.ndarray:
        """Advance every slot one token; [slots] sampled ids on the host."""
        paged = PagedKV(
            self._pools,
            self._to_device(self._pages.block_table),
            self._to_device(ctx),
        )
        logits = self._model(
            self._to_device(tokens[:, None].astype(np.int64)),
            position_ids=self._to_device(ctx[:, None].astype(np.int64)),
            paged=paged,
        )
        sampled = device_sample(logits[:, 0], seeds, steps, temps, top_ks)
        return sampled.cpu().numpy()   # the tick's one device-to-host copy

    # ---------------------------------------------------------- accounting

    def _finish(self, req: GenRequest, status: str, reason: str) -> None:
        req.status = status
        req.finish_reason = reason
        req.finish_t = time.monotonic()
        self.finished += 1
        cb = req.on_finish
        if cb is not None:
            try:
                cb(req)
            except Exception:  # user callback: the loop must keep serving
                logger.exception("on_finish callback failed for %s", req.id)
        req.done.set()

    def _emit_token(self, req: GenRequest, token: int) -> None:
        if req.first_token_t is None:
            req.first_token_t = time.monotonic()
        req.tokens.append(int(token))
        cb = req.stream
        if cb is not None:
            try:
                cb(req, int(token))
            except Exception:  # user callback: the loop must keep serving
                logger.exception("stream callback failed for %s", req.id)

    def _is_terminal(self, req: GenRequest, token: int) -> bool:
        """Finish ``req`` if ``token`` completed it; True when finished."""
        if req.eot_id is not None and token == req.eot_id:
            self._finish(req, "done", "eot")
            return True
        if len(req.tokens) >= req.max_new_tokens:
            self._finish(req, "done", "length")
            return True
        return False

    # ----------------------------------------------------------------- slots

    def slot_occupancy(self) -> float:
        return sum(1 for s in self._slots if s is not None) / len(self._slots)

    def _free_slot(self) -> Optional[int]:
        for i, s in enumerate(self._slots):
            if s is None:
                return i
        return None

    def _evict(self, slot: int) -> None:
        """Free ``slot`` and its pages for reuse."""
        self._slots[slot] = None
        self._pages.release(slot)

    def _pages_for(self, req: GenRequest) -> int:
        """Up-front worst-case reservation: bucket + max_new_tokens."""
        return self._pages.pages_reserved(
            req.bucket + req.max_new_tokens, self.config.spec_k
        )

    def _admission_fits(self, req: GenRequest) -> bool:
        """Page-budget admission predicate (``RequestQueue.pop_ready``)."""
        if self._pages.can_alloc(self._pages_for(req)):
            return True
        self._page_blocked = True
        return False

    def _admit(self, req: GenRequest, slot: int) -> None:
        """Prefill ``req`` into ``slot`` and take its first token."""
        req.status = "running"
        req.admit_t = time.monotonic()
        self.admitted += 1
        self._pages.admit(slot, self._pages_for(req))
        t0 = time.perf_counter()
        try:
            token = self._prefill(req, slot)
        except BaseException:
            # failed admissions must not leak the pages just reserved
            self._pages.release(slot)
            raise
        self.prefill_s += time.perf_counter() - t0
        self.prefill_tokens += req.prompt_len
        self._emit_token(req, token)
        if self._is_terminal(req, token):
            self._pages.release(slot)
            return
        self._slots[slot] = _Slot(request=req, pending_token=token)

    # ------------------------------------------------------------------ tick

    def tick(self) -> bool:
        """One engine iteration: expire, admit, decode one token for every
        active slot. True when any work happened (the serve loop idles on
        the queue otherwise)."""
        with torch.inference_mode():
            return self._tick_body()

    def _tick_body(self) -> bool:
        worked = False
        for req in self._queue.expire_overdue():
            self._finish(req, "expired", "deadline")
            worked = True

        # running-slot deadlines: stop spending decode on an abandoned answer
        now = time.monotonic()
        for i, s in enumerate(self._slots):
            if s is not None and s.request.overdue(now):
                self._evict(i)
                self._finish(s.request, "expired", "deadline")
                worked = True

        # admissions: fill free slots in FIFO order; the head must also fit
        # the page budget (a blocked head blocks the queue, no bypass)
        self._page_blocked = False
        while True:
            slot = self._free_slot()
            if slot is None:
                break
            req = self._queue.pop_ready(accept=self._admission_fits)
            if req is None:
                break
            try:
                self._admit(req, slot)
            except Exception:
                # popped and not yet slotted: finish it so its waiter does
                # not hang, then let the loop's failure path take over
                self._finish(req, "error", "admit_failure")
                raise
            worked = True
        if self._page_blocked:
            self.page_exhausted += 1

        active = [i for i, s in enumerate(self._slots) if s is not None]
        if active:
            S = self.config.num_slots
            tokens = np.zeros((S,), np.int64)
            ctx = np.zeros((S,), np.int32)
            seeds = np.zeros((S,), np.int64)
            steps = np.zeros((S,), np.int64)
            temps = np.zeros((S,), np.float32)
            top_ks = np.zeros((S,), np.int64)
            for i in active:
                s = self._slots[i]
                r = s.request
                tokens[i] = s.pending_token
                ctx[i] = r.prompt_len + s.steps_done
                seeds[i] = r.seed
                steps[i] = s.steps_done + 1   # == len(r.tokens) at sample
                temps[i] = r.temperature
                top_ks[i] = r.top_k
            t0 = time.perf_counter()
            sampled = self._decode(tokens, ctx, seeds, steps, temps, top_ks)
            self.decode_s += time.perf_counter() - t0
            for i in active:
                s = self._slots[i]
                s.steps_done += 1
                token = int(sampled[i])
                self._emit_token(s.request, token)
                if self._is_terminal(s.request, token):
                    self._evict(i)          # slot + pages free for reuse
                else:
                    s.pending_token = token
            self.decode_dispatches += 1
            self.decode_tokens += len(active)
            worked = True

        self.ticks += 1
        if worked:
            self.busy_ticks += 1
        self.last_tick_t = time.monotonic()
        return worked

    # -------------------------------------------------------------- shutdown

    def has_work(self) -> bool:
        return any(s is not None for s in self._slots) or bool(
            self._queue.depth()
        )

    def cancel_all(self) -> None:
        """Terminate every in-flight and queued request; partial outputs
        stay on the request."""
        for i, s in enumerate(self._slots):
            if s is not None:
                self._evict(i)
                self._finish(s.request, "cancelled", "cancelled")
        for req in self._queue.drain_pending():
            self._finish(req, "cancelled", "cancelled")

    def _kv_bytes_per_token(self) -> int:
        """Pool bytes one token occupies across every layer (K and V)."""
        k_pages = self._pools[0][0]
        _, _, heads, head_dim = k_pages.shape
        return 2 * len(self._pools) * heads * head_dim * k_pages.element_size()

    def stats(self) -> dict:
        return {
            "device": str(self.device),
            "ticks": self.ticks,
            "busy_ticks": self.busy_ticks,
            "admitted": self.admitted,
            "finished": self.finished,
            "queue_depth": self._queue.depth(),
            "slot_occupancy": self.slot_occupancy(),
            "num_slots": self.config.num_slots,
            "prompt_buckets": list(self.config.prompt_buckets),
            "prefill_buckets_used": sorted(self._prefill_buckets),
            "kv_layout": self.config.kv_layout,
            "sampling": self.config.sampling,
            "kv_bytes_per_token": self._kv_bytes_per_token(),
            "kv_page_size": self.config.page_size,
            "kv_pages_total": self._pages.num_pages - 1,
            "kv_pages_used": self._pages.pages_used,
            "kv_pages_free": self._pages.pages_free,
            "kv_pages_peak": self._pages.peak_used,
            "page_exhausted": self.page_exhausted,
            "prefill_tokens": self.prefill_tokens,
            "prefill_s": self.prefill_s,
            "decode_dispatches": self.decode_dispatches,
            "decode_tokens": self.decode_tokens,
            "decode_s": self.decode_s,
            "tokens_per_dispatch": (
                self.decode_tokens / self.decode_dispatches
                if self.decode_dispatches else None
            ),
        }
