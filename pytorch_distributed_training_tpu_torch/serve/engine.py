"""Continuous-batching decode engine: paged or dense KV cache, device or
host sampling (counterpart: the JAX package's ``serve/engine.py``).

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
- **Speculative decoding** (``spec_k > 0``, ``spec_draft="ngram"``): the
  host drafts k tokens per slot from the slot's own history (prompt
  lookup, no dispatch), and ONE verify dispatch scores all k + 1
  positions through the 4-D-query paged kernel, then accepts the leading
  run of drafts that equal the per-position samples
  (``sampling.spec_accept``). Every emitted token is the sample the
  non-speculative engine would draw at that position, so streams are
  identical. Rejected drafts roll back by the host not advancing the
  slot's context past the accepted prefix: their K/V lanes stay dead in
  the over-reserved pages (``PageAllocator.pages_reserved``).
- **Chunked prefill** (``prefill_chunk > 0``): prompts stream into their
  pages ``prefill_chunk`` tokens per tick through the same 4-D-query path,
  between decode ticks; ``prefill_concurrency`` caps the slots streaming
  at once (a transient queue hold, not page exhaustion).
- **Prefix cache** (``prefix_cache``): finished prompts' full pages are
  indexed in a token trie (``serve/prefix_cache.py``); a later prompt with
  a matching prefix maps those pages into its row (refcounts bumped),
  copies a partly matching page on write, and prefills only the tail
  through the chunk path (chunks of ``prefill_chunk``, or a page when
  chunking is off).

Weights are cast to the compute dtype once at build (``GPT2LMModel.
cast_for_serving``), which gives the values flax's per-call cast gives.

- **int8 weights** (``weights_dtype="int8"``): the projections quantize
  once at build to int8 kernels with fp32 per-output-channel scales and
  dequantize per call (``models/bert.DenseGeneral``); ``stats()["variant"]``
  names the resident variant (``ops/quant.serve_params_variant``).
- **int8 KV** (``kv_dtype="int8"``): int8 pools beside fp32 scale pools
  [num_pages, page_size, heads]; K/V quantize on write and the paged
  kernels dequantize in place (their int8-pool entries). The allocator is
  dtype-blind: the same pages whatever the pool dtype.

- **Tensor parallelism** (``tp > 1``): one replica over the ``model``
  axis of ``tp`` processes, one a card (``comms/mesh.build_mesh(MeshConfig(
  model=tp))``, its ``shard("model")``); the JAX engine is one process
  driving ``tp`` devices under GSPMD. Each rank serves its Megatron slice
  (``parallel/sharding.serve_param_specs``: the heads of every attention,
  the columns of every MLP, the rest replicated), cut after the cast for
  serving, so int8 weights quantize whole first (a row-parallel
  projection's per-output-channel scale is a max over the input dim the
  cut splits), and pools at ``heads / tp`` (``serve_pool_shape``: the page
  axis whole, so the allocator and block tables are tp=1's). Rank 0, the
  leader, is this engine: it owns the queue, the allocator, the prefix
  cache, the sampler and every host decision, and broadcasts each device
  call (a forward, a page copy) to the model group before it runs the call
  itself (``_dispatch``, ``comms/collectives.broadcast_call``); the other
  ranks, the followers (``serve/tp_worker.py``), run each call on their
  slice and pools. The row-parallel all-reduces leave the same logits on
  every rank, so the leader alone samples. ``shutdown`` sends the stop
  message that ends the followers.

- **Draft-model lane** (``spec_k > 0``, ``spec_draft="model"``): a small
  model (its vocabulary the base's) resident beside the served one, with
  its own page pools at the same page geometry, so the allocator's block
  tables address both. Every prompt write (prefill, chunk, a prefix hit's
  tail) and COW page copy is mirrored into the draft pools; each verify
  tick first runs ``spec_k + 1`` greedy draft decodes on the device (the
  first re-feeds the last committed token, healing the one position a
  fully accepted tick never fed the draft), and the k proposals come to
  the host in one copy. Under int8 weights or KV the draft serves at the
  same variant; under ``tp`` it is cut into head slices as the base.
- **Dense KV layout** (``kv_layout="dense"``): one [num_slots, cache_len,
  heads, head_dim] K and V buffer a layer (``models/bert.DenseKV``, a
  view a slot at prefill, a per-slot write index at decode), admission by
  slot alone; the plain baseline of the paged layout.
- **Host sampling** (``sampling="host"``): the float32 logits come to the
  host and ``serve/sampling.host_sample`` picks each token in numpy, the
  same token ``device_sample`` picks (the JAX engine's pinned reference
  sampler).
- **Tenant page quotas** (``tenant_page_quota`` with ``prefix_cache``): a
  tenant whose private (unshared) pages would pass ``quota × (num_pages -
  1)`` is held at admission, without counting as page exhaustion; shared
  prefix pages are free. The queue's tier and tenant lanes
  (``serve/queue.py``) pick who is tried.

Every option of the JAX engine's ``EngineConfig`` above is ported, with
its cross-checks: speculation, chunked prefill, ``tp`` and the prefix cache
need the paged layout and device sampling, int8 KV the paged layout, a
quota the prefix cache.

- **Telemetry** (the default registry, or ``registry``): a
  ``serve_request`` record and a span tree (``telemetry/spans.py``:
  ``serve`` -> ``queue`` / ``prefill`` (``admission``) / ``decode``, with
  ``swap_overlap`` and ``brownout_clamp``) a finished request, the JAX
  engine's counters and gauges, the ``slo`` burn monitor fed at finish,
  and a flight-recorder entry (``telemetry/flight.py``) a busy or
  eventful tick, registered for the watchdog's dumps. The prefill,
  decode and tick sections run under ``faults/watchdog.watchdog_guard``,
  and ``faults/inject``'s serve faults fire after each busy tick.
- **Brownout** (``brownout``, ``serve/queue.BrownoutController``): each
  tick feeds it the queue's pressure; at level 1 and up the prefix cache
  drops its idle runs. The HTTP front end sheds and clamps at admission.
- **Warm-up** (``warmup``): each prefill bucket (or the chunk), the page
  copy, a decode or a verify (and the draft's) runs once on the null page
  at build, so kernel builds and first launches leave the first request;
  it leaves no trace (no page held, no cache entry, no generator drawn).
- **Hot-swap** (``request_swap``, applied between ticks): new weights,
  coerced to the resident variant (fp32 <-> int8, ``ops/quant.py``) and
  checked against the running model's names and shapes first, are copied
  into the live parameters in place (the kernels take raw pointers each
  launch); the first tick after a swap is its trial, and a failing trial
  copies the previous weights back. The prefix cache is flushed on every
  swap. Under ``tp`` each rank loads and cuts its own slice of the step
  and the swap installs on every rank or none.

- **Runtime guards** (``guards``, an ``analysis/guards.GuardSet``; one
  from ``PDT_TPU_GUARDS`` when None): every device call is the guarded
  entry point of its program (``serve_prefill_b<bucket>``, ``serve_chunk``,
  ``serve_decode``, ``serve_verify``, ``serve_copy`` and the draft's
  ``serve_draft_*``, as JAX's jitted programs), so a call after a
  program's warm-up at a new shape, or one that builds a kernel library,
  is a recompile; warm calls run under the implicit-transfer detector, and
  once every program is warm (and sampling is on the device) the whole
  tick runs under ``transfer_scope("serve_tick")``. The tick's intended
  copies — the operand uploads, the token readbacks, the sampler's noise,
  the control broadcasts — are explicit transfers, so only a new sync is
  a violation; in strict mode it fails the serve loop. With ``warmup``,
  the hot program's (the decode step's, or the verify's) warm-up call has
  its collectives recorded and audited against its manifest
  (``analysis/spmd``: no collective at ``tp=1``; under ``tp``, the
  row-parallel all-reduces only, at most two activation-sized ones a
  layer), on every rank, in ``_run``'s window (the leader's control
  broadcast is host control, outside it); ``stats()`` carries
  ``guard_mode``, ``guard_recompiles``, ``guard_implicit_transfers`` and
  the audit's record (``comm_audit``), and ``warmup_dispatches`` the
  warm-up's calls by program.
"""

from __future__ import annotations

import copy
import dataclasses
import threading
import time
from collections import deque
from typing import Optional

import numpy as np
import torch

from pytorch_distributed_training_tpu_torch.analysis import concurrency
from pytorch_distributed_training_tpu_torch.analysis.guards import (
    GuardSet,
    explicit_transfer,
    guard_mode_from_env,
)
from pytorch_distributed_training_tpu_torch.analysis.spmd import (
    comm_audit,
    record_collectives,
    serve_manifest,
    serve_tp_manifest,
    summarize_collectives,
)
from pytorch_distributed_training_tpu_torch.comms.collectives import (
    all_ranks_ok,
    broadcast_call,
)
from pytorch_distributed_training_tpu_torch.faults.inject import get_plan
from pytorch_distributed_training_tpu_torch.faults.watchdog import (
    watchdog_guard,
)
from pytorch_distributed_training_tpu_torch.models.bert import (
    DenseKV,
    PagedKV,
)
from pytorch_distributed_training_tpu_torch.models.gpt2 import unscanned
from pytorch_distributed_training_tpu_torch.ops.quant import (
    dequantize_serve_params,
    quantize_serve_params,
    serve_params_variant,
)
from pytorch_distributed_training_tpu_torch.parallel.sharding import (
    cut_model_slice,
    model_dims,
    serve_param_specs,
    serve_pool_shape,
    tensor_parallel,
)
from pytorch_distributed_training_tpu_torch.serve.paged_cache import (
    PageAllocator,
)
from pytorch_distributed_training_tpu_torch.serve.prefix_cache import (
    PrefixCache,
)
from pytorch_distributed_training_tpu_torch.serve.queue import (
    GenRequest,
    RequestQueue,
    emit_expiry,
)
from pytorch_distributed_training_tpu_torch.serve.sampling import (
    device_sample,
    host_sample,
    spec_accept,
)
from pytorch_distributed_training_tpu_torch.telemetry import (
    flight as flight_mod,
)
from pytorch_distributed_training_tpu_torch.telemetry.registry import (
    get_registry,
)
from pytorch_distributed_training_tpu_torch.telemetry.spans import Tracer
from pytorch_distributed_training_tpu_torch.utils.device import resolve_device
from pytorch_distributed_training_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

# the device calls a tensor-parallel leader broadcasts to its followers:
# the stop message that ends them, a forward (ids, positions, block-table
# rows, context lengths; flag bits: FLAG_MULTIQUERY, FLAG_DRAFT), a page
# copy (src, dst) of the base pools and any draft pools, the draft lane's
# chain of greedy decodes (last committed tokens, pending tokens, block
# table, context lengths, increments; the flag: spec_k), a weight swap
# (the checkpoint directory's bytes, the step) and a swap's end (the flag:
# 1 commit, 0 roll back); FLAG_AUDIT on any call: record and audit its
# collectives (the hot program's warm-up call)
(CALL_STOP, CALL_FORWARD, CALL_PAGE_COPY, CALL_DRAFT_CHAIN, CALL_SWAP,
 CALL_SWAP_END) = range(6)
FLAG_MULTIQUERY, FLAG_DRAFT = 1, 2
FLAG_AUDIT = 1 << 30


@dataclasses.dataclass
class EngineConfig:
    """Decode-engine shape knobs.

    ``cache_len`` (largest bucket + ``max_new_tokens``) bounds every
    request. A request admitted at bucket ``b`` holds ``ceil((b +
    max_new_tokens + spec_k) / page_size)`` pages for its whole life.
    ``num_pages=0`` sizes the pool so every slot can hold a worst-case
    request (plus the null page); set it lower to trade concurrency for KV
    memory.
    """

    num_slots: int = 4
    prompt_buckets: tuple = (16, 32, 64)
    max_new_tokens: int = 64
    # "paged" (block-table pages) or "dense" (one [slots, cache_len] buffer)
    kv_layout: str = "paged"
    page_size: int = 16
    num_pages: int = 0          # total pages incl. null page; 0 = auto
    # "device" ([slots] token ids to the host a tick) or "host" (float32
    # logits to the host, ``sampling.host_sample``)
    sampling: str = "device"
    # speculative decoding: draft tokens proposed per slot per tick (0 off)
    spec_k: int = 0
    # draft lane: "ngram" drafts from the slot's own history; "model" from
    # a draft model passed to the engine
    spec_draft: str = "ngram"
    # chunked prefill: prompt tokens streamed per tick per slot (0 off)
    prefill_chunk: int = 0
    # slots streaming a chunked prompt at once; further admissions wait
    prefill_concurrency: int = 1
    # shared-KV prefix cache over finished prompts' full pages
    prefix_cache: bool = False
    # a tenant's private-page ceiling, a fraction of the pool (0: none)
    tenant_page_quota: float = 0.0
    tp: int = 1
    weights_dtype: str = "float32"
    kv_dtype: str = "float32"
    # run every prefill shape, a decode and a verify once at build
    warmup: bool = False
    # flight-recorder ring size (busy or eventful ticks kept)
    flight_capacity: int = 256

    def __post_init__(self):
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
        if self.kv_layout not in ("dense", "paged"):
            raise ValueError(
                f"kv_layout must be dense/paged, got {self.kv_layout!r}")
        if self.sampling not in ("host", "device"):
            raise ValueError(
                f"sampling must be host/device, got {self.sampling!r}")
        if self.page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {self.page_size}")
        if self.spec_k < 0:
            raise ValueError(f"spec_k must be >= 0, got {self.spec_k}")
        if self.spec_draft not in ("ngram", "model"):
            raise ValueError(
                f"spec_draft must be ngram/model, got {self.spec_draft!r}")
        if self.prefill_chunk < 0:
            raise ValueError(
                f"prefill_chunk must be >= 0, got {self.prefill_chunk}"
            )
        if self.prefill_concurrency < 1:
            raise ValueError(
                f"prefill_concurrency must be >= 1, got "
                f"{self.prefill_concurrency}"
            )
        # JAX's cross-checks: the options that ride the 4-D-query paged
        # path and on-device sampling refuse the dense/host baselines
        for on, what in ((self.spec_k > 0 or self.prefill_chunk > 0,
                          "spec_k/prefill_chunk"),
                         (self.tp > 1, "tp > 1"),
                         (self.prefix_cache, "prefix_cache")):
            if on and self.kv_layout != "paged":
                raise ValueError(f"{what} requires kv_layout='paged'")
            if on and self.sampling != "device":
                raise ValueError(f"{what} requires sampling='device'")
        if self.tp < 1:
            raise ValueError(f"tp must be >= 1, got {self.tp}")
        if self.flight_capacity < 1:
            raise ValueError(
                f"flight_capacity must be >= 1, got {self.flight_capacity}")
        if self.weights_dtype not in ("float32", "int8"):
            raise ValueError(
                f"weights_dtype must be float32/int8, got "
                f"{self.weights_dtype!r}"
            )
        if self.kv_dtype not in ("float32", "int8"):
            raise ValueError(
                f"kv_dtype must be float32/int8, got {self.kv_dtype!r}"
            )
        if self.kv_dtype == "int8" and self.kv_layout != "paged":
            raise ValueError(
                "kv_dtype='int8' requires kv_layout='paged' (the dense "
                "cache has no scale-pool layout)")
        if not 0.0 <= self.tenant_page_quota <= 1.0:
            raise ValueError(
                f"tenant_page_quota must be in [0, 1], got "
                f"{self.tenant_page_quota}")
        if self.tenant_page_quota > 0.0 and not self.prefix_cache:
            raise ValueError(
                "tenant_page_quota requires prefix_cache=True (quota "
                "accounting rides the prefix-cache admission path)")
        if (self.kv_layout == "paged" and self.num_pages > 0
                and self.num_pages < self.pages_per_slot + 1):
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
        """Block-table row width: pages covering one worst-case request
        including the speculative overshoot."""
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
    # "prefill" while a prompt streams into the slot's pages (prefill_pos
    # tokens written so far), "decode" once its first token is sampled
    phase: str = "decode"
    prefill_pos: int = 0
    spec: bool = False          # in the speculative lane (fixed at admit)


@dataclasses.dataclass
class SwapTicket:
    """The outcome of one requested weight swap: ``done`` fires when the
    engine committed (``ok=True``) or rolled back (``ok=False``) the swap;
    the requesting thread waits on it, never on the serve loop."""

    version: Optional[int]
    done: threading.Event = dataclasses.field(
        default_factory=threading.Event)
    ok: Optional[bool] = None
    error: Optional[str] = None
    stage: Optional[str] = None

    def resolve(self, ok: bool, *, error: str = None,
                stage: str = None) -> None:
        self.ok = ok
        self.error = error
        self.stage = stage
        self.done.set()


class _PendingSwap:
    """The one weight swap waiting for the serve loop: ``put`` from any
    thread (``RuntimeError`` while one waits), ``take`` on the loop. The
    engine's only state shared across threads, behind its own lock."""

    def __init__(self):
        self._lock = concurrency.lock("serve.engine.swap")
        self._item = None

    def put(self, item) -> None:
        with self._lock:
            if self._item is not None:
                raise RuntimeError(
                    "a weight swap is already pending; one at a time")
            self._item = item

    def take(self):
        with self._lock:
            item, self._item = self._item, None
        return item

    @property
    def waiting(self) -> bool:
        return self._item is not None


def _check_tp_divisible(cfg, tp: int, role: str) -> None:
    """JAX ``_check_tp_divisible``: the model axis splits the attention
    heads and the MLP's hidden dim into equal slices, so both must
    divide."""
    for axis, size in (("num_heads", cfg.num_heads),
                       ("intermediate_size", cfg.intermediate_size)):
        if size % tp:
            raise ValueError(
                f"tp={tp} does not divide {role} model's {axis}={size} — "
                f"attention heads and the MLP hidden dim shard over the "
                f"model axis, so each shard needs an equal slice"
            )


def _served(model, config: EngineConfig, device, shard):
    """The copy of ``model`` a rank serves: laid out a block a module (a
    stacked trunk unstacked once, as the JAX engine does at build), on
    ``device``, cast for serving at ``config.weights_dtype`` (int8
    quantized whole, so a row-parallel kernel's scale is a max over the
    input dim the cut splits) and, under ``tp > 1``, cut to this rank's
    heads and MLP columns."""
    serving = unscanned(copy.deepcopy(model))
    serving = serving.to(device)
    serving.cast_for_serving(config.weights_dtype)
    if config.tp > 1:
        tensor_parallel(serving, serve_param_specs(
            {n: tuple(p.shape) for n, p in serving.named_parameters()},
            config.tp), shard)
    return serving.eval().requires_grad_(False)


class ServeSlice:
    """The device half of a serve replica on one rank: the served copy of
    the model (cast for serving and, under ``tp > 1``, cut to this rank's
    slice), its KV state (paged pools at ``heads / tp``, or the dense
    cache) and the draft model and pools of ``spec_draft="model"``, with
    the device calls that run on them (``_run``). The leader's
    ``DecodeEngine`` and each follower (``serve/tp_worker.py``) build one
    from the same ``EngineConfig``. ``shard``: the model axis's
    ``AxisShard`` (its size must be ``config.tp``); None at ``tp=1``.
    ``guards``: the ``GuardSet`` whose mode and registry its collective
    audit uses (one from ``PDT_TPU_GUARDS`` when None)."""

    def __init__(self, model, config: EngineConfig, *, device="cuda",
                 shard=None, draft_model=None,
                 guards: Optional[GuardSet] = None):
        cfg = model.config
        if not cfg.causal:
            raise ValueError("DecodeEngine needs a causal model")
        if config.cache_len + config.spec_k > cfg.max_position_embeddings:
            raise ValueError(
                f"cache_len {config.cache_len} (= largest bucket "
                f"{config.prompt_buckets[-1]} + max_new_tokens "
                f"{config.max_new_tokens}) + spec_k {config.spec_k} exceeds "
                f"max_position_embeddings {cfg.max_position_embeddings}"
            )
        tp = config.tp
        if tp > 1:
            _check_tp_divisible(cfg, tp, "model")
            size = 1 if shard is None else shard.size
            if size != tp:
                raise ValueError(
                    f"tp={tp} needs a model group of {tp} ranks, got {size}")
        draft = config.spec_k > 0 and config.spec_draft == "model"
        if draft:
            if draft_model is None:
                raise ValueError(
                    "spec_draft='model' needs a draft_model (pass "
                    "spec_draft='ngram' for checkpoint-free self-drafting)")
            dmc = draft_model.config
            if dmc.vocab_size != cfg.vocab_size:
                raise ValueError(
                    f"draft vocab {dmc.vocab_size} != base vocab "
                    f"{cfg.vocab_size}: draft tokens must be base tokens")
            if config.cache_len + config.spec_k > dmc.max_position_embeddings:
                raise ValueError(
                    f"draft max_position_embeddings "
                    f"{dmc.max_position_embeddings} cannot cover cache_len "
                    f"{config.cache_len} + spec_k {config.spec_k}")
            if tp > 1:
                _check_tp_divisible(dmc, tp, "draft")
        self.config = config
        self.device = resolve_device(device)
        self._guards = guards if guards is not None else GuardSet(
            mode=guard_mode_from_env())
        self.comm_record = None     # the hot program's audit record
        self._shard = shard if tp > 1 else None
        self._model = _served(model, config, self.device, self._shard)
        self.variant = serve_params_variant(self._model.state_dict())
        self.weight_bytes = sum(p.numel() * p.element_size()
                                for p in self._model.parameters())
        self._max_pos = cfg.max_position_embeddings
        self._pools = self._scales = self._dense = None
        if config.kv_layout == "paged":
            self._pools, self._scales = self._make_pools(cfg)
        else:
            # one [slots, cache_len] buffer a layer, K and V
            self._dense = DenseKV.zeros(cfg, config.num_slots,
                                        config.cache_len, self.device)
        self._swap_backup = None    # a follower's weights before a swap
        self._draft = self._draft_pools = self._draft_scales = None
        if draft:
            self._draft = _served(draft_model, config, self.device,
                                  self._shard)
            self._draft_pools, self._draft_scales = self._make_pools(
                draft_model.config)

    def _make_pools(self, cfg) -> tuple:
        """``cfg``'s page pools, a ``(k_pages, v_pages)`` pair a layer at
        ``heads / tp``, in the compute dtype or int8, and for int8 pools
        the fp32 scale pools beside them (else None)."""
        config = self.config
        quant_kv = config.kv_dtype == "int8"
        dtype = torch.int8 if quant_kv else getattr(torch, cfg.compute_dtype)
        shape = serve_pool_shape((config.total_pages, config.page_size,
                                  cfg.num_heads, cfg.head_dim), config.tp)

        def zeros(shape, dtype):
            return torch.zeros(shape, dtype=dtype, device=self.device)

        pools = [(zeros(shape, dtype), zeros(shape, dtype))
                 for _ in range(cfg.num_layers)]
        # int8 pools: one fp32 scale per (page, offset, head) beside them
        scales = [(zeros(shape[:3], torch.float32),
                   zeros(shape[:3], torch.float32))
                  for _ in range(cfg.num_layers)] if quant_kv else None
        return pools, scales

    def _to_device(self, array: np.ndarray) -> torch.Tensor:
        with explicit_transfer():   # an operand's upload, by design
            return torch.from_numpy(np.ascontiguousarray(array)).to(
                self.device)

    def _hot_manifest(self):
        """The expected-collective manifest of the hot program (JAX
        ``_serve_manifest``): the verify under speculation, else the
        decode step. One device: no collective at all. Under ``tp``: the
        row-parallel all-reduces only, required, their payload bounded by
        two activation-sized reductions a layer in the compute dtype (the
        bytes on the wire) and clamped below one extra attention-out
        weight at its resident width, so a silently replicated weight (no
        collective) and a gathered one (a wrong kind, the ceiling blown)
        both fail."""
        cfg = self.config
        name = "serve_verify" if cfg.spec_k > 0 else "serve_decode"
        if cfg.tp <= 1:
            return serve_manifest(1, name=name)
        mcfg = self._model.config
        dtype_bytes = getattr(torch, mcfg.compute_dtype).itemsize
        wbytes = 1 if cfg.weights_dtype == "int8" else dtype_bytes
        return serve_tp_manifest(
            cfg.tp, layers=mcfg.num_layers, hidden=mcfg.hidden_size,
            max_q_tokens=cfg.num_slots * (1 + cfg.spec_k),
            dtype_bytes=dtype_bytes, name=name,
            weight_bytes_floor=mcfg.hidden_size * mcfg.hidden_size * wbytes)

    def _audit(self, fn):
        """``fn()`` with the collectives it issues recorded and audited
        against ``_hot_manifest`` (a ``comm_audit`` record, kept as
        ``self.comm_record``; strict mode raises on a deviation)."""
        manifest = self._hot_manifest()
        with record_collectives() as seen:
            out = fn()
        self.comm_record = comm_audit(
            manifest.name, summarize_collectives(seen), manifest,
            registry=self._guards.registry, mode=self._guards.mode)
        return out

    def _audited_run(self, kind: int, operands: list, flag: int = 0):
        """``_run``, audited (``_audit``) when ``flag`` has
        ``FLAG_AUDIT``."""
        if not flag & FLAG_AUDIT:
            return self._run(kind, operands, flag)
        return self._audit(
            lambda: self._run(kind, operands, flag & ~FLAG_AUDIT))

    def _paged(self, block_table, context_len, multiquery=False,
               draft=False) -> PagedKV:
        """The paged operands of a forward of the served model (``draft``:
        the draft's) over its pools."""
        pools, scales = ((self._draft_pools, self._draft_scales) if draft
                         else (self._pools, self._scales))
        return PagedKV(pools, block_table, context_len,
                       multiquery=multiquery, scales=scales)

    def _run(self, kind: int, operands: list, flag: int = 0):
        """Run one device call on this rank's slice and pools: a forward
        of the served model or (``FLAG_DRAFT``) the draft (``operands``:
        ids, positions, block-table rows, context lengths;
        ``FLAG_MULTIQUERY``: a chunk over an existing context), its
        logits; a page copy (``operands``: ``[[src, dst]]``) of every
        layer's pools, base and draft, and for int8 pools their scale
        pools; or the draft lane's chain (``_draft_chain``)."""
        if kind == CALL_FORWARD:
            ids, pos, bt, ctx = (self._to_device(a) for a in operands)
            draft = bool(flag & FLAG_DRAFT)
            model = self._draft if draft else self._model
            return model(ids, position_ids=pos, paged=self._paged(
                bt, ctx, bool(flag & FLAG_MULTIQUERY), draft))
        if kind == CALL_PAGE_COPY:
            src, dst = (int(v) for v in operands[0])
            for pools in (self._pools, self._scales, self._draft_pools,
                          self._draft_scales):
                for pair in pools or ():
                    for leaf in pair:
                        leaf[dst].copy_(leaf[src])
            return None
        if kind == CALL_DRAFT_CHAIN:
            return self._draft_chain(*operands, k=flag)
        if kind == CALL_SWAP:
            return self._follow_swap(
                operands[0].astype(np.uint8).tobytes().decode(),
                int(operands[1][0]))
        if kind == CALL_SWAP_END:
            return self._end_swap(bool(flag))
        raise ValueError(f"unknown device call {kind}")

    def _draft_chain(self, last, pending, bt, ctx, inc, *, k: int):
        """``k + 1`` greedy single-token decodes of the draft over its
        pools (JAX ``_model_drafts``): the first re-writes the last
        committed token at ``ctx`` (whose output is dropped), the second
        feeds the pending token, then each proposal feeds the next, on the
        device; ``inc`` is 1 for the slots in the lane (0 parks a row on
        the null page). [slots, k] proposals on the device."""
        bt, inc = self._to_device(bt), self._to_device(inc)
        ctx, feed = self._to_device(ctx), self._to_device(last)
        pending = self._to_device(pending)
        outs = []
        for j in range(k + 1):
            logits = self._draft(feed[:, None], position_ids=ctx[:, None],
                                 paged=self._paged(bt, ctx, draft=True))
            out = torch.argmax(logits[:, 0], dim=-1)
            outs.append(out)
            feed = pending if j == 0 else out
            ctx = ctx + inc
        return torch.stack(outs[1:], dim=1)

    def _kv_bytes_per_token(self) -> Optional[int]:
        """Pool bytes one token occupies on this rank across every layer
        (K and V): ``head_dim`` values a head at the pool dtype, plus one
        fp32 scale a head for int8 pools (None under the dense layout)."""
        if self._pools is None:
            return None
        k_pages = self._pools[0][0]
        _, _, heads, head_dim = k_pages.shape
        per_head = head_dim * k_pages.element_size()
        if self._scales is not None:
            per_head += 4
        return 2 * len(self._pools) * heads * per_head

    def _kv_heads(self) -> int:
        kv = self._dense.keys if self._pools is None else self._pools[0]
        return kv[0].shape[2]

    # ------------------------------------------------------------ hot swap

    @property
    def params(self) -> dict:
        """The served weights (``state_dict`` views of the live tensors;
        a swap loader reads their names and layout)."""
        return self._model.state_dict()

    def _coerce_swap(self, params: dict) -> tuple[dict, str]:
        """A whole serving ``state_dict`` (float32 or int8, the served
        model's names) as this rank's resident weights: converted to the
        resident variant (JAX ``_coerce_variant``: an fp32 publish into an
        int8 engine is quantized, an int8 one into an fp32 engine
        dequantized), cut to this rank's slice under ``tp``, each on the
        host at its live tensor's dtype; with the incoming variant. Raises
        ``ValueError`` on names or shapes the running model lacks (JAX
        ``_validate_swap``), before anything changes."""
        incoming = serve_params_variant(params)
        if incoming != self.variant:
            params = (quantize_serve_params(params) if self.variant == "int8"
                      else dequantize_serve_params(params))
        if self._shard is not None:
            dims = model_dims(serve_param_specs(
                {n: tuple(t.shape) for n, t in params.items()},
                self.config.tp))
            params = {n: cut_model_slice(t, dims[n], self._shard)
                      if n in dims else t for n, t in params.items()}
        live = self._model.state_dict()
        if set(params) != set(live):
            odd = sorted(set(params) ^ set(live))
            raise ValueError(
                f"swap rejected: the weights' names do not match the "
                f"running model's ({odd[:4]})")
        out = {}
        for name, cur in live.items():
            new = params[name]
            if tuple(new.shape) != tuple(cur.shape):
                raise ValueError(
                    f"swap rejected: {name} is {tuple(new.shape)}, the "
                    f"running model has {tuple(cur.shape)} (shape mismatch: "
                    f"a checkpoint of an incompatible model config)")
            out[name] = new.detach().to("cpu", cur.dtype)
        return out, incoming

    def _install_swap(self, coerced: dict) -> dict:
        """Install ``coerced``; the replaced weights, cloned on the
        device, for a rollback (``_restore_swap``)."""
        backup = {n: t.clone() for n, t in self.params.items()}
        self._restore_swap(coerced)
        return backup

    @torch.no_grad()
    def _restore_swap(self, weights: dict) -> None:
        """Copy ``weights`` into the live tensors in place (never rebound:
        kernels take raw pointers, TP and the draft lane hold views) and
        refresh the float32 tied head."""
        for n, t in self.params.items():
            t.copy_(weights[n])
        self._model.head_weight.copy_(self._model.wte.embedding.float())

    def _follow_swap(self, directory: str, step: int) -> None:
        """A follower's half of a swap: load the step's weights, cut its
        slice, vote, and install when every rank could."""
        from pytorch_distributed_training_tpu_torch.serve.hotswap import (
            load_swap_params,
        )

        coerced = None
        try:
            coerced, _ = self._coerce_swap(
                load_swap_params(directory, step, current_params=self.params))
        except Exception as e:  # the vote carries it to every rank
            logger.warning("swap of step %d failed on this rank: %s: %s",
                           step, type(e).__name__, e)
        if all_ranks_ok(self._shard, coerced is not None):
            self._swap_backup = self._install_swap(coerced)

    def _end_swap(self, commit: bool) -> None:
        """A follower's end of a swap's trial: keep the new weights, or
        copy the previous ones back."""
        backup, self._swap_backup = self._swap_backup, None
        if not commit and backup is not None:
            self._restore_swap(backup)


class DecodeEngine(ServeSlice):
    """Slotted continuous-batching decode over a causal LM.

    Single-threaded by contract: ``tick``/``cancel_all``/``shutdown`` run
    on the serve loop thread (serve/server.py), or after it has stopped;
    construction may happen anywhere. ``model`` is a
    ``models.gpt2.GPT2LMModel``; the engine serves a copy of it on
    ``device`` with its weights cast once to the compute dtype (under
    ``tp > 1``: this rank's slice of it, and the engine is the leader of
    the model group of ``shard``). ``weights_step``: the checkpoint step
    the weights came from (None for HF or random ones), reported as
    ``stats()["weights_step"]``. ``draft_model``: the draft lane's model
    (``spec_draft="model"``), served as ``model`` is. ``registry`` (the
    default registry when None) takes the records; ``brownout``
    (``serve/queue.BrownoutController``), ``slo``
    (``telemetry/slo.BurnRateMonitor``), ``tracer`` and ``flight`` are
    optional (a tracer and a recorder are made when None);
    ``replica_name`` stamps spans and flight records; ``guards`` (an
    ``analysis/guards.GuardSet``, one from ``PDT_TPU_GUARDS`` when None)
    wraps every device call (see the module docstring).
    """

    def __init__(self, model, config: EngineConfig, queue: RequestQueue, *,
                 device="cuda", shard=None,
                 weights_step: Optional[int] = None, draft_model=None,
                 registry=None, brownout=None, tracer=None, flight=None,
                 slo=None, replica_name: Optional[str] = None,
                 guards: Optional[GuardSet] = None):
        registry = registry if registry is not None else get_registry()
        guards = guards if guards is not None else GuardSet(
            mode=guard_mode_from_env(), registry=registry)
        super().__init__(model, config, device=device, shard=shard,
                         draft_model=draft_model, guards=guards)
        self.weights_step = weights_step
        self._registry = registry
        # the guarded entry point of each program, and the programs the
        # tick's transfer scope waits for (warm all, JAX _scope_ready)
        self._programs: dict = {}
        self._scope_programs = self._required_programs()
        self._scope_warm = False
        self.warmup_dispatches: dict = {}
        # live weight swaps: the version served, one pending replacement
        # (coerced and checked) and the trial window's weights before it
        self.swaps = 0              # committed swaps
        self.swap_rollbacks = 0     # trial-tick failures rolled back
        # (params, version, ticket, variant, source), put from any thread
        self._pending_swap = _PendingSwap()
        self._trial = None          # (backup, prev_version, ticket)
        self._last_swap_variant = None
        self._stopped = False
        paged = config.kv_layout == "paged"
        self._pages = PageAllocator(
            config.total_pages, config.page_size, config.pages_per_slot,
            config.num_slots,
        ) if paged else None
        self._prefix = (PrefixCache(self._pages) if config.prefix_cache
                        else None)
        self.tenant_blocked = 0     # admissions held by a tenant's quota
        self._tenant_pages: dict[str, int] = {}   # tenant -> private pages
        self._slot_charge: dict[int, tuple] = {}  # slot -> (tenant, pages)
        # chunk width: prefill_chunk, or one page for prefix-hit tails when
        # only the cache is on
        self._chunk_size = (config.prefill_chunk if config.prefill_chunk > 0
                            else config.page_size)
        self._queue = queue
        self._slots: list[Optional[_Slot]] = [None] * config.num_slots
        self._prefill_buckets: set[int] = set()
        self._match_scratch = None      # (req id, PrefixMatch) from accept
        self.ticks = 0
        self.busy_ticks = 0
        self.admitted = 0
        self.finished = 0
        self.page_exhausted = 0     # ticks the FIFO head waited on pages
        self._page_blocked = False  # scratch flag for the admission pass
        self.prefill_tokens = 0     # real prompt tokens through a prefill
        self.prefill_dispatches = 0  # monolithic bucket prefills
        self.prefill_chunks = 0     # chunk dispatches
        self.decode_dispatches = 0  # decode-phase dispatches of any kind
        self.decode_tokens = 0      # tokens emitted by decode-phase work
        self.spec_dispatches = 0    # verify dispatches
        self.spec_drafted = 0
        self.spec_accepted = 0
        self.cow_copies = 0
        self.cached_tokens = 0      # prompt tokens served from the cache
        # host seconds in prefill (bucket and chunk) and decode (plain and
        # verify) dispatches; those ending in the token-id copy to the host
        # wait for the device, a non-final chunk only enqueues
        self.prefill_s = 0.0
        self.decode_s = 0.0
        # the overload ladder the tick feeds (None: never degrade)
        self.brownout = brownout
        # finished requests a second, an EWMA over ~1 s windows: the live
        # half of the Retry-After estimate (engine thread writes, HTTP
        # threads read one float)
        self.drain_rate = 0.0
        self._drain_window_t = time.monotonic()
        self._drain_window_finished = 0
        # the heartbeat: stamped at the end of every tick, idle ones too
        self.last_tick_t = time.monotonic()
        self.replica_name = replica_name
        self.tracer = tracer if tracer is not None else Tracer(
            registry=self._registry, component=replica_name or "engine")
        self.flight = flight if flight is not None else (
            flight_mod.FlightRecorder(
                config.flight_capacity, component=replica_name or "engine",
                registry=self._registry))
        flight_mod.register(self.flight)
        self.slo = slo
        # applied swap windows: requests whose life crosses one get a
        # swap_overlap span
        self._swap_windows: deque = deque(maxlen=32)
        # this tick's events for its flight entry (swaps, brownout moves)
        self._tick_events: list = []
        self._prev_brownout_level = 0
        if config.warmup:
            self._warmup()

    # ------------------------------------------------------------- programs

    def _required_programs(self) -> tuple:
        """The programs a tick may call, all warm before the tick runs
        under the transfer scope (JAX ``_scope_ready``): the decode step or
        the verify (and the draft's chain), the chunk (chunked prefill or
        a prefix hit's tail), every bucket's prefill (monolithic prefill)
        and the page copy (prefix cache)."""
        cfg, draft = self.config, self._draft is not None
        names = ["serve_verify" if cfg.spec_k > 0 else "serve_decode"]
        if cfg.spec_k > 0 and draft:
            names.append("serve_draft_chain")
        if cfg.prefill_chunk > 0 or cfg.prefix_cache:
            names += ["serve_chunk"] + (["serve_draft_chunk"] if draft
                                        else [])
        if cfg.prefill_chunk == 0:
            for b in cfg.prompt_buckets:
                names += [f"serve_prefill_b{b}"] + (
                    [f"serve_draft_prefill_b{b}"] if draft else [])
        if cfg.prefix_cache:
            names.append("serve_copy")
        return tuple(names)

    def _scope_ready(self) -> bool:
        """True when the whole tick can run under the transfer scope:
        device sampling (host sampling copies logits to the host by
        design) and every program it may call warm."""
        if not self._scope_warm and self.config.sampling == "device":
            self._scope_warm = all(
                name in self._programs and self._programs[name].warm
                for name in self._scope_programs)
        return self._scope_warm

    def _guarded(self, program: str, fn, *args):
        """``fn(*args)`` as the guarded entry point ``program``."""
        call = self._programs.get(program)
        if call is None:
            call = self._programs[program] = self._guards.wrap(program, fn)
        return call(*args)

    def _dispatch(self, kind: int, operands: list, flag: int = 0, *,
                  program: str):
        """Every device call of the paged engine, as the guarded entry
        point ``program``: under ``tp > 1`` broadcast to the model group's
        followers first, then run on this rank's slice."""
        return self._guarded(program, self._call, kind, operands, flag)

    def _call(self, kind: int, operands: list, flag: int = 0):
        flag |= self._audit_flag
        if self._shard is not None:
            if self._stopped:
                raise RuntimeError("the model group was stopped")
            broadcast_call(self._shard, kind, operands, flag)
        return self._audited_run(kind, operands, flag)

    _audit_flag = 0     # FLAG_AUDIT while the hot program is audited

    def _forward(self, ids, pos, bt, ctx, multiquery=False,
                 draft=False, *, program: str) -> torch.Tensor:
        """The served model's (``draft``: the draft's) forward over the
        slots' pages (numpy operands: int64 ids and positions, int32
        block-table rows and context lengths), as ``program`` (the
        draft's is ``serve_draft_<program>``); float32 logits on the
        device."""
        flag = (FLAG_MULTIQUERY if multiquery else 0) | (
            FLAG_DRAFT if draft else 0)
        if draft:
            program = program.replace("serve_", "serve_draft_", 1)
        return self._dispatch(CALL_FORWARD, [ids, pos, bt, ctx], flag,
                              program=program)

    def _dense_forward(self, ids, pos, slot: Optional[int] = None):
        """A forward over the dense cache, as the guarded entry point of
        its program: ``slot``'s prefill (its cache rows from position 0,
        ``serve_prefill_b<bucket>``) or, ``slot`` None, every slot's
        decode step (``serve_decode``), each writing at its own index, its
        position (idle slots write position 0 of their unused rows, which
        the next prefill overwrites)."""
        program = ("serve_decode" if slot is None
                   else f"serve_prefill_b{ids.shape[1]}")
        # the slot goes in as an array: its value is data, not a shape
        return self._guarded(program, self._dense_run, ids, pos,
                             None if slot is None else np.asarray(slot))

    def _dense_run(self, ids, pos, slot):
        dense = self._dense
        if slot is not None:
            slot = int(slot)
            cache = DenseKV([k[slot:slot + 1] for k in dense.keys],
                            [v[slot:slot + 1] for v in dense.values])
        else:
            # the indices' bound from the host copy: no readback
            cache = DenseKV(dense.keys, dense.values,
                            index=self._to_device(pos[:, 0]),
                            index_max=int(pos[:, 0].max()))

        def run():
            return self._model(self._to_device(ids),
                               position_ids=self._to_device(pos),
                               cache=cache)

        return self._audit(run) if self._audit_flag else run()

    def _sample_one(self, req: GenRequest, logits: torch.Tensor) -> int:
        """The first token from a prefill's last-position [vocab] logits:
        on the device, or on the host (``sampling="host"``); either way
        the prefill's one device-to-host copy."""
        if self.config.sampling == "host":
            with explicit_transfer():
                host = logits.float().cpu().numpy()
            return host_sample(host, req.seed, 0, req.temperature,
                               req.top_k)
        token = device_sample(logits[None], [req.seed], [0],
                              [req.temperature], [req.top_k])
        with explicit_transfer():
            return int(token[0])

    def _prefill(self, req: GenRequest, slot: int) -> int:
        """Prefill ``req`` into ``slot``'s pages (and the draft's) or its
        dense cache rows; its first token."""
        bucket = req.bucket
        padded = np.zeros((1, bucket), np.int64)
        padded[0, : req.prompt_len] = req.prompt_ids
        pos = np.arange(bucket, dtype=np.int64)[None]
        if self._pages is None:
            # right-padded prompt, no mask: the pads follow every real
            # token, so the causal mask hides them, and decode writes over
            # them from prompt_len on
            logits = self._dense_forward(padded, pos, slot)
        else:
            # fresh sequence: context_len 0, K/V scattered straight into
            # the slot's pages through its block-table row
            operands = (padded, pos, self._pages.block_table[slot:slot + 1],
                        np.zeros((1,), np.int32))
            program = f"serve_prefill_b{bucket}"
            logits = self._forward(*operands, program=program)
            if self._draft is not None:
                # the draft lane shares the slot's committed context
                self._forward(*operands, draft=True, program=program)
        self._prefill_buckets.add(bucket)
        self.prefill_dispatches += 1
        return self._sample_one(req, logits[0, req.prompt_len - 1])

    def _chunk(self, req: GenRequest, slot: int, start: int,
               sample_row: Optional[int]) -> Optional[int]:
        """Write prompt tokens ``start .. start + chunk`` of ``req`` into
        ``slot``'s pages (the last chunk zero-padded: pad lanes are dead
        by the causal horizon now and by the context length later). With
        ``sample_row`` (the chunk row of the prompt's last token) the first
        token is sampled and returned; else nothing syncs."""
        C = self._chunk_size
        end = min(start + C, req.prompt_len)
        ids = np.zeros((1, C), np.int64)
        ids[0, : end - start] = req.prompt_ids[start:end]
        # pad lanes past the position table read its last row (dead lanes)
        pos = np.minimum(start + np.arange(C), self._max_pos - 1)
        operands = (ids, pos[None].astype(np.int64),
                    self._pages.block_table[slot:slot + 1],
                    np.asarray([start], np.int32))
        logits = self._forward(*operands, multiquery=True,
                               program="serve_chunk")
        if self._draft is not None:
            self._forward(*operands, multiquery=True, draft=True,
                          program="serve_chunk")
        if sample_row is None:
            return None
        token = device_sample(logits[0, sample_row][None], [req.seed], [0],
                              [req.temperature], [req.top_k])
        with explicit_transfer():
            return int(token[0])

    def _decode(self, tokens, bt, ctx, seeds, steps, temps,
                top_ks) -> np.ndarray:
        """Advance every slot one token; [slots] sampled ids on the host.
        The tick's one device-to-host copy is those ids, or under host
        sampling the [slots, vocab] float32 logits."""
        ids = tokens[:, None].astype(np.int64)
        pos = ctx[:, None].astype(np.int64)
        if self._pages is None:
            logits = self._dense_forward(ids, pos)[:, 0]
        else:
            logits = self._forward(ids, pos, bt, ctx,
                                   program="serve_decode")[:, 0]
        if self.config.sampling == "host":
            with explicit_transfer():
                host = logits.float().cpu().numpy()
            return np.asarray([host_sample(host[i], seeds[i], steps[i],
                                           temps[i], top_ks[i])
                               for i in range(len(host))], np.int64)
        sampled = device_sample(logits, seeds, steps, temps, top_ks)
        with explicit_transfer():
            return sampled.cpu().numpy()

    def _verify(self, tokens, bt, ctx, seeds, steps0, temps,
                top_ks) -> np.ndarray:
        """Score all k + 1 positions of every slot (row = [pending, d1..dk]
        written at ctx..ctx+k) and accept on the device; returns [slots,
        k + 2] on the host: the k + 1 per-position samples, then the
        accepted-draft count."""
        q_len = tokens.shape[1]
        tokens = tokens.astype(np.int64)
        logits = self._forward(
            tokens, (ctx[:, None] + np.arange(q_len)).astype(np.int64), bt,
            ctx, multiquery=True, program="serve_verify",
        )
        target, accept = spec_accept(logits, self._to_device(tokens[:, 1:]),
                                     seeds, steps0, temps, top_ks)
        # the tick's one device-to-host copy
        out = torch.cat([target, accept[:, None]], dim=1)
        with explicit_transfer():
            return out.cpu().numpy()

    def _page_copy(self, src: int, dst: int) -> None:
        """Copy page ``src`` onto page ``dst`` in every layer's pools, the
        draft's too, and for int8 pools their scale pools (the
        copy-on-write of a partly matched prefix page)."""
        self._dispatch(CALL_PAGE_COPY, [np.asarray([src, dst], np.int64)],
                       program="serve_copy")

    # -------------------------------------------------------------- warm-up

    @torch.inference_mode()
    def _warmup(self) -> None:
        """Run every serving shape once before the first request (JAX
        ``_warmup``): each prefill bucket (or, chunked, the chunk), the
        chunk of a prefix hit's tail and the page copy, then a decode step
        or a verify (and the draft lane's chain), greedy, so kernel builds
        and first launches leave the first request's TTFT. Paged calls run
        on the null page (all-zero block tables, context 0); the dense
        prefill writes slot 0's rows, which a real prefill overwrites, and
        the dense decode writes position 0 of every row. No page is held,
        the prefix cache stays empty and no generator is drawn: a warmed
        engine's streams equal a cold one's. The hot program's (the decode
        step's, or the verify's) call is audited (``_hot_manifest``) on
        every rank, as JAX audits a warmed program after its first
        compile."""
        cfg = self.config
        S, W = cfg.num_slots, cfg.pages_per_slot
        paged = self._pages is not None
        draft = self._draft is not None

        def ids(*shape):
            return np.zeros(shape, np.int64)

        def table(rows):
            return np.zeros((rows, W), np.int32)

        logits = []
        if paged and (cfg.prefill_chunk > 0 or cfg.prefix_cache):
            C = self._chunk_size
            pos = np.arange(C, dtype=np.int64)[None]
            ops = (ids(1, C), pos, table(1), np.zeros((1,), np.int32))
            logits.append(self._forward(*ops, multiquery=True,
                                        program="serve_chunk")[0, -1:])
            if draft:
                self._forward(*ops, multiquery=True, draft=True,
                              program="serve_chunk")
        if not (paged and cfg.prefill_chunk > 0):
            for bucket in cfg.prompt_buckets:
                pos = np.arange(bucket, dtype=np.int64)[None]
                if paged:
                    ops = (ids(1, bucket), pos, table(1),
                           np.zeros((1,), np.int32))
                    program = f"serve_prefill_b{bucket}"
                    logits.append(self._forward(*ops,
                                                program=program)[0, -1:])
                    if draft:
                        self._forward(*ops, draft=True, program=program)
                else:
                    logits.append(self._dense_forward(
                        ids(1, bucket), pos, 0)[0, -1:])
        if paged and cfg.prefix_cache:
            self._page_copy(0, 0)
        zeros = np.zeros((S,), np.int64)
        ctx = np.zeros((S,), np.int32)
        if self._guards.mode != "off":
            self._audit_flag = FLAG_AUDIT
        if paged and cfg.spec_k > 0:
            k = cfg.spec_k
            pos = np.tile(np.arange(k + 1, dtype=np.int64), (S, 1))
            out = self._forward(ids(S, k + 1), pos, table(S), ctx,
                                multiquery=True, program="serve_verify")
            self._audit_flag = 0
            spec_accept(out, self._to_device(ids(S, k)), zeros, zeros,
                        np.zeros((S,), np.float32), zeros)
            if draft:
                self._dispatch(CALL_DRAFT_CHAIN,
                               [zeros, zeros, table(S), ctx, ctx], k,
                               program="serve_draft_chain")
        elif paged:
            logits.append(self._forward(ids(S, 1), ids(S, 1), table(S),
                                        ctx, program="serve_decode")[:, 0])
        else:
            logits.append(self._dense_forward(ids(S, 1), ids(S, 1))[:, 0])
        self._audit_flag = 0
        for row in logits:
            if cfg.sampling == "device":
                device_sample(row[:1], [0], [0], [0.0], [0])
        self.warmup_dispatches = {name: call.calls
                                  for name, call in self._programs.items()}
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------- hot swap

    def request_swap(self, params: dict, version: Optional[int], *,
                     source: Optional[tuple] = None) -> SwapTicket:
        """Queue a weight swap from any thread; the serve loop applies it
        between ticks. ``params``: a whole serving ``state_dict`` of the
        served model's names (float32 or int8; coerced to the resident
        variant and checked here, off the loop). ``source``: the
        ``(checkpoint directory, step)`` it came from, which every
        follower loads its own slice of under ``tp > 1`` (required
        there). Returns a ticket whose ``done`` fires at commit or
        rollback. Raises ``ValueError`` on weights the running model
        cannot serve (nothing queued) and ``RuntimeError`` while another
        swap is pending."""
        if self._shard is not None and source is None:
            raise ValueError("a swap under tp > 1 needs its source "
                             "(directory, step): each rank loads its slice")
        coerced, variant = self._coerce_swap(params)
        ticket = SwapTicket(version)
        self._pending_swap.put((coerced, version, ticket, variant, source))
        return ticket

    def swap_params(self, params: dict, version: Optional[int],
                    ticket: Optional[SwapTicket] = None, *,
                    variant: Optional[str] = None,
                    source: Optional[tuple] = None) -> None:
        """Install ``params`` as the serving weights, in place; between
        ticks only (the loop applies ``request_swap``'s; direct calls are
        for single-threaded use, ``params`` then uncoerced). The KV state
        stays: slots in flight go on with the new weights. The replaced
        weights are kept until ``_commit_swap`` (the first clean tick
        after) or copied back by ``_rollback_swap``. Under ``tp > 1`` the
        followers load their slices first and it installs on every rank
        or raises on every rank."""
        if variant is None:
            params, variant = self._coerce_swap(params)
        if self._shard is not None:
            if source is None:
                raise ValueError("a swap under tp > 1 needs its source")
            directory, step = source
            path = np.frombuffer(str(directory).encode(), np.uint8)
            broadcast_call(self._shard, CALL_SWAP,
                           [path.astype(np.int64),
                            np.asarray([step], np.int64)])
            if not all_ranks_ok(self._shard, True):
                raise RuntimeError(
                    f"swap of step {step} failed on a follower rank")
        prev_version = self.weights_step
        backup = self._install_swap(params)
        self.weights_step = version
        self._trial = (backup, prev_version, ticket)
        self._last_swap_variant = variant
        if self._prefix is not None:
            # cached K/V is a function of the weights that wrote it: flush
            # on apply (and stay flushed on a rollback); slots in flight
            # keep their mapped pages
            dropped = self._prefix.invalidate_all()
            if dropped:
                self._tick_events.append(f"prefix_invalidate:{dropped}")
            self._registry.inc("serve/prefix_invalidations")
        self._swap_windows.append({
            "t0": time.monotonic(), "t1": None, "version": version,
            "variant": variant, "outcome": "open"})
        self._tick_events.append(f"swap_applied:{version}")
        self._registry.inc("serve/swaps_applied")
        self._registry.emit({"record": "swap_applied", "version": version,
                             "from_version": prev_version,
                             "variant": variant})

    def _end_trial(self, commit: bool) -> None:
        if self._shard is not None:
            broadcast_call(self._shard, CALL_SWAP_END, [], int(commit))

    def _close_swap_window(self, outcome: str) -> None:
        if self._swap_windows and self._swap_windows[-1]["t1"] is None:
            self._swap_windows[-1]["t1"] = time.monotonic()
            self._swap_windows[-1]["outcome"] = outcome

    def _commit_swap(self) -> None:
        _backup, _prev, ticket = self._trial
        self._trial = None
        self._end_trial(True)
        self.swaps += 1
        self._close_swap_window("committed")
        self._tick_events.append(f"swap_committed:{self.weights_step}")
        self._registry.inc("serve/swaps")
        if self.weights_step is not None:
            self._registry.gauge("serve/weights_step", self.weights_step)
        self._registry.emit({"record": "swap_committed",
                             "version": self.weights_step,
                             "variant": self._last_swap_variant})
        if ticket is not None:
            ticket.resolve(True)

    def _rollback_swap(self, error: str) -> None:
        """The first tick after a swap failed: copy the previous weights
        back (every rank under ``tp``) and record the failure."""
        backup, prev_version, ticket = self._trial
        self._trial = None
        failed = self.weights_step
        self._restore_swap(backup)
        self._end_trial(False)
        self.weights_step = prev_version
        self.swap_rollbacks += 1
        self._close_swap_window("rollback")
        self._tick_events.append(f"swap_rollback:{failed}")
        self._registry.inc("serve/swap_rollbacks")
        self._registry.emit({"record": "swap_failed", "version": failed,
                             "stage": "tick", "error": error})
        self._registry.emit({"record": "swap_rollback",
                             "from_version": failed,
                             "to_version": prev_version, "stage": "tick"})
        logger.error("post-swap tick failed (%s); rolled back to weights "
                     "step %s", error, prev_version)
        if ticket is not None:
            ticket.resolve(False, error=error, stage="tick")

    # ---------------------------------------------------------- accounting

    def _emit_request_record(self, req: GenRequest) -> None:
        n = len(req.tokens)
        decode_s = (req.finish_t - req.first_token_t
                    if req.finish_t is not None
                    and req.first_token_t is not None else None)
        self._registry.emit({
            "record": "serve_request",
            "id": req.id,
            "tier": req.tier,
            "status": req.status,
            "finish_reason": req.finish_reason,
            "prompt_len": req.prompt_len,
            "bucket": req.bucket,
            "new_tokens": n,
            "queue_wait_s": (req.admit_t - req.submit_t
                             if req.admit_t is not None else None),
            "ttft_s": (req.first_token_t - req.submit_t
                       if req.first_token_t is not None else None),
            "tpot_s": (decode_s / (n - 1)
                       if decode_s is not None and n > 1 else None),
            "total_s": (req.finish_t - req.submit_t
                        if req.finish_t is not None else None),
            # the weights version that produced this answer
            "weights_step": self.weights_step,
        })

    def _emit_spans(self, req: GenRequest) -> None:
        """The request's span tree, emitted at finish from its monotonic
        stamps (JAX ``_emit_spans``): ``queue`` (submit to admit),
        ``prefill`` (admit to first token, ``admission`` inside it) and
        ``decode`` (first token to finish) tile the ``serve`` root; a
        request that never left the queue has a queue span over its whole
        life; ``brownout_clamp`` and ``swap_overlap`` mark what touched
        it."""
        tr = self.tracer
        trace = req.id
        base = {"tier": req.tier, "status": req.status,
                "finish_reason": req.finish_reason,
                "weights_step": self.weights_step, "variant": self.variant}
        if self.replica_name:
            base["replica"] = self.replica_name
        serve = tr.begin(trace, "serve", parent=req.trace_parent,
                         t0=req.submit_t,
                         attrs={**base, "bucket": req.bucket,
                                "new_tokens": len(req.tokens)})
        admit = req.admit_t
        q = tr.begin(trace, "queue", parent=serve.span, t0=req.submit_t,
                     attrs={"tier": req.tier})
        tr.end(q, t1=admit if admit is not None else req.finish_t)
        if admit is not None:
            first = req.first_token_t
            p = tr.begin(trace, "prefill", parent=serve.span, t0=admit,
                         attrs={"bucket": req.bucket, "chunks": req.chunks})
            if req.reserve_t is not None:
                attrs = {"pages": (self._pages_for(req)
                                   if self._pages is not None else 0)}
                if self._prefix is not None:
                    attrs["prefix_hit"] = req.prefix_hit
                    attrs["cached_tokens"] = req.cached_tokens
                a = tr.begin(trace, "admission", parent=p.span, t0=admit,
                             attrs=attrs)
                tr.end(a, t1=req.reserve_t)
            tr.end(p, t1=first if first is not None else req.finish_t)
            if first is not None:
                d = tr.begin(trace, "decode", parent=serve.span, t0=first,
                             attrs={"ticks": req.decode_ticks,
                                    "tokens": len(req.tokens),
                                    "drafted": req.drafted,
                                    "accepted": req.accepted})
                tr.end(d, t1=req.finish_t)
        if req.clamped_from is not None:
            tr.event(trace, "brownout_clamp", parent=serve.span,
                     t=req.submit_t,
                     attrs={"from_max_new": req.clamped_from,
                            "to_max_new": req.max_new_tokens})
        for w in self._swap_windows:
            lo = max(w["t0"], req.submit_t)
            hi = min(w["t1"] if w["t1"] is not None else req.finish_t,
                     req.finish_t)
            if hi > lo:
                sw = tr.begin(trace, "swap_overlap", parent=serve.span,
                              t0=lo, attrs={"version": w["version"],
                                            "variant": w["variant"],
                                            "outcome": w["outcome"]})
                tr.end(sw, t1=hi)
        tr.end(serve, t1=req.finish_t)

    def _finish(self, req: GenRequest, status: str, reason: str) -> None:
        req.status = status
        req.finish_reason = reason
        req.finish_t = time.monotonic()
        self.finished += 1
        self._registry.inc(f"serve/finished_{status}")
        self._emit_request_record(req)
        self._emit_spans(req)
        if self.slo is not None and status != "cancelled":
            # an expired request was served but missed its deadline; only
            # errors count against availability here (sheds are fed by the
            # front end)
            self.slo.observe(
                req.tier, available=status != "error",
                deadline_met=(None if req.deadline_s is None
                              else status == "done"))
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
        self._registry.inc("serve/tokens")
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

    def page_occupancy(self) -> float:
        """The fraction of the KV page pool in use (0.0 under the dense
        layout)."""
        if self._pages is None:
            return 0.0
        total = self._pages.num_pages - 1
        return self._pages.pages_used / total if total > 0 else 0.0

    def page_split(self) -> tuple[int, int]:
        """(shared, free) page counts for ``/healthz``; (0, 0) under the
        dense layout."""
        if self._pages is None:
            return (0, 0)
        return (self._pages.pages_shared, self._pages.pages_free)

    def _free_slot(self) -> Optional[int]:
        for i, s in enumerate(self._slots):
            if s is None:
                return i
        return None

    def _evict(self, slot: int) -> None:
        """Free ``slot`` and, paged, drop its page references (shared pages
        live on in other rows or the prefix cache)."""
        self._slots[slot] = None
        if self._pages is not None:
            self._release_pages(slot)

    def _release_pages(self, slot: int) -> None:
        """Drop ``slot``'s page references and give its quota charge back
        to its tenant: every release goes through here, so the tenant
        ledger cannot drift from the allocator."""
        self._pages.release(slot)
        charge = self._slot_charge.pop(slot, None)
        if charge is not None:
            tenant, n = charge
            left = self._tenant_pages.get(tenant, 0) - n
            if left > 0:
                self._tenant_pages[tenant] = left
            else:
                self._tenant_pages.pop(tenant, None)

    def _charge_tenant(self, slot: int, tenant: Optional[str],
                       n: int) -> None:
        """Charge ``n`` freshly allocated (private) pages to ``tenant`` for
        the life of ``slot``'s reservation; shared prefix pages are
        free."""
        if self.config.tenant_page_quota <= 0.0 or tenant is None:
            return
        self._tenant_pages[tenant] = self._tenant_pages.get(tenant, 0) + n
        self._slot_charge[slot] = (tenant, n)

    def _tenant_quota_pages(self) -> int:
        """A tenant's private-page ceiling (a fraction of the usable
        pool)."""
        return max(1, int(self.config.tenant_page_quota
                          * (self._pages.num_pages - 1)))

    def _pages_for(self, req: GenRequest) -> int:
        """Up-front worst-case reservation: bucket + max_new_tokens + the
        speculative overshoot (every slot rides the verify scatter)."""
        return self._pages.pages_reserved(
            req.bucket + req.max_new_tokens, self.config.spec_k
        )

    def _prompt_head(self, req: GenRequest) -> list:
        """The matchable part of a prompt: all but its last token, which
        the tail prefill must run to sample the first output (this also
        keeps every later write past the shared full pages)."""
        return [int(t) for t in req.prompt_ids[: req.prompt_len - 1]]

    def _admission_fits(self, req: GenRequest) -> bool:
        """Page-budget admission predicate (``RequestQueue.pop_ready``);
        the dense layout admits on a free slot alone. With the prefix
        cache the trie match happens here (stashed for the admission right
        after a True): only the pages beyond the fully matched shared ones
        come from the free list, a tenant over its private-page quota is
        held (not page exhaustion), and page pressure first LRU-evicts
        cache-only runs."""
        if self._pages is None:
            return True
        need = self._pages_for(req)
        match = None
        if self._prefix is not None:
            match = self._prefix.match(self._prompt_head(req))
            self._match_scratch = (req.id, match)
            need -= len(match.pages)
        if (self.config.tenant_page_quota > 0.0 and req.tenant is not None
                and self._tenant_pages.get(req.tenant, 0) + need
                > self._tenant_quota_pages()):
            self.tenant_blocked += 1
            self._registry.inc("serve/tenant_blocked")
            return False
        if self._pages.can_alloc(need):
            return True
        if self._prefix is not None:
            # never evict the pages this very match is about to map
            protect = set(match.pages)
            if match.cow_src is not None:
                protect.add(match.cow_src)
            if self._prefix.evict_until(
                need - self._pages.pages_free, protect=protect
            ) and self._pages.can_alloc(need):
                return True
        self._page_blocked = True
        return False

    def _take_match(self, req: GenRequest):
        """The trie match ``_admission_fits`` stashed for the request just
        popped (None when the cache is off)."""
        if self._prefix is None:
            return None
        stashed, self._match_scratch = self._match_scratch, None
        if stashed is not None and stashed[0] == req.id:
            return stashed[1]
        return self._prefix.match(self._prompt_head(req))

    def _prefill_resident(self) -> int:
        return sum(1 for s in self._slots
                   if s is not None and s.phase == "prefill")

    def _admission_defer(self, req: GenRequest) -> bool:
        """Chunked-prefill residency hold (``pop_ready(defer=)``): while
        ``prefill_concurrency`` slots are streaming prompts in, admissions
        wait a tick; checked before the page predicate, so a hold never
        counts as page exhaustion."""
        return self._prefill_resident() >= self.config.prefill_concurrency

    def _slot_spec(self, req: GenRequest) -> bool:
        """The request's speculative opt-in/out against the engine
        default (on whenever spec_k > 0)."""
        if self.config.spec_k <= 0:
            return False
        return req.spec if req.spec is not None else True

    def _start(self, req: GenRequest) -> None:
        req.status = "running"
        req.admit_t = time.monotonic()
        self.admitted += 1
        self._registry.inc("serve/admitted")

    def _reserve(self, req: GenRequest, slot: int) -> None:
        """Reserve ``req``'s worst case of pages for ``slot`` (paged) and
        charge them to its tenant."""
        if self._pages is not None:
            n = self._pages_for(req)
            self._pages.admit(slot, n)
            self._charge_tenant(slot, req.tenant, n)
            req.reserve_t = time.monotonic()

    def _admit(self, req: GenRequest, slot: int) -> None:
        """Prefill ``req`` into ``slot`` and take its first token."""
        self._start(req)
        self._reserve(req, slot)
        t0 = time.perf_counter()
        try:
            with watchdog_guard("serve_prefill"):
                token = self._prefill(req, slot)
        except BaseException:
            # failed admissions must not leak the pages just reserved
            if self._pages is not None:
                self._release_pages(slot)
            raise
        self.prefill_s += time.perf_counter() - t0
        self.prefill_tokens += req.prompt_len
        # index the prompt's full pages before any release below: the
        # cache's own reference keeps them alive past the slot
        self._insert_prefix(slot, req)
        self._emit_token(req, token)
        if self._is_terminal(req, token):
            if self._pages is not None:
                self._release_pages(slot)
            return
        self._slots[slot] = _Slot(request=req, pending_token=token,
                                  spec=self._slot_spec(req))

    def _admit_chunked(self, req: GenRequest, slot: int) -> None:
        """Chunked admission: reserve the slot and its pages; the tick's
        ``_advance_prefills`` streams the prompt in (its first chunk this
        very tick)."""
        self._start(req)
        self._reserve(req, slot)
        self._slots[slot] = _Slot(request=req, pending_token=-1,
                                  phase="prefill", spec=self._slot_spec(req))

    def _admit_hit(self, req: GenRequest, slot: int, match) -> None:
        """Prefix-cache hit: map the shared full pages into the slot's row
        (read-only, refcounts bumped), copy the partly matched page into a
        private one when the match ends mid-page, and leave the slot in
        prefill phase at the cached boundary, so only the tail streams
        through the chunk path. The reservation still covers the whole
        worst case, drawing ``reserved - shared`` pages from the pool."""
        self._start(req)
        reserved = self._pages_for(req)
        shared = list(match.pages)
        cow = match.cow_src is not None
        if cow:
            shared.append(match.cow_src)
        self._pages.admit_shared(slot, shared, reserved - len(shared))
        self._charge_tenant(slot, req.tenant, reserved - len(match.pages))
        req.reserve_t = time.monotonic()
        try:
            if cow:
                # private copy before the tail's first write: a slot never
                # writes a page with refcount > 1; its lanes past the
                # cached length are dead (context length) and overwritten
                old, new = self._pages.cow(slot, len(match.pages))
                with watchdog_guard("serve_prefill"):
                    self._page_copy(old, new)
                self.cow_copies += 1
                self._registry.inc("serve/cow_copies_total")
        except BaseException:
            self._release_pages(slot)
            raise
        req.prefix_hit = True
        req.cached_tokens = match.cached_len
        self.cached_tokens += match.cached_len
        self._slots[slot] = _Slot(
            request=req, pending_token=-1, phase="prefill",
            prefill_pos=match.cached_len, spec=self._slot_spec(req),
        )

    def _insert_prefix(self, slot: int, req: GenRequest) -> None:
        """Index the just-prefilled prompt's FULL pages in the trie (the
        cache takes its own reference on each new node's page). Called
        after the dispatch that wrote the last prompt token; padding never
        lands in the first ``prompt_len // page_size`` pages."""
        if self._prefix is None:
            return
        ps = self.config.page_size
        full = req.prompt_len // ps
        if full <= 0:
            return
        self._prefix.insert(
            [int(t) for t in req.prompt_ids[: full * ps]],
            self._pages.slot_pages(slot)[:full],
        )

    # ------------------------------------------------------- chunked prefill

    def _advance_prefills(self) -> bool:
        """One chunk for every slot still streaming its prompt (a batch-1
        dispatch each). On the final chunk the first token is sampled and
        the slot turns to decode; other slots' decode ticks run between
        chunks, so a long prompt does not stall them."""
        C = self._chunk_size
        chunks = 0
        for i, s in enumerate(self._slots):
            if s is None or s.phase != "prefill":
                continue
            req = s.request
            start = s.prefill_pos
            end = min(start + C, req.prompt_len)
            is_last = end >= req.prompt_len
            t0 = time.perf_counter()
            with watchdog_guard("serve_prefill"):
                token = self._chunk(req, i, start,
                                    req.prompt_len - 1 - start if is_last
                                    else None)
            self.prefill_s += time.perf_counter() - t0
            self.prefill_chunks += 1
            req.chunks += 1
            chunks += 1
            self.prefill_tokens += end - start
            s.prefill_pos = end
            if is_last:
                self._insert_prefix(i, req)
                self._emit_token(req, token)
                if self._is_terminal(req, token):
                    self._evict(i)
                else:
                    s.phase = "decode"
                    s.pending_token = token
                    s.steps_done = 0
        if chunks:
            self._registry.gauge("serve/prefill_chunks", chunks)
        return chunks > 0

    # ------------------------------------------------------------- drafting

    @staticmethod
    def _ngram_draft(hist: list, k: int) -> list:
        """Prompt-lookup drafting (no dispatch): the continuation of the
        most recent EARLIER occurrence of the trailing bigram (unigram
        fallback) in the slot's own prompt + output, padded by repeating
        the last proposal. A wrong guess costs only acceptance."""
        out = []
        for n in (2, 1):
            if len(hist) <= n:
                continue
            pat = hist[-n:]
            for i in range(len(hist) - n - 1, -1, -1):
                if hist[i : i + n] == pat:
                    out = list(hist[i + n : i + n + k])
                    break
            if out:
                break
        while len(out) < k:
            out.append(out[-1] if out else hist[-1])
        return out[:k]

    # --------------------------------------------------------------- ticks

    def _slot_inputs(self, active):
        """Per-slot host operands of a decode-phase dispatch: context
        lengths, sampling streams, and a block table where only ``active``
        rows are real (a streaming prompt's pages must not take a decode
        scatter)."""
        S = self.config.num_slots
        ctx = np.zeros((S,), np.int32)
        seeds = np.zeros((S,), np.int64)
        steps = np.zeros((S,), np.int64)
        temps = np.zeros((S,), np.float32)
        top_ks = np.zeros((S,), np.int64)
        bt = (None if self._pages is None
              else np.zeros_like(self._pages.block_table))
        for i in active:
            s = self._slots[i]
            r = s.request
            ctx[i] = r.prompt_len + s.steps_done
            seeds[i] = r.seed
            steps[i] = s.steps_done + 1   # == len(r.tokens) at sample
            temps[i] = r.temperature
            top_ks[i] = r.top_k
            if bt is not None:
                bt[i] = self._pages.block_table[i]
        return bt, ctx, seeds, steps, temps, top_ks

    def _decode_tick(self, active) -> None:
        """One plain decode dispatch: every decode-phase slot one token."""
        tokens = np.zeros((self.config.num_slots,), np.int64)
        for i in active:
            tokens[i] = self._slots[i].pending_token
        t0 = time.perf_counter()
        with watchdog_guard("serve_decode"):
            sampled = self._decode(tokens, *self._slot_inputs(active))
        self.decode_s += time.perf_counter() - t0
        for i in active:
            s = self._slots[i]
            s.steps_done += 1
            s.request.decode_ticks += 1
            token = int(sampled[i])
            self._emit_token(s.request, token)
            if self._is_terminal(s.request, token):
                self._evict(i)          # slot + pages free for reuse
            else:
                s.pending_token = token
        self.decode_dispatches += 1
        self.decode_tokens += len(active)
        self._registry.gauge("serve/tokens_per_dispatch", 1.0)

    def _last_committed_token(self, s: _Slot) -> int:
        """The token whose K/V sits at position ctx - 1 (the last one fed):
        the newest generated and fed token, or the prompt's last."""
        r = s.request
        if s.steps_done >= 1:
            return int(r.tokens[s.steps_done - 1])
        return int(r.prompt_ids[r.prompt_len - 1])

    def _model_drafts(self, spec_slots) -> np.ndarray:
        """The draft lane's [slots, k] proposals: one chain of ``k + 1``
        greedy draft decodes on the device (``ServeSlice._draft_chain``),
        one copy to the host. Only the spec slots get real block-table
        rows; the rest park on the null page."""
        S = self.config.num_slots
        last = np.zeros((S,), np.int64)
        pending = np.zeros((S,), np.int64)
        ctx = np.zeros((S,), np.int32)
        inc = np.zeros((S,), np.int32)
        bt = np.zeros_like(self._pages.block_table)
        for i in spec_slots:
            s = self._slots[i]
            last[i] = self._last_committed_token(s)
            pending[i] = s.pending_token
            ctx[i] = s.request.prompt_len + s.steps_done - 1
            inc[i] = 1
            bt[i] = self._pages.block_table[i]
        with watchdog_guard("serve_decode"):
            drafts = self._dispatch(CALL_DRAFT_CHAIN,
                                    [last, pending, bt, ctx, inc],
                                    self.config.spec_k,
                                    program="serve_draft_chain")
            with explicit_transfer():
                return drafts.cpu().numpy()

    def _verify_tick(self, active) -> None:
        """ONE verify dispatch advancing every decode-phase slot 1..k+1
        tokens: drafts for the spec slots (n-gram on the host, or the
        draft model's), all k+1 positions scored, the leading exact-match
        run accepted, the accepted drafts plus the sample at the first
        divergence emitted. Non-spec slots ride along with acceptance
        forced to 0 (the one token a decode step would give). Rollback is
        the context cursor not moving past what was accepted."""
        S, k = self.config.num_slots, self.config.spec_k
        spec_slots = [i for i in active if self._slots[i].spec]
        t0 = time.perf_counter()  # the draft chain is decode work too
        drafts = (self._model_drafts(spec_slots)
                  if self._draft is not None and spec_slots else None)
        tokens = np.zeros((S, k + 1), np.int64)
        for i in active:
            s = self._slots[i]
            r = s.request
            tokens[i, 0] = s.pending_token
            if not s.spec:
                tokens[i, 1:] = s.pending_token
            elif drafts is not None:
                tokens[i, 1:] = drafts[i]
            else:
                hist = [int(t) for t in r.prompt_ids[: r.prompt_len]]
                hist.extend(int(t) for t in r.tokens)
                tokens[i, 1:] = self._ngram_draft(hist, k)
        with watchdog_guard("serve_decode"):
            out = self._verify(tokens, *self._slot_inputs(active))
        self.decode_s += time.perf_counter() - t0
        target, accept = out[:, : k + 1], out[:, k + 1]
        self.spec_dispatches += 1
        self.decode_dispatches += 1
        emitted = accepted = 0
        for i in active:
            s = self._slots[i]
            r = s.request
            a = int(accept[i]) if s.spec else 0
            r.decode_ticks += 1
            if s.spec:
                self.spec_drafted += k
                self.spec_accepted += a
                r.drafted += k
                r.accepted += a
                accepted += a
            finished = False
            for j in range(a + 1):
                token = int(target[i, j])
                s.steps_done += 1
                self._emit_token(r, token)
                self.decode_tokens += 1
                emitted += 1
                if self._is_terminal(r, token):
                    self._evict(i)
                    finished = True
                    break
            if not finished:
                s.pending_token = int(target[i, a])
        if spec_slots:
            self._registry.gauge("serve/spec_accept_rate",
                                 accepted / (k * len(spec_slots)))
        self._registry.gauge("serve/tokens_per_dispatch",
                             emitted / len(active))

    def tick(self) -> bool:
        """One engine iteration: apply a pending weight swap, then expire,
        admit, stream prompt chunks, decode (or verify) every decode-phase
        slot. True when any work happened (the serve loop idles on the
        queue otherwise).

        A swap is installed here, between ticks, so a tick runs wholly on
        one version. Its first tick is the trial: a clean tick commits
        it, a failing one copies the previous weights back and the loop
        goes on serving (a bad swap costs the version, not the
        replica)."""
        pending = self._pending_swap.take()
        if pending is not None:
            params, version, ticket, variant, source = pending
            try:
                self.swap_params(params, version, ticket, variant=variant,
                                 source=source)
            except Exception as e:
                if ticket is not None:
                    ticket.resolve(False, error=f"{type(e).__name__}: {e}",
                                   stage="apply")
        try:
            # the tick-wide guard nests over the prefill and decode ones:
            # a hang anywhere in the tick (the fault hooks too) stalls a
            # named section, which dumps the flight recorder
            with watchdog_guard("serve_tick"), torch.inference_mode():
                if self._scope_ready():
                    with self._guards.transfer_scope("serve_tick"):
                        worked = self._tick_body()
                else:
                    worked = self._tick_body()
        except Exception as e:
            if self._trial is not None:
                self._rollback_swap(f"{type(e).__name__}: {e}")
                self.last_tick_t = time.monotonic()
                return True
            raise
        if self._trial is not None:
            self._commit_swap()
        return worked

    def _tick_body(self) -> bool:
        t0 = time.monotonic()
        worked = False
        for req in self._queue.expire_overdue():
            emit_expiry(self._registry, req, "queued")
            self._finish(req, "expired", "deadline")
            worked = True

        # running-slot deadlines: stop spending decode on an abandoned answer
        now = time.monotonic()
        for i, s in enumerate(self._slots):
            if s is not None and s.request.overdue(now):
                self._evict(i)
                emit_expiry(self._registry, s.request, "running")
                self._finish(s.request, "expired", "deadline")
                worked = True

        # admissions: fill free slots in FIFO order; the head must also fit
        # the page budget (a blocked head blocks the queue, no bypass).
        # Chunked engines park admitted prompts in prefill phase, and so do
        # prefix-cache hits (their tails stream from the cached boundary)
        self._page_blocked = False
        chunked = self.config.prefill_chunk > 0
        streaming = chunked or self._prefix is not None
        while True:
            slot = self._free_slot()
            if slot is None:
                break
            req = self._queue.pop_ready(
                accept=self._admission_fits,
                defer=self._admission_defer if chunked else None,
            )
            if req is None:
                break
            try:
                match = self._take_match(req)
                if match is not None:
                    self._prefix.note(match.hit)
                if match is not None and match.hit:
                    self._admit_hit(req, slot, match)
                elif chunked:
                    self._admit_chunked(req, slot)
                else:
                    self._admit(req, slot)
            except Exception:
                # popped and not yet slotted: finish it so its waiter does
                # not hang, then let the loop's failure path take over
                self._registry.inc("serve/admit_failures")
                self._finish(req, "error", "admit_failure")
                raise
            worked = True
        if self._page_blocked:
            self.page_exhausted += 1
            self._registry.inc("serve/page_exhausted")

        # prompt chunks after admissions (a new slot's first chunk this
        # tick) and before decode (its pages hold the prompt before any
        # other dispatch could read them)
        if streaming:
            worked = self._advance_prefills() or worked

        active = [i for i, s in enumerate(self._slots)
                  if s is not None and s.phase == "decode"]
        if active:
            if self.config.spec_k > 0:
                self._verify_tick(active)
            else:
                self._decode_tick(active)
            worked = True

        self.ticks += 1
        depth = self._observe_tick()
        if worked:
            self.busy_ticks += 1
            self._registry.observe("serve/tick", time.monotonic() - t0)
        # a flight entry for every busy or eventful tick, before the fault
        # hooks, so a hang injected at this tick dumps a ring whose last
        # entry is the stalled tick
        events, self._tick_events = self._tick_events, []
        if worked or events:
            self.flight.record(
                tick=self.ticks, busy_tick=self.busy_ticks,
                dur_ms=round((time.monotonic() - t0) * 1e3, 3),
                queue_depth=depth,
                slots_active=sum(1 for s in self._slots if s is not None),
                prefill_resident=self._prefill_resident(),
                decode_active=len(active),
                pages_used=(self._pages.pages_used
                            if self._pages is not None else 0),
                brownout=(self.brownout.level
                          if self.brownout is not None else 0),
                weights_step=self.weights_step, finished=self.finished,
                events=events)
        if worked:
            # the fault hooks fire before the heartbeat below, so an
            # injected hang reads as a stale heartbeat, as a wedged device
            plan = get_plan()
            plan.slow_host_delay(time.monotonic() - t0)
            plan.fire_serve_tick(self.busy_ticks, time.monotonic() - t0)
        self.last_tick_t = time.monotonic()
        return worked

    def _observe_tick(self) -> int:
        """The tick's gauges, the brownout ladder's pressure sample (with
        the prefix cache's idle runs dropped from level 1 up) and the
        drain-rate window; the queue depth."""
        reg = self._registry
        depth = self._queue.depth()
        reg.gauge("serve/queue_depth", depth)
        reg.gauge("serve/slot_occupancy", self.slot_occupancy())
        if self._pages is not None:
            reg.gauge("serve/kv_pages_used", self._pages.pages_used)
            reg.gauge("serve/kv_pages_free", self._pages.pages_free)
        if self._prefix is not None:
            lookups = self._prefix.hits + self._prefix.misses
            reg.gauge("serve/prefix_hit_rate",
                      self._prefix.hits / lookups if lookups else 0.0)
            reg.gauge("serve/pages_shared", self._pages.pages_shared)
            reg.gauge("serve/cow_copies", self.cow_copies)
        if self.brownout is not None:
            level = self.brownout.observe(depth / self._queue.max_depth)
            reg.gauge("serve/brownout_level", level)
            if level != self._prev_brownout_level:
                self._tick_events.append(
                    f"brownout:{self._prev_brownout_level}->{level}")
                self._prev_brownout_level = level
            if level >= 1 and self._prefix is not None:
                # idle cached runs are the cheapest capacity to give back
                dropped = self._prefix.evict_idle()
                if dropped:
                    self._tick_events.append(f"prefix_evict_idle:{dropped}")
        now = time.monotonic()
        window = now - self._drain_window_t
        if window >= 1.0:
            rate = (self.finished - self._drain_window_finished) / window
            # an EWMA, so one quiet window does not zero the estimate
            self.drain_rate = (rate if self.drain_rate == 0.0
                               else 0.5 * self.drain_rate + 0.5 * rate)
            self._drain_window_t = now
            self._drain_window_finished = self.finished
            reg.gauge("serve/drain_rate_rps", self.drain_rate)
        return depth

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
                self._registry.inc("serve/cancelled")
                self._finish(s.request, "cancelled", "cancelled")
        for req in self._queue.drain_pending():
            self._registry.inc("serve/cancelled")
            self._finish(req, "cancelled", "cancelled")

    def shutdown(self) -> None:
        """End the model group's followers (``tp > 1``): send them the stop
        message, once; the engine dispatches nothing after. A no-op at
        ``tp=1``."""
        if self._shard is None or self._stopped:
            return
        self._stopped = True
        broadcast_call(self._shard, CALL_STOP)

    def stats(self) -> dict:
        """The engine's counts. Under ``tp > 1``, ``weight_bytes``,
        ``kv_bytes_per_token`` and ``kv_heads`` are this rank's (its slice
        and its pools); the page counts are the replica's, equal to
        tp=1's. The page counts are None under the dense layout."""
        pages = self._pages
        prefix = None
        if self._prefix is not None:
            prefix = dict(self._prefix.stats(), cow_copies=self.cow_copies,
                          pages_shared=pages.pages_shared,
                          prefill_tokens_skipped=self.cached_tokens,
                          tenant_blocked=self.tenant_blocked,
                          tenant_page_quota=self.config.tenant_page_quota)

        def page(value):
            return None if pages is None else value()

        return {
            "device": str(self.device),
            "ticks": self.ticks,
            "busy_ticks": self.busy_ticks,
            "admitted": self.admitted,
            "finished": self.finished,
            "queue_depth": self._queue.depth(),
            "queue_depth_by_tier": self._queue.depth_by_tier(),
            "slot_occupancy": self.slot_occupancy(),
            "page_occupancy": self.page_occupancy(),
            "drain_rate_rps": self.drain_rate,
            "brownout": (self.brownout.stats()
                         if self.brownout is not None else None),
            "spans_emitted": self.tracer.emitted,
            **self.flight.stats(),
            **(self.slo.stats() if self.slo is not None else {}),
            "num_slots": self.config.num_slots,
            "prompt_buckets": list(self.config.prompt_buckets),
            "prefill_buckets_used": sorted(self._prefill_buckets),
            "kv_layout": self.config.kv_layout,
            "sampling": self.config.sampling,
            "weights_dtype": self.config.weights_dtype,
            "kv_dtype": self.config.kv_dtype,
            "tp": self.config.tp,
            "variant": self.variant,
            "weights_step": self.weights_step,
            "weight_bytes": self.weight_bytes,
            "kv_bytes_per_token": self._kv_bytes_per_token(),
            "kv_heads": self._kv_heads(),
            "kv_page_size": page(lambda: self.config.page_size),
            "kv_pages_total": page(lambda: pages.num_pages - 1),
            "kv_pages_used": page(lambda: pages.pages_used),
            "kv_pages_free": page(lambda: pages.pages_free),
            "kv_pages_shared": page(lambda: pages.pages_shared),
            "kv_pages_peak": page(lambda: pages.peak_used),
            "page_exhausted": self.page_exhausted,
            "prefill_tokens": self.prefill_tokens,
            "prefill_dispatches": self.prefill_dispatches,
            "prefill_s": self.prefill_s,
            "prefill_chunk": self.config.prefill_chunk,
            "prefill_chunks": self.prefill_chunks,
            "prefix_cache": prefix,
            "decode_dispatches": self.decode_dispatches,
            "decode_tokens": self.decode_tokens,
            "decode_s": self.decode_s,
            "tokens_per_dispatch": (
                self.decode_tokens / self.decode_dispatches
                if self.decode_dispatches else None
            ),
            "spec_k": self.config.spec_k,
            "spec_draft": (self.config.spec_draft if self.config.spec_k > 0
                           else None),
            "spec_dispatches": self.spec_dispatches,
            "spec_drafted": self.spec_drafted,
            "spec_accepted": self.spec_accepted,
            "spec_accept_rate": (
                self.spec_accepted / self.spec_drafted
                if self.spec_drafted else None
            ),
            "swaps": self.swaps,
            "swap_rollbacks": self.swap_rollbacks,
            "swap_pending": self._pending_swap.waiting,
            "guard_mode": self._guards.mode,
            "guard_recompiles": self._guards.recompile_violations,
            "guard_implicit_transfers": self._guards.transfer_violations,
            "comm_audit": self.comm_record,
            "warmup_dispatches": self.warmup_dispatches,
        }
