"""BERT encoder family and the attention stack shared with GPT-2
(counterpart: the JAX package's ``models/bert.py``).

- ``Embed``: flax ``nn.Embed``, an ``embedding`` table looked up in the
  compute dtype.

- ``DenseGeneral``: the flax ``nn.DenseGeneral`` layout — ``kernel`` of
  shape ``in_shape + out_shape`` and ``bias`` of ``out_shape`` — so the
  weight bridge (``models/convert.py``) is a rename, not a relayout. The
  matmul runs in the compute dtype, as flax casts inputs and weights.
  Weight-only int8 (``quantize``, or loading a ``kernel_scale``): an int8
  ``kernel`` beside its fp32 per-output-channel ``kernel_scale``,
  dequantized per call (``kernel.float() * kernel_scale`` cast to the
  compute dtype, one op), so only the int8 bytes stay resident.
  int8 training (``matmul_impl`` int8/int8_full, the counterpart of JAX
  ``QuantDenseGeneral``), a different path: the float32 ``kernel`` and
  ``bias`` of the native layer, names and shapes unchanged, contracted
  through ``ops/quant.int8_dense`` (``int8_dense_delayed`` with
  ``quant_delayed``, ``int8_dense_delayed_grads`` with
  ``quant_delayed_grads``). The delayed sites hold persistent float32
  buffers, ``amax`` (a scalar) and ``dy_amax`` [2], JAX's ``"quant"``
  leaves: a forward with grad enabled (training) or inside
  ``dy_calibration_mode`` (calibration) carries the amax it observed on
  in ``amax``; any other forward under ``torch.no_grad()`` (eval) reads
  them and leaves them as they are. Only the six projections
  of a layer take this path (``dense(..., int8=True)``); the pooler, the
  classifier and GPT-2's tied head stay native, as in JAX. Their amaxes
  are maxed over ``batch_group`` (the gradient axes: data, fsdp, seq),
  and under tensor parallelism over the model axis where the tensor is
  cut there (``reduce_group`` of a row-parallel site, whose int32 partial
  products are summed before the rescale; ``feature_group`` of a
  column-parallel one).
- ``BertSelfAttention``: separate ``query``/``key``/``value`` projections
  to [heads, head_dim] and an ``out`` projection back; full-sequence
  attention through ``ops/attention.py``, or the PAGED branch when the
  caller passes the layer's page pools (``PagedKV``):

  * prefill (chunk > 1): the sequence is fresh (context_len == 0), its
    block-table row covers the chunk; K/V is scattered into its pages and
    attention is intra-chunk causal with the dense-cache formula (fp32
    scores, ``finfo.min`` mask, fp32 softmax, probs in the V dtype) over
    the in-flight K/V in the compute dtype, so the first token is exact
    whatever the pool dtype;
  * decode (chunk == 1): one token appended at ``context_len``, then
    ``ops/paged_attention.paged_attention`` over the whole context. Idle
    rows park on the null page 0; their outputs are ignored by the engine;
  * multi-token query (``PagedKV.multiquery`` or ``paged_multiquery``,
    chunk > 1): the chunk is
    appended at ``context_len`` of an existing context (speculative
    verify, chunked prefill, a prefix-hit tail) and attends causally over
    the earlier pages and itself through the 4-D-query ``paged_attention``;

  or the DENSE decode cache when it passes the layer's ``DenseKV.layer``
  (``models/generate.py``; JAX ``BertSelfAttention._cached_attend``): a
  [batch, max_len, heads, head_dim] K and V a layer in the compute dtype,
  the chunk written at the cache's index, scores over the whole buffer in
  float32 with the causal-over-cache mask (key t visible to chunk row i iff
  t <= index + i) and the pad bias, probabilities in the cache's dtype;
  multi-token prefill and one-token steps alike, no dropout. Its products
  are ``einsum``s, as JAX's are outside any Pallas kernel.

  Full-sequence attention takes a dropout seed (probs dropout, site 2 of
  the layer's seed) and, with ``attention_remat``, recomputes its core in
  the backward under ``torch.utils.checkpoint``; the seed is an explicit
  input of the core, so the recomputed mask is the forward's.
- Remat (``remat``, ``remat_policy``; JAX ``_layer_cls``, ``nn.remat``):
  ``call_layer`` runs each layer of ``run_layers`` (the BERT trunk, the
  TriBert branches, a stage's layers), of GPT-2's blocks and of the
  scanned trunk under ``remat_call``, a non-reentrant
  ``torch.utils.checkpoint`` whose selective policy keeps every matmul
  output (``dots``), the unbatched ones (``weight_dots``) or nothing; the
  layer's parameters (slices, in the scanned trunk) are checkpoint inputs
  and its delayed-int8 amaxes advance once, in the first forward.
- ``BertLayer``: the post-LN block. Attention, then the fused
  dropout-add-LayerNorm tail (``attention_norm``, site 0), the MLP with
  tanh GELU when ``gelu_approximate``, and the second tail (``mlp_norm``,
  site 1); both tails share the layer's seed.
- ``BertForSequenceClassification``: embeddings (word + position + token
  type, LayerNorm, dropout) -> layers -> CLS pooler (dense, tanh) ->
  dropout -> float32 classifier on the float32 pooled output.
- RoBERTa (``roberta_style``, JAX ``default_position_ids`` and
  ``pool_cls``): the same trunk; position ids ``cumsum(ids != pad) * (ids
  != pad) + pad`` (counted over the ids, not the attention mask: a task
  that pads with 0 where RoBERTa's pad is 1 counts every column, as JAX
  does), a token-type table of one row, and a dropout of the CLS row
  before the pooler (RobertaClassificationHead's order). Under context
  parallelism a rank's positions add the non-pad ids of the columns left
  of its shard, gathered over the seq axis (``shard_position_ids``).
- The options of every ``Dropout`` site and LayerNorm: ``dropout_impl``
  (the mask stream, ``ops/dropout.py``) and ``layernorm_impl``
  (``ops/layer_norm.py``).
- ``ScannedLayers``: with ``scan_layers`` the trunk (``bert.layers_scan``,
  and GPT-2's ``layers_scan``) holds one layer module whose parameters
  stack every layer's on a leading [num_layers] dim, the JAX ``nn.scan``
  trunk's layout and names; it computes what the per-layer trunk does,
  bit for bit. The int8 sites' amax buffers stack alike ([num_layers],
  [num_layers, 2]), each layer reading and writing its row.

Dropout seeds: ``forward(..., dropout_seed=None)`` is deterministic; a
seed gives the embeddings ``fold_in(seed, 0)``, layer i ``fold_in(seed,
i + 1)`` and the classifier ``fold_in(seed, num_layers + 1)`` (site 0; the
RoBERTa pooler's pre-dropout site 1), the counterpart of the distinct flax
``make_rng("dropout")`` keys per module.

Tensor parallelism (``parallel/sharding.tensor_parallel`` sets
``tp_shard``, the model axis's ``AxisShard``, on the modules whose
weights it cut, Megatron's layout as JAX ``_tp_spec`` implies): the
attention runs on its rank's heads and the MLP on its rank's
``intermediate / M`` columns; ``copy_to_model`` before the
column-parallel projections (query/key/value, ``mlp_up``), the
row-parallel ones (``out``, ``mlp_down``) sum their partial products with
``reduce_from_model`` and add their replicated bias once, after the sum.
The probabilities' dropout seed folds in the model coordinate, so the
ranks' heads draw their own masks; every other site sees replicated
activations and draws alike on every model rank.

Context parallelism (``parallel/sharding.context_parallel`` sets
``seq_shard``, the seq axis's ``AxisShard``): each rank holds the columns
``index * S/P ...`` of every row; position ids start there, attention is
``"ring"`` (``ops/ring_attention.py``), the embeddings' and layers' seeds
fold in the seq coordinate (the shards draw their own masks), and BERT's
pooler reads the CLS row of seq coordinate 0 on every seq rank
(``comms/collectives.broadcast_first``), the classifier's seed unfolded.

The page pools are tensors the serving engine owns and passes in; the
scatter writes them in place (the JAX package returns new pools, which
XLA updates in place through donation). int8 pools quantize on write
(``ops/quant.quantize_kv``, one fp32 scale per token and head) and their
scales scatter through the same (page, offset) indices into the layer's
scale pools (``PagedKV.scales``). The dense cache is an explicit
``DenseKV`` the caller makes and passes to each forward; the forward
writes it in place and advances its ``index``.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (
    checkpoint,
    create_selective_checkpoint_contexts,
    noop_context_fn,
)

from pytorch_distributed_training_tpu_torch.comms.collectives import (
    all_reduce_sum,
    broadcast_first,
    copy_to_model,
    reduce_from_model,
)
from pytorch_distributed_training_tpu_torch.ops.attention import (
    dot_product_attention,
    make_attention_bias,
)
from pytorch_distributed_training_tpu_torch.ops.dropout import Dropout, fold_in
from pytorch_distributed_training_tpu_torch.ops.layer_norm import (
    FusedDropoutAddLayerNorm,
    FusedLayerNorm,
)
from pytorch_distributed_training_tpu_torch.ops.paged_attention import (
    paged_attention,
)
from pytorch_distributed_training_tpu_torch.ops.quant import (
    QuantGroups,
    calibrating,
    int8_dense,
    int8_dense_delayed,
    int8_dense_delayed_grads,
    quantize_kernel,
    quantize_kv,
)
from pytorch_distributed_training_tpu_torch.utils.config import ModelConfig

_NEG = torch.finfo(torch.float32).min
# dropout sites within one layer's seed: the two tails, then the probs
_SITE_ATTENTION_NORM, _SITE_MLP_NORM, _SITE_PROBS = 0, 1, 2
# within the classifier's seed: its dropout, then RoBERTa's pre-pooler one
_SITE_CLASSIFIER, _SITE_POOL = 0, 1


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.compute_dtype)


def param_dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.param_dtype)


def layer_norm_module(cfg: ModelConfig, device=None) -> FusedLayerNorm:
    """LayerNorm with fp32 stats emitting the compute dtype directly."""
    return FusedLayerNorm(
        cfg.hidden_size, eps=cfg.layer_norm_eps, out_dtype=compute_dtype(cfg),
        param_dtype=param_dtype(cfg), device=device, impl=cfg.layernorm_impl,
    )


def dropout_module(cfg: ModelConfig) -> Dropout:
    """A dropout site at ``hidden_dropout`` in the config's stream."""
    return Dropout(cfg.hidden_dropout, cfg.dropout_impl)


class Embed(nn.Module):
    """flax ``nn.Embed``: an ``embedding`` table, lookups in ``dtype``."""

    def __init__(self, num: int, features: int, *, dtype: torch.dtype,
                 param_dtype: torch.dtype, device=None, generator=None):
        super().__init__()
        self.dtype = dtype
        table = torch.empty(num, features, dtype=param_dtype, device=device)
        table.normal_(0.0, 0.02, generator=generator)
        self.embedding = nn.Parameter(table)

    def forward(self, ids):
        # gather, then cast: the same values as flax's cast-then-gather
        return F.embedding(ids, self.embedding).to(self.dtype)


@dataclasses.dataclass
class PagedKV:
    """Per-call paged-cache operands: the engine's pools (one ``(k_pages,
    v_pages)`` pair per layer), the block table [batch, W] int32 and the
    context length [batch] int32 (tokens already in the pages).
    ``multiquery``: a chunk of more than one token goes through the
    4-D-query kernel over an existing context (as ``cfg.paged_multiquery``
    does for every call) instead of the fresh-prefill branch. ``scales``:
    for int8 pools, one ``(k_scales, v_scales)`` pair per layer, fp32
    [num_pages, page_size, heads]; None for float pools."""

    pools: list
    block_table: torch.Tensor
    context_len: torch.Tensor
    multiquery: bool = False
    scales: Optional[list] = None

    def layer(self, i: int) -> tuple:
        """Layer ``i``'s operands, as ``BertSelfAttention`` takes them."""
        k_scales, v_scales = (None, None) if self.scales is None else (
            self.scales[i])
        return (*self.pools[i], k_scales, v_scales, self.block_table,
                self.context_len, self.multiquery)


class DenseLayerKV(tuple):
    """One layer's dense-cache operands, ``(keys, values, index)``
    (``DenseKV.layer``)."""


@dataclasses.dataclass
class DenseKV:
    """The dense decode cache of a causal model (counterpart: JAX's flax
    ``"cache"`` collection of ``cached_key``/``cached_value`` and
    ``cache_index``): per layer a [batch, max_len, heads, head_dim] K and
    V buffer, and ``index``, the tokens written so far (every layer's, as
    one forward writes them all): an int, or a [batch] tensor when each
    row has its own (the serving engine's slots), with ``index_max`` its
    largest value when the caller knows it on the host (else the forward
    reads it back from the device)."""

    keys: list
    values: list
    index: "int | torch.Tensor" = 0
    index_max: Optional[int] = None

    @classmethod
    def zeros(cls, cfg: ModelConfig, batch: int, max_len: int,
              device=None) -> "DenseKV":
        shape = (batch, max_len, cfg.num_heads, cfg.head_dim)

        def buf():
            return torch.zeros(shape, dtype=compute_dtype(cfg),
                               device=device)

        return cls([buf() for _ in range(cfg.num_layers)],
                   [buf() for _ in range(cfg.num_layers)])

    def layer(self, i: int) -> DenseLayerKV:
        return DenseLayerKV((self.keys[i], self.values[i], self.index))


class DenseGeneral(nn.Module):
    """flax ``DenseGeneral`` over the trailing ``len(in_shape)`` axes."""

    def __init__(self, in_shape: tuple, out_shape: tuple, *,
                 dtype: torch.dtype, param_dtype: torch.dtype, device=None,
                 generator: Optional[torch.Generator] = None,
                 int8_mode: Optional[str] = None, delayed: bool = False,
                 delayed_grads: bool = False):
        super().__init__()
        self.in_shape = tuple(in_shape)
        self.out_shape = tuple(out_shape)
        self.dtype = dtype
        kernel = torch.empty(self.in_shape + self.out_shape,
                             dtype=param_dtype, device=device)
        kernel.normal_(0.0, 0.02, generator=generator)
        self.kernel = nn.Parameter(kernel)
        self.bias = nn.Parameter(
            torch.zeros(self.out_shape, dtype=param_dtype, device=device)
        )
        self.register_parameter("kernel_scale", None)
        # row-parallel (tensor parallelism): the model axis's group the
        # partial products are summed over before the bias
        self.reduce_group = None
        # int8 training: None (native), "fwd" or "full" (ops/quant.py)
        self.int8_mode = int8_mode
        if int8_mode is not None and delayed:
            self.register_buffer("amax", torch.zeros(
                (), dtype=torch.float32, device=device))
            if delayed_grads:
                self.register_buffer("dy_amax", torch.zeros(
                    2, dtype=torch.float32, device=device))
        # int8 amaxes: the gradient axes' group (the rows and tokens are cut
        # over it) and, column-parallel, the model group of the features
        self.batch_group = None
        self.feature_group = None

    @torch.no_grad()
    def quantize(self) -> None:
        """Weight-only int8 in place: an int8 ``kernel`` and its fp32
        per-output-channel ``kernel_scale`` (the ``in_shape`` axes kept as
        size-1 dims), neither requiring grad. Idempotent."""
        if self.kernel_scale is not None:
            return
        q, scale = quantize_kernel(self.kernel, len(self.in_shape))
        self.kernel = nn.Parameter(q, requires_grad=False)
        self.kernel_scale = nn.Parameter(scale, requires_grad=False)

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        # an int8 state (a ``kernel_scale`` beside an int8 kernel) loads
        # as it is: take the quantized layout first, so the int8 values are
        # copied, never cast into a float kernel without their scale
        scale = state_dict.get(prefix + "kernel_scale")
        if scale is not None and self.kernel_scale is None:
            kernel = state_dict[prefix + "kernel"]
            dev = self.kernel.device
            self.kernel = nn.Parameter(
                torch.empty(kernel.shape, dtype=kernel.dtype, device=dev),
                requires_grad=False)
            self.kernel_scale = nn.Parameter(
                torch.empty(scale.shape, dtype=scale.dtype, device=dev),
                requires_grad=False)
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)

    def _int8_forward(self, x):
        n_in = len(self.in_shape)
        amax = getattr(self, "amax", None)
        dy_amax = getattr(self, "dy_amax", None)
        row = self.reduce_group
        groups = QuantGroups(x=(self.batch_group, row), w=(row,),
                             dy=(self.batch_group, self.feature_group),
                             sum=row)
        if dy_amax is not None:
            y, new = int8_dense_delayed_grads(x, self.kernel, amax, dy_amax,
                                              n_in, groups)
        elif amax is not None:
            y, new = int8_dense_delayed(x, self.kernel, amax, n_in,
                                        self.int8_mode, groups)
        else:
            y = int8_dense(x, self.kernel, n_in, self.int8_mode, groups)
        if amax is not None and (torch.is_grad_enabled() or calibrating()):
            amax.copy_(new)  # what the next microbatch quantizes with
        return y.to(self.dtype) + self.bias.to(self.dtype)

    def forward(self, x):
        n_in = len(self.in_shape)
        if self.int8_mode is not None and self.kernel_scale is None:
            return self._int8_forward(x.to(self.dtype))
        lead = x.shape[: x.dim() - n_in]
        if self.kernel_scale is None:
            w = self.kernel.to(self.dtype)
        else:
            # int8: ``kernel.float() * kernel_scale`` in float32, rounded
            # once into a compute-dtype tensor (one op), the values of the
            # JAX package's dequantize-then-cast
            w = torch.mul(self.kernel, self.kernel_scale, out=torch.empty(
                self.kernel.shape, dtype=self.dtype,
                device=self.kernel.device))
        w = w.reshape(math.prod(self.in_shape), math.prod(self.out_shape))
        y = torch.matmul(x.to(self.dtype).reshape(*lead, w.shape[0]), w)
        if self.reduce_group is not None:
            y = reduce_from_model(y, self.reduce_group)
        # bias added after the product's rounding, as flax does
        y = y + self.bias.to(self.dtype).reshape(-1)
        return y.reshape(*lead, *self.out_shape)


def dense(cfg: ModelConfig, in_shape, out_shape, device=None, generator=None,
          int8: bool = False):
    """A ``DenseGeneral`` in the compute dtype; ``int8``: one of a layer's
    six projections, which ``cfg.matmul_impl`` may make int8 (JAX
    ``dense_general``)."""
    quant = {}
    if int8 and cfg.matmul_impl != "native":
        quant = dict(
            int8_mode="full" if cfg.matmul_impl == "int8_full" else "fwd",
            delayed=cfg.quant_delayed,
            delayed_grads=cfg.quant_delayed_grads)
    return DenseGeneral(
        in_shape, out_shape, dtype=compute_dtype(cfg),
        param_dtype=param_dtype(cfg), device=device, generator=generator,
        **quant,
    )


class BertSelfAttention(nn.Module):
    def __init__(self, cfg: ModelConfig, device=None, generator=None):
        super().__init__()
        self.config = cfg
        h = cfg.hidden_size
        heads = (cfg.num_heads, cfg.head_dim)
        self.query = dense(cfg, (h,), heads, device, generator, int8=True)
        self.key = dense(cfg, (h,), heads, device, generator, int8=True)
        self.value = dense(cfg, (h,), heads, device, generator, int8=True)
        self.out = dense(cfg, heads, (h,), device, generator, int8=True)
        self.tp_shard = None  # the model axis, under tensor parallelism
        self.seq_shard = None  # the seq axis, under context parallelism

    def forward(self, x, attention_bias=None, paged=None, dropout_seed=None):
        """``paged``: None for full-sequence attention, else ``(k_pages,
        v_pages, k_scales, v_scales, block_table, context_len,
        multiquery)`` for this layer (``PagedKV.layer``), or its dense
        cache (``DenseKV.layer``).
        ``dropout_seed``: the layer's seed for probs dropout (None is
        deterministic)."""
        cfg = self.config
        if self.tp_shard is not None:
            x = copy_to_model(x, self.tp_shard.group)
            dropout_seed = child_seed(dropout_seed, self.tp_shard.index)
        q = self.query(x)
        k = self.key(x)
        v = self.value(x)
        if isinstance(paged, DenseLayerKV):
            out = self._cached_attend(q, k, v, attention_bias, *paged)
        elif paged is not None:
            out = self._paged_attend(q, k, v, attention_bias, *paged)
        else:
            seq = self.seq_shard

            def core(q, k, v, bias, seed):
                return dot_product_attention(
                    q, k, v, bias, impl=cfg.attention_impl,
                    causal=cfg.causal, dropout_rate=cfg.attention_dropout,
                    dropout_seed=seed, dropout_site=_SITE_PROBS, seq=seq,
                    dropout_impl=cfg.dropout_impl,
                )

            # the ring at a seq axis of one rank is reference attention
            plain = cfg.attention_impl == "reference" or (
                cfg.attention_impl == "ring" and seq is None)
            if cfg.attention_remat and plain and torch.is_grad_enabled():
                # recompute scores, softmax and the probs mask in the
                # backward instead of saving the [B, N, S, S] probs
                out = checkpoint(core, q, k, v, attention_bias, dropout_seed,
                                 use_reentrant=False)
            else:
                out = core(q, k, v, attention_bias, dropout_seed)
        return self.out(out)

    def _cached_attend(self, q, k, v, attention_bias, keys, values, index):
        """The dense-cache attention (JAX ``_cached_attend``): this chunk's
        K/V written at ``index``, then rows ``index .. index + chunk - 1``
        attend over the buffer up to themselves. ``index`` is an int, or a
        [batch] tensor of each row's own index (the serving engine's
        slots, the JAX engine's per-slot ``cache_index``)."""
        if not self.config.causal:
            raise ValueError("a dense decode cache requires a causal model")
        batch, chunk, head_dim = q.shape[0], q.shape[1], q.shape[3]
        max_len = keys.shape[1]
        steps = torch.arange(chunk, device=q.device)
        if torch.is_tensor(index):
            q_pos = index.long()[:, None] + steps[None, :]    # [batch, chunk]
            rows = torch.arange(batch, device=q.device)[:, None]
            keys[rows, q_pos] = k.to(keys.dtype)
            values[rows, q_pos] = v.to(values.dtype)
        else:
            q_pos = (index + steps)[None, :]
            keys[:, index:index + chunk] = k.to(keys.dtype)
            values[:, index:index + chunk] = v.to(values.dtype)
        scores = torch.einsum("bsnd,btnd->bnst", q.float(),
                              keys.float()) * head_dim ** -0.5
        k_pos = torch.arange(max_len, device=q.device)
        visible = k_pos[None, None, :] <= q_pos[:, :, None]  # [b|1, s, t]
        scores = torch.where(visible[:, None], scores, _NEG)
        if attention_bias is not None:
            scores = scores + attention_bias.float()
        probs = torch.softmax(scores, dim=-1).to(values.dtype)
        return torch.einsum("bnst,btnd->bsnd", probs, values)

    def _paged_attend(self, q, k, v, attention_bias, k_pages, v_pages,
                      k_scales, v_scales, block_table, context_len,
                      multiquery):
        if not self.config.causal:
            raise ValueError("paged attention requires a causal model")
        batch, chunk, heads, head_dim = q.shape
        page_size = k_pages.shape[1]
        windows = block_table.shape[1]
        # scatter this chunk's K/V through the block table: position idx+j
        # lives at page bt[b, (idx+j)//P], offset (idx+j)%P; pad lanes of
        # a last chunk past the table's reach land on the null page (the
        # JAX scatter drops them)
        pos = context_len[:, None] + torch.arange(
            chunk, dtype=context_len.dtype, device=q.device
        )[None, :]
        win = (pos // page_size).long()
        page_ids = torch.gather(block_table, 1, win.clamp(max=windows - 1))
        page_ids = torch.where(win < windows, page_ids, 0)
        at = (page_ids.long(), (pos % page_size).long())
        if k_pages.dtype == torch.int8:
            # quantize-on-write: values and scales through the same (page,
            # offset), so a token's int8 lanes and its scales stay together;
            # K and V in one quantize_kv (its rows are independent, so the
            # same values as two calls, in half the launches). The
            # fresh-prefill branch below attends the unquantized K/V
            kc, vc = k, v
            kvq, kvs = quantize_kv(torch.stack([k, v]))
            k_pages[at], v_pages[at] = kvq[0], kvq[1]
            k_scales[at], v_scales[at] = kvs[0], kvs[1]
            pool_kw = dict(k_scales=k_scales, v_scales=v_scales)
        else:
            kc = k.to(k_pages.dtype)
            vc = v.to(v_pages.dtype)
            k_pages[at] = kc
            v_pages[at] = vc
            pool_kw = {}
        scale = head_dim ** -0.5
        if chunk == 1:
            if attention_bias is not None:
                raise ValueError(
                    "paged decode steps take no attention bias (padding is "
                    "expressed through context_len)"
                )
            out = paged_attention(
                q[:, 0], k_pages, v_pages, block_table, context_len + 1,
                scale=scale, **pool_kw,
            )
            return out[:, None]
        if multiquery or self.config.paged_multiquery:
            # the chunk's rows sit at positions idx..idx+chunk-1 and see
            # everything written up to themselves (lengths include the chunk)
            if attention_bias is not None:
                raise ValueError(
                    "paged multiquery attention takes no attention bias "
                    "(padding is expressed through context_len)"
                )
            return paged_attention(q, k_pages, v_pages, block_table,
                                   context_len + chunk, scale=scale,
                                   **pool_kw)
        # prefill: fresh sequence (context_len == 0 by engine contract), so
        # the visible context IS this chunk: the dense-cache formula
        scores = torch.einsum("bsnd,btnd->bnst", q.float(), kc.float()) * scale
        causal = torch.ones(chunk, chunk, dtype=torch.bool,
                            device=q.device).tril()
        scores = torch.where(causal[None, None], scores, _NEG)
        if attention_bias is not None:
            scores = scores + attention_bias.float()
        probs = torch.softmax(scores, dim=-1).to(vc.dtype)
        return torch.einsum("bnst,btnd->bsnd", probs, vc)


def _dal(cfg: ModelConfig, site: int, device=None) -> FusedDropoutAddLayerNorm:
    return FusedDropoutAddLayerNorm(
        cfg.hidden_size, eps=cfg.layer_norm_eps, rate=cfg.hidden_dropout,
        site=site, out_dtype=compute_dtype(cfg), param_dtype=param_dtype(cfg),
        device=device, impl=cfg.layernorm_impl, dropout_impl=cfg.dropout_impl,
    )


class BertEmbeddings(nn.Module):
    """word + position (+ token type) embeddings -> LayerNorm -> dropout."""

    def __init__(self, cfg: ModelConfig, device=None, generator=None):
        super().__init__()
        self.config = cfg
        kw = dict(dtype=compute_dtype(cfg), param_dtype=param_dtype(cfg),
                  device=device, generator=generator)
        self.word_embeddings = Embed(cfg.vocab_size, cfg.hidden_size, **kw)
        self.position_embeddings = Embed(cfg.max_position_embeddings,
                                         cfg.hidden_size, **kw)
        self.token_type_embeddings = (
            Embed(cfg.type_vocab_size, cfg.hidden_size, **kw)
            if cfg.type_vocab_size else None
        )
        self.norm = layer_norm_module(cfg, device)
        self.dropout = dropout_module(cfg)

    def forward(self, input_ids, token_type_ids, position_ids,
                dropout_seed=None):
        x = self.word_embeddings(input_ids) + self.position_embeddings(
            position_ids
        )
        if self.token_type_embeddings is not None:
            types = token_type_ids.clamp(0, self.config.type_vocab_size - 1)
            x = x + self.token_type_embeddings(types)
        return self.dropout(self.norm(x), dropout_seed)


class BertLayer(nn.Module):
    """Post-LN transformer block (BERT convention)."""

    def __init__(self, cfg: ModelConfig, device=None, generator=None):
        super().__init__()
        self.config = cfg
        h = cfg.hidden_size
        self.attention = BertSelfAttention(cfg, device, generator)
        self.attention_norm = _dal(cfg, _SITE_ATTENTION_NORM, device)
        self.mlp_up = dense(cfg, (h,), (cfg.intermediate_size,), device,
                            generator, int8=True)
        self.mlp_down = dense(cfg, (cfg.intermediate_size,), (h,), device,
                              generator, int8=True)
        self.mlp_norm = _dal(cfg, _SITE_MLP_NORM, device)
        self.tp_shard = None  # the model axis, under tensor parallelism

    def forward(self, x, attention_bias=None, dropout_seed=None):
        attn_out = self.attention(x, attention_bias,
                                  dropout_seed=dropout_seed)
        x = self.attention_norm(attn_out, x, dropout_seed)
        h = self.mlp_up(model_input(x, self.tp_shard))
        h = F.gelu(h, approximate="tanh" if self.config.gelu_approximate
                   else "none")
        h = self.mlp_down(h)
        return self.mlp_norm(h, x, dropout_seed)


def model_input(x, tp_shard):
    """The input of a column-parallel projection: ``copy_to_model`` over
    the model axis under tensor parallelism, else ``x``."""
    return x if tp_shard is None else copy_to_model(x, tp_shard.group)


def seq_offset(input_ids, seq_shard) -> int:
    """The global position of this rank's first column: its seq
    coordinate times the local length (0 without context parallelism)."""
    return 0 if seq_shard is None else seq_shard.index * input_ids.shape[1]


def default_position_ids(cfg: ModelConfig, input_ids, offset: int = 0,
                         before=None):
    """Position ids per model family (JAX ``default_position_ids``),
    checked against the position table: BERT's arange over the sequence
    from ``offset`` (the rank's first column under context parallelism);
    RoBERTa's ``cumsum(ids != pad) * (ids != pad) + pad``, the count
    starting after ``before`` ([batch], the non-pad ids of the columns
    left of this shard; None: none)."""
    batch, seq = input_ids.shape
    total = offset + seq
    # roberta positions run pad_token_id+1 .. seq+pad_token_id (HF offset)
    max_pos = total + cfg.pad_token_id + 1 if cfg.roberta_style else total
    if max_pos > cfg.max_position_embeddings:
        raise ValueError(
            f"sequence length {total} needs position ids up to "
            f"{max_pos - 1} but max_position_embeddings is "
            f"{cfg.max_position_embeddings}"
        )
    if cfg.roberta_style:
        mask = (input_ids != cfg.pad_token_id).long()
        count = torch.cumsum(mask, dim=-1)
        if before is not None:
            count = count + before[:, None]
        return count * mask + cfg.pad_token_id
    return torch.arange(offset, offset + seq, device=input_ids.device)[
        None, :].expand(batch, seq)


def shard_position_ids(cfg: ModelConfig, input_ids, seq_shard=None):
    """The default position ids of this rank's columns: under context
    parallelism RoBERTa's count adds, for each row, the non-pad ids of the
    seq ranks before this one (one all-reduce of a [seq, batch] tensor over
    the seq axis), so the positions are one process's."""
    before = None
    if cfg.roberta_style and seq_shard is not None:
        counts = torch.zeros(seq_shard.size, input_ids.shape[0],
                             dtype=torch.long, device=input_ids.device)
        counts[seq_shard.index] = (input_ids != cfg.pad_token_id).sum(-1)
        counts = all_reduce_sum(counts, seq_shard.group)
        before = counts[:seq_shard.index].sum(0)
    return default_position_ids(cfg, input_ids,
                                seq_offset(input_ids, seq_shard), before)


def child_seed(seed: Optional[int], index: int) -> Optional[int]:
    return None if seed is None else fold_in(seed, index)


def trunk_seed(seed: Optional[int], seq_shard) -> Optional[int]:
    """The seed of the embeddings and layers: under context parallelism
    folded with the seq coordinate, so the shards draw their own masks."""
    return seed if seq_shard is None else child_seed(seed, seq_shard.index)


# the matmul ops each remat policy keeps (JAX ``remat_policy``, models/
# bert.py): "dots" is ``dots_saveable``, every product; "weight_dots" is
# ``dots_with_no_batch_dims_saveable``, the projections (2-D products) but
# not the attention einsums (batched). Everything else is recomputed, and
# so is every kernel bound through ctypes (flash attention, LayerNorm,
# dropout-add-LayerNorm, dropout: ``ops/_build.py``), which no torch op
# stands for, as JAX's policies recompute a ``pallas_call``.
_aten = torch.ops.aten
_REMAT_SAVED = {
    "dots": (_aten.mm.default, _aten.addmm.default, _aten.bmm.default,
             _aten.baddbmm.default, _aten._int_mm.default),
    "weight_dots": (_aten.mm.default, _aten.addmm.default,
                    _aten._int_mm.default),
}


def _remat_context(policy: str):
    """``checkpoint``'s ``context_fn`` for ``policy``."""
    if policy == "nothing":
        return noop_context_fn
    return functools.partial(create_selective_checkpoint_contexts,
                             list(_REMAT_SAVED[policy]))


def remat_call(fn, args: tuple, modules, policy: str = "nothing"):
    """``fn(*args)``, a forward of ``modules``, under
    ``torch.utils.checkpoint`` (non-reentrant): the forward keeps only what
    ``policy`` saves and runs again in the backward (JAX ``nn.remat`` /
    ``jax.checkpoint``).

    A recomputed forward must see the state the first one saw. The
    tensors ``modules`` hold when the call starts (its parameters, inputs
    of the checkpoint, and its buffers; in a stacked trunk, layer i's
    slices and rows) are swapped in again for the recompute, which runs
    after the caller has put other tensors back. Dropout draws from
    explicit seeds (kernel 5 and the flash kernels key Philox by seed and
    element index), so the masks repeat. The delayed-int8 activation
    amaxes (``amax`` buffers of int8 ``DenseGeneral`` sites) are state the
    forward reads and writes: ``fn`` runs on copies of their values as
    they were before it, and the amaxes it observed are written home once,
    after the first forward. So a recompute quantizes on the scales the
    first forward used and advances nothing, as JAX's functional remat
    carries its ``"quant"`` collection once a step. The delayed dy amaxes
    are written by the backward, which runs once either way; as buffers
    the backward writes, they are held by the recompute, not saved as
    checkpoint inputs (whose versions the checkpoint checks)."""
    subs = [m for module in modules for m in module.modules()]
    params = [(m, name) for m in subs
              for name, t in m._parameters.items() if t is not None]
    bufs = [(m, name) for m in subs
            for name, t in m._buffers.items() if t is not None]
    amax = [j for j, (m, name) in enumerate(bufs)
            if name == "amax" and isinstance(m, DenseGeneral)]
    homes = [m._buffers[name] for m, name in bufs]
    held = [t.detach().clone() if j in amax else t
            for j, t in enumerate(homes)]
    n = len(args)

    def run(*inputs):
        state = [*inputs[n:], *(t.clone() if j in amax else t
                                for j, t in enumerate(held))]
        slots = [(m, "_parameters", name) for m, name in params] + [
            (m, "_buffers", name) for m, name in bufs]
        before = [getattr(m, kind)[name] for m, kind, name in slots]
        for (m, kind, name), t in zip(slots, state):
            getattr(m, kind)[name] = t
        try:
            out = fn(*inputs[:n])
        finally:
            for (m, kind, name), t in zip(slots, before):
                getattr(m, kind)[name] = t
        # what this forward wrote into its amax copies
        return (out, *(state[len(params) + j] for j in amax))

    out, *seen = checkpoint(
        run, *args, *(m._parameters[name] for m, name in params),
        use_reentrant=False, context_fn=_remat_context(policy))
    with torch.no_grad():
        for j, t in zip(amax, seen):
            homes[j].copy_(t)
    return out


def call_layer(layer, cfg: ModelConfig, x, attention_bias, seed, kv=None):
    """One trunk layer: ``layer(x, attention_bias, dropout_seed=seed)``
    (and ``paged=kv`` when given), under per-layer remat when ``cfg.remat``
    and grad is on (JAX ``_layer_cls``: ``nn.remat(BertLayer)``, ``nn.remat
    (GPT2Block)``)."""
    kw = {} if kv is None else {"paged": kv}
    if not (cfg.remat and torch.is_grad_enabled()):
        return layer(x, attention_bias, dropout_seed=seed, **kw)
    return remat_call(
        lambda x, bias: layer(x, bias, dropout_seed=seed, **kw),
        (x, attention_bias), [layer], cfg.remat_policy)


def run_layers(layers, x, attention_bias, dropout_seed=None, first=0):
    """The trunk: layer i draws its dropout from ``fold_in(seed, i + 1)``;
    ``layers`` may be a run of the trunk's layers starting at layer
    ``first`` (a stage of the layer split). Each layer runs under remat
    with ``config.remat`` (``call_layer``), which the pipeline schedules'
    stage forwards reach too (JAX ``gpipe_trunk_fn``'s
    ``jax.checkpoint(fn)``)."""
    for i, layer in enumerate(layers, first):
        x = call_layer(layer, layer.config, x, attention_bias,
                       child_seed(dropout_seed, i + 1))
    return x


class ScannedLayers(nn.Module):
    """The stacked trunk (counterpart: the JAX package's ``nn.scan`` trunk,
    ``layers_scan``): one layer module, ``inner`` (``"layer"`` for BERT,
    ``"block"`` for GPT-2), whose every parameter stacks the ``layers``'
    on a leading [num_layers] dim, so the names are the flax tree's
    (``layers_scan.layer.attention.query.kernel`` <->
    ``layers_scan/layer/attention/query/kernel``).

    The forward takes each stacked parameter apart once (``unbind(0)``,
    whose backward is one ``stack``) and runs the inner module on layer
    i's slices, the parameters swapped in for the call and put back after;
    layer i draws its dropout from ``fold_in(seed, i + 1)``, as
    ``run_layers``, so a scanned and an unscanned model made from one
    generator compute the same values bit for bit. Under ``remat`` layer
    i's call is checkpointed with its slices and rows as inputs
    (``remat_call``; JAX's ``nn.scan`` of ``nn.remat(layer)``)."""

    def __init__(self, layers: list, inner: str):
        super().__init__()
        template = layers[0]
        self.num_layers = len(layers)
        self.inner = inner
        self._slots = []  # (module, parameter name) of every stacked leaf
        for name, _ in list(template.named_parameters()):
            path, _, leaf = name.rpartition(".")
            mod = template.get_submodule(path)
            stacked = torch.stack([layer.get_parameter(name).detach()
                                   for layer in layers])
            setattr(mod, leaf, nn.Parameter(stacked))
            self._slots.append((mod, leaf))
        # the int8 sites' amax buffers stack alike (JAX's variable_axes
        # {"quant": 0}); layer i reads and writes its row in place
        self._buffer_slots = []
        for name, _ in list(template.named_buffers()):
            path, _, leaf = name.rpartition(".")
            mod = template.get_submodule(path)
            mod._buffers[leaf] = torch.stack(
                [layer.get_buffer(name) for layer in layers])
            self._buffer_slots.append((mod, leaf))
        self.add_module(inner, template)

    def forward(self, x, attention_bias=None, dropout_seed=None, paged=None):
        layer = getattr(self, self.inner)
        stacks = [mod._parameters[leaf] for mod, leaf in self._slots]
        slices = [w.unbind(0) for w in stacks]
        buffers = [mod._buffers[leaf] for mod, leaf in self._buffer_slots]
        rows = [b.unbind(0) for b in buffers]
        try:
            for i in range(self.num_layers):
                for (mod, leaf), ws in zip(self._slots, slices):
                    mod._parameters[leaf] = ws[i]
                for (mod, leaf), bs in zip(self._buffer_slots, rows):
                    mod._buffers[leaf] = bs[i]
                x = call_layer(layer, layer.config, x, attention_bias,
                               child_seed(dropout_seed, i + 1),
                               None if paged is None else paged.layer(i))
        finally:
            for (mod, leaf), w in zip(self._slots, stacks):
                mod._parameters[leaf] = w
            for (mod, leaf), b in zip(self._buffer_slots, buffers):
                mod._buffers[leaf] = b
        return x


def make_trunk(cfg: ModelConfig, make_layer, name: str):
    """``cfg.num_layers`` layers from ``make_layer()``, made in order (so
    from one generator the same values either way): an ``nn.ModuleList``,
    or with ``cfg.scan_layers`` their ``ScannedLayers`` under ``name``."""
    layers = [make_layer() for _ in range(cfg.num_layers)]
    if cfg.scan_layers:
        return ScannedLayers(layers, name)
    return nn.ModuleList(layers)


def pool_cls(pooler: "DenseGeneral", x, seq_shard=None,
             dropout: Optional[Dropout] = None, dropout_seed=None):
    """CLS pooling head: [RoBERTa's pre-dropout ->] dense('pooler') -> tanh
    on the first token (under context parallelism, seq coordinate 0's on
    every seq rank). ``dropout`` (RoBERTa) draws from the classifier's
    seed, site ``_SITE_POOL``."""
    cls = broadcast_first(x[:, 0], seq_shard)
    if dropout is not None:
        # the kernel takes a contiguous row block, not x's strided column
        cls = dropout(cls.contiguous(), dropout_seed, _SITE_POOL)
    return torch.tanh(pooler(cls))


def pool_dropout(cfg: ModelConfig) -> Optional[Dropout]:
    """RoBERTa's pre-pooler dropout site (None for BERT)."""
    return dropout_module(cfg) if cfg.roberta_style else None


def classify(dropout: Dropout, classifier: "DenseGeneral", pooled,
             dropout_seed=None):
    """dropout -> float32 dense('classifier') -> logits."""
    return classifier(dropout(pooled, dropout_seed, _SITE_CLASSIFIER).float())


class BertEncoderModel(nn.Module):
    """Embeddings + N layers + pooler -> (sequence_output, pooled_output)."""

    def __init__(self, cfg: ModelConfig, device=None, generator=None):
        super().__init__()
        self.config = cfg
        h = cfg.hidden_size
        self.embeddings = BertEmbeddings(cfg, device, generator)
        trunk = make_trunk(cfg, lambda: BertLayer(cfg, device, generator),
                           "layer")
        if cfg.scan_layers:
            self.layers_scan = trunk
        else:
            self.layers = trunk
        self.pooler = dense(cfg, (h,), (h,), device, generator)
        self.pool_dropout = pool_dropout(cfg)
        self.seq_shard = None  # the seq axis, under context parallelism

    def forward(self, input_ids, attention_mask=None, token_type_ids=None,
                position_ids=None, dropout_seed=None):
        cfg = self.config
        input_ids = input_ids.long()
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        if position_ids is None:
            position_ids = shard_position_ids(cfg, input_ids,
                                              self.seq_shard)
        seed = trunk_seed(dropout_seed, self.seq_shard)
        x = self.embeddings(input_ids, token_type_ids.long(), position_ids,
                            child_seed(seed, 0))
        bias = make_attention_bias(attention_mask)
        if self.config.scan_layers:
            x = self.layers_scan(x, bias, seed)
        else:
            x = run_layers(self.layers, x, bias, seed)
        return x, pool_cls(self.pooler, x, self.seq_shard, self.pool_dropout,
                           child_seed(dropout_seed, cfg.num_layers + 1))


class BertForSequenceClassification(nn.Module):
    """Trunk + dropout + float32 classifier -> logits [batch, num_labels].
    The loss lives in the train step (``train/step.py``)."""

    def __init__(self, cfg: ModelConfig, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if cfg.causal:
            raise ValueError("BertForSequenceClassification needs a "
                             "non-causal config")
        self.config = cfg
        self.bert = BertEncoderModel(cfg, device, generator)
        self.dropout = dropout_module(cfg)
        self.classifier = DenseGeneral(
            (cfg.hidden_size,), (cfg.num_labels,), dtype=torch.float32,
            param_dtype=param_dtype(cfg), device=device, generator=generator,
        )

    def forward(self, input_ids, attention_mask=None, token_type_ids=None,
                position_ids=None, dropout_seed=None):
        _, pooled = self.bert(input_ids, attention_mask, token_type_ids,
                              position_ids, dropout_seed)
        return classify(self.dropout, self.classifier, pooled,
                        child_seed(dropout_seed, self.config.num_layers + 1))
