"""BERT encoder family and the attention stack shared with GPT-2
(counterpart: the JAX package's ``models/bert.py``).

- ``Embed``: flax ``nn.Embed``, an ``embedding`` table looked up in the
  compute dtype.

- ``DenseGeneral``: the flax ``nn.DenseGeneral`` layout — ``kernel`` of
  shape ``in_shape + out_shape`` and ``bias`` of ``out_shape`` — so the
  weight bridge (``models/convert.py``) is a rename, not a relayout. The
  matmul runs in the compute dtype, as flax casts inputs and weights.
- ``BertSelfAttention``: separate ``query``/``key``/``value`` projections
  to [heads, head_dim] and an ``out`` projection back; full-sequence
  attention through ``ops/attention.py``, or the PAGED branch when the
  caller passes the layer's page pools (``PagedKV``):

  * prefill (chunk > 1): the sequence is fresh (context_len == 0), its
    block-table row covers the chunk; K/V is scattered into its pages and
    attention is intra-chunk causal with the dense-cache formula (fp32
    scores, ``finfo.min`` mask, fp32 softmax, probs in the V dtype);
  * decode (chunk == 1): one token appended at ``context_len``, then
    ``ops/paged_attention.paged_attention`` over the whole context. Idle
    rows park on the null page 0; their outputs are ignored by the engine.

  Full-sequence attention takes a dropout seed (probs dropout, site 2 of
  the layer's seed) and, with ``attention_remat``, recomputes its core in
  the backward under ``torch.utils.checkpoint``; the seed is an explicit
  input of the core, so the recomputed mask is the forward's.
- ``BertLayer``: the post-LN block. Attention, then the fused
  dropout-add-LayerNorm tail (``attention_norm``, site 0), the MLP with
  tanh GELU when ``gelu_approximate``, and the second tail (``mlp_norm``,
  site 1); both tails share the layer's seed.
- ``BertForSequenceClassification``: embeddings (word + position + token
  type, LayerNorm, dropout) -> layers -> CLS pooler (dense, tanh) ->
  dropout -> float32 classifier on the float32 pooled output.

Dropout seeds: ``forward(..., dropout_seed=None)`` is deterministic; a
seed gives the embeddings ``fold_in(seed, 0)``, layer i ``fold_in(seed,
i + 1)`` and the classifier ``fold_in(seed, num_layers + 1)``, the
counterpart of the distinct flax ``make_rng("dropout")`` keys per module.

The page pools are tensors the serving engine owns and passes in; the
scatter writes them in place (the JAX package returns new pools, which
XLA updates in place through donation). The dense cache, the multi-token
query and int8 pools are not ported yet.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

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
from pytorch_distributed_training_tpu_torch.utils.config import ModelConfig

_NEG = torch.finfo(torch.float32).min
# dropout sites within one layer's seed: the two tails, then the probs
_SITE_ATTENTION_NORM, _SITE_MLP_NORM, _SITE_PROBS = 0, 1, 2


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.compute_dtype)


def param_dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.param_dtype)


def layer_norm_module(cfg: ModelConfig, device=None) -> FusedLayerNorm:
    """LayerNorm with fp32 stats emitting the compute dtype directly."""
    return FusedLayerNorm(
        cfg.hidden_size, eps=cfg.layer_norm_eps, out_dtype=compute_dtype(cfg),
        param_dtype=param_dtype(cfg), device=device,
    )


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
    context length [batch] int32 (tokens already in the pages)."""

    pools: list
    block_table: torch.Tensor
    context_len: torch.Tensor


class DenseGeneral(nn.Module):
    """flax ``DenseGeneral`` over the trailing ``len(in_shape)`` axes."""

    def __init__(self, in_shape: tuple, out_shape: tuple, *,
                 dtype: torch.dtype, param_dtype: torch.dtype, device=None,
                 generator: Optional[torch.Generator] = None):
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

    def forward(self, x):
        n_in = len(self.in_shape)
        lead = x.shape[: x.dim() - n_in]
        w = self.kernel.to(self.dtype).reshape(
            math.prod(self.in_shape), math.prod(self.out_shape)
        )
        y = torch.matmul(x.to(self.dtype).reshape(*lead, w.shape[0]), w)
        # bias added after the product's rounding, as flax does
        y = y + self.bias.to(self.dtype).reshape(-1)
        return y.reshape(*lead, *self.out_shape)


def dense(cfg: ModelConfig, in_shape, out_shape, device=None, generator=None):
    return DenseGeneral(
        in_shape, out_shape, dtype=compute_dtype(cfg),
        param_dtype=param_dtype(cfg), device=device, generator=generator,
    )


class BertSelfAttention(nn.Module):
    def __init__(self, cfg: ModelConfig, device=None, generator=None):
        super().__init__()
        self.config = cfg
        h = cfg.hidden_size
        heads = (cfg.num_heads, cfg.head_dim)
        self.query = dense(cfg, (h,), heads, device, generator)
        self.key = dense(cfg, (h,), heads, device, generator)
        self.value = dense(cfg, (h,), heads, device, generator)
        self.out = dense(cfg, heads, (h,), device, generator)

    def forward(self, x, attention_bias=None, paged=None, dropout_seed=None):
        """``paged``: None for full-sequence attention, else ``(k_pages,
        v_pages, block_table, context_len)`` for this layer.
        ``dropout_seed``: the layer's seed for probs dropout (None is
        deterministic)."""
        cfg = self.config
        q = self.query(x)
        k = self.key(x)
        v = self.value(x)
        if paged is not None:
            out = self._paged_attend(q, k, v, attention_bias, *paged)
        else:
            def core(q, k, v, bias, seed):
                return dot_product_attention(
                    q, k, v, bias, impl=cfg.attention_impl,
                    causal=cfg.causal, dropout_rate=cfg.attention_dropout,
                    dropout_seed=seed, dropout_site=_SITE_PROBS,
                )

            if (cfg.attention_remat and cfg.attention_impl == "reference"
                    and torch.is_grad_enabled()):
                # recompute scores, softmax and the probs mask in the
                # backward instead of saving the [B, N, S, S] probs
                out = checkpoint(core, q, k, v, attention_bias, dropout_seed,
                                 use_reentrant=False)
            else:
                out = core(q, k, v, attention_bias, dropout_seed)
        return self.out(out)

    def _paged_attend(self, q, k, v, attention_bias, k_pages, v_pages,
                      block_table, context_len):
        if not self.config.causal:
            raise ValueError("paged attention requires a causal model")
        batch, chunk, heads, head_dim = q.shape
        page_size = k_pages.shape[1]
        # scatter this chunk's K/V through the block table: position idx+j
        # lives at page bt[b, (idx+j)//P], offset (idx+j)%P
        pos = context_len[:, None] + torch.arange(
            chunk, dtype=context_len.dtype, device=q.device
        )[None, :]
        page_ids = torch.gather(block_table, 1, (pos // page_size).long())
        offs = pos % page_size
        kc = k.to(k_pages.dtype)
        vc = v.to(v_pages.dtype)
        k_pages[page_ids.long(), offs.long()] = kc
        v_pages[page_ids.long(), offs.long()] = vc
        scale = head_dim ** -0.5
        if chunk == 1:
            if attention_bias is not None:
                raise ValueError(
                    "paged decode steps take no attention bias (padding is "
                    "expressed through context_len)"
                )
            out = paged_attention(
                q[:, 0], k_pages, v_pages, block_table, context_len + 1,
                scale=scale,
            )
            return out[:, None]
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
        device=device,
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
        self.dropout = Dropout(cfg.hidden_dropout)

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
                            generator)
        self.mlp_down = dense(cfg, (cfg.intermediate_size,), (h,), device,
                              generator)
        self.mlp_norm = _dal(cfg, _SITE_MLP_NORM, device)

    def forward(self, x, attention_bias=None, dropout_seed=None):
        attn_out = self.attention(x, attention_bias,
                                  dropout_seed=dropout_seed)
        x = self.attention_norm(attn_out, x, dropout_seed)
        h = self.mlp_up(x)
        h = F.gelu(h, approximate="tanh" if self.config.gelu_approximate
                   else "none")
        h = self.mlp_down(h)
        return self.mlp_norm(h, x, dropout_seed)


def default_position_ids(cfg: ModelConfig, input_ids):
    """BERT position ids: arange over the sequence, checked against the
    position table."""
    batch, seq = input_ids.shape
    if seq > cfg.max_position_embeddings:
        raise ValueError(
            f"sequence length {seq} needs position ids up to {seq - 1} "
            f"but max_position_embeddings is {cfg.max_position_embeddings}"
        )
    return torch.arange(seq, device=input_ids.device)[None, :].expand(
        batch, seq
    )


def _child_seed(seed: Optional[int], index: int) -> Optional[int]:
    return None if seed is None else fold_in(seed, index)


def run_layers(layers, x, attention_bias, dropout_seed=None):
    """The trunk: layer i draws its dropout from ``fold_in(seed, i + 1)``."""
    for i, layer in enumerate(layers):
        x = layer(x, attention_bias, _child_seed(dropout_seed, i + 1))
    return x


def pool_cls(pooler: "DenseGeneral", x):
    """CLS pooling head: dense('pooler') -> tanh on the first token."""
    return torch.tanh(pooler(x[:, 0]))


def classify(dropout: Dropout, classifier: "DenseGeneral", pooled,
             dropout_seed=None):
    """dropout -> float32 dense('classifier') -> logits."""
    return classifier(dropout(pooled, dropout_seed).float())


class BertEncoderModel(nn.Module):
    """Embeddings + N layers + pooler -> (sequence_output, pooled_output)."""

    def __init__(self, cfg: ModelConfig, device=None, generator=None):
        super().__init__()
        self.config = cfg
        h = cfg.hidden_size
        self.embeddings = BertEmbeddings(cfg, device, generator)
        self.layers = nn.ModuleList(
            BertLayer(cfg, device, generator) for _ in range(cfg.num_layers)
        )
        self.pooler = dense(cfg, (h,), (h,), device, generator)

    def forward(self, input_ids, attention_mask=None, token_type_ids=None,
                position_ids=None, dropout_seed=None):
        cfg = self.config
        input_ids = input_ids.long()
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        if position_ids is None:
            position_ids = default_position_ids(cfg, input_ids)
        x = self.embeddings(input_ids, token_type_ids.long(), position_ids,
                            _child_seed(dropout_seed, 0))
        bias = make_attention_bias(attention_mask)
        x = run_layers(self.layers, x, bias, dropout_seed)
        return x, pool_cls(self.pooler, x)


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
        self.dropout = Dropout(cfg.hidden_dropout)
        self.classifier = DenseGeneral(
            (cfg.hidden_size,), (cfg.num_labels,), dtype=torch.float32,
            param_dtype=param_dtype(cfg), device=device, generator=generator,
        )

    def forward(self, input_ids, attention_mask=None, token_type_ids=None,
                position_ids=None, dropout_seed=None):
        _, pooled = self.bert(input_ids, attention_mask, token_type_ids,
                              position_ids, dropout_seed)
        return classify(self.dropout, self.classifier, pooled,
                        _child_seed(dropout_seed, self.config.num_layers + 1))
