"""Attention stack shared by the model families (counterpart: the JAX
package's ``models/bert.py``; this slice ports what GPT-2 serving runs).

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
from torch import nn

from pytorch_distributed_training_tpu_torch.ops.attention import (
    dot_product_attention,
)
from pytorch_distributed_training_tpu_torch.ops.layer_norm import FusedLayerNorm
from pytorch_distributed_training_tpu_torch.ops.paged_attention import (
    paged_attention,
)
from pytorch_distributed_training_tpu_torch.utils.config import ModelConfig

_NEG = torch.finfo(torch.float32).min


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

    def forward(self, x, attention_bias=None, paged=None):
        """``paged``: None for full-sequence attention, else ``(k_pages,
        v_pages, block_table, context_len)`` for this layer."""
        cfg = self.config
        q = self.query(x)
        k = self.key(x)
        v = self.value(x)
        if paged is not None:
            out = self._paged_attend(q, k, v, attention_bias, *paged)
        else:
            out = dot_product_attention(
                q, k, v, attention_bias, impl=cfg.attention_impl,
                causal=cfg.causal,
            )
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
