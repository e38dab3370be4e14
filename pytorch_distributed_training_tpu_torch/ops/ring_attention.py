"""Ring attention: context parallelism over the mesh's ``seq`` axis
(counterpart: the JAX package's ``ops/ring_attention.py``).

Each seq rank holds a contiguous block of the sequence (``data/
pipeline.py`` cuts the columns). Attention is the one op that needs every
key: each rank keeps its query block for the whole pass while the K/V
blocks and the key-padding bias hop around the ring, one hop left a step
(``comms/collectives.ring_hop``, one batched ``isend``/``irecv`` a step;
its backward sends the gradients the other way, as JAX transposes
``ppermute``), and the blocks are merged with the online softmax of the
flash kernels. The math is JAX's, step by step:

- ``_local_block``: one (query block) × (one hop's K/V) block: float32
  scores, the key-padding bias, a causal mask at GLOBAL positions (shard
  offset + local index, ``-1e30`` above the diagonal), the row max, the
  exponentials and their sum (the denominator, taken before dropout), the
  probabilities cast to the V dtype, then dropout, then the float32
  product with V.
- ``_ring_shard_body``: the running (max, sum, accumulator) over the hops,
  step j holding the block of shard ``(my + j) % P``; the dropout seed of
  step j is ``fold_in(fold_in(seed, j), my)``, JAX's ``fold_in(fold_in(
  rng, j), my)``, through ``raw_dropout`` (kernel 5 on the card); then
  ``acc / max(l, 1e-30)``. The hop is a parameter: ``ring_attention_shard``
  passes the ring's exchange, ``ring_attention`` hands shard ``my`` the
  block of shard ``my + j + 1`` from the whole tensors, so one process
  drives the P shards in turn (the tests, ``chip_smoke.py``'s ``ring``
  phase).
- ``ring_attention``: whole [B, S, N, D] tensors cut into ``n_shards``
  shards in this process; JAX's three fallbacks to ``reference_attention``
  (one shard, a bias not of the key-padding form [B, 1, 1, S], S not
  divisible by the shards).
- ``ring_attention_shard``: this rank's shard over an ``AxisShard`` of the
  seq axis (``comms/mesh.Mesh.shard``), the model's path
  (``ops/attention.dot_product_attention(impl="ring")``); a seq axis of
  one rank is JAX's first fallback. With the sequence already cut there is
  no whole sequence to fall back to, so another bias raises.

The per-hop products are ``torch.einsum`` on float32 operands: JAX
computes them with ``jnp.einsum`` outside any Pallas kernel, so no CUDA
kernel belongs here; the probabilities' dropout is kernel 5's.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from pytorch_distributed_training_tpu_torch.comms.collectives import ring_hop
from pytorch_distributed_training_tpu_torch.ops.attention import (
    reference_attention,
)
from pytorch_distributed_training_tpu_torch.ops.dropout import (
    fold_in,
    raw_dropout,
)

_NEG_INF = -1e30


def _local_block(q, k, v, bias, *, scale, q_offset, kv_offset, causal,
                 dropout_seed, dropout_rate, dropout_site, dropout_impl):
    """Scores and online-softmax partials of one (local Q) × (one hop's
    K/V) block: q [B, Sq, N, D], k/v [B, Skv, N, D], bias [B, 1, 1, Skv]
    or None. Returns (m, l, pv): the row max [B, N, Sq], the denominator's
    partial [B, N, Sq] and the weighted values [B, Sq, N, D], float32."""
    s = torch.einsum("bsnd,btnd->bnst", q.float(), k.float()) * scale
    if bias is not None:
        s = s + bias.float()
    if causal:
        sq, skv = q.shape[1], k.shape[1]
        q_pos = q_offset + torch.arange(sq, device=q.device)[:, None]
        k_pos = kv_offset + torch.arange(skv, device=q.device)[None, :]
        s = s + torch.where(k_pos <= q_pos, 0.0, _NEG_INF)[None, None]
    m = torch.amax(s, dim=-1)
    p = torch.exp(s - m[..., None])
    l = torch.sum(p, dim=-1)  # the denominator from the undropped p
    # cast before dropout whatever the stream, as JAX's ring does
    p = p.to(v.dtype)
    if dropout_rate > 0.0:
        p = raw_dropout(p, dropout_rate, dropout_seed, dropout_site,
                        dropout_impl)
    pv = torch.einsum("bnst,btnd->bsnd", p.float(), v.float())
    return m, l, pv


def _ring_shard_body(q, k, v, bias, *, scale: float, n_shards: int, my: int,
                     causal: bool, hop: Callable,
                     dropout_seed: Optional[int] = None,
                     dropout_rate: float = 0.0, dropout_site: int = 0,
                     dropout_impl: str = "kernel"):
    """Shard ``my``'s output: its query block stays, and ``hop(j, k, v,
    bias)`` returns the K/V/bias block it holds at step ``j + 1`` (the
    block of shard ``(my + j + 1) % n_shards``)."""
    seq_local = q.shape[1]
    m_run = torch.full((q.shape[0], q.shape[2], seq_local), _NEG_INF,
                       dtype=torch.float32, device=q.device)  # [B, N, Sq]
    l_run = torch.zeros_like(m_run)
    acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    k_cur, v_cur, bias_cur = k, v, bias
    for j in range(n_shards):
        src = (my + j) % n_shards  # the shard whose block is held now
        m_j, l_j, pv_j = _local_block(
            q, k_cur, v_cur, bias_cur, scale=scale,
            q_offset=my * seq_local, kv_offset=src * seq_local,
            causal=causal,
            dropout_seed=(fold_in(fold_in(dropout_seed, j), my)
                          if dropout_rate > 0.0 else None),
            dropout_rate=dropout_rate, dropout_site=dropout_site,
            dropout_impl=dropout_impl,
        )
        m_new = torch.maximum(m_run, m_j)
        alpha = torch.exp(m_run - m_new)
        beta = torch.exp(m_j - m_new)
        l_run = l_run * alpha + l_j * beta
        # acc is [B, Sq, N, D], the statistics [B, N, Sq]
        acc = (acc * alpha.transpose(1, 2)[..., None]
               + pv_j * beta.transpose(1, 2)[..., None])
        m_run = m_new
        if j + 1 < n_shards:
            k_cur, v_cur, bias_cur = hop(j, k_cur, v_cur, bias_cur)
    l_safe = torch.clamp(l_run, min=1e-30)
    return (acc / l_safe.transpose(1, 2)[..., None]).to(q.dtype)


def _rate(dropout_rate: float, dropout_seed: Optional[int]) -> float:
    return dropout_rate if dropout_seed is not None else 0.0


def _key_padding(bias) -> bool:
    return bias is None or (bias.dim() == 4 and bias.shape[1] == 1
                            and bias.shape[2] == 1)


def ring_attention(q, k, v, bias=None, *, n_shards: int = 1,
                   causal: bool = False, dropout_rate: float = 0.0,
                   dropout_seed: Optional[int] = None,
                   dropout_site: int = 0, dropout_impl: str = "kernel"):
    """Ring attention over whole [B, S, N, D] tensors, the sequence cut
    into ``n_shards`` shards driven one after another in this process
    (what the ranks of a seq axis of ``n_shards`` compute, each shard's
    output in its columns). ``dropout_seed`` None is deterministic."""
    if n_shards == 1 or not _key_padding(bias) or q.shape[1] % n_shards:
        return reference_attention(
            q, k, v, bias, causal=causal, dropout_rate=dropout_rate,
            dropout_seed=dropout_seed, dropout_site=dropout_site,
            dropout_impl=dropout_impl)
    ks, vs = k.chunk(n_shards, dim=1), v.chunk(n_shards, dim=1)
    bs = ([None] * n_shards if bias is None
          else bias.chunk(n_shards, dim=3))
    outs = []
    for my, q_my in enumerate(q.chunk(n_shards, dim=1)):
        def hop(j, k_cur, v_cur, bias_cur, my=my):
            at = (my + j + 1) % n_shards
            return ks[at], vs[at], bs[at]

        outs.append(_ring_shard_body(
            q_my, ks[my], vs[my], bs[my], scale=q.shape[-1] ** -0.5,
            n_shards=n_shards, my=my, causal=causal, hop=hop,
            dropout_seed=dropout_seed,
            dropout_rate=_rate(dropout_rate, dropout_seed),
            dropout_site=dropout_site, dropout_impl=dropout_impl))
    return torch.cat(outs, dim=1)


def ring_attention_shard(q, k, v, bias=None, *, seq=None,
                         causal: bool = False, dropout_rate: float = 0.0,
                         dropout_seed: Optional[int] = None,
                         dropout_site: int = 0, dropout_impl: str = "kernel"):
    """Ring attention on this rank's shard of the sequence: q/k/v [B,
    S/P, N, D] and the key-padding bias [B, 1, 1, S/P] of coordinate
    ``seq.index`` of the seq axis ``seq`` (an ``AxisShard``; None: a seq
    axis of one rank, plain reference attention)."""
    if seq is None:
        return reference_attention(
            q, k, v, bias, causal=causal, dropout_rate=dropout_rate,
            dropout_seed=dropout_seed, dropout_site=dropout_site,
            dropout_impl=dropout_impl)
    if not _key_padding(bias):
        raise ValueError(
            f"ring attention over a seq axis of {seq.size} takes a "
            f"key-padding bias [B, 1, 1, S] or none, got "
            f"{tuple(bias.shape)}")

    def hop(j, k_cur, v_cur, bias_cur):
        return ring_hop(k_cur, v_cur, bias_cur, shard=seq)

    return _ring_shard_body(
        q, k, v, bias, scale=q.shape[-1] ** -0.5, n_shards=seq.size,
        my=seq.index, causal=causal, hop=hop, dropout_seed=dropout_seed,
        dropout_rate=_rate(dropout_rate, dropout_seed),
        dropout_site=dropout_site, dropout_impl=dropout_impl)
