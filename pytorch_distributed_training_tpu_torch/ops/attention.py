"""Full-sequence attention (counterpart: the JAX package's
``ops/attention.py``).

``make_attention_bias`` and the plain ``"reference"`` implementation:
fp32 scores and softmax whatever the input dtype, ``finfo.min`` masking,
probs cast to the V dtype. q/k/v are [batch, seq, heads, head_dim] as in
the JAX package. Probability dropout follows the JAX package's order for
its stream (``dropout_impl``, ``ops/dropout.py``): ``"exact"`` masks the
float32 probs and then casts them (flax's order); every other stream casts
the probs to the V dtype first and then masks them. ``"flash"`` goes to
``ops/flash_attention.flash_attention`` (the flash kernels), ``"ring"``
to ``ops/ring_attention.ring_attention_shard`` over the seq axis ``seq``
(reference attention when it is None, JAX's fallback at a seq axis of 1);
the flash kernels keep their in-kernel mask whatever the stream, which
reaches only their plain-attention fallback (as in JAX).
"""

from __future__ import annotations

from typing import Optional

import torch

from pytorch_distributed_training_tpu_torch.ops.dropout import raw_dropout


def make_attention_bias(attention_mask: Optional[torch.Tensor], *,
                        dtype=torch.float32) -> Optional[torch.Tensor]:
    """[batch, kv_len] 1/0 mask -> additive bias [batch, 1, 1, kv_len]."""
    if attention_mask is None:
        return None
    neg = torch.finfo(dtype).min
    bias = torch.where(attention_mask[:, None, None, :] > 0, 0.0, neg)
    return bias.to(dtype)


def causal_bias(q_len: int, kv_len: int, *, device=None,
                dtype=torch.float32) -> torch.Tensor:
    i = torch.arange(q_len, device=device)[:, None]
    j = torch.arange(kv_len, device=device)[None, :]
    neg = torch.finfo(dtype).min
    return torch.where(j <= i, 0.0, neg).to(dtype)[None, None, :, :]


def reference_attention(q, k, v, bias=None, *, causal: bool = False,
                        dropout_rate: float = 0.0,
                        dropout_seed: Optional[int] = None,
                        dropout_site: int = 0, dropout_impl: str = "kernel"):
    """Plain einsum attention; softmax in fp32 regardless of input dtype.
    ``dropout_seed`` None is deterministic."""
    scale = q.shape[-1] ** -0.5
    scores = torch.einsum("bsnd,btnd->bnst", q.float(), k.float()) * scale
    if bias is not None:
        scores = scores + bias.float()
    if causal:
        scores = scores + causal_bias(q.shape[-3], k.shape[-3],
                                      device=q.device)
    probs = torch.softmax(scores, dim=-1)
    if dropout_seed is not None and dropout_rate > 0.0:
        drop = (dropout_rate, dropout_seed, dropout_site, dropout_impl)
        if dropout_impl == "exact":
            probs = raw_dropout(probs, *drop).to(v.dtype)
        else:
            probs = raw_dropout(probs.to(v.dtype), *drop)
    else:
        probs = probs.to(v.dtype)
    return torch.einsum("bnst,btnd->bsnd", probs, v)


def dot_product_attention(q, k, v, bias=None, *, impl: str = "reference",
                          causal: bool = False, dropout_rate: float = 0.0,
                          dropout_seed: Optional[int] = None,
                          dropout_site: int = 0, seq=None,
                          dropout_impl: str = "kernel"):
    """Dispatch to the configured attention implementation (``seq``: the
    ``AxisShard`` of the seq axis the sequence is cut over, for
    ``"ring"``) and ``dropout_impl`` its probabilities' mask stream."""
    drop = dict(dropout_rate=dropout_rate, dropout_seed=dropout_seed,
                dropout_site=dropout_site, dropout_impl=dropout_impl)
    if impl == "reference":
        return reference_attention(q, k, v, bias, causal=causal, **drop)
    if impl == "flash":
        from pytorch_distributed_training_tpu_torch.ops.flash_attention import (
            flash_attention,
        )

        return flash_attention(q, k, v, bias, causal=causal, **drop)
    if impl == "ring":
        from pytorch_distributed_training_tpu_torch.ops.ring_attention import (
            ring_attention_shard,
        )

        return ring_attention_shard(q, k, v, bias, seq=seq, causal=causal,
                                    **drop)
    raise ValueError(f"unknown attention impl {impl!r}")
