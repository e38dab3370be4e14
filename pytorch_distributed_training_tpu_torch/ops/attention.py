"""Full-sequence attention (counterpart: the JAX package's
``ops/attention.py``).

``make_attention_bias`` and the plain ``"reference"`` implementation:
fp32 scores and softmax whatever the input dtype, ``finfo.min`` masking,
probs cast to the V dtype. q/k/v are [batch, seq, heads, head_dim] as in
the JAX package. Probability dropout follows the JAX package's order for
the ``"kernel"`` dropout impl: cast the fp32 probs to the V dtype first,
then multiply by the mask-scale tensor (``ops/dropout.py``), so the mask
saved for the backward is half-width. ``"flash"`` goes to
``ops/flash_attention.flash_attention`` (the flash kernels).
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
                        dropout_site: int = 0):
    """Plain einsum attention; softmax in fp32 regardless of input dtype.
    ``dropout_seed`` None is deterministic."""
    scale = q.shape[-1] ** -0.5
    scores = torch.einsum("bsnd,btnd->bnst", q.float(), k.float()) * scale
    if bias is not None:
        scores = scores + bias.float()
    if causal:
        scores = scores + causal_bias(q.shape[-3], k.shape[-3],
                                      device=q.device)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    if dropout_seed is not None and dropout_rate > 0.0:
        probs = raw_dropout(probs, dropout_rate, dropout_seed, dropout_site)
    return torch.einsum("bnst,btnd->bsnd", probs, v)


def dot_product_attention(q, k, v, bias=None, *, impl: str = "reference",
                          causal: bool = False, dropout_rate: float = 0.0,
                          dropout_seed: Optional[int] = None,
                          dropout_site: int = 0):
    """Dispatch to the configured attention implementation."""
    if impl == "reference":
        return reference_attention(
            q, k, v, bias, causal=causal, dropout_rate=dropout_rate,
            dropout_seed=dropout_seed, dropout_site=dropout_site,
        )
    if impl == "flash":
        from pytorch_distributed_training_tpu_torch.ops.flash_attention import (
            flash_attention,
        )

        return flash_attention(
            q, k, v, bias, causal=causal, dropout_rate=dropout_rate,
            dropout_seed=dropout_seed, dropout_site=dropout_site,
        )
    raise ValueError(f"unknown attention impl {impl!r}")
