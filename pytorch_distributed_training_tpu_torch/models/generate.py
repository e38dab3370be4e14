"""Autoregressive generation for the causal LM over the dense decode cache
(counterpart: the JAX package's ``models/generate.py``).

One forward over the whole prompt fills the cache (prefill,
``models/bert.DenseKV``), then one forward a new token attends over it:
O(L) a token instead of re-running the prefix. Greedy (temperature 0) or
temperature and top-k sampling on an explicit ``torch.Generator``. JAX's
``lax.scan`` is a plain loop here; the last token's forward, whose logits
JAX's scan computes and drops, is not run.

Prompt batches are right-padded. Each row's first token comes from its
own last real prompt position (``prompt_lengths``), pad positions are
masked out of attention, and continuations are written at columns
``[prompt_len, prompt_len + max_new_tokens)``. Decode steps pass per-row
position ids ``prompt_lengths + t``, so a row's continuation is the one it
generates alone, unpadded. A model with the scanned trunk is re-laid out
once (``models/relayout.py``) and decodes per layer.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from pytorch_distributed_training_tpu_torch.models.bert import DenseKV


def _sample(logits: torch.Tensor, generator: Optional[torch.Generator],
            temperature: float, top_k: int) -> torch.Tensor:
    """logits [B, V] float32 -> token ids [B] (JAX ``_sample``): argmax at
    temperature 0; else the logits over ``temperature``, those below the
    k-th largest set to ``finfo.min`` (``top_k`` > 0), then a categorical
    draw (Gumbel-max on uniforms from ``generator``)."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    logits = logits / temperature
    if top_k > 0:
        kth = torch.topk(logits, top_k, dim=-1).values[:, -1:]
        logits = torch.where(logits < kth, torch.finfo(logits.dtype).min,
                             logits)
    u = torch.rand(logits.shape, generator=generator,
                   device=generator.device).to(logits.device)
    gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(u.dtype).tiny)))
    return torch.argmax(logits + gumbel, dim=-1)


def generate(model, prompt_ids, *, max_new_tokens: int,
             prompt_lengths=None, temperature: float = 0.0, top_k: int = 0,
             generator: Optional[torch.Generator] = None,
             eot_id: Optional[int] = None) -> torch.Tensor:
    """Continuations of a batch of right-padded prompts.

    ``model``: a ``GPT2LMModel`` (scanned or not), on its device.
    ``prompt_ids``: [batch, prompt_len] ints (numpy or a tensor).
    ``prompt_lengths``: [batch] real lengths (default: full rows).
    ``temperature`` 0 is greedy; above 0 samples with ``generator``
    (required then), keeping the ``top_k`` largest logits (0: all).
    ``eot_id``: a row that emits it keeps emitting it.

    Returns [batch, prompt_len + max_new_tokens] int64 on the model's
    device: the padded prompts, then the continuations."""
    from pytorch_distributed_training_tpu_torch.models.gpt2 import unscanned

    cfg = model.config
    if not cfg.causal:
        raise ValueError("generate() needs a causal model")
    if temperature > 0.0 and generator is None:
        raise ValueError("temperature sampling needs a generator")
    model = unscanned(model)
    device = model.wte.embedding.device
    prompt = torch.as_tensor(np.asarray(prompt_ids), dtype=torch.long,
                             device=device)
    batch, prompt_len = prompt.shape
    total = prompt_len + max_new_tokens
    if total > cfg.max_position_embeddings:
        raise ValueError(
            f"prompt_len + max_new_tokens = {total} exceeds "
            f"max_position_embeddings {cfg.max_position_embeddings}")
    lengths = (torch.full((batch,), prompt_len, dtype=torch.long,
                          device=device) if prompt_lengths is None
               else torch.as_tensor(np.asarray(prompt_lengths),
                                    dtype=torch.long, device=device))
    positions = torch.arange(total, device=device)[None, :]

    def mask_upto(n_generated: int) -> torch.Tensor:
        """Each row's real prompt and its first ``n_generated`` tokens,
        over the whole buffer."""
        return ((positions < lengths[:, None])
                | ((positions >= prompt_len)
                   & (positions < prompt_len + n_generated))).long()

    out = torch.zeros((batch, total), dtype=torch.long, device=device)
    out[:, :prompt_len] = prompt
    cache = DenseKV.zeros(cfg, batch, total, device)
    with torch.inference_mode():
        logits = model(prompt, mask_upto(0), cache=cache)
        last = logits[torch.arange(batch, device=device),
                      lengths - 1].float()
        done = torch.zeros(batch, dtype=torch.bool, device=device)
        for t in range(max_new_tokens):
            nxt = _sample(last, generator, temperature, top_k)
            if eot_id is not None:
                nxt = torch.where(done, eot_id, nxt)
                done = done | (nxt == eot_id)
            out[:, prompt_len + t] = nxt
            if t + 1 == max_new_tokens:
                break
            logits = model(nxt[:, None], mask_upto(t + 1),
                           position_ids=(lengths + t)[:, None], cache=cache)
            last = logits[:, 0].float()
    return out
