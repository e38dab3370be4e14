"""Batched sampling for the decode engine (counterpart: the JAX package's
``serve/sampling.py`` ``device_sample`` and ``spec_accept``, and the JAX
engine's host ``_sample``).

Greedy rows (temperature <= 0) take ``argmax`` over the float32 logits,
which returns the FIRST maximum, exactly as the JAX sampler. Sampled rows
divide by the temperature, keep every logit >= the k-th largest (ties
kept; ``top_k`` 0 or >= vocab keeps all; the rest go to ``finfo.min``)
and draw by Gumbel-max: the argmax of the kept logits plus Gumbel noise
made on the host from a ``torch.Generator`` seeded from ``(seed, step)``,
where ``step`` is the number of tokens already emitted for the request.
Fixed-seed streams are reproducible within the port; they differ from
the JAX package's, whose stream is ``fold_in(key(seed), step)``
threefry.

``device_sample`` keeps the logits on the device (the noise goes up, one
[rows, vocab] copy for the sampled rows; an all-greedy batch pays one
argmax, as the JAX sampler's ``lax.cond`` arranges); its uploads are
explicit transfers (``analysis/guards.explicit_transfer``), JAX's
``device_put`` of the sampler's operands. ``host_sample`` is
the engine's ``sampling="host"`` path on float32 logits already copied
to the host, in numpy. Every step of the draw is one IEEE operation a
element (a true division, a comparison, an addition) or exact (the sort,
the argmax), and the noise is the same host tensor, so the two pick the
same token on any device: the contract JAX pins between its in-jit
sampler and its host ``_sample``.
"""

from __future__ import annotations

import numpy as np
import torch

from pytorch_distributed_training_tpu_torch.analysis.guards import (
    explicit_transfer,
)

_NEG = torch.finfo(torch.float32).min


_MASK64 = (1 << 64) - 1


def sample_seed(seed: int, step: int) -> int:
    """The generator seed of request ``seed`` at emission ``step``:
    splitmix64 of ``(seed, step)``, so every bit of both reaches the low 32
    bits (the CPU generator seeds its Mersenne Twister from those alone)."""
    z = ((int(seed) & 0xFFFFFFFF) << 32 | (int(step) & 0xFFFFFFFF))
    z = (z + 0x9E3779B97F4A7C15) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (z ^ (z >> 31)) & ((1 << 63) - 1)


def gumbel_noise(seed: int, step: int, vocab: int) -> torch.Tensor:
    """[vocab] float32 Gumbel(0, 1) noise of request ``seed`` at emission
    ``step``, on the CPU: ``-log(-log(u))`` of uniforms from a
    ``torch.Generator`` seeded with ``sample_seed(seed, step)``."""
    gen = torch.Generator().manual_seed(sample_seed(seed, step))
    u = torch.rand(vocab, generator=gen)
    return -torch.log(-torch.log(u.clamp_min(torch.finfo(u.dtype).tiny)))


def device_sample(logits: torch.Tensor, seeds, steps, temps, top_ks):
    """Next tokens for a batch of slots.

    Args:
        logits: [slots, vocab] float32, on the engine's device.
        seeds, steps: [slots] ints (request seed; tokens already emitted).
        temps: [slots] floats; <= 0 selects greedy.
        top_ks: [slots] ints; 0 (or >= vocab) means no truncation.

    Returns:
        [slots] int64 token ids on ``logits.device``.
    """
    vocab = logits.shape[-1]
    out = torch.argmax(logits, dim=-1)
    temps = np.asarray(temps, np.float32)
    rows = np.flatnonzero(temps > 0.0)
    if rows.size == 0:
        return out
    dev = logits.device
    keep = np.clip(np.asarray(top_ks, np.int64)[rows], 0, vocab)
    with explicit_transfer():
        idx = torch.as_tensor(rows, device=dev)
        temp = torch.as_tensor(temps[rows], device=dev)
        cut = (torch.as_tensor(np.where(keep > 0, vocab - keep, 0),
                               device=dev) if keep.any() else None)
        noise = torch.stack([gumbel_noise(seeds[r], steps[r], vocab)
                             for r in rows]).to(dev)
    # a tensor divisor: a true division a element, as numpy's (a host
    # scalar would take the reciprocal's product on the card)
    scaled = logits[idx] / temp[:, None]
    if cut is not None:
        kth = torch.sort(scaled, dim=-1).values.gather(1, cut[:, None])
        scaled = torch.where(scaled < kth, _NEG, scaled)
    out[idx] = torch.argmax(scaled + noise, dim=-1)
    return out


def host_sample(logits: np.ndarray, seed: int, step: int,
                temperature: float, top_k: int) -> int:
    """One request's next token from its [vocab] float32 logits on the
    host (the engine's ``sampling="host"``; JAX ``DecodeEngine._sample``):
    ``device_sample``'s draw, in numpy."""
    if temperature <= 0.0:
        return int(np.argmax(logits))
    vocab = logits.shape[-1]
    scaled = logits / np.float32(temperature)
    k = min(max(int(top_k), 0), vocab)
    if k > 0:
        kth = np.sort(scaled)[vocab - k]
        scaled = np.where(scaled < kth, np.finfo(np.float32).min, scaled)
    return int(np.argmax(scaled + gumbel_noise(seed, step, vocab).numpy()))


def spec_accept(logits: torch.Tensor, draft: torch.Tensor, seeds, steps0,
                temps, top_ks):
    """Exact-match speculative acceptance over a verify block.

    Row 0 of each slot's block is its pending token's position, rows 1..k
    the draft candidates. Row ``j`` is sampled with the stream of step
    ``steps0 + j`` (the stream the non-speculative engine would use at that
    position), and a draft token is accepted iff it EQUALS that sample;
    acceptance stops at the first mismatch. So the accepted stream is the
    non-speculative stream token for token, greedy or fixed-seed; the draft
    only sets how many positions one dispatch commits.

    Args:
        logits: [slots, q_len, vocab] float32 verify logits.
        draft: [slots, q_len - 1] int64 draft candidates, on the logits'
            device.
        seeds, steps0, temps, top_ks: [slots] host values, as
            ``device_sample`` takes them (``steps0`` is the step of row 0).

    Returns:
        (target [slots, q_len], accept [slots]) int64 on the logits'
        device: per-position samples and the leading-match count; the
        engine emits ``target[s, :accept[s] + 1]``.
    """
    slots, q_len, vocab = logits.shape
    rows = np.arange(q_len)
    target = device_sample(
        logits.reshape(slots * q_len, vocab),
        np.repeat(np.asarray(seeds), q_len),
        (np.asarray(steps0)[:, None] + rows[None, :]).reshape(-1),
        np.repeat(np.asarray(temps, np.float32), q_len),
        np.repeat(np.asarray(top_ks), q_len),
    ).reshape(slots, q_len)
    matches = (target[:, : q_len - 1] == draft).long()
    accept = torch.cumprod(matches, dim=1).sum(dim=1)
    return target, accept
