"""On-device batched sampling for the decode engine (counterpart: the JAX
package's ``serve/sampling.py`` ``device_sample`` and ``spec_accept``).

Greedy rows (temperature <= 0) take ``argmax`` over the float32 logits,
which returns the FIRST maximum, exactly as the JAX sampler. Sampled rows
scale by temperature, keep every logit >= the k-th largest (ties kept;
``top_k`` 0 or >= vocab keeps all), and draw from the softmax with a
``torch.Generator`` seeded from ``(seed, step)``, where ``step`` is the
number of tokens already emitted for the request. Fixed-seed streams are
reproducible within the port; they differ from the JAX package's, whose
stream is ``fold_in(key(seed), step)`` threefry.

The per-row sampling parameters are host values (the engine builds them on
the host each tick); the logits never leave the device. An all-greedy
batch pays one argmax, as the JAX sampler's ``lax.cond`` arranges.
"""

from __future__ import annotations

import numpy as np
import torch

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
    for r in rows:
        scaled = logits[r] / float(temps[r])
        k = min(max(int(top_ks[r]), 0), vocab)
        if k > 0:
            kth = torch.sort(scaled).values[vocab - k]
            scaled = torch.where(scaled < kth, _NEG, scaled)
        gen = torch.Generator(device=logits.device)
        gen.manual_seed(sample_seed(seeds[r], steps[r]))
        probs = torch.softmax(scaled, dim=-1)
        out[r] = torch.multinomial(probs, 1, generator=gen)[0]
    return out


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
