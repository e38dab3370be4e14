"""On-device batched sampling for the decode engine (counterpart: the JAX
package's ``serve/sampling.py`` ``device_sample``).

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
