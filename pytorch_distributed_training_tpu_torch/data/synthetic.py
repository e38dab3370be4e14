"""Deterministic synthetic tasks for offline runs (counterpart: the JAX
package's ``data/synthetic.py`` ``synthetic_pair_task`` and
``synthetic_lm_task``, whose streams this copy keeps byte for byte).

Same tensor contract and split sizes as GLUE/MRPC (3668 train / 408
validation). Binary: label 1 = segment B is segment A with ~15% token
noise (a "paraphrase"), label 0 = unrelated tokens, so the task is
learnable. Multi-class (MNLI-shaped): graded noise drawn from a
per-class marker band at the bottom of the vocab.
"""

from __future__ import annotations

import numpy as np

from pytorch_distributed_training_tpu_torch.data.tokenizer import (
    PAD_ID,
    SEP_ID,
    assemble_pair_row,
)

MRPC_TRAIN_SIZE = 3668
MRPC_EVAL_SIZE = 408
MARKER_BAND = 64  # per-class marker sub-vocab width for multi-class tasks


def synthetic_lm_task(
    n_examples: int,
    *,
    max_length: int = 128,
    vocab_size: int = 50257,
    seed: int = 42,
    order: int = 1,
    row_seed: int | None = None,
) -> dict[str, np.ndarray]:
    """{input_ids, attention_mask} int32 rows of a learnable causal-LM
    corpus: a fixed random order-``order`` Markov chain over a 256-token
    alphabet (tokens 2..257, each context preferring 4 successors),
    embedded in the full vocab; dense rows, no padding. The transition
    table depends only on ``seed``; ``row_seed`` (when given) seeds an
    independent stream for the rows, so disjoint splits of one chain are
    each made at their own size."""
    rng = np.random.default_rng(seed)
    alphabet = 256
    table = rng.dirichlet(np.full(4, 0.5), size=alphabet**order)
    cum = table.cumsum(axis=1)
    prefs = rng.integers(0, alphabet, size=(alphabet**order, 4))
    if row_seed is not None:
        rng = np.random.default_rng(row_seed)

    ids = np.empty((n_examples, max_length), np.int64)
    ids[:, :order] = rng.integers(0, alphabet, size=(n_examples, order))
    for t in range(order, max_length):
        ctx = ids[:, t - order]
        for k in range(1, order):
            ctx = ctx * alphabet + ids[:, t - order + k]
        u = rng.random(n_examples)
        choice = (u[:, None] > cum[ctx]).sum(axis=1).clip(0, 3)
        ids[:, t] = prefs[ctx, choice]
    ids = (ids + 2) % vocab_size
    return {
        "input_ids": ids.astype(np.int32),
        "attention_mask": np.ones((n_examples, max_length), np.int32),
    }


def synthetic_pair_task(
    n_examples: int,
    *,
    max_length: int = 128,
    vocab_size: int = 28996,
    num_labels: int = 2,
    seed: int = 42,
    seg_len_range: tuple[int, int] = (8, 40),
) -> dict[str, np.ndarray]:
    """{input_ids, attention_mask, token_type_ids, labels} int32 arrays of a
    paraphrase-detection-shaped dataset (see the module docstring)."""
    rng = np.random.default_rng(seed)
    first = SEP_ID + 1
    input_ids = np.full((n_examples, max_length), PAD_ID, np.int32)
    token_type = np.zeros((n_examples, max_length), np.int32)
    mask = np.zeros((n_examples, max_length), np.int32)
    labels = rng.integers(0, num_labels, n_examples).astype(np.int32)
    content_lo = (
        first + num_labels * MARKER_BAND if num_labels > 2 else first
    )
    if content_lo >= vocab_size:
        raise ValueError(
            f"vocab_size {vocab_size} too small for {num_labels} marker "
            f"bands of {MARKER_BAND} tokens (content range starts at "
            f"{content_lo})"
        )

    for i in range(n_examples):
        la = int(rng.integers(*seg_len_range))
        lb = int(rng.integers(*seg_len_range))
        label = labels[i]
        if num_labels > 2:
            a = rng.integers(content_lo, vocab_size, la)
            noise = 0.15 * (label + 1)
            b = a.copy()
            flip = rng.random(la) < noise
            band_lo = first + int(label) * MARKER_BAND
            b[flip] = rng.integers(band_lo, band_lo + MARKER_BAND, flip.sum())
            lb = la
        else:
            a = rng.integers(first, vocab_size, la)
            if label == num_labels - 1:
                b = rng.integers(first, vocab_size, lb)  # unrelated
            else:
                # copy of A with ~15% noise (the "paraphrase")
                noise = 0.15 * (label + 1)
                b = a.copy()
                flip = rng.random(la) < noise
                b[flip] = rng.integers(first, vocab_size, flip.sum())
                lb = la
        ids, types = assemble_pair_row(
            a[:la].tolist(), b[:lb].tolist(), max_length
        )
        input_ids[i, : len(ids)] = ids
        token_type[i, : len(ids)] = types
        mask[i, : len(ids)] = 1

    # binary: flip so label 1 == "paraphrase" (the MRPC convention)
    if num_labels == 2:
        labels = 1 - labels
    return {
        "input_ids": input_ids,
        "attention_mask": mask,
        "token_type_ids": token_type,
        "labels": labels,
    }
