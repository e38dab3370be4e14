"""GLUE task loading -> fixed-shape numpy arrays, with the offline fallback
(counterpart: the JAX package's ``data/glue.py`` ``resolve_task``,
``load_task_arrays`` and ``eval_splits``).

Tasks: MRPC (the reference workload), MNLI (matched and mismatched
validation splits), SST-2, QNLI, ``synthetic``, the MRPC-shaped
stand-in of ``data/synthetic.py``, and ``lm``, its causal-LM corpus (no
labels; ``num_labels`` 0). ``auto`` tries MRPC through the
``datasets`` package and falls back to ``synthetic`` when it is missing
or the hub and cache are unreachable. Real text is encoded with the
WordPiece vocabulary at ``vocab_path`` or the hash tokenizer (the JAX
package's C++ bulk encoder is not ported: ROADMAP.md, queue 1).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from pytorch_distributed_training_tpu_torch.data import synthetic
from pytorch_distributed_training_tpu_torch.data.tokenizer import (
    HashTokenizer,
    WordPieceTokenizer,
    encode_pairs,
)
from pytorch_distributed_training_tpu_torch.utils.logging import log0

TASKS = {
    # task: (dataset args, text field a, text field b, num_labels)
    "mrpc": (("glue", "mrpc"), "sentence1", "sentence2", 2),
    "mnli": (("glue", "mnli"), "premise", "hypothesis", 3),
    "sst2": (("glue", "sst2"), "sentence", None, 2),
    "qnli": (("glue", "qnli"), "question", "sentence", 2),
    "synthetic": (None, None, None, 2),
    # the synthetic causal-LM corpus (data/synthetic.py synthetic_lm_task)
    "lm": (None, None, None, 0),
}


def eval_splits(task: str) -> list[tuple[str, str]]:
    """(metric name suffix, split) pairs a trainer evaluates: both MNLI
    validation splits, else the single unsuffixed ``validation``."""
    if task == "mnli":
        return [("matched", "validation"),
                ("mismatched", "validation_mismatched")]
    return [("", "validation")]


def make_tokenizer(vocab_path: Optional[str] = None, vocab_size: int = 28996):
    if vocab_path:
        return WordPieceTokenizer(vocab_path)
    return HashTokenizer(vocab_size=vocab_size)


def resolve_task(task: str) -> str:
    """Resolve ``"auto"`` to a concrete task once (so every split of a run
    agrees)."""
    if task != "auto":
        return task
    try:
        import datasets

        datasets.load_dataset("glue", "mrpc", split="train[:1]")
        return "mrpc"
    except Exception as e:  # no datasets package, hub unreachable, no cache
        log0(f"glue/mrpc unavailable ({type(e).__name__}); using synthetic task")
        return "synthetic"


def load_task_arrays(
    task: str,
    split: str,
    *,
    max_length: int = 128,
    vocab_path: Optional[str] = None,
    vocab_size: int = 28996,
    seed: int = 42,
    synthetic_sizes: tuple[int, int] = (
        synthetic.MRPC_TRAIN_SIZE,
        synthetic.MRPC_EVAL_SIZE,
    ),
) -> tuple[dict[str, np.ndarray], int]:
    """({input_ids, attention_mask, token_type_ids, labels}, num_labels);
    the ``lm`` task has only {input_ids, attention_mask} and 0 labels.

    ``split`` is "train", "validation" or (MNLI) "validation_mismatched".
    """
    if task == "auto":
        task = resolve_task(task)
    if task == "synthetic":
        n_train, n_eval = synthetic_sizes
        n = n_train if split == "train" else n_eval
        data = synthetic.synthetic_pair_task(
            n, max_length=max_length, vocab_size=vocab_size,
            seed=seed if split == "train" else seed + 1,
        )
        return data, 2
    if task == "lm":
        # both splits sample one chain (the table from ``seed``) through
        # their own row streams, each made at its own size
        n_train, n_eval = synthetic_sizes
        n = n_train if split == "train" else n_eval
        data = synthetic.synthetic_lm_task(
            n, max_length=max_length, vocab_size=vocab_size, seed=seed,
            row_seed=seed + (1 if split == "train" else 2),
        )
        return data, 0
    if task not in TASKS:
        raise KeyError(f"unknown task {task!r}; have {sorted(TASKS)}")
    ds_args, field_a, field_b, num_labels = TASKS[task]
    import datasets  # deferred: optional dependency

    hub_split = split
    if task == "mnli" and split == "validation":
        hub_split = "validation_matched"
    if split == "validation_mismatched" and task != "mnli":
        raise ValueError(f"task {task!r} has no mismatched validation split")
    try:
        ds = datasets.load_dataset(*ds_args, split=hub_split)
    except (ConnectionError, TimeoutError, OSError) as e:
        # connectivity or cache failures only: anything else propagates
        log0(
            f"glue/{task} unavailable ({type(e).__name__}); falling back to "
            f"the synthetic pair task with num_labels={num_labels}"
        )
        n_train, n_eval = synthetic_sizes
        n = n_train if split == "train" else n_eval
        split_seed = {
            "train": seed,
            "validation": seed + 1,
            "validation_mismatched": seed + 2,
        }.get(split, seed + 1)
        data = synthetic.synthetic_pair_task(
            n, max_length=max_length, vocab_size=vocab_size,
            num_labels=num_labels, seed=split_seed,
        )
        return data, num_labels
    tokenizer = make_tokenizer(vocab_path, vocab_size)
    arrays = encode_pairs(
        tokenizer, ds[field_a], ds[field_b] if field_b else None,
        max_length=max_length,
    )
    arrays["labels"] = np.asarray(ds["label"], np.int32)
    return arrays, num_labels
