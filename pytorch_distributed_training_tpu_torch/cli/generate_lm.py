"""Model and tokenizer loading shared by the LM entry points (counterpart:
the JAX package's ``cli/generate_lm.py`` helpers ``add_model_args``,
``build_tokenizer`` and ``load_model_and_params``).

Weights come from random init seeded by ``--seed`` (demo mode; the
serving path runs the same programs on any weights). Loading a trainer
checkpoint (``--checkpoint-dir``) or an HF GPT-2 checkpoint
(``--hf-checkpoint``) is not ported yet. Tokenization uses the byte-level
BPE when ``--vocab``/``--merges`` are given, else the raw-byte fallback.
The one-shot ``generate`` command of the JAX package is not ported yet;
serve with ``cli/serve_lm.py``.
"""

from __future__ import annotations

import argparse

import torch


def add_model_args(p: argparse.ArgumentParser) -> None:
    """Model/checkpoint/tokenizer flags shared by the LM entry points."""
    p.add_argument("--model", default="gpt2-medium")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--checkpoint-dir", default=None,
                   help="framework checkpoint directory (not ported yet)")
    p.add_argument("--hf-checkpoint", default=None,
                   help="HF GPT-2 checkpoint directory (not ported yet)")
    p.add_argument("--vocab", default=None, help="encoder.json path")
    p.add_argument("--merges", default=None, help="merges.txt path")


def build_tokenizer(args):
    from pytorch_distributed_training_tpu_torch.data.bpe import (
        ByteLevelBPETokenizer,
        ByteTokenizer,
    )
    from pytorch_distributed_training_tpu_torch.utils.logging import log0

    if args.vocab and args.merges:
        return ByteLevelBPETokenizer(args.vocab, args.merges)
    log0("no --vocab/--merges: using raw-byte fallback tokenizer")
    return ByteTokenizer()


def load_model_and_params(args, tok):
    """``(model, ckpt_step)``: a ``GPT2LMModel`` of ``--model`` on the CPU
    with float32 parameters drawn from a ``torch.Generator`` seeded by
    ``--seed`` (``ckpt_step`` is None for random weights). The serving
    engine moves and casts its own copy."""
    from pytorch_distributed_training_tpu_torch.models.gpt2 import GPT2LMModel
    from pytorch_distributed_training_tpu_torch.utils.config import (
        model_preset,
    )
    from pytorch_distributed_training_tpu_torch.utils.logging import log0

    if args.checkpoint_dir or args.hf_checkpoint:
        raise NotImplementedError(
            "--checkpoint-dir/--hf-checkpoint: checkpoint loading is not yet "
            "ported (see ROADMAP.md, queue 1, slice 3)"
        )
    mcfg = model_preset(args.model)
    if tok.vocab_size > mcfg.vocab_size:
        raise SystemExit(
            f"tokenizer vocab {tok.vocab_size} exceeds model vocab "
            f"{mcfg.vocab_size}"
        )
    log0("no checkpoint given: generating from RANDOM weights (demo)")
    gen = torch.Generator().manual_seed(args.seed)
    return GPT2LMModel(mcfg, generator=gen), None
