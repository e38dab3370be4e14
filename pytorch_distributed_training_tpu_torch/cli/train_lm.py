"""Causal-LM trainer entry point (counterpart: the JAX package's
``cli/train_lm.py``): train a GPT-2 preset on next-token cross-entropy and
report eval loss, perplexity and next-token accuracy per epoch.

    python -m pytorch_distributed_training_tpu_torch.cli.train_lm \\
        --model gpt2-medium

    # the long-context recipe: seq 1024, global batch 32 = micro 4 x 8
    python -m pytorch_distributed_training_tpu_torch.cli.train_lm \\
        --model gpt2-medium --max-seq-length 1024 --global-batch-size 32 \\
        --micro-batch-size 4

Attention is the preset's (``gpt2-medium``: the flash kernels, the
whole-sequence pair at seq <= 256 and the blockwise pair above);
``--attention reference`` takes the plain einsum path. Runs on the GPU
(``--device cuda``, the default; it raises when no GPU is visible) or on
the CPU with ``--device cpu``, where every kernel takes its plain PyTorch
version. Data-parallel under ``torch.distributed.run``, one process per
card (NCCL) or per CPU worker (gloo)::

    python -m torch.distributed.run --nproc-per-node 2 \\
        -m pytorch_distributed_training_tpu_torch.cli.train_lm \\
        --model gpt2-tiny --device cpu

``--task lm`` (the only task) is the synthetic Markov-chain corpus of
``data/synthetic.py``; the model starts from random weights made from
``--seed``. ``--history-out`` writes the per-epoch records as JSON (rank
0). The JAX CLI's FSDP, TP, mesh and scan-layers flags wait for slice 5,
its remat, int8-matmul and restart flags for the slice 2 and slice 3
leftovers (ROADMAP.md).
"""

from __future__ import annotations

import argparse

from pytorch_distributed_training_tpu_torch.cli.train_dp import run
from pytorch_distributed_training_tpu_torch.utils.config import (
    TrainConfig,
    add_dataclass_args,
    dataclass_from_args,
    model_preset,
)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--model", default="gpt2-medium",
                   help="causal model preset (gpt2-medium, gpt2-tiny)")
    p.add_argument("--task", default="lm",
                   help="lm (the synthetic causal-LM corpus)")
    p.add_argument("--attention", default=None,
                   choices=("reference", "flash"),
                   help="attention implementation (default: the preset's)")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="where the run goes (cuda raises when no GPU is "
                        "visible)")
    p.add_argument("--history-out", default=None,
                   help="write the per-epoch metric history as JSON here")
    add_dataclass_args(p, TrainConfig)
    return p


def build_trainer(args):
    """The ``Trainer`` that parsed ``args`` describe (process group joined,
    data made, model on its device), not yet run."""
    from pytorch_distributed_training_tpu_torch.train.loop import Trainer

    tcfg = dataclass_from_args(TrainConfig, args)
    overrides = dict(compute_dtype="bfloat16" if tcfg.bf16 else "float32")
    if args.attention is not None:
        overrides["attention_impl"] = args.attention
    mcfg = model_preset(args.model, **overrides)
    if not mcfg.causal:
        raise SystemExit(
            f"--model {args.model} is not a causal/decoder preset; use "
            f"gpt2-medium or gpt2-tiny"
        )
    return Trainer(mcfg, tcfg, task=args.task, device=args.device)


def train(argv=None):
    """Parse ``argv``, run the trainer to its end and return it."""
    return run(build_parser().parse_args(argv), build_trainer)


def main(argv=None) -> list[dict]:
    return train(argv).history


if __name__ == "__main__":
    main()
