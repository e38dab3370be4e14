"""Data-parallel trainer entry point (counterpart: the JAX package's
``cli/train_dp.py``): fine-tune a BERT classifier on GLUE/MRPC with the
reference recipe (lr 2e-5, 3 epochs, seed 42, global batch 96 = micro 8 x
accumulation 12, eval batch 32, linear warmup 100, bf16 compute).

    python -m pytorch_distributed_training_tpu_torch.cli.train_dp \\
        --model bert-large-cased --task synthetic

Runs on the GPU (``--device cuda``, the default; it raises when no GPU is
visible) or on the CPU with ``--device cpu``, where every kernel takes its
plain PyTorch version. Data-parallel under ``torch.distributed.run``, one
process per card (NCCL) or per CPU worker (gloo)::

    python -m torch.distributed.run --nproc-per-node 2 \\
        -m pytorch_distributed_training_tpu_torch.cli.train_dp \\
        --model tiny --task synthetic --device cpu

Without GLUE data (no ``datasets`` package or no cache) ``--task auto``
falls back to the synthetic MRPC-shaped task; the model starts from random
weights made from ``--seed``. ``--history-out`` writes the per-epoch
records as JSON (rank 0). The JAX CLI's ``--attention``, ``--matmul-impl``,
``--hf-checkpoint``, mesh, FSDP and restart flags wait for their slices
(ROADMAP.md, queue 1).
"""

from __future__ import annotations

import argparse
import json

from pytorch_distributed_training_tpu_torch.utils.config import (
    TrainConfig,
    add_dataclass_args,
    dataclass_from_args,
    model_preset,
)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--model", default="bert-large-cased",
                   help="model preset (bert-base-cased, bert-large-cased, "
                        "tiny)")
    p.add_argument("--task", default="auto",
                   help="mrpc | mnli | sst2 | qnli | synthetic | auto (mrpc "
                        "with the synthetic fallback)")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="where the run goes (cuda raises when no GPU is "
                        "visible)")
    p.add_argument("--history-out", default=None,
                   help="write the per-epoch metric history as JSON here")
    add_dataclass_args(p, TrainConfig)
    return p


def build_trainer(args):
    """The ``Trainer`` that parsed ``args`` describe (process group joined,
    data loaded, model on its device), not yet run."""
    from pytorch_distributed_training_tpu_torch.train.loop import Trainer

    tcfg = dataclass_from_args(TrainConfig, args)
    mcfg = model_preset(
        args.model, compute_dtype="bfloat16" if tcfg.bf16 else "float32",
    )
    return Trainer(mcfg, tcfg, task=args.task, device=args.device)


def train(argv=None):
    """Parse ``argv``, run the trainer to its end and return it."""
    return run(build_parser().parse_args(argv), build_trainer)


def run(args, build):
    """Build the trainer of ``args`` with ``build``, run it to its end,
    write ``--history-out`` (rank 0) and leave the process group; the
    trainer. Shared with ``cli/train_lm``."""
    from pytorch_distributed_training_tpu_torch.comms.bootstrap import shutdown

    try:
        trainer = build(args)
        trainer.run()
        if args.history_out and trainer.info.is_main:
            with open(args.history_out, "w") as f:
                json.dump(trainer.history, f, indent=1)
    finally:
        shutdown()
    return trainer


def main(argv=None) -> list[dict]:
    return train(argv).history


if __name__ == "__main__":
    main()
