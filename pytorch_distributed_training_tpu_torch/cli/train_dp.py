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
records as JSON (rank 0).

The JAX CLI's mesh flags, with its defaults: the processes lay out as
``--mesh-data`` (-1: what is left) × ``--mesh-fsdp`` (1) × ``--mesh-seq``
(1), the batch sharded over data × fsdp; ``--fsdp`` (off) shards the
parameters and optimizer state over the fsdp axis (FSDP2,
``parallel/sharding.py``), else DDP keeps them replicated::

    python -m torch.distributed.run --nproc-per-node 4 \\
        -m pytorch_distributed_training_tpu_torch.cli.train_dp \\
        --model tiny --task synthetic --device cpu --fsdp --mesh-fsdp 2

``--mesh-seq P`` is context parallelism: each rank holds S/P columns of
every row, attention is the ring (``--attention ring``, the default there;
at a seq axis of 1 it is reference attention, JAX's fallback) and the
pooler reads the CLS row of the first seq shard::

    python -m torch.distributed.run --nproc-per-node 4 \\
        -m pytorch_distributed_training_tpu_torch.cli.train_dp \\
        --model tiny --task synthetic --device cpu --mesh-seq 2

``--matmul-impl int8|int8_full`` runs the six projections of every layer
on int8 products (``ops/quant.py``: int8 forward and float backward, or
int8 dgrad and wgrad too); ``--quant-delayed`` quantizes each site's
input on the previous microbatch's amax, observed on the first batch
before step 0, and ``--quant-delayed-grads`` (with ``int8_full``) the
backward's dy too::

    python -m pytorch_distributed_training_tpu_torch.cli.train_dp \
        --model tiny --task synthetic --device cpu \
        --matmul-impl int8_full --quant-delayed --quant-delayed-grads

Checkpoints (``train/checkpoint.py``): ``--checkpoint-dir`` saves every
epoch's end and every ``--checkpoint-every-steps`` updates (0: per epoch
only); ``--resume`` starts from the newest step there that verifies at
``--checkpoint-verify`` (``size``, ``digest`` or ``off``), mid-epoch
included; ``python -m
pytorch_distributed_training_tpu_torch.cli.verify_checkpoint DIR``
checks a directory offline. ``--hf-checkpoint DIR`` starts the model from
an HF BERT or RoBERTa checkpoint (``models/hf_loader.py``).

RoBERTa-large on MNLI, the repo's fourth recipe (``--task mnli`` falls back
to the synthetic 3-class pair task without GLUE data)::

    python -m pytorch_distributed_training_tpu_torch.cli.train_dp \
        --model roberta-large --task mnli

Telemetry and faults: ``--metrics-dir DIR`` writes the JSONL stream that
``scripts/summarize_metrics.py DIR`` reads (every step then synchronizes
on the device), ``--log-format json`` makes the log lines JSON;
``--max-restarts N`` (with ``--checkpoint-dir``) retries a crashed run
from its newest verified checkpoint, in the same process, ``N`` times
(``--restart-window-s``: within a sliding window); ``PDT_TPU_FAULT``
injects the faults of ``faults/inject.py`` (``crash_at_step:2`` and so
on), ``--crash-at-step`` a hard exit. A SIGTERM stops the run with an
emergency checkpoint and exit 75 (``--no-handle-preemption``: off).
"""

from __future__ import annotations

import argparse
import json

from pytorch_distributed_training_tpu_torch.cli import (
    add_quant_args,
    add_restart_args,
    quant_overrides,
    resolve_attention,
    run_supervised,
)
from pytorch_distributed_training_tpu_torch.utils.config import (
    MeshConfig,
    TrainConfig,
    add_dataclass_args,
    dataclass_from_args,
    model_preset,
)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--model", default="bert-large-cased",
                   help="model preset (bert-base-cased, bert-large-cased, "
                        "roberta-large, tiny)")
    p.add_argument("--task", default="auto",
                   help="mrpc | mnli | sst2 | qnli | synthetic | auto (mrpc "
                        "with the synthetic fallback)")
    p.add_argument("--attention", default=None,
                   choices=("reference", "flash", "ring"),
                   help="attention implementation (default: the preset's; "
                        "ring when --mesh-seq > 1)")
    add_quant_args(p)
    p.add_argument("--fsdp", action=argparse.BooleanOptionalAction,
                   default=False,
                   help="shard params/opt state over the fsdp axis")
    p.add_argument("--mesh-data", type=int, default=-1)
    p.add_argument("--mesh-fsdp", type=int, default=1)
    p.add_argument("--mesh-seq", type=int, default=1,
                   help="context-parallel degree (ring attention)")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="where the run goes (cuda raises when no GPU is "
                        "visible)")
    add_restart_args(p)
    p.add_argument("--hf-checkpoint", default=None,
                   help="HF torch checkpoint directory to start from "
                        "(model.safetensors or pytorch_model.bin; BERT or "
                        "RoBERTa)")
    p.add_argument("--history-out", default=None,
                   help="write the per-epoch metric history as JSON here")
    add_dataclass_args(p, TrainConfig)
    return p


def build_trainer(args, tcfg=None):
    """The ``Trainer`` that parsed ``args`` describe (process group joined,
    data loaded, model on its device), not yet run; ``tcfg`` in place of
    the flags' ``TrainConfig`` (a supervised retry's)."""
    from pytorch_distributed_training_tpu_torch.parallel import (
        ShardingPolicy,
    )
    from pytorch_distributed_training_tpu_torch.train.loop import Trainer

    quant = quant_overrides(args)
    tcfg = tcfg or dataclass_from_args(TrainConfig, args)
    mcfg = model_preset(
        args.model, compute_dtype="bfloat16" if tcfg.bf16 else "float32",
        **quant, **resolve_attention(args.attention, args.mesh_seq),
    )
    mesh = MeshConfig(data=args.mesh_data, fsdp=args.mesh_fsdp,
                      seq=args.mesh_seq)
    return Trainer(mcfg, tcfg, task=args.task, device=args.device,
                   mesh_config=mesh, policy=ShardingPolicy(fsdp=args.fsdp),
                   hf_checkpoint=args.hf_checkpoint)


def train(argv=None):
    """Parse ``argv``, run the trainer to its end and return it."""
    return run(build_parser().parse_args(argv), build_trainer)


def run(args, build):
    """Build the trainer of ``args`` with ``build(args, tcfg)`` and run it
    to its end under the restart flags (``run_supervised``), write
    ``--history-out`` (rank 0) and leave the process group once, after the
    last attempt; the trainer. Shared with ``cli/train_lm`` and
    ``cli/train_mp``."""
    from pytorch_distributed_training_tpu_torch.comms.bootstrap import shutdown
    from pytorch_distributed_training_tpu_torch.utils.logging import (
        set_log_format,
    )

    # before anything logs, so the bootstrap's lines take the format too
    set_log_format(args.log_format)
    try:
        trainer = run_supervised(args, dataclass_from_args(TrainConfig, args),
                                 lambda cfg: build(args, cfg))
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
