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
0).

The JAX CLI's defaults: ``--fsdp`` on over ``--mesh-fsdp -1`` (every
process), ``--mesh-data 1``, and ``--scan-layers`` on (the stacked trunk,
``layers_scan``). FSDP2 shards each parameter and its Adam moments on
one dim over the fsdp axis (``parallel/sharding.py``); with ``--no-fsdp``
DDP keeps them replicated. One process (one card) is an fsdp axis of 1:
nothing to shard, the model runs unwrapped. Over four gloo workers::

    python -m torch.distributed.run --nproc-per-node 4 \\
        -m pytorch_distributed_training_tpu_torch.cli.train_lm \\
        --model gpt2-tiny --device cpu --mesh-data 2 --mesh-fsdp 2

``--tp`` with ``--mesh-model M`` is Megatron tensor parallelism over the
model axis (``parallel/sharding.py``): each rank holds N/M heads of every
attention and intermediate/M columns of every MLP, and FSDP shards that
slice. As in JAX, the policy splits only per-layer leaves: under the
default ``--scan-layers`` the stacked trunk has no leaf it splits, and the
model ranks train alike, so pass ``--no-scan-layers`` to split the
trunk. ``--mesh-seq P`` is context parallelism: each rank holds S/P
columns of every row and attention is the ring (``--attention ring``,
the default there; at a seq axis of 1 it is reference attention, JAX's
fallback). The axes compose: over four gloo workers, ``--mesh-model 2``
or ``--mesh-seq 2`` leaves fsdp 2 by ``--mesh-fsdp -1``::

    python -m torch.distributed.run --nproc-per-node 4 \\
        -m pytorch_distributed_training_tpu_torch.cli.train_lm \\
        --model gpt2-tiny --device cpu --tp --no-scan-layers --mesh-model 2

``--matmul-impl int8|int8_full`` runs the six projections of every block
on int8 products (``ops/quant.py``); the JAX LM CLI has no delayed
scaling flags. ``--checkpoint-dir``, ``--checkpoint-every-steps``,
``--resume`` and ``--checkpoint-verify`` are ``train_dp``'s
(``train/checkpoint.py``); a checkpoint of the scanned trunk generates and
serves as it is (``cli/generate_lm.py``, ``cli/serve_lm.py``).

``--remat`` checkpoints every block (its forward runs again in the
backward; ``--remat-policy dots|weight_dots`` keeps every matmul output or
only the projections), ``--remat-mlp`` only each block's MLP tail
(``models/bert.remat_call``); losses and gradients equal those without
remat. ``--metrics-dir``, ``--log-format``, ``--max-restarts``,
``--restart-window-s`` and the fault flags are ``train_dp``'s.
"""

from __future__ import annotations

import argparse

from pytorch_distributed_training_tpu_torch.cli import (
    add_quant_args,
    add_restart_args,
    quant_overrides,
    resolve_attention,
)
from pytorch_distributed_training_tpu_torch.cli.train_dp import run
from pytorch_distributed_training_tpu_torch.utils.config import (
    MeshConfig,
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
                   choices=("reference", "flash", "ring"),
                   help="attention implementation (default: the preset's; "
                        "ring when --mesh-seq > 1)")
    p.add_argument("--fsdp", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="shard params/opt state over the fsdp axis")
    p.add_argument("--tp", action=argparse.BooleanOptionalAction,
                   default=False,
                   help="Megatron tensor parallelism over the model axis")
    p.add_argument("--scan-layers", action=argparse.BooleanOptionalAction,
                   default=True, help="the stacked trunk (layers_scan)")
    p.add_argument("--remat", action=argparse.BooleanOptionalAction,
                   default=False,
                   help="checkpoint each block: its forward runs again in "
                        "the backward (bigger micro batches)")
    add_quant_args(p, delayed=False, delayed_grads=False)
    p.add_argument("--remat-policy", default="nothing",
                   choices=("nothing", "dots", "weight_dots"),
                   help="what --remat saves: nothing = full recompute; "
                        "dots = every matmul output; weight_dots = the "
                        "projections, recomputing the attention products")
    p.add_argument("--remat-mlp", action=argparse.BooleanOptionalAction,
                   default=False,
                   help="recompute only each block's MLP tail (mlp_up -> "
                        "gelu -> mlp_down -> dropout): drops the GELU "
                        "activations without recomputing attention")
    p.add_argument("--mesh-data", type=int, default=1)
    p.add_argument("--mesh-fsdp", type=int, default=-1)
    p.add_argument("--mesh-model", type=int, default=1)
    p.add_argument("--mesh-seq", type=int, default=1,
                   help="context-parallel degree (ring attention)")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="where the run goes (cuda raises when no GPU is "
                        "visible)")
    add_restart_args(p)
    p.add_argument("--history-out", default=None,
                   help="write the per-epoch metric history as JSON here")
    add_dataclass_args(p, TrainConfig)
    return p


def build_trainer(args, tcfg=None):
    """The ``Trainer`` that parsed ``args`` describe (process group joined,
    data made, model on its device), not yet run; ``tcfg`` in place of the
    flags' ``TrainConfig`` (a supervised retry's)."""
    from pytorch_distributed_training_tpu_torch.parallel import (
        ShardingPolicy,
    )
    from pytorch_distributed_training_tpu_torch.train.loop import Trainer

    tcfg = tcfg or dataclass_from_args(TrainConfig, args)
    mcfg = model_preset(
        args.model, compute_dtype="bfloat16" if tcfg.bf16 else "float32",
        scan_layers=args.scan_layers, remat=args.remat,
        remat_policy=args.remat_policy, remat_mlp=args.remat_mlp,
        **quant_overrides(args),
        **resolve_attention(args.attention, args.mesh_seq))
    if not mcfg.causal:
        raise SystemExit(
            f"--model {args.model} is not a causal/decoder preset; use "
            f"gpt2-medium or gpt2-tiny"
        )
    mesh = MeshConfig(data=args.mesh_data, fsdp=args.mesh_fsdp,
                      model=args.mesh_model, seq=args.mesh_seq)
    return Trainer(mcfg, tcfg, task=args.task, device=args.device,
                   mesh_config=mesh,
                   policy=ShardingPolicy(fsdp=args.fsdp, tp=args.tp))


def train(argv=None):
    """Parse ``argv``, run the trainer to its end and return it."""
    return run(build_parser().parse_args(argv), build_trainer)


def main(argv=None) -> list[dict]:
    return train(argv).history


if __name__ == "__main__":
    main()
