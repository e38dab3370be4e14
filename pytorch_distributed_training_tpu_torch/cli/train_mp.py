"""Hybrid data × model parallel trainer entry point (counterpart: the JAX
package's ``cli/train_mp.py``): fine-tune under data parallelism wrapping
a model split over ranks, the reference's second script (reference
test_model_parallelism.py). Its model-parallel modes split the reference's
two custom modules:

- ``--mp-mode branch`` (default): the TriBert ensemble (:92-163), shared
  embeddings, ``--n-branches`` BERT encoders mean-fused, BERT's head
  (``models/branch.py``); the branches split over the mesh's ``model``
  axis, each rank running its own one after another;
- ``--mp-mode stage``: ConcatBert's layer split (:40-89) over the mesh's
  ``stage`` axis, the activation and its gradient passed between stages
  one microbatch at a time (``models/stage.py``); one stage is
  ``BertForSequenceClassification`` itself;
- ``--mp-mode pipeline`` and ``--mp-mode 1f1b``: the same split trained
  through the GPipe and the 1F1B schedule (``parallel/pipeline.py``), each
  micro-batch in ``--pipeline-microbatches`` pipeline microbatches (0:
  ``resolve_n_micro``'s choice); the eval runs stage mode's forward.

    python -m pytorch_distributed_training_tpu_torch.cli.train_mp \\
        --model bert-base-cased --task synthetic

Runs on the GPU (``--device cuda``, the default; it raises when no GPU is
visible; one card is world size 1, every axis of the mesh 1) or on the CPU
with ``--device cpu``, where every kernel takes its plain PyTorch version.
Over several processes under ``torch.distributed.run``, one per card (NCCL)
or per CPU worker (gloo), the mesh flags lay them out (ranks row-major in
the order data, fsdp, stage, model, seq; ``-1`` takes what is left)::

    python -m torch.distributed.run --nproc-per-node 4 \\
        -m pytorch_distributed_training_tpu_torch.cli.train_mp \\
        --model tiny --task synthetic --mesh-data 2 --mesh-model 2 \\
        --n-branches 2 --device cpu

    python -m torch.distributed.run --nproc-per-node 2 \\
        -m pytorch_distributed_training_tpu_torch.cli.train_mp \\
        --model tiny --task synthetic --mesh-data 1 --mesh-stage 2 \\
        --mp-mode 1f1b --device cpu

The reference's MP script has no fp16 (:320-321); bf16 is on by default as
in every entry point (``--no-bf16`` for float32). ``--history-out`` writes
the per-epoch records as JSON (rank 0). The batch shards over data ×
fsdp; ``--fsdp`` shards each rank's part of the model over the fsdp axis
(FSDP2 on the (data, fsdp) sub-mesh at its model and stage coordinates,
``parallel/sharding.py``), judged as JAX judges the stacked branches and
layers. Every mode keeps per-layer modules (JAX's stage and pipeline
modes scan the trunk; the port's do not). ``--attention ring`` at a seq
axis of 1 is reference attention (JAX's fallback). ``--mesh-seq P`` is
context parallelism under every mode: each rank holds S/P columns of
every row, each branch's and stage's layers attend through the ring
(the default there; ``--attention reference|flash`` raise), the stage
wire joins the stages of one seq coordinate and the pooler reads the
CLS row of seq coordinate 0::

    python -m torch.distributed.run --nproc-per-node 4 \\
        -m pytorch_distributed_training_tpu_torch.cli.train_mp \\
        --model tiny --task synthetic --mesh-data 1 --mesh-stage 2 \\
        --mesh-seq 2 --mp-mode pipeline --device cpu

``--matmul-impl int8|int8_full`` and ``--quant-delayed`` are
``train_dp``'s (``ops/quant.py``); under the pipeline and 1f1b schedules
the delayed amaxes stream through the pipeline microbatches. The
checkpoint flags are ``train_dp``'s (``train/checkpoint.py``): each stage
or branch rank writes its own layers under the whole model's names, so a
checkpoint of one mode and mesh resumes under another. ``--model
roberta-large`` runs RoBERTa's trunk in every mode. The telemetry,
restart and fault flags are ``train_dp``'s.
"""

from __future__ import annotations

import argparse
import functools

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
    p.add_argument("--model", default="bert-base-cased",
                   help="model preset (the reference MP script uses "
                        "bert-base-cased x 3, test_model_parallelism.py:"
                        "230-238; bert-large-cased, roberta-large, tiny)")
    p.add_argument("--task", default="auto",
                   help="mrpc | mnli | synthetic | auto (mrpc with the "
                        "synthetic fallback)")
    p.add_argument("--mp-mode", default="branch",
                   choices=["branch", "stage", "pipeline", "1f1b"],
                   help="branch = TriBert-style ensemble over the model "
                        "axis; stage = ConcatBert-style layer split over "
                        "the stage axis, one microbatch at a time; "
                        "pipeline = the same layer split run through the "
                        "GPipe schedule (microbatches stream through "
                        "stages concurrently); 1f1b = one-forward-one-"
                        "backward schedule (same split, backward "
                        "interleaved with forward, stage-bounded "
                        "activation memory)")
    p.add_argument("--n-branches", type=int, default=3)
    p.add_argument("--pipeline-microbatches", type=int, default=0,
                   help="GPipe microbatches per train microbatch (pipeline "
                        "mode; 0 = auto: deepest of 4x/2x/1x the stage "
                        "count that divides the micro-batch size with "
                        "per-microbatch batches divisible over data*fsdp)")
    p.add_argument("--attention", default=None,
                   choices=("reference", "flash", "ring"),
                   help="attention implementation (default: the preset's)")
    add_quant_args(p, delayed_grads=False)
    p.add_argument("--fsdp", action=argparse.BooleanOptionalAction,
                   default=False)
    p.add_argument("--mesh-data", type=int, default=-1)
    p.add_argument("--mesh-fsdp", type=int, default=1)
    p.add_argument("--mesh-stage", type=int, default=1)
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


def resolve_n_micro(mesh, n: int, batch: int, what: str) -> int:
    """The pipeline-microbatch count for a batch of ``batch`` rows (JAX
    ``cli/train_mp.py:114-136``): ``n``, checked, or for ``n`` <= 0 the
    deepest of {4, 2, 1} × the stages that divides ``batch`` with the
    rows of each pipeline microbatch divisible over data × fsdp."""
    stages = mesh.shape["stage"]
    dshard = mesh.shape["data"] * mesh.shape["fsdp"]
    if n <= 0:
        for cand in (4 * stages, 2 * stages, stages):
            if batch % cand == 0 and (batch // cand) % dshard == 0:
                return cand
        raise SystemExit(
            f"no pipeline microbatch count in {{4,2,1}}x{stages} "
            f"divides {what} {batch} with per-microbatch rows "
            f"divisible by data*fsdp={dshard}; pick sizes explicitly"
        )
    if batch % n or (batch // n) % dshard:
        raise SystemExit(
            f"--pipeline-microbatches {n}: {what} {batch} must split "
            f"into {n} microbatches whose size divides "
            f"data*fsdp={dshard}"
        )
    return n


def build_trainer(args, tcfg=None):
    """The ``Trainer`` that parsed ``args`` describe (process group joined,
    mesh built, data loaded, this rank's part of the model on its device),
    not yet run; ``tcfg`` in place of the flags' ``TrainConfig`` (a
    supervised retry's)."""
    quant = quant_overrides(args)
    from pytorch_distributed_training_tpu_torch.models.branch import (
        BranchEnsembleClassifier,
    )
    from pytorch_distributed_training_tpu_torch.parallel import (
        ShardingPolicy,
    )
    from pytorch_distributed_training_tpu_torch.train.loop import Trainer

    tcfg = tcfg or dataclass_from_args(TrainConfig, args)
    mcfg = model_preset(
        args.model, compute_dtype="bfloat16" if tcfg.bf16 else "float32",
        **quant, **resolve_attention(args.attention, args.mesh_seq))
    if mcfg.causal:
        raise SystemExit(f"--model {args.model} is a causal preset; train_mp "
                         f"fine-tunes an encoder classifier")
    model = None
    if args.mp_mode == "branch":
        if args.mesh_model > 1 and args.n_branches % args.mesh_model:
            raise SystemExit(
                f"--n-branches {args.n_branches} must be divisible by "
                f"--mesh-model {args.mesh_model} for branch parallelism "
                f"(each model-axis slice holds n_branches/mesh_model "
                f"branches)")

        def model(cfg, *, seed, mesh, n=args.n_branches):
            return BranchEnsembleClassifier(cfg, n, seed=seed, mesh=mesh)

    elif args.mesh_stage > 1 and mcfg.num_layers % args.mesh_stage:
        raise SystemExit(
            f"model has {mcfg.num_layers} layers, not divisible by "
            f"--mesh-stage {args.mesh_stage} — the layer split would "
            f"silently replicate instead of sharding")
    mesh = MeshConfig(data=args.mesh_data, fsdp=args.mesh_fsdp,
                      stage=args.mesh_stage, model=args.mesh_model,
                      seq=args.mesh_seq)
    n_micro = None
    if args.mp_mode in ("pipeline", "1f1b"):
        # only the train micro-batch is split: the eval runs stage mode's
        # forward, one batch at a time
        n_micro = functools.partial(
            resolve_n_micro, n=args.pipeline_microbatches,
            batch=tcfg.micro_batch_size, what="micro-batch")
    return Trainer(mcfg, tcfg, task=args.task, device=args.device,
                   mesh_config=mesh, mp_mode=args.mp_mode, model=model,
                   policy=ShardingPolicy(fsdp=args.fsdp), n_micro=n_micro)


def train(argv=None):
    """Parse ``argv``, run the trainer to its end and return it."""
    return run(build_parser().parse_args(argv), build_trainer)


def main(argv=None) -> list[dict]:
    return train(argv).history


if __name__ == "__main__":
    main()
