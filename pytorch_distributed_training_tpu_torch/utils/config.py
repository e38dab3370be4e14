"""Model, mesh and training configuration for the port (counterpart: the
JAX package's ``utils/config.py`` ``MeshConfig``, ``ModelConfig``,
``model_preset``, ``TrainConfig``, ``add_dataclass_args`` and
``dataclass_from_args``).

The fields are those the ported paths read (GPT-2 serving, BERT and
RoBERTa fine-tuning, GPT-2 causal-LM training), with the JAX package's
defaults, so ``ModelConfig()`` and a preset name mean the same model in
both packages.
"""

from __future__ import annotations

import argparse
import dataclasses
import warnings
from typing import Any

DROPOUT_IMPLS = ("exact", "bits32", "bits8", "kernel")
LAYERNORM_IMPLS = ("fused", "reference")


@dataclasses.dataclass
class MeshConfig:
    """Logical mesh shape over the processes, axes in the order
    ``(data, fsdp, stage, model, seq)``:

    - ``data``: data parallelism (each data slice reads its own rows; DDP
      averages the gradients over it);
    - ``fsdp``: data parallelism with sharded parameters (ZeRO-3);
    - ``stage``: the layer split (ConcatBert's stages);
    - ``model``: the branch axis (TriBert's branches);
    - ``seq``: context parallelism (ring attention).

    Any axis set to ``-1`` absorbs all remaining processes (at most one).
    """

    data: int = -1
    fsdp: int = 1
    stage: int = 1
    model: int = 1
    seq: int = 1

    AXIS_NAMES = ("data", "fsdp", "stage", "model", "seq")

    def resolved_shape(self, n_devices: int) -> tuple[int, int, int, int, int]:
        sizes = [self.data, self.fsdp, self.stage, self.model, self.seq]
        n_fill = sum(1 for s in sizes if s == -1)
        if n_fill > 1:
            raise ValueError(f"at most one mesh axis may be -1, got {sizes}")
        fixed = 1
        for s in sizes:
            if s != -1:
                if s < 1:
                    raise ValueError(f"invalid mesh axis size {s}")
                fixed *= s
        if n_fill:
            if n_devices % fixed:
                raise ValueError(
                    f"{n_devices} devices not divisible by fixed axes "
                    f"product {fixed}"
                )
            sizes = [n_devices // fixed if s == -1 else s for s in sizes]
        elif fixed != n_devices:
            raise ValueError(
                f"mesh shape {sizes} (={fixed} devices) != available "
                f"devices {n_devices}"
            )
        return tuple(sizes)  # type: ignore[return-value]


@dataclasses.dataclass
class ModelConfig:
    """Transformer encoder/decoder hyperparameters and the dtype policy.

    dtype policy (as in the JAX package): parameters in ``param_dtype``
    (float32), matmuls and the residual stream in ``compute_dtype``
    (bfloat16 by default), LayerNorm and softmax statistics in float32,
    logits in float32.
    """

    vocab_size: int = 28996  # bert-*-cased vocab
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    hidden_dropout: float = 0.1
    attention_dropout: float = 0.1
    layer_norm_eps: float = 1e-12
    num_labels: int = 2
    # full-sequence (non-paged) attention: "reference" is the plain einsum
    # path, "flash" the flash kernels (ops/flash_attention.py), "ring" the
    # ring over the seq axis (ops/ring_attention.py; reference at seq 1)
    attention_impl: str = "reference"
    # dense matmuls (ops/quant.py): "native" in the compute dtype; "int8"
    # an int8 forward with a float straight-through backward; "int8_full"
    # int8 dgrad and wgrad too
    matmul_impl: str = "native"
    # int8: each site quantizes its input on the amax the previous
    # microbatch observed there (a buffer carried in the model), calibrated
    # before step 0 (train/step.calibrate_quant); read only by int8
    quant_delayed: bool = False
    # ... and the backward's dy on the previous microbatch's dy amaxes
    # (int8_full and quant_delayed only; not under the pipeline schedules)
    quant_delayed_grads: bool = False
    # the dropout mask stream (ops/dropout.py): "kernel" and "bits32" keep
    # a 32-bit word >= mask_threshold(rate) (the dropout-add-LayerNorm tail
    # fuses the mask only under "kernel"); "bits8" one byte an element at
    # 1/256 granularity; "exact" a float32 uniform < 1 - rate, a select
    dropout_impl: str = "kernel"
    compute_dtype: str = "bfloat16"
    param_dtype: str = "float32"
    causal: bool = False  # GPT-2 family
    # RoBERTa-style embeddings (pad-offset position ids, no token types)
    roberta_style: bool = False
    pad_token_id: int = 0
    # tanh-approximate GELU (the JAX default); False is BERT's erf GELU
    gelu_approximate: bool = True
    # recompute the attention core (scores, softmax, probs dropout) in the
    # backward instead of saving the probs; "reference" attention only
    attention_remat: bool = True
    # "fused": the LayerNorm kernels; "reference": the plain float32 math
    # under autograd on every device (ops/layer_norm.py)
    layernorm_impl: str = "fused"
    # per-layer remat: each layer (BERT, GPT-2, the scanned trunk's layer
    # i, a branch's or a stage's) recomputes its forward in the backward
    # (``models/bert.remat_call``, ``torch.utils.checkpoint``)
    remat: bool = False
    # what per-layer remat saves: "nothing" (full recompute), "dots" (every
    # matmul output), "weight_dots" (the unbatched projections only)
    remat_policy: str = "nothing"
    # recompute only each GPT-2 block's MLP tail (mlp_up -> gelu ->
    # mlp_down -> dropout), a plain checkpoint
    remat_mlp: bool = False
    # the stacked trunk (models/bert.py ScannedLayers, ``layers_scan``);
    # train_mp's branch and stage modes keep per-layer modules
    scan_layers: bool = False
    # paged serving: a chunk of more than one token is appended at
    # context_len of an EXISTING context and attends through the 4-D-query
    # paged kernel (speculative verify, chunked prefill, prefix-hit tails);
    # False keeps the fresh-prefill branch
    paged_multiquery: bool = False

    def __post_init__(self):
        if self.attention_impl not in ("reference", "flash", "ring"):
            raise ValueError(
                f"attention_impl must be reference/flash/ring, got "
                f"{self.attention_impl!r}"
            )
        if self.matmul_impl not in ("native", "int8", "int8_full"):
            raise ValueError(
                f"matmul_impl must be native/int8/int8_full, got "
                f"{self.matmul_impl!r}"
            )
        if (self.quant_delayed and self.quant_delayed_grads
                and self.matmul_impl == "int8"):
            # JAX's QuantDenseGeneral check
            raise ValueError(
                "delayed_grads implements the 'full' backward layout only "
                "(got mode='fwd')"
            )
        # JAX raises these where the stream or the LayerNorm runs
        # (raw_dropout, layer_norm); a config cannot reach a run with them
        if self.dropout_impl not in DROPOUT_IMPLS:
            raise ValueError(f"unknown dropout impl {self.dropout_impl!r}; "
                             f"have {DROPOUT_IMPLS}")
        if self.layernorm_impl not in LAYERNORM_IMPLS:
            raise ValueError(f"unknown layernorm impl "
                             f"{self.layernorm_impl!r}; have "
                             f"{LAYERNORM_IMPLS}")
        # JAX's remat checks, eagerly: a misspelt policy, or one set without
        # remat, must not pass unnoticed
        if self.remat_policy not in ("nothing", "dots", "weight_dots"):
            raise ValueError(
                f"remat_policy must be nothing/dots/weight_dots, got "
                f"{self.remat_policy!r}"
            )
        if self.remat_policy != "nothing" and not self.remat:
            warnings.warn(
                f"remat_policy={self.remat_policy!r} has no effect without "
                f"remat=True",
                stacklevel=2,
            )
        if self.remat_mlp and self.remat:
            # the layer checkpoint already recomputes the MLP; the nested
            # one only recomputes it a second time
            warnings.warn(
                "remat_mlp=True is redundant under remat=True (the layer "
                "checkpoint already recomputes the MLP); the nested "
                "checkpoint only adds recompute",
                stacklevel=2,
            )
        if self.hidden_size % self.num_heads:
            raise ValueError(
                f"hidden_size {self.hidden_size} is not a multiple of "
                f"num_heads {self.num_heads}"
            )

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


_MODEL_PRESETS: dict[str, dict[str, Any]] = {
    "bert-base-cased": dict(
        vocab_size=28996, hidden_size=768, num_layers=12, num_heads=12,
        intermediate_size=3072,
    ),
    "bert-large-cased": dict(
        vocab_size=28996, hidden_size=1024, num_layers=24, num_heads=16,
        intermediate_size=4096,
    ),
    "roberta-large": dict(
        vocab_size=50265, hidden_size=1024, num_layers=24, num_heads=16,
        intermediate_size=4096, max_position_embeddings=514,
        type_vocab_size=1, roberta_style=True, pad_token_id=1,
        layer_norm_eps=1e-5,
    ),
    "gpt2-medium": dict(
        vocab_size=50257, hidden_size=1024, num_layers=24, num_heads=16,
        intermediate_size=4096, max_position_embeddings=1024,
        type_vocab_size=0, causal=True, layer_norm_eps=1e-5,
        # trains with the flash kernels, as the JAX preset does; serving
        # never reads it (decode attention is the paged path)
        attention_impl="flash",
    ),
    # tiny configs for tests and smoke runs
    "tiny": dict(
        vocab_size=1024, hidden_size=64, num_layers=2, num_heads=4,
        intermediate_size=128, max_position_embeddings=128,
    ),
    "gpt2-tiny": dict(
        vocab_size=1024, hidden_size=64, num_layers=2, num_heads=4,
        intermediate_size=128, max_position_embeddings=128,
        type_vocab_size=0, causal=True, layer_norm_eps=1e-5,
    ),
}


def model_preset(name: str, **overrides: Any) -> ModelConfig:
    if name not in _MODEL_PRESETS:
        raise KeyError(
            f"unknown model preset {name!r}; have {sorted(_MODEL_PRESETS)}"
        )
    kwargs = dict(_MODEL_PRESETS[name])
    kwargs.update(overrides)
    return ModelConfig(**kwargs)


@dataclasses.dataclass
class TrainConfig:
    """Training hyperparameters, with the JAX package's defaults (the
    reference recipe): lr 2e-5, 3 epochs, seed 42, global batch 96 = micro
    8 x accumulation 12, eval batch 32, linear warmup 100, AdamW with bias
    correction, bf16 compute, sequences of 128.

    The fields are JAX's, less ``prng_impl`` (the port has one dropout
    generator). The trainer (``train/loop.py``) checks the values JAX's
    trainer checks, with its messages.
    """

    learning_rate: float = 2e-5
    num_epochs: int = 3
    seed: int = 42
    global_batch_size: int = 96
    micro_batch_size: int = 8
    eval_batch_size: int = 32
    warmup_steps: int = 100
    weight_decay: float = 0.0
    # global-norm clipping; 0 is off, as the reference never clips
    max_grad_norm: float = 0.0
    adam_b1: float = 0.9
    adam_b2: float = 0.999
    adam_eps: float = 1e-8
    # the AdamW moments' storage dtypes ("float32" or "bfloat16"); the
    # update's arithmetic is float32 either way (train/optim.py)
    adam_mu_dtype: str = "float32"
    adam_nu_dtype: str = "float32"
    bf16: bool = True
    # the gradient-accumulation carry's dtype: each microbatch's gradient
    # is rounded to it and added, and the optimizer takes the carry in it
    # (train/step.py); "bfloat16" rounds, "float32" is exact
    grad_accum_dtype: str = "float32"
    max_seq_length: int = 128
    # 0 = the full dataset; > 0 truncates (smoke and integration runs)
    train_size: int = 0
    eval_size: int = 0
    log_every: int = 50
    # sharded checkpoints (train/checkpoint.py): saved at each epoch's end
    # and every checkpoint_every_steps updates (0 = per epoch only); with
    # resume, a run starts from the newest verified step there
    checkpoint_dir: str | None = None
    checkpoint_every_steps: int = 0
    resume: bool = False
    # a WordPiece vocab.txt for real GLUE text; None = the hash tokenizer
    vocab_path: str | None = None
    # integrity level a restore verifies each step at (train/manifest.py):
    # "size" (file sizes), "digest" (sha256 of every file) or "off"; a
    # latest step that fails falls back to the newest verified one
    checkpoint_verify: str = "size"
    # fault injection: rank ``crash_rank`` hard-exits (``os._exit``, no
    # cleanup) right after completing update ``crash_at_step``; 0 is off
    crash_at_step: int = 0
    crash_rank: int = 0
    # SIGTERM/SIGINT stop the run at the next step boundary with an
    # emergency checkpoint (inside preempt_grace_s, else a log line), a
    # ``preemption`` record and exit 75 (faults/preemption.py)
    handle_preemption: bool = True
    preempt_grace_s: float = 30.0
    # the hung-step watchdog (faults/watchdog.py) around the step and the
    # checkpoint saves: a ``watchdog_stall`` record after max(min_stall_s,
    # stall_factor x the section's rolling median), exit 84 past
    # hard_timeout_s (0: never)
    watchdog: bool = True
    watchdog_stall_factor: float = 10.0
    watchdog_min_stall_s: float = 60.0
    watchdog_hard_timeout_s: float = 1800.0
    # rank 0 appends a JSONL stream here (telemetry/sink.py): the
    # ``run_meta`` header, per-step timings (data wait, dispatch, device
    # block: each step synchronizes on the device), per-epoch records with
    # the straggler stats, checkpoint, restart and fault events; read it
    # with scripts/summarize_metrics.py
    metrics_dir: str | None = None
    # "text" | "json": json makes the loggers write one JSON object a line
    log_format: str = "text"
    # a torch.profiler trace of the epochs (CPU and CUDA activities) under
    # this directory, under host_<rank> at world size > 1
    # (utils/profiling.py); None: off
    profile_dir: str | None = None
    # raise FloatingPointError at the first NaN in a module's forward
    # output or in a gradient (utils/profiling.py); synchronizes
    debug_nans: bool = False
    # train and eval batch assembly: "auto" the C++ batcher (native/) when
    # g++ builds it, else the Python loader; "on" requires it; "off" the
    # Python loader (data/native_loader.py, data/pipeline.py)
    native_loader: str = "auto"
    # train batches assembled and copied to the device this many batches
    # ahead on a background thread (data/prefetch.py); the order is the
    # loader's, bit for bit; 0 assembles and copies on the step thread
    prefetch_depth: int = 2
    # optimizer updates run back to back with no host synchronize between
    # them; loss is the chain's float32 mean, the other metrics the last
    # step's, and the log and checkpoint cadences fall on chain ends
    chain_steps: int = 1
    # "auto" | "on" | "off": JAX's accumulation-scan unrolling; the eager
    # microbatch loop is one schedule, so no value changes the math
    unroll_accum: str = "auto"
    # the kernel and native libraries' build directory (train/compile.py):
    # a second run with the same code loads them instead of compiling;
    # None: the package's ignored _build/
    compile_cache_dir: str | None = None
    # warm start: build and load every library the run launches before
    # epoch 0, so the first step is a steady-state one (no
    # compile_inclusive) and the build gets its own `compile` record
    aot_warmup: bool = True
    # runtime guards (analysis/guards.py): "record" counts a recompile (a
    # step at a new signature, or a kernel build, after warm-up) or an
    # implicit transfer in a warm step and emits telemetry, and runs the
    # sharding and first-step collective audits; "strict" raises on any
    # of them; "off" disables the layer. PDT_TPU_GUARDS overrides it.
    guards: str = "record"

    @property
    def grad_accum_steps(self) -> int:
        """The global batch split into micro batches."""
        if self.global_batch_size % self.micro_batch_size:
            raise ValueError(
                f"global_batch_size {self.global_batch_size} must be divisible "
                f"by micro_batch_size {self.micro_batch_size}"
            )
        return self.global_batch_size // self.micro_batch_size


def add_dataclass_args(parser: argparse.ArgumentParser, cls) -> None:
    """Register every field of a dataclass as a typed CLI flag; booleans
    become ``--flag/--no-flag`` pairs."""
    for f in dataclasses.fields(cls):
        name = f"--{f.name.replace('_', '-')}"
        default = f.default if f.default is not dataclasses.MISSING else None
        ftype = f.type if isinstance(f.type, type) else str(f.type)
        if ftype in (bool, "bool"):
            parser.add_argument(
                name, action=argparse.BooleanOptionalAction, default=default
            )
        elif ftype in (int, "int"):
            parser.add_argument(name, type=int, default=default)
        elif ftype in (float, "float"):
            parser.add_argument(name, type=float, default=default)
        else:
            parser.add_argument(name, type=str, default=default)


def dataclass_from_args(cls, args: argparse.Namespace):
    """The dataclass from the flags ``add_dataclass_args`` registered."""
    return cls(**{f.name: getattr(args, f.name)
                  for f in dataclasses.fields(cls) if hasattr(args, f.name)})
