"""Model and training configuration for the port (counterpart: the JAX
package's ``utils/config.py`` ``ModelConfig``, ``model_preset``,
``TrainConfig``, ``add_dataclass_args`` and ``dataclass_from_args``).

The fields are those the ported paths read (GPT-2 serving, BERT
data-parallel fine-tuning, GPT-2 causal-LM training), with the JAX package's defaults, so
``ModelConfig()`` and a preset name mean the same model in both packages.
Options whose path is not ported yet raise ``NotImplementedError`` naming
the ROADMAP.md queue that holds them.
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Any

_ROADMAP = "see ROADMAP.md, queue 1"


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
    # path, "flash" the flash kernels (ops/flash_attention.py)
    attention_impl: str = "reference"
    # only "native" matmuls are ported (int8 waits for its slice)
    matmul_impl: str = "native"
    # only the "kernel" mask generator is ported (ops/dropout.py)
    dropout_impl: str = "kernel"
    compute_dtype: str = "bfloat16"
    param_dtype: str = "float32"
    causal: bool = False  # GPT-2 family
    pad_token_id: int = 0
    # tanh-approximate GELU (the JAX default); False is BERT's erf GELU
    gelu_approximate: bool = True
    # recompute the attention core (scores, softmax, probs dropout) in the
    # backward instead of saving the probs; "reference" attention only
    attention_remat: bool = True
    # only "fused" (the LayerNorm kernels) is ported
    layernorm_impl: str = "fused"
    remat: bool = False  # per-layer remat: not ported
    remat_policy: str = "nothing"  # what per-layer remat saves: not ported
    remat_mlp: bool = False  # remat of each block's MLP tail: not ported
    scan_layers: bool = False  # stacked trunk: not ported (models/convert.py
    #                            reads a scanned checkpoint all the same)

    def __post_init__(self):
        if self.attention_impl not in ("reference", "flash"):
            raise ValueError(
                f"attention_impl must be reference/flash, got "
                f"{self.attention_impl!r}"
            )
        not_ported = (
            ("matmul_impl", "native", "int8 matmuls, slice 5"),
            ("dropout_impl", "kernel", "the exact/bits32/bits8 dropout "
                                       "streams, slice 2 leftovers"),
            ("layernorm_impl", "fused", "the jnp-math LayerNorm switch, "
                                        "slice 2 leftovers"),
            ("remat", False, "per-layer remat, slice 3 leftovers"),
            ("remat_policy", "nothing", "per-layer remat, slice 3 leftovers"),
            ("remat_mlp", False, "MLP remat, slice 3 leftovers"),
            ("scan_layers", False, "the scanned trunk, slice 5"),
        )
        for name, ported, item in not_ported:
            if getattr(self, name) != ported:
                raise NotImplementedError(
                    f"{name}={getattr(self, name)!r} is not ported yet "
                    f"({item}; {_ROADMAP})"
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

    The fields are those the ported trainer reads; checkpoints, resume,
    the native loader, prefetch, telemetry, guards and chained steps wait
    in ROADMAP.md (queue 1, slice 2 leftovers).
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
    bf16: bool = True
    max_seq_length: int = 128
    # 0 = the full dataset; > 0 truncates (smoke and integration runs)
    train_size: int = 0
    eval_size: int = 0
    log_every: int = 50
    # a WordPiece vocab.txt for real GLUE text; None = the hash tokenizer
    vocab_path: str | None = None

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
