"""Model configuration for the port (counterpart: the JAX package's
``utils/config.py`` ``ModelConfig`` and ``model_preset``).

Only the fields the serving path of the GPT-2 family reads are kept; the
preset values are the JAX package's own, so a preset name means the same
model in both packages.
"""

from __future__ import annotations

import dataclasses
from typing import Any

_ROADMAP = "see ROADMAP.md, queue 1"


@dataclasses.dataclass
class ModelConfig:
    """Decoder hyperparameters and the dtype policy.

    dtype policy (as in the JAX package): parameters in ``param_dtype``
    (float32), matmuls and the residual stream in ``compute_dtype``
    (bfloat16 by default), LayerNorm and softmax statistics in float32,
    logits in float32.
    """

    vocab_size: int = 50257
    hidden_size: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    intermediate_size: int = 4096
    max_position_embeddings: int = 1024
    layer_norm_eps: float = 1e-5
    # full-sequence (non-paged) attention: "reference" is the plain einsum
    # path; "flash" names the JAX package's Pallas kernel, not yet ported
    attention_impl: str = "reference"
    # only "native" matmuls are ported (int8 waits for its slice)
    matmul_impl: str = "native"
    compute_dtype: str = "bfloat16"
    param_dtype: str = "float32"
    causal: bool = True

    def __post_init__(self):
        if self.attention_impl not in ("reference", "flash"):
            raise ValueError(
                f"attention_impl must be reference/flash, got "
                f"{self.attention_impl!r}"
            )
        if self.matmul_impl != "native":
            raise NotImplementedError(
                f"matmul_impl={self.matmul_impl!r} is not ported yet "
                f"(int8 matmuls, {_ROADMAP})"
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
    "gpt2-medium": dict(
        vocab_size=50257, hidden_size=1024, num_layers=24, num_heads=16,
        intermediate_size=4096, max_position_embeddings=1024,
        layer_norm_eps=1e-5,
        # the JAX preset trains with Pallas flash attention; serving never
        # reads it (decode attention is the paged path)
        attention_impl="flash",
    ),
    "gpt2-tiny": dict(
        vocab_size=1024, hidden_size=64, num_layers=2, num_heads=4,
        intermediate_size=128, max_position_embeddings=128,
        layer_norm_eps=1e-5,
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
