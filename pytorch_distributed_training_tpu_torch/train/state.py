"""Training state: everything a step reads and mutates, together
(counterpart: the JAX package's ``train/state.py`` ``TrainState``).

The JAX state is one immutable pytree (params, optimizer state, step, the
base dropout key) threaded through a jitted step. Here the parameters live
in the model, which the step updates in place, so the state holds the
model (DDP-wrapped when data-parallel; under FSDP the module itself,
sharded in place), the bare module for evaluation,
the optimizer (moments and its update count), the optimizer step counter
and the base dropout seed; under tensor parallelism, ``tp``: the dim each
parameter cut over the model axis is cut on, and the axis, which a
checkpoint reads to save those slices whole (``train/checkpoint.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from torch import nn

from pytorch_distributed_training_tpu_torch.ops.dropout import fold_in
from pytorch_distributed_training_tpu_torch.train.optim import AdamW

_DROPOUT_STREAM = 1  # fold_in(seed, .) of the base dropout seed


@dataclasses.dataclass
class TrainState:
    model: nn.Module      # what the train step calls (DDP, or FSDP's module)
    module: nn.Module     # the bare model (eval, weights)
    optimizer: AdamW
    dropout_seed: int
    step: int = 0         # optimizer updates applied
    tp: Optional[tuple] = None  # ({name: dim}, AxisShard) of the TP cut


def create_train_state(model: nn.Module, optimizer: AdamW, seed: int, *,
                       wrapped: nn.Module | None = None) -> TrainState:
    """State of a fresh run: the parameters were made from ``seed`` (by
    the caller's generator); the dropout seed is derived from it too."""
    return TrainState(
        model=wrapped if wrapped is not None else model, module=model,
        optimizer=optimizer, dropout_seed=fold_in(seed, _DROPOUT_STREAM),
    )
