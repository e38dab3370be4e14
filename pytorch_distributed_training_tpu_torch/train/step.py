"""Train and eval steps with gradient accumulation (counterpart: the JAX
package's ``train/step.py`` ``make_train_step`` / ``make_eval_step``).

- ``train_step(state, batch)``: batch leaves are ``[accum, micro, ...]``.
  Each microbatch's mean masked cross-entropy is scaled by ``1/accum``
  before its backward, so the accumulated gradient IS the mean gradient
  (the JAX step folds the scale into the loss the same way). Under DDP,
  every microbatch but the last runs in ``no_sync()``, so gradients cross
  the ranks once per optimizer step. Then ``grad_norm`` over the float32
  gradients and one optimizer update. The loss returned is the sum of the
  scaled microbatch losses (= the mean), averaged over the ranks.
- ``eval_step(state, batch)``: forward and argmax; the masked counts
  ``correct/total/tp/fp/fn`` under ``valid`` (positive label 1).

Dropout: microbatch m of update ``step`` on ``rank`` draws from
``fold_in(fold_in(fold_in(state.dropout_seed, step), m), rank)``, the
counterpart of ``fold_in(fold_in(dropout_rng, step), m)`` and of the JAX
kernels' per-shard seed offset. The forward saves what its backward needs;
the model's kernels regenerate masks from the same seeds.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch.nn.parallel import DistributedDataParallel

from pytorch_distributed_training_tpu_torch.comms.collectives import (
    all_reduce_mean,
)
from pytorch_distributed_training_tpu_torch.ops.dropout import fold_in
from pytorch_distributed_training_tpu_torch.train.optim import global_norm
from pytorch_distributed_training_tpu_torch.train.state import TrainState


def classification_loss(logits: torch.Tensor, labels: torch.Tensor,
                        valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean masked softmax cross-entropy over one microbatch, in fp32."""
    ce = F.cross_entropy(logits.float(), labels.long(), reduction="none")
    if valid is None:
        valid = torch.ones_like(ce)
    valid = valid.float()
    return (ce * valid).sum() / torch.clamp(valid.sum(), min=1.0)


def microbatch_seed(dropout_seed: int, step: int, micro: int,
                    rank: int) -> int:
    return fold_in(fold_in(fold_in(dropout_seed, step), micro), rank)


def _forward(model, micro, dropout_seed=None):
    return model(micro["input_ids"], micro.get("attention_mask"),
                 micro.get("token_type_ids"), dropout_seed=dropout_seed)


def make_train_step(*, grad_accum_steps: int, rank: int = 0) -> Callable:
    """Build the train step for this rank."""
    inv_accum = 1.0 / grad_accum_steps

    def train_step(state: TrainState, batch: dict) -> dict:
        model = state.model
        ddp = isinstance(model, DistributedDataParallel)
        state.optimizer.zero_grad(set_to_none=True)
        loss_sum = None
        for m in range(grad_accum_steps):
            micro = {k: v[m] for k, v in batch.items()}
            seed = microbatch_seed(state.dropout_seed, state.step, m, rank)
            sync = not ddp or m == grad_accum_steps - 1
            with contextlib.nullcontext() if sync else model.no_sync():
                logits = _forward(model, micro, seed)
                loss = classification_loss(logits, micro["labels"],
                                           micro.get("valid")) * inv_accum
                loss.backward()
            loss = loss.detach()
            loss_sum = loss if loss_sum is None else loss_sum + loss
        grads = [p.grad for p in state.module.parameters()
                 if p.grad is not None]
        grad_norm = global_norm(grads)
        state.optimizer.step()
        state.step += 1
        return {"loss": all_reduce_mean(loss_sum), "grad_norm": grad_norm}

    return train_step


def make_eval_step() -> Callable:
    """Build the eval step -> scalar count tensors on the device."""

    @torch.no_grad()
    def eval_step(state: TrainState, batch: dict) -> dict:
        logits = _forward(state.module, batch)
        preds = torch.argmax(logits.float(), dim=-1)
        labels = batch["labels"].long()
        valid = batch.get("valid")
        valid = (torch.ones_like(labels) if valid is None else valid).float()
        pos_pred = (preds == 1).float() * valid
        pos_label = (labels == 1).float() * valid
        return {
            "correct": ((preds == labels).float() * valid).sum(),
            "total": valid.sum(),
            "tp": (pos_pred * pos_label).sum(),
            "fp": (pos_pred * (1.0 - pos_label)).sum(),
            "fn": ((1.0 - pos_pred) * pos_label).sum(),
        }

    return eval_step
