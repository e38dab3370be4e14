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

``make_train_step`` and ``make_eval_step`` take ``objective``:
``"classification"`` (the above) or ``"causal_lm"``, where the loss is the
mean next-token cross-entropy over the positions ``lm_shift_and_mask``
keeps and the eval step returns ``nll_sum``, ``token_count`` and
``token_correct``.

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


def lm_shift_and_mask(micro: dict):
    """Next-token targets and per-position weights of a causal-LM batch:
    position t predicts token t + 1. A roll by -1 keeps the [B, S] shape;
    the rolled-in last position is masked, as are pad targets (the rolled
    ``attention_mask``) and padded eval rows (``valid``)."""
    ids = micro["input_ids"].long()
    targets = torch.roll(ids, -1, dims=1)
    mask = micro.get("attention_mask")
    mask = (torch.ones_like(ids, dtype=torch.float32) if mask is None
            else torch.roll(mask, -1, dims=1).float())
    mask[:, -1] = 0.0
    valid = micro.get("valid")
    if valid is not None:
        mask = mask * valid.float()[:, None]
    return targets, mask


def causal_lm_loss(logits: torch.Tensor, micro: dict) -> torch.Tensor:
    """Mean next-token cross-entropy per kept target position, in fp32."""
    targets, mask = lm_shift_and_mask(micro)
    ce = F.cross_entropy(logits.float().flatten(0, 1), targets.flatten(),
                         reduction="none").view_as(mask)
    return (ce * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def _loss(objective: str, logits, micro):
    if objective == "causal_lm":
        return causal_lm_loss(logits, micro)
    if objective == "classification":
        return classification_loss(logits, micro["labels"],
                                   micro.get("valid"))
    raise ValueError(f"unknown objective {objective!r}")


def microbatch_seed(dropout_seed: int, step: int, micro: int,
                    rank: int) -> int:
    return fold_in(fold_in(fold_in(dropout_seed, step), micro), rank)


def _forward(model, micro, dropout_seed=None):
    return model(micro["input_ids"], micro.get("attention_mask"),
                 micro.get("token_type_ids"), dropout_seed=dropout_seed)


def make_train_step(*, grad_accum_steps: int, rank: int = 0,
                    objective: str = "classification") -> Callable:
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
                loss = _loss(objective, logits, micro) * inv_accum
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


def make_eval_step(objective: str = "classification") -> Callable:
    """Build the eval step -> scalar count tensors on the device."""

    @torch.no_grad()
    def lm_eval_step(state: TrainState, batch: dict) -> dict:
        logits = _forward(state.module, batch).float()
        targets, mask = lm_shift_and_mask(batch)
        ce = F.cross_entropy(logits.flatten(0, 1), targets.flatten(),
                             reduction="none").view_as(mask)
        preds = torch.argmax(logits, dim=-1)
        return {
            "nll_sum": (ce * mask).sum(),
            "token_count": mask.sum(),
            "token_correct": ((preds == targets).float() * mask).sum(),
        }

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

    if objective == "causal_lm":
        return lm_eval_step
    if objective != "classification":
        raise ValueError(f"unknown objective {objective!r}")
    return eval_step
