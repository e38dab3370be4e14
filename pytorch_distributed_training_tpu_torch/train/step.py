"""Train and eval steps with gradient accumulation (counterpart: the JAX
package's ``train/step.py`` ``make_train_step`` / ``make_eval_step``).

- ``train_step(state, batch)``: batch leaves are ``[accum, micro, ...]``.
  Each microbatch's mean masked cross-entropy is scaled by ``1/accum``
  before its backward, so the accumulated gradient IS the mean gradient
  (the JAX step folds the scale into the loss the same way). Under DDP,
  every microbatch but the last runs in ``no_sync()``, and under FSDP
  (``parallel/sharding.py``) with ``set_requires_gradient_sync(False)``,
  so gradients cross the ranks of the batch axes ``(data, fsdp)`` once per
  optimizer step: DDP's all-reduce, or FSDP's reduce-scatter of each
  sharded parameter's gradient, with the replicated parameters' (FSDP's
  ignored ones) averaged over the batch group here. Then ``grad_norm``
  over the float32 gradients (over the whole model when it is split or
  sharded over ranks, ``train/optim.py``) and one optimizer update. The
  loss returned is the sum of the scaled microbatch losses (= the mean),
  averaged over the batch axes.
- ``eval_step(state, batch)``: forward and argmax; the masked counts
  ``correct/total/tp/fp/fn`` under ``valid`` (positive label 1).

Both take the rank's ``mesh`` (``comms/mesh.py``). Under the layer split
(``models/stage.py``) only the last stage has logits: the earlier stages'
forward returns a token whose ``backward()`` runs theirs, and they count
a loss and eval counts of zero, which the sums over the ``stage`` axis
leave exact.

``make_train_step`` and ``make_eval_step`` take ``objective``:
``"classification"`` (the above) or ``"causal_lm"``, where the loss is the
mean next-token cross-entropy over the positions ``lm_shift_and_mask``
keeps and the eval step returns ``nll_sum``, ``token_count`` and
``token_correct``.

Context parallelism (a ``seq`` axis of P ranks, each holding S/P columns
of every row): the LM targets and their mask are shifted on the whole row
before the loader cuts it (``lm_whole_rows``, the loader's
``whole_rows``), so the last column of each shard keeps its target, and
this shard's loss is its sum over the microbatch's count of kept targets
on the whole row; the classification head runs on every seq rank from
the CLS row of seq coordinate 0 (``models/bert.py``), each rank counting
1/P of its loss. The shards' losses sum over ``seq`` to the microbatch's;
the gradients are reduced over ``(data, fsdp, seq)`` (``grad_group``), so
each backward runs on P times its share. The eval counts are summed over
``seq`` (the classification counts taken at seq coordinate 0 only).
Tensor parallelism changes nothing here: every model rank computes the
same loss.

Delayed int8 (``ops/quant.py``): the amaxes ride the accumulation loop
in the int8 sites' buffers (``models/bert.py``), as JAX's scan carry
holds them: microbatch m quantizes on m - 1's, the first of step n on
step n - 1's last. ``calibrate_quant`` observes them before step 0.

Dropout: microbatch m of update ``step`` on batch shard ``rank``
(``comms/mesh.batch_index``) draws from ``fold_in(fold_in(fold_in(
state.dropout_seed, step), m), rank)``, the counterpart of
``fold_in(fold_in(dropout_rng, step), m)`` and of the JAX kernels'
per-shard seed offset (``ops/dispatch.py``); the ranks of one batch shard
(its model and stage ranks) draw alike. The forward saves what its
backward needs; the model's kernels regenerate masks from the same seeds.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch.distributed.fsdp import FSDPModule
from torch.nn.parallel import DistributedDataParallel

from pytorch_distributed_training_tpu_torch.comms.collectives import (
    all_reduce_mean,
    all_reduce_sum,
    average_,
)
from pytorch_distributed_training_tpu_torch.comms.mesh import (
    AXIS_SEQ,
    AXIS_STAGE,
    Mesh,
    batch_index,
    build_mesh,
)
from pytorch_distributed_training_tpu_torch.models.convert import (
    is_quant_name,
)
from pytorch_distributed_training_tpu_torch.ops.dropout import fold_in
from pytorch_distributed_training_tpu_torch.ops.quant import (
    dy_calibration_mode,
)
from pytorch_distributed_training_tpu_torch.train.optim import (
    is_sharded,
    plain_grad_norm,
)
from pytorch_distributed_training_tpu_torch.train.state import TrainState


CLASSIFICATION_COUNTS = ("correct", "total", "tp", "fp", "fn")


def classification_loss(logits: torch.Tensor, labels: torch.Tensor,
                        valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean masked softmax cross-entropy over one microbatch, in fp32."""
    ce = F.cross_entropy(logits.float(), labels.long(), reduction="none")
    if valid is None:
        valid = torch.ones_like(ce)
    valid = valid.float()
    return (ce * valid).sum() / torch.clamp(valid.sum(), min=1.0)


def lm_shift_and_mask(micro: dict):
    """Next-token targets and per-position weights of a causal-LM batch
    (leaves [..., B, S]): position t predicts token t + 1. A roll by -1
    keeps the shape; the rolled-in last position is masked, as are pad
    targets (the rolled ``attention_mask``) and padded eval rows
    (``valid``)."""
    ids = micro["input_ids"].long()
    targets = torch.roll(ids, -1, dims=-1)
    mask = micro.get("attention_mask")
    mask = (torch.ones_like(ids, dtype=torch.float32) if mask is None
            else torch.roll(mask, -1, dims=-1).float())
    mask[..., -1] = 0.0
    valid = micro.get("valid")
    if valid is not None:
        mask = mask * valid.float()[..., None]
    return targets, mask


def lm_whole_rows(batch: dict) -> dict:
    """``batch`` with its targets shifted on the whole rows, before the
    loader cuts the columns over ``seq``: ``lm_targets`` and ``lm_mask``
    ([..., B, S], cut with the ids) and ``lm_count``, each row's kept
    targets ([..., B], kept whole)."""
    targets, mask = lm_shift_and_mask(batch)
    return dict(batch, lm_targets=targets, lm_mask=mask,
                lm_count=mask.sum(-1))


def lm_targets(micro: dict):
    """(targets, mask, count): the next-token targets of this rank's
    columns, their weights, and the microbatch's count of kept targets
    (on the whole rows)."""
    if "lm_targets" in micro:
        return (micro["lm_targets"].long(), micro["lm_mask"],
                micro["lm_count"].sum())
    targets, mask = lm_shift_and_mask(micro)
    return targets, mask, mask.sum()


def causal_lm_loss(logits: torch.Tensor, micro: dict) -> torch.Tensor:
    """Next-token cross-entropy of this rank's kept target positions over
    the microbatch's count of them, in fp32: the mean on one rank, this
    shard's part of it under context parallelism."""
    targets, mask, count = lm_targets(micro)
    ce = F.cross_entropy(logits.float().flatten(0, 1), targets.flatten(),
                         reduction="none").view_as(mask)
    return (ce * mask).sum() / torch.clamp(count, min=1.0)


def _loss(objective: str, logits, micro):
    if objective == "causal_lm":
        return causal_lm_loss(logits, micro)
    if objective == "classification":
        return classification_loss(logits, micro["labels"],
                                   micro.get("valid"))
    raise ValueError(f"unknown objective {objective!r}")


def micro_loss(objective: str, out, micro, mesh: Mesh, scale: float):
    """The loss a microbatch's backward starts from on the last stage:
    this rank's part of the mean times ``scale`` (1/accumulation), and
    under context parallelism the classification head's 1/P share, all
    times P, as the gradients are averaged over the seq shards. Returns
    (what to backward, the loss to report)."""
    n_seq = mesh.shape[AXIS_SEQ]
    share = 1.0 / n_seq if objective == "classification" else 1.0
    loss = _loss(objective, out, micro) * share * scale
    return (loss * n_seq if n_seq > 1 else loss), loss


def quant_buffers(module) -> dict:
    """The delayed-int8 amax buffers of ``module`` by name."""
    return {n: b for n, b in module.named_buffers() if is_quant_name(n)}


def calibrate_quant(state: TrainState, micro: dict, *,
                    objective: str = "classification",
                    loss_scale: float = 1.0,
                    mesh: Optional[Mesh] = None) -> TrainState:
    """Observe the delayed-int8 amaxes on one microbatch before step 0
    (JAX ``train/step.py:118-169``): one deterministic forward whose sites
    carry the amaxes they observe; with ``quant_delayed_grads`` one more
    forward and a backward of the loss times ``loss_scale`` (the train
    step's 1/accumulation) inside ``dy_calibration_mode``, whose dy
    observations are kept, and the forward amaxes put back to the first
    pass's. No optimizer update; the gradients are dropped. A no-op for a
    model without delayed sites."""
    module = state.module
    buffers = quant_buffers(module)
    if not buffers:
        return state
    mesh = mesh or build_mesh()
    with dy_calibration_mode():
        with torch.no_grad():  # the sites observe in calibration mode
            _forward(module, micro)
        if any(n.endswith("dy_amax") for n in buffers):
            kept = {n: b.clone() for n, b in buffers.items()
                    if not n.endswith("dy_amax")}
            out = _forward(module, micro)
            if _last_stage(mesh):
                micro_loss(objective, out, micro, mesh, loss_scale)[0] \
                    .backward()
            else:  # the token of an earlier stage (models/stage.py)
                out.backward()
            for n, v in kept.items():
                buffers[n].copy_(v)
            for p in module.parameters():
                p.grad = None
    return state


def microbatch_seed(dropout_seed: int, step: int, micro: int,
                    rank: int) -> int:
    return fold_in(fold_in(fold_in(dropout_seed, step), micro), rank)


def _forward(model, micro, dropout_seed=None):
    return model(micro["input_ids"], micro.get("attention_mask"),
                 micro.get("token_type_ids"), dropout_seed=dropout_seed)


def _last_stage(mesh: Mesh) -> bool:
    return mesh.coord(AXIS_STAGE) == mesh.shape[AXIS_STAGE] - 1


def make_train_step(*, grad_accum_steps: int,
                    objective: str = "classification",
                    mesh: Optional[Mesh] = None,
                    grad_norm: Callable = plain_grad_norm) -> Callable:
    """Build the train step for this rank of ``mesh`` (None: one
    process). ``grad_norm(params, grads)`` is the reported norm
    (``train/optim.py``)."""
    inv_accum = 1.0 / grad_accum_steps
    mesh = mesh or build_mesh()
    shard, last = batch_index(mesh), _last_stage(mesh)

    def train_step(state: TrainState, batch: dict) -> dict:
        model = state.model
        ddp = isinstance(model, DistributedDataParallel)
        fsdp = isinstance(model, FSDPModule)
        state.optimizer.zero_grad(set_to_none=True)
        loss_sum = None
        for m in range(grad_accum_steps):
            micro = {k: v[m] for k, v in batch.items()}
            seed = microbatch_seed(state.dropout_seed, state.step, m, shard)
            sync = m == grad_accum_steps - 1
            if fsdp:
                model.set_requires_gradient_sync(sync)
            with (model.no_sync() if ddp and not sync
                  else contextlib.nullcontext()):
                out = _forward(model, micro, seed)
                if last:
                    grad_loss, loss = micro_loss(objective, out, micro,
                                                 mesh, inv_accum)
                    grad_loss.backward()
                else:  # the token of an earlier stage (models/stage.py)
                    out.backward()
                    loss = torch.zeros_like(out)
            loss = loss.detach()
            loss_sum = loss if loss_sum is None else loss_sum + loss
        # FSDP's ignored parameters: replicated, reduced here
        return finish_step(state, loss_sum, mesh, grad_norm,
                           average=is_replicated if fsdp else None)

    return train_step


def is_replicated(p) -> bool:
    return not is_sharded(p)


def finish_step(state: TrainState, loss_sum: torch.Tensor, mesh: Mesh,
                grad_norm: Callable, *,
                average: Optional[Callable] = None) -> dict:
    """The rest of a train step once its backwards have run: the
    gradients of the parameters ``average`` picks averaged over the
    gradient axes (``grad_group``), the grad norm, one optimizer update,
    and the step's loss (``loss_sum``, this rank's) summed over the stage
    and seq axes and averaged over the batch axes."""
    params = [p for p in state.module.parameters() if p.grad is not None]
    if average is not None:
        average_([p.grad for p in params if average(p)], mesh.grad_group)
    norm = grad_norm(params, [p.grad for p in params])
    state.optimizer.step()
    state.step += 1
    # the loss lives on the last stage (the others add zeros), in parts
    # over the seq shards, and is the same on every rank of the model axis
    for axis in (AXIS_STAGE, AXIS_SEQ):
        loss_sum = all_reduce_sum(loss_sum, mesh.group(axis))
    loss = all_reduce_mean(loss_sum, mesh.batch_group)
    return {"loss": loss, "grad_norm": norm}


def make_eval_step(objective: str = "classification",
                   mesh: Optional[Mesh] = None) -> Callable:
    """Build the eval step -> scalar count tensors on the device (zeros on
    a stage of ``mesh`` before the last, which hands its activations on,
    and, for classification, on a seq coordinate after the first, whose
    head computes the first's counts again)."""
    mesh = mesh or build_mesh()
    last = _last_stage(mesh) and mesh.coord(AXIS_SEQ) == 0

    @torch.no_grad()
    def lm_eval_step(state: TrainState, batch: dict) -> dict:
        logits = _forward(state.module, batch).float()
        targets, mask, _ = lm_targets(batch)
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
        if not last:
            return {k: torch.zeros((), device=logits.device)
                    for k in CLASSIFICATION_COUNTS}
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
