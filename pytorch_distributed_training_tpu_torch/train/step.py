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
- The accumulation carry (``accum_dtype``, JAX ``train/step.py:311-
  349``): "float32" accumulates in ``.grad`` as above. A narrower dtype
  ("bfloat16") is JAX's ``a + g.astype(acc_dtype)``: after each
  microbatch's backward its gradient is rounded to the carry dtype and
  added to the carry (``GradCarry``), and the optimizer takes the carry in
  that dtype (``train/optim.py`` upcasts per tensor). Under DDP every
  microbatch runs in ``no_sync()``, so each rank rounds its own gradient
  before the average, and the carry is averaged once over the gradient
  axes (in float32, then rounded again). Under FSDP each microbatch's
  reduce-scatter runs (FSDP2 keeps the gradients of unsynced backwards
  inside its unsharded parameters), so a shard's carry adds the rounded
  global microbatch gradient, as JAX's does; the replicated parameters
  round before their average. The float32 ``.grad`` of a microbatch
  exists beside the carry, so the narrow carry can raise the peak by the
  carry's bytes; it saves no memory in eager mode.
- ``unroll_accum`` (JAX's accumulation-scan unrolling): the microbatch
  loop is eager, one schedule; JAX pins rolled equal to unrolled, so the
  setting changes nothing here (the trainer checks its value).
- Chaining (``chain_steps`` > 1, JAX :364-376): ``train_step(state,
  batches)`` takes a list of ``chain_steps`` batches and runs their
  updates back to back with no host synchronize between them; ``loss``
  is the float32 mean of the steps' losses, the other metrics the last
  step's.
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
    torch_dtype,
)
from pytorch_distributed_training_tpu_torch.train.state import TrainState
from pytorch_distributed_training_tpu_torch.utils.profiling import (
    check_grads,
)


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


class GradCarry:
    """The accumulation carry in a dtype narrower than float32: ``add``
    rounds each parameter's ``.grad`` to ``dtype``, adds it to the
    parameter's carry and clears ``.grad`` (a ``DTensor`` gradient stays
    one); ``grads`` maps each parameter to its carry."""

    def __init__(self, dtype: torch.dtype):
        self.dtype = dtype
        self.grads: dict = {}

    def add(self, params) -> None:
        for p in params:
            if p.grad is None:
                continue
            g = p.grad.to(self.dtype)
            prev = self.grads.get(p)
            self.grads[p] = g if prev is None else prev + g
            p.grad = None


def chained(step: Callable) -> Callable:
    """``step`` over a list of batches, back to back: the float32 mean of
    their losses, the last step's other metrics (JAX :364-376)."""

    def train_step(state: TrainState, batches) -> dict:
        outs = [step(state, batch) for batch in batches]
        out = dict(outs[-1])
        out["loss"] = torch.stack([o["loss"] for o in outs]).float().mean()
        return out

    return train_step


def make_train_step(*, grad_accum_steps: int,
                    objective: str = "classification",
                    mesh: Optional[Mesh] = None,
                    grad_norm: Callable = plain_grad_norm,
                    accum_dtype: str = "float32",
                    chain_steps: int = 1) -> Callable:
    """Build the train step for this rank of ``mesh`` (None: one
    process). ``grad_norm(params, grads)`` is the reported norm
    (``train/optim.py``); ``accum_dtype`` the carry's dtype and
    ``chain_steps`` the updates a call runs (see the module
    docstring)."""
    inv_accum = 1.0 / grad_accum_steps
    mesh = mesh or build_mesh()
    shard, last = batch_index(mesh), _last_stage(mesh)
    carry_dtype = torch_dtype(accum_dtype)
    narrow = carry_dtype != torch.float32

    def train_step(state: TrainState, batch: dict) -> dict:
        model = state.model
        ddp = isinstance(model, DistributedDataParallel)
        fsdp = isinstance(model, FSDPModule)
        state.optimizer.zero_grad(set_to_none=True)
        carry = GradCarry(carry_dtype) if narrow else None
        loss_sum = None
        for m in range(grad_accum_steps):
            micro = {k: v[m] for k, v in batch.items()}
            seed = microbatch_seed(state.dropout_seed, state.step, m, shard)
            sync = m == grad_accum_steps - 1
            if fsdp:
                model.set_requires_gradient_sync(sync or narrow)
            with (model.no_sync() if ddp and (narrow or not sync)
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
            if carry is not None:
                carry.add(state.module.parameters())
        # FSDP's ignored parameters: replicated, reduced here; under DDP a
        # narrow carry, which no backward reduced
        average = is_replicated if fsdp else (
            every if ddp and narrow else None)
        return finish_step(state, loss_sum, mesh, grad_norm,
                           average=average, carry=carry)

    return chained(train_step) if chain_steps > 1 else train_step


def is_replicated(p) -> bool:
    return not is_sharded(p)


def every(p) -> bool:
    return True


def finish_step(state: TrainState, loss_sum: torch.Tensor, mesh: Mesh,
                grad_norm: Callable, *,
                average: Optional[Callable] = None,
                carry: Optional[GradCarry] = None) -> dict:
    """The rest of a train step once its backwards have run: the
    gradients (``.grad``, or ``carry``'s) of the parameters ``average``
    picks averaged over the gradient axes (``grad_group``; a carry's in
    float32, rounded back), the grad norm, one optimizer update, and the
    step's loss (``loss_sum``, this rank's) summed over the stage and seq
    axes and averaged over the batch axes."""
    if carry is None:
        params = [p for p in state.module.parameters() if p.grad is not None]
        if average is not None:
            average_([p.grad for p in params if average(p)],
                     mesh.grad_group)
        grads = None
        held = [p.grad for p in params]
    else:
        grads = carry.grads
        params = list(grads)
        if average is not None:
            picked = [p for p in params if average(p)]
            work = [grads[p].float() for p in picked]
            average_(work, mesh.grad_group)
            for p, w in zip(picked, work):
                grads[p] = w.to(carry.dtype)
        held = [grads[p] for p in params]
    check_grads(state.module, params, held)
    norm = grad_norm(params, held)
    if grads is None:
        state.optimizer.step()
    else:
        state.optimizer.step(grads=grads)
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
