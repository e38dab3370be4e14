"""GPipe and 1F1B pipeline schedules over the mesh's ``stage`` axis
(counterpart: the JAX package's ``parallel/pipeline.py``).

The stage axis splits BERT's layers as ``--mp-mode stage`` does
(``models/stage.py`` ``BertStage``: stage 0 also holds the embeddings, the
last stage the pooler and classifier; one stage is
``BertForSequenceClassification`` itself), the reference's ConcatBert
split (reference test_model_parallelism.py:40-89). Stage mode passes one
microbatch at a time; the schedules stream ``n_micro`` pipeline
microbatches through the stages, so at steady state every stage works on
a different one. They are written by hand over point-to-point on the
stage axis (``comms/collectives.py`` ``exchange``: the sends and receives
of one step posted in one batch), where JAX writes a ``lax.scan`` of
ticks inside ``shard_map`` with ``ppermute``:

- ``gpipe_apply``: the forward of every pipeline microbatch in order, each
  received from stage s - 1 and sent on to stage s + 1; every
  microbatch's autograd graph is kept, as ``jax.grad`` of JAX's
  ``gpipe_apply`` keeps its activations;
- ``gpipe_grads``: ``gpipe_apply``, then the backwards in microbatch order
  0 … N - 1, the gradients passed down the reverse ring;
- ``one_f_one_b_grads``: JAX's tick table (:384-389): at tick t, stage s
  runs the forward of microbatch f = t - s and the backward of b = t -
  2(S - 1) + s, over ``n_micro + 2(S - 1)`` ticks; the last stage's loss
  of f is formed in the tick of its forward, its backward follows at once
  (JAX :500-517). A stage keeps the graphs of microbatches b … f, at most
  2(S - s) - 1, where JAX's stash holds 2S block inputs (:405) and
  recomputes the block in the backward tick, since a scan cannot keep a
  graph; the numbers agree, as the kernels draw their masks again from
  the seeds. Its idle share is ``pipeline_bubble`` = 2(S - 1) / (n_micro
  + 2(S - 1)) (JAX :767, :903); GPipe's is (S - 1) / (n_micro + S - 1).

Every backward is an explicit call in the schedule's order, so the
receives on stage s match the sends of stage s + 1 one for one, whatever
order the autograd engine would visit the graphs in.

``make_pipeline_train_step`` (``make_1f1b_train_step`` for 1F1B) is the
train step of ``--mp-mode pipeline|1f1b`` (``train/loop.py``; JAX trains
GPipe through ``GPipeClassifier`` and ``jax.grad``). Its batch comes from
the loader at ``grad_accum_steps × n_micro`` microbatches, so pipeline
microbatch j of accumulation microbatch m is the loader's microbatch k =
m·N + j: rows [j·M/N, (j + 1)·M/N) of micro-batch m (M its global rows,
split over the batch shards as JAX's stream is). It draws dropout from
``microbatch_seed(dropout_seed, step, k, batch_index)`` and adds its
masked mean cross-entropy × 1/(A·N) (A = ``grad_accum_steps``), which is
JAX's ``ce.sum() / (mb_rows · n_micro · accum)`` when every row is
valid; gradients accumulate and the loss sums in the order of k. So both
schedules equal ``--mp-mode stage`` at A·N microbatches of M/N rows. The
step takes no DDP: it averages the gradients over the batch group once
(``train/step.py`` ``finish_step``), since DDP's reducer, armed at each
forward, would fire on the wrong backward; under FSDP it syncs the
gradients only in the step's last backward. The eval runs stage mode's
forward, one microbatch at a time (JAX's ``serial_apply``).

The accumulation carry (``accum_dtype``, JAX :879-888 for 1F1B; JAX's
GPipe trains through the standard step, ``train/step.py``, which carries
the same way): after each accumulation microbatch's schedule, the
gradient it left in ``.grad`` is rounded to the carry dtype and added to
the carry (``train/step.py`` ``GradCarry``), before the once-a-step
average; under FSDP every accumulation microbatch's last backward syncs,
so the shards round the global gradient.

``GPipeClassifier`` is the GPipe forward of one micro-batch: logits of its
rows on the last stage.

Delayed int8 (``quant_delayed``, JAX :38-46): the amaxes live in the
stages' int8 sites (``models/bert.py``), so they stream through the
schedules as they ride stage mode's accumulation loop: pipeline
microbatch j of a stage quantizes with the amaxes microbatch j - 1
observed at that site (forwards run in microbatch order under both
schedules), and every amax is maxed over the batch shards as it is
observed, so the one carried out is the max across them. JAX's 1F1B
stashes the scales each forward used for its backward's recompute; here
the graphs are kept and each backward reads its scales from its autograd
context. Both schedules refuse ``quant_delayed_grads`` with JAX's
reasons.

Remat (``remat``, JAX ``gpipe_trunk_fn``'s ``jax.checkpoint(fn)`` around
the layer function the schedules call): each stage's forward (the ``run``
closures below) runs its layers through ``models/bert.run_layers``,
which checkpoints every layer under ``config.remat`` (``call_layer``), so
a schedule keeps each microbatch's layer inputs and recomputes the layer
in its backward; the delayed amaxes advance once, in the first forward
(``remat_call``).

Context parallelism (a ``seq`` axis): each stage's layers attend through
the ring on its seq coordinate's columns, the wire joins the stages of one
(data, fsdp, model, seq) coordinate (``mesh.rank_at``), the last stage's
loss is its share of the head's (``train/step.micro_loss``), and the
gradients and the loss are reduced over (data, fsdp, seq) as
``finish_step`` does for stage mode.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch.distributed.fsdp import FSDPModule

from pytorch_distributed_training_tpu_torch.comms.collectives import exchange
from pytorch_distributed_training_tpu_torch.comms.mesh import (
    AXIS_SEQ,
    AXIS_STAGE,
    BATCH_AXES,
    Mesh,
    batch_index,
    dp_degree,
)
from pytorch_distributed_training_tpu_torch.models.bert import compute_dtype
from pytorch_distributed_training_tpu_torch.train.optim import (
    plain_grad_norm,
    torch_dtype,
)
from pytorch_distributed_training_tpu_torch.train.state import TrainState
from pytorch_distributed_training_tpu_torch.train.step import (
    GradCarry,
    every,
    finish_step,
    is_replicated,
    micro_loss,
    microbatch_seed,
)
from pytorch_distributed_training_tpu_torch.utils.config import ModelConfig


# JAX's refusal of a causal config, by schedule (:749-750, :973-974)
_CAUSAL = {"pipeline": "GPipeClassifier is an encoder-classifier trunk",
           "1f1b": "make_1f1b_train_step is an encoder-classifier step"}
# ... and of delayed dy scales (:756-761, :975-980)
_DELAYED_GRADS = {
    "pipeline": "quant_delayed_grads is unsupported under the GPipe "
                "schedule (the sink-gradient channel is not threaded "
                "through jax.grad of the pipeline); use plain quant_delayed",
    "1f1b": "quant_delayed_grads is unsupported under the 1F1B schedule "
            "(the sink-gradient channel is not threaded through the tick "
            "vjp); use plain quant_delayed",
}


def check_config(config: ModelConfig, schedule: str) -> None:
    """JAX's refusals of a config under ``schedule``."""
    if config.causal:
        raise ValueError(_CAUSAL[schedule])
    if config.quant_delayed_grads:
        raise ValueError(_DELAYED_GRADS[schedule])


def check_layers(num_layers: int, n_stages: int) -> None:
    """JAX's check of the layer split (:127-130)."""
    if num_layers % n_stages:
        raise ValueError(
            f"{num_layers} layers not divisible by {n_stages} stages")


def check_n_micro(n_micro: int, n_stages: int) -> None:
    """JAX's check of the pipeline depth (:131-135)."""
    if n_micro < n_stages:
        raise ValueError(
            f"need n_micro >= n_stages for a useful pipeline "
            f"(got {n_micro} < {n_stages})")


def check_micro_batch(batch: int, n_micro: int, dshard: int) -> None:
    """JAX's checks of a micro-batch of ``batch`` rows (all batch shards')
    split into ``n_micro`` pipeline microbatches (:1027-1042)."""
    if batch % n_micro:
        raise ValueError(
            f"micro-batch size {batch} not divisible by "
            f"n_micro={n_micro} pipeline microbatches")
    if (batch // n_micro) % dshard:
        raise ValueError(
            f"pipeline microbatch size {batch // n_micro} (= {batch}/"
            f"{n_micro}) must divide over the data axes "
            f"({'x'.join(BATCH_AXES)} = {dshard}) — lower n_micro or raise "
            f"the micro-batch size")


class StageWire:
    """This rank's place on ``mesh``'s stage axis: its neighbours, and the
    shape and dtype of what passes between stages (an activation going
    forward, its gradient coming back)."""

    def __init__(self, mesh: Mesh, shape, dtype, device):
        self.n_stages = mesh.shape[AXIS_STAGE]
        self.stage = s = mesh.coord(AXIS_STAGE)
        self.first, self.last = s == 0, s == self.n_stages - 1
        self.prev = None if self.first else mesh.rank_at(stage=s - 1)
        self.next = None if self.last else mesh.rank_at(stage=s + 1)
        self.meta = (tuple(shape), dtype, device)

    def exchange(self, *, fwd=None, bwd=None, recv_fwd=False,
                 recv_bwd=False):
        """Send ``fwd`` on to the next stage and ``bwd`` back to the
        previous one, and receive an activation from the previous stage
        (``recv_fwd``) and a gradient from the next (``recv_bwd``), in one
        batch; returns (activation, gradient), None where not received."""
        sends = [(t, dst) for t, dst in ((fwd, self.next), (bwd, self.prev))
                 if t is not None]
        want = [src for on, src in ((recv_fwd, self.prev),
                                    (recv_bwd, self.next)) if on]
        got = iter(exchange(sends, [(*self.meta, src) for src in want]))
        return (next(got) if recv_fwd else None,
                next(got) if recv_bwd else None)


def _input(x):
    """A received activation: a leaf whose gradient goes back."""
    if x is not None and torch.is_grad_enabled():
        x.requires_grad_()
    return x


def gpipe_apply(run: Callable, n_micro: int, wire: StageWire) -> list:
    """The GPipe forward on this stage: for j = 0 … ``n_micro`` - 1, the
    input received from the previous stage (None on stage 0), ``run(j,
    x)``, its output sent to the next stage. Returns each microbatch's
    (input, output), their graphs kept."""
    check_n_micro(n_micro, wire.n_stages)
    held = []
    for j in range(n_micro):
        x, _ = wire.exchange(recv_fwd=not wire.first)
        y = run(j, _input(x))
        wire.exchange(fwd=None if wire.last else y)
        held.append((x, y))
    return held


def _backward(x, y, dy, wire, before=None):
    if before is not None:
        before()
    y.backward(dy)
    return None if wire.first else x.grad


def gpipe_grads(run: Callable, n_micro: int, wire: StageWire,
                before_last: Optional[Callable] = None) -> list:
    """GPipe: ``gpipe_apply``, then the backwards in microbatch order, each
    gradient received from the next stage (on the last, ``run`` returned
    the loss) and the input's sent back; ``before_last()`` runs before
    the last backward. Returns the last stage's losses, detached, in
    order (none elsewhere)."""
    held = gpipe_apply(run, n_micro, wire)
    losses = []
    for j in range(n_micro):
        x, y = held[j]
        held[j] = None
        if wire.last:
            losses.append(y.detach())
        _, dy = wire.exchange(recv_bwd=not wire.last)
        dx = _backward(x, y, dy, wire,
                       before_last if j == n_micro - 1 else None)
        wire.exchange(bwd=dx)
    return losses


def one_f_one_b_grads(run: Callable, n_micro: int, wire: StageWire,
                      before_last: Optional[Callable] = None) -> list:
    """1F1B, by JAX's tick table: at tick t the forward of f = t - s, then
    the backward of b = t - 2(S - 1) + s; at the tick's end this stage's
    sends and the next tick's receives go in one batch. Returns as
    ``gpipe_grads``."""
    n_stages, s = wire.n_stages, wire.stage
    check_n_micro(n_micro, n_stages)
    held, losses = {}, []
    x = dy = None
    for t in range(n_micro + 2 * (n_stages - 1)):
        f, b = t - s, t - 2 * (n_stages - 1) + s
        y_out = dx = None
        if 0 <= f < n_micro:
            y = run(f, _input(x))
            held[f] = (x, y)
            if wire.last:
                losses.append(y.detach())
            else:
                y_out = y
        if 0 <= b < n_micro:
            xb, yb = held.pop(b)
            dx = _backward(xb, yb, dy, wire,
                           before_last if b == n_micro - 1 else None)
        x, dy = wire.exchange(
            fwd=y_out, bwd=dx,
            recv_fwd=not wire.first and 0 <= f + 1 < n_micro,
            recv_bwd=not wire.last and 0 <= b + 1 < n_micro)
    return losses


SCHEDULES = {"pipeline": gpipe_grads, "1f1b": one_f_one_b_grads}


def bubble(schedule: str, n_stages: int, n_micro: int) -> float:
    """The schedule's idle share of a stage's ticks."""
    idle = (n_stages - 1) * (2 if schedule == "1f1b" else 1)
    return idle / (n_micro + idle)


def _stage_forward(model, micro: dict, seed, x, n_stages: int):
    kw = {} if n_stages == 1 else dict(hidden=x, wire=False)
    return model(micro["input_ids"], micro.get("attention_mask"),
                 micro.get("token_type_ids"), dropout_seed=seed, **kw)


def make_pipeline_train_step(config: ModelConfig, mesh: Mesh, *,
                             schedule: str, n_micro: int,
                             grad_accum_steps: int,
                             grad_norm: Callable = plain_grad_norm,
                             accum_dtype: str = "float32") -> Callable:
    """The train step of ``schedule`` ("pipeline": GPipe, "1f1b") for this
    rank's stage of ``mesh``: batch leaves are ``[grad_accum_steps ×
    n_micro, rows, ...]``, ``accum_dtype`` the carry's (see the module
    docstring)."""
    check_config(config, schedule)
    n_stages = mesh.shape[AXIS_STAGE]
    check_layers(config.num_layers, n_stages)
    check_n_micro(n_micro, n_stages)
    grads = SCHEDULES[schedule]
    idle = bubble(schedule, n_stages, n_micro)
    inv = 1.0 / (grad_accum_steps * n_micro)
    shard = batch_index(mesh)
    n_seq = mesh.shape[AXIS_SEQ]
    act_dtype = compute_dtype(config)
    carry_dtype = torch_dtype(accum_dtype)
    narrow = carry_dtype != torch.float32

    def train_step(state: TrainState, batch: dict) -> dict:
        model = state.model
        fsdp = isinstance(model, FSDPModule)
        ids = batch["input_ids"]
        wire = StageWire(mesh, (*ids.shape[1:], config.hidden_size),
                         act_dtype, ids.device)
        state.optimizer.zero_grad(set_to_none=True)
        if fsdp:
            model.set_requires_gradient_sync(False)
        carry = GradCarry(carry_dtype) if narrow else None
        loss_sum = None
        for m in range(grad_accum_steps):
            def run(j, x, m=m):
                k = m * n_micro + j
                micro = {key: v[k] for key, v in batch.items()}
                seed = microbatch_seed(state.dropout_seed, state.step, k,
                                       shard)
                out = _stage_forward(model, micro, seed, x, n_stages)
                if not wire.last:
                    return out
                return micro_loss("classification", out, micro, mesh,
                                  inv)[0]

            sync = None
            if fsdp and (narrow or m == grad_accum_steps - 1):
                def sync():
                    model.set_requires_gradient_sync(True)
            for loss in grads(run, n_micro, wire, sync):
                loss_sum = loss if loss_sum is None else loss_sum + loss
            if carry is not None:
                carry.add(model.parameters())
                if fsdp:
                    model.set_requires_gradient_sync(False)
        if loss_sum is None:  # a stage before the last
            loss_sum = torch.zeros((), device=ids.device)
        elif n_seq > 1:  # the backwards ran on P times the shard's share
            loss_sum = loss_sum / n_seq
        out = finish_step(state, loss_sum, mesh, grad_norm,
                          average=is_replicated if fsdp else every,
                          carry=carry)
        out["pipeline_bubble"] = idle
        return out

    return train_step


def make_1f1b_train_step(config: ModelConfig, mesh: Mesh, **kw) -> Callable:
    """The 1F1B train step (JAX :708): ``make_pipeline_train_step`` with
    ``schedule="1f1b"``."""
    return make_pipeline_train_step(config, mesh, schedule="1f1b", **kw)


class GPipeClassifier:
    """The GPipe forward of ``module``, this rank's part of a
    ``BertForSequenceClassification`` (the whole model at one stage, else
    its ``BertStage``), over ``mesh``'s stage axis in ``n_micro`` pipeline
    microbatches (JAX :943, deterministic: no dropout seed)."""

    def __init__(self, config: ModelConfig, mesh: Mesh, n_micro: int,
                 module=None):
        check_config(config, "pipeline")
        self.n_stages = mesh.shape[AXIS_STAGE]
        check_layers(config.num_layers, self.n_stages)
        check_n_micro(n_micro, self.n_stages)
        self.config, self.mesh, self.n_micro = config, mesh, int(n_micro)
        self.module = module

    def __call__(self, input_ids, attention_mask=None, token_type_ids=None):
        """Logits of this batch shard's rows on the last stage (None on the
        others)."""
        n, rows = self.n_micro, input_ids.shape[0]
        dshard = dp_degree(self.mesh)
        check_micro_batch(rows * dshard, n, dshard)
        per = rows // n
        parts = {"input_ids": input_ids, "attention_mask": attention_mask,
                 "token_type_ids": token_type_ids}
        wire = StageWire(self.mesh, (per, *input_ids.shape[1:],
                                     self.config.hidden_size),
                         compute_dtype(self.config), input_ids.device)

        def run(j, x):
            micro = {k: None if v is None else v[j * per:(j + 1) * per]
                     for k, v in parts.items()}
            return _stage_forward(self.module, micro, None, x, self.n_stages)

        held = gpipe_apply(run, n, wire)
        return torch.cat([y for _, y in held]) if wire.last else None
