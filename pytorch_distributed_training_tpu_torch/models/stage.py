"""One stage of the layer split, the ConcatBert capability (counterpart:
the JAX package's stage mode, the scan-stacked BERT trunk sharded over the
mesh's ``stage`` axis, ``parallel/sharding.py:128-140``).

The reference's ConcatBert (reference test_model_parallelism.py:40-89)
splits BERT's layers over two devices and moves the activation between
them. ``BertStage`` is stage s of S of a ``BertForSequenceClassification``
made whole from the seed on every rank: it keeps layers ``[s·L/S,
(s+1)·L/S)``, stage 0 also the embeddings and the last stage the pooler and
classifier; the rest is dropped, so its ``state_dict`` is the whole model's
restricted to what it keeps (the same names), and the stages' dicts merge.

A forward on stage s > 0 receives its input from stage s - 1
(``stage_recv``); on every stage but the last it ends by sending its
output to stage s + 1 and returns the scalar token of ``stage_send``,
whose ``backward()`` brings the gradient back. The last stage returns the
logits. Microbatches pass one at a time, forward then backward, as in
ConcatBert (``--mp-mode stage``, and every eval). With ``wire=False`` a
forward runs one pipeline microbatch with no point-to-point inside, the
wire left to the GPipe and 1F1B schedules (``parallel/pipeline.py``): a
stage s > 0 takes its input as ``hidden`` and a stage before the last
returns its output. Layer i draws its dropout from ``fold_in(seed, i +
1)`` by its global index, the embeddings and classifier as in the whole
model, so any S is the same model as S = 1.

Context parallelism (the ``seq_shard`` of the whole model's encoder,
set by ``parallel/sharding.context_parallel``): each stage holds its seq
coordinate's columns, stage s of seq shard j passing to stage s + 1 of
seq shard j (``mesh.rank_at`` keeps every other coordinate); stage 0's
position ids start at the shard's first column, the trunk's seeds fold
in the seq coordinate, the layers attend through the ring, and the last
stage's pooler reads seq coordinate 0's CLS row (``broadcast_first``).
"""

from __future__ import annotations

import torch
from torch import nn

from pytorch_distributed_training_tpu_torch.comms.collectives import (
    stage_recv,
    stage_send,
)
from pytorch_distributed_training_tpu_torch.comms.mesh import AXIS_STAGE, Mesh
from pytorch_distributed_training_tpu_torch.models.bert import (
    BertForSequenceClassification,
    child_seed,
    classify,
    compute_dtype,
    pool_cls,
    run_layers,
    shard_position_ids,
    trunk_seed,
)
from pytorch_distributed_training_tpu_torch.ops.attention import (
    make_attention_bias,
)


class BertStage(nn.Module):
    """This rank's stage of ``full`` (which it takes apart) on ``mesh``'s
    ``stage`` axis."""

    def __init__(self, full: BertForSequenceClassification, mesh: Mesh):
        super().__init__()
        cfg = self.config = full.config
        n_stages, stage = mesh.shape[AXIS_STAGE], mesh.coord(AXIS_STAGE)
        if cfg.num_layers % n_stages:
            raise ValueError(
                f"model has {cfg.num_layers} layers, not divisible by "
                f"{n_stages} stages")
        per = cfg.num_layers // n_stages
        self.lo, self.hi = stage * per, (stage + 1) * per
        self.first, self.last = stage == 0, stage == n_stages - 1
        self.prev = None if self.first else mesh.rank_at(stage=stage - 1)
        self.next = None if self.last else mesh.rank_at(stage=stage + 1)
        bert = full.bert
        for i in range(cfg.num_layers):
            if not self.lo <= i < self.hi:
                bert.layers[i] = nn.Identity()
        if not self.first:
            bert.embeddings = None
        if not self.last:
            bert.pooler = None
        self.bert = bert
        self.dropout = full.dropout
        self.classifier = full.classifier if self.last else None

    def forward(self, input_ids, attention_mask=None, token_type_ids=None,
                position_ids=None, dropout_seed=None, *, hidden=None,
                wire=True):
        cfg = self.config
        input_ids = input_ids.long()
        seq_shard = self.bert.seq_shard
        seed = trunk_seed(dropout_seed, seq_shard)
        if self.first:
            if token_type_ids is None:
                token_type_ids = torch.zeros_like(input_ids)
            if position_ids is None:
                position_ids = shard_position_ids(cfg, input_ids, seq_shard)
            x = self.bert.embeddings(input_ids, token_type_ids.long(),
                                     position_ids, child_seed(seed, 0))
        elif wire:
            x = stage_recv((*input_ids.shape, cfg.hidden_size),
                           compute_dtype(cfg), input_ids.device, self.prev)
        else:
            x = hidden
        bias = make_attention_bias(attention_mask)
        x = run_layers(self.bert.layers[self.lo:self.hi], x, bias, seed,
                       first=self.lo)
        if not self.last:
            return stage_send(x, self.next) if wire else x
        head_seed = child_seed(dropout_seed, cfg.num_layers + 1)
        return classify(self.dropout, self.classifier,
                        pool_cls(self.bert.pooler, x, seq_shard,
                                 self.bert.pool_dropout, head_seed),
                        head_seed)
