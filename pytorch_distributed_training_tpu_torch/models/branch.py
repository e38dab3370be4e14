"""Branch-ensemble classifier, the TriBert capability (counterpart: the JAX
package's ``models/branch.py`` ``BranchEnsembleClassifier``).

The reference's TriBert (reference test_model_parallelism.py:92-163) is a
3-branch ensemble: shared input embeddings (:114,118), each branch a full
BERT encoder, the branch outputs stacked and mean-fused (:139-148), then
the pooler, dropout and classifier (:149-151).

The JAX package stacks the branches' weights on a leading [n_branches]
axis (``nn.vmap``) and shards it over the mesh's ``model`` axis. Here a
rank holds the ``n_branches / model`` branches of its ``model`` coordinate
as ordinary modules and runs them one after another, as the JAX vmap runs
them on one device:

- ``embeddings`` (``BertEmbeddings``), computed once a forward and passed
  through ``copy_to_model``, so their gradient is every branch's;
- ``branches``: an ``nn.ModuleDict`` keyed by the *global* branch index,
  each an encoder stack with ``layers.i``, so the state-dict names
  (``branches.b.layers.i...``) are the same on every mesh and the ranks'
  dicts merge (``models/convert.py`` maps them to the flax
  ``branches/layer_i/...`` leaves with their leading [n_branches] axis);
- the fuse: the float32 sum of the local branches, ``reduce_from_model``
  over the ``model`` group, divided by ``n_branches`` (the float32 mean of
  JAX ``:102-103``), cast back to the compute dtype;
- ``pooler``, ``dropout``, ``classifier``: BERT's head (``pool_cls``,
  ``classify``), replicated on every rank of the group.

Context parallelism (``parallel/sharding.context_parallel`` sets
``seq_shard``): as in ``models/bert.py``, the position ids start at this
rank's first column, the embeddings' and branches' seeds fold in the seq
coordinate, every branch's layers attend through the ring, and the
pooler reads the fused CLS row of seq coordinate 0 (``broadcast_first``).

Branch b's initial weights come from a generator seeded by (seed, b) and
its dropout from ``fold_in(seed, b + 1)`` (layer i of it from
``fold_in(that, i + 1)``), so neither depends on the rank that holds it
and ``model=2`` is the same model as ``model=1``. The shared parts take
the generator of ``seed``, the embeddings' dropout ``fold_in(seed, 0)``
and the classifier's ``fold_in(seed, n_branches + 1)``.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from pytorch_distributed_training_tpu_torch.comms.collectives import (
    copy_to_model,
    reduce_from_model,
)
from pytorch_distributed_training_tpu_torch.comms.mesh import (
    AXIS_MODEL,
    Mesh,
)
from pytorch_distributed_training_tpu_torch.models.bert import (
    BertEmbeddings,
    BertLayer,
    DenseGeneral,
    child_seed,
    classify,
    compute_dtype,
    dense,
    dropout_module,
    param_dtype,
    pool_cls,
    pool_dropout,
    run_layers,
    shard_position_ids,
    trunk_seed,
)
from pytorch_distributed_training_tpu_torch.ops.attention import (
    make_attention_bias,
)
from pytorch_distributed_training_tpu_torch.ops.dropout import fold_in
from pytorch_distributed_training_tpu_torch.utils.config import ModelConfig

BRANCH_MODULE = "branches"
_BRANCH_INIT_STREAM = 2  # fold_in(seed, .) of the branches' weight seeds


def branch_init_seed(seed: int, branch: int) -> int:
    """The seed of branch ``branch``'s initial weights."""
    return fold_in(fold_in(seed, _BRANCH_INIT_STREAM), branch)


class EncoderStack(nn.Module):
    """N transformer layers: one ensemble branch (no embeddings, no
    pooler)."""

    def __init__(self, cfg: ModelConfig, device=None, generator=None):
        super().__init__()
        self.layers = nn.ModuleList(
            BertLayer(cfg, device, generator) for _ in range(cfg.num_layers)
        )

    def forward(self, x, attention_bias, dropout_seed=None):
        return run_layers(self.layers, x, attention_bias, dropout_seed)


class BranchEnsembleClassifier(nn.Module):
    """``n_branches`` encoders over shared embeddings -> mean-fused CLS
    pooler -> dropout -> float32 classifier -> logits. The loss lives in
    the train step (``train/step.py``)."""

    def __init__(self, cfg: ModelConfig, n_branches: int = 3, *,
                 seed: int = 0, mesh: Optional[Mesh] = None, device=None):
        super().__init__()
        if cfg.causal:
            raise ValueError("BranchEnsembleClassifier needs a non-causal "
                             "config")
        size = 1 if mesh is None else mesh.shape[AXIS_MODEL]
        if n_branches % size:
            raise ValueError(
                f"n_branches {n_branches} must be divisible by the model "
                f"axis {size} (each rank holds n_branches/model branches)")
        self.config = cfg
        self.n_branches = n_branches
        self.group = None if mesh is None else mesh.group(AXIS_MODEL)
        per = n_branches // size
        first = 0 if mesh is None else mesh.coord(AXIS_MODEL) * per
        shared = torch.Generator().manual_seed(seed)
        self.embeddings = BertEmbeddings(cfg, device, shared)
        self.branches = nn.ModuleDict({
            str(b): EncoderStack(cfg, device, torch.Generator().manual_seed(
                branch_init_seed(seed, b)))
            for b in range(first, first + per)
        })
        h = cfg.hidden_size
        self.pooler = dense(cfg, (h,), (h,), device, shared)
        self.pool_dropout = pool_dropout(cfg)
        self.dropout = dropout_module(cfg)
        self.classifier = DenseGeneral(
            (h,), (cfg.num_labels,), dtype=torch.float32,
            param_dtype=param_dtype(cfg), device=device, generator=shared,
        )
        self.seq_shard = None  # the seq axis, under context parallelism

    def forward(self, input_ids, attention_mask=None, token_type_ids=None,
                position_ids=None, dropout_seed=None):
        cfg = self.config
        input_ids = input_ids.long()
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        if position_ids is None:
            position_ids = shard_position_ids(cfg, input_ids, self.seq_shard)
        seed = trunk_seed(dropout_seed, self.seq_shard)
        x = self.embeddings(input_ids, token_type_ids.long(), position_ids,
                            child_seed(seed, 0))
        x = copy_to_model(x, self.group)
        bias = make_attention_bias(attention_mask)
        total = None
        for b, stack in self.branches.items():
            h = stack(x, bias, child_seed(seed, int(b) + 1)).float()
            total = h if total is None else total + h
        fused = reduce_from_model(total, self.group) / self.n_branches
        head_seed = child_seed(dropout_seed, self.n_branches + 1)
        pooled = pool_cls(self.pooler, fused.to(compute_dtype(cfg)),
                          self.seq_shard, self.pool_dropout, head_seed)
        return classify(self.dropout, self.classifier, pooled, head_seed)
