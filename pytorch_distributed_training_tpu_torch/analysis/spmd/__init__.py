"""SPMD analysis: the collective audit (counterpart: the JAX package's
``analysis/spmd/``).

``record_collectives`` records the collectives a window issues (the
port's counterpart of JAX's compiled-HLO extraction), and ``comm_audit``
checks their summary against a :class:`CommManifest` (expected kinds and
byte bounds), wired into the trainer's first step and the serve engine's
hot program. JAX's static spmd rules lint ``PartitionSpec``/``shard_map``
sites, which the port does not have.
"""

from pytorch_distributed_training_tpu_torch.analysis.spmd.collectives import (
    COLLECTIVE_KINDS,
    Collective,
    CostModel,
    record_collectives,
    summarize_collectives,
)
from pytorch_distributed_training_tpu_torch.analysis.spmd.manifest import (
    CommManifest,
    comm_audit,
    serve_manifest,
    serve_tp_manifest,
    train_manifest,
)

__all__ = [
    "COLLECTIVE_KINDS",
    "Collective",
    "CommManifest",
    "CostModel",
    "comm_audit",
    "record_collectives",
    "serve_manifest",
    "serve_tp_manifest",
    "summarize_collectives",
    "train_manifest",
]
