"""Host-side collectives of the trainer (counterpart: the JAX package's
``comms/collectives.py``, the part the data-parallel path uses).

Gradients need no call here: DDP all-reduces them. What is left is summing
a few scalars across ranks: the eval counts and the step loss. Each is
one ``all_reduce`` of a small float tensor on this process's device (NCCL
reduces CUDA tensors, gloo CPU ones); with no process group both are the
identity.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def _group_size() -> int:
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """Sum ``t`` over the ranks (a copy; ``t`` is left as it is)."""
    out = t.clone()
    if _group_size() > 1:
        dist.all_reduce(out, op=dist.ReduceOp.SUM)
    return out


def all_reduce_mean(t: torch.Tensor) -> torch.Tensor:
    """Mean of ``t`` over the ranks."""
    n = _group_size()
    return all_reduce_sum(t) / n if n > 1 else t.clone()


def host_sum_counts(counts: dict[str, torch.Tensor]) -> dict[str, float]:
    """Sum a dict of scalar counts over the ranks in one all-reduce and
    bring the totals to the host."""
    keys = sorted(counts)
    stacked = torch.stack([counts[k].float() for k in keys])
    total = all_reduce_sum(stacked).cpu().tolist()
    return dict(zip(keys, total))
