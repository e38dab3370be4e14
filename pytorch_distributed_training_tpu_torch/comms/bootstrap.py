"""Process bootstrap (counterpart: the JAX package's ``comms/bootstrap.py``).

``initialize`` reads the ``torch.distributed.run`` environment (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``) and, when
``WORLD_SIZE`` > 1, joins the process group: NCCL when the run is on the
card (one card per process, ``cuda:LOCAL_RANK``), gloo on the CPU. A single
process without that environment runs with no process group at all, and
the same training code runs unchanged.
"""

from __future__ import annotations

import dataclasses
import os

import torch
import torch.distributed as dist

from pytorch_distributed_training_tpu_torch.utils.logging import get_logger

_log = get_logger(__name__)


@dataclasses.dataclass(frozen=True)
class RuntimeInfo:
    rank: int
    world_size: int
    local_rank: int
    backend: str          # "nccl", "gloo", or "none" for one process
    device: torch.device  # this process's device

    @property
    def is_main(self) -> bool:
        return self.rank == 0


def _env_int(name: str, default: int) -> int:
    raw = os.environ.get(name)
    return default if raw in (None, "") else int(raw)


def initialize(device: torch.device) -> RuntimeInfo:
    """Join the process group the launcher describes (if any) and return
    this process's rank, world size and device. ``device`` is the run's
    device type (``resolve_device``); on CUDA each process takes
    ``cuda:LOCAL_RANK``."""
    world = _env_int("WORLD_SIZE", 1)
    rank = _env_int("RANK", 0)
    local_rank = _env_int("LOCAL_RANK", 0)
    if device.type == "cuda":
        index = local_rank if world > 1 else (device.index or 0)
        device = torch.device("cuda", index)
        torch.cuda.set_device(device)
    backend = "none"
    if world > 1:
        backend = "nccl" if device.type == "cuda" else "gloo"
        if not dist.is_initialized():
            dist.init_process_group(backend=backend, init_method="env://",
                                    rank=rank, world_size=world)
    info = RuntimeInfo(rank=rank, world_size=world, local_rank=local_rank,
                       backend=backend, device=device)
    if info.is_main:
        _log.info("runtime: %d process(es), backend=%s, device=%s",
                  world, backend, device)
    return info


def shutdown() -> None:
    """Leave the process group, if one was joined."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
