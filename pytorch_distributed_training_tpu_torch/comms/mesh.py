"""The process mesh (counterpart: the JAX package's ``comms/mesh.py``).

The JAX mesh is an array of devices with named axes, and GSPMD places the
collectives. Here the mesh is the same named axes over the processes of
``torch.distributed``: ranks laid out row-major in the axis order ``(data,
fsdp, stage, model, seq)`` (the last axis varies fastest), this rank's
coordinate on each axis, and one process group per axis holding the ranks
that differ from this one on that axis only. The callers place the
collectives themselves: DDP over the ``data`` group, the branch fuse over
``model``, the activations of the layer split over ``stage``.

An axis of one process has no group (``None``), and every collective over
it is the identity (``comms/collectives.py``). One process, as on a single
card, joins no process group at all (``comms/bootstrap.py``), so its mesh
is all ones. An axis that spans every process is the world group.

``fsdp`` and ``seq`` above 1 wait for their ports (ROADMAP.md, queue 1,
slice 5 items 2 and 4).
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Optional

import torch.distributed as dist

from pytorch_distributed_training_tpu_torch.utils.config import MeshConfig

AXIS_NAMES = MeshConfig.AXIS_NAMES
AXIS_DATA, AXIS_FSDP, AXIS_STAGE, AXIS_MODEL, AXIS_SEQ = AXIS_NAMES
# the batch shards over both flavours of data parallelism
BATCH_AXES = (AXIS_DATA, AXIS_FSDP)

_NOT_PORTED = {
    AXIS_FSDP: "FSDP, slice 5 item 2",
    AXIS_SEQ: "context parallelism (ring attention), slice 5 item 4",
}


@dataclasses.dataclass
class Mesh:
    """This rank's view of the mesh: each axis's size, this rank's
    coordinate on it, and its process group (None for an axis of one)."""

    shape: dict
    coords: dict
    groups: dict

    def coord(self, axis: str) -> int:
        return self.coords[axis]

    def group(self, axis: str) -> Optional[dist.ProcessGroup]:
        return self.groups[axis]

    def rank_at(self, **coords: int) -> int:
        """The global rank at this rank's coordinates with ``coords``
        replaced (row-major over ``AXIS_NAMES``)."""
        rank = 0
        for axis in AXIS_NAMES:
            rank = rank * self.shape[axis] + coords.get(axis,
                                                        self.coords[axis])
        return rank


def axis_size(mesh: Mesh, *axes: str) -> int:
    return math.prod(mesh.shape[a] for a in axes)


def dp_degree(mesh: Mesh) -> int:
    """Total data-parallel degree (number of batch shards)."""
    return axis_size(mesh, *BATCH_AXES)


def build_mesh(config: MeshConfig | None = None, *, rank: int = 0,
               world_size: int = 1) -> Mesh:
    """The mesh of ``config`` over ``world_size`` processes, seen from
    ``rank`` (the defaults: one process, every axis of size 1). With more
    than one process the process group must be up; every rank makes every
    axis group in the same order (``dist.new_group`` is collective), and
    keeps those it belongs to."""
    config = config or MeshConfig()
    shape = dict(zip(AXIS_NAMES, config.resolved_shape(world_size)))
    for axis, item in _NOT_PORTED.items():
        if shape[axis] > 1:
            raise NotImplementedError(
                f"mesh axis {axis}={shape[axis]} is not ported yet ({item}; "
                f"see ROADMAP.md, queue 1)")
    coords, rest = {}, rank
    for axis in reversed(AXIS_NAMES):
        coords[axis] = rest % shape[axis]
        rest //= shape[axis]
    coords = {a: coords[a] for a in AXIS_NAMES}
    mesh = Mesh(shape=shape, coords=coords,
                groups={a: None for a in AXIS_NAMES})
    for axis in AXIS_NAMES:
        if shape[axis] == 1:
            continue
        if shape[axis] == world_size:
            mesh.groups[axis] = dist.group.WORLD
            continue
        others = [a for a in AXIS_NAMES if a != axis]
        for fixed in itertools.product(*(range(shape[a]) for a in others)):
            at = dict(zip(others, fixed))
            ranks = [mesh.rank_at(**at, **{axis: i})
                     for i in range(shape[axis])]
            group = dist.new_group(ranks)
            if rank in ranks:
                mesh.groups[axis] = group
    return mesh
