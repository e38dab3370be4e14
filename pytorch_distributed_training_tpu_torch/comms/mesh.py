"""The process mesh (counterpart: the JAX package's ``comms/mesh.py``).

The JAX mesh is an array of devices with named axes, and GSPMD places the
collectives. Here the mesh is the same named axes over the processes of
``torch.distributed``: ranks laid out row-major in the axis order ``(data,
fsdp, stage, model, seq)`` (the last axis varies fastest), this rank's
coordinate on each axis, and one process group per axis holding the ranks
that differ from this one on that axis only, plus one over the batch axes
``(data, fsdp)`` jointly (``batch_group``). The callers place the
collectives themselves: DDP (or FSDP's gradient reduction) and the loss
mean over the batch axes, FSDP's all-gathers and reduce-scatters over
``fsdp`` (``parallel/sharding.py``, on ``fsdp_device_mesh``), the branch
fuse over ``model``, the activations of the layer split over ``stage``.

The batch shards over ``(data, fsdp)``: shard ``batch_index`` (``data``
major) of ``dp_degree``, the JAX package's ``linear_device_index`` over
the batch axes (``ops/dispatch.py``), which also offsets each shard's
dropout seed; the ranks of one batch shard at other stage and model
coordinates read the same rows.

An axis of one process has no group (``None``), and every collective over
it is the identity (``comms/collectives.py``). One process, as on a single
card, joins no process group at all (``comms/bootstrap.py``), so its mesh
is all ones. An axis (or the batch axes) spanning every process is the
world group.

``seq`` above 1 waits for its port (ROADMAP.md, queue 1, slice 5 item 4).
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
    AXIS_SEQ: "context parallelism (ring attention), slice 5 item 4",
}


@dataclasses.dataclass
class Mesh:
    """This rank's view of the mesh: each axis's size, this rank's
    coordinate on it, its process group (None for an axis of one), and
    the group over the batch axes jointly (None for one batch shard)."""

    shape: dict
    coords: dict
    groups: dict
    batch_group: Optional[dist.ProcessGroup] = None

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


def batch_index(mesh: Mesh) -> int:
    """This rank's batch shard: its linear index over ``BATCH_AXES``,
    ``data`` major."""
    index = 0
    for axis in BATCH_AXES:
        index = index * mesh.shape[axis] + mesh.coord(axis)
    return index


def _line_groups(mesh: Mesh, axes: tuple, rank: int):
    """One ``dist.new_group`` over ``axes`` jointly for every coordinate
    of the other axes, made on every rank in the same order; this rank's,
    or the world group when ``axes`` span every process."""
    size = axis_size(mesh, *axes)
    if size == 1:
        return None
    if size == math.prod(mesh.shape.values()):
        return dist.group.WORLD
    others = [a for a in AXIS_NAMES if a not in axes]
    mine = None
    for fixed in itertools.product(*(range(mesh.shape[a]) for a in others)):
        at = dict(zip(others, fixed))
        ranks = [mesh.rank_at(**at, **dict(zip(axes, c))) for c in
                 itertools.product(*(range(mesh.shape[a]) for a in axes))]
        group = dist.new_group(ranks)
        if rank in ranks:
            mine = group
    return mine


def fsdp_device_mesh(mesh: Mesh, device_type: str):
    """The ``DeviceMesh`` FSDP shards over at this rank's stage and model
    coordinates, on the mesh's own process groups: 1-D over ``fsdp`` when
    ``data`` is 1, else 2-D (replicate over ``data``, shard over
    ``fsdp``: HSDP), ranks row-major as the mesh lays them out. A world of
    one process (a process group of one rank) gives a one-rank mesh."""
    from torch.distributed.device_mesh import DeviceMesh

    data, fsdp = mesh.shape[AXIS_DATA], mesh.shape[AXIS_FSDP]
    if data == fsdp == 1 and dist.is_initialized() and (
            dist.get_world_size() == 1):
        return DeviceMesh.from_group(dist.group.WORLD, device_type,
                                     mesh_dim_names=(AXIS_FSDP,))
    if fsdp == 1:
        raise ValueError("an fsdp axis of 1 shards nothing")
    if data == 1:
        return DeviceMesh.from_group(mesh.group(AXIS_FSDP), device_type,
                                     mesh_dim_names=(AXIS_FSDP,))
    ranks = [[mesh.rank_at(data=d, fsdp=f) for f in range(fsdp)]
             for d in range(data)]
    return DeviceMesh.from_group(
        [mesh.group(AXIS_DATA), mesh.group(AXIS_FSDP)], device_type,
        mesh=ranks, mesh_dim_names=BATCH_AXES)


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
        mesh.groups[axis] = _line_groups(mesh, (axis,), rank)
    # batch axes of which one alone is > 1: that axis's group
    batch = [a for a in BATCH_AXES if shape[a] > 1]
    mesh.batch_group = (mesh.groups[batch[0]] if len(batch) == 1
                        else _line_groups(mesh, BATCH_AXES, rank))
    return mesh
