"""The process mesh (counterpart: the JAX package's ``comms/mesh.py``).

The JAX mesh is an array of devices with named axes, and GSPMD places the
collectives. Here the mesh is the same named axes over the processes of
``torch.distributed``: ranks laid out row-major in the axis order ``(data,
fsdp, stage, model, seq)`` (the last axis varies fastest), this rank's
coordinate on each axis, and one process group per axis holding the ranks
that differ from this one on that axis only, plus one over the batch axes
``(data, fsdp)`` jointly (``batch_group``) and one over the gradient axes
``(data, fsdp, seq)`` jointly (``grad_group``). The callers place the
collectives themselves: DDP (or FSDP's gradient reduction) over the
gradient axes, the loss mean and the loader over the batch axes, FSDP's
all-gathers and reduce-scatters over ``fsdp`` (``parallel/sharding.py``,
on ``fsdp_device_mesh``), the branch fuse and tensor parallelism's pair
over ``model``, the activations of the layer split over ``stage``, the
ring attention's hops and BERT's CLS row over ``seq`` (``seq_ring``).

The batch shards over ``(data, fsdp)``: shard ``batch_index`` (``data``
major) of ``dp_degree``, the JAX package's ``linear_device_index`` over
the batch axes (``ops/dispatch.py``), which also offsets each shard's
dropout seed; the ranks of one batch shard at other stage, model and seq
coordinates read the same rows (the seq ranks each its own columns, the
model ranks the same dropout masks, so their replicated activations
agree). Each seq rank's gradient covers only its own tokens, so gradients
are reduced over the seq axis too (``grad_group``), and FSDP's replicate
dimension spans data × seq.

An axis of one process has no group (``None``), and every collective over
it is the identity (``comms/collectives.py``). One process, as on a single
card, joins no process group at all (``comms/bootstrap.py``), so its mesh
is all ones. An axis (or the batch axes) spanning every process is the
world group; the ring's group (``seq_ring``) is always a group of its own,
so its point-to-point never shares a group with DDP's all-reduces.
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
# gradients are reduced over the batch axes and the sequence's shards
GRAD_AXES = (AXIS_DATA, AXIS_FSDP, AXIS_SEQ)


@dataclasses.dataclass(frozen=True)
class AxisShard:
    """This rank's place on one mesh axis of more than one rank: the
    axis's process group, this rank's coordinate on it, its size and the
    global ranks along it (by coordinate)."""

    group: dist.ProcessGroup
    index: int
    size: int
    ranks: tuple

    def rank(self, index: int) -> int:
        """The global rank at coordinate ``index % size`` of the axis."""
        return self.ranks[index % self.size]


@dataclasses.dataclass
class Mesh:
    """This rank's view of the mesh: each axis's size, this rank's
    coordinate on it, its process group (None for an axis of one), the
    groups over the batch axes and over the gradient axes jointly, the
    group of FSDP's replicate dimension (data × seq), and the seq axis's
    ring group (each None where it would hold one rank)."""

    shape: dict
    coords: dict
    groups: dict
    batch_group: Optional[dist.ProcessGroup] = None
    grad_group: Optional[dist.ProcessGroup] = None
    rep_group: Optional[dist.ProcessGroup] = None
    seq_ring: Optional[dist.ProcessGroup] = None

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

    def shard(self, axis: str) -> Optional[AxisShard]:
        """This rank's ``AxisShard`` of ``axis`` (the ``seq`` axis on its
        ring group), or None for an axis of one rank."""
        size = self.shape[axis]
        if size == 1:
            return None
        group = self.seq_ring if axis == AXIS_SEQ else self.groups[axis]
        return AxisShard(group=group, index=self.coords[axis], size=size,
                         ranks=tuple(self.rank_at(**{axis: i})
                                     for i in range(size)))


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


def _line_groups(mesh: Mesh, axes: tuple, rank: int, own: bool = False):
    """One ``dist.new_group`` over ``axes`` jointly for every coordinate
    of the other axes, made on every rank in the same order; this rank's,
    or the world group when ``axes`` span every process (unless ``own``:
    then a group of its own all the same)."""
    size = axis_size(mesh, *axes)
    if size == 1:
        return None
    if size == math.prod(mesh.shape.values()) and not own:
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


def _joint_group(mesh: Mesh, axes: tuple, rank: int):
    """The group over ``axes`` jointly: None, the one axis's group when
    only one of them is more than 1, else a group of lines of its own."""
    big = [a for a in axes if mesh.shape[a] > 1]
    if len(big) <= 1:
        return mesh.groups[big[0]] if big else None
    return _line_groups(mesh, tuple(big), rank)


def fsdp_device_mesh(mesh: Mesh, device_type: str):
    """The ``DeviceMesh`` FSDP shards over at this rank's stage and model
    coordinates, on the mesh's own process groups: 1-D over ``fsdp`` when
    ``data`` and ``seq`` are 1, else 2-D (replicate over ``data`` × ``seq``,
    shard over ``fsdp``: HSDP, so FSDP's reduce-scatter and the replicate
    all-reduce together reduce over every gradient axis), ranks row-major
    as the mesh lays them out. A world of one process (a process group of
    one rank) gives a one-rank mesh."""
    from torch.distributed.device_mesh import DeviceMesh

    fsdp = mesh.shape[AXIS_FSDP]
    rep = [a for a in (AXIS_DATA, AXIS_SEQ) if mesh.shape[a] > 1]
    if not rep and fsdp == 1 and dist.is_initialized() and (
            dist.get_world_size() == 1):
        return DeviceMesh.from_group(dist.group.WORLD, device_type,
                                     mesh_dim_names=(AXIS_FSDP,))
    if fsdp == 1:
        raise ValueError("an fsdp axis of 1 shards nothing")
    if not rep:
        return DeviceMesh.from_group(mesh.group(AXIS_FSDP), device_type,
                                     mesh_dim_names=(AXIS_FSDP,))
    lines = itertools.product(*(range(mesh.shape[a]) for a in rep))
    ranks = [[mesh.rank_at(**dict(zip(rep, at)), fsdp=f)
              for f in range(fsdp)] for at in lines]
    return DeviceMesh.from_group(
        [mesh.rep_group, mesh.group(AXIS_FSDP)], device_type, mesh=ranks,
        mesh_dim_names=("_".join(rep), AXIS_FSDP))


def build_mesh(config: MeshConfig | None = None, *, rank: int = 0,
               world_size: int = 1) -> Mesh:
    """The mesh of ``config`` over ``world_size`` processes, seen from
    ``rank`` (the defaults: one process, every axis of size 1). With more
    than one process the process group must be up; every rank makes every
    axis group in the same order (``dist.new_group`` is collective), and
    keeps those it belongs to."""
    config = config or MeshConfig()
    shape = dict(zip(AXIS_NAMES, config.resolved_shape(world_size)))
    coords, rest = {}, rank
    for axis in reversed(AXIS_NAMES):
        coords[axis] = rest % shape[axis]
        rest //= shape[axis]
    coords = {a: coords[a] for a in AXIS_NAMES}
    mesh = Mesh(shape=shape, coords=coords,
                groups={a: None for a in AXIS_NAMES})
    for axis in AXIS_NAMES:
        mesh.groups[axis] = _line_groups(mesh, (axis,), rank)
    mesh.batch_group = _joint_group(mesh, BATCH_AXES, rank)
    # the gradient axes, and FSDP's replicate dimension (fsdp_device_mesh)
    if shape[AXIS_SEQ] == 1:
        mesh.grad_group, mesh.rep_group = mesh.batch_group, mesh.groups[
            AXIS_DATA]
    else:
        mesh.grad_group = _joint_group(mesh, GRAD_AXES, rank)
        mesh.rep_group = _joint_group(mesh, (AXIS_DATA, AXIS_SEQ), rank)
    mesh.seq_ring = _line_groups(mesh, (AXIS_SEQ,), rank, own=True)
    return mesh
