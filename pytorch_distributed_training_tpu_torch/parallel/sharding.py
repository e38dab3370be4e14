"""FSDP: parameters and optimizer state sharded over the mesh's ``fsdp``
axis, ZeRO-3 (counterpart: the JAX package's ``parallel/sharding.py``).

The JAX package states every parallelism as a sharding policy, a map from
parameter paths to PartitionSpecs, and lets XLA insert the all-gathers and
reduce-scatters. Here the same policy picks each parameter's placement
over ``fsdp`` and FSDP2 (``torch.distributed.fsdp.fully_shard``) moves the
bytes:

- ``param_placements`` follows JAX ``_leaf_spec`` and ``_add_fsdp`` leaf
  by leaf: a leaf of at least ``fsdp_min_size`` elements is sharded on
  its largest dim (the later of equal ones) that the fsdp size divides and
  that no stacked axis already takes; smaller leaves, leaves with no such
  dim and every leaf at an fsdp size of 1 stay replicated. A stacked leaf
  is judged by its stacked shape, as JAX sees it: the scanned trunk's
  (``layers_scan``, one parameter here too), the ensemble's
  ``branches`` (here a module a branch, [n_branches] stacked in JAX) and,
  under ``stage``, the layer split's trunk (here a module a layer; JAX's
  stage mode scans). Its leading dim is kept out of the choice only where
  JAX gives it a ``lead`` axis (``model`` for the branches, ``stage`` for
  the layers, when that axis is more than 1 and divides the dim); the port
  holds whole branches and layers, so a spec on that dim raises.
- ``apply_fsdp`` wraps the model: one ``fully_shard`` unit per trunk layer
  (a BERT layer, a GPT-2 block, each branch's layers, a stage's layers),
  or the whole stacked trunk as one unit when it is scanned, then the
  root; each sharded parameter on its placement's dim
  (``shard_placement_fn``). The replicated leaves are FSDP's
  ``ignored_params``: they stay plain tensors, and the train step averages
  their gradients over the batch axes itself (``train/step.py``).

No ``MixedPrecisionPolicy``: the modules cast their float32 parameters to
the compute dtype at use, as JAX does, so the all-gathers move float32.
Tensor parallelism (``tp``) waits for ROADMAP.md queue 1, slice 5 item 4.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

from torch import nn

SCAN = "layers_scan"
BRANCHES = "branches"
_LAYERS = "layers"


@dataclasses.dataclass(frozen=True)
class ShardingPolicy:
    """The JAX package's ``ShardingPolicy``, its fields and defaults."""

    tp: bool = False  # Megatron tensor parallelism over "model": not ported
    fsdp: bool = False  # shard the largest eligible dim over "fsdp"
    # the ensemble's branches over "model" (models/branch.py)
    branch: bool = False
    # the layer split over "stage" (models/stage.py)
    stage: bool = False
    # leaves below this many elements stay replicated
    fsdp_min_size: int = 2**16


def _add_fsdp(spec: list, shape: tuple, fsdp_size: int,
              min_size: int) -> list:
    """JAX ``_add_fsdp``: the largest still-unsharded divisible dim."""
    if fsdp_size <= 1 or math.prod(shape) < min_size:
        return spec
    candidates = [(shape[i], i) for i in range(len(shape))
                  if spec[i] is None and shape[i] % fsdp_size == 0
                  and shape[i] > 1]
    if candidates:
        spec = list(spec)
        spec[max(candidates)[1]] = "fsdp"
    return spec


def _stack_of(parts: list, policy: ShardingPolicy) -> Optional[tuple]:
    """(index of the per-module key in ``parts``, its stacked axis) for a
    leaf the port holds per branch or per layer and JAX stacks."""
    if BRANCHES in parts:
        return parts.index(BRANCHES) + 1, "model"
    if policy.stage and _LAYERS in parts and SCAN not in parts:
        at = parts.index(_LAYERS) + 1
        if at < len(parts) and parts[at].isdigit():
            return at, "stage"
    return None


def param_placements(named_shapes: dict, policy: ShardingPolicy,
                     mesh_shape: dict) -> dict:
    """Each parameter's placement over ``fsdp``: ``Shard(dim)`` or
    ``Replicate()``, by name (``named_shapes``: the port's names ->
    shapes, those of this rank's module; ``mesh_shape``: axis -> size)."""
    from torch.distributed.tensor import Replicate, Shard

    if policy.tp:
        raise NotImplementedError(
            "tensor parallelism (tp=True) is not ported yet (ROADMAP.md, "
            "queue 1, slice 5 item 4)")
    split = {name: name.split(".") for name in named_shapes}
    # how many modules this rank holds per stacked leaf; the stacked dim
    # is that times the axis the port splits them over
    held: dict = {}
    for name, parts in split.items():
        stack = _stack_of(parts, policy)
        if stack is not None:
            at, axis = stack
            key = (tuple(parts[:at]), tuple(parts[at + 1:]))
            held.setdefault(key, set()).add(parts[at])
    out = {}
    for name, shape in named_shapes.items():
        parts, shape = split[name], tuple(shape)
        if not shape:
            out[name] = Replicate()
            continue
        stack = _stack_of(parts, policy)
        full = shape
        lead = None
        if stack is not None:
            at, axis = stack
            key = (tuple(parts[:at]), tuple(parts[at + 1:]))
            full = (len(held[key]) * mesh_shape[axis],) + shape
            wanted = policy.branch if axis == "model" else policy.stage
            if wanted and mesh_shape[axis] > 1 and not (
                    full[0] % mesh_shape[axis]):
                lead = axis
        elif (SCAN in parts and policy.stage and mesh_shape["stage"] > 1
              and not shape[0] % mesh_shape["stage"]):
            lead = "stage"
        spec = [None] * len(full)
        if lead:
            spec[0] = lead
        if policy.fsdp:
            spec = _add_fsdp(spec, full, mesh_shape["fsdp"],
                             policy.fsdp_min_size)
        if stack is not None:
            if spec[0] == "fsdp":
                raise ValueError(
                    f"{name}: JAX shards the stacked {stack[1]} dim of this "
                    f"leaf over fsdp; the port holds whole modules there")
            spec = spec[1:]
        out[name] = (Shard(spec.index("fsdp")) if "fsdp" in spec
                     else Replicate())
    return out


def _fsdp_units(model: nn.Module) -> list:
    """The modules ``apply_fsdp`` makes units of, before the root: every
    trunk layer, or the stacked trunk as one."""
    from pytorch_distributed_training_tpu_torch.models.bert import (
        BertLayer,
        ScannedLayers,
    )
    from pytorch_distributed_training_tpu_torch.models.gpt2 import GPT2Block

    units, inside = [], ()
    for name, mod in model.named_modules():
        if inside and name.startswith(inside):
            continue
        if isinstance(mod, ScannedLayers):
            units.append(mod)
            inside = name + "."
        elif isinstance(mod, (BertLayer, GPT2Block)):
            units.append(mod)
    return units


def apply_fsdp(model: nn.Module, placements: dict, device_mesh) -> nn.Module:
    """Shard ``model`` in place with FSDP2 on ``device_mesh``
    (``comms/mesh.fsdp_device_mesh``) by ``placements``
    (``param_placements`` of its names); the replicated parameters are
    left out (``ignored_params``). Returns the model, now an FSDP
    module."""
    from torch.distributed.fsdp import fully_shard
    from torch.distributed.tensor import Shard

    by_param, ignored = {}, set()
    for name, p in model.named_parameters():
        placement = placements[name]
        if isinstance(placement, Shard):
            by_param[p] = placement
        else:
            ignored.add(p)

    def place(p):
        return by_param[p]

    for unit in _fsdp_units(model):
        fully_shard(unit, mesh=device_mesh, shard_placement_fn=place,
                    ignored_params=ignored)
    fully_shard(model, mesh=device_mesh, shard_placement_fn=place,
                ignored_params=ignored)
    return model
