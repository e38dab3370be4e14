"""FSDP and tensor parallelism: parameters and optimizer state sharded
over the mesh's ``fsdp`` axis, ZeRO-3, and Megatron's split of the
transformer blocks over ``model`` (counterpart: the JAX package's
``parallel/sharding.py``).

The JAX package states every parallelism as a sharding policy, a map from
parameter paths to PartitionSpecs, and lets XLA insert the all-gathers and
reduce-scatters. Here the same policy picks each parameter's spec
(``param_specs``: per dim ``None``, ``"fsdp"`` or ``"model"``), this
module cuts each rank's model-axis slice (``tensor_parallel``) and FSDP2
(``torch.distributed.fsdp.fully_shard``) moves the fsdp bytes:

- ``_tp_spec`` is JAX's, keyed on the same names: query/key/value kernels
  [hidden, heads, head_dim] split on the heads and their biases too
  (column-parallel), the ``out`` kernel [heads, head_dim, hidden] on the
  heads (row-parallel, bias replicated), ``mlp_up`` on its columns and
  bias, ``mlp_down`` on its rows (bias replicated), a ``kernel_scale``
  as its kernel. ``param_specs`` applies it where JAX ``_leaf_spec``
  does: ``tp`` on and a ``model`` axis above 1, on the leaf's shape as
  JAX sees it. A scanned trunk (``layers_scan``, no stage split) shows it
  stacked shapes of one more dim, which none of its rules match: under
  ``--scan-layers`` JAX splits no trunk leaf, and neither does the port.
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
  holds whole branches and layers, so a spec on that dim raises. Under
  ``tp`` the fsdp dim is chosen after the model dim, on the whole shape,
  and it is never the model dim, so FSDP shards a rank's TP slice on the
  same dim.
- ``tensor_parallel`` cuts a model made whole (from one generator, so
  every rank starts from the same weights) to this rank's slice of each
  leaf split over ``model`` and hands the model axis to the modules whose
  weights it cut (``models/bert.py``; a column-parallel int8 site also
  gets the model group its output features span); ``context_parallel``
  hands the seq axis to the modules that read it, and ``int8_groups`` the
  gradient axes' group to every int8 site, whose amaxes are maxed over
  it.
- Serving (``serve/engine.py`` under ``tp > 1``): ``serve_param_specs`` is
  JAX ``serve_param_shardings``, ``_tp_spec`` on a ``model``-only mesh and
  no fsdp, and ``serve_pool_shape`` a rank's share of a paged pool, the
  shard shape of JAX ``serve_pool_pspec`` (heads split, pages whole).
- ``apply_fsdp`` wraps the model: one ``fully_shard`` unit per trunk layer
  (a BERT layer, a GPT-2 block, each branch's layers, a stage's layers),
  or the whole stacked trunk as one unit when it is scanned, then the
  root; each sharded parameter on its placement's dim
  (``shard_placement_fn``). The replicated leaves are FSDP's
  ``ignored_params``: they stay plain tensors, and the train step averages
  their gradients over the batch axes itself (``train/step.py``).

No ``MixedPrecisionPolicy``: the modules cast their float32 parameters to
the compute dtype at use, as JAX does, so the all-gathers move float32.
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

    tp: bool = False  # Megatron tensor parallelism over "model"
    fsdp: bool = False  # shard the largest eligible dim over "fsdp"
    # the ensemble's branches over "model" (models/branch.py)
    branch: bool = False
    # the layer split over "stage" (models/stage.py)
    stage: bool = False
    # leaves below this many elements stay replicated
    fsdp_min_size: int = 2**16


def _tp_spec(names, shape: tuple) -> Optional[tuple]:
    """JAX ``_tp_spec``: Megatron's spec of one leaf (by the names on its
    path and its shape), or None where tensor parallelism leaves it."""
    names = list(names)
    leaf, ndim, has = names[-1], len(shape), set(names)
    if leaf == "kernel_scale":
        spec = _tp_spec(names[:-1] + ["kernel"], shape)
        if spec is None:
            return None
        return tuple(None if shape[i] == 1 else axis
                     for i, axis in enumerate(spec))
    if "attention" in has:
        if has & {"query", "key", "value"}:
            if leaf == "kernel" and ndim == 3:
                return (None, "model", None)
            if leaf == "bias" and ndim == 2:
                return ("model", None)
        if "out" in has:
            if leaf == "kernel" and ndim == 3:
                return ("model", None, None)
            if leaf == "bias":
                return (None,)
    if "mlp_up" in has:
        if leaf == "kernel" and ndim == 2:
            return (None, "model")
        if leaf == "bias" and ndim == 1:
            return ("model",)
    if "mlp_down" in has:
        if leaf == "kernel" and ndim == 2:
            return ("model", None)
        if leaf == "bias":
            return (None,)
    return None


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


def param_specs(named_shapes: dict, policy: ShardingPolicy,
                mesh_shape: dict) -> dict:
    """Each parameter's spec, JAX ``_leaf_spec``'s: a tuple with one entry
    a dim of the port's leaf, ``None``, ``"fsdp"`` or ``"model"``, by name
    (``named_shapes``: the port's names -> shapes, those of this rank's
    module before any model-axis cut; ``mesh_shape``: axis -> size). The
    stacked dim of a leaf the port holds per branch or layer is left
    out."""
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
            out[name] = ()
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
        if policy.tp and mesh_shape["model"] > 1 and lead != "model":
            inner = full[1:] if lead else full
            tp = _tp_spec(parts, inner)
            if tp is not None:
                spec[len(full) - len(inner):] = (
                    list(tp) + [None] * (len(inner) - len(tp)))
        if policy.fsdp:
            spec = _add_fsdp(spec, full, mesh_shape["fsdp"],
                             policy.fsdp_min_size)
        if stack is not None:
            if spec[0] == "fsdp":
                raise ValueError(
                    f"{name}: JAX shards the stacked {stack[1]} dim of this "
                    f"leaf over fsdp; the port holds whole modules there")
            spec = spec[1:]
        out[name] = tuple(spec)
    return out


def serve_param_specs(named_shapes: dict, tp: int) -> dict:
    """Each serving parameter's spec on a tensor-parallel replica of ``tp``
    ranks (counterpart: JAX ``serve_param_shardings``): ``param_specs``
    under ``ShardingPolicy(tp=True)`` on a mesh of ``{model: tp}`` and
    every other axis 1. Megatron on the heads and the MLP's hidden dim,
    everything else (embeddings, LayerNorms, the tied head) replicated; no
    fsdp: a serve replica keeps its layers resident."""
    mesh_shape = {axis: 1 for axis in ("data", "fsdp", "stage", "seq")}
    mesh_shape["model"] = tp
    return param_specs(named_shapes, ShardingPolicy(tp=True), mesh_shape)


def serve_pool_shape(shape: tuple, tp: int) -> tuple:
    """One rank's shape of a paged-KV pool leaf (counterpart: the shard
    shape of JAX ``serve_pool_pspec``): a value pool ``[num_pages,
    page_size, heads, head_dim]`` or an int8 pool's scale pool
    ``[num_pages, page_size, heads]`` with its heads divided by ``tp``;
    the page axis stays whole, so page indices, block tables and the
    allocator are those of one rank."""
    return tuple(shape[:2]) + (shape[2] // tp,) + tuple(shape[3:])


def placements_of(specs: dict) -> dict:
    """Each spec's placement over ``fsdp``: ``Shard(dim)`` or
    ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard

    return {name: Shard(spec.index("fsdp")) if "fsdp" in spec
            else Replicate() for name, spec in specs.items()}


def param_placements(named_shapes: dict, policy: ShardingPolicy,
                     mesh_shape: dict) -> dict:
    """Each parameter's placement over ``fsdp``: ``Shard(dim)`` or
    ``Replicate()``, by name (``param_specs``' arguments)."""
    return placements_of(param_specs(named_shapes, policy, mesh_shape))


def model_dims(specs: dict) -> dict:
    """name -> the dim split over ``model``, of the leaves ``specs``
    split (JAX's ``_tp_spec`` puts one dim of a leaf on the axis)."""
    return {name: spec.index("model") for name, spec in specs.items()
            if "model" in spec}


def cut_model_slice(t, dim: int, shard):
    """This rank's slice of ``t`` on ``dim`` over the model axis ``shard``
    (an ``AxisShard``), contiguous."""
    size = t.shape[dim] // shard.size
    return t.narrow(dim, shard.index * size, size).contiguous()


def tensor_parallel(model: nn.Module, specs: dict, shard) -> set:
    """Cut ``model`` (whole, as one process makes it) to this rank's slice
    of every leaf ``specs`` splits over ``model`` (``param_specs`` of its
    names and shapes; ``shard``: the model axis's ``AxisShard``), in
    place, and hand the axis to the attention and MLP modules whose weights
    were cut (``models/bert.py``). Returns the names cut; raises
    ``ValueError`` naming both numbers when a split dim (the heads, the
    MLP's width) does not divide by the axis."""
    from pytorch_distributed_training_tpu_torch.models.bert import (
        DenseGeneral,
    )

    dims = model_dims(specs)
    params = dict(model.named_parameters())
    for name, dim in dims.items():
        n = params[name].shape[dim]
        if n % shard.size:
            raise ValueError(
                f"{name}: dim {dim} of size {n} does not divide by the "
                f"model axis of {shard.size}")
    for name, dim in dims.items():
        path, _, leaf = name.rpartition(".")
        mod = model.get_submodule(path)
        old = mod._parameters[leaf]
        setattr(mod, leaf, nn.Parameter(
            cut_model_slice(old.detach(), dim, shard),
            requires_grad=old.requires_grad))
    cut = {name.rpartition(".")[0] for name in dims}
    for name, mod in model.named_modules():
        if isinstance(mod, DenseGeneral) and name in cut:
            n_in = len(mod.in_shape)
            mod.in_shape = tuple(mod.kernel.shape[:n_in])
            mod.out_shape = tuple(mod.kernel.shape[n_in:])
            if name.rpartition(".")[2] in ("out", "mlp_down"):
                mod.reduce_group = shard.group  # row-parallel
            else:  # column-parallel: int8 dy amaxes span the features
                mod.feature_group = shard.group
        elif {f"{name}.query".lstrip("."),
              f"{name}.mlp_up".lstrip(".")} & cut:
            mod.tp_shard = shard  # an attention, or a layer's MLP
    return set(dims)


def context_parallel(model: nn.Module, shard) -> None:
    """Hand the seq axis (``shard``, its ``AxisShard``) to every module of
    ``model`` that reads it (``models/bert.py``): the sequence is cut over
    it, each rank holding its columns."""
    for mod in model.modules():
        if hasattr(mod, "seq_shard"):
            mod.seq_shard = shard


def int8_groups(model: nn.Module, group) -> None:
    """Hand the gradient axes' group (``Mesh.grad_group``: data, fsdp,
    seq, over which the activations' rows and tokens are cut) to every
    int8 site of ``model`` (``models/bert.py``), whose amaxes are maxed
    over it."""
    from pytorch_distributed_training_tpu_torch.models.bert import (
        DenseGeneral,
    )

    for mod in model.modules():
        if isinstance(mod, DenseGeneral) and mod.int8_mode is not None:
            mod.batch_group = group


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
