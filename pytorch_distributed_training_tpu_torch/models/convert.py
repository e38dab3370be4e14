"""Weight bridge between the JAX package's flax parameter trees and the
port's ``state_dict`` (no JAX counterpart).

The port keeps flax's layouts (``DenseGeneral`` kernels as ``in_shape +
out_shape``, ``Embed`` tables as ``embedding``, LayerNorm ``scale`` and
``bias``), so the bridge is a rename. Per-layer modules are
``block_i`` (GPT-2) and ``layer_i`` (BERT) in flax, list entries
``blocks.i`` and ``layers.i`` here, wherever they sit in the tree:

- GPT-2: ``block_0/attention/query/kernel`` <->
  ``blocks.0.attention.query.kernel``;
- BERT classifier: ``bert/layer_0/attention_norm/scale`` <->
  ``bert.layers.0.attention_norm.scale``, with ``bert/embeddings/...``,
  ``bert/pooler`` and ``classifier`` renamed alike (RoBERTa,
  ``roberta_style``, has BERT's names, its token-type table one row).

A scanned trunk (``layers_scan/block/...`` for GPT-2, the ``train_lm``
default, or ``bert/layers_scan/layer/...`` for BERT, each leaf with a
leading [num_layers] axis; see the JAX package's ``models/relayout.py``
and ``models/bert.py``) is the port's ``ScannedLayers`` under the same
names. Both directions take either trunk and give the one ``scan_layers``
asks for: per-layer entries (False) or the stacked trunk (True), layer i
of the one slice i of the other. The branch ensemble's
(``models/branch.py``) ``branches/layer_i/...`` leaves carry a leading
[n_branches] axis: branch b becomes ``branches.b.layers.i...``, and
``params_to_jax`` stacks the branches back (the branches keep per-layer
entries). A model sharded by FSDP (``parallel/sharding.py``) bridges
through its full tensors: ``params_to_jax`` gathers each ``DTensor``
leaf (``full_tensor()``); load a converted dict before sharding. A model
cut by tensor parallelism (``parallel/sharding.tensor_parallel``) bridges
through ``tp``, ``(dims, shard)``: the name -> dim of every leaf split
over the model axis (``parallel/sharding.model_dims``) and the axis's
``AxisShard``. ``params_from_jax`` then keeps this rank's slice of each,
and ``params_to_jax`` gathers the slices over the axis (a collective:
every rank of it calls), so the trees compare whole. Leaves are numpy
arrays on the flax side, so this module needs no JAX.

The delayed-int8 amaxes (JAX's ``"quant"`` collection, ``amax`` and
``dy_amax`` leaves in the params tree's layout: per layer, stacked on
``layers_scan`` and on ``branches``) are the int8 sites' buffers of the
same names (``models/bert.py``): ``params_from_jax(..., quant=tree)``
adds them to the ``state_dict``, ``params_to_jax`` leaves them out and
``quant_to_jax`` gives them alone, each trunk layout and the branches
handled as for the parameters.

The weight-only int8 serving variant (the JAX package's
``quantize_serve_params``: int8 ``kernel`` leaves beside fp32
``kernel_scale`` ones) bridges as it is, dtypes kept both ways; a
``DenseGeneral`` loading a ``kernel_scale`` takes the int8 layout.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Optional

import numpy as np
import torch

_SCAN = "layers_scan"
_BRANCHES = "branches"  # the ensemble's stacked axis (models/branch.py)
# flax per-layer prefix -> the port's list attribute
_LISTS = {"block": "blocks", "layer": "layers"}
_PREFIXES = {v: k for k, v in _LISTS.items()}


def _flatten(tree: Mapping, prefix: tuple = ()) -> dict[tuple, np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, prefix + (str(k),)))
        else:
            out[prefix + (str(k),)] = np.asarray(v)
    return out


def _unstack_branches(flat: dict[tuple, np.ndarray]
                      ) -> dict[tuple, np.ndarray]:
    out = {}
    for path, leaf in flat.items():
        if _BRANCHES not in path:
            out[path] = leaf
            continue
        at = path.index(_BRANCHES) + 1
        for b in range(leaf.shape[0]):
            out[path[:at] + (str(b),) + path[at:]] = leaf[b]
    return out


def _trunk_index(path: tuple):
    """(position, kind, layer) of a trunk layer entry ``block_i`` /
    ``layer_i`` in ``path`` (not a branch's), else None."""
    if _BRANCHES in path:
        return None
    for at, p in enumerate(path):
        kind, _, idx = p.rpartition("_")
        if kind in _LISTS and idx.isdigit():
            return at, kind, int(idx)
    return None


def _unstack_scan(flat: dict[tuple, np.ndarray]) -> dict[tuple, np.ndarray]:
    """``layers_scan/<kind>/...`` [L, ...] -> ``<kind>_i/...``."""
    out = {}
    for path, leaf in flat.items():
        if _SCAN not in path:
            out[path] = leaf
            continue
        at = path.index(_SCAN)
        kind = path[at + 1] if len(path) > at + 1 else None
        if kind not in _LISTS:
            raise ValueError(
                f"unrecognized scanned trunk entry {'/'.join(path)} "
                f"(expected layers_scan/block/... or layers_scan/layer/...)"
            )
        for i in range(leaf.shape[0]):
            out[path[:at] + (f"{kind}_{i}",) + path[at + 2:]] = leaf[i]
    return out


def _stack_scan(flat: dict[tuple, np.ndarray]) -> dict[tuple, np.ndarray]:
    """``<kind>_i/...`` -> ``layers_scan/<kind>/...`` [L, ...]."""
    out, layers = {}, {}
    for path, leaf in flat.items():
        found = _trunk_index(path)
        if found is None:
            out[path] = leaf
            continue
        at, kind, i = found
        key = path[:at] + (_SCAN, kind) + path[at + 1:]
        layers.setdefault(key, {})[i] = leaf
    for key, by_layer in layers.items():
        if sorted(by_layer) != list(range(len(by_layer))):
            raise ValueError(f"layers {sorted(by_layer)} of {'/'.join(key)} "
                             f"are not 0..{len(by_layer) - 1}")
        out[key] = np.stack([by_layer[i] for i in range(len(by_layer))])
    return out


def _relayout(flat: dict[tuple, np.ndarray], scan_layers: bool
              ) -> dict[tuple, np.ndarray]:
    return _stack_scan(flat) if scan_layers else _unstack_scan(flat)


def _torch_name(path: tuple) -> str:
    parts = []
    for p in path:
        kind, _, idx = p.rpartition("_")
        if kind in _LISTS and idx.isdigit():
            parts += [_LISTS[kind], idx]
        else:
            parts.append(p)
    return ".".join(parts)


_QUANT_LEAVES = ("amax", "dy_amax")  # the "quant" collection's leaves


def is_quant_name(name: str) -> bool:
    """Whether a ``state_dict`` name is an int8 site's amax buffer."""
    return name.rpartition(".")[2] in _QUANT_LEAVES


def params_from_jax(flax_params: Mapping, *, scan_layers: bool = False,
                    tp=None, quant: Optional[Mapping] = None
                    ) -> dict[str, torch.Tensor]:
    """flax params (nested dict of arrays; GPT-2 LM or BERT classifier,
    unscanned or scanned trunk, float or with int8 serving kernels) -> the
    port's ``state_dict`` (CPU tensors of the leaves' dtypes) for a model
    whose trunk is scanned (``scan_layers``) or not; with ``tp``, this
    rank's slice of the leaves it splits; with ``quant``, the ``"quant"``
    collection's amaxes too."""
    from pytorch_distributed_training_tpu_torch.parallel.sharding import (
        cut_model_slice,
    )

    flat = _flatten(flax_params)
    if quant is not None:
        flat.update(_flatten(quant))
    flat = _relayout(_unstack_branches(flat), scan_layers)
    out = {
        _torch_name(path): torch.from_numpy(np.array(leaf, copy=True))
        for path, leaf in flat.items()
    }
    if tp is not None:
        dims, shard = tp
        out.update({name: cut_model_slice(out[name], dim, shard)
                    for name, dim in dims.items()})
    return out


def _gather_model(t: torch.Tensor, dim: int, shard) -> torch.Tensor:
    """The whole leaf from every model rank's slice of it on ``dim``."""
    import torch.distributed as dist

    parts = [torch.empty_like(t) for _ in range(shard.size)]
    dist.all_gather(parts, t.contiguous(), group=shard.group)
    return torch.cat(parts, dim=dim)


def _stack_branches(tree: dict) -> dict:
    """``branches/{"0", "1", ...}/...`` -> ``branches/...`` with a leading
    [n_branches] axis on every leaf."""
    for key, node in tree.items():
        if key != _BRANCHES:
            if isinstance(node, dict):
                _stack_branches(node)
            continue
        ids = sorted(node, key=int)
        if ids != [str(b) for b in range(len(ids))]:
            raise ValueError(f"branches {ids} are not 0..{len(ids) - 1} "
                             f"(merge every rank's state dict first)")
        flats = [_flatten(node[b]) for b in ids]
        stacked: dict = {}
        for path in flats[0]:
            at = stacked
            for p in path[:-1]:
                at = at.setdefault(p, {})
            at[path[-1]] = np.stack([f[path] for f in flats])
        tree[key] = stacked
    return tree


def params_to_jax(state_dict: Mapping[str, torch.Tensor], *,
                  scan_layers: bool = False, tp=None) -> dict:
    """Inverse of ``params_from_jax``: nested dict of numpy arrays in the
    flax tree layout, the trunk per layer or scanned (``scan_layers``), the
    ensemble's branches stacked back, float32 but for int8 kernels;
    ``DTensor`` leaves (an FSDP model's) gathered whole first, then, with
    ``tp``, the model axis's slices. The amax buffers are left out
    (``quant_to_jax``)."""
    return _to_jax({n: t for n, t in state_dict.items()
                    if not is_quant_name(n)}, scan_layers, tp)


def quant_to_jax(state_dict: Mapping[str, torch.Tensor], *,
                 scan_layers: bool = False) -> Optional[dict]:
    """The ``"quant"`` collection of a ``state_dict``'s amax buffers, in
    the layout of ``params_to_jax``; None when it has none."""
    quant = {n: t for n, t in state_dict.items() if is_quant_name(n)}
    return _to_jax(quant, scan_layers, None) if quant else None


def _to_jax(state_dict, scan_layers, tp) -> dict:
    dims, shard = tp if tp is not None else ({}, None)
    flat: dict[tuple, np.ndarray] = {}
    for name, tensor in state_dict.items():
        parts, flax_parts = name.split("."), []
        i = 0
        while i < len(parts):
            p = parts[i]
            if p in _PREFIXES and i + 1 < len(parts) and parts[i + 1].isdigit():
                flax_parts.append(f"{_PREFIXES[p]}_{parts[i + 1]}")
                i += 2
            else:
                flax_parts.append(p)
                i += 1
        if hasattr(tensor, "full_tensor"):
            tensor = tensor.full_tensor()
        if name in dims:
            tensor = _gather_model(tensor.detach(), dims[name], shard)
        leaf = tensor.detach().cpu()
        if leaf.dtype != torch.int8:
            leaf = leaf.float()
        flat[tuple(flax_parts)] = leaf.numpy()
    tree: dict = {}
    for path, leaf in _relayout(flat, scan_layers).items():
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = leaf
    return _stack_branches(tree)
