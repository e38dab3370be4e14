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
  ``bert/pooler`` and ``classifier`` renamed alike.

A scanned trunk (``layers_scan/block/...`` for GPT-2, the ``train_lm``
default, or ``bert/layers_scan/layer/...`` for BERT, each leaf with a
leading [num_layers] axis; see the JAX package's ``models/relayout.py``
and ``models/bert.py``) is unstacked into per-layer entries. Leaves are
numpy arrays on the flax side, so this module needs no JAX.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

_SCAN = "layers_scan"
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


def _unstack(flat: dict[tuple, np.ndarray]) -> dict[tuple, np.ndarray]:
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


def _torch_name(path: tuple) -> str:
    parts = []
    for p in path:
        kind, _, idx = p.rpartition("_")
        if kind in _LISTS and idx.isdigit():
            parts += [_LISTS[kind], idx]
        else:
            parts.append(p)
    return ".".join(parts)


def params_from_jax(flax_params: Mapping) -> dict[str, torch.Tensor]:
    """flax params (nested dict of arrays; GPT-2 LM or BERT classifier,
    unscanned or scanned trunk) -> the port's ``state_dict`` (float32 CPU
    tensors as given)."""
    flat = _unstack(_flatten(flax_params))
    return {
        _torch_name(path): torch.from_numpy(np.array(leaf, copy=True))
        for path, leaf in flat.items()
    }


def params_to_jax(state_dict: Mapping[str, torch.Tensor]) -> dict:
    """Inverse of ``params_from_jax`` (unscanned trunk): nested dict of
    numpy arrays in the flax tree layout."""
    tree: dict = {}
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
        node = tree
        for p in flax_parts[:-1]:
            node = node.setdefault(p, {})
        node[flax_parts[-1]] = tensor.detach().cpu().float().numpy()
    return tree
