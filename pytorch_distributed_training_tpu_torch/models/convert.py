"""Weight bridge between the JAX package's flax parameter trees and the
port's ``state_dict`` (no JAX counterpart).

The port keeps flax's layouts (``DenseGeneral`` kernels as ``in_shape +
out_shape``, ``Embed`` tables as ``embedding``, LayerNorm ``scale`` and
``bias``), so the bridge is a rename: ``block_0/attention/query/kernel``
<-> ``blocks.0.attention.query.kernel``. A scanned trunk
(``layers_scan/block/...`` with a leading [num_layers] axis, the
``train_lm`` default; see the JAX package's ``models/relayout.py``) is
unstacked into per-layer entries. Leaves are numpy arrays on the flax
side, so this module needs no JAX.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

_BLOCK = "block_"


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
        if path[0] != "layers_scan":
            out[path] = leaf
            continue
        if len(path) < 2 or path[1] != "block":
            raise ValueError(
                f"unrecognized scanned trunk entry {'/'.join(path)} "
                f"(expected layers_scan/block/...)"
            )
        for i in range(leaf.shape[0]):
            out[(f"{_BLOCK}{i}",) + path[2:]] = leaf[i]
    return out


def _torch_name(path: tuple) -> str:
    parts = list(path)
    head = parts[0]
    if head.startswith(_BLOCK) and head[len(_BLOCK):].isdigit():
        parts[0:1] = ["blocks", head[len(_BLOCK):]]
    return ".".join(parts)


def params_from_jax(flax_params: Mapping) -> dict[str, torch.Tensor]:
    """flax GPT-2 params (nested dict of arrays; unscanned or scanned
    trunk) -> the port's ``state_dict`` (float32 CPU tensors as given)."""
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
        parts = name.split(".")
        if parts[0] == "blocks":
            parts[0:2] = [f"{_BLOCK}{parts[1]}"]
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = tensor.detach().cpu().float().numpy()
    return tree
