"""Parameter re-layout between the scanned and per-layer trunks
(counterpart: the JAX package's ``models/relayout.py``).

With ``scan_layers`` the trunk is one ``ScannedLayers`` module
(``models/bert.py``) whose every tensor stacks the layers' on a leading
[num_layers] dim, under ``layers_scan.<inner>.`` (``block`` for GPT-2,
``layer`` for BERT); the per-layer trunk names layer i ``blocks.i.`` or
``layers.i.`` with the same inner names and no leading dim. The two hold
the same values, so converting a ``state_dict`` is a reshape of names:
``unstack_scanned_params`` and ``stack_layer_params`` go both ways, for
the LM's trunk at the top of the dict and the classifier's under
``bert.`` alike (every trunk found). A checkpoint the scanned
``train_lm`` default wrote so drives the dense-cache generation
(``models/generate.py``) and the serving engine, which run the per-layer
trunk.
"""

from __future__ import annotations

from collections.abc import Mapping

import torch

_SCAN = "layers_scan"
# scanned inner-module name -> the per-layer list's name
_SCAN_INNER_TO_LIST = {"block": "blocks", "layer": "layers"}
_LIST_TO_SCAN_INNER = {v: k for k, v in _SCAN_INNER_TO_LIST.items()}


def has_scanned_trunk(names) -> bool:
    """True if any of ``names`` (a ``state_dict``, or its keys) lies in a
    stacked ``layers_scan`` trunk."""
    return any(_SCAN in name.split(".") for name in names)


def _scan_split(name: str):
    """``(prefix, inner, rest)`` of a ``...layers_scan.<inner>.<rest>``
    name, else None."""
    parts = name.split(".")
    if _SCAN not in parts:
        return None
    at = parts.index(_SCAN)
    if len(parts) < at + 3 or parts[at + 1] not in _SCAN_INNER_TO_LIST:
        raise ValueError(
            f"unrecognized scanned trunk entry {name!r} (expected "
            f"layers_scan.block.... or layers_scan.layer....)")
    return (".".join(parts[:at]), parts[at + 1], ".".join(parts[at + 2:]))


def _join(*parts: str) -> str:
    return ".".join(p for p in parts if p)


def unstack_scanned_params(state: Mapping[str, torch.Tensor]
                           ) -> dict[str, torch.Tensor]:
    """[L]-stacked ``layers_scan`` trunks -> per-layer ``blocks.i`` /
    ``layers.i``; a new dict whose trunk tensors are slices of the
    originals (views)."""
    out: dict[str, torch.Tensor] = {}
    dims: dict[str, set] = {}
    for name, t in state.items():
        split = _scan_split(name)
        if split is None:
            out[name] = t
            continue
        prefix, inner, rest = split
        dims.setdefault(_join(prefix, _SCAN), set()).add(int(t.shape[0]))
        for i, leaf in enumerate(t.unbind(0)):
            out[_join(prefix, _SCAN_INNER_TO_LIST[inner], str(i), rest)] = leaf
    for trunk, n in dims.items():
        if len(n) != 1:
            raise ValueError(
                f"inconsistent leading layer dims in {trunk}: {sorted(n)}")
    return out


def stack_layer_params(state: Mapping[str, torch.Tensor]
                       ) -> dict[str, torch.Tensor]:
    """Per-layer ``blocks.i`` / ``layers.i`` -> [L]-stacked
    ``layers_scan.<inner>`` trunks (new tensors)."""
    out: dict[str, torch.Tensor] = {}
    layers: dict[str, dict[int, torch.Tensor]] = {}
    for name, t in state.items():
        parts = name.split(".")
        at = next((j for j, p in enumerate(parts[:-1])
                   if p in _LIST_TO_SCAN_INNER and parts[j + 1].isdigit()),
                  None)
        if at is None:
            out[name] = t
            continue
        key = _join(".".join(parts[:at]), _SCAN,
                    _LIST_TO_SCAN_INNER[parts[at]], ".".join(parts[at + 2:]))
        layers.setdefault(key, {})[int(parts[at + 1])] = t
    for key, by_layer in layers.items():
        idxs = sorted(by_layer)
        if idxs != list(range(len(idxs))):
            raise ValueError(f"non-contiguous layer indices of {key}: {idxs}")
        out[key] = torch.stack([by_layer[i] for i in idxs])
    return out
