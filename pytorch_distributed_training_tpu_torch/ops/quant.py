"""int8 serving: weight-only int8 projections and int8 KV pages
(counterpart: the serving half of the JAX package's ``ops/quant.py``).

One quantization grid for everything: symmetric, saturating at ±127,
``clip(round(x / scale), -127, 127)`` with a true float32 division (not a
multiply by the reciprocal) and ``torch.round``'s half-to-even rounding,
as ``jnp.round`` rounds; ``scale`` is the absmax over the reduced axes /
127, floored at 1e-12 so an all-zero row dequantizes to zeros, not NaN.

- ``quantize_kernel``: per-output-channel weight scales (the contracted
  leading kernel axes reduce away and stay as size-1 dims, so the dequant
  ``kernel.float() * scale`` is a plain broadcast);
- ``quantize_serve_params`` / ``dequantize_serve_params`` /
  ``serve_params_variant``: the weight-only int8 variant of a serving
  ``state_dict`` (the port's names, ``blocks.0.attention.query.kernel``):
  each projection of ``_SERVE_QUANT_MODULES`` gets an int8 ``kernel`` and
  an fp32 ``kernel_scale``; embeddings, LayerNorms, biases and the tied
  head stay as they are;
- ``quantize_kv``: K/V page writes, one fp32 scale per (token, head)
  (the head_dim axis reduces away).

The training half (the int8 ``dot_general``, delayed scaling,
``QuantDenseGeneral``) is not ported yet (ROADMAP.md, queue 1, slice 5).
No kernel here: the JAX package computes all of this in XLA.
"""

from __future__ import annotations

import torch

_INT8_MAX = 127.0

#: serving projections whose kernels quantize -> number of leading
#: contracted kernel axes (the ``DenseGeneral`` layout ``[*in, *out]``)
_SERVE_QUANT_MODULES = {
    "query": 1, "key": 1, "value": 1, "out": 2,
    "mlp_up": 1, "mlp_down": 1,
}


def _absmax(x, dims, keepdim=True):
    m = torch.amax(x.float().abs(), dim=dims, keepdim=keepdim)
    # guard all-zero rows: a scale of 0 would give NaN on dequant
    return m.clamp_min(1e-12)


def _quantize(x, scale):
    """THE grid: every int8 cast of the port goes through here."""
    return torch.div(x.float(), scale).round().clamp(-127, 127).to(torch.int8)


def quantize_kernel(kernel, n_contract: int):
    """-> (int8 kernel, fp32 per-output-channel scale with the contracted
    axes kept as size-1 dims); ``kernel ~ q.float() * scale``."""
    scale = _absmax(kernel, tuple(range(n_contract))) / _INT8_MAX
    return _quantize(kernel, scale), scale


def quantize_serve_params(state_dict):
    """Weight-only int8 variant of a serving ``state_dict``: every
    projection kernel of ``_SERVE_QUANT_MODULES`` becomes int8 beside a new
    ``kernel_scale``; everything else passes through. Idempotent: an int8
    kernel stays as it is."""
    out = dict(state_dict)
    for name, kernel in state_dict.items():
        # blocks.0.attention.query.kernel: the module is "query"
        module = name.split(".")[-2] if name.endswith(".kernel") else ""
        if module not in _SERVE_QUANT_MODULES or kernel.dtype == torch.int8:
            continue
        q, scale = quantize_kernel(kernel, _SERVE_QUANT_MODULES[module])
        out[name] = q
        out[name + "_scale"] = scale
    return out


def dequantize_serve_params(state_dict):
    """Inverse of ``quantize_serve_params``: each int8 kernel becomes
    ``kernel.float() * kernel_scale`` (float32) and the scale is dropped; a
    dict without scales passes through."""
    out = {}
    for name, value in state_dict.items():
        if name.endswith(".kernel_scale"):
            continue
        scale = state_dict.get(name + "_scale")
        out[name] = value if scale is None else value.float() * scale
    return out


def serve_params_variant(state_dict) -> str:
    """``"int8"`` when the dict carries quantized kernels (any
    ``kernel_scale``), else ``"fp32"``."""
    return ("int8" if any(n.endswith(".kernel_scale") for n in state_dict)
            else "fp32")


def quantize_kv(values, dim: int = -1):
    """Symmetric int8 quantization of K/V page writes: one fp32 scale per
    everything but ``dim`` -> (int8 values, fp32 scales with ``dim``
    dropped)."""
    x = values.float()   # one cast, shared by the absmax and the grid
    scale = _absmax(x, dim) / _INT8_MAX
    return _quantize(x, scale), scale.squeeze(dim)
