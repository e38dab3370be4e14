"""int8 serving (weight-only int8 projections and int8 KV pages) and int8
training (counterpart: the JAX package's ``ops/quant.py``).

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

The training half (counterpart: JAX ``ops/quant.py:64-360``): dense
contractions whose products run int8 x int8 -> int32, rescaled once,
with JAX's straight-through backward.

- ``quantize_per_tensor`` / ``quantize_per_channel``: one scale for the
  whole tensor (activations, gradients), one per output channel (weights);
- ``int8_dense(x, kernel, n_contract, mode)``: ``x``'s trailing
  ``n_contract`` axes against the kernel's leading ones; ``mode="fwd"``
  has a backward of compute-dtype products of the dequantized operands
  with float32 accumulation, ``mode="full"`` an int8 dgrad and wgrad on
  fresh per-tensor scales of ``dy * sw`` and ``dy``;
- ``int8_dense_delayed``: the activation's scale is the one carried from
  the previous microbatch (``amax_prev``), and the current amax comes back
  to be carried on; ``amax_prev`` gets a zero gradient;
- ``int8_dense_delayed_grads``: ``full`` with carried dy scales too. The
  site's ``dy_amax`` [2] is read when the forward runs (microbatch m - 1's
  observations) and the backward writes microbatch m's
  ``[amax(dy * sw), amax(dy)]`` into it; JAX returns them through a sink's
  cotangent, which torch does not need. Inside ``dy_calibration_mode``
  (read when the forward runs, as JAX binds it when it traces) the
  backward quantizes on fresh dynamic scales and still writes them.

Every amax is global, as GSPMD makes ``jnp.max`` of a sharded array: each
is maxed over the process groups the tensor is cut over (``QuantGroups``;
``comms/collectives.all_reduce_max``, one scalar collective, a vector for
a row-parallel weight's channels). A row-parallel site (tensor
parallelism) sums its int32 partial products over the model axis before
the one rescale, as JAX does, so the sum is exact.

The int8 products (``int8_mm``) are ``torch._int_mm`` on the card: the
counterpart of XLA's int8 ``dot_general``, which the JAX package runs
outside any Pallas kernel. Its operands go in as ``a [m, k]`` and ``bt
[n, k]`` row-major (cuBLASLt's ``TN`` layout), zero rows and columns
padded on to its limits (more than 16 rows, k and n multiples of 8),
which add nothing to an int32 sum. On the CPU the product is a float64
matmul of the int8 values, exact for every sum under 2^53.
No kernel here: the JAX package computes all of this in XLA.
"""

from __future__ import annotations

import contextlib
import math
import threading
from typing import NamedTuple, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F

from pytorch_distributed_training_tpu_torch.comms.collectives import (
    all_reduce_,
    all_reduce_max,
)

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


# ------------------------------------------------------------- training


class QuantGroups(NamedTuple):
    """The process groups each amax of a dense site is maxed over (each
    None or a group; ``all_reduce_max`` skips a group of one): ``x``, the
    activation's (the batch and seq groups, and the model group at a
    row-parallel site, whose input is cut on the contracted features);
    ``w``, the weight's per-channel amax (the model group at a row-parallel
    site); ``dy``, the output gradient's (the batch and seq groups, and
    the model group at a column-parallel site); ``sum``, the model group
    a row-parallel site sums its int32 products over."""

    x: tuple = ()
    w: tuple = ()
    dy: tuple = ()
    sum: Optional[object] = None


_NO_GROUPS = QuantGroups()


def _global_max(t, groups):
    for group in groups:
        t = all_reduce_max(t, group)
    return t


def _tensor_amax(x, groups=()):
    """The absmax of the whole of ``x`` (every shard's, over ``groups``),
    floored at 1e-12, float32 scalar."""
    return _global_max(_absmax(x, tuple(range(x.dim())), keepdim=False),
                       groups)


def quantize_per_tensor(x, groups=()):
    """-> (int8 tensor, fp32 scalar scale); ``x ~ q.float() * scale``."""
    scale = _tensor_amax(x, groups) / _INT8_MAX
    return _quantize(x, scale), scale


def quantize_per_channel(w, contract_dims, groups=()):
    """-> (int8 weight, fp32 per-output-channel scale, the contracted
    ``contract_dims`` reduced away)."""
    scale = _global_max(_absmax(w, tuple(contract_dims), keepdim=False),
                        groups) / _INT8_MAX
    keep = list(scale.shape)
    for d in sorted(contract_dims):
        keep.insert(d, 1)
    return _quantize(w, scale.reshape(keep)), scale


def int8_mm(a, bt):
    """``a [m, k] @ bt [n, k]^T`` of int8 operands -> int32 [m, n], exact:
    ``torch._int_mm`` on the card (zero padding to its limits), a float64
    product on the CPU."""
    if a.is_cuda:
        return _int_mm_cuda(a, bt)
    return torch.matmul(a.double(), bt.double().t()).to(torch.int32)


def _int_mm_cuda(a, bt):
    m, k = a.shape
    n = bt.shape[0]
    if bt.shape[1] != k or a.dtype != torch.int8 or bt.dtype != torch.int8:
        raise ValueError(f"int8_mm takes int8 [m, k] and [n, k], got "
                         f"{a.dtype}{tuple(a.shape)}, "
                         f"{bt.dtype}{tuple(bt.shape)}")
    pad_m, pad_k, pad_n = max(17 - m, 0), -k % 8, -n % 8
    if pad_m or pad_k:
        a = F.pad(a, (0, pad_k, 0, pad_m))
    if pad_n or pad_k:
        bt = F.pad(bt, (0, pad_k, 0, pad_n))
    out = torch._int_mm(a.contiguous(), bt.contiguous().t())
    return out[:m, :n] if pad_m or pad_n else out


def _matmul_acc32(a, b, out_dtype):
    """``a @ b`` of compute-dtype operands with float32 accumulation,
    rounded once to ``out_dtype`` (XLA's ``preferred_element_type``)."""
    if a.is_cuda and a.dtype != torch.float32:
        if out_dtype == torch.float32:
            return torch.mm(a, b, out_dtype=torch.float32)
        return torch.mm(a, b).to(out_dtype)
    return torch.matmul(a.float(), b.float()).to(out_dtype)


_DY_CAL = threading.local()


@contextlib.contextmanager
def dy_calibration_mode():
    """Inside it, ``int8_dense_delayed_grads`` forwards give backwards that
    quantize dy on fresh dynamic scales (and still write their
    observations): the one calibration pass before step 0
    (``train/step.calibrate_quant``). Reentrant: the value before it comes
    back on exit (the JAX context sets False instead)."""
    before = getattr(_DY_CAL, "on", False)
    _DY_CAL.on = True
    try:
        yield
    finally:
        _DY_CAL.on = before


def calibrating() -> bool:
    return getattr(_DY_CAL, "on", False)


class _Int8Dense(torch.autograd.Function):
    """The int8 dense contraction on 2-D operands ``x [T, K]``, ``kernel
    [K, N]``: returns (y [T, N] in ``x``'s dtype, amax of ``x``)."""

    @staticmethod
    def forward(ctx, x, kernel, amax_prev, mode, dy_amax, calibrate,
                groups):
        amax = _tensor_amax(x, groups.x)
        if amax_prev is None:
            sx = amax / _INT8_MAX
        else:   # delayed: the carried amax, floored as the grid's
            sx = amax_prev.detach().float().clamp_min(1e-12) / _INT8_MAX
        xq = _quantize(x, sx)
        wq, sw = quantize_per_channel(kernel, (0,), groups.w)
        acc = int8_mm(xq, wq.t().contiguous())
        if groups.sum is not None and dist.get_world_size(groups.sum) > 1:
            # row-parallel: the int32 partials summed before the rescale
            all_reduce_(acc, dist.ReduceOp.SUM, groups.sum)
        y = (acc.float() * (sx * sw)).to(x.dtype)
        ctx.save_for_backward(xq, wq, sx, sw)
        ctx.meta = (mode, x.dtype, kernel.dtype, groups,
                    None if amax_prev is None else amax_prev.shape)
        # delayed dy scales: this microbatch's backward quantizes with the
        # observations in dy_amax NOW (microbatch m - 1's); it writes its
        # own into dy_amax for the next one
        ctx.dy = None if dy_amax is None else (dy_amax,
                                               dy_amax.detach().clone(),
                                               calibrate)
        ctx.mark_non_differentiable(amax)
        return y, amax

    @staticmethod
    def backward(ctx, dy, _):
        xq, wq, sx, sw = ctx.saved_tensors
        mode, x_dtype, w_dtype, groups, amax_shape = ctx.meta
        if mode == "full":
            dy_scaled = dy.float() * sw
            obs = (_tensor_amax(dy_scaled, groups.dy),
                   _tensor_amax(dy, groups.dy))
            s0, s1 = obs[0] / _INT8_MAX, obs[1] / _INT8_MAX
            if ctx.dy is not None:
                sink, carried, calibrate = ctx.dy
                if not calibrate:
                    s0, s1 = (carried.float().clamp_min(1e-12)
                              / _INT8_MAX).unbind()
                sink.copy_(torch.stack(obs))
            dx = (int8_mm(_quantize(dy_scaled, s0), wq).float()
                  * s0).to(x_dtype)
            dw = (int8_mm(xq.t().contiguous(),
                          _quantize(dy, s1).t().contiguous()).float()
                  * (sx * s1)).to(w_dtype)
        else:
            xdq = (xq.float() * sx).to(x_dtype)
            wdq = (wq.float() * sw).to(x_dtype)
            dy = dy.to(x_dtype)
            dx = _matmul_acc32(dy, wdq.t(), x_dtype)
            dw = _matmul_acc32(xdq.t(), dy, w_dtype)
        d_amax = (None if amax_shape is None
                  else torch.zeros(amax_shape, device=dy.device))
        return dx, dw, d_amax, None, None, None, None


def _dense(x, kernel, n_contract, mode, amax_prev=None, dy_amax=None,
           groups=None):
    if mode not in ("fwd", "full"):
        raise ValueError(f"mode must be fwd/full, got {mode!r}")
    k = math.prod(kernel.shape[:n_contract])
    features = kernel.shape[n_contract:]
    lead = x.shape[:x.dim() - n_contract]
    if math.prod(x.shape[x.dim() - n_contract:]) != k:
        raise ValueError(f"x {tuple(x.shape)} does not contract with kernel "
                         f"{tuple(kernel.shape)} over {n_contract} axes")
    y, amax = _Int8Dense.apply(
        x.reshape(-1, k), kernel.reshape(k, -1), amax_prev, mode, dy_amax,
        calibrating(), groups or _NO_GROUPS)
    return y.reshape(*lead, *features), amax


def int8_dense(x, kernel, n_contract: int = 1, mode: str = "fwd",
               groups: Optional[QuantGroups] = None):
    """int8 DenseGeneral contraction, straight-through backward: ``x``
    [b.., c1..cn] against ``kernel`` [c1..cn, f..] -> [b.., f..] in
    ``x``'s dtype; ``mode`` "fwd" (float backward) or "full" (int8 dgrad
    and wgrad)."""
    return _dense(x, kernel, n_contract, mode, groups=groups)[0]


def int8_dense_delayed(x, kernel, amax_prev, n_contract: int = 1,
                       mode: str = "full",
                       groups: Optional[QuantGroups] = None):
    """``int8_dense`` on the carried activation amax ``amax_prev`` -> (y,
    new_amax), the amax of this ``x`` to carry on; ``amax_prev`` gets a
    zero gradient."""
    return _dense(x, kernel, n_contract, mode, amax_prev=amax_prev,
                  groups=groups)


def int8_dense_delayed_grads(x, kernel, amax_prev, dy_amax,
                             n_contract: int = 1,
                             groups: Optional[QuantGroups] = None):
    """``int8_dense_delayed`` in ``full`` mode whose backward quantizes dy
    on the carried ``dy_amax`` [2] (read now) and writes its observations
    ``[amax(dy * sw), amax(dy)]`` into ``dy_amax`` -> (y, new_amax)."""
    return _dense(x, kernel, n_contract, "full", amax_prev=amax_prev,
                  dy_amax=dy_amax, groups=groups)
