"""LayerNorm and the fused dropout + residual add + LayerNorm tail: the
Hopper kernels and their plain versions (counterpart: the JAX package's
``ops/layer_norm.py`` ``layer_norm`` / ``dropout_add_layer_norm`` /
``FusedLayerNorm`` / ``FusedDropoutAddLayerNorm``).

Contract, as in the JAX package: normalization over the last axis with
float32 statistics whatever the input dtype, biased variance, eps inside
the rsqrt, float32 scale/bias, output cast to ``out_dtype`` (the models
cast the LayerNorm output straight to the compute dtype, so the kernel
emits it directly). Both ops are ``torch.autograd.Function``s whose
backward is a kernel too:

- ``layer_norm``: forward ``csrc/layer_norm.cu`` ``pdt_layer_norm_fwd``;
  backward ``pdt_layer_norm_bwd`` recomputes the statistics from the
  saved x and returns dx in x's dtype and float32 dscale/dbias.
- ``dropout_add_layer_norm``: ``LN(x + dropout(h))`` with the keep mask
  drawn from ``(seed, site)`` (``ops/dropout.py``); the forward saves
  ``s = x + dropout(h)`` in h's dtype (bf16 under the bf16 policy) and
  the backward recomputes the statistics from that rounded s, as the JAX
  package does. With nothing requiring a gradient (eval, ``no_grad``) the
  forward writes no s. The two tails of a block share one seed and differ
  by ``site``.

Both kernels' backward write float32 partial rows of dscale/dbias, one per
block, which are summed here with ``torch.sum`` (the JAX package sums its
per-block partials outside its kernel too): no atomics, so two runs give
the same bits.

On a CPU tensor every step runs its plain version (``reference_*``); on a
CUDA tensor the kernels (built at first use) or an error.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch
from torch import nn

from pytorch_distributed_training_tpu_torch.ops import _build
from pytorch_distributed_training_tpu_torch.ops.dropout import (
    check_seed,
    keep_mask,
    mask_threshold,
)

_MAX_H = 2048  # 64 float registers per lane in the one-warp-per-row kernels
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_ROWS_PER_BLOCK = 4
# backward grid cap: blocks beyond it walk more rows per warp instead of
# writing more partial rows (a function of the row count only, so the
# summation order, and the bits, do not depend on the card)
_MAX_PARTIAL_BLOCKS = 256


def _use_kernel(x: torch.Tensor, what: str) -> bool:
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"{what} runs on cpu or cuda, got {x.device}")
    return True


def _partial_blocks(rows: int) -> int:
    """Blocks (= float32 partial rows) of a backward launch over ``rows``."""
    return max(1, min(-(-rows // _ROWS_PER_BLOCK), _MAX_PARTIAL_BLOCKS))


# --------------------------------------------------------- plain versions


def _ln_stats(xf, eps: float):
    """float32 (mean, rstd, xhat) over the last axis: the LayerNorm formula
    of every plain version here."""
    mean = xf.mean(dim=-1, keepdim=True)
    c = xf - mean
    var = (c * c).mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    return mean, rstd, c * rstd


def _ln_dx(xhat, dy, scale_f32, rstd):
    """LayerNorm input gradient from float32 xhat/dy (the JAX ``_ln_dx``)."""
    wdy = dy * scale_f32
    h = xhat.shape[-1]
    c1 = (wdy * xhat).sum(dim=-1, keepdim=True) / h
    c2 = wdy.sum(dim=-1, keepdim=True) / h
    return (wdy - xhat * c1 - c2) * rstd


def _param_grads(dyf, xhat):
    h = dyf.shape[-1]
    return ((dyf * xhat).reshape(-1, h).sum(dim=0),
            dyf.reshape(-1, h).sum(dim=0))


def reference_layer_norm(x, scale, bias, *, eps: float, out_dtype=None):
    """Plain twin of the kernel: fp32 stats, biased variance, cast at the end."""
    out_dtype = out_dtype or x.dtype
    _, _, xhat = _ln_stats(x.float(), eps)
    y = xhat * scale.float() + bias.float()
    return y.to(out_dtype)


def reference_layer_norm_bwd(x, dy, scale, *, eps: float):
    """Plain twin of the backward kernel: (dx in x's dtype, float32
    dscale, float32 dbias), statistics recomputed from x."""
    _, rstd, xhat = _ln_stats(x.float(), eps)
    dyf = dy.to(x.dtype).float()
    dx = _ln_dx(xhat, dyf, scale.float(), rstd).to(x.dtype)
    return (dx, *_param_grads(dyf, xhat))


def reference_dal_fwd(h, x, scale, bias, *, rate: float, seed: int,
                      site: int, eps: float, out_dtype,
                      keep: Optional[torch.Tensor] = None):
    """Plain twin of the dropout-add-LayerNorm forward: (y, s) with s in
    h's dtype. ``keep`` overrides the generator's mask (tests feed the JAX
    interpreter's all-dropped mask)."""
    hf = h.float()
    if rate > 0.0:
        if keep is None:
            keep = keep_mask(tuple(h.shape), rate, seed, site, h.device)
        hf = torch.where(keep, hf * (1.0 / (1.0 - rate)), 0.0)
    s = x.float() + hf
    _, _, xhat = _ln_stats(s, eps)
    y = (xhat * scale.float() + bias.float()).to(out_dtype)
    return y, s.to(h.dtype)


def reference_dal_bwd(s, dy, scale, *, rate: float, seed: int, site: int,
                      eps: float, keep: Optional[torch.Tensor] = None):
    """Plain twin of the backward: (dh, dx, dscale, dbias) from the saved
    s (h's dtype), the mask regenerated from (seed, site)."""
    _, rstd, xhat = _ln_stats(s.float(), eps)
    dyf = dy.to(s.dtype).float()
    ds = _ln_dx(xhat, dyf, scale.float(), rstd)
    dh = ds
    if rate > 0.0:
        if keep is None:
            keep = keep_mask(tuple(s.shape), rate, seed, site, s.device)
        dh = torch.where(keep, ds * (1.0 / (1.0 - rate)), 0.0)
    return (dh.to(s.dtype), ds.to(s.dtype), *_param_grads(dyf, xhat))


# ---------------------------------------------------------------- kernels


@functools.cache
def _ln_kernels():
    """(library, forward entry, backward entry), built on first use."""
    lib = _build.load("layer_norm")
    fwd = lib.pdt_layer_norm_fwd
    fwd.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_int,
                                            ctypes.c_float, ctypes.c_int,
                                            ctypes.c_int, ctypes.c_void_p]
    fwd.restype = ctypes.c_int
    bwd = lib.pdt_layer_norm_bwd
    bwd.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_int,
                                            ctypes.c_float, ctypes.c_int,
                                            ctypes.c_int, ctypes.c_void_p]
    bwd.restype = ctypes.c_int
    return lib, fwd, bwd


@functools.cache
def _dal_kernels():
    lib = _build.load("dropout_add_layer_norm")
    fwd = lib.pdt_dal_fwd
    fwd.argtypes = [ctypes.c_void_p] * 6 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_uint,
        ctypes.c_uint, ctypes.c_uint, ctypes.c_float, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fwd.restype = ctypes.c_int
    bwd = lib.pdt_dal_bwd
    bwd.argtypes = [ctypes.c_void_p] * 7 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_uint,
        ctypes.c_uint, ctypes.c_uint, ctypes.c_float, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    bwd.restype = ctypes.c_int
    return lib, fwd, bwd


def _check_params(x, h, *params):
    for t in params:
        if t.device != x.device:
            raise ValueError(f"scale/bias on {t.device}, x on {x.device}")
        if t.dtype != torch.float32 or t.shape != (h,) or not t.is_contiguous():
            raise ValueError(
                f"scale/bias must be contiguous float32 [{h}] tensors, got "
                f"{t.dtype} {tuple(t.shape)}"
            )


def _check_rows(what, h, *tensors, dtypes=()):
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError(f"{what} kernel needs contiguous inputs")
    for d in dtypes:
        if d not in _DTYPE_CODES:
            raise ValueError(f"{what} kernel takes float32/bfloat16, got {d}")
    if not 0 < h <= _MAX_H:
        raise ValueError(f"{what} kernel takes 0 < H <= {_MAX_H}, got {h}")


def _layer_norm_cuda(x, scale, bias, eps: float, out_dtype):
    h = x.shape[-1]
    _check_params(x, h, scale, bias)
    _check_rows("layer_norm", h, x, dtypes=(x.dtype, out_dtype))
    y = torch.empty(x.shape, dtype=out_dtype, device=x.device)
    rows = x.numel() // h
    if rows == 0:
        return y
    lib, fn, _ = _ln_kernels()
    code = fn(x.data_ptr(), scale.data_ptr(), bias.data_ptr(), y.data_ptr(),
              rows, h, eps, _DTYPE_CODES[x.dtype], _DTYPE_CODES[out_dtype],
              _build.stream_ptr(x))
    _build.check_launch(lib, "layer_norm", code)
    return y


def _layer_norm_bwd_cuda(x, dy, scale, *, eps: float):
    h = x.shape[-1]
    dy = dy.to(x.dtype).contiguous()
    _check_params(x, h, scale)
    _check_rows("layer_norm_bwd", h, x, dy, dtypes=(x.dtype,))
    rows = x.numel() // h
    dx = torch.empty_like(x)
    if rows == 0:
        zero = torch.zeros(h, dtype=torch.float32, device=x.device)
        return dx, zero, zero.clone()
    blocks = _partial_blocks(rows)
    parts = torch.empty(2, blocks, h, dtype=torch.float32, device=x.device)
    lib, _, fn = _ln_kernels()
    code = fn(x.data_ptr(), dy.data_ptr(), scale.data_ptr(), dx.data_ptr(),
              parts[0].data_ptr(), parts[1].data_ptr(), rows, h, eps,
              _DTYPE_CODES[x.dtype], blocks, _build.stream_ptr(x))
    _build.check_launch(lib, "layer_norm_bwd", code)
    return (dx, *parts.sum(dim=1))  # (dscale, dbias)


def _dropout_args(rate: float, seed: int, site: int):
    if rate > 0.0:
        return (seed, site, mask_threshold(rate), 1.0 / (1.0 - rate), 1)
    return (0, 0, 0, 1.0, 0)


def _dal_fwd_cuda(h, x, scale, bias, *, rate: float, seed: int, site: int,
                  eps: float, out_dtype, save_s: bool):
    hdim = x.shape[-1]
    if h.dtype != x.dtype or h.shape != x.shape:
        raise ValueError(
            f"dropout_add_layer_norm kernel needs h and x of one dtype and "
            f"shape, got {h.dtype} {tuple(h.shape)} and {x.dtype} "
            f"{tuple(x.shape)}"
        )
    _check_params(x, hdim, scale, bias)
    _check_rows("dropout_add_layer_norm", hdim, h, x,
                dtypes=(x.dtype, out_dtype))
    y = torch.empty(x.shape, dtype=out_dtype, device=x.device)
    s = torch.empty_like(h) if save_s else None
    rows = x.numel() // hdim
    if rows == 0:
        return y, s
    lib, fn, _ = _dal_kernels()
    code = fn(h.data_ptr(), x.data_ptr(), scale.data_ptr(), bias.data_ptr(),
              y.data_ptr(), s.data_ptr() if save_s else None, rows, hdim,
              eps, *_dropout_args(rate, seed, site), _DTYPE_CODES[x.dtype],
              _DTYPE_CODES[out_dtype], _build.stream_ptr(x))
    _build.check_launch(lib, "dropout_add_layer_norm", code)
    return y, s


def _dal_bwd_cuda(s, dy, scale, *, rate: float, seed: int, site: int,
                  eps: float):
    hdim = s.shape[-1]
    dy = dy.to(s.dtype).contiguous()
    _check_params(s, hdim, scale)
    _check_rows("dropout_add_layer_norm_bwd", hdim, s, dy, dtypes=(s.dtype,))
    rows = s.numel() // hdim
    dh = torch.empty_like(s)
    dx = torch.empty_like(s)
    if rows == 0:
        zero = torch.zeros(hdim, dtype=torch.float32, device=s.device)
        return dh, dx, zero, zero.clone()
    blocks = _partial_blocks(rows)
    parts = torch.empty(2, blocks, hdim, dtype=torch.float32, device=s.device)
    lib, _, fn = _dal_kernels()
    code = fn(s.data_ptr(), dy.data_ptr(), scale.data_ptr(), dh.data_ptr(),
              dx.data_ptr(), parts[0].data_ptr(), parts[1].data_ptr(), rows,
              hdim, eps, *_dropout_args(rate, seed, site),
              _DTYPE_CODES[s.dtype], blocks, _build.stream_ptr(s))
    _build.check_launch(lib, "dropout_add_layer_norm_bwd", code)
    return (dh, dx, *parts.sum(dim=1))


# --------------------------------------------------------------- autograd


class _LayerNormFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, bias, eps, out_dtype, use_kernel):
        ctx.save_for_backward(x, scale)
        ctx.eps, ctx.use_kernel = eps, use_kernel
        if use_kernel:
            return _layer_norm_cuda(x, scale, bias, eps, out_dtype)
        return reference_layer_norm(x, scale, bias, eps=eps,
                                    out_dtype=out_dtype)

    @staticmethod
    def backward(ctx, dy):
        x, scale = ctx.saved_tensors
        bwd = _layer_norm_bwd_cuda if ctx.use_kernel else reference_layer_norm_bwd
        dx, dscale, dbias = bwd(x, dy, scale, eps=ctx.eps)
        return dx, dscale, dbias, None, None, None


class _DropoutAddLayerNormFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, x, scale, bias, rate, seed, site, eps, out_dtype,
                use_kernel):
        kw = dict(rate=rate, seed=seed, site=site, eps=eps)
        if use_kernel:
            y, s = _dal_fwd_cuda(h, x, scale, bias, out_dtype=out_dtype,
                                 save_s=True, **kw)
        else:
            y, s = reference_dal_fwd(h, x, scale, bias, out_dtype=out_dtype,
                                     **kw)
        ctx.save_for_backward(s, scale)
        ctx.kw, ctx.use_kernel, ctx.x_dtype = kw, use_kernel, x.dtype
        return y

    @staticmethod
    def backward(ctx, dy):
        s, scale = ctx.saved_tensors
        bwd = _dal_bwd_cuda if ctx.use_kernel else reference_dal_bwd
        dh, dx, dscale, dbias = bwd(s, dy, scale, **ctx.kw)
        return (dh, dx.to(ctx.x_dtype), dscale, dbias,
                None, None, None, None, None, None)


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def layer_norm(x, scale, bias, *, eps: float = 1e-12,
               out_dtype: Optional[torch.dtype] = None):
    """LayerNorm over the last axis; fp32 stats; output in ``out_dtype``.

    CPU tensors take the plain versions; CUDA tensors the kernels."""
    out_dtype = out_dtype or x.dtype
    use_kernel = _use_kernel(x, "layer_norm")
    if _needs_grad(x, scale, bias):
        return _LayerNormFn.apply(x, scale, bias, eps, out_dtype, use_kernel)
    if use_kernel:
        return _layer_norm_cuda(x, scale, bias, eps, out_dtype)
    return reference_layer_norm(x, scale, bias, eps=eps, out_dtype=out_dtype)


def _check_rate(rate: float) -> None:
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout rate must be in [0, 1), got {rate}")


def dropout_add_layer_norm(h, x, scale, bias, *, rate: float,
                           seed: Optional[int] = None, site: int = 0,
                           eps: float = 1e-12,
                           out_dtype: Optional[torch.dtype] = None):
    """``LayerNorm(x + Dropout(h))`` over the last axis. ``seed`` None is
    deterministic (rate taken as 0). CPU tensors take the plain versions;
    CUDA tensors the kernels."""
    out_dtype = out_dtype or x.dtype
    _check_rate(rate)
    if seed is None:
        rate, seed = 0.0, 0
    check_seed(seed, site)
    use_kernel = _use_kernel(x, "dropout_add_layer_norm")
    if _needs_grad(h, x, scale, bias):
        return _DropoutAddLayerNormFn.apply(h, x, scale, bias, rate, seed,
                                            site, eps, out_dtype, use_kernel)
    kw = dict(rate=rate, seed=seed, site=site, eps=eps, out_dtype=out_dtype)
    if use_kernel:
        return _dal_fwd_cuda(h, x, scale, bias, save_s=False, **kw)[0]
    return reference_dal_fwd(h, x, scale, bias, **kw)[0]


def reference_dropout_add_layer_norm(h, x, scale, bias, *, rate: float,
                                     seed: int, site: int = 0,
                                     eps: float = 1e-12, out_dtype=None):
    """The plain forward and backward under autograd, on any device: the
    oracle the kernels are held against (s saved in h's dtype, as the
    kernels save it)."""
    _check_rate(rate)
    return _DropoutAddLayerNormFn.apply(h, x, scale, bias, rate, seed, site,
                                        eps, out_dtype or x.dtype, False)


# ---------------------------------------------------------------- modules


class FusedLayerNorm(nn.Module):
    """LayerNorm module with the JAX package's parameter names (``scale``
    ones, ``bias`` zeros), float32 parameters, output in ``out_dtype``."""

    def __init__(self, features: int, *, eps: float, out_dtype: torch.dtype,
                 param_dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.eps = eps
        self.out_dtype = out_dtype
        self.scale = nn.Parameter(
            torch.ones(features, dtype=param_dtype, device=device)
        )
        self.bias = nn.Parameter(
            torch.zeros(features, dtype=param_dtype, device=device)
        )

    def forward(self, x):
        return layer_norm(x, self.scale, self.bias, eps=self.eps,
                          out_dtype=self.out_dtype)


class FusedDropoutAddLayerNorm(FusedLayerNorm):
    """``LayerNorm(x + Dropout(h))`` as one module, the post-LN block tail.
    Parameter names as ``FusedLayerNorm``; ``site`` tells apart the two
    tails of one block, which share the layer's seed."""

    def __init__(self, features: int, *, eps: float, rate: float, site: int,
                 out_dtype: torch.dtype,
                 param_dtype: torch.dtype = torch.float32, device=None):
        super().__init__(features, eps=eps, out_dtype=out_dtype,
                         param_dtype=param_dtype, device=device)
        self.rate = rate
        self.site = site

    def forward(self, h, x, seed: Optional[int] = None):
        return dropout_add_layer_norm(
            h, x, self.scale, self.bias, rate=self.rate, seed=seed,
            site=self.site, eps=self.eps, out_dtype=self.out_dtype,
        )
