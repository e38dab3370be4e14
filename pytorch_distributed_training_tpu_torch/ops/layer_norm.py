"""LayerNorm forward: the Hopper kernel and its plain version (counterpart:
the JAX package's ``ops/layer_norm.py`` ``layer_norm`` /
``reference_layer_norm`` / ``FusedLayerNorm``, forward only).

Contract, as in the JAX package: normalization over the last axis with
float32 statistics whatever the input dtype, biased variance, eps inside
the rsqrt, float32 scale/bias, output cast to ``out_dtype`` (the models
cast the LayerNorm output straight to the compute dtype, so the kernel
emits it directly).

``layer_norm`` on a CPU tensor runs ``reference_layer_norm``; on a CUDA
tensor it launches ``csrc/layer_norm.cu`` (built at first use) or raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch
from torch import nn

from pytorch_distributed_training_tpu_torch.ops import _build

_MAX_H = 2048  # 64 float registers per lane in the one-warp-per-row kernel
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def reference_layer_norm(x, scale, bias, *, eps: float, out_dtype=None):
    """Plain twin of the kernel: fp32 stats, biased variance, cast at the end."""
    out_dtype = out_dtype or x.dtype
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    c = xf - mean
    var = (c * c).mean(dim=-1, keepdim=True)
    y = c * torch.rsqrt(var + eps)
    y = y * scale.float() + bias.float()
    return y.to(out_dtype)


@functools.cache
def _kernel():
    """(library, C entry point) of the LayerNorm kernel, built on first use."""
    lib = _build.load("layer_norm")
    fn = lib.pdt_layer_norm_fwd
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_int,
                                           ctypes.c_float, ctypes.c_int,
                                           ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


def _layer_norm_cuda(x, scale, bias, eps: float, out_dtype):
    h = x.shape[-1]
    for name, t in (("scale", scale), ("bias", bias)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if t.dtype != torch.float32 or t.shape != (h,) or not t.is_contiguous():
            raise ValueError(
                f"{name} must be a contiguous float32 [{h}] tensor, got "
                f"{t.dtype} {tuple(t.shape)}"
            )
    if x.dtype not in _DTYPE_CODES or out_dtype not in _DTYPE_CODES:
        raise ValueError(
            f"layer_norm kernel takes float32/bfloat16 in and out, got "
            f"{x.dtype} -> {out_dtype}"
        )
    if not x.is_contiguous():
        raise ValueError("layer_norm kernel needs a contiguous x")
    if not 0 < h <= _MAX_H:
        raise ValueError(f"layer_norm kernel takes 0 < H <= {_MAX_H}, got {h}")
    y = torch.empty(x.shape, dtype=out_dtype, device=x.device)
    rows = x.numel() // h
    if rows == 0:
        return y
    lib, fn = _kernel()
    code = fn(x.data_ptr(), scale.data_ptr(), bias.data_ptr(), y.data_ptr(),
              rows, h, eps, _DTYPE_CODES[x.dtype], _DTYPE_CODES[out_dtype],
              _build.stream_ptr(x))
    _build.check_launch(lib, "layer_norm", code)
    return y


def layer_norm(x, scale, bias, *, eps: float = 1e-12,
               out_dtype: Optional[torch.dtype] = None):
    """LayerNorm over the last axis; fp32 stats; output in ``out_dtype``.

    CPU tensors take the plain version; CUDA tensors the kernel."""
    out_dtype = out_dtype or x.dtype
    if x.device.type == "cpu":
        return reference_layer_norm(x, scale, bias, eps=eps,
                                    out_dtype=out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"layer_norm runs on cpu or cuda, got {x.device}")
    return _layer_norm_cuda(x, scale, bias, eps, out_dtype)


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
