"""Dropout with the port's counter-based mask generator (counterpart: the
JAX package's ``ops/dropout.py``, the ``"kernel"`` impl).

The JAX package's ``"kernel"`` dropout draws its keep mask from the TPU's
per-core hardware PRNG inside a Pallas kernel; those bits cannot be
reproduced off the TPU. The port draws them from Philox4x32-10 keyed by
``(seed, site)`` and counted by the flat element index::

    bits(seed, site, i) = philox4x32_10(counter=(i // 4 low 32, i // 4
                                                 high 32, 0, 0),
                                        key=(seed, site))[i % 4]

and keeps element ``i`` when ``bits >= mask_threshold(rate)``, the JAX
package's threshold. The bits are a pure function of ``(seed, site, i)``,
so a forward, its backward and a recomputation (``attention_remat``) see
the same mask, however a kernel launch is shaped. The plain PyTorch
version here computes the same bits on int64 tensors (16-bit limbs for the
32 x 32 -> 64 products), so on the card the kernels (``csrc/dropout.cu``,
``csrc/dropout_add_layer_norm.cu``, sharing ``csrc/philox.cuh``) agree
with it bit for bit.

Seeds are 32-bit Python ints. ``fold_in`` derives one from another and an
integer (the counterpart of ``jax.random.fold_in``): the train step folds
in the step, microbatch and rank, the model folds in the layer.

``raw_dropout`` is one ``torch.autograd.Function``: its forward is ``x *
mask-scale`` and its backward ``dy * mask-scale`` with the mask drawn
again from the same ``(seed, site, rate)``, so no mask is saved. On a CPU
tensor both are the plain ``x * reference_mask_scale(...)``; on a CUDA
tensor both launch the apply mode of ``csrc/dropout.cu`` (built at first
use), one pass that reads x and writes the product, or raise.
``mask_scale``, the TPU kernel's own function, launches its mask-only
mode on a CUDA device and runs ``reference_mask_scale`` on the CPU.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch
from torch import nn

from pytorch_distributed_training_tpu_torch.ops import _build

_M32 = 0xFFFFFFFF
_M64 = (1 << 64) - 1
_PHILOX_M0 = 0xD2511F53
_PHILOX_M1 = 0xCD9E8D57
_PHILOX_W0 = 0x9E3779B9
_PHILOX_W1 = 0xBB67AE85
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def mask_threshold(rate: float) -> int:
    """Drop threshold for raw 32-bit words: P(bits >= t) == 1 - rate (the
    JAX package's ``mask_threshold``, Python's ``round`` included)."""
    return min(round(rate * (1 << 32)), (1 << 32) - 1)


def fold_in(seed: int, data: int) -> int:
    """A new 32-bit seed from ``seed`` and ``data``: splitmix64 of the two
    32-bit words, low 32 bits."""
    z = ((int(seed) & _M32) << 32) | (int(data) & _M32)
    z = (z + 0x9E3779B97F4A7C15) & _M64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _M64
    return (z ^ (z >> 31)) & _M32


def _mulhilo(a: torch.Tensor, m: int):
    """(high, low) 32-bit words of ``a * m`` for int64 ``a`` < 2^32 and a
    32-bit constant ``m``, in 16-bit limbs so no product passes 2^48."""
    p_lo = a * (m & 0xFFFF)
    p_hi = a * (m >> 16)
    mid = p_lo + ((p_hi & 0xFFFF) << 16)
    return (p_hi >> 16) + (mid >> 32), mid & _M32


def philox4x32_10(c0, c1, c2, c3, k0: int, k1: int):
    """Philox4x32-10 (Random123) on int64 tensors of 32-bit counter words
    and a 32-bit key pair; returns the four 32-bit output words."""
    k0 &= _M32
    k1 &= _M32
    for r in range(10):
        if r:
            k0 = (k0 + _PHILOX_W0) & _M32
            k1 = (k1 + _PHILOX_W1) & _M32
        hi0, lo0 = _mulhilo(c0, _PHILOX_M0)
        hi1, lo1 = _mulhilo(c2, _PHILOX_M1)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def philox_bits(n: int, seed: int, site: int, device=None) -> torch.Tensor:
    """``bits(seed, site, i)`` for i in [0, n): int64 [n] of 32-bit words."""
    group = torch.arange((n + 3) // 4, dtype=torch.int64, device=device)
    zero = torch.zeros_like(group)
    words = philox4x32_10(group & _M32, group >> 32, zero, zero, seed, site)
    return torch.stack(words, dim=1).reshape(-1)[:n]


def philox_bits_at(index: torch.Tensor, seed: int, site: int) -> torch.Tensor:
    """``bits(seed, site, i)`` at arbitrary flat indices: int64 ``index``
    (any shape) -> int64 words of the same shape, so a tile's mask can be
    drawn without the words before it."""
    group = index >> 2
    zero = torch.zeros_like(group)
    words = torch.stack(philox4x32_10(group & _M32, group >> 32, zero, zero,
                                      seed, site), dim=-1)
    return torch.gather(words, -1, (index & 3)[..., None])[..., 0]


def keep_mask(shape, rate: float, seed: int, site: int,
              device=None) -> torch.Tensor:
    """Boolean keep mask of ``shape`` over the flat element index."""
    n = math.prod(shape)
    bits = philox_bits(n, seed, site, device)
    return (bits >= mask_threshold(rate)).reshape(shape)


def reference_mask_scale(shape, rate: float, dtype, *, seed: int, site: int,
                         device=None) -> torch.Tensor:
    """Plain twin of the kernel: {0, 1/(1-rate)} in ``dtype``, the value
    rounded to float32 first and the select made in float32, as the TPU
    kernel does."""
    keep = keep_mask(tuple(shape), rate, seed, site, device)
    # filled on the device (no host copy, so it can be graph-captured)
    scale = torch.full((), 1.0 / (1.0 - rate), dtype=torch.float32,
                       device=device)
    return torch.where(keep, scale, torch.zeros((), device=device)).to(dtype)


def check_seed(seed: int, site: int) -> None:
    for name, v in (("seed", seed), ("site", site)):
        if not 0 <= int(v) <= _M32:
            raise ValueError(f"dropout {name} must be a 32-bit unsigned int, "
                             f"got {v}")


@functools.cache
def _kernel():
    """The library of both modes, with its two C entry points typed."""
    lib = _build.load("dropout")
    common = [ctypes.c_longlong, ctypes.c_uint, ctypes.c_uint, ctypes.c_uint,
              ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    lib.pdt_mask_scale.argtypes = [ctypes.c_void_p] + common
    lib.pdt_dropout_apply.argtypes = [ctypes.c_void_p] * 2 + common
    lib.pdt_mask_scale.restype = lib.pdt_dropout_apply.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _scale_in(dtype, rate: float) -> float:
    """The mask-scale's kept value in ``dtype``: 1/(1-rate) rounded to
    float32, then to ``dtype`` (bf16 1.109375 at rate 0.1), as
    ``reference_mask_scale`` rounds it."""
    return torch.tensor(1.0 / (1.0 - rate), dtype=torch.float32).to(
        dtype).item()


def _check_dtype(dtype, what):
    if dtype not in _DTYPE_CODES:
        raise ValueError(f"{what} kernel takes float32/bfloat16, got {dtype}")


def _mask_scale_cuda(shape, rate, dtype, seed, site, device):
    _check_dtype(dtype, "mask_scale")
    out = torch.empty(shape, dtype=dtype, device=device)
    n = out.numel()
    if n == 0:
        return out
    lib = _kernel()
    code = lib.pdt_mask_scale(
        out.data_ptr(), n, seed, site, mask_threshold(rate),
        _scale_in(dtype, rate), _DTYPE_CODES[dtype], _build.stream_ptr(out))
    _build.check_launch(lib, "mask_scale", code)
    return out


def _apply_cuda(x, rate, seed, site):
    """``x * mask-scale`` in one pass of the apply mode."""
    _check_dtype(x.dtype, "dropout apply")
    if not x.is_contiguous():
        raise ValueError(f"dropout apply kernel takes a contiguous x, got "
                         f"strides {x.stride()} for shape {tuple(x.shape)}")
    y = torch.empty_like(x)
    n = x.numel()
    if n == 0:
        return y
    lib = _kernel()
    code = lib.pdt_dropout_apply(
        x.data_ptr(), y.data_ptr(), n, seed, site, mask_threshold(rate),
        _scale_in(x.dtype, rate), _DTYPE_CODES[x.dtype], _build.stream_ptr(x))
    _build.check_launch(lib, "mask_scale_apply", code)
    return y


def _device_type(device) -> str:
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"dropout runs on cpu or cuda, got {device}")
    return device.type


def mask_scale(shape, rate: float, dtype, *, seed: int, site: int = 0,
               device=None) -> torch.Tensor:
    """[shape] tensor of 0 / 1/(1-rate) in ``dtype`` for 0 < rate < 1.

    On the CPU the plain version; on a CUDA device the kernel's mask-only
    mode."""
    if not 0.0 < rate < 1.0:
        raise ValueError(f"mask_scale needs 0 < rate < 1, got {rate}")
    check_seed(seed, site)
    device = torch.device(device if device is not None else "cpu")
    shape = tuple(shape)
    if _device_type(device) == "cpu":
        return reference_mask_scale(shape, rate, dtype, seed=seed, site=site,
                                    device=device)
    return _mask_scale_cuda(shape, rate, dtype, seed, site, device)


def apply_mask(x: torch.Tensor, rate: float, seed: int,
               site: int) -> torch.Tensor:
    """``x * mask_scale(x.shape, rate, x.dtype, ...)`` for 0 < rate < 1:
    the plain product on the CPU, one pass of the kernel's apply mode on a
    CUDA device (float32 or bf16, contiguous)."""
    if _device_type(x.device) == "cpu":
        return x * reference_mask_scale(x.shape, rate, x.dtype, seed=seed,
                                        site=site, device=x.device)
    return _apply_cuda(x, rate, seed, site)


class _RawDropout(torch.autograd.Function):
    """``x * mask-scale``; the backward is ``dy * mask-scale`` with the mask
    drawn again from the same ``(rate, seed, site)``: nothing is saved."""

    @staticmethod
    def forward(ctx, x, rate, seed, site):
        ctx.mask = (rate, seed, site)
        return apply_mask(x, rate, seed, site)

    @staticmethod
    def backward(ctx, dy):
        # dy may arrive strided (an einsum's backward); the kernel takes it
        # contiguous
        return _RawDropout.apply(dy.contiguous(), *ctx.mask), None, None, None


def raw_dropout(x: torch.Tensor, rate: float, seed: int,
                site: int = 0) -> torch.Tensor:
    """Inverted dropout (train mode) of ``x``: ``x * mask_scale``, as the
    JAX package's ``"kernel"`` impl, in one pass each way (``_RawDropout``).
    A non-finite ``x`` stays non-finite where it is dropped (NaN * 0), as
    there."""
    if rate <= 0.0:
        return x
    if rate >= 1.0:  # everything dropped, no infinite scale
        return torch.zeros_like(x)
    check_seed(seed, site)
    return _RawDropout.apply(x, rate, seed, site)


class Dropout(nn.Module):
    """Dropout with the port's generator. ``forward(x, seed, site)``: the
    identity when ``seed`` is None (deterministic) or ``rate`` is 0."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor, seed: Optional[int] = None,
                site: int = 0) -> torch.Tensor:
        if seed is None or self.rate <= 0.0:
            return x
        return raw_dropout(x, self.rate, seed, site)
