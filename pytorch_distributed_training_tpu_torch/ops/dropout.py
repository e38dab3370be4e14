"""Dropout with the port's counter-based mask generator (counterpart: the
JAX package's ``ops/dropout.py``, its four impls).

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

The mask streams (``impl``, ``ModelConfig.dropout_impl``; JAX
``raw_dropout``), each drawn from the same Philox words, so each a pure
function of ``(seed, site, flat index)`` that a backward or a recompute
draws again:

- ``"kernel"`` and ``"bits32"``: the mask above (JAX's ``"kernel"`` falls
  back to ``bits32``'s mask-scale form off the TPU); the same kernel mode.
  They differ only in the dropout-add-LayerNorm tail, which fuses the
  mask (kernels 3 and 4) under ``"kernel"`` alone (``ops/layer_norm.py``).
- ``"bits8"``: element i keeps when byte ``i % 4`` (little endian) of word
  ``i // 4`` is ``>= t``, ``t = min(max(round(rate * 256), 1), 255)``,
  scaled by ``1/(1 - t/256)``, the rate actually applied (``bits8_rate``).
  JAX draws uint8 words of its own when the last axis is no multiple of
  4; here every shape takes the one formula (a stream difference).
- ``"exact"``: ``u = bitcast_f32((word >> 9) | 0x3F800000) - 1`` (JAX's
  uniform) kept when ``u < 1 - rate``; the output is ``where(keep, x /
  (1 - rate), 0)``.

IEEE contract, as in JAX: ``"exact"`` is a select, so a NaN at a dropped
position becomes 0; the others multiply, so it stays NaN. At rate <= 0
every stream is the identity, at rate >= 1 all zeros. On a CUDA tensor
``"bits8"`` and ``"exact"`` launch kernel 5's bits8 and exact modes; no
stream calls ``torch.rand``, ``torch.bernoulli`` or ``F.dropout``, whose
stateful generators a recompute cannot replay.
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

DROPOUT_IMPLS = ("exact", "bits32", "bits8", "kernel")
# the kernel mode each stream launches, counted under these names
STREAM_KERNELS = {"kernel": "mask_scale_apply", "bits32": "mask_scale_apply",
                   "bits8": "dropout_bits8", "exact": "dropout_exact"}


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


def bits8_threshold(rate: float) -> int:
    """bits8's byte threshold (JAX ``raw_dropout``): P(byte >= t) = 1 -
    t/256."""
    return min(max(round(rate * 256), 1), 255)


def bits8_rate(rate: float) -> float:
    """The drop rate bits8 applies (1/256 granularity)."""
    return bits8_threshold(rate) / 256.0


def _in_dtype(value: float, dtype) -> float:
    """``value`` rounded once into ``dtype``, as JAX casts a Python float
    (its scale and its divisor) to x's dtype."""
    return torch.tensor(value, dtype=torch.float64).to(dtype).item()


def bits8_keep(shape, rate: float, seed: int, site: int,
               device=None) -> torch.Tensor:
    """bits8's keep mask: byte ``i % 4`` of word ``i // 4`` >= t."""
    n = math.prod(shape)
    words = philox_bits((n + 3) // 4, seed, site, device)
    shifts = torch.arange(0, 32, 8, dtype=torch.int64, device=device)
    bytes_ = ((words[:, None] >> shifts) & 0xFF).reshape(-1)[:n]
    return (bytes_ >= bits8_threshold(rate)).reshape(shape)


def exact_keep(shape, rate: float, seed: int, site: int,
               device=None) -> torch.Tensor:
    """exact's keep mask: JAX's float32 uniform of each word < 1 - rate."""
    words = philox_bits(math.prod(shape), seed, site, device)
    u = ((words >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    # filled on the device (no host copy, so it can be graph-captured)
    keep = torch.full((), 1.0 - rate, dtype=torch.float32, device=device)
    return (u < keep).reshape(shape)


def reference_dropout(x: torch.Tensor, rate: float, seed: int, site: int,
                      impl: str = "kernel") -> torch.Tensor:
    """Plain twin of the stream ``impl`` for 0 < rate < 1 (the kernel's
    arithmetic: a multiply in float32 rounded once, or exact's quotient
    rounded once, selected)."""
    shape, dev = tuple(x.shape), x.device
    if impl in ("kernel", "bits32"):
        return x * reference_mask_scale(shape, rate, x.dtype, seed=seed,
                                        site=site, device=dev)
    if impl == "bits8":
        scale = torch.full((), _in_dtype(1.0 / (1.0 - bits8_rate(rate)),
                                         x.dtype), dtype=x.dtype, device=dev)
        keep = bits8_keep(shape, rate, seed, site, dev)
        return x * torch.where(keep, scale, torch.zeros((), dtype=x.dtype,
                                                        device=dev))
    if impl == "exact":
        div = torch.full((), _in_dtype(1.0 - rate, x.dtype),
                         dtype=torch.float32, device=dev)
        keep = exact_keep(shape, rate, seed, site, dev)
        return torch.where(keep, (x.float() / div).to(x.dtype),
                           torch.zeros((), dtype=x.dtype, device=dev))
    raise ValueError(f"unknown dropout impl {impl!r}; have {DROPOUT_IMPLS}")


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
    lib.pdt_dropout_bits8.argtypes = [ctypes.c_void_p] * 2 + common
    lib.pdt_dropout_exact.argtypes = [ctypes.c_void_p] * 2 + [
        ctypes.c_longlong, ctypes.c_uint, ctypes.c_uint, ctypes.c_float,
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    for fn in (lib.pdt_mask_scale, lib.pdt_dropout_apply,
               lib.pdt_dropout_bits8, lib.pdt_dropout_exact):
        fn.restype = ctypes.c_int
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


def _apply_cuda(x, rate, seed, site, impl="kernel"):
    """The stream ``impl`` on ``x`` in one pass of its kernel mode: ``x *
    mask-scale`` (apply, bits8) or exact's select."""
    _check_dtype(x.dtype, "dropout apply")
    if not x.is_contiguous():
        raise ValueError(f"dropout apply kernel takes a contiguous x, got "
                         f"strides {x.stride()} for shape {tuple(x.shape)}")
    y = torch.empty_like(x)
    n = x.numel()
    if n == 0:
        return y
    lib = _kernel()
    io = (x.data_ptr(), y.data_ptr(), n, seed, site)
    tail = (_DTYPE_CODES[x.dtype], _build.stream_ptr(x))
    if impl in ("kernel", "bits32"):
        code = lib.pdt_dropout_apply(*io, mask_threshold(rate),
                                     _scale_in(x.dtype, rate), *tail)
    elif impl == "bits8":
        code = lib.pdt_dropout_bits8(
            *io, bits8_threshold(rate),
            _in_dtype(1.0 / (1.0 - bits8_rate(rate)), x.dtype), *tail)
    elif impl == "exact":
        keep = torch.tensor(1.0 - rate, dtype=torch.float32).item()
        code = lib.pdt_dropout_exact(*io, keep, _in_dtype(1.0 - rate, x.dtype),
                                     *tail)
    else:
        raise ValueError(f"unknown dropout impl {impl!r}; have "
                         f"{DROPOUT_IMPLS}")
    _build.check_launch(lib, STREAM_KERNELS[impl], code)
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
    """``x * mask_scale(x.shape, rate, x.dtype, ...)`` for 0 < rate < 1
    (the ``"kernel"`` and ``"bits32"`` streams): the plain product on the
    CPU, one pass of the kernel's apply mode on a CUDA device (float32 or
    bf16, contiguous)."""
    if _device_type(x.device) == "cpu":
        return x * reference_mask_scale(x.shape, rate, x.dtype, seed=seed,
                                        site=site, device=x.device)
    return _apply_cuda(x, rate, seed, site)


def apply_stream(x: torch.Tensor, rate: float, seed: int, site: int,
                 impl: str = "kernel") -> torch.Tensor:
    """The stream ``impl`` on ``x`` for 0 < rate < 1: ``apply_mask`` under
    ``"kernel"``/``"bits32"``; bits8 and exact as their plain versions on
    the CPU, one pass of their kernel modes on a CUDA device."""
    if impl in ("kernel", "bits32"):
        return apply_mask(x, rate, seed, site)
    if _device_type(x.device) == "cpu":
        return reference_dropout(x, rate, seed, site, impl)
    return _apply_cuda(x, rate, seed, site, impl)


class _RawDropout(torch.autograd.Function):
    """The stream on x; the backward is the same stream on dy (``dy *
    mask-scale``, or exact's ``where(keep, dy / (1 - rate), 0)``), the mask
    drawn again from the same ``(rate, seed, site)``: nothing is saved."""

    @staticmethod
    def forward(ctx, x, rate, seed, site, impl):
        ctx.mask = (rate, seed, site, impl)
        return apply_stream(x, rate, seed, site, impl)

    @staticmethod
    def backward(ctx, dy):
        # dy may arrive strided (an einsum's backward); the kernel takes it
        # contiguous
        return (_RawDropout.apply(dy.contiguous(), *ctx.mask),
                None, None, None, None)


def raw_dropout(x: torch.Tensor, rate: float, seed: int, site: int = 0,
                impl: str = "kernel") -> torch.Tensor:
    """Inverted dropout (train mode) of ``x`` in the stream ``impl``, in
    one pass each way (``_RawDropout``). Under every stream but
    ``"exact"`` a non-finite ``x`` stays non-finite where it is dropped
    (NaN * 0), as in JAX."""
    if impl not in DROPOUT_IMPLS:
        raise ValueError(f"unknown dropout impl {impl!r}; have "
                         f"{DROPOUT_IMPLS}")
    if rate <= 0.0:
        return x
    if rate >= 1.0:  # everything dropped, no infinite scale
        return torch.zeros_like(x)
    check_seed(seed, site)
    return _RawDropout.apply(x, rate, seed, site, impl)


class Dropout(nn.Module):
    """Dropout with the port's generator in the stream ``impl``.
    ``forward(x, seed, site)``: the identity when ``seed`` is None
    (deterministic) or ``rate`` is 0."""

    def __init__(self, rate: float, impl: str = "kernel"):
        super().__init__()
        self.rate = rate
        self.impl = impl

    def forward(self, x: torch.Tensor, seed: Optional[int] = None,
                site: int = 0) -> torch.Tensor:
        if seed is None or self.rate <= 0.0:
            return x
        return raw_dropout(x, self.rate, seed, site, self.impl)
