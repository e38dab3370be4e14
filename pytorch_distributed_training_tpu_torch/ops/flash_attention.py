"""Flash attention (counterpart: the JAX package's ``ops/flash_attention.py``).

Four kernels (``csrc/flash_attention.cu``), each with its plain PyTorch
version here:

- ``flash_fwd``: the blockwise forward (TPU ``_fwd_kernel``): online
  softmax, causal k-tile skip, probability dropout in the kernel, O and
  the float32 log-sum-exp ``lse`` [B, N, Sq];
- ``flash_bwd``: the fused one-pass backward (TPU ``_dqkv_kernel``, the
  JAX package's default): dq, dk and dv from one recompute of the probs
  from ``lse``; delta = rowsum(dO * O) is formed in the kernel;
- ``flash_whole_fwd`` / ``flash_whole_bwd``: the whole-sequence pair (TPU
  ``_mh_fwd_kernel`` / ``_mh_bwd_kernel``): the softmax of a full row, no
  residual saved; the backward recomputes the row statistics itself.

Arithmetic (the plain versions mirror it): q is scaled in float32 and
rounded to the k dtype before Q K^T; scores, statistics and accumulators
are float32; the causal fill is -1e30 and the normaliser is floored at
1e-30, so a fully masked row gives zeros; p is rounded to the V dtype
before P V; dP = dO V^T in float32; dq = (round(dS) K) * scale; the
blockwise dk = dS^T (q * scale) in float32, the whole-sequence dk =
(round(dS)^T q) * scale, as the two TPU kernels differ.

Dropout: the TPU kernels key their hardware PRNG by block coordinates, so
their masks depend on the block size and cannot be reproduced off the TPU.
Here element (b, n, q, k) of the probs is kept when ``bits(seed, site,
((b N + n) Sq + q) Sk + k) >= mask_threshold(rate)`` (``ops/dropout.py``):
the index ``reference_attention`` uses for its probs, so the mask does not
depend on tiling, both kernel pairs draw the same mask, and flash equals
the plain attention with dropout up to the scale's rounding. Only the p
that meets V (and dP) is dropped, scaled by 1/(1-rate) in float32; the
normaliser sums the undropped p.

``flash_attention_base`` (differentiable, [B, N, S, D]) picks the
whole-sequence pair when ``q_len == kv_len == block <= 256``, as the JAX
``_whole_seq`` does; ``block_q``/``block_k`` only route and are checked to
divide the lengths (the kernels tile at 64 whatever the block). The
adapter ``flash_attention`` ([B, S, N, D]) keeps the JAX adapter's
dispatch: ``pick_block`` with a cap of 512, and the plain
``reference_attention`` when the bias is not [B, 1, 1, S], a length does
not divide its block, or ``head_dim > 256``. The kernels take head_dim 16,
32 and 64 in float32 or bfloat16; another shape on a CUDA tensor raises.
The JAX package's two-pass backward (``PDT_FLASH_TWO_PASS=1``) is not
ported: with that variable set, the adapter raises.

Each wrapper runs its plain version on a CPU tensor and its kernel (built
at first use) on a CUDA tensor, or raises.
"""

from __future__ import annotations

import ctypes
import functools
import os
from typing import Optional

import torch

from pytorch_distributed_training_tpu_torch.ops import _build
from pytorch_distributed_training_tpu_torch.ops.attention import (
    reference_attention,
)
from pytorch_distributed_training_tpu_torch.ops.dropout import (
    check_seed,
    mask_threshold,
    philox_bits_at,
)

DEFAULT_BLOCK_Q = 512
DEFAULT_BLOCK_K = 512
_WHOLE_SEQ_MAX = 256
_NEG_INF = -1e30          # the causal fill, and the row max's floor
_L_FLOOR = 1e-30          # the normaliser's floor
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_KERNEL_HEAD_DIMS = (16, 32, 64)
_TILE = 64                # the kernels' q-rows and keys per tile


# ------------------------------------------------------- plain versions


def probs_keep(shape, rate: float, seed: int, site: int,
               device=None) -> torch.Tensor:
    """Boolean keep mask of the [B, N, Sq, Sk] probs at their flat index."""
    b, n, sq, sk = shape
    ar = functools.partial(torch.arange, dtype=torch.int64, device=device)
    bn = (ar(b)[:, None] * n + ar(n)[None, :])[:, :, None, None]
    index = (bn * sq + ar(sq)[:, None]) * sk + ar(sk)[None, :]
    return philox_bits_at(index, seed, site) >= mask_threshold(rate)


def _scores(q, k, bias, causal):
    """float32 scores: round(q * scale) k^T + bias + the causal fill."""
    scale = q.shape[-1] ** -0.5
    qs = (q.float() * scale).to(k.dtype).float()
    s = torch.matmul(qs, k.float().transpose(-1, -2)) + bias.float()
    if causal:
        sq, sk = s.shape[-2:]
        i = torch.arange(sq, device=s.device)[:, None]
        j = torch.arange(sk, device=s.device)[None, :]
        s = s + torch.where(j <= i, 0.0, _NEG_INF)
    return s


def _dropper(shape, rate, seed, site, device):
    """x -> x kept / (1 - rate) or 0, in float32 (identity at rate 0)."""
    if rate <= 0.0:
        return lambda x: x
    keep = probs_keep(shape, rate, seed, site, device)
    keep_prob = torch.full((), 1.0 - rate, dtype=torch.float32, device=device)
    zero = torch.zeros((), device=device)
    return lambda x: torch.where(keep, x / keep_prob, zero)


def _delta(o, do):
    return (do.float() * o.float()).sum(-1, keepdim=True)


def reference_flash_fwd(q, k, v, bias, *, causal: bool, rate: float = 0.0,
                        seed: int = 0, site: int = 0):
    """Plain twin of ``flash_fwd``: (o [B, N, Sq, D] in q's dtype, lse
    [B, N, Sq] float32)."""
    s = _scores(q, k, bias, causal)
    m = s.amax(-1, keepdim=True).clamp_min(_NEG_INF)
    p = torch.exp(s - m)
    l_safe = p.sum(-1, keepdim=True).clamp_min(_L_FLOOR)
    pd = _dropper(s.shape, rate, seed, site, q.device)(p)
    o = torch.matmul(pd.to(v.dtype).float(), v.float()) / l_safe
    return o.to(q.dtype), (m + torch.log(l_safe))[..., 0]


def reference_flash_bwd(q, k, v, bias, o, lse, do, *, causal: bool,
                        rate: float = 0.0, seed: int = 0, site: int = 0):
    """Plain twin of ``flash_bwd``: (dq, dk, dv) from the saved lse."""
    scale = q.shape[-1] ** -0.5
    s = _scores(q, k, bias, causal)
    p = torch.exp(s - lse[..., None])
    drop = _dropper(s.shape, rate, seed, site, q.device)
    dof = do.float()
    dp = drop(torch.matmul(dof, v.float().transpose(-1, -2)))
    ds = p * (dp - _delta(o, do))
    dv = torch.matmul(drop(p).transpose(-1, -2), dof)
    dk = torch.matmul(ds.transpose(-1, -2), q.float() * scale)
    dq = torch.matmul(ds.to(k.dtype).float(), k.float()) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _whole_probs(q, k, bias, causal):
    """The whole-sequence softmax (TPU ``_mh_softmax``)."""
    s = _scores(q, k, bias, causal)
    m = s.amax(-1, keepdim=True).clamp_min(_NEG_INF)
    p = torch.exp(s - m)
    return p / p.sum(-1, keepdim=True).clamp_min(_L_FLOOR)


def reference_whole_fwd(q, k, v, bias, *, causal: bool, rate: float = 0.0,
                        seed: int = 0, site: int = 0):
    """Plain twin of ``flash_whole_fwd``: o [B, N, Sq, D] in q's dtype."""
    p = _whole_probs(q, k, bias, causal)
    pd = _dropper(p.shape, rate, seed, site, q.device)(p)
    return torch.matmul(pd.to(v.dtype).float(), v.float()).to(q.dtype)


def reference_whole_bwd(q, k, v, bias, o, do, *, causal: bool,
                        rate: float = 0.0, seed: int = 0, site: int = 0):
    """Plain twin of ``flash_whole_bwd``: (dq, dk, dv), the probs and delta
    recomputed."""
    scale = q.shape[-1] ** -0.5
    p = _whole_probs(q, k, bias, causal)
    drop = _dropper(p.shape, rate, seed, site, q.device)
    dof = do.float()
    dp = drop(torch.matmul(dof, v.float().transpose(-1, -2)))
    ds = p * (dp - _delta(o, do))
    dv = torch.matmul(drop(p).transpose(-1, -2), dof)
    dq = torch.matmul(ds.to(k.dtype).float(), k.float()) * scale
    dk = torch.matmul(ds.to(q.dtype).float().transpose(-1, -2),
                      q.float()) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# ---------------------------------------------------------------- kernels

_COMMON_ARGTYPES = (
    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 6
    + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_uint,
       ctypes.c_uint, ctypes.c_uint, ctypes.c_float, ctypes.c_int]
)
# entry point -> the pointers it takes after the common arguments (the
# stream last)
_ENTRY_POINTERS = {
    "pdt_flash_fwd": 3,        # o, lse, stream
    "pdt_flash_whole_fwd": 2,  # o, stream
    "pdt_flash_bwd": 8,        # o, do, lse, dq, dk, dv, dq_part, stream
    "pdt_flash_whole_bwd": 7,  # o, do, dq, dk, dv, dq_part, stream
}


@functools.cache
def _kernel(entry: str):
    """(library, C entry point), built on first use."""
    lib = _build.load("flash_attention")
    fn = getattr(lib, entry)
    fn.argtypes = _COMMON_ARGTYPES + [ctypes.c_void_p] * _ENTRY_POINTERS[entry]
    fn.restype = ctypes.c_int
    return lib, fn


def _dense(t: torch.Tensor) -> torch.Tensor:
    """``t`` if it is [B, N, S, D] contiguous or the [B, N, S, D] view of a
    contiguous [B, S, N, D] tensor (the layouts the kernels read by
    strides), else a contiguous copy."""
    if t.is_contiguous() or t.transpose(1, 2).is_contiguous():
        return t
    return t.contiguous()


def _like(t: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """``t`` in ``ref``'s strides (a copy only when they differ)."""
    if t.stride() == ref.stride():
        return t
    return _empty_like(ref, t.dtype).copy_(t)


def _empty_like(ref: torch.Tensor, dtype=None) -> torch.Tensor:
    return torch.empty_strided(ref.shape, ref.stride(),
                               dtype=dtype or ref.dtype, device=ref.device)


def _check(name, q, k, v, bias):
    for what, t in (("k", k), ("v", v), ("bias", bias)):
        if t.device != q.device:
            raise ValueError(f"{name}: {what} is on {t.device}, q on "
                             f"{q.device}")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"{name} takes q, k, v of [B, N, S, D] with v "
                         f"shaped as k; got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, n, _, d = q.shape
    if k.shape[0] != b or k.shape[1] != n or k.shape[3] != d:
        raise ValueError(f"{name}: q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)} differ in batch, heads or "
                         f"head_dim")
    if bias.shape != (b, 1, 1, k.shape[2]) or bias.dtype != torch.float32:
        raise ValueError(f"{name} takes a float32 key-padding bias [B, 1, 1, "
                         f"Sk]; got {bias.dtype} {tuple(bias.shape)}")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cpu or cuda, got {q.device}")


def _cuda_common(name, q, k, v, bias, causal, rate, seed, site):
    """Kernel-side checks; (q, k, v, the common C arguments)."""
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPE_CODES:
        raise ValueError(f"{name} kernel takes q, k, v of one dtype, float32 "
                         f"or bfloat16; got {q.dtype}, {k.dtype}, {v.dtype}")
    b, n, sq, d = q.shape
    sk = k.shape[2]
    if d not in _KERNEL_HEAD_DIMS:
        raise ValueError(f"{name} kernel takes head_dim in "
                         f"{_KERNEL_HEAD_DIMS}, got {d}")
    if min(b, n, sq, sk) == 0:
        raise ValueError(f"{name} kernel got an empty input {tuple(q.shape)}")
    q, k = _dense(q), _dense(k)
    v = _like(v, k)
    if not bias.is_contiguous():
        raise ValueError(f"{name} kernel needs a contiguous bias")
    check_seed(seed, site)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
            b, n, sq, sk, d, *q.stride()[:3], *k.stride()[:3],
            d ** -0.5, int(causal), int(rate > 0.0), seed, site,
            mask_threshold(rate) if rate > 0.0 else 0, 1.0 - rate,
            _DTYPE_CODES[q.dtype])
    return q, k, v, args


def _launch(kernel_name, entry, anchor, args, *pointers):
    lib, fn = _kernel(entry)
    code = fn(*args, *pointers, _build.stream_ptr(anchor))
    _build.check_launch(lib, kernel_name, code)


def _dq_scratch(q, k):
    b, n, sq, d = q.shape
    tiles = -(-k.shape[2] // _TILE)
    return torch.empty((b, n, tiles, sq, d), dtype=torch.float32,
                       device=q.device)


def _on_cpu(name, q, k, v, bias, rate) -> bool:
    """Check the inputs; True when they lie on the CPU (the plain version
    runs), False on a CUDA device (the kernel runs)."""
    _check(name, q, k, v, bias)
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"{name} needs 0 <= rate < 1, got {rate}")
    return q.device.type == "cpu"


def flash_fwd(q, k, v, bias, *, causal: bool, rate: float = 0.0,
              seed: int = 0, site: int = 0):
    """Blockwise forward: (o, lse). Plain version on the CPU, kernel on a
    CUDA device."""
    kw = dict(causal=causal, rate=rate, seed=seed, site=site)
    if _on_cpu("flash_fwd", q, k, v, bias, rate):
        return reference_flash_fwd(q, k, v, bias, **kw)
    q, k, v, args = _cuda_common("flash_fwd", q, k, v, bias, **kw)
    o = _empty_like(q)
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    _launch("flash_fwd", "pdt_flash_fwd", q, args, o.data_ptr(),
            lse.data_ptr())
    return o, lse


def flash_bwd(q, k, v, bias, o, lse, do, *, causal: bool, rate: float = 0.0,
              seed: int = 0, site: int = 0):
    """Fused blockwise backward: (dq, dk, dv)."""
    kw = dict(causal=causal, rate=rate, seed=seed, site=site)
    if _on_cpu("flash_bwd", q, k, v, bias, rate):
        return reference_flash_bwd(q, k, v, bias, o, lse, do, **kw)
    q, k, v, args = _cuda_common("flash_bwd", q, k, v, bias, **kw)
    o, do = _like(o, q), _like(do.to(q.dtype), q)
    lse = lse.contiguous()
    if lse.shape != q.shape[:3] or lse.dtype != torch.float32:
        raise ValueError(f"flash_bwd takes a float32 lse [B, N, Sq], got "
                         f"{lse.dtype} {tuple(lse.shape)}")
    dq, dk, dv = _empty_like(q), _empty_like(k), _empty_like(k)
    _launch("flash_bwd", "pdt_flash_bwd", q, args, o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), _dq_scratch(q, k).data_ptr())
    return dq, dk, dv


def flash_whole_fwd(q, k, v, bias, *, causal: bool, rate: float = 0.0,
                    seed: int = 0, site: int = 0):
    """Whole-sequence forward: o."""
    kw = dict(causal=causal, rate=rate, seed=seed, site=site)
    if _on_cpu("flash_whole_fwd", q, k, v, bias, rate):
        return reference_whole_fwd(q, k, v, bias, **kw)
    q, k, v, args = _cuda_common("flash_whole_fwd", q, k, v, bias, **kw)
    o = _empty_like(q)
    _launch("flash_whole_fwd", "pdt_flash_whole_fwd", q, args, o.data_ptr())
    return o


def flash_whole_bwd(q, k, v, bias, o, do, *, causal: bool, rate: float = 0.0,
                    seed: int = 0, site: int = 0):
    """Whole-sequence backward: (dq, dk, dv)."""
    kw = dict(causal=causal, rate=rate, seed=seed, site=site)
    if _on_cpu("flash_whole_bwd", q, k, v, bias, rate):
        return reference_whole_bwd(q, k, v, bias, o, do, **kw)
    q, k, v, args = _cuda_common("flash_whole_bwd", q, k, v, bias, **kw)
    o, do = _like(o, q), _like(do.to(q.dtype), q)
    dq, dk, dv = _empty_like(q), _empty_like(k), _empty_like(k)
    _launch("flash_whole_bwd", "pdt_flash_whole_bwd", q, args, o.data_ptr(),
            do.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            _dq_scratch(q, k).data_ptr())
    return dq, dk, dv


# --------------------------------------------------------------- autograd


class _FlashBlockwise(torch.autograd.Function):
    """Kernel 6 forward, kernel 9 backward; saves o and lse."""

    @staticmethod
    def forward(ctx, q, k, v, bias, causal, rate, seed, site):
        ctx.opts = dict(causal=causal, rate=rate, seed=seed, site=site)
        o, lse = flash_fwd(q, k, v, bias, **ctx.opts)
        ctx.save_for_backward(q, k, v, bias, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, bias, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_bwd(q, k, v, bias, o, lse, do, **ctx.opts)
        return dq, dk, dv, None, None, None, None, None


class _FlashWhole(torch.autograd.Function):
    """Kernel 7 forward, kernel 8 backward; saves o only."""

    @staticmethod
    def forward(ctx, q, k, v, bias, causal, rate, seed, site):
        ctx.opts = dict(causal=causal, rate=rate, seed=seed, site=site)
        o = flash_whole_fwd(q, k, v, bias, **ctx.opts)
        ctx.save_for_backward(q, k, v, bias, o)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, bias, o = ctx.saved_tensors
        dq, dk, dv = flash_whole_bwd(q, k, v, bias, o, do, **ctx.opts)
        return dq, dk, dv, None, None, None, None, None


def whole_seq(q_len: int, kv_len: int, block_q: int, block_k: int) -> bool:
    """The JAX ``_whole_seq`` route: one block that is the whole sequence."""
    return (q_len == block_q and kv_len == block_k and q_len == kv_len
            and q_len <= _WHOLE_SEQ_MAX)


def flash_attention_base(q, k, v, bias, seed: Optional[int], *,
                         dropout_rate: float = 0.0, causal: bool = False,
                         block_q: int = DEFAULT_BLOCK_Q,
                         block_k: int = DEFAULT_BLOCK_K,
                         dropout_site: int = 0):
    """Differentiable flash attention on [B, N, S, D]; ``bias`` is the
    key-padding bias [B, 1, 1, Sk] (None: no padding); ``seed`` None or
    ``dropout_rate`` 0 is deterministic."""
    batch, _, q_len, _ = q.shape
    kv_len = k.shape[2]
    if q_len % block_q or kv_len % block_k:
        raise ValueError(f"flash attention blocks ({block_q}, {block_k}) "
                         f"must divide the lengths ({q_len}, {kv_len})")
    rate = dropout_rate if seed is not None else 0.0
    if bias is None:
        bias = torch.zeros((batch, 1, 1, kv_len), dtype=torch.float32,
                           device=q.device)
    else:
        bias = bias.float().expand(batch, 1, 1, kv_len).contiguous()
    fn = (_FlashWhole if whole_seq(q_len, kv_len, block_q, block_k)
          else _FlashBlockwise)
    return fn.apply(q, k, v, bias, causal, rate,
                    0 if seed is None else int(seed), dropout_site)


def pick_block(n: int, cap: int) -> int:
    """The JAX adapter's block: the whole length up to ``cap``, else the
    largest multiple of 128 <= cap that divides it (``cap`` when none does,
    which then routes to the plain attention)."""
    if n <= cap:
        return n
    for b in range(cap, 127, -128):
        if n % b == 0:
            return b
    return cap


def flash_attention(q, k, v, bias=None, *, causal: bool = False,
                    dropout_rate: float = 0.0,
                    dropout_seed: Optional[int] = None,
                    dropout_site: int = 0):
    """The ``"flash"`` attention of ``ops/attention.py`` on [B, S, N, D],
    dispatched as the JAX adapter does (module docstring)."""
    if os.environ.get("PDT_FLASH_TWO_PASS", "0") == "1":
        raise NotImplementedError(
            "PDT_FLASH_TWO_PASS=1 selects the two-pass flash backward "
            "(kernels 10 and 11), which is not ported yet (ROADMAP.md, "
            "queue 2)"
        )
    _, q_len, _, head_dim = q.shape
    kv_len = k.shape[1]
    block_q = pick_block(q_len, DEFAULT_BLOCK_Q)
    block_k = pick_block(kv_len, DEFAULT_BLOCK_K)
    bias_ok = bias is None or (bias.dim() == 4 and bias.shape[1] == 1
                               and bias.shape[2] == 1)
    if (not bias_ok or q_len % block_q or kv_len % block_k
            or head_dim > 256):
        return reference_attention(
            q, k, v, bias, causal=causal, dropout_rate=dropout_rate,
            dropout_seed=dropout_seed, dropout_site=dropout_site,
        )
    o = flash_attention_base(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), bias,
        dropout_seed, dropout_rate=dropout_rate, causal=causal,
        block_q=block_q, block_k=block_k, dropout_site=dropout_site,
    )
    return o.transpose(1, 2)
