"""Flash attention (counterpart: the JAX package's ``ops/flash_attention.py``).

Six kernels (``csrc/flash_attention.cu``), each with its plain PyTorch
version here:

- ``flash_fwd``: the blockwise forward (TPU ``_fwd_kernel``): online
  softmax, causal k-tile skip, probability dropout in the kernel, O and
  the float32 log-sum-exp ``lse`` [B, N, Sq];
- ``flash_bwd``: the fused one-pass backward (TPU ``_dqkv_kernel``, the
  JAX package's default): dq, dk and dv from one recompute of the probs
  from ``lse``; delta = rowsum(dO * O) is formed in the kernel (float32)
  or by a pre-pass the wrapper launches with it (bfloat16);
- ``flash_dq`` / ``flash_dkv``: the two-pass backward (TPU ``_dq_kernel``
  / ``_dkv_kernel``), taken by the blockwise route when
  ``PDT_FLASH_TWO_PASS=1`` (read at each call): dq from a pass over the
  k-tiles each q-tile sees, dk and dv from a pass over the q-tiles each
  k-tile is seen by. Each takes ``delta=`` (``flash_delta``: rowsum(dO *
  O) in float32, [B, N, Sq]), which the two-pass route forms once and
  hands to both, as the JAX ``_vjp_bwd`` does; without it a call forms
  its own (the pre-pass on bfloat16, in the kernel on float32). Their
  plain versions are the fused plain backward's two halves, so the plain
  two-pass equals the plain fused backward;
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
32 and 64 in float32 or bfloat16, and the bfloat16 whole-sequence pair at
most 256 keys (``_WHOLE_SEQ_MAX``, the route's ceiling); another shape on
a CUDA tensor raises.
The whole-sequence route keeps its own backward in both modes, as the JAX
``_vjp_bwd`` does.

Entry points: every wrapper takes a tensor-core kernel (``pdt_*_mma``)
for bfloat16 inputs, which covers every head_dim the kernels take, and
its float32 FMA kernel (``pdt_flash_fwd``, ``pdt_flash_bwd``,
``pdt_flash_dq``, ``pdt_flash_dkv``, ``pdt_flash_whole_fwd``,
``pdt_flash_whole_bwd``) for float32 inputs. The tensor-core kernels run
bf16 ``mma.sync`` with float32 accumulators on tiles that ``cp.async``
brings into shared memory:

- ``pdt_flash_fwd_mma`` (kernel 6) and ``pdt_flash_bwd_mma`` (kernel 9,
  with a delta pre-pass and the dq sum): dv and dk as three bf16-piece
  products (``split_bf16x3``); at seq 1024 kernel 6 is bound by bytes,
  kernel 9 by operations;
- ``pdt_flash_dq_mma`` (kernel 10): the forward's grid; a warp keeps its
  rows of round(q * scale) and dO as fragments and walks the k-tiles,
  dq accumulated in registers; bound by bytes at seq 1024;
- ``pdt_flash_dkv_mma`` (kernel 11): kernel 9's main kernel with the dq
  work compiled out, so its dk and dv are kernel 9's sums in kernel 9's
  order; bytes and operations (8 D a visible pair) about even at seq
  1024; kernels 10 and 11 read a delta from ``pdt_flash_delta``;
- ``pdt_flash_whole_fwd_mma`` (kernel 7, Sk <= 256): the row's K and V
  stay in shared memory; a warp walks the tiles twice, the row's max and
  sum online, then the normalised p and P V; bound by bytes at seq 128;
- ``pdt_flash_whole_bwd_mma`` (kernel 8, Sk <= 256): a pre-pass forms
  each row's max and sum by kernel 7's walk, and delta; then kernel 9's
  main kernel with the normalised p and dk = round(dS)^T q, and the dq
  sum; bound by bytes at seq 128.

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


def _recompute(q, k, v, bias, o, lse, do, causal, rate, seed, site,
               delta=None):
    """The backward's recompute from the saved lse: (p, the dropper, ds);
    ``delta`` [B, N, Sq] as ``flash_delta`` forms it, or None to form it
    here."""
    s = _scores(q, k, bias, causal)
    p = torch.exp(s - lse[..., None])
    drop = _dropper(s.shape, rate, seed, site, q.device)
    dp = drop(torch.matmul(do.float(), v.float().transpose(-1, -2)))
    d = _delta(o, do) if delta is None else delta[..., None]
    return p, drop, p * (dp - d)


def _dq_from(ds, q, k):
    return (torch.matmul(ds.to(k.dtype).float(), k.float())
            * q.shape[-1] ** -0.5).to(q.dtype)


def _dkv_from(p, drop, ds, q, k, v, do):
    dv = torch.matmul(drop(p).transpose(-1, -2), do.float())
    dk = torch.matmul(ds.transpose(-1, -2), q.float() * q.shape[-1] ** -0.5)
    return dk.to(k.dtype), dv.to(v.dtype)


def reference_flash_dq(q, k, v, bias, o, lse, do, *, causal: bool,
                       rate: float = 0.0, seed: int = 0, site: int = 0,
                       delta=None):
    """Plain twin of ``flash_dq``: dq = (round(ds) K) * scale."""
    _, _, ds = _recompute(q, k, v, bias, o, lse, do, causal, rate, seed, site,
                          delta)
    return _dq_from(ds, q, k)


def reference_flash_dkv(q, k, v, bias, o, lse, do, *, causal: bool,
                        rate: float = 0.0, seed: int = 0, site: int = 0,
                        delta=None):
    """Plain twin of ``flash_dkv``: (dk, dv), dk = ds^T (q * scale)."""
    p, drop, ds = _recompute(q, k, v, bias, o, lse, do, causal, rate, seed,
                             site, delta)
    return _dkv_from(p, drop, ds, q, k, v, do)


def reference_flash_bwd(q, k, v, bias, o, lse, do, *, causal: bool,
                        rate: float = 0.0, seed: int = 0, site: int = 0):
    """Plain twin of ``flash_bwd``: (dq, dk, dv) from the saved lse, one
    recompute shared by the two halves of the two-pass plain version."""
    p, drop, ds = _recompute(q, k, v, bias, o, lse, do, causal, rate, seed,
                             site)
    return (_dq_from(ds, q, k), *_dkv_from(p, drop, ds, q, k, v, do))


def split_bf16x3(x: torch.Tensor):
    """float32 ``x`` as three bfloat16 pieces with hi + mid + lo == x
    exactly (|x| >= 2^-110 or 0): hi the nearest bf16 of x, mid of what hi
    leaves, lo of what both leave. The plain twin of the split the
    tensor-core backward applies to p_drop and dS before dv = p_drop^T dO
    and dk = dS^T q (``csrc/mma.cuh``); no path here uses it."""
    hi = x.to(torch.bfloat16)
    rest = x - hi.float()
    mid = rest.to(torch.bfloat16)
    return hi, mid, (rest - mid.float()).to(torch.bfloat16)


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
    "pdt_flash_fwd_mma": 3,    # o, lse, stream
    "pdt_flash_whole_fwd": 2,  # o, stream
    "pdt_flash_bwd": 8,        # o, do, lse, dq, dk, dv, dq_part, stream
    "pdt_flash_bwd_mma": 9,    # o, do, lse, delta, dq, dk, dv, dq_part,
                               # stream
    "pdt_flash_delta": 4,      # o, do, delta, stream
    "pdt_flash_dq": 5,         # o, do, lse, dq, stream
    "pdt_flash_dq_mma": 5,     # do, lse, delta, dq, stream
    "pdt_flash_dkv": 6,        # o, do, lse, dk, dv, stream
    "pdt_flash_dkv_mma": 6,    # do, lse, delta, dk, dv, stream
    "pdt_flash_whole_fwd_mma": 2,  # o, stream
    "pdt_flash_whole_bwd": 7,  # o, do, dq, dk, dv, dq_part, stream
    "pdt_flash_whole_bwd_mma": 9,  # o, do, stats, delta, dq, dk, dv,
                                   # dq_part, stream
}


@functools.cache
def _kernel(entry: str):
    """(library, C entry point), built on first use."""
    lib = _build.load("flash_attention")
    fn = getattr(lib, entry)
    fn.argtypes = _COMMON_ARGTYPES + [ctypes.c_void_p] * _ENTRY_POINTERS[entry]
    fn.restype = ctypes.c_int
    return lib, fn


def _aligned(t: torch.Tensor) -> bool:
    """16-byte rows at 16-byte addresses (the tensor-core kernels copy 16
    bytes at a time)."""
    return (t.data_ptr() % 16 == 0
            and all(s * t.element_size() % 16 == 0 for s in t.stride()[:3]))


def _dense(t: torch.Tensor) -> torch.Tensor:
    """``t`` if it is [B, N, S, D] contiguous or the [B, N, S, D] view of a
    contiguous [B, S, N, D] tensor (the layouts the kernels read by
    strides), aligned, else a contiguous copy."""
    if ((t.is_contiguous() or t.transpose(1, 2).is_contiguous())
            and _aligned(t)):
        return t
    return t.contiguous()


def _like(t: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """``t`` in ``ref``'s strides (a copy only when they differ or ``t`` is
    not aligned)."""
    if t.stride() == ref.stride() and _aligned(t):
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


def _launch(kernel_name, entry, anchor, args, *pointers, count=True):
    lib, fn = _kernel(entry)
    code = fn(*args, *pointers, _build.stream_ptr(anchor))
    _build.check_launch(lib, kernel_name, code, count)


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
    CUDA device: the tensor-core kernel for bfloat16, the FMA one for
    float32."""
    kw = dict(causal=causal, rate=rate, seed=seed, site=site)
    if _on_cpu("flash_fwd", q, k, v, bias, rate):
        return reference_flash_fwd(q, k, v, bias, **kw)
    q, k, v, args = _cuda_common("flash_fwd", q, k, v, bias, **kw)
    o = _empty_like(q)
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    entry = ("pdt_flash_fwd_mma" if q.dtype == torch.bfloat16
             else "pdt_flash_fwd")
    _launch("flash_fwd", entry, q, args, o.data_ptr(), lse.data_ptr())
    return o, lse


def _bwd_inputs(name, q, k, v, bias, o, lse, do, kw):
    """Kernel-side checks of a blockwise backward's inputs; (q, k, v, o,
    do, lse, the common C arguments)."""
    q, k, v, args = _cuda_common(name, q, k, v, bias, **kw)
    o, do = _like(o, q), _like(do.to(q.dtype), q)
    lse = lse.contiguous()
    if lse.shape != q.shape[:3] or lse.dtype != torch.float32:
        raise ValueError(f"{name} takes a float32 lse [B, N, Sq], got "
                         f"{lse.dtype} {tuple(lse.shape)}")
    return q, k, v, o, do, lse, args


def _delta_scratch(q):
    """float32 [B, N, Sq] that the tensor-core backwards' pre-pass fills
    with delta = rowsum(dO o)."""
    return torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)


def flash_bwd(q, k, v, bias, o, lse, do, *, causal: bool, rate: float = 0.0,
              seed: int = 0, site: int = 0):
    """Fused blockwise backward: (dq, dk, dv); on a CUDA device the
    tensor-core kernel (with its delta pre-pass and dq sum) for bfloat16,
    the FMA one for float32."""
    kw = dict(causal=causal, rate=rate, seed=seed, site=site)
    if _on_cpu("flash_bwd", q, k, v, bias, rate):
        return reference_flash_bwd(q, k, v, bias, o, lse, do, **kw)
    q, k, v, o, do, lse, args = _bwd_inputs("flash_bwd", q, k, v, bias, o,
                                            lse, do, kw)
    dq, dk, dv = _empty_like(q), _empty_like(k), _empty_like(k)
    grads = (dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
             _dq_scratch(q, k).data_ptr())
    if q.dtype == torch.bfloat16:
        _launch("flash_bwd", "pdt_flash_bwd_mma", q, args, o.data_ptr(),
                do.data_ptr(), lse.data_ptr(), _delta_scratch(q).data_ptr(),
                *grads)
    else:
        _launch("flash_bwd", "pdt_flash_bwd", q, args, o.data_ptr(),
                do.data_ptr(), lse.data_ptr(), *grads)
    return dq, dk, dv


def flash_delta(o, do):
    """delta = rowsum(dO * O) in float32, [B, N, Sq], formed once for both
    passes of the two-pass backward (JAX ``_vjp_bwd`` forms it outside
    ``_dq_kernel`` and ``_dkv_kernel``): the plain formula on the CPU, the
    pre-pass kernel ``pdt_flash_delta`` on a CUDA device for bfloat16.
    None for float32 on a CUDA device, whose FMA kernels form delta
    themselves."""
    if o.device.type == "cpu":
        return _delta(o, do)[..., 0]
    if o.dtype != torch.bfloat16:
        return None
    if o.dim() != 4 or do.shape != o.shape or o.shape[-1] not in \
            _KERNEL_HEAD_DIMS:
        raise ValueError(f"flash_delta kernel takes o and do of one [B, N, "
                         f"S, D] shape with D in {_KERNEL_HEAD_DIMS}; got "
                         f"{tuple(o.shape)}, {tuple(do.shape)}")
    o = _dense(o)
    do = _like(do.to(o.dtype), o)
    b, n, sq, d = o.shape
    delta = _delta_scratch(o)
    # the pre-pass reads the shape, o's strides (do shares them) and the
    # dtype of the common arguments
    args = (o.data_ptr(), o.data_ptr(), o.data_ptr(), 0, b, n, sq, sq, d,
            *o.stride()[:3], *o.stride()[:3], 1.0, 0, 0, 0, 0, 0, 1.0,
            _DTYPE_CODES[o.dtype])
    # one pre-pass for kernels 10 and 11, counted under neither
    _launch("flash_dq", "pdt_flash_delta", o, args, o.data_ptr(),
            do.data_ptr(), delta.data_ptr(), count=False)
    return delta


def _given_delta(name, delta, q, o, do):
    """The delta a bfloat16 two-pass kernel reads: ``delta`` checked, or
    a new one from the pre-pass."""
    if delta is None:
        return flash_delta(o, do)
    if (delta.shape != q.shape[:3] or delta.dtype != torch.float32
            or not delta.is_contiguous() or delta.device != q.device):
        raise ValueError(f"{name} takes a contiguous float32 delta [B, N, "
                         f"Sq] on {q.device}, got {delta.dtype} "
                         f"{tuple(delta.shape)} on {delta.device}")
    return delta


def flash_dq(q, k, v, bias, o, lse, do, *, causal: bool, rate: float = 0.0,
             seed: int = 0, site: int = 0, delta=None):
    """Two-pass blockwise backward, first pass: dq; on a CUDA device the
    tensor-core kernel for bfloat16 (reading ``delta``, or the pre-pass's
    when None), the FMA one for float32 (delta formed in the kernel)."""
    kw = dict(causal=causal, rate=rate, seed=seed, site=site)
    if _on_cpu("flash_dq", q, k, v, bias, rate):
        return reference_flash_dq(q, k, v, bias, o, lse, do, delta=delta,
                                  **kw)
    q, k, v, o, do, lse, args = _bwd_inputs("flash_dq", q, k, v, bias, o,
                                            lse, do, kw)
    dq = _empty_like(q)
    if q.dtype == torch.bfloat16:
        delta = _given_delta("flash_dq", delta, q, o, do)
        _launch("flash_dq", "pdt_flash_dq_mma", q, args, do.data_ptr(),
                lse.data_ptr(), delta.data_ptr(), dq.data_ptr())
    else:
        _launch("flash_dq", "pdt_flash_dq", q, args, o.data_ptr(),
                do.data_ptr(), lse.data_ptr(), dq.data_ptr())
    return dq


def flash_dkv(q, k, v, bias, o, lse, do, *, causal: bool, rate: float = 0.0,
              seed: int = 0, site: int = 0, delta=None):
    """Two-pass blockwise backward, second pass: (dk, dv); on a CUDA
    device the tensor-core kernel for bfloat16 (reading ``delta``, or the
    pre-pass's when None), the FMA one for float32."""
    kw = dict(causal=causal, rate=rate, seed=seed, site=site)
    if _on_cpu("flash_dkv", q, k, v, bias, rate):
        return reference_flash_dkv(q, k, v, bias, o, lse, do, delta=delta,
                                   **kw)
    q, k, v, o, do, lse, args = _bwd_inputs("flash_dkv", q, k, v, bias, o,
                                            lse, do, kw)
    dk, dv = _empty_like(k), _empty_like(k)
    grads = (dk.data_ptr(), dv.data_ptr())
    if q.dtype == torch.bfloat16:
        delta = _given_delta("flash_dkv", delta, q, o, do)
        _launch("flash_dkv", "pdt_flash_dkv_mma", q, args, do.data_ptr(),
                lse.data_ptr(), delta.data_ptr(), *grads)
    else:
        _launch("flash_dkv", "pdt_flash_dkv", q, args, o.data_ptr(),
                do.data_ptr(), lse.data_ptr(), *grads)
    return dk, dv


def _whole_bf16_keys(name, k):
    if k.dtype == torch.bfloat16 and k.shape[2] > _WHOLE_SEQ_MAX:
        raise ValueError(f"{name} kernel takes at most {_WHOLE_SEQ_MAX} keys "
                         f"in bfloat16, got {k.shape[2]}")


def flash_whole_fwd(q, k, v, bias, *, causal: bool, rate: float = 0.0,
                    seed: int = 0, site: int = 0):
    """Whole-sequence forward: o; on a CUDA device the tensor-core kernel
    for bfloat16 (up to ``_WHOLE_SEQ_MAX`` keys, the route's ceiling), the
    FMA one for float32."""
    kw = dict(causal=causal, rate=rate, seed=seed, site=site)
    if _on_cpu("flash_whole_fwd", q, k, v, bias, rate):
        return reference_whole_fwd(q, k, v, bias, **kw)
    q, k, v, args = _cuda_common("flash_whole_fwd", q, k, v, bias, **kw)
    _whole_bf16_keys("flash_whole_fwd", k)
    entry = ("pdt_flash_whole_fwd_mma" if q.dtype == torch.bfloat16
             else "pdt_flash_whole_fwd")
    o = _empty_like(q)
    _launch("flash_whole_fwd", entry, q, args, o.data_ptr())
    return o


def flash_whole_bwd(q, k, v, bias, o, do, *, causal: bool, rate: float = 0.0,
                    seed: int = 0, site: int = 0):
    """Whole-sequence backward: (dq, dk, dv); on a CUDA device the
    tensor-core kernel for bfloat16 (up to ``_WHOLE_SEQ_MAX`` keys; with
    its statistics pre-pass and dq sum), the FMA one for float32."""
    kw = dict(causal=causal, rate=rate, seed=seed, site=site)
    if _on_cpu("flash_whole_bwd", q, k, v, bias, rate):
        return reference_whole_bwd(q, k, v, bias, o, do, **kw)
    q, k, v, args = _cuda_common("flash_whole_bwd", q, k, v, bias, **kw)
    _whole_bf16_keys("flash_whole_bwd", k)
    o, do = _like(o, q), _like(do.to(q.dtype), q)
    dq, dk, dv = _empty_like(q), _empty_like(k), _empty_like(k)
    grads = (dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
             _dq_scratch(q, k).data_ptr())
    if q.dtype == torch.bfloat16:
        # the pre-pass's m, l and 1 / l of each row, and delta
        stats = torch.empty((3, *q.shape[:3]), dtype=torch.float32,
                            device=q.device)
        _launch("flash_whole_bwd", "pdt_flash_whole_bwd_mma", q, args,
                o.data_ptr(), do.data_ptr(), stats.data_ptr(),
                _delta_scratch(q).data_ptr(), *grads)
    else:
        _launch("flash_whole_bwd", "pdt_flash_whole_bwd", q, args,
                o.data_ptr(), do.data_ptr(), *grads)
    return dq, dk, dv


# --------------------------------------------------------------- autograd


class _FlashBlockwise(torch.autograd.Function):
    """Kernel 6 forward; kernel 9 backward, or kernels 10 and 11 (after one
    delta pre-pass) when ``two_pass``; saves o and lse."""

    @staticmethod
    def forward(ctx, q, k, v, bias, causal, rate, seed, site, two_pass):
        ctx.opts = dict(causal=causal, rate=rate, seed=seed, site=site)
        ctx.two_pass = two_pass
        o, lse = flash_fwd(q, k, v, bias, **ctx.opts)
        ctx.save_for_backward(q, k, v, bias, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        saved = ctx.saved_tensors
        if ctx.two_pass:
            # delta once for both passes, as the JAX _vjp_bwd forms it
            delta = flash_delta(saved[4], do)
            dq = flash_dq(*saved, do, delta=delta, **ctx.opts)
            dk, dv = flash_dkv(*saved, do, delta=delta, **ctx.opts)
        else:
            dq, dk, dv = flash_bwd(*saved, do, **ctx.opts)
        return dq, dk, dv, None, None, None, None, None, None


class _FlashWhole(torch.autograd.Function):
    """Kernel 7 forward, kernel 8 backward; saves o only."""

    @staticmethod
    def forward(ctx, q, k, v, bias, causal, rate, seed, site, two_pass):
        del two_pass  # one backward kernel in both modes, as in the JAX one
        ctx.opts = dict(causal=causal, rate=rate, seed=seed, site=site)
        o = flash_whole_fwd(q, k, v, bias, **ctx.opts)
        ctx.save_for_backward(q, k, v, bias, o)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, bias, o = ctx.saved_tensors
        dq, dk, dv = flash_whole_bwd(q, k, v, bias, o, do, **ctx.opts)
        return dq, dk, dv, None, None, None, None, None, None


def whole_seq(q_len: int, kv_len: int, block_q: int, block_k: int) -> bool:
    """The JAX ``_whole_seq`` route: one block that is the whole sequence."""
    return (q_len == block_q and kv_len == block_k and q_len == kv_len
            and q_len <= _WHOLE_SEQ_MAX)


def two_pass_backward() -> bool:
    """``PDT_FLASH_TWO_PASS=1`` selects the two-pass blockwise backward
    (kernels 10 and 11) over the fused one (kernel 9), as it flips the JAX
    package's ``FUSED_BWD``; read at each call."""
    return os.environ.get("PDT_FLASH_TWO_PASS", "0") == "1"


def flash_attention_base(q, k, v, bias, seed: Optional[int], *,
                         dropout_rate: float = 0.0, causal: bool = False,
                         block_q: int = DEFAULT_BLOCK_Q,
                         block_k: int = DEFAULT_BLOCK_K,
                         dropout_site: int = 0):
    """Differentiable flash attention on [B, N, S, D]; ``bias`` is the
    key-padding bias [B, 1, 1, Sk] (None: no padding); ``seed`` None or
    ``dropout_rate`` 0 is deterministic. The blockwise route's backward is
    fused or two-pass by ``two_pass_backward()`` at this call."""
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
                    0 if seed is None else int(seed), dropout_site,
                    two_pass_backward())


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
                    dropout_site: int = 0, dropout_impl: str = "kernel"):
    """The ``"flash"`` attention of ``ops/attention.py`` on [B, S, N, D],
    dispatched as the JAX adapter does (module docstring). The kernels
    keep their in-kernel mask whatever ``dropout_impl``; only the plain
    attention fallback takes the stream, as in JAX."""
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
            dropout_impl=dropout_impl,
        )
    o = flash_attention_base(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), bias,
        dropout_seed, dropout_rate=dropout_rate, causal=causal,
        block_q=block_q, block_k=block_k, dropout_site=dropout_site,
    )
    return o.transpose(1, 2)
