"""Paged attention: the Hopper kernels and their plain versions
(counterpart: the JAX package's ``ops/paged_attention.py``).

Shapes (as in the JAX package):

- ``q``: [batch, heads, head_dim], ONE query token per sequence (the decode
  step), or [batch, q_len, heads, head_dim], a causal block of query tokens
  (speculative verify, chunked prefill, the tail of a prefix-cache hit):
  the q_len tokens are the LAST q_len positions of the sequence and row
  ``j`` sees positions ``< lengths - q_len + 1 + j``;
- ``k_pages``/``v_pages``: [num_pages, page_size, heads, head_dim], the
  engine-owned pools; page 0 is the reserved null page idle sequences
  park on;
- ``block_table``: [batch, pages_per_seq] int32, page ids in token order;
- ``lengths``: [batch] int32, valid tokens per sequence INCLUDING every
  query token (the engine writes the new K/V before attending);
  ``lengths >= q_len`` is the engine's contract.

int8 pools carry fp32 scale pools ``k_scales``/``v_scales`` of shape
[num_pages, page_size, heads], one scale per (token, head), written
through the same (page, offset) as their values (``ops/quant.quantize_kv``);
float pools take none (``_check_scale_pool``).

The output has the pools' dtype, float32 for int8 pools. On CPU tensors
``paged_attention`` runs the plain versions ``_paged_reference`` (3-D) and
``_paged_reference_mq`` (4-D): gather through the block table (int8 pages
dequantized as ``page.float() * scale``), the dense formula (fp32 scores,
``finfo(float32).min`` mask, fp32 softmax, probs cast to the V dtype). On
CUDA tensors it launches ``csrc/paged_attention.cu`` (3-D, counted as
``paged_attention``, or ``paged_attention_int8`` on int8 pools) or
``csrc/paged_attention_mq.cu`` (4-D, ``paged_attention_mq`` or
``paged_attention_mq_int8``), all walking the block table in place and
dequantizing in the kernel, or raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from pytorch_distributed_training_tpu_torch.ops import _build

_NEG = torch.finfo(torch.float32).min
_MAX_HEAD_DIM = 256
_MAX_Q_LEN = 128          # the multi-query kernel's rows per (seq, head)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_POOL_AXES = ("num_pages", "page_size", "heads", "head_dim")
_SCALE_AXES = ("num_pages", "page_size", "heads")


def _check(q, k_pages, v_pages, block_table, lengths):
    """The JAX package's shape/dtype contract, axis by axis."""
    if q.dim() not in (3, 4):
        raise ValueError(
            f"q must be [batch, heads, head_dim] or "
            f"[batch, q_len, heads, head_dim], got {tuple(q.shape)}"
        )
    if k_pages.shape != v_pages.shape:
        bad = ", ".join(
            f"{name} (axis {i}): k_pages={ks} vs v_pages={vs}"
            for i, (name, ks, vs) in enumerate(
                zip(_POOL_AXES, k_pages.shape, v_pages.shape)
            )
            if ks != vs
        ) or f"rank: k_pages={k_pages.dim()} vs v_pages={v_pages.dim()}"
        raise ValueError(
            f"k_pages/v_pages shapes differ on {bad} (full shapes "
            f"{tuple(k_pages.shape)} vs {tuple(v_pages.shape)})"
        )
    if k_pages.dim() != 4:
        raise ValueError(
            f"pools must be [num_pages, page_size, heads, head_dim], got "
            f"{tuple(k_pages.shape)}"
        )
    for name, q_dim, pool_dim in (
        ("heads", q.shape[-2], k_pages.shape[2]),
        ("head_dim", q.shape[-1], k_pages.shape[3]),
    ):
        if q_dim != pool_dim:
            raise ValueError(
                f"q/pool mismatch on axis {name!r}: q has {q_dim}, "
                f"k_pages/v_pages have {pool_dim} (q {tuple(q.shape)}, pools "
                f"{tuple(k_pages.shape)})"
            )
    if block_table.dim() != 2 or block_table.shape[0] != q.shape[0]:
        raise ValueError(
            f"block_table must be [batch, pages_per_seq]: got shape "
            f"{tuple(block_table.shape)} (rank {block_table.dim()}, want 2; "
            f"axis 'batch' got "
            f"{block_table.shape[0] if block_table.dim() else '-'}, want "
            f"{q.shape[0]} from q)"
        )
    if tuple(lengths.shape) != (q.shape[0],):
        raise ValueError(
            f"lengths must be [batch]: got shape {tuple(lengths.shape)}, want "
            f"({q.shape[0]},) (axis 'batch' from q)"
        )
    if k_pages.dtype != v_pages.dtype:
        raise ValueError(
            f"k_pages/v_pages dtypes differ: {k_pages.dtype} vs "
            f"{v_pages.dtype} (pools quantize together or not at all)"
        )
    if q.dim() == 4 and q.shape[1] > block_table.shape[1] * k_pages.shape[1]:
        raise ValueError(
            f"q_len {q.shape[1]} exceeds the {block_table.shape[1]} x "
            f"{k_pages.shape[1]} tokens a block-table row addresses"
        )


def _check_scale_pool(pool_name, pool, scale_name, scales):
    """The contract between an int8 pool and its scale pool, in the JAX
    package's named-axis style: int8 pools REQUIRE fp32 scales of shape
    [num_pages, page_size, heads]; float pools take none."""
    if pool.dtype == torch.int8:
        want = tuple(pool.shape[:3])
        if scales is None:
            raise ValueError(
                f"{pool_name} is int8 but {scale_name} is missing: int8 "
                f"pools require fp32 per-page-per-head scales of shape "
                f"(num_pages, page_size, heads) = {want}"
            )
        if scales.dim() != 3:
            raise ValueError(
                f"{scale_name} must be [num_pages, page_size, heads]: got "
                f"shape {tuple(scales.shape)} (rank {scales.dim()}, want 3)"
            )
        if tuple(scales.shape) != want:
            bad = ", ".join(
                f"{name} (axis {i}): got {g}, want {w}"
                for i, (name, g, w) in enumerate(
                    zip(_SCALE_AXES, scales.shape, want))
                if g != w
            )
            raise ValueError(
                f"{scale_name} shape mismatch on {bad} (got "
                f"{tuple(scales.shape)}, want {want} from {pool_name})"
            )
        if scales.dtype != torch.float32:
            raise ValueError(
                f"{scale_name} must be float32, got {scales.dtype}"
            )
    elif scales is not None:
        raise ValueError(
            f"{scale_name} provided but {pool_name} dtype is {pool.dtype}: "
            f"scale pools accompany int8 pages only"
        )


def paged_attention(q, k_pages, v_pages, block_table, lengths, *,
                    scale: float, k_scales=None, v_scales=None):
    """Attention through a page table. 3-D ``q`` is the decode step
    (returns [batch, heads, head_dim]); 4-D ``q`` a causal block of query
    tokens (returns [batch, q_len, heads, head_dim]); the pools' dtype, or
    float32 for int8 pools, which carry their fp32 ``k_scales`` and
    ``v_scales`` [num_pages, page_size, heads]."""
    _check(q, k_pages, v_pages, block_table, lengths)
    _check_scale_pool("k_pages", k_pages, "k_scales", k_scales)
    _check_scale_pool("v_pages", v_pages, "v_scales", v_scales)
    args = (q, k_pages, v_pages, block_table, lengths, scale, k_scales,
            v_scales)
    if q.device.type == "cpu":
        return (_paged_reference_mq if q.dim() == 4 else _paged_reference)(
            *args)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention runs on cpu or cuda, got {q.device}")
    return _paged_cuda(*args)


def _gather_dequant(pages, scales, idx, batch, tokens, heads, head_dim):
    """Gather pages through the block table ([B, W, P, H, D] -> [B, W*P, H,
    D]: token order is page order x in-page offset, exactly how the
    allocator lays tokens out) and, for int8 pools, dequantize against the
    scale pool gathered the same way (one fp32 scale per token per head)."""
    x = pages[idx].reshape(batch, tokens, heads, head_dim)
    if scales is None:
        return x
    s = scales[idx].reshape(batch, tokens, heads)
    return x.float() * s[..., None]


def _paged_reference(q, k_pages, v_pages, block_table, lengths, scale,
                     k_scales=None, v_scales=None):
    batch, heads, head_dim = q.shape
    tokens = block_table.shape[1] * k_pages.shape[1]
    idx = block_table.long()
    k = _gather_dequant(k_pages, k_scales, idx, batch, tokens, heads, head_dim)
    v = _gather_dequant(v_pages, v_scales, idx, batch, tokens, heads, head_dim)
    scores = torch.einsum("bnd,btnd->bnt", q.float(), k.float()) * scale
    pos = torch.arange(tokens, device=q.device)
    valid = pos[None, :] < lengths[:, None]
    scores = torch.where(valid[:, None, :], scores, _NEG)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bnt,btnd->bnd", probs.float(), v.float())
    return out.to(v.dtype)


def _paged_reference_mq(q, k_pages, v_pages, block_table, lengths, scale,
                        k_scales=None, v_scales=None):
    """The JAX ``_paged_reference_mq``: row ``j`` of the query block sees
    positions ``< lengths - (q_len - 1) + j``."""
    batch, q_len, heads, head_dim = q.shape
    tokens = block_table.shape[1] * k_pages.shape[1]
    idx = block_table.long()
    k = _gather_dequant(k_pages, k_scales, idx, batch, tokens, heads, head_dim)
    v = _gather_dequant(v_pages, v_scales, idx, batch, tokens, heads, head_dim)
    scores = torch.einsum("bqnd,btnd->bnqt", q.float(), k.float()) * scale
    pos = torch.arange(tokens, device=q.device)
    row = torch.arange(q_len, device=q.device)
    limit = lengths[:, None].long() - (q_len - 1) + row[None, :]   # [B, Q]
    valid = pos[None, None, :] < limit[:, :, None]                 # [B, Q, T]
    scores = torch.where(valid[:, None], scores, _NEG)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bnqt,btnd->bqnd", probs.float(), v.float())
    return out.to(v.dtype)


@functools.cache
def _kernel(multi: bool, quantized: bool):
    """(library, C entry point) of the paged kernel (``multi``: the 4-D
    query one; ``quantized``: its int8-pool entry, which also takes the two
    scale pools), built on first use."""
    lib = _build.load("paged_attention_mq" if multi else "paged_attention")
    fn = getattr(lib, ("pdt_paged_attention_mq" if multi else
                       "pdt_paged_attention_decode")
                 + ("_int8" if quantized else ""))
    fn.argtypes = ([ctypes.c_void_p] * (8 if quantized else 6)
                   + [ctypes.c_int] * (6 if multi else 5)
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib, fn


def _paged_cuda(q, k_pages, v_pages, block_table, lengths, scale,
                k_scales=None, v_scales=None):
    """Launch the paged kernel: q float32 or bfloat16, with pools of q's
    dtype (output in q's dtype) or int8 pools and their fp32 scale pools
    (output float32); raises on anything else."""
    quantized = k_pages.dtype == torch.int8
    tensors = [("q", q), ("k_pages", k_pages), ("v_pages", v_pages)]
    if quantized:
        tensors += [("k_scales", k_scales), ("v_scales", v_scales)]
    tensors += [("block_table", block_table), ("lengths", lengths)]
    for name, t in tensors:
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"paged_attention kernel needs a contiguous {name}")
    if q.dtype not in _DTYPE_CODES or not (quantized
                                           or k_pages.dtype == q.dtype):
        raise ValueError(
            f"paged_attention kernel takes a float32 or bfloat16 q with pools "
            f"of q's dtype or int8 pools; got q {q.dtype}, pools "
            f"{k_pages.dtype}"
        )
    for name, t in (("block_table", block_table), ("lengths", lengths)):
        if t.dtype != torch.int32:
            raise ValueError(f"{name} must be int32, got {t.dtype}")
    multi = q.dim() == 4
    batch, heads, head_dim = q.shape[0], q.shape[-2], q.shape[-1]
    if head_dim > _MAX_HEAD_DIM:
        raise ValueError(
            f"paged_attention kernel takes head_dim <= {_MAX_HEAD_DIM}, got "
            f"{head_dim}"
        )
    if multi and not 1 <= q.shape[1] <= _MAX_Q_LEN:
        raise ValueError(
            f"paged_attention_mq kernel takes 1 <= q_len <= {_MAX_Q_LEN}, got "
            f"{q.shape[1]}"
        )
    out = torch.empty(q.shape, device=q.device,
                      dtype=torch.float32 if quantized else q.dtype)
    if batch == 0:
        return out
    lib, fn = _kernel(multi, quantized)
    ptrs = [t.data_ptr() for _, t in tensors] + [out.data_ptr()]
    dims = (batch, q.shape[1]) if multi else (batch,)
    code = fn(*ptrs, *dims, heads, head_dim, k_pages.shape[1],
              block_table.shape[1], scale, _DTYPE_CODES[q.dtype],
              _build.stream_ptr(q))
    _build.check_launch(
        lib, ("paged_attention_mq" if multi else "paged_attention")
        + ("_int8" if quantized else ""), code)
    return out
