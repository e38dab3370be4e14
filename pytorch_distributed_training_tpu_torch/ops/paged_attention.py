"""Paged decode attention: the Hopper kernel and its plain version
(counterpart: the JAX package's ``ops/paged_attention.py``, 3-D query).

Shapes (as in the JAX package):

- ``q``: [batch, heads, head_dim], ONE query token per sequence;
- ``k_pages``/``v_pages``: [num_pages, page_size, heads, head_dim], the
  engine-owned pools; page 0 is the reserved null page idle sequences
  park on;
- ``block_table``: [batch, pages_per_seq] int32, page ids in token order;
- ``lengths``: [batch] int32, valid tokens per sequence INCLUDING the query
  token (the engine writes the new K/V before attending); ``lengths >= 1``
  is the engine's contract.

The output has the pools' dtype. ``paged_attention`` on CPU tensors runs
``_paged_reference`` (gather through the block table, the dense formula:
fp32 scores, ``finfo(float32).min`` mask, fp32 softmax, probs cast to the
V dtype); on CUDA tensors it launches ``csrc/paged_attention.cu``, which
walks the block table in place, or raises. A 4-D (multi-token) query and
int8 pools are not ported yet.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from pytorch_distributed_training_tpu_torch.ops import _build

_NEG = torch.finfo(torch.float32).min
_MAX_HEAD_DIM = 256
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_POOL_AXES = ("num_pages", "page_size", "heads", "head_dim")


def _check(q, k_pages, v_pages, block_table, lengths):
    """The JAX package's shape/dtype contract, axis by axis."""
    if q.dim() == 4:
        raise NotImplementedError(
            "multi-token (4-D) query paged attention is not ported yet "
            "(speculative verify / chunked prefill; see ROADMAP.md, queue 2 "
            "kernel 13)"
        )
    if q.dim() != 3:
        raise ValueError(
            f"q must be [batch, heads, head_dim], got {tuple(q.shape)}"
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
    if k_pages.dtype == torch.int8:
        raise NotImplementedError(
            "int8 page pools are not ported yet (see ROADMAP.md, queue 1, "
            "slice 4)"
        )


def paged_attention(q, k_pages, v_pages, block_table, lengths, *,
                    scale: float):
    """Single-token decode attention through a page table; returns
    [batch, heads, head_dim] in the pools' dtype."""
    _check(q, k_pages, v_pages, block_table, lengths)
    if q.device.type == "cpu":
        return _paged_reference(q, k_pages, v_pages, block_table, lengths,
                                scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention runs on cpu or cuda, got {q.device}")
    return _paged_cuda(q, k_pages, v_pages, block_table, lengths, scale)


def _paged_reference(q, k_pages, v_pages, block_table, lengths, scale):
    batch, heads, head_dim = q.shape
    page_size = k_pages.shape[1]
    windows = block_table.shape[1]
    tokens = windows * page_size
    # [B, W, P, H, D] -> [B, W*P, H, D]: token order is page order x in-page
    # offset, exactly how the allocator lays tokens out
    idx = block_table.long()
    k = k_pages[idx].reshape(batch, tokens, heads, head_dim)
    v = v_pages[idx].reshape(batch, tokens, heads, head_dim)
    scores = torch.einsum("bnd,btnd->bnt", q.float(), k.float()) * scale
    pos = torch.arange(tokens, device=q.device)
    valid = pos[None, :] < lengths[:, None]
    scores = torch.where(valid[:, None, :], scores, _NEG)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bnt,btnd->bnd", probs.float(), v.float())
    return out.to(v.dtype)


@functools.cache
def _kernel():
    """(library, C entry point) of the paged kernel, built on first use."""
    lib = _build.load("paged_attention")
    fn = lib.pdt_paged_attention_decode
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return lib, fn


def _paged_cuda(q, k_pages, v_pages, block_table, lengths, scale):
    tensors = (("q", q), ("k_pages", k_pages), ("v_pages", v_pages),
               ("block_table", block_table), ("lengths", lengths))
    for name, t in tensors:
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"paged_attention kernel needs a contiguous {name}")
    if q.dtype != k_pages.dtype or q.dtype not in _DTYPE_CODES:
        raise ValueError(
            f"paged_attention kernel takes q and pools of one dtype, float32 "
            f"or bfloat16; got q {q.dtype}, pools {k_pages.dtype}"
        )
    for name, t in (("block_table", block_table), ("lengths", lengths)):
        if t.dtype != torch.int32:
            raise ValueError(f"{name} must be int32, got {t.dtype}")
    batch, heads, head_dim = q.shape
    if head_dim > _MAX_HEAD_DIM:
        raise ValueError(
            f"paged_attention kernel takes head_dim <= {_MAX_HEAD_DIM}, got "
            f"{head_dim}"
        )
    out = torch.empty_like(q)
    if batch == 0:
        return out
    lib, fn = _kernel()
    code = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
              block_table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
              batch, heads, head_dim, k_pages.shape[1], block_table.shape[1],
              scale, _DTYPE_CODES[q.dtype], _build.stream_ptr(q))
    _build.check_launch(lib, "paged_attention", code)
    return out
