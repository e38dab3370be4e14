"""The order of the port's multi-query paged kernel on bf16 and int8 pools
(``csrc/paged_attention_mq.cu``, ``paged_mq_mma_kernel``) emulated in
float32 on the CPU, against the JAX package's paged attention on 4-D q
(the Pallas kernel in interpret mode and the reference) on the same numpy
inputs.

The kernel gives each tile of 16 query rows a block whose warps split the
tile's visible tokens (those of the tile's last row) in shares of 16
tokens, warp w taking shares w, w + warps, ... Every warp keeps a per-row
online softmax (m, l, acc) that starts at finfo(float32).min, masks each
row at its own horizon, forms S on the tensor cores from q in bf16 pieces
(three for float32 q, exact) and adds P V with p (times the int8 v scale)
split into three exact bf16 pieces; the warps merge in warp order, and
out = acc / l with l floored to 1. The emulation follows that order with
the warps, the share and the tile rows as parameters; each bf16 piece and
its product are exact in float32, so the emulation adds the pieces'
products in the kernel's order (hi, mid, lo) in float32. The CUDA kernel
itself runs only on the card (``chip_smoke.py``)."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_training_tpu.ops import paged_attention as jax_pa
from pytorch_distributed_training_tpu.ops.flash_attention import (
    tpu_interpret_mode,
)
from pytorch_distributed_training_tpu_torch.ops import quant
from pytorch_distributed_training_tpu_torch.ops.paged_attention import (
    paged_attention,
)

torch.set_num_threads(2)

F32 = np.float32
NEG_MIN = np.finfo(F32).min
PAGE, HEADS, HEAD_DIM = 4, 2, 16
Q_LENS = (1, 2, 5, 16, 17, 32, 64)
# float32 sums in another order than JAX's, over at most 76 unit-scale
# terms: a few float32 ulps of outputs of magnitude ~1
TOL = 1e-5

# the kernel's constants (paged_attention_mq.cu): rows a block, tokens a
# warp share, warps a block up to head_dim 64
KERNEL = dict(warps=16, share=16, tile=16)
# a layout that cuts a small problem into many shares, steps and tiles
SPLIT = dict(warps=3, share=4, tile=8)
SMEM_MAX = 232448   # bytes a block may opt into on the card


def _bf16(x: np.ndarray) -> np.ndarray:
    return torch.from_numpy(x).bfloat16().float().numpy()


def _lengths(q_len, page=PAGE):
    """q_len and q_len + 1, a page boundary past them and its neighbours,
    and a full block-table row; returns (lengths, windows)."""
    edge = page * -(-(q_len + 2) // page)
    windows = edge // page + 2
    lens = sorted({q_len, q_len + 1, edge - 1, edge, edge + 1,
                   windows * page})
    return tuple(lens), windows


def _inputs(lengths, q_len, *, windows, page=PAGE, heads=HEADS,
            head_dim=HEAD_DIM, seed=0):
    """Noise-filled pools (the null page 0 too), each sequence's pages in
    a permuted order, block-table tails on page 0, one sequence a length;
    q [batch, q_len, heads, head_dim]."""
    rng = np.random.default_rng(seed)
    need = [-(-max(n, 0) // page) for n in lengths]
    num_pages = 1 + sum(need) + 2
    shape = (num_pages, page, heads, head_dim)
    kp = rng.standard_normal(shape).astype(F32)
    vp = rng.standard_normal(shape).astype(F32)
    order = list(rng.permutation(np.arange(1, num_pages)))
    bt = np.zeros((len(lengths), windows), np.int32)
    for b, n in enumerate(need):
        bt[b, :n] = [order.pop() for _ in range(n)]
    q = rng.standard_normal((len(lengths), q_len, heads, head_dim)).astype(F32)
    return q, kp, vp, bt, np.asarray(lengths, np.int32)


def _pieces(x: np.ndarray):
    """x as bf16 pieces hi + mid + lo (exact for float32 x)."""
    hi = _bf16(x)
    mid = _bf16((x - hi).astype(F32))
    lo = _bf16((x - hi - mid).astype(F32))
    return hi, mid, lo


def emulate(q, kp, vp, bt, lengths, scale, ks=None, vs=None, *, warps,
            share, tile):
    """float32 emulation of ``paged_mq_mma_kernel``: one block per (b, h,
    tile of ``tile`` rows), ``warps`` warps taking shares of ``share``
    tokens. Returns [batch, q_len, heads, head_dim] float32."""
    batch, q_len, heads, d = q.shape
    page = kp.shape[1]
    tokens = bt.shape[1] * page
    out = np.zeros(q.shape, F32)
    for b in range(batch):
        n_len = int(lengths[b])
        for h in range(heads):
            for r0 in range(0, q_len, tile):
                rows = min(tile, q_len - r0)
                n = min(n_len - (q_len - 1) + r0 + rows - 1, tokens)
                busy = min(warps, -(-n // share)) if n > 0 else 0
                tok = np.arange(max(n, 0))
                pg, off = bt[b, tok // page], tok % page
                k = kp[pg, off, h].astype(F32)
                v = vp[pg, off, h].astype(F32)
                qt = _pieces(q[b, r0:r0 + rows, h].astype(F32))  # [rows, d]
                lim = np.minimum(n_len - (q_len - 1) + r0 + np.arange(rows),
                                 n)
                states = []
                for w in range(busy):
                    m = np.full(rows, NEG_MIN, F32)
                    l = np.zeros(rows, F32)
                    acc = np.zeros((rows, d), F32)
                    for base in range(w * share, n, warps * share):
                        j = np.arange(base, min(base + share, n))
                        s = qt[0] @ k[j].T             # hi, mid, lo
                        s = (s + qt[1] @ k[j].T).astype(F32)
                        s = (s + qt[2] @ k[j].T).astype(F32)
                        if ks is not None:
                            s = s * ks[pg[j], off[j], h]
                        s = (s * F32(scale)).astype(F32)
                        valid = j[None, :] < lim[:, None]
                        s = np.where(valid, s, NEG_MIN)
                        m_new = np.maximum(m, s.max(axis=1))
                        alpha = np.exp(m - m_new)
                        p = np.where(valid, np.exp(s - m_new[:, None]),
                                     F32(0)).astype(F32)
                        l = (l * alpha + p.sum(axis=1)).astype(F32)
                        if vs is not None:
                            p = (p * vs[pg[j], off[j], h]).astype(F32)
                        acc = (acc * alpha[:, None]).astype(F32)
                        for piece in _pieces(p):       # hi, mid, lo
                            acc = (acc + piece @ v[j]).astype(F32)
                        m = m_new
                    states.append((m, l, acc))
                lsum = np.zeros(rows, F32)
                a = np.zeros((rows, d), F32)
                if states:
                    mx = np.max([st[0] for st in states], axis=0)
                    for m, l, acc in states:                # in warp order
                        wt = np.exp(m - mx)
                        lsum = (lsum + l * wt).astype(F32)
                        a = (a + acc * wt[:, None]).astype(F32)
                out[b, r0:r0 + rows, h] = a / np.where(lsum > 0, lsum,
                                                       F32(1))[:, None]
    return out


def kernel_config(head_dim, kv_itemsize, q_itemsize=2, aligned=True):
    """The launcher's choice for bf16 (``kv_itemsize`` 2) or int8 (1)
    pools: tile width ``dp`` (head_dim rounded up to a power of two, at
    least 32), warps a block, 16-byte cp.async staging when a row is a
    multiple of 16 bytes in aligned pools (else scalar loads), and the
    block's shared memory in bytes (q in one bf16 piece, three for float32
    q; each warp's two stages of K and V, for int8 also the int8 rows and
    the scales; the merge's m, l and weights)."""
    dp = max(32, 1 << (head_dim - 1).bit_length())
    warps = 16 if dp <= 64 else 8 if dp == 128 else 4
    vec = aligned and head_dim % (16 // kv_itemsize) == 0
    ld = dp + 8
    tile = 16 * ld                                   # bf16 elements
    if kv_itemsize == 1:
        warp_bytes = 2 * 2 * 16 * dp + 2 * tile * 2 + 2 * 2 * 16 * 4
    else:
        warp_bytes = 2 * 2 * tile * 2
    pieces = 3 if q_itemsize == 4 else 1
    smem = pieces * 16 * ld * 2 + 3 * warps * 16 * 4 + warps * warp_bytes
    return dict(dp=dp, warps=warps, vec=vec, smem=smem, warp_bytes=warp_bytes)


@functools.cache
def _jax_outputs(kind, q_dtype, q_len, lengths=None, windows=None,
                 head_dim=HEAD_DIM, page=PAGE):
    """(inputs, JAX reference, JAX Pallas in interpret mode) for float
    pools (``kind`` "float": bf16-valued inputs given to JAX as float32
    when ``q_dtype`` is bfloat16, so both sides compute in float32) or
    int8 pools (``quantize_kv`` of the same noise; q in ``q_dtype``)."""
    if lengths is None:
        lengths, windows = _lengths(q_len, page)
    q, kp, vp, bt, lengths = _inputs(lengths, q_len, windows=windows,
                                     page=page, head_dim=head_dim,
                                     seed=q_len)
    scale = head_dim ** -0.5
    if q_dtype == "bfloat16":
        q = _bf16(q)
    if kind == "float":
        if q_dtype == "bfloat16":
            kp, vp = _bf16(kp), _bf16(vp)
        args, kw, inp = (kp, vp), {}, dict(kp=kp, vp=vp)
    else:
        (kq, ks), (vq, vs) = (quant.quantize_kv(torch.from_numpy(x))
                              for x in (kp, vp))
        kq, ks, vq, vs = (t.numpy() for t in (kq, ks, vq, vs))
        args = (kq, vq)
        kw = dict(k_scales=jnp.asarray(ks), v_scales=jnp.asarray(vs))
        inp = dict(kp=kq, vp=vq, ks=ks, vs=vs)
    jq = jnp.asarray(q).astype(getattr(jnp, q_dtype) if kind == "int8"
                               else jnp.float32)
    jargs = [jnp.asarray(a) for a in (*args, bt, lengths)]
    ref = jax_pa.paged_attention(jq, *jargs, scale=scale, impl="reference",
                                 **kw)
    with tpu_interpret_mode():
        pal = jax_pa.paged_attention(jq, *jargs, scale=scale, impl="pallas",
                                     **kw)
    inp.update(q=q, bt=bt, lengths=lengths, scale=scale)
    return inp, np.asarray(ref, F32), np.asarray(pal, F32)


def _emulate(inp, **cfg):
    return emulate(inp["q"], inp["kp"], inp["vp"], inp["bt"],
                   inp["lengths"], inp["scale"], inp.get("ks"),
                   inp.get("vs"), **cfg)


def _plain(inp):
    """The port's plain version, the kernel's oracle on the card."""
    tensors = [torch.from_numpy(inp[k]) for k in ("q", "kp", "vp", "bt",
                                                  "lengths")]
    kw = {}
    if "ks" in inp:
        kw = dict(k_scales=torch.from_numpy(inp["ks"]),
                  v_scales=torch.from_numpy(inp["vs"]))
    return paged_attention(*tensors, scale=inp["scale"], **kw).numpy()


CONFIGS = {"kernel": KERNEL, "split": SPLIT}


@pytest.mark.parametrize("cfg", sorted(CONFIGS))
@pytest.mark.parametrize("q_len", Q_LENS)
@pytest.mark.parametrize("q_dtype", ["float32", "bfloat16"])
def test_emulation_float_pools_matches_jax(q_dtype, q_len, cfg):
    inp, ref, pal = _jax_outputs("float", q_dtype, q_len)
    got = _emulate(inp, **CONFIGS[cfg])
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(got, pal, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(got, _plain(inp), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("cfg", sorted(CONFIGS))
@pytest.mark.parametrize("q_len", Q_LENS)
@pytest.mark.parametrize("q_dtype", ["float32", "bfloat16"])
def test_emulation_int8_pools_matches_jax(q_dtype, q_len, cfg):
    inp, ref, pal = _jax_outputs("int8", q_dtype, q_len)
    got = _emulate(inp, **CONFIGS[cfg])
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(got, pal, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(got, _plain(inp), atol=TOL, rtol=TOL)


# the kernel's own layout at head_dim 64 and pages of 16: the verify shape
# (5 rows over the serve contexts + 5) and chunks of 32 rows at lengths
# 32-160 (two row tiles, up to 10 busy warps)
SERVE_SHAPES = {
    "verify": (5, (22, 38, 53, 70, 95, 125, 145, 157), 13),
    "chunk": (32, (32, 64, 96, 128, 160), 12),
}


@pytest.mark.parametrize("shape", sorted(SERVE_SHAPES))
@pytest.mark.parametrize("kind,q_dtype", [("float", "bfloat16"),
                                          ("int8", "bfloat16"),
                                          ("int8", "float32")])
def test_kernel_layout_at_serve_shapes_matches_jax(kind, q_dtype, shape):
    q_len, lengths, windows = SERVE_SHAPES[shape]
    inp, ref, pal = _jax_outputs(kind, q_dtype, q_len, lengths, windows,
                                 64, 16)
    got = _emulate(inp, **KERNEL)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(got, pal, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("q_len,length", [(32, 40), (17, 20), (64, 70)])
def test_shares_past_early_rows_leave_them_alone(q_len, length):
    """Early rows of a chunk see few tokens: with 16 warps, the shares of
    warps 1.. lie wholly past their horizons and leave those rows at
    (finfo.min, 0, 0). No NaN anywhere, and every row whose horizon ends
    inside the first share equals the one-warp emulation bit for bit (an
    empty state weighs exp(finfo.min - m) = 0 exactly)."""
    q, kp, vp, bt, lens = _inputs((length,), q_len, windows=-(-length // 4))
    scale = HEAD_DIM ** -0.5
    many = emulate(q, kp, vp, bt, lens, scale, **KERNEL)
    one = emulate(q, kp, vp, bt, lens, scale, **dict(KERNEL, warps=1))
    assert np.isfinite(many).all()
    horizon = length - (q_len - 1) + np.arange(q_len)
    first = horizon <= KERNEL["share"]
    assert first.any() and not first.all()
    np.testing.assert_array_equal(many[:, first], one[:, first])
    np.testing.assert_allclose(many, one, atol=TOL, rtol=TOL)
    want = paged_attention(*(torch.from_numpy(a) for a in (q, kp, vp, bt,
                                                           lens)),
                           scale=scale).numpy()
    np.testing.assert_allclose(many, want, atol=TOL, rtol=TOL)


def test_rows_before_the_first_token_give_zeros():
    """lengths below q_len (outside the engine's contract): a row whose
    horizon is at or before token 0 gives zeros, as the TPU kernel's l > 0
    select does, and the rest match it; a length of 0 gives all zeros."""
    q_len, lengths = 5, (0, 1, 3, 4, 5)
    inp, _, pal = _jax_outputs("float", "float32", q_len, lengths, 2)
    got = _emulate(inp, **KERNEL)
    assert np.isfinite(got).all()
    horizon = np.asarray(lengths)[:, None] - (q_len - 1) + np.arange(q_len)
    assert (horizon <= 0).any()
    np.testing.assert_array_equal(got[horizon <= 0], 0)
    np.testing.assert_allclose(got, pal, atol=TOL, rtol=TOL)


def test_kernel_config_covers_every_head_dim():
    # the main path: bf16 and int8 pools at head_dim 64, 16 warps,
    # 16-byte copies; rows no multiple of 16 bytes take scalar loads
    for itemsize in (1, 2):
        cfg = kernel_config(64, itemsize)
        assert (cfg["dp"], cfg["warps"], cfg["vec"]) == (64, 16, True)
    assert kernel_config(96, 1)["vec"] and kernel_config(96, 1)["dp"] == 128
    assert kernel_config(40, 2)["vec"] and not kernel_config(40, 1)["vec"]
    for itemsize in (1, 2):
        assert not kernel_config(50, itemsize)["vec"]
        assert not kernel_config(64, itemsize, aligned=False)["vec"]
    assert kernel_config(256, 2)["warps"] == 4
    assert kernel_config(128, 2)["warps"] == 8
    for d in range(1, 257):
        for kv, qs in ((2, 2), (1, 2), (1, 4)):
            cfg = kernel_config(d, kv, qs)
            dp = cfg["dp"]
            assert dp >= max(d, 32) and dp & (dp - 1) == 0 and dp < 2 * max(
                d, 32)
            assert cfg["smem"] <= SMEM_MAX
            # the merge's [16][dp + 4] float32 acc fits a warp's region
            assert cfg["warp_bytes"] >= 16 * (dp + 4) * 4
            # 16-byte copies cover whole rows
            assert not cfg["vec"] or (d * kv) % 16 == 0
    # row tiles: ceil(q_len / 16) blocks a (sequence, head), 17 and 33
    # rows spanning a tile boundary
    tiles = [-(-q // KERNEL["tile"]) for q in (1, 5, 16, 17, 32, 33, 128)]
    assert tiles == [1, 1, 1, 2, 2, 3, 8]
