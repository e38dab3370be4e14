"""The order of the port's single-query paged decode kernel
(``csrc/paged_attention.cu``, ``paged_decode_kernel``) emulated in float32
on the CPU, against the JAX package's paged attention (the Pallas kernel
in interpret mode and the reference) on the same numpy inputs.

The kernel splits each (sequence, head)'s tokens across the warps of a
block and, inside a warp, across groups of ``group`` lanes that lie along
head_dim, ``vec`` columns a lane load; every group runs its own online
softmax, the groups of a warp merge by xor-shuffles and the warps in warp
order. The emulation follows that order step by step (per-lane partial
dot products summed over the group by a butterfly, per-group (m, l, acc),
the fixed-order merges), with the number of warps, the group width, the
columns a load and the tokens a group takes a step as parameters. The
CUDA kernel itself runs only on the card (``chip_smoke.py``)."""

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
NEG_INF = F32(-np.inf)
# lengths: 1; a page boundary (4) and +-1 around it; 8 and 9; a full
# block-table row (W x P = 24)
PAGE, WINDOWS, HEADS, HEAD_DIM = 4, 6, 2, 16
LENGTHS = (1, 3, 4, 5, 8, 9, 24)
TOL = 1e-5


def _bf16(x: np.ndarray) -> np.ndarray:
    return torch.from_numpy(x).bfloat16().float().numpy()


def _inputs(lengths=LENGTHS, *, page=PAGE, windows=WINDOWS, heads=HEADS,
            head_dim=HEAD_DIM, seed=0):
    """Noise-filled pools (the null page 0 too), each sequence's pages in
    a permuted order, block-table tails on page 0, one sequence a length."""
    rng = np.random.default_rng(seed)
    need = [-(-n // page) for n in lengths]
    num_pages = 1 + sum(need) + 2
    shape = (num_pages, page, heads, head_dim)
    kp = rng.standard_normal(shape).astype(F32)
    vp = rng.standard_normal(shape).astype(F32)
    order = list(rng.permutation(np.arange(1, num_pages)))
    bt = np.zeros((len(lengths), windows), np.int32)
    for b, n in enumerate(need):
        bt[b, :n] = [order.pop() for _ in range(n)]
    q = rng.standard_normal((len(lengths), heads, head_dim)).astype(F32)
    return q, kp, vp, bt, np.asarray(lengths, np.int32)


def _merge(a, b):
    """Two online-softmax states (m, l, acc): an empty state (-inf, 0, 0)
    weighs an exact 0, and (-inf) - (-inf) is never formed."""
    (ma, la, aa), (mb, lb, ab) = a, b
    mn = max(ma, mb)
    wa = F32(0) if ma == NEG_INF else np.exp(F32(ma - mn))
    wb = F32(0) if mb == NEG_INF else np.exp(F32(mb - mn))
    return mn, F32(la * wa + lb * wb), (aa * wa + ab * wb).astype(F32)


def emulate(q, kp, vp, bt, lengths, scale, ks=None, vs=None, *, warps,
            group, vec, loads=4):
    """float32 emulation of ``paged_decode_kernel<..., vec, group, nv>``
    with ``warps`` warps a block and ``loads`` K loads a lane a step.
    int8 pools (``ks``/``vs`` given): a score is (sum q k) * ks * scale,
    a V row weighs p * vs. Returns [batch, heads, head_dim] float32."""
    batch, heads, d = q.shape
    page = kp.shape[1]
    nv = -(-d // (group * vec))
    tpw = 32 // group                  # tokens a warp load
    unroll = max(1, loads // nv)       # tokens a group takes a step
    warp_tok, block_tok = unroll * tpw, warps * unroll * tpw
    # columns of lane lg: (j * group + lg) * vec + e, those < d
    cols = [[(j * group + lg) * vec + e for j in range(nv)
             for e in range(vec) if (j * group + lg) * vec + e < d]
            for lg in range(group)]
    out = np.zeros((batch, heads, d), F32)
    for b in range(batch):
        n = min(int(lengths[b]), bt.shape[1] * page)
        tok = np.arange(n)
        pg, off = bt[b, tok // page], tok % page
        for h in range(heads):
            k = kp[pg, off, h].astype(F32)          # [n, d]
            v = vp[pg, off, h].astype(F32)
            qh = q[b, h].astype(F32)
            part = np.zeros((n, group), F32)
            for lg in range(group):
                for c in cols[lg]:
                    part[:, lg] = part[:, lg] + qh[c] * k[:, c]
            o = group // 2
            while o:                               # the group's butterfly
                part = part + part[:, np.arange(group) ^ o]
                o //= 2
            s = part[:, 0]
            if ks is not None:
                s = s * ks[pg, off, h]
            s = (s * F32(scale)).astype(F32)
            states = []
            for w in range(warps):
                groups = []
                for g in range(tpw):
                    m, l, acc = NEG_INF, F32(0), np.zeros(d, F32)
                    for base in range(w * warp_tok, n, block_tok):
                        ts = [t for t in (base + u * tpw + g
                                          for u in range(unroll)) if t < n]
                        m_new = max([m] + [s[t] for t in ts])
                        if m_new == NEG_INF:
                            continue
                        alpha = np.exp(F32(m - m_new))
                        l, acc = F32(l * alpha), (acc * alpha).astype(F32)
                        for t in ts:
                            p = np.exp(F32(s[t] - m_new))
                            l = F32(l + p)
                            pv = p if vs is None else F32(p * vs[pg[t],
                                                                 off[t], h])
                            acc = (acc + pv * v[t]).astype(F32)
                        m = m_new
                    groups.append((m, l, acc))
                o = 1
                while o < tpw:                     # the warp's butterfly
                    groups = [_merge(groups[g], groups[g ^ o])
                              for g in range(tpw)]
                    o *= 2
                states.append(groups[0])
            mx = max(st[0] for st in states)       # warps, in warp order
            lsum, a = F32(0), np.zeros(d, F32)
            for m, l, acc in states:
                wt = F32(0) if m == NEG_INF else np.exp(F32(m - mx))
                lsum = F32(lsum + l * wt)
                a = (a + acc * wt).astype(F32)
            out[b, h] = a * (F32(1) / lsum) if lsum > 0 else 0
    return out


# the kernel's constants: warps a block (one block a (sequence, head)), K
# loads a lane a step
KERNEL_WARPS, KERNEL_LOADS = 16, 4


def kernel_config(head_dim, itemsize, aligned=True):
    """The (vec, group) the kernel's launcher picks: 16-byte loads with
    the row's 16-byte pieces rounded up to a power of 2 of lanes (at most
    32, two loads a lane past that), or scalar loads on 32 lanes when a
    row is no multiple of 16 bytes."""
    vec = 16 // itemsize
    if head_dim % vec or not aligned:
        return dict(vec=1, group=32)
    n = head_dim // vec
    return dict(vec=vec, group=min(32, 1 << (n - 1).bit_length()))


@functools.cache
def _jax_outputs(kind, q_dtype, lengths=LENGTHS, head_dim=HEAD_DIM,
                 page=PAGE, windows=WINDOWS):
    """(inputs, JAX reference, JAX Pallas in interpret mode) for float
    pools (``kind`` "float": bf16-valued inputs given to JAX as float32
    when ``q_dtype`` is bfloat16, so both sides compute in float32) or
    int8 pools (``quantize_kv`` of the same noise; q in ``q_dtype``)."""
    q, kp, vp, bt, lengths = _inputs(lengths, page=page, windows=windows,
                                     head_dim=head_dim)
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


# (warps, group, vec, loads): the scalar-load layout on one warp; 16-byte
# layouts of float32 (4 columns a load) and bf16 (8) over several warps,
# with few loads a step so that the 24-token row spreads over the warps
FLOAT_CONFIGS = (
    dict(warps=1, group=32, vec=1, loads=8),
    dict(warps=4, group=4, vec=4, loads=1),
    dict(warps=8, group=2, vec=8, loads=1),
    dict(warps=3, group=8, vec=2, loads=2),
)
# int8 (16 columns a load: one lane a row of 16) and two other splits
INT8_CONFIGS = (
    dict(warps=8, group=1, vec=16, loads=1),
    dict(warps=4, group=4, vec=4, loads=1),
    dict(warps=1, group=32, vec=1, loads=8),
)


@pytest.mark.parametrize("q_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cfg", FLOAT_CONFIGS,
                         ids=lambda c: "w{warps}g{group}v{vec}u{loads}"
                         .format(**c))
def test_emulation_float_pools_matches_jax(cfg, q_dtype):
    inp, ref, pal = _jax_outputs("float", q_dtype)
    got = _emulate(inp, **cfg)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(got, pal, atol=TOL, rtol=TOL)
    # and the port's plain version, the kernel's oracle on the card
    plain = paged_attention(
        *(torch.from_numpy(inp[k]) for k in ("q", "kp", "vp", "bt",
                                             "lengths")),
        scale=inp["scale"]).numpy()
    np.testing.assert_allclose(got, plain, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("q_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cfg", INT8_CONFIGS,
                         ids=lambda c: "w{warps}g{group}v{vec}u{loads}"
                         .format(**c))
def test_emulation_int8_pools_matches_jax(cfg, q_dtype):
    inp, ref, pal = _jax_outputs("int8", q_dtype)
    got = _emulate(inp, **cfg)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(got, pal, atol=TOL, rtol=TOL)


# the kernel's own layout (16 warps, 4 loads a lane a step) at head_dim
# 64 and pages of 16, over rows of 160 and 768 tokens, so that the longest
# rows reach past the first warps and take several steps; bf16 and
# float32 float pools, int8 pools
KERNEL_ROWS = {10: (1, 15, 16, 17, 40, 100, 152, 160), 48: (1, 300, 700)}


@pytest.mark.parametrize("windows", sorted(KERNEL_ROWS))
@pytest.mark.parametrize("kind,itemsize", [("float", 2), ("float", 4),
                                           ("int8", 1)])
def test_kernel_layout_at_head_dim_64_matches_jax(kind, itemsize, windows):
    q_dtype = "bfloat16" if itemsize == 2 else "float32"
    inp, ref, pal = _jax_outputs(kind, q_dtype, KERNEL_ROWS[windows], 64,
                                 16, windows)
    got = _emulate(inp, warps=KERNEL_WARPS, loads=KERNEL_LOADS,
                   **kernel_config(64, itemsize))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(got, pal, atol=TOL, rtol=TOL)


def test_kernel_config_covers_every_head_dim():
    # 16-byte loads whenever a row is a multiple of 16 bytes, one to two
    # loads a lane; scalar loads otherwise (head_dim 50 in every dtype)
    assert kernel_config(64, 2) == dict(vec=8, group=8)
    assert kernel_config(64, 1) == dict(vec=16, group=4)
    assert kernel_config(96, 2) == dict(vec=8, group=16)
    assert kernel_config(256, 4) == dict(vec=4, group=32)   # two loads
    assert kernel_config(8, 2) == dict(vec=8, group=1)
    for itemsize in (1, 2, 4):
        assert kernel_config(50, itemsize) == dict(vec=1, group=32)
        assert kernel_config(64, itemsize, aligned=False)["vec"] == 1
    for d in range(1, 257):
        for itemsize in (1, 2, 4):
            cfg = kernel_config(d, itemsize)
            nv = -(-d // (cfg["group"] * cfg["vec"]))
            assert 1 <= nv <= 8 and (cfg["vec"] == 1 or nv <= 2)


@pytest.mark.parametrize("cfg", [dict(group=8, vec=2), dict(group=4, vec=16)],
                         ids=["g8v2", "g4v16"])
def test_empty_warps_add_nothing(cfg):
    """Lengths that reach warp 0 only (<= its loads x tokens a load) and a
    length-0 row: the kernel's 16-warp result has no NaN and equals the
    one-warp emulation bit for bit (an empty warp weighs an exact 0), and
    the length-0 row gives zeros, the TPU kernel's l > 0 select."""
    lengths = (0, 1, 2, 3, 5, 8)
    q, kp, vp, bt, lens = _inputs(lengths, windows=2)
    scale = HEAD_DIM ** -0.5
    many = emulate(q, kp, vp, bt, lens, scale, warps=KERNEL_WARPS, **cfg)
    one = emulate(q, kp, vp, bt, lens, scale, warps=1, **cfg)
    assert np.isfinite(many).all()
    np.testing.assert_array_equal(many, one)
    np.testing.assert_array_equal(many[0], 0)
    want = paged_attention(*(torch.from_numpy(a) for a in (q, kp, vp, bt,
                                                           lens)),
                           scale=scale).numpy()
    np.testing.assert_allclose(many[1:], want[1:], atol=TOL, rtol=TOL)
