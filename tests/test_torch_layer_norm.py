"""The order of the port's LayerNorm kernels (``csrc/layer_norm.cu``:
the forward, and the backward's dx pass and column pass) emulated in
float32 on the CPU, against the port's plain versions and the JAX
package's LayerNorm (the Pallas kernels in interpret mode) on the same
numpy inputs.

A row belongs to ``wpr`` warps; thread t of the row holds chunks t,
t + 32 * wpr, ... of ``vec`` elements (16 bytes, or 1 element where rows
are not 16-byte aligned). A thread sums its values in chunk order, a warp
by xor-butterfly, the row's warps in warp order. The backward's column
pass gives each block a chunk of columns over every row: row group g of a
block sums rows g, g + groups, ... in order, then the groups of a warp
meet by xor-butterfly and the warps in warp order. The launch plan
(``_row_plan``) is the wrapper's own; the emulation takes it from it. The
CUDA kernels themselves run only on the card (``chip_smoke.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_training_tpu.ops import layer_norm as jax_ln
from pytorch_distributed_training_tpu.ops.flash_attention import (
    tpu_interpret_mode,
)
from pytorch_distributed_training_tpu_torch.ops import layer_norm as port_ln

torch.set_num_threads(2)

F32 = np.float32
EPS = 1e-5
# H: the presets' widths (64 tiny, 768 bert-base, 1024 large/medium), the
# widest row (2048), and one that is no multiple of 8 (scalar chunks)
WIDTHS = (64, 256, 768, 1024, 2048, 1001)
# row counts below and above the forward's few-rows threshold
FWD_ROWS = (8, 300)
# dscale/dbias against the plain version: |got - want| <= 2^-16 of the
# column's sum of |terms| (float32 sums over rows in another order), as
# chip_smoke.py's PARAM_SUM_SLACK
PARAM_SUM_SLACK = 2.0 ** -16


def _fma(a, b, c):
    """float32 a * b + c rounded once, as the compiler fuses it."""
    return (np.float64(1) * a * b + c).astype(F32)


def _inputs(rows, h, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((rows, h)).astype(F32)
    dy = rng.standard_normal((rows, h)).astype(F32)
    scale = (1.0 + 0.1 * rng.standard_normal(h)).astype(F32)
    bias = (0.1 * rng.standard_normal(h)).astype(F32)
    return x, dy, scale, bias


def _bf16(a):
    return torch.from_numpy(a).bfloat16().float().numpy()


def _chunk_index(h, vec, wpr):
    """[tpr, cpt, vec] element indices of a row's threads, -1 past the row."""
    tpr = 32 * wpr
    n = h // vec
    cpt = -(-n // tpr)
    k = np.arange(cpt)[None, :] * tpr + np.arange(tpr)[:, None]
    idx = k[..., None] * vec + np.arange(vec)
    return np.where((k < n)[..., None], idx, -1)


def _thread_sums(terms, idx, fused=None):
    """Each thread's sum of its values in chunk order: [rows, tpr].
    ``fused`` (a, b) sums a * b by FMA instead of the terms."""
    rows = (terms if fused is None else fused[0]).shape[0]
    acc = np.zeros((rows, idx.shape[0]), F32)
    for c in range(idx.shape[1]):
        for i in range(idx.shape[2]):
            j = idx[:, c, i]
            ok = j >= 0
            if fused is None:
                new = (acc + terms[:, j]).astype(F32)
            else:
                new = _fma(fused[0][:, j], fused[1][:, j], acc)
            acc = np.where(ok[None, :], new, acc)
    return acc


def _row_sum(acc, wpr):
    """The row's total in every thread: butterfly a warp, warps in order."""
    lanes = acc.reshape(acc.shape[0], wpr, 32)
    for o in (16, 8, 4, 2, 1):
        lanes = (lanes + lanes[..., np.arange(32) ^ o]).astype(F32)
    total = np.zeros(acc.shape[0], F32)
    for w in range(wpr):
        total = (total + lanes[:, w, 0]).astype(F32)
    return total[:, None]


def _stats(x, idx, wpr, h):
    """(centred x, rstd) of the kernels: the mean, then the centred
    variance, with 0 past the row."""
    mean = (_row_sum(_thread_sums(x, idx), wpr) / F32(h)).astype(F32)
    c = (x - mean).astype(F32)
    var = (_row_sum(_thread_sums(None, idx, fused=(c, c)),
                    wpr) / F32(h)).astype(F32)
    rstd = (F32(1) / np.sqrt((var + F32(EPS)).astype(F32))).astype(F32)
    return c, rstd


def emulate_fwd(x, scale, bias, *, vec, wpr):
    """``layer_norm_fwd_kernel`` with ``vec`` elements a chunk and ``wpr``
    warps a row, in float32 (before the output cast)."""
    h = x.shape[1]
    idx = _chunk_index(h, vec, wpr)
    assert sorted(idx[idx >= 0].tolist()) == list(range(h))
    c, rstd = _stats(x, idx, wpr, h)
    return _fma((c * rstd).astype(F32), scale[None], bias[None])


# the column pass (csrc/layer_norm.cu kColumnThreads, column_chunks): 512
# threads a block; a block two 16-byte chunks of columns, or 32 single
# columns
COLUMN_THREADS = 512


def _column_groups(vec):
    """(chunks a block, row groups a block) of the column pass."""
    cb = 2 if vec > 1 else 32
    return cb, COLUMN_THREADS // cb


def emulate_bwd(x, dy, scale, *, vec, wpr):
    """The dx pass then the column pass in float32: (dx before the cast,
    dscale, dbias)."""
    rows, h = x.shape
    idx = _chunk_index(h, vec, wpr)
    c, rstd = _stats(x, idx, wpr, h)
    xhat = (c * rstd).astype(F32)
    wdy = (dy * scale[None]).astype(F32)
    c1 = (_row_sum(_thread_sums(None, idx, fused=(wdy, xhat)), wpr)
          / F32(h)).astype(F32)
    c2 = (_row_sum(_thread_sums(wdy, idx), wpr) / F32(h)).astype(F32)
    dx = (((_fma(-xhat, c1, wdy) - c2).astype(F32)) * rstd).astype(F32)

    # column pass: group g takes rows g, g + groups, ... in order
    cb, groups = _column_groups(vec)
    ps = np.zeros((groups, h), F32)
    pb = np.zeros((groups, h), F32)
    for start in range(0, rows, groups):
        r = np.arange(start, min(rows, start + groups))
        g = r - start
        ps[g] = _fma(dy[r], xhat[r], ps[g])
        pb[g] = (pb[g] + dy[r]).astype(F32)
    sums = []
    for p in (ps, pb):
        # a warp holds 32 / cb groups: xor-butterfly over them, then the
        # warps in warp order
        lanes = p.reshape(COLUMN_THREADS // 32, 32 // cb, h)
        o = 32 // cb // 2
        while o >= 1:
            lanes = (lanes + lanes[:, np.arange(32 // cb) ^ o]).astype(F32)
            o //= 2
        total = np.zeros(h, F32)
        for w in range(lanes.shape[0]):
            total = (total + lanes[w, 0]).astype(F32)
        sums.append(total)
    return dx, sums[0], sums[1]


def _vec_of(path, h):
    """Elements a chunk of a float32 ("f32"), bfloat16 ("bf16") or
    unaligned ("scalar") input, as the wrapper's ``_vec`` picks them."""
    if path == "scalar":
        return 1
    vec = 4 if path == "f32" else 8
    return vec if h % vec == 0 else 1


# ------------------------------------------------------------------ forward


@pytest.mark.parametrize("rows", FWD_ROWS)
@pytest.mark.parametrize("path", ["bf16", "f32", "scalar"])
@pytest.mark.parametrize("h", WIDTHS)
def test_forward_order_matches_plain_version(h, path, rows):
    x, _, scale, bias = _inputs(rows, h, seed=h + rows)
    if path == "bf16":
        x = _bf16(x)
    vec = _vec_of(path, h)
    wpr, slots = port_ln._row_plan(rows, h, vec)
    got = emulate_fwd(x, scale, bias, vec=vec, wpr=wpr)
    want = port_ln.reference_layer_norm(
        torch.from_numpy(x), torch.from_numpy(scale), torch.from_numpy(bias),
        eps=EPS).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("h", [256, 1024])
def test_forward_order_matches_jax_fused_interpret(h):
    # rows 32 and H % 128 == 0: the Pallas _fwd_kernel's tiling
    x, _, scale, bias = _inputs(32, h, seed=5)
    with tpu_interpret_mode():
        want = jax_ln.layer_norm(jnp.asarray(x), jnp.asarray(scale),
                                 jnp.asarray(bias), eps=EPS, impl="fused")
    for rows_plan in FWD_ROWS:   # both mappings of the rows
        wpr, _ = port_ln._row_plan(rows_plan, h, 4)
        got = emulate_fwd(x, scale, bias, vec=4, wpr=wpr)
        np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-6)


def test_forward_plan_takes_the_shape_only_and_fits_the_kernel():
    # csrc/layer_norm.cu: a thread holds <= 32 values of 16-byte bf16
    # chunks, <= 16 else; a block <= 16 warps; a block a row (one chunk a
    # thread, up to 16 warps) below _FEW_ROWS
    for h in range(1, port_ln._MAX_H + 1, 7):
        for vec in (1, 4, 8):
            if h % vec:
                continue
            for rows in (1, 8, port_ln._FEW_ROWS - 1, port_ln._FEW_ROWS, 4096):
                wpr, slots = port_ln._row_plan(rows, h, vec)
                cpt = -(-(h // vec) // (32 * wpr))
                assert wpr in (1, 2, 4, 8, 16) and 1 <= slots * wpr <= 16
                assert cpt * vec <= (32 if vec == 8 else 16)
                if rows < port_ln._FEW_ROWS:
                    assert slots == 1
                    assert cpt == 1 or wpr == 16
    assert port_ln._row_plan(8, 1024, 8) == (4, 1)      # serve's decode tick
    assert port_ln._row_plan(4096, 1024, 8) == (1, 4)   # lm-1024


def test_forward_takes_scalar_chunks_off_16_bytes():
    x = torch.zeros(1 + 4 * 64, dtype=torch.bfloat16)[1:].view(4, 64)
    scale = torch.ones(64)
    assert port_ln._vec(64, x.dtype, x, scale) == 1
    assert port_ln._vec(64, x.dtype, x.clone(), scale) == 8
    assert port_ln._vec(1001, torch.float32, torch.zeros(2, 1001)) == 1
    assert port_ln._vec(1024, torch.float32, torch.zeros(2, 1024)) == 4
    # the plain version gives the same values from the odd-offset view
    xs = torch.randn(4, 64, generator=torch.Generator().manual_seed(0))
    x.copy_(xs)
    y = port_ln.layer_norm(x, scale, torch.zeros(64), eps=EPS)
    assert torch.equal(y, port_ln.layer_norm(x.clone(), scale,
                                             torch.zeros(64), eps=EPS))


# ----------------------------------------------------------------- backward


@pytest.mark.parametrize("rows", [1, 8, 63, 1000, 1024, 4096])
def test_backward_column_pass_takes_each_row_once(rows):
    # a column-pass block owns its columns over every row, so no partial
    # row leaves it; its row groups follow from the block alone
    for vec in (1, 4, 8):
        cb, groups = _column_groups(vec)
        assert cb * groups == COLUMN_THREADS
        group, step = np.arange(rows) % groups, np.arange(rows) // groups
        assert len(set(zip(group.tolist(), step.tolist()))) == rows
        assert np.array_equal(group + step * groups, np.arange(rows))
    # the dx pass: each row one slot's, the plan a function of the shape
    for h in (64, 1001, 1024, 2048):
        for vec in (1, 4, 8):
            if h % vec:
                continue
            wpr, slots = port_ln._row_plan(rows, h, vec)
            assert port_ln._row_plan(rows, h, vec) == (wpr, slots)
            blocks = -(-rows // slots)
            assert blocks * slots >= rows > (blocks - 1) * slots


@pytest.mark.parametrize("path", ["bf16", "f32", "scalar"])
@pytest.mark.parametrize("rows,h", [(8, 64), (64, 256), (1000, 768),
                                    (1024, 1024), (300, 1001), (4096, 256),
                                    (128, 2048)])
def test_backward_order_matches_plain_version(rows, h, path):
    x, dy, scale, _ = _inputs(rows, h, seed=rows + 3 * h)
    if path == "bf16":
        x, dy = _bf16(x), _bf16(dy)
    vec = _vec_of(path, h)
    wpr, _ = port_ln._row_plan(rows, h, vec)
    dx, dscale, dbias = emulate_bwd(x, dy, scale, vec=vec, wpr=wpr)
    want = port_ln.reference_layer_norm_bwd(
        torch.from_numpy(x), torch.from_numpy(dy), torch.from_numpy(scale),
        eps=EPS)
    np.testing.assert_allclose(dx, want[0].numpy(), rtol=1e-5, atol=1e-5)
    _, _, xhat = port_ln._ln_stats(torch.from_numpy(x), EPS)
    terms = (np.abs(dy * xhat.numpy()).sum(0), np.abs(dy).sum(0))
    for got, w, t in zip((dscale, dbias), want[1:], terms):
        err = np.abs(got - w.numpy())
        assert np.all(err <= PARAM_SUM_SLACK * t), float((err / t).max())


def test_backward_order_matches_jax_pallas_vjp_interpret():
    # rows 64 and H 256: the Pallas _bwd kernel runs (interpreted)
    x, dy, scale, bias = _inputs(64, 256, seed=3)

    def f(x, s, b):
        return jax_ln.layer_norm(x, s, b, eps=EPS, impl="fused")

    with tpu_interpret_mode():
        _, vjp = jax.vjp(f, *(jnp.asarray(a) for a in (x, scale, bias)))
        want = [np.asarray(g) for g in vjp(jnp.asarray(dy))]
    for vec in (1, 4):
        wpr, _ = port_ln._row_plan(64, 256, vec)
        got = emulate_bwd(x, dy, scale, vec=vec, wpr=wpr)
        np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=1e-5)
        for g, w in zip(got[1:], want[1:]):
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-4)
