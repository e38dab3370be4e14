"""The order of the port's dropout-add-LayerNorm kernels
(``csrc/dropout_add_layer_norm.cu``: the forward, and the backward's dx
pass and column pass) emulated in float32 on the CPU, against the port's
plain versions and the JAX package's ``dropout_add_layer_norm`` (the
Pallas kernels in interpret mode) on the same numpy inputs.

The kernels take the LayerNorm kernels' row mapping and launch plan
(``_row_plan``; ``tests/test_torch_layer_norm.py`` emulates its sums).
What they add is the mask: a thread draws the Philox groups of its
chunks, two for a chunk of 8 bf16, one for a chunk of 4 float32 (a chunk
starts on a flat index that is a multiple of its length), and one for
each element on the scalar path. s = x + keep * h / (1 - rate) is a
rounded product, then a rounded sum; the statistics are taken on the
float32 s in the forward and on the stored (rounded) s in the backward;
dh = keep * ds / (1 - rate) from the float32 ds. The CUDA kernels
themselves run only on the card (``chip_smoke.py``)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_training_tpu.ops import layer_norm as jax_ln
from pytorch_distributed_training_tpu.ops.flash_attention import (
    tpu_interpret_mode,
)
from pytorch_distributed_training_tpu_torch.ops import dropout as port_dropout
from pytorch_distributed_training_tpu_torch.ops import layer_norm as port_ln
from test_torch_layer_norm import (
    EPS,
    F32,
    PARAM_SUM_SLACK,
    _bf16,
    _chunk_index,
    _fma,
    _stats,
    _vec_of,
    emulate_bwd,
)

torch.set_num_threads(2)

# the presets' widths (64 tiny, 768 bert-base, 1024 large), the widest row
# and one that is no multiple of 8 (scalar chunks)
WIDTHS = (64, 768, 1024, 2048, 1001)
# below the few-rows threshold, above it, and the training tail's 8 x 128
ROWS = (8, 300, 1024)
RATES = (0.0, 0.1)
SEED, SITE = 1234, 1
_M32 = 0xFFFFFFFF


def _words(groups, seed, site):
    """Philox4x32-10 words of each group index: [..., 4] int64."""
    g = torch.from_numpy(np.ascontiguousarray(groups).reshape(-1))
    zero = torch.zeros_like(g)
    words = port_dropout.philox4x32_10(g & _M32, g >> 32, zero, zero,
                                       seed, site)
    return torch.stack(words, dim=-1).numpy().reshape(groups.shape + (4,))


def emulate_mask(rows, h, vec, rate, seed, site):
    """The keep mask as the kernels draw it: chunk k of row r starts on
    flat index i0 = r * h + k * vec; with vec 4 or 8 it is groups
    i0 / 4 + g (g < vec / 4), element 4 g + e taking word e; a single
    element i takes word i % 4 of group i / 4."""
    threshold = port_dropout.mask_threshold(rate)
    if vec == 1:
        i = np.arange(rows * h, dtype=np.int64).reshape(rows, h)
        words = _words(i >> 2, seed, site)
        bits = np.take_along_axis(words, (i & 3)[..., None], -1)[..., 0]
        return bits >= threshold
    n = h // vec
    i0 = (np.arange(rows, dtype=np.int64)[:, None] * h
          + np.arange(n, dtype=np.int64)[None, :] * vec)
    assert np.all(i0 % vec == 0)
    keep = np.zeros((rows, n, vec), bool)
    for g in range(vec // 4):
        keep[..., 4 * g:4 * g + 4] = _words((i0 >> 2) + g, seed,
                                            site) >= threshold
    return keep.reshape(rows, h)


def _keep_scale(rate):
    return F32(1.0 / (1.0 - rate))


def emulate_fwd(h, x, scale, bias, keep, *, rate, vec, wpr):
    """``dal_fwd_kernel`` in float32: (y before the output cast, float32
    s before it is stored)."""
    hf = h
    if rate > 0.0:
        hf = np.where(keep, (h * _keep_scale(rate)).astype(F32), F32(0))
    s = (x + hf).astype(F32)
    width = s.shape[1]
    c, rstd = _stats(s, _chunk_index(width, vec, wpr), wpr, width)
    return _fma((c * rstd).astype(F32), scale[None], bias[None]), s


def emulate_dal_bwd(s, dy, scale, keep, *, rate, vec, wpr):
    """The dx pass then the column pass in float32: (dh, dx, dscale,
    dbias); kernel 2's order on the stored s, then the mask on ds."""
    dx, dscale, dbias = emulate_bwd(s, dy, scale, vec=vec, wpr=wpr)
    dh = dx
    if rate > 0.0:
        dh = np.where(keep, (dx * _keep_scale(rate)).astype(F32), F32(0))
    return dh, dx, dscale, dbias


@functools.lru_cache(maxsize=None)
def _case(rows, h, path, rate):
    """Inputs (bf16-rounded on the bf16 path, as float32 arrays), the
    emulated and the generator's mask, and the plain forward's (y, s)."""
    rng = np.random.default_rng(rows * 7 + h)
    hh = rng.standard_normal((rows, h)).astype(F32)
    x = (1.0 + rng.standard_normal((rows, h))).astype(F32)
    dy = rng.standard_normal((rows, h)).astype(F32)
    scale = (1.0 + 0.1 * rng.standard_normal(h)).astype(F32)
    bias = (0.1 * rng.standard_normal(h)).astype(F32)
    dtype = torch.bfloat16 if path == "bf16" else torch.float32
    if path == "bf16":
        hh, x, dy = _bf16(hh), _bf16(x), _bf16(dy)
    vec = _vec_of(path, h)
    keep = want_keep = np.ones((rows, h), bool)
    if rate > 0.0:
        keep = emulate_mask(rows, h, vec, rate, SEED, SITE)
        want_keep = port_dropout.keep_mask((rows, h), rate, SEED,
                                           SITE).numpy()
    t = {k: torch.from_numpy(a) for k, a in
         dict(h=hh, x=x, scale=scale, bias=bias).items()}
    y, s = port_ln.reference_dal_fwd(
        t["h"].to(dtype), t["x"].to(dtype), t["scale"], t["bias"],
        rate=rate, seed=SEED, site=SITE, eps=EPS, out_dtype=torch.float32)
    return dict(h=hh, x=x, dy=dy, scale=scale, bias=bias, vec=vec,
                keep=keep, want_keep=want_keep, y=y.numpy(),
                s=s.float().numpy(), dtype=dtype)


@pytest.mark.parametrize("rate", RATES)
@pytest.mark.parametrize("rows", ROWS)
@pytest.mark.parametrize("path", ["bf16", "f32", "scalar"])
@pytest.mark.parametrize("h", WIDTHS)
def test_forward_order_matches_plain_version(h, path, rows, rate):
    c = _case(rows, h, path, rate)
    assert np.array_equal(c["keep"], c["want_keep"])
    wpr, _ = port_ln._row_plan(rows, h, c["vec"])
    y, s = emulate_fwd(c["h"], c["x"], c["scale"], c["bias"], c["keep"],
                       rate=rate, vec=c["vec"], wpr=wpr)
    # s as stored (h's dtype): bit for bit the plain version's
    stored = torch.from_numpy(s).to(c["dtype"]).float().numpy()
    assert np.array_equal(stored.view(np.uint32), c["s"].view(np.uint32))
    np.testing.assert_allclose(y, c["y"], rtol=0, atol=1e-5)


@pytest.mark.parametrize("rate", RATES)
@pytest.mark.parametrize("rows", ROWS)
@pytest.mark.parametrize("path", ["bf16", "f32", "scalar"])
@pytest.mark.parametrize("h", WIDTHS)
def test_backward_order_matches_plain_version(h, path, rows, rate):
    c = _case(rows, h, path, rate)
    wpr, _ = port_ln._row_plan(rows, h, c["vec"])
    dh, dx, dscale, dbias = emulate_dal_bwd(
        c["s"], c["dy"], c["scale"], c["keep"], rate=rate, vec=c["vec"],
        wpr=wpr)
    # the plain backward on the same values in float32 (the stored s and
    # dy are bf16 values on the bf16 path), so nothing is rounded after
    want = port_ln.reference_dal_bwd(
        torch.from_numpy(c["s"]), torch.from_numpy(c["dy"]),
        torch.from_numpy(c["scale"]), rate=rate, seed=SEED, site=SITE,
        eps=EPS)
    np.testing.assert_allclose(dh, want[0].numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(dx, want[1].numpy(), rtol=1e-5, atol=1e-5)
    if rate > 0.0:
        assert not c["keep"].all()
        assert np.all(dh[~c["keep"]] == 0) and np.all(
            want[0].numpy()[~c["keep"]] == 0)
    _, _, xhat = port_ln._ln_stats(torch.from_numpy(c["s"]), EPS)
    dyf = c["dy"]
    terms = (np.abs(dyf * xhat.numpy()).sum(0), np.abs(dyf).sum(0))
    for got, w, t in zip((dscale, dbias), want[2:], terms):
        err = np.abs(got - w.numpy())
        assert np.all(err <= PARAM_SUM_SLACK * t), float((err / t).max())


def test_order_matches_jax_pallas_interpret():
    # rows 64, H 256, rate 0: the Pallas _dal_fwd and _dal_bwd run
    # (interpreted); both of the port's plans of the rows, float32 chunks
    # and single elements
    rng = np.random.default_rng(4)
    shape = (64, 256)
    h = rng.standard_normal(shape).astype(F32)
    x = (1.0 + rng.standard_normal(shape)).astype(F32)
    scale = (1.0 + 0.1 * rng.standard_normal(256)).astype(F32)
    bias = (0.1 * rng.standard_normal(256)).astype(F32)
    dy = rng.standard_normal(shape).astype(F32)

    def f(h, x, s, b):
        return jax_ln.dropout_add_layer_norm(
            h, x, s, b, rate=0.0, dropout_rng=jax.random.key(0),
            deterministic=False, eps=EPS, site=SITE, impl="fused",
            dropout_impl="kernel",
        )

    with tpu_interpret_mode():
        y_j, vjp = jax.vjp(f, *(jnp.asarray(a) for a in (h, x, scale, bias)))
        want = [np.asarray(g) for g in vjp(jnp.asarray(dy))]
    keep = np.ones(shape, bool)
    for vec in (1, 4):
        for rows_plan in (64, 300):
            wpr, _ = port_ln._row_plan(rows_plan, 256, vec)
            y, s = emulate_fwd(h, x, scale, bias, keep, rate=0.0, vec=vec,
                               wpr=wpr)
            np.testing.assert_allclose(y, np.asarray(y_j), rtol=0,
                                       atol=1e-5)
            got = emulate_dal_bwd(s, dy, scale, keep, rate=0.0, vec=vec,
                                  wpr=wpr)
            for g, w in zip(got[:2], want[:2]):
                np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)
            for g, w in zip(got[2:], want[2:]):
                np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-4)


def test_plan_takes_the_shape_only_and_fits_the_mask_word():
    # csrc/dropout_add_layer_norm.cu: kernel 1's plan; a thread's keep bits
    # (chunks x elements) fit one 32-bit word, its values the registers
    # (max_floats); each chunk starts on a whole Philox group; every
    # element of a row is one thread's, every row one slot's
    for h in (*WIDTHS, 1, 8, 100, 512, 1536):
        for vec in (1, 4, 8):
            if h % vec:
                continue
            for rows in (1, 8, 255, 256, 300, 1000, 1024, 4096):
                wpr, slots = port_ln._row_plan(rows, h, vec)
                assert port_ln._row_plan(rows, h, vec) == (wpr, slots)
                idx = _chunk_index(h, vec, wpr)
                cpt = idx.shape[1]
                assert cpt * vec <= (32 if vec == 8 else 16)
                assert sorted(idx[idx >= 0].tolist()) == list(range(h))
                starts = idx[:, :, 0][idx[:, :, 0] >= 0]
                assert np.all(starts % vec == 0)
                blocks = -(-rows // slots)
                assert blocks * slots >= rows > (blocks - 1) * slots
    # the training tails (8 x 128 rows), the eval forward (32 x 128)
    assert port_ln._row_plan(1024, 1024, 8) == (1, 4)
    assert port_ln._row_plan(4096, 1024, 8) == (1, 4)
