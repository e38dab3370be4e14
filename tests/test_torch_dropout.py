"""The port's dropout (``ops/dropout.py``, ``csrc/dropout.cu``) on the CPU.

The kernel's plan is emulated here: a thread owns 16-byte chunks (8 bf16,
two whole Philox groups; 4 float32, one), each chunk starting on a flat
index that is a multiple of its length; the grid (one wave of blocks of
256 threads) walks the chunks with a grid stride, a chunk a thread an
iteration; the ragged tail, and the whole tensor when x or y is not
16-byte aligned, takes groups of four elements a thread. The emulation
must cover every element once and draw the generator's ``keep_mask`` bit
for bit. ``raw_dropout`` is one autograd Function whose backward draws the
mask again: its values and gradients are those of autograd of ``x *
reference_mask_scale(...)`` bit for bit, nothing is saved, a non-finite x
stays non-finite where dropped, and the mask-scale value and the product
agree with the JAX package's. The dropout sites of the BERT and GPT-2
models pass contiguous tensors and make the launches ``chip_smoke.py``
counts. The CUDA kernel itself runs only on the card (``chip_smoke.py``).
"""

import functools
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_training_tpu.ops import dropout as jax_dropout
from pytorch_distributed_training_tpu_torch.models.bert import (
    BertForSequenceClassification,
)
from pytorch_distributed_training_tpu_torch.models.gpt2 import GPT2LMModel
from pytorch_distributed_training_tpu_torch.ops import dropout as port_dropout
from pytorch_distributed_training_tpu_torch.utils.config import model_preset

torch.set_num_threads(2)

THREADS = 256
# grid sizes: one block, a few, and a wave of the card (132 SMs x 8
# blocks, more threads than BIG has chunks)
PLANS = (1, 3, 1056)
BIG = (8, 16, 128, 128)   # BERT-large's probs at micro 8, seq 128
SHAPES = ((1,), (7,), (8,), (9,), (4097,), (1000, 3), BIG)
DTYPES = (torch.bfloat16, torch.float32)
SEED, SITE = 4321, 2
_M32 = 0xFFFFFFFF
_INT = {torch.bfloat16: torch.int16, torch.float32: torch.int32}


@functools.lru_cache(maxsize=None)
def _words(groups, seed=SEED, site=SITE):
    """Philox4x32-10 words of groups 0 .. groups-1: int64 [groups, 4]."""
    g = torch.arange(groups, dtype=torch.int64)
    zero = torch.zeros_like(g)
    return torch.stack(port_dropout.philox4x32_10(g & _M32, g >> 32, zero,
                                                  zero, seed, site), dim=1)


def emulate_plan(n, vec, aligned, blocks):
    """(group, word) each element of [n] takes its bits from, as the
    kernel's threads walk it; asserts every element is written once."""
    stride = blocks * THREADS
    chunks = n // vec if aligned else 0
    group = np.full(n, -1, np.int64)
    word = np.full(n, -1, np.int64)
    seen = np.zeros(n, np.int64)
    t = np.arange(stride, dtype=np.int64)
    c = t.copy()
    lanes = np.arange(vec, dtype=np.int64)
    while (c < chunks).any():            # the main loop, a chunk a turn
        ck = c[c < chunks]
        i = (ck[:, None] * vec + lanes[None, :]).reshape(-1)
        # chunk ck draws groups ck * vec / 4 + g, element 4 g + e taking
        # word e
        g = (ck[:, None] * (vec // 4) + lanes[None, :] // 4).reshape(-1)
        group[i], word[i] = g, np.tile(lanes % 4, len(ck))
        np.add.at(seen, i, 1)
        c = c + stride
    groups = -(-n // 4)
    g = chunks * (vec // 4) + t
    while (g < groups).any():            # scalar groups of four
        gl = g[g < groups]
        for e in range(4):
            i = gl * 4 + e
            i = i[i < n]
            group[i], word[i] = i // 4, e
            np.add.at(seen, i, 1)
        g = g + stride
    assert (seen == 1).all(), "an element written twice or never"
    return group, word


def emulate_keep(n, vec, aligned, blocks, rate=0.1):
    group, word = emulate_plan(n, vec, aligned, blocks)
    words = _words(-(-n // 4)).numpy()
    return words[group, word] >= port_dropout.mask_threshold(rate)


def _same_bits(got, want):
    """Bit for bit, NaN where ``want`` is NaN (its payload aside)."""
    assert got.dtype == want.dtype and got.shape == want.shape
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan)
    assert torch.equal(got.masked_fill(nan, 0).view(_INT[got.dtype]),
                       want.masked_fill(nan, 0).view(_INT[want.dtype]))


def _inputs(shape, dtype, seed=0, non_finite=True):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    if non_finite:
        flat = x.view(-1)
        flat[::97] = float("nan")
        flat[1::89] = float("inf")
        flat[2::83] = -float("inf")
    return x.to(dtype)


@pytest.mark.parametrize("aligned", [True, False],
                         ids=["aligned", "off16"])
@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "f32"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_chunk_plan_draws_keep_mask(shape, dtype, aligned):
    # every plan covers each element once and draws the generator's bits
    n = math.prod(shape)
    vec = 16 // dtype.itemsize
    want = port_dropout.keep_mask(shape, 0.1, SEED, SITE).reshape(-1).numpy()
    for blocks in PLANS[-1:] if shape == BIG else PLANS:
        keep = emulate_keep(n, vec, aligned, blocks)
        assert np.array_equal(keep, want), blocks


@pytest.mark.parametrize("aligned", [True, False],
                         ids=["aligned", "off16"])
@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "f32"])
@pytest.mark.parametrize("shape", ((9,), (1000, 3), (8, 16, 16, 16)),
                         ids=lambda s: "x".join(map(str, s)))
def test_apply_emulation_matches_plain_product(shape, dtype, aligned):
    # y = x times the mask-scale in x's dtype, formed in float32 and
    # rounded once (a multiply: NaN * 0 stays NaN), against the plain
    # x * reference_mask_scale bit for bit
    n = math.prod(shape)
    x = _inputs(shape, dtype)
    keep = emulate_keep(n, 16 // dtype.itemsize, aligned, 3)
    scale = port_dropout._scale_in(dtype, 0.1)
    m = torch.from_numpy(np.where(keep, np.float32(scale), np.float32(0)))
    y = (x.float().reshape(-1) * m).to(dtype).reshape(shape)
    _same_bits(y, x * port_dropout.reference_mask_scale(
        shape, 0.1, dtype, seed=SEED, site=SITE))


@pytest.mark.parametrize("rate", [0.1, 0.5])
@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "f32"])
def test_raw_dropout_function_forward_backward(dtype, rate):
    # forward and backward bit for bit with autograd of the plain product;
    # the mask is drawn again in the backward, nothing saved
    shape = (6, 5, 37)
    x = _inputs(shape, dtype, 1, non_finite=False)
    dy = _inputs(shape, dtype, 2, non_finite=False)
    m = port_dropout.reference_mask_scale(shape, rate, dtype, seed=SEED,
                                          site=SITE)
    packed = []
    xk = x.clone().requires_grad_()
    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: packed.append(t) or t, lambda t: t):
        yk = port_dropout.raw_dropout(xk, rate, SEED, SITE)
    assert packed == [], "raw_dropout saved a tensor for its backward"
    assert type(yk.grad_fn).__name__ == "_RawDropoutBackward"
    yk.backward(dy)
    xp = x.clone().requires_grad_()
    yp = xp * m
    yp.backward(dy)
    _same_bits(yk.detach(), yp.detach())
    _same_bits(xk.grad, xp.grad)
    # twice the same bits; another site another mask
    _same_bits(port_dropout.raw_dropout(x, rate, SEED, SITE), yp.detach())
    assert not torch.equal(port_dropout.raw_dropout(x, rate, SEED, SITE + 1),
                           yp.detach())


@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "f32"])
def test_raw_dropout_keeps_non_finite(dtype):
    # NaN and +-inf stay non-finite where dropped (x * 0), in the forward
    # and in the backward's dy
    shape = (40, 50)
    keep = port_dropout.keep_mask(shape, 0.3, SEED, SITE)
    x = torch.full(shape, float("nan"), dtype=dtype)
    x[:, ::2] = float("inf")
    xg = x.clone().requires_grad_()
    y = port_dropout.raw_dropout(xg, 0.3, SEED, SITE)
    assert not torch.isfinite(y).any()
    assert torch.isnan(y[~keep]).all()
    assert torch.isinf(y[keep & torch.isinf(x)]).all()
    y.backward(torch.full(shape, float("nan"), dtype=dtype))
    assert torch.isnan(xg.grad).all()


@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "f32"])
def test_raw_dropout_rates_0_and_1_match_jax(dtype):
    # rate 0 is the identity (the same tensor), rate 1 zeros, as JAX
    # raw_dropout
    x = _inputs((7, 9), dtype, 3)
    assert port_dropout.raw_dropout(x, 0.0, SEED, SITE) is x
    for rate in (0.0, 1.0):
        want = np.asarray(jax_dropout.raw_dropout(
            jnp.asarray(x.float().numpy()), rate, None, impl="kernel"))
        got = port_dropout.raw_dropout(x, rate, SEED, SITE).float().numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("rate", [0.1, 0.25, 1 / 3, 0.5, 0.9])
@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "f32"])
def test_mask_scale_value_and_product_match_jax(dtype, rate):
    # the kept value is the Pallas kernel's: float32(1 / (1 - rate)) cast
    # to the dtype (bf16 1.109375 at rate 0.1), beside JAX's threshold; the
    # apply product is JAX's x * mask-scale on the same mask, bit for bit
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    kept = jnp.asarray(jnp.float32(1.0 / (1.0 - rate))).astype(jdt)
    assert port_dropout._scale_in(dtype, rate) == float(kept)
    if rate == 0.1 and dtype == torch.bfloat16:
        assert port_dropout._scale_in(dtype, rate) == 1.109375
    shape = (33, 65)
    keep = port_dropout.keep_mask(shape, rate, SEED, SITE).numpy()
    assert port_dropout.mask_threshold(rate) == int(
        jax_dropout.mask_threshold(rate))
    jmask = jnp.where(keep, kept, jnp.zeros((), jdt))
    m = port_dropout.reference_mask_scale(shape, rate, dtype, seed=SEED,
                                          site=SITE)
    np.testing.assert_array_equal(m.float().numpy(),
                                  np.asarray(jmask, np.float32))
    x = _inputs(shape, dtype, 4, non_finite=False)
    want = np.asarray(jnp.asarray(x.float().numpy()).astype(jdt) * jmask,
                      np.float32)
    got = port_dropout.raw_dropout(x, rate, SEED, SITE).float().numpy()
    np.testing.assert_array_equal(got, want)


def test_cuda_wrappers_refuse_what_the_kernel_does_not_take():
    # checked before any launch: dtype, contiguity, device
    x = torch.zeros(4, 8)
    with pytest.raises(ValueError, match="float32/bfloat16"):
        port_dropout._apply_cuda(x.half(), 0.1, 1, 0)
    with pytest.raises(ValueError, match="contiguous"):
        port_dropout._apply_cuda(x.t(), 0.1, 1, 0)
    with pytest.raises(ValueError, match="float32/bfloat16"):
        port_dropout._mask_scale_cuda((4,), 0.1, torch.float16, 1, 0, "cpu")
    with pytest.raises(ValueError, match="cpu or cuda"):
        port_dropout.raw_dropout(torch.zeros(4, device="meta"), 0.1, 1, 0)


def _count_sites(monkeypatch):
    """Calls of the apply step (one kernel launch each on the card), with
    whether each x was contiguous."""
    calls = []
    plain = port_dropout.apply_mask

    def counted(x, rate, seed, site):
        calls.append((tuple(x.shape), x.is_contiguous()))
        return plain(x, rate, seed, site)

    monkeypatch.setattr(port_dropout, "apply_mask", counted)
    return calls


@pytest.mark.parametrize("model", ["tiny", "gpt2-tiny"])
def test_model_dropout_sites_contiguous_and_counted(model, monkeypatch):
    # one microbatch forward + backward: BERT 2 + L dropouts forward, L
    # again under attention_remat, 2 + L backward (4 + 3 L); GPT-2 with
    # flash attention 2 L + 1 each way; every x contiguous
    torch.manual_seed(0)
    cfg = model_preset(model, **({"attention_impl": "flash"}
                                 if model == "gpt2-tiny" else {}))
    gen = torch.Generator().manual_seed(0)
    if cfg.causal:
        net = GPT2LMModel(cfg, generator=gen)
    else:
        net = BertForSequenceClassification(cfg, generator=gen)
    ids = torch.randint(1, cfg.vocab_size, (2, 16), generator=gen)
    calls = _count_sites(monkeypatch)
    out = net(ids, torch.ones_like(ids), dropout_seed=77)
    forward = len(calls)
    out.float().square().mean().backward()
    layers = cfg.num_layers
    if cfg.causal:
        assert (forward, len(calls)) == (2 * layers + 1, 4 * layers + 2)
    else:
        assert (forward, len(calls)) == (2 + layers, 4 + 3 * layers)
    assert all(contiguous for _, contiguous in calls), calls
