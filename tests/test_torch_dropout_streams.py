"""Port parity, the dropout streams and the reference LayerNorm: the PyTorch
package's ``raw_dropout`` in its four streams (``ops/dropout.py``), the
dropout-add-LayerNorm tail and the attention probabilities under them, and
``layernorm_impl="reference"``, against the JAX package's ``raw_dropout``,
``layer_norm`` and models, on the CPU.

The streams draw other bits than JAX's (Philox here, jax.random there), so
what is held against JAX is what does not depend on the bits: rate 0 and 1,
the NaN contract, bits8's threshold and scale, and whole models with
dropout off (logits rtol 1e-5, atol 1e-6; gradients atol 1e-6, float32).
Within the port: keep rates within 5 sigma of the binomial, masks a pure
function of (seed, site, flat index), gradients equal to the mask applied
to dy bit for bit, and remat bit-equal to no remat.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from pytorch_distributed_training_tpu.models.bert import (
    BertForSequenceClassification as JaxBert,
)
from pytorch_distributed_training_tpu.ops.dropout import (
    raw_dropout as jax_raw_dropout,
)
from pytorch_distributed_training_tpu.ops.layer_norm import (
    layer_norm as jax_layer_norm,
)
from pytorch_distributed_training_tpu.utils.config import (
    model_preset as jax_preset,
)
from pytorch_distributed_training_tpu_torch.models.bert import (
    BertForSequenceClassification,
)
from pytorch_distributed_training_tpu_torch.models.convert import (
    params_from_jax,
)
from pytorch_distributed_training_tpu_torch.models.gpt2 import GPT2LMModel
from pytorch_distributed_training_tpu_torch.ops import dropout as drop
from pytorch_distributed_training_tpu_torch.ops.attention import (
    reference_attention,
)
from pytorch_distributed_training_tpu_torch.ops.layer_norm import (
    dropout_add_layer_norm,
    layer_norm,
)
from pytorch_distributed_training_tpu_torch.utils.config import model_preset

torch.set_num_threads(2)

STREAMS = ("kernel", "bits32", "bits8", "exact")
MULTIPLY = ("kernel", "bits32", "bits8")
NO_DROPOUT = dict(compute_dtype="float32", hidden_dropout=0.0,
                  attention_dropout=0.0)


def _x(shape, seed=0, dtype=torch.float32):
    return torch.from_numpy(
        np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    ).to(dtype)


def _keep(impl, shape, rate, seed, site):
    if impl == "bits8":
        return drop.bits8_keep(shape, rate, seed, site)
    if impl == "exact":
        return drop.exact_keep(shape, rate, seed, site)
    return drop.keep_mask(shape, rate, seed, site)


# ------------------------------------------------------------ the streams


@pytest.mark.parametrize("impl", STREAMS)
def test_rate_zero_and_one_against_jax(impl):
    x = _x((4, 33))
    xj = jnp.asarray(x.numpy())
    key = jax.random.key(0)
    for rate in (0.0, -0.1):
        got = drop.raw_dropout(x, rate, 7, 1, impl)
        assert got is x
        np.testing.assert_array_equal(
            np.asarray(jax_raw_dropout(xj, rate, key, impl)), x.numpy())
    for rate in (1.0, 1.5):
        got = drop.raw_dropout(x, rate, 7, 1, impl)
        want = np.asarray(jax_raw_dropout(xj, rate, key, impl))
        np.testing.assert_array_equal(got.numpy(), want)
        assert not got.any()


@pytest.mark.parametrize("impl", STREAMS)
def test_nan_contract_against_jax(impl):
    # exact is a select (a dropped NaN is 0), the others multiply (NaN
    # stays), in both packages; kept positions carry NaN in both
    x = _x((8, 64))
    x.view(-1)[::3] = float("nan")
    rate = 0.5
    got = drop.raw_dropout(x, rate, 11, 2, impl)
    want = np.asarray(jax_raw_dropout(jnp.asarray(x.numpy()), rate,
                                      jax.random.key(1), impl))
    nan = torch.isnan(x)
    for out, kept in ((got.numpy(), None), (want, None)):
        out_nan = np.isnan(out)
        if impl in MULTIPLY:
            np.testing.assert_array_equal(out_nan, nan.numpy())
        else:
            # a NaN survives only where it was kept (nonzero elsewhere)
            assert not (out_nan & ~nan.numpy()).any()
            assert 0 < out_nan.sum() < nan.sum()
    if impl == "exact":
        keep = _keep(impl, tuple(x.shape), rate, 11, 2)
        np.testing.assert_array_equal(np.isnan(got.numpy()),
                                      (nan & keep).numpy())


@pytest.mark.parametrize("rate", (0.001, 0.1, 0.3, 0.5, 0.9, 0.999))
def test_bits8_threshold_and_scale_against_jax(rate):
    # JAX's bits8: t = min(max(round(rate * 256), 1), 255), the scale
    # 1/(1 - t/256) cast to x's dtype; its kept value on ones, and the
    # dropped share within 5 sigma of t/256 in both packages
    t = drop.bits8_threshold(rate)
    assert t == min(max(round(rate * 256), 1), 255)
    assert drop.bits8_rate(rate) == t / 256.0
    n = 1 << 16
    for dtype, jdtype in ((torch.float32, jnp.float32),
                          (torch.bfloat16, jnp.bfloat16)):
        got = drop.raw_dropout(torch.ones(n // 64, 64, dtype=dtype), rate,
                               3, 0, "bits8")
        want = np.asarray(jax_raw_dropout(jnp.ones((n // 64, 64), jdtype),
                                          rate, jax.random.key(2), "bits8"
                                          ).astype(jnp.float32))
        scale = float(want[want != 0][0])
        assert set(np.unique(want)) <= {0.0, scale}
        assert set(np.unique(got.float().numpy())) <= {0.0, scale}
        sigma = (t / 256 * (1 - t / 256) / n) ** 0.5
        for out in (got.float().numpy(), want):
            assert abs((out == 0).mean() - t / 256) < 5 * sigma + 1e-12


@pytest.mark.parametrize("impl", STREAMS)
@pytest.mark.parametrize("rate", (0.1, 0.5))
def test_keep_rates_within_binomial_bounds(impl, rate):
    n = 1 << 16
    keep = _keep(impl, (n,), rate, 5, 3).double().mean().item()
    p = 1 - (drop.bits8_rate(rate) if impl == "bits8" else rate)
    assert abs(keep - p) < 5 * (p * (1 - p) / n) ** 0.5


@pytest.mark.parametrize("impl", STREAMS)
def test_masks_pure_in_seed_site_and_flat_index(impl):
    shape = (6, 7, 5)  # 210 elements: no multiple of 4 or 16
    a = _keep(impl, shape, 0.3, 9, 1)
    assert torch.equal(a, _keep(impl, shape, 0.3, 9, 1))
    # the flat index alone: any shape of the same elements, any prefix
    assert torch.equal(a.reshape(-1), _keep(impl, (210,), 0.3, 9, 1))
    assert torch.equal(a.reshape(-1)[:100], _keep(impl, (100,), 0.3, 9, 1))
    assert not torch.equal(a, _keep(impl, shape, 0.3, 9, 2))
    assert not torch.equal(a, _keep(impl, shape, 0.3, 10, 1))


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
@pytest.mark.parametrize("impl", STREAMS)
def test_gradient_is_the_mask_on_dy(impl, dtype):
    # the backward draws the mask again: dy * mask-scale (the multiply
    # streams) or where(keep, dy / (1 - rate), 0) (exact), bit for bit
    rate, shape = 0.2, (5, 38)
    x = _x(shape, 1, dtype).requires_grad_()
    dy = _x(shape, 2, dtype)
    y = drop.raw_dropout(x, rate, 21, 4, impl)
    y.backward(dy)
    keep = _keep(impl, shape, rate, 21, 4)
    assert torch.equal(y.detach(), drop.reference_dropout(
        x.detach(), rate, 21, 4, impl))
    assert torch.equal(x.grad, drop.reference_dropout(dy, rate, 21, 4, impl))
    assert torch.equal(x.grad == 0, ~keep | (dy == 0))
    if impl == "exact":
        div = torch.tensor(1 - rate, dtype=torch.float64).to(dtype).float()
        want = torch.where(keep, (dy.float() / div).to(dtype), 0)
        assert torch.equal(x.grad, want)


def test_unknown_stream_and_layernorm_impl_refused():
    with pytest.raises(ValueError, match="unknown dropout impl"):
        drop.raw_dropout(_x((4,)), 0.1, 1, 0, "threefry")
    with pytest.raises(ValueError, match="unknown dropout impl"):
        model_preset("tiny", dropout_impl="threefry")
    with pytest.raises(ValueError, match="unknown layernorm impl"):
        model_preset("tiny", layernorm_impl="pallas")
    with pytest.raises(ValueError, match="unknown layernorm impl"):
        layer_norm(_x((2, 8)), torch.ones(8), torch.zeros(8),
                   impl="pallas")


# ------------------------------------------- the sites under the streams


@pytest.mark.parametrize("impl", STREAMS)
def test_dal_tail_unfused_under_foreign_streams(impl):
    # JAX: "foreign mask streams can't regenerate in-kernel": under any
    # stream but "kernel" (or the reference LayerNorm) the tail is
    # raw_dropout in the stream, the add, then the LayerNorm
    g = np.random.default_rng(3)
    h, x = _x((6, 32), 4), _x((6, 32), 5)
    scale = torch.from_numpy(g.standard_normal(32).astype(np.float32))
    bias = torch.from_numpy(g.standard_normal(32).astype(np.float32))
    kw = dict(rate=0.25, seed=13, site=1, eps=1e-12)
    for ln in ("fused", "reference"):
        got = dropout_add_layer_norm(h, x, scale, bias, impl=ln,
                                     dropout_impl=impl, **kw)
        if impl == "kernel" and ln == "fused":
            continue  # the fused kernels' own tests hold this one
        want = layer_norm(x + drop.raw_dropout(h, 0.25, 13, 1, impl), scale,
                          bias, eps=1e-12, impl=ln)
        assert torch.equal(got, want)


@pytest.mark.parametrize("impl", STREAMS)
def test_attention_probs_order_per_stream(impl):
    # exact masks the float32 probabilities and then casts them; every
    # other stream casts first (JAX reference_attention's two orders)
    q, k = _x((2, 8, 2, 4), 6), _x((2, 8, 2, 4), 7)
    v = _x((2, 8, 2, 4), 8, torch.bfloat16)
    got = reference_attention(q, k, v, dropout_rate=0.3, dropout_seed=5,
                              dropout_site=2, dropout_impl=impl)
    scores = torch.einsum("bsnd,btnd->bnst", q, k) * 4 ** -0.5
    probs = torch.softmax(scores, dim=-1)
    if impl == "exact":
        probs = drop.raw_dropout(probs, 0.3, 5, 2, impl).to(v.dtype)
    else:
        probs = drop.raw_dropout(probs.to(v.dtype), 0.3, 5, 2, impl)
    assert torch.equal(got, torch.einsum("bnst,btnd->bsnd", probs, v))


def test_reference_layer_norm_against_jax():
    # forward and gradients of the plain LayerNorm under autograd against
    # JAX's impl="reference" (jnp math, jax.grad), float32, atol 1e-6
    g = np.random.default_rng(9)
    x = g.standard_normal((5, 48)).astype(np.float32) * 3 + 1
    scale = g.standard_normal(48).astype(np.float32)
    bias = g.standard_normal(48).astype(np.float32)
    dy = g.standard_normal((5, 48)).astype(np.float32)
    xt, st, bt = (torch.tensor(a, requires_grad=True)
                  for a in (x, scale, bias))
    y = layer_norm(xt, st, bt, eps=1e-5, impl="reference")
    y.backward(torch.from_numpy(dy))

    def f(x, s, b):
        return jnp.sum(jax_layer_norm(x, s, b, eps=1e-5, impl="reference")
                       * dy)

    jy = jax_layer_norm(x, scale, bias, eps=1e-5, impl="reference")
    grads = jax.grad(f, argnums=(0, 1, 2))(x, scale, bias)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy),
                               rtol=0, atol=1e-6)
    for got, want in zip((xt.grad, st.grad, bt.grad), grads):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-5)


@pytest.fixture(scope="module")
def jax_tiny():
    """JAX tiny BERT params (float32, dropout off), shared by the option
    matrix; layernorm_impl does not change the params."""
    model = JaxBert(jax_preset("tiny", **NO_DROPOUT))
    ids = jnp.ones((2, 16), jnp.int32)
    return jax.tree.map(np.asarray,
                        model.init(jax.random.key(0), ids)["params"])


@pytest.mark.parametrize("ln", ("fused", "reference"))
@pytest.mark.parametrize("impl", STREAMS)
def test_whole_tiny_model_dropout_off_against_jax(jax_tiny, impl, ln):
    opts = dict(NO_DROPOUT, dropout_impl=impl, layernorm_impl=ln)
    g = np.random.default_rng(4)
    ids = g.integers(0, 1024, (3, 16)).astype(np.int32)
    mask = (np.arange(16) < g.integers(8, 17, (3, 1))).astype(np.int32)
    labels = np.array([0, 1, 1])
    jmodel = JaxBert(jax_preset("tiny", **opts))

    def loss(p):
        logits = jmodel.apply({"params": p}, ids, mask)
        return jnp.mean(-jax.nn.log_softmax(logits)[np.arange(3), labels])

    jl, jg = jax.value_and_grad(loss)(jax_tiny)
    model = BertForSequenceClassification(model_preset("tiny", **opts))
    model.load_state_dict(params_from_jax(jax_tiny))
    logits = model(torch.from_numpy(ids), torch.from_numpy(mask))
    pl = F.cross_entropy(logits, torch.from_numpy(labels))
    pl.backward()
    np.testing.assert_allclose(pl.item(), float(jl), rtol=1e-5, atol=1e-6)
    want = params_from_jax(jax.tree.map(np.asarray, jg))
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   rtol=0, atol=1e-6, err_msg=name)


# ------------------------------------------------ determinism and remat


def _grads(model, ids, seed, **kw):
    model.zero_grad()
    out = model(ids, dropout_seed=seed, **kw)
    out.float().square().mean().backward()
    return out.detach(), {n: p.grad.clone() for n, p in
                          model.named_parameters() if p.grad is not None}


@pytest.mark.parametrize("impl", STREAMS)
def test_remat_bit_equal_and_no_stateful_generator(impl, monkeypatch):
    # BERT and GPT-2 with dropout on in every stream: per-layer remat and
    # the MLP remat recompute the forward, and the masks with it, bit for
    # bit; no site reaches torch's stateful generators
    def refuse(*a, **k):
        raise AssertionError("a stateful generator was drawn from")

    for name in ("rand", "rand_like", "bernoulli"):
        monkeypatch.setattr(torch, name, refuse)
    monkeypatch.setattr(F, "dropout", refuse)
    ids = torch.from_numpy(
        np.random.default_rng(2).integers(0, 1024, (2, 16)))
    for cls, preset, variants in (
            (BertForSequenceClassification, "tiny", ({"remat": True},)),
            (GPT2LMModel, "gpt2-tiny", ({"remat": True},
                                        {"remat_mlp": True}))):
        base = model_preset(preset, dropout_impl=impl)
        ref = cls(base, generator=torch.Generator().manual_seed(0))
        want = _grads(ref, ids, 77)
        for extra in variants:
            cfg = model_preset(preset, dropout_impl=impl, **extra)
            model = cls(cfg, generator=torch.Generator().manual_seed(0))
            got = _grads(model, ids, 77)
            assert torch.equal(got[0], want[0]), (preset, extra)
            for n in want[1]:
                assert torch.equal(got[1][n], want[1][n]), (preset, extra, n)
        other = _grads(ref, ids, 78)
        assert not torch.equal(other[0], want[0])
