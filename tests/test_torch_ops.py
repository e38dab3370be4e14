"""Port parity, ops and models: the PyTorch package's plain kernel versions
(LayerNorm forward and backward, dropout + add + LayerNorm, the dropout
mask generator, paged decode) and its GPT-2 and BERT models against the
JAX package on the same numpy inputs, on the CPU (Pallas kernels in
interpret mode). The CUDA kernels themselves run only on the card
(``chip_smoke.py``)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_training_tpu.models.bert import (
    BertForSequenceClassification as JaxBert,
)
from pytorch_distributed_training_tpu.models.gpt2 import GPT2LMModel as JaxGPT2
from pytorch_distributed_training_tpu.models.relayout import stack_layer_params
from pytorch_distributed_training_tpu.ops import dropout as jax_dropout
from pytorch_distributed_training_tpu.ops import layer_norm as jax_ln
from pytorch_distributed_training_tpu.ops import paged_attention as jax_pa
from pytorch_distributed_training_tpu.ops.flash_attention import (
    tpu_interpret_mode,
)
from pytorch_distributed_training_tpu.utils.config import (
    model_preset as jax_preset,
)
from pytorch_distributed_training_tpu_torch.models.convert import (
    params_from_jax,
    params_to_jax,
)
from pytorch_distributed_training_tpu_torch.models.bert import (
    BertForSequenceClassification,
)
from pytorch_distributed_training_tpu_torch.models.gpt2 import GPT2LMModel
from pytorch_distributed_training_tpu_torch.ops import _build
from pytorch_distributed_training_tpu_torch.ops import dropout as port_dropout
from pytorch_distributed_training_tpu_torch.ops.attention import (
    make_attention_bias,
)
from pytorch_distributed_training_tpu_torch.ops.layer_norm import (
    FusedDropoutAddLayerNorm,
    FusedLayerNorm,
    dropout_add_layer_norm,
    layer_norm,
    reference_dal_bwd,
    reference_dal_fwd,
    reference_layer_norm,
)
from pytorch_distributed_training_tpu_torch.ops.paged_attention import (
    paged_attention,
)
from pytorch_distributed_training_tpu_torch.utils.config import model_preset

torch.set_num_threads(2)


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    """Spacing of bfloat16 values at |x| (8 significant bits)."""
    a = np.maximum(np.abs(x.astype(np.float32)), np.float32(2.0 ** -126))
    return 2.0 ** (np.floor(np.log2(a)) - 7)


def _ln_inputs(seed=0, shape=(4, 8, 256)):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    scale = (1.0 + 0.1 * rng.standard_normal(shape[-1])).astype(np.float32)
    bias = (0.1 * rng.standard_normal(shape[-1])).astype(np.float32)
    return x, scale, bias


# ------------------------------------------------------------- layer norm


def test_layer_norm_plain_matches_jax_reference_fp32():
    x, scale, bias = _ln_inputs()
    want = jax_ln.reference_layer_norm(
        jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias), eps=1e-5,
    )
    got = reference_layer_norm(
        torch.from_numpy(x), torch.from_numpy(scale), torch.from_numpy(bias),
        eps=1e-5,
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)


def test_layer_norm_plain_matches_jax_fused_kernel_interpret():
    # rows = 32 and H % 128 == 0: the Pallas kernel's tiling, run by the
    # interpreter on the CPU
    x, scale, bias = _ln_inputs(seed=1)
    with tpu_interpret_mode():
        want = jax_ln.layer_norm(
            jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias), eps=1e-5,
            impl="fused",
        )
    got = layer_norm(
        torch.from_numpy(x), torch.from_numpy(scale), torch.from_numpy(bias),
        eps=1e-5,
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("in_dtype", ["float32", "bfloat16"])
def test_layer_norm_bf16_out_within_one_ulp_of_jax(in_dtype):
    x, scale, bias = _ln_inputs(seed=2)
    xj = jnp.asarray(x).astype(in_dtype)
    with tpu_interpret_mode():
        want = jax_ln.layer_norm(
            xj, jnp.asarray(scale), jnp.asarray(bias), eps=1e-5,
            out_dtype=jnp.bfloat16, impl="fused",
        )
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(
        getattr(torch, in_dtype)
    )
    got = layer_norm(xt, torch.from_numpy(scale), torch.from_numpy(bias),
                     eps=1e-5, out_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    want32 = np.asarray(want.astype(jnp.float32))
    got32 = got.float().numpy()
    err = np.abs(got32 - want32)
    assert np.all(err <= _bf16_ulp(want32)), float(err.max())


def test_fused_layer_norm_module_params_and_dtype():
    ln = FusedLayerNorm(64, eps=1e-5, out_dtype=torch.bfloat16)
    assert ln.scale.dtype == torch.float32 and ln.bias.dtype == torch.float32
    assert torch.equal(ln.scale, torch.ones(64))
    y = ln(torch.randn(3, 64, generator=torch.Generator().manual_seed(0)))
    assert y.dtype == torch.bfloat16 and y.shape == (3, 64)


def test_layer_norm_backward_matches_jax_pallas_vjp_interpret():
    # (a) rows = 64 and H = 256: the Pallas _bwd kernel runs (interpreted)
    x, scale, bias = _ln_inputs(seed=3, shape=(4, 16, 256))
    dy = np.random.default_rng(13).standard_normal(x.shape).astype(np.float32)

    def f(x, s, b):
        return jax_ln.layer_norm(x, s, b, eps=1e-5, impl="fused")

    with tpu_interpret_mode():
        _, vjp = jax.vjp(f, *(jnp.asarray(a) for a in (x, scale, bias)))
        want = [np.asarray(g) for g in vjp(jnp.asarray(dy))]
    leaves = [torch.from_numpy(a).requires_grad_() for a in (x, scale, bias)]
    y = layer_norm(*leaves, eps=1e-5)
    got = torch.autograd.grad(y, leaves, torch.from_numpy(dy))
    # dx: a few float32 ulps of O(1) terms; dscale/dbias: sums of 64 rows
    # of O(1) terms taken in another order
    np.testing.assert_allclose(got[0].numpy(), want[0], rtol=1e-5, atol=1e-5)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=1e-4)


def _dal_inputs(seed=4, shape=(4, 16, 256)):
    rng = np.random.default_rng(seed)
    h = rng.standard_normal(shape).astype(np.float32)
    x = (1.0 + rng.standard_normal(shape)).astype(np.float32)
    scale = (1.0 + 0.1 * rng.standard_normal(shape[-1])).astype(np.float32)
    bias = (0.1 * rng.standard_normal(shape[-1])).astype(np.float32)
    dy = rng.standard_normal(shape).astype(np.float32)
    return h, x, scale, bias, dy


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_dropout_add_layer_norm_matches_jax_pallas_interpret(rate):
    # (b) rows 64, H 256: the Pallas _dal_fwd/_dal_bwd kernels run. In
    # interpret mode their random bits are all zero, so at rate > 0 every
    # element of h drops; the port's plain versions get that mask.
    h, x, scale, bias, dy = _dal_inputs()

    def f(h, x, s, b):
        return jax_ln.dropout_add_layer_norm(
            h, x, s, b, rate=rate, dropout_rng=jax.random.key(0),
            deterministic=False, eps=1e-5, site=1, impl="fused",
            dropout_impl="kernel",
        )

    with tpu_interpret_mode():
        y_j, vjp = jax.vjp(f, *(jnp.asarray(a) for a in (h, x, scale, bias)))
        want = [np.asarray(g) for g in vjp(jnp.asarray(dy))]
    t = [torch.from_numpy(a) for a in (h, x, scale, bias, dy)]
    if rate == 0.0:
        leaves = [a.clone().requires_grad_() for a in t[:4]]
        y = dropout_add_layer_norm(*leaves, rate=0.0, seed=7, site=1,
                                   eps=1e-5)
        got = torch.autograd.grad(y, leaves, t[4])
    else:
        keep = torch.zeros(h.shape, dtype=torch.bool)
        kw = dict(rate=rate, seed=7, site=1, eps=1e-5, keep=keep)
        y, s = reference_dal_fwd(*t[:4], out_dtype=torch.float32, **kw)
        dh, dx, dscale, dbias = reference_dal_bwd(s, t[4], t[2], **kw)
        got = (dh, dx, dscale, dbias)
        assert torch.equal(dh, torch.zeros_like(dh))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_j),
                               rtol=0, atol=1e-5)
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=1e-5)
    for g, w in zip(got[2:], want[2:]):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=1e-4)


def test_mask_threshold_matches_jax():
    # (c) Python's round included, the top clamped to 2^32 - 1
    for rate in (0.0, 1e-10, 0.1, 0.25, 1 / 3, 0.5, 0.9, 1 - 1e-12, 1.0):
        assert port_dropout.mask_threshold(rate) == int(
            jax_dropout.mask_threshold(rate)
        ), rate


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_mask_scale_values_and_keep_rate(rate):
    # (d) 2^20 elements: values in {0, 1/(1-rate)}, keep rate within 4 sigma
    n = 1 << 20
    m = port_dropout.mask_scale((1024, 1024), rate, torch.float32, seed=3,
                                site=1)
    scale = np.float32(1.0 / (1.0 - rate))
    vals = set(np.unique(m.numpy()).tolist())
    assert vals == {0.0, float(scale)}
    p = 1.0 - rate
    kept = float((m > 0).float().mean())
    assert abs(kept - p) < 4 * np.sqrt(p * (1 - p) / n), kept
    b = port_dropout.mask_scale((1000, 3), rate, torch.bfloat16, seed=3,
                                site=1)
    assert b.dtype == torch.bfloat16 and b.shape == (1000, 3)
    assert set(np.unique(b.float().numpy()).tolist()) <= {
        0.0, float(torch.tensor(scale).bfloat16().float())
    }


def test_mask_depends_on_seed_and_site_only():
    # (e) a pure function of (seed, site, index): the same pair gives the
    # same mask (and the same prefix at any shape); another pair another
    shape = (64, 100)
    a = port_dropout.keep_mask(shape, 0.1, 5, 0)
    assert torch.equal(a, port_dropout.keep_mask(shape, 0.1, 5, 0))
    assert torch.equal(a.reshape(-1)[:999],
                       port_dropout.keep_mask((999,), 0.1, 5, 0))
    assert not torch.equal(a, port_dropout.keep_mask(shape, 0.1, 5, 1))
    assert not torch.equal(a, port_dropout.keep_mask(shape, 0.1, 6, 0))
    assert port_dropout.fold_in(5, 1) != port_dropout.fold_in(5, 2)
    assert port_dropout.fold_in(5, 1) != port_dropout.fold_in(6, 1)
    assert 0 <= port_dropout.fold_in(2 ** 32 - 1, 7) < 2 ** 32


def test_philox_known_answers():
    # (f) Random123's known-answer vectors for Philox4x32-10
    def run(c, k):
        words = [torch.tensor([v], dtype=torch.int64) for v in c]
        return [int(w) for w in port_dropout.philox4x32_10(*words, *k)]

    assert run([0, 0, 0, 0], [0, 0]) == [
        0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8]
    m = 0xFFFFFFFF
    assert run([m, m, m, m], [m, m]) == [
        0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD]
    assert port_dropout.philox_bits(4, 0, 0).tolist() == [
        0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8]


def test_dropout_add_layer_norm_backward_is_zero_where_h_dropped():
    # (g) the backward regenerates the forward's mask: dh is exactly 0 at
    # dropped elements, and the output ignores h there
    h, x, scale, bias, _ = _dal_inputs(seed=6, shape=(8, 128))
    t = [torch.from_numpy(a) for a in (h, x, scale, bias)]
    hg = t[0].clone().requires_grad_()
    kw = dict(rate=0.3, seed=11, site=1, eps=1e-12)
    y = dropout_add_layer_norm(hg, *t[1:], **kw)
    (dh,) = torch.autograd.grad(y.square().sum(), hg)
    keep = port_dropout.keep_mask(h.shape, 0.3, 11, 1)
    assert 0.6 < float(keep.float().mean()) < 0.8
    assert torch.equal(dh[~keep], torch.zeros_like(dh[~keep]))
    assert bool((dh[keep] != 0).all())
    h2 = t[0].clone()
    h2[~keep] = 1e3
    with torch.no_grad():
        assert torch.equal(dropout_add_layer_norm(h2, *t[1:], **kw), y)
    # the other tail of the block (site 0) draws another mask
    assert not torch.equal(keep, port_dropout.keep_mask(h.shape, 0.3, 11, 0))
    tail = FusedDropoutAddLayerNorm(128, eps=1e-12, rate=0.3, site=1,
                                    out_dtype=torch.float32)
    assert [n for n, _ in tail.named_parameters()] == ["scale", "bias"]


# -------------------------------------------------------- paged attention


def _paged_fixture(seed=0, batch=3, heads=2, head_dim=4, page_size=4,
                   windows=3, num_pages=16):
    """The JAX package's test_paged geometry: contiguous K/V scattered into
    a noise-filled pool via a shuffled block table."""
    rng = np.random.default_rng(seed)
    T = page_size * windows
    q = rng.standard_normal((batch, heads, head_dim)).astype(np.float32)
    k = rng.standard_normal((batch, T, heads, head_dim)).astype(np.float32)
    v = rng.standard_normal((batch, T, heads, head_dim)).astype(np.float32)
    k_pages = rng.standard_normal(
        (num_pages, page_size, heads, head_dim)
    ).astype(np.float32)
    v_pages = rng.standard_normal(
        (num_pages, page_size, heads, head_dim)
    ).astype(np.float32)
    ids = rng.permutation(np.arange(1, num_pages))[: batch * windows]
    block_table = ids.reshape(batch, windows).astype(np.int32)
    for b in range(batch):
        for w in range(windows):
            k_pages[block_table[b, w]] = k[b, w * page_size:(w + 1) * page_size]
            v_pages[block_table[b, w]] = v[b, w * page_size:(w + 1) * page_size]
    lengths = np.asarray([1, T - 3, T], np.int32)[:batch]
    return q, k_pages, v_pages, block_table, lengths


def _port_paged(q, k_pages, v_pages, bt, lengths, scale):
    return paged_attention(
        torch.from_numpy(q), torch.from_numpy(k_pages),
        torch.from_numpy(v_pages), torch.from_numpy(bt),
        torch.from_numpy(lengths), scale=scale,
    ).numpy()


@pytest.mark.parametrize("seed", [0, 5])
def test_paged_attention_matches_jax_pallas_interpret_and_reference(seed):
    q, kp, vp, bt, lengths = _paged_fixture(seed=seed)
    scale = q.shape[-1] ** -0.5
    args = [jnp.asarray(a) for a in (q, kp, vp, bt, lengths)]
    ref = jax_pa.paged_attention(*args, scale=scale, impl="reference")
    with tpu_interpret_mode():
        pal = jax_pa.paged_attention(*args, scale=scale, impl="pallas")
    got = _port_paged(q, kp, vp, bt, lengths, scale)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got, np.asarray(pal), rtol=1e-6, atol=1e-6)


def test_paged_attention_null_page_tail_and_garbage_pool():
    # a short sequence whose block-table tail points at the null page 0:
    # the masked lanes must contribute nothing, whatever page 0 holds
    q, kp, vp, bt, lengths = _paged_fixture(seed=3)
    scale = q.shape[-1] ** -0.5
    bt = bt.copy()
    bt[0, 1:] = 0
    kp0 = kp.copy()
    kp0[0] = 1e4
    vp0 = vp.copy()
    vp0[0] = -1e4
    a = _port_paged(q, kp, vp, bt, lengths, scale)
    b = _port_paged(q, kp0, vp0, bt, lengths, scale)
    np.testing.assert_array_equal(a[0], b[0])


def test_paged_attention_validates_like_jax():
    q, kp, vp, bt, lengths = _paged_fixture()
    t = [torch.from_numpy(a) for a in (q, kp, vp, bt, lengths)]
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        paged_attention(t[0][:, None], *t[1:], scale=1.0)
    with pytest.raises(ValueError, match="q must be"):
        paged_attention(t[0][0], *t[1:], scale=1.0)
    with pytest.raises(ValueError, match="head_dim"):
        paged_attention(t[0][..., :2], *t[1:], scale=1.0)
    with pytest.raises(ValueError, match="k_pages/v_pages shapes differ"):
        paged_attention(t[0], t[1], t[2][:, :2], *t[3:], scale=1.0)
    with pytest.raises(ValueError, match="block_table"):
        paged_attention(t[0], t[1], t[2], t[3][:2], t[4], scale=1.0)
    with pytest.raises(ValueError, match="lengths"):
        paged_attention(*t[:4], t[4][:2], scale=1.0)
    with pytest.raises(NotImplementedError, match="int8"):
        paged_attention(t[0], t[1].to(torch.int8), t[2].to(torch.int8),
                        *t[3:], scale=1.0)


def test_kernel_modules_build_nothing_at_import():
    # the CPU path never touches nvcc: nothing built, nothing launched
    assert _build._LIBS == {}
    assert sum(_build.LAUNCH_COUNTS.values()) == 0
    assert set(_build.KERNEL_SOURCES) == {
        "layer_norm", "dropout_add_layer_norm", "dropout", "paged_attention",
        "flash_attention",
    }
    assert set(_build.KERNELS) == {
        "layer_norm", "layer_norm_bwd", "dropout_add_layer_norm",
        "dropout_add_layer_norm_bwd", "mask_scale", "paged_attention",
        "flash_fwd", "flash_bwd", "flash_whole_fwd", "flash_whole_bwd",
    }
    assert set(_build.KERNELS.values()) == set(_build.KERNEL_SOURCES)
    for src in _build.KERNEL_SOURCES.values():
        assert (_build.CSRC_DIR / src).exists()
    assert (_build.CSRC_DIR / "philox.cuh").exists()


# ------------------------------------------------------------------ model


def _jax_lm(compute_dtype, scan_layers=False):
    cfg = jax_preset(
        "gpt2-tiny", compute_dtype=compute_dtype, attention_impl="reference",
        hidden_dropout=0.0, attention_dropout=0.0, scan_layers=scan_layers,
    )
    model = JaxGPT2(cfg)
    params = model.init(jax.random.key(0), jnp.ones((2, 16), jnp.int32))[
        "params"
    ]
    return model, jax.tree.map(np.asarray, params)


def _port_lm(params, compute_dtype):
    model = GPT2LMModel(model_preset("gpt2-tiny", compute_dtype=compute_dtype))
    model.load_state_dict(params_from_jax(params))
    return model.eval()


def _ids(seed=0, shape=(2, 16), vocab=1024):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32
    )


@pytest.mark.parametrize("compute_dtype,atol", [
    ("float32", 1e-5),
    ("bfloat16", 2e-2),
])
def test_gpt2_full_sequence_logits_match_flax(compute_dtype, atol):
    jmodel, params = _jax_lm(compute_dtype)
    ids = _ids()
    want = np.asarray(jmodel.apply({"params": params}, jnp.asarray(ids)))
    model = _port_lm(params, compute_dtype)
    with torch.no_grad():
        got = model(torch.from_numpy(ids).long())
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=atol)


def test_gpt2_padding_mask_logits_match_flax():
    jmodel, params = _jax_lm("float32")
    ids = _ids(seed=1)
    mask = np.ones_like(ids)
    mask[1, 11:] = 0
    want = np.asarray(jmodel.apply(
        {"params": params}, jnp.asarray(ids), attention_mask=jnp.asarray(mask)
    ))
    model = _port_lm(params, "float32")
    with torch.no_grad():
        got = model(torch.from_numpy(ids).long(),
                    attention_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_weight_bridge_scanned_trunk_and_round_trip():
    _, params = _jax_lm("float32")
    flat = params_from_jax(params)
    scanned = jax.tree.map(np.asarray, stack_layer_params(params))
    assert "layers_scan" in scanned
    flat_scanned = params_from_jax(scanned)
    assert flat.keys() == flat_scanned.keys()
    for name in flat:
        assert torch.equal(flat[name], flat_scanned[name]), name
    # the port's own module tree has exactly these names and shapes
    model = GPT2LMModel(model_preset("gpt2-tiny"))
    own = model.state_dict()
    assert own.keys() == flat.keys()
    for name in own:
        assert own[name].shape == flat[name].shape, name
    back = params_to_jax(flat)
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        np.testing.assert_array_equal(a, b)


def test_cast_for_serving_keeps_values_and_layer_norm_fp32():
    _, params = _jax_lm("bfloat16")
    model = _port_lm(params, "bfloat16")
    ids = torch.from_numpy(_ids(seed=2)).long()
    with torch.no_grad():
        before = model(ids)
        model.cast_for_serving()
        after = model(ids)
    torch.testing.assert_close(after, before, rtol=0, atol=0)
    assert model.blocks[0].attention.query.kernel.dtype == torch.bfloat16
    assert model.wte.embedding.dtype == torch.bfloat16
    assert model.blocks[0].ln_1.scale.dtype == torch.float32
    assert model.head_weight.dtype == torch.float32


def test_make_attention_bias_matches_jax():
    from pytorch_distributed_training_tpu.ops.attention import (
        make_attention_bias as jax_bias,
    )

    mask = np.asarray([[1, 1, 0], [1, 0, 0]], np.int32)
    want = np.asarray(jax_bias(jnp.asarray(mask)))
    got = make_attention_bias(torch.from_numpy(mask)).numpy()
    np.testing.assert_array_equal(got, want)
    assert make_attention_bias(None) is None


# ---------------------------------------------------------- BERT model


def _jax_bert(compute_dtype, **overrides):
    cfg = jax_preset("tiny", compute_dtype=compute_dtype, **overrides)
    ids = jnp.ones((2, 16), jnp.int32)
    params = JaxBert(cfg).init(jax.random.key(1), ids, ids,
                               jnp.zeros_like(ids))["params"]
    return JaxBert(cfg), jax.tree.map(np.asarray, params)


def _bert_batch(seed=0, batch=3, seq=16, vocab=1024):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, vocab, (batch, seq)).astype(np.int32)
    mask = np.ones_like(ids)
    mask[1, 11:] = 0
    mask[2, 5:] = 0
    types = np.zeros_like(ids)
    types[:, 8:] = 1
    return ids, mask, types


@pytest.mark.parametrize("width", ["tiny", "h128"])
@pytest.mark.parametrize("compute_dtype,atol", [
    ("float32", 1e-6),
    # bf16 activations over 2 layers, rounded at other places by the two
    # frameworks (logits of the random model are O(0.03); measured 4e-4)
    ("bfloat16", 2e-3),
])
def test_bert_classifier_logits_match_flax(width, compute_dtype, atol):
    # (h) bridged weights, deterministic, padding mask and token types
    over = dict(hidden_size=128, intermediate_size=256) if width == "h128" \
        else {}
    jmodel, params = _jax_bert(compute_dtype, **over)
    ids, mask, types = _bert_batch()
    want = np.asarray(jmodel.apply(
        {"params": params}, jnp.asarray(ids), jnp.asarray(mask),
        jnp.asarray(types),
    ))
    model = BertForSequenceClassification(
        model_preset("tiny", compute_dtype=compute_dtype, **over)
    )
    model.load_state_dict(params_from_jax(params))
    with torch.no_grad():
        got = model(*(torch.from_numpy(a) for a in (ids, mask, types)))
    assert got.dtype == torch.float32 and got.shape == want.shape == (3, 2)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=atol)


def test_bert_weight_bridge_round_trip_and_scanned_trunk():
    _, params = _jax_bert("float32")
    flat = params_from_jax(params)
    model = BertForSequenceClassification(model_preset("tiny"))
    own = model.state_dict()
    assert own.keys() == flat.keys()
    for name in own:
        assert own[name].shape == flat[name].shape, name
    back = params_to_jax(flat)
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        np.testing.assert_array_equal(a, b)
    # a scanned trunk (bert/layers_scan/layer/..., leading [num_layers])
    bert = dict(params["bert"])
    layers = [bert.pop(f"layer_{i}") for i in range(2)]
    bert["layers_scan"] = {"layer": jax.tree.map(
        lambda *xs: np.stack(xs), *layers)}
    scanned = params_from_jax(dict(params, bert=bert))
    assert scanned.keys() == flat.keys()
    for name in flat:
        assert torch.equal(scanned[name], flat[name]), name
    # the JAX model's own scanned layout has the same names and shapes
    _, jscan = _jax_bert("float32", scan_layers=True)
    assert "layers_scan" in jscan["bert"]
    real = params_from_jax(jscan)
    assert {k: v.shape for k, v in real.items()} == {
        k: v.shape for k, v in own.items()}


def test_model_config_defaults_match_jax():
    from pytorch_distributed_training_tpu.utils.config import (
        ModelConfig as JaxModelConfig,
    )
    from pytorch_distributed_training_tpu_torch.utils.config import (
        ModelConfig,
    )

    port, ref = ModelConfig(), JaxModelConfig()
    for f in dataclasses.fields(port):
        assert getattr(port, f.name) == getattr(ref, f.name), f.name
    assert not port.causal
    for name in ("gpt2-medium", "gpt2-tiny"):
        assert model_preset(name).causal
    for name in ("bert-base-cased", "bert-large-cased", "tiny"):
        p, r = model_preset(name), jax_preset(name)
        for f in dataclasses.fields(p):
            assert getattr(p, f.name) == getattr(r, f.name), (name, f.name)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        model_preset("tiny", dropout_impl="exact")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        model_preset("tiny", scan_layers=True)
