"""Port parity, ops and model: the PyTorch package's plain kernel versions
and GPT-2 model against the JAX package on the same numpy inputs, on the
CPU (Pallas kernels in interpret mode). The CUDA kernels themselves run
only on the card (``chip_smoke.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_training_tpu.models.gpt2 import GPT2LMModel as JaxGPT2
from pytorch_distributed_training_tpu.models.relayout import stack_layer_params
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
from pytorch_distributed_training_tpu_torch.models.gpt2 import GPT2LMModel
from pytorch_distributed_training_tpu_torch.ops import _build
from pytorch_distributed_training_tpu_torch.ops.attention import (
    make_attention_bias,
)
from pytorch_distributed_training_tpu_torch.ops.layer_norm import (
    FusedLayerNorm,
    layer_norm,
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
    assert set(_build.KERNEL_SOURCES) == {"layer_norm", "paged_attention"}
    for src in _build.KERNEL_SOURCES.values():
        assert (_build.CSRC_DIR / src).exists()


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
