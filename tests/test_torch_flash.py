"""Port parity, flash attention: the PyTorch package's plain flash versions
(the CPU side of ``ops/flash_attention.py``, whose kernels run on the card)
against the JAX package's Pallas kernels in interpret mode, on the same
numpy inputs. In interpret mode the TPU PRNG's bits are all zero, so the
parity with JAX is at dropout rate 0; at rate 0.1 the port's flash is held
to the port's own plain attention, which draws the same Philox mask."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_training_tpu.ops import flash_attention as jax_fa
from pytorch_distributed_training_tpu.ops.attention import (
    make_attention_bias as jax_bias,
)
from pytorch_distributed_training_tpu_torch.ops import flash_attention as fa
from pytorch_distributed_training_tpu_torch.ops.attention import (
    make_attention_bias,
    reference_attention,
)
from pytorch_distributed_training_tpu_torch.ops.dropout import keep_mask

torch.set_num_threads(2)

# float32 on both sides; the sums run in other orders (blockwise online
# softmax against one pass), a few float32 ulps of unit-scale values
TOL = 1e-5


def _inputs(batch=2, seq=64, heads=2, head_dim=16, seed=0, lens=(64, 40)):
    """[B, N, S, D] q, k, v and a cotangent, and a [B, S] mask with a
    padded tail on row 1."""
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.normal(size=(batch, heads, seq, head_dim)).astype(
        np.float32) for _ in range(4))
    mask = (np.arange(seq)[None, :] < np.asarray(lens)[:, None]).astype(
        np.int32)
    return q, k, v, do, mask


def _jax_base(q, k, v, mask, do, *, causal, block):
    """JAX flash_attention_base in interpret mode: (o, lse, (dq, dk, dv))."""
    bias = jax_bias(jnp.asarray(mask))
    seed = jnp.zeros((1,), jnp.int32)
    args = [jnp.asarray(a) for a in (q, k, v)]
    with jax_fa.tpu_interpret_mode():
        o, vjp = jax.vjp(
            lambda q, k, v: jax_fa.flash_attention_base(
                q, k, v, bias, seed, causal=causal, block_q=block,
                block_k=block),
            *args)
        grads = vjp(jnp.asarray(do))
        lse = None
        if not jax_fa._whole_seq(args[0], args[1], block, block):
            lse = jax_fa._flash_fwd(*args, bias, seed, 0.0, causal, block,
                                    block)[1][..., 0]
    return (np.asarray(o), None if lse is None else np.asarray(lse),
            [np.asarray(g) for g in grads])


def _port_base(q, k, v, mask, do, *, causal, block, rate=0.0, seed=None):
    bias = make_attention_bias(torch.from_numpy(mask))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    o = fa.flash_attention_base(*leaves, bias, seed, dropout_rate=rate,
                                causal=causal, block_q=block, block_k=block,
                                dropout_site=2)
    grads = torch.autograd.grad(o, leaves, torch.from_numpy(do))
    return o.detach(), [g.numpy() for g in grads]


@pytest.mark.parametrize("causal", [False, True])
def test_blockwise_fwd_lse_and_grads_match_jax(causal):
    # case 1: block 16 at S 64 (4 x 4 blocks, the causal skip), a padded
    # key tail on row 1
    q, k, v, do, mask = _inputs()
    o, lse, grads = _jax_base(q, k, v, mask, do, causal=causal, block=16)
    bias = make_attention_bias(torch.from_numpy(mask))
    t = [torch.from_numpy(a) for a in (q, k, v)]
    po, plse = fa.reference_flash_fwd(*t, bias, causal=causal)
    np.testing.assert_allclose(po.numpy(), o, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(plse.numpy(), lse, rtol=TOL, atol=TOL)
    # the differentiable path routes to the blockwise pair at block 16
    po2, pgrads = _port_base(q, k, v, mask, do, causal=causal, block=16)
    np.testing.assert_array_equal(po2.numpy(), po.numpy())
    for name, got, want in zip("qkv", pgrads, grads):
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("causal", [False, True])
def test_whole_sequence_fwd_and_grads_match_jax(causal):
    # case 2: S 32 = block 32 <= 256 takes the whole-sequence pair in both
    q, k, v, do, mask = _inputs(seq=32, lens=(32, 21), seed=1)
    assert fa.whole_seq(32, 32, 32, 32)
    o, _, grads = _jax_base(q, k, v, mask, do, causal=causal, block=32)
    po, pgrads = _port_base(q, k, v, mask, do, causal=causal, block=32)
    np.testing.assert_allclose(po.numpy(), o, rtol=TOL, atol=TOL)
    for name, got, want in zip("qkv", pgrads, grads):
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("block", [16, 64])
@pytest.mark.parametrize("causal", [False, True])
def test_dropout_is_the_plain_attentions_philox_mask(block, causal):
    # case 3: rate 0.1, blockwise (block 16) and whole-sequence (block 64),
    # against reference_attention with the same seed and site: the same
    # mask, so equal up to the scale's rounding (p / 0.9 against p * the
    # float32 1/0.9), in the forward and the gradients
    rate, seed = 0.1, 1234
    q, k, v, do, mask = _inputs(seed=2)
    po, pgrads = _port_base(q, k, v, mask, do, causal=causal, block=block,
                            rate=rate, seed=seed)
    bias = make_attention_bias(torch.from_numpy(mask))
    leaves = [torch.from_numpy(a).transpose(1, 2).requires_grad_()
              for a in (q, k, v)]
    ro = reference_attention(*leaves, bias, causal=causal, dropout_rate=rate,
                             dropout_seed=seed, dropout_site=2)
    rgrads = torch.autograd.grad(ro, leaves,
                                 torch.from_numpy(do).transpose(1, 2))
    np.testing.assert_allclose(po.numpy(), ro.detach().transpose(1, 2),
                               rtol=TOL, atol=TOL)
    for name, got, want in zip("qkv", pgrads, rgrads):
        np.testing.assert_allclose(got, want.transpose(1, 2).numpy(),
                                   rtol=TOL, atol=TOL, err_msg=f"d{name}")
    # the mask is the one the plain attention draws, and a different seed
    # gives a different output
    keep = fa.probs_keep((2, 2, 64, 64), rate, seed, 2)
    assert torch.equal(keep, keep_mask((2, 2, 64, 64), rate, seed, 2))
    assert abs(float(keep.float().mean()) - (1.0 - rate)) < 0.01
    other, _ = _port_base(q, k, v, mask, do, causal=causal, block=block,
                          rate=rate, seed=seed + 1)
    assert float((other - po).abs().max()) > 1e-3


@pytest.mark.parametrize("block", [16, 32])
def test_fully_masked_row_stays_finite_and_zero(block):
    # case 4: row 1 masked out entirely, blockwise and whole-sequence
    q, k, v, do, mask = _inputs(seq=32, lens=(32, 0), seed=8)
    for causal in (False, True):
        o, grads = _port_base(q, k, v, mask, do, causal=causal, block=block)
        assert np.isfinite(o.numpy()).all()
        assert all(np.isfinite(g).all() for g in grads)
        np.testing.assert_array_equal(o[1].numpy(), 0.0)
        # nothing flows through keys that every row has masked
        np.testing.assert_array_equal(grads[1][1], 0.0)
        np.testing.assert_array_equal(grads[2][1], 0.0)
    # the JAX kernels agree on the same row
    jo, _, jgrads = _jax_base(q, k, v, mask, do, causal=False, block=block)
    po, pgrads = _port_base(q, k, v, mask, do, causal=False, block=block)
    np.testing.assert_allclose(po.numpy(), jo, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(pgrads[0], jgrads[0], rtol=TOL, atol=TOL)


def test_adapter_routes_like_the_jax_adapter(monkeypatch):
    # case 5: pick_block with a cap of 512, the whole-sequence route at
    # S <= 256, the plain attention for other biases, ragged lengths and
    # head_dim > 256, and the two-pass switch refused
    calls = []
    real_base = fa.flash_attention_base

    def spy_base(q, k, v, bias, seed, **kw):
        calls.append(("flash", q.shape[2], kw["block_q"], kw["block_k"],
                      fa.whole_seq(q.shape[2], k.shape[2], kw["block_q"],
                                   kw["block_k"])))
        return real_base(q, k, v, bias, seed, **kw)

    def spy_ref(q, *args, **kw):
        calls.append(("reference", q.shape[1]))
        return torch.zeros_like(q)

    monkeypatch.setattr(fa, "flash_attention_base", spy_base)
    monkeypatch.setattr(fa, "reference_attention", spy_ref)

    def run(seq, head_dim=8, heads=1, bias_shape=None):
        x = torch.zeros(1, seq, heads, head_dim)
        bias = None if bias_shape is None else torch.zeros(bias_shape)
        calls.clear()
        fa.flash_attention(x, x, x, bias, causal=True)
        return calls[0]

    assert run(128) == ("flash", 128, 128, 128, True)
    assert run(256, bias_shape=(1, 1, 1, 256)) == ("flash", 256, 256, 256,
                                                   True)
    assert run(384) == ("flash", 384, 384, 384, False)
    assert run(640) == ("flash", 640, 128, 128, False)
    assert run(1024) == ("flash", 1024, 512, 512, False)
    assert run(768) == ("flash", 768, 384, 384, False)
    assert run(700) == ("reference", 700)
    assert run(128, heads=2, bias_shape=(1, 2, 1, 128)) == ("reference", 128)
    assert run(128, bias_shape=(1, 1, 128, 128)) == ("reference", 128)
    assert run(16, head_dim=320) == ("reference", 16)
    assert fa.pick_block(640, 512) == 128
    assert jax_fa.DEFAULT_BLOCK_Q == fa.DEFAULT_BLOCK_Q == 512
    assert jax_fa._WHOLE_SEQ_MAX == fa._WHOLE_SEQ_MAX
    monkeypatch.setenv("PDT_FLASH_TWO_PASS", "1")
    x = torch.zeros(1, 128, 1, 8)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        fa.flash_attention(x, x, x, causal=True)


def test_kernel_wrappers_check_their_inputs():
    q, k, v, do, mask = _inputs(seq=16, lens=(16, 8))
    t = [torch.from_numpy(a) for a in (q, k, v)]
    bias = make_attention_bias(torch.from_numpy(mask))
    with pytest.raises(ValueError, match=r"\[B, 1, 1, Sk\]"):
        fa.flash_fwd(*t, bias[:, :, :, :8], causal=True)
    with pytest.raises(ValueError, match="rate"):
        fa.flash_fwd(*t, bias, causal=True, rate=1.0)
    with pytest.raises(ValueError, match="v shaped as k"):
        fa.flash_whole_fwd(t[0], t[1], t[2][:, :, :8], bias, causal=True)
    # the CPU path runs the plain version and launches nothing
    from pytorch_distributed_training_tpu_torch.ops import _build

    before = dict(_build.LAUNCH_COUNTS)
    o, lse = fa.flash_fwd(*t, bias, causal=True)
    assert o.shape == t[0].shape and lse.shape == t[0].shape[:3]
    assert dict(_build.LAUNCH_COUNTS) == before
