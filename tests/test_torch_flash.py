"""Port parity, flash attention: the PyTorch package's plain flash versions
(the CPU side of ``ops/flash_attention.py``, whose kernels run on the card)
against the JAX package's Pallas kernels in interpret mode, on the same
numpy inputs. In interpret mode the TPU PRNG's bits are all zero, so the
parity with JAX is at dropout rate 0; at rate 0.1 the port's flash is held
to the port's own plain attention, which draws the same Philox mask."""

import re

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
    # head_dim > 256, and the two-pass switch, which moves the blockwise
    # backward to flash_dq + flash_dkv and leaves the whole-sequence one
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
    backward = []

    def spy(name):
        real = getattr(fa, name)

        def wrapped(*args, **kw):
            backward.append(name)
            return real(*args, **kw)
        return wrapped

    for name in ("flash_bwd", "flash_dq", "flash_dkv", "flash_whole_bwd"):
        monkeypatch.setattr(fa, name, spy(name))
    for env, seq, want in (("1", 640, ["flash_dq", "flash_dkv"]),
                           ("1", 128, ["flash_whole_bwd"]),
                           ("0", 640, ["flash_bwd"])):
        monkeypatch.setenv("PDT_FLASH_TWO_PASS", env)
        x = torch.randn(1, seq, 1, 8, requires_grad=True)
        backward.clear()
        fa.flash_attention(x, x, x, causal=True).sum().backward()
        assert backward == want, (env, seq)


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


@pytest.mark.parametrize("causal", [False, True])
def test_two_pass_grads_match_jax_two_pass(causal, monkeypatch):
    # case 6: PDT_FLASH_TWO_PASS=1 on both sides: the port's flash_dq +
    # flash_dkv plain versions against the Pallas _dq_kernel and
    # _dkv_kernel (FUSED_BWD False) in interpret mode, block 16 at S 64
    monkeypatch.setattr(jax_fa, "FUSED_BWD", False)
    monkeypatch.setenv("PDT_FLASH_TWO_PASS", "1")
    q, k, v, do, mask = _inputs(seed=4)
    _, _, grads = _jax_base(q, k, v, mask, do, causal=causal, block=16)
    _, pgrads = _port_base(q, k, v, mask, do, causal=causal, block=16)
    for name, got, want in zip("qkv", pgrads, grads):
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL,
                                   err_msg=f"two-pass d{name}")


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_plain_two_pass_equals_plain_fused(rate, monkeypatch):
    # case 7: the two plain halves are the fused plain backward, bit for
    # bit, directly and through the autograd route, with dropout on or off
    q, k, v, do, mask = _inputs(seed=5)
    bias = make_attention_bias(torch.from_numpy(mask))
    t = [torch.from_numpy(a) for a in (q, k, v, do)]
    kw = dict(causal=True, rate=rate, seed=77, site=2)
    o, lse = fa.reference_flash_fwd(*t[:3], bias, **kw)
    dq, dk, dv = fa.reference_flash_bwd(*t[:3], bias, o, lse, t[3], **kw)
    assert torch.equal(fa.flash_dq(*t[:3], bias, o, lse, t[3], **kw), dq)
    dk2, dv2 = fa.flash_dkv(*t[:3], bias, o, lse, t[3], **kw)
    assert torch.equal(dk2, dk) and torch.equal(dv2, dv)
    seed = 77 if rate else None
    grads = {}
    for env in ("0", "1"):
        monkeypatch.setenv("PDT_FLASH_TWO_PASS", env)
        _, grads[env] = _port_base(q, k, v, mask, do, causal=True, block=16,
                                   rate=rate, seed=seed)
    for a, b in zip(grads["0"], grads["1"]):
        np.testing.assert_array_equal(a, b)


# ------------------------------------------- the tensor-core backward's math


def _bf16_values(*arrays):
    """float32 arrays rounded to bf16 values: the operands the tensor-core
    kernels take."""
    return [torch.from_numpy(a).to(torch.bfloat16).float().numpy()
            for a in arrays]


@pytest.mark.parametrize("what", ["p_drop", "ds"])
def test_split_bf16x3_rebuilds_float32_exactly(what):
    # the three-piece split kernel 9 applies to the float32 p_drop (in
    # [0, 1 / (1 - rate)]) and dS (either sign, a wide range of magnitudes)
    # before dv = p_drop^T dO and dk = dS^T q: hi + mid + lo == x exactly,
    # each piece a bf16, where two pieces do not suffice
    rng = np.random.default_rng(3)
    n = 200_000
    if what == "p_drop":
        x = np.concatenate([rng.uniform(0.0, 1.0 / 0.9, n),
                            np.exp(-rng.uniform(0.0, 70.0, n)) / 0.9,
                            [0.0, 1.0, 1.0 / 0.9]])
    else:
        x = np.concatenate([rng.choice([-1.0, 1.0], n)
                            * 10.0 ** rng.uniform(-30.0, 3.0, n),
                            rng.normal(0.0, 1e-3, n), [0.0]])
    x = torch.from_numpy(x.astype(np.float32))
    hi, mid, lo = fa.split_bf16x3(x)
    assert hi.dtype == mid.dtype == lo.dtype == torch.bfloat16
    rebuilt = hi.double() + mid.double() + lo.double()
    assert torch.equal(rebuilt, x.double())
    assert not torch.equal(hi.double() + mid.double(), x.double())


def _three_piece_bwd(q, k, v, bias, o, lse, do, *, causal, rate=0.0,
                     seed=0, site=0):
    """The plain backward with dv and dk as the float32 sums of the three
    bf16-piece products, dk = (dS^T q) * scale as the kernel forms it:
    kernel 11's dk and dv (``_kernel11_dkv``) and the plain dq."""
    _, _, ds = fa._recompute(q, k, v, bias, o, lse, do, causal, rate, seed,
                             site)
    return (fa._dq_from(ds, q, k),
            *_kernel11_dkv(q, k, v, bias, o, lse, do, causal=causal,
                           rate=rate, seed=seed, site=site))


@pytest.mark.parametrize("head_dim", [32, 64])
def test_three_piece_backward_matches_plain_and_jax(head_dim):
    # bf16-valued inputs at S 64 (block 16, causal): the emulation of the
    # tensor-core backward equals reference_flash_bwd within 1e-6 of each
    # gradient's largest magnitude (float32 sums in another order; at D 32
    # also one rounding a term, q * scale against a scale at the end), with
    # dropout on too, and the JAX fused Pallas backward (interpret mode,
    # rate 0) within TOL
    q, k, v, do, mask = _inputs(head_dim=head_dim, seed=9)
    q, k, v, do = _bf16_values(q, k, v, do)
    bias = make_attention_bias(torch.from_numpy(mask))
    t = [torch.from_numpy(a) for a in (q, k, v, do)]
    for rate in (0.0, 0.1):
        kw = dict(causal=True, rate=rate, seed=21, site=2)
        o, lse = fa.reference_flash_fwd(*t[:3], bias, **kw)
        want = fa.reference_flash_bwd(*t[:3], bias, o, lse, t[3], **kw)
        got = _three_piece_bwd(*t[:3], bias, o, lse, t[3], **kw)
        for name, a, b in zip(("dq", "dk", "dv"), got, want):
            limit = 1e-6 * float(b.abs().max())
            assert float((a - b).abs().max()) <= limit, (rate, name)
    _, _, grads = _jax_base(q, k, v, mask, do, causal=True, block=16)
    o, lse = fa.reference_flash_fwd(*t[:3], bias, causal=True)
    got = _three_piece_bwd(*t[:3], bias, o, lse, t[3], causal=True)
    for name, a, b in zip(("dq", "dk", "dv"), got, grads):
        np.testing.assert_allclose(a.numpy(), b, rtol=TOL, atol=TOL,
                                   err_msg=name)


def test_delta_prepass_formula_matches_jax():
    # kernel 9's pre-pass forms delta = rowsum(dO o) in float32 once, as the
    # JAX _vjp_bwd does outside its kernel; the port's plain formula is
    # JAX's on the same bf16 inputs (float32 sums in another order)
    rng = np.random.default_rng(11)
    o, do = (rng.normal(size=(2, 3, 40, 64)).astype(np.float32)
             for _ in range(2))
    o_t, do_t = (torch.from_numpy(a).to(torch.bfloat16) for a in (o, do))
    jo, jdo = (jnp.asarray(a, dtype=jnp.bfloat16) for a in (o, do))
    want = jnp.sum(jdo.astype(jnp.float32) * jo.astype(jnp.float32),
                   axis=-1)
    got = fa._delta(o_t, do_t)[..., 0]
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


# ----------------------------- the tensor-core kernels 11 and 7's math


def _kernel11_dkv(q, k, v, bias, o, lse, do, *, causal, rate=0.0, seed=0,
                  site=0):
    """Kernel 11's arithmetic: delta = rowsum(dO o) in float32 as its
    pre-pass forms it, p = exp(s - lse), dv = p_drop^T dO and dk = (dS^T
    q) * scale (raw q, scaled once) each the float32 sum of three
    bf16-piece products; no dq."""
    scale = q.shape[-1] ** -0.5
    s = fa._scores(q, k, bias, causal)
    p = torch.exp(s - lse[..., None])
    drop = fa._dropper(s.shape, rate, seed, site, q.device)
    delta = (do.float() * o.float()).sum(-1, keepdim=True)
    ds = p * (drop(torch.matmul(do.float(), v.float().transpose(-1, -2)))
              - delta)
    dv = sum(torch.matmul(x.float(), do.float())
             for x in fa.split_bf16x3(drop(p).transpose(-1, -2)))
    dk = sum(torch.matmul(x.float(), q.float())
             for x in fa.split_bf16x3(ds.transpose(-1, -2))) * scale
    return dk, dv


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("head_dim", [32, 64])
def test_kernel11_dkv_emulation_matches_plain(head_dim, rate):
    # (a) bf16-valued inputs at S 64 (causal, a padded key tail): the
    # emulation of the tensor-core dk/dv pass equals reference_flash_dkv
    # within 1e-6 of each gradient's largest magnitude (float32 sums in
    # another order; at D 32 also one rounding a term, q * scale against
    # a scale at the end)
    q, k, v, do, mask = _inputs(head_dim=head_dim, seed=9)
    t = [torch.from_numpy(a) for a in _bf16_values(q, k, v, do)]
    bias = make_attention_bias(torch.from_numpy(mask))
    kw = dict(causal=True, rate=rate, seed=21, site=2)
    o, lse = fa.reference_flash_fwd(*t[:3], bias, **kw)
    got = _kernel11_dkv(*t[:3], bias, o, lse, t[3], **kw)
    want = fa.reference_flash_dkv(*t[:3], bias, o, lse, t[3], **kw)
    for name, a, b in zip(("dk", "dv"), got, want):
        limit = 1e-6 * float(b.abs().max())
        assert float((a - b).abs().max()) <= limit, name


@pytest.mark.parametrize("causal", [False, True])
def test_kernel11_dkv_emulation_matches_jax_two_pass(causal, monkeypatch):
    # (a) the same emulation against the JAX two-pass backward (FUSED_BWD
    # False: the Pallas _dkv_kernel in interpret mode), rate 0, block 16
    # at S 64, on bf16-valued inputs
    monkeypatch.setattr(jax_fa, "FUSED_BWD", False)
    q, k, v, do, mask = _inputs(head_dim=64, seed=6)
    q, k, v, do = _bf16_values(q, k, v, do)
    _, _, (_, jdk, jdv) = _jax_base(q, k, v, mask, do, causal=causal,
                                    block=16)
    t = [torch.from_numpy(a) for a in (q, k, v, do)]
    bias = make_attention_bias(torch.from_numpy(mask))
    o, lse = fa.reference_flash_fwd(*t[:3], bias, causal=causal)
    dk, dv = _kernel11_dkv(*t[:3], bias, o, lse, t[3], causal=causal)
    np.testing.assert_allclose(dk.numpy(), jdk, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(dv.numpy(), jdv, rtol=TOL, atol=TOL)


def _kernel7_stats(s):
    """Kernel 7's first walk, which kernel 8's pre-pass shares: the online
    row max (from -1e30) and sum over 64-key tiles, each lane t of a quad
    summing its columns 2t and 2t + 1 of each group of 8 keys, rescaled to
    the running max, the quad adding its four parts by two xor shuffles at
    the end; (m, l floored at 1e-30), each [..., Sq, 1]. ``s`` holds a
    whole number of 64-key tiles (keys past Sk at -inf, as the kernel's)."""
    m = torch.full((*s.shape[:-1], 1), fa._NEG_INF)
    lane = torch.zeros(*s.shape[:-1], 4, dtype=torch.float32)
    for k0 in range(0, s.shape[-1], 64):
        tile = s[..., k0:k0 + 64]
        m_new = torch.maximum(m, tile.amax(-1, keepdim=True))
        part = torch.exp(tile - m_new).reshape(
            *tile.shape[:-1], 8, 4, 2).sum(dim=(-3, -1))
        lane = lane * torch.exp(m - m_new) + part
        m = m_new
    l = ((lane[..., 0] + lane[..., 1]) + (lane[..., 2] + lane[..., 3]))
    return m, l[..., None].clamp_min(fa._L_FLOOR)


def _kernel7_fwd(q, k, v, bias, *, causal, rate=0.0, seed=0, site=0):
    """Kernel 7's arithmetic: the first walk's m and l (``_kernel7_stats``);
    then p = exp(s - m) / l (normalised before dropout, as JAX
    _mh_softmax), dropped, rounded to v's dtype, P V in float32."""
    s = fa._scores(q, k, bias, causal)
    m, l = _kernel7_stats(s)
    p = torch.exp(s - m) / l
    pd = fa._dropper(p.shape, rate, seed, site, q.device)(p)
    return torch.matmul(pd.to(v.dtype).float(), v.float())


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("seq", [128, 256])
def test_kernel7_emulation_matches_plain_and_jax(seq, causal):
    # (b) [2, 2, S, 64], a padded key tail on row 1: the emulation of the
    # tensor-core whole-sequence forward (two walks over 64-key tiles)
    # equals reference_whole_fwd within 1e-6 of max|o| (float32 sums
    # in another order), with dropout on too, and the JAX whole-sequence
    # Pallas forward (interpret mode, rate 0) within TOL
    q, k, v, _, mask = _inputs(seq=seq, head_dim=64, seed=12,
                               lens=(seq, seq * 2 // 3))
    bias = make_attention_bias(torch.from_numpy(mask))
    t = [torch.from_numpy(a) for a in (q, k, v)]
    for rate in (0.0, 0.1):
        kw = dict(causal=causal, rate=rate, seed=31, site=2)
        got = _kernel7_fwd(*t, bias, **kw)
        want = fa.reference_whole_fwd(*t, bias, **kw)
        limit = 1e-6 * float(want.abs().max())
        assert float((got - want).abs().max()) <= limit, rate
    with jax_fa.tpu_interpret_mode():
        jo = jax_fa._flash_fwd_whole_seq(
            *(jnp.asarray(a) for a in (q, k, v)), jax_bias(jnp.asarray(mask)),
            jnp.zeros((1,), jnp.int32), 0.0, causal)
    got = _kernel7_fwd(*t, bias, causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(jo), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("seq", [128, 256])
def test_kernel7_emulation_bf16_rounds_the_normalised_p(seq, causal):
    # (b) bf16 q, k and v, so the emulation rounds the normalised, dropped
    # p to bf16 before P V, as reference_whole_fwd does. Their bf16 o
    # agree but in at most 1e-3 of the elements, each within one bf16 ulp
    # (2^-7 max(|got|, |want|)) + 1e-3 max|want|: a float32 order of l's
    # sum can move a p across a bf16 rounding boundary. The
    # blockwise kernel's order, round(exp(s - m)) V / l, misses in more
    # than a tenth of them, so the check tells the two orders apart.
    q, k, v, _, mask = _inputs(seq=seq, head_dim=64, seed=12,
                               lens=(seq, seq * 2 // 3))
    bias = make_attention_bias(torch.from_numpy(mask))
    t = [torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)]
    for rate in (0.0, 0.1):
        kw = dict(causal=causal, rate=rate, seed=31, site=2)
        want = fa.reference_whole_fwd(*t, bias, **kw).float()
        got = _kernel7_fwd(*t, bias, **kw).to(torch.bfloat16).float()
        diff = (got - want).abs()
        assert float((diff > 0).float().mean()) <= 1e-3, rate
        limit = (2.0 ** -7 * torch.maximum(got.abs(), want.abs())
                 + 1e-3 * float(want.abs().max()))
        assert bool((diff <= limit).all()), rate
        s = fa._scores(*t[:2], bias, causal)
        e = torch.exp(s - s.amax(-1, keepdim=True).clamp_min(fa._NEG_INF))
        ed = fa._dropper(e.shape, rate, 31, 2, e.device)(e)
        blockwise = (torch.matmul(ed.to(torch.bfloat16).float(), t[2].float())
                     / e.sum(-1, keepdim=True)).to(torch.bfloat16).float()
        assert float((blockwise != want).float().mean()) > 0.1, rate


@pytest.mark.parametrize("name", ["flash_fwd", "flash_bwd", "flash_dq",
                                  "flash_dkv", "flash_whole_fwd",
                                  "flash_whole_bwd"])
def test_bf16_calls_take_the_tensor_core_entry_points(name, monkeypatch):
    # (c) a CUDA-typed call (the device test patched to say "not the
    # CPU", _launch recording instead of launching): bf16 takes the *_mma
    # entry point, float32 the FMA one, each with the pointer count that
    # _ENTRY_POINTERS registers (the stream last); on these CPU tensors
    # flash_dq and flash_dkv take flash_delta's plain delta
    launched = []

    def record(kernel_name, entry, anchor, args, *pointers, count=True):
        assert len(args) == len(fa._COMMON_ARGTYPES)
        assert len(pointers) + 1 == fa._ENTRY_POINTERS[entry], entry
        assert count
        launched.append((kernel_name, entry))

    def not_cpu(fn_name, q, k, v, bias, rate):
        fa._check(fn_name, q, k, v, bias)
        return False

    monkeypatch.setattr(fa, "_launch", record)
    monkeypatch.setattr(fa, "_on_cpu", not_cpu)
    q, k, v, do, mask = _inputs(seq=64, head_dim=32)
    bias = make_attention_bias(torch.from_numpy(mask))
    lse = torch.zeros(2, 2, 64)
    for dtype, entry in ((torch.bfloat16, f"pdt_{name}_mma"),
                         (torch.float32, f"pdt_{name}")):
        t = [torch.from_numpy(a).to(dtype) for a in (q, k, v, do)]
        extra = ((t[0], t[3]) if name == "flash_whole_bwd"
                 else () if "fwd" in name else (t[0], lse, t[3]))
        launched.clear()
        getattr(fa, name)(*t[:3], bias, *extra, causal=True)
        assert launched == [(name, entry)]
    if name.startswith("flash_whole"):
        # past the route's ceiling of 256 keys the bf16 kernels raise
        x = torch.zeros(1, 1, 320, 32, dtype=torch.bfloat16)
        extra = () if name == "flash_whole_fwd" else (x, x)
        with pytest.raises(ValueError, match="at most 256 keys"):
            getattr(fa, name)(x, x, x, torch.zeros(1, 1, 1, 320), *extra,
                              causal=False)


def test_entry_pointer_counts_match_the_cuda_source():
    # (c) every extern "C" entry point of csrc/flash_attention.cu takes,
    # after the common arguments, the pointers _ENTRY_POINTERS counts
    from pytorch_distributed_training_tpu_torch.ops import _build

    src = (_build.CSRC_DIR / "flash_attention.cu").read_text()
    entries = re.findall(
        r'extern "C" int (\w+)\(PDT_FLASH_COMMON_ARGS,([^)]*)\)', src)
    assert {e for e, _ in entries} == set(fa._ENTRY_POINTERS)
    for entry, rest in entries:
        assert rest.count(",") + 1 == fa._ENTRY_POINTERS[entry], entry


# ----------------------------- the tensor-core kernels 10 and 8's math


def _kernel10_dq(q, k, v, bias, o, lse, do, *, causal, rate=0.0, seed=0,
                 site=0):
    """Kernel 10's arithmetic: delta from the pre-pass's formula
    (``flash_delta``); per 64-key tile, in order, p = exp(s - lse), dP = dO
    V^T dropped (p never, as JAX _dq_kernel), ds = p (dP - delta) and dq +=
    round(ds) K in float32 (ds rounded to k's dtype before the product);
    dq * scale at the end."""
    s = fa._scores(q, k, bias, causal)
    p = torch.exp(s - lse[..., None])
    dp = fa._dropper(s.shape, rate, seed, site, q.device)(
        torch.matmul(do.float(), v.float().transpose(-1, -2)))
    ds = p * (dp - fa.flash_delta(o, do)[..., None])
    dq = torch.zeros(q.shape, dtype=torch.float32)
    for k0 in range(0, k.shape[2], 64):
        dq = dq + torch.matmul(ds[..., k0:k0 + 64].to(k.dtype).float(),
                               k[..., k0:k0 + 64, :].float())
    return dq * q.shape[-1] ** -0.5


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("head_dim", [32, 64])
def test_kernel10_dq_emulation_matches_plain(head_dim, rate):
    # (a) bf16-valued inputs at S 192 (three 64-key tiles, causal, a padded
    # key tail): the emulation of the tensor-core dq pass equals
    # reference_flash_dq within 1e-6 of max|dq| (float32 sums in another
    # order), and so does the plain version handed flash_delta's delta
    q, k, v, do, mask = _inputs(seq=192, head_dim=head_dim, seed=14,
                                lens=(192, 130))
    t = [torch.from_numpy(a) for a in _bf16_values(q, k, v, do)]
    bias = make_attention_bias(torch.from_numpy(mask))
    kw = dict(causal=True, rate=rate, seed=23, site=2)
    o, lse = fa.reference_flash_fwd(*t[:3], bias, **kw)
    want = fa.reference_flash_dq(*t[:3], bias, o, lse, t[3], **kw)
    limit = 1e-6 * float(want.abs().max())
    got = _kernel10_dq(*t[:3], bias, o, lse, t[3], **kw)
    assert float((got - want).abs().max()) <= limit
    given = fa.reference_flash_dq(*t[:3], bias, o, lse, t[3],
                                  delta=fa.flash_delta(o, t[3]), **kw)
    assert torch.equal(given, want)


@pytest.mark.parametrize("causal", [False, True])
def test_kernel10_dq_emulation_matches_jax_two_pass(causal, monkeypatch):
    # (a) the same emulation against the JAX two-pass backward (FUSED_BWD
    # False: the Pallas _dq_kernel in interpret mode), rate 0, block 64 at
    # S 128 (two k-tiles), on bf16-valued inputs
    monkeypatch.setattr(jax_fa, "FUSED_BWD", False)
    q, k, v, do, mask = _inputs(seq=128, head_dim=64, seed=15,
                                lens=(128, 85))
    q, k, v, do = _bf16_values(q, k, v, do)
    _, _, (jdq, _, _) = _jax_base(q, k, v, mask, do, causal=causal,
                                  block=64)
    t = [torch.from_numpy(a) for a in (q, k, v, do)]
    bias = make_attention_bias(torch.from_numpy(mask))
    o, lse = fa.reference_flash_fwd(*t[:3], bias, causal=causal)
    dq = _kernel10_dq(*t[:3], bias, o, lse, t[3], causal=causal)
    np.testing.assert_allclose(dq.numpy(), jdq, rtol=TOL, atol=TOL)


def test_kernel10_ds_rounds_to_bf16_before_k():
    # (a) bf16 q, k, v and dO: the emulation rounds ds to bf16 before the
    # K product, as reference_flash_dq does; their bf16 dq agree but in at
    # most 1e-3 of the elements, each within one bf16 ulp (float32 sums in
    # another order can move a dq across a rounding boundary) + 1e-3
    # max|want|
    q, k, v, do, mask = _inputs(seq=192, head_dim=64, seed=16,
                                lens=(192, 130))
    t = [torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v, do)]
    bias = make_attention_bias(torch.from_numpy(mask))
    for rate in (0.0, 0.1):
        kw = dict(causal=True, rate=rate, seed=24, site=2)
        o, lse = fa.reference_flash_fwd(*t[:3], bias, **kw)
        want = fa.reference_flash_dq(*t[:3], bias, o, lse, t[3], **kw)
        got = _kernel10_dq(*t[:3], bias, o, lse, t[3], **kw).to(
            torch.bfloat16)
        want, got = want.float(), got.float()
        diff = (got - want).abs()
        assert float((diff > 0).float().mean()) <= 1e-3, rate
        limit = (2.0 ** -7 * torch.maximum(got.abs(), want.abs())
                 + 1e-3 * float(want.abs().max()))
        assert bool((diff <= limit).all()), rate


def _kernel8_bwd(q, k, v, bias, o, do, *, causal, rate=0.0, seed=0,
                 site=0):
    """Kernel 8's arithmetic: the pre-pass's m and l by kernel 7's walk
    (``_kernel7_stats``) and delta = rowsum(dO o); p = exp(s - m) / l,
    normalised before dropout; dv = p_drop^T dO as the float32 sum of three
    bf16-piece products; dk = (round(dS)^T q) * scale, one product on q as
    given; dq the per-64-key-tile partials (round(dS) K) * scale summed in
    k-tile order (the dq sum)."""
    scale = q.shape[-1] ** -0.5
    sk = k.shape[2]
    pad = -sk % 64  # the kernel's keys past Sk: -inf, p = 0
    s = torch.nn.functional.pad(fa._scores(q, k, bias, causal), (0, pad),
                                value=-float("inf"))
    m, l = _kernel7_stats(s)
    p = (torch.exp(s - m) / l)[..., :sk]
    drop = fa._dropper(p.shape, rate, seed, site, q.device)
    delta = (do.float() * o.float()).sum(-1, keepdim=True)
    ds = p * (drop(torch.matmul(do.float(), v.float().transpose(-1, -2)))
              - delta)
    dv = sum(torch.matmul(x.float(), do.float())
             for x in fa.split_bf16x3(drop(p).transpose(-1, -2)))
    dk = torch.matmul(ds.to(q.dtype).float().transpose(-1, -2),
                      q.float()) * scale
    dq = torch.zeros(q.shape, dtype=torch.float32)
    for k0 in range(0, sk, 64):
        dq = dq + torch.matmul(ds[..., k0:k0 + 64].to(k.dtype).float(),
                               k[..., k0:k0 + 64, :].float()) * scale
    return dq, dk, dv


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("seq", [128, 256])
def test_kernel8_emulation_matches_plain(seq, causal):
    # (b) [2, 2, S, 64] bf16-valued inputs, a padded key tail on row 1:
    # the emulation of the tensor-core whole-sequence backward equals
    # reference_whole_bwd within 1e-6 of each gradient's largest magnitude
    # (float32 sums in another order), at rates 0 and 0.1; dv within 2e-6:
    # it sums up to 256 p of one sign, each a float32 ulp or two from the
    # plain p (l summed in kernel 7's lane order), 1.5e-6 at S 256 causal
    q, k, v, do, mask = _inputs(seq=seq, head_dim=64, seed=17,
                                lens=(seq, seq * 2 // 3))
    t = [torch.from_numpy(a) for a in _bf16_values(q, k, v, do)]
    bias = make_attention_bias(torch.from_numpy(mask))
    for rate in (0.0, 0.1):
        kw = dict(causal=causal, rate=rate, seed=33, site=2)
        o = fa.reference_whole_fwd(*t[:3], bias, **kw)
        want = fa.reference_whole_bwd(*t[:3], bias, o, t[3], **kw)
        got = _kernel8_bwd(*t[:3], bias, o, t[3], **kw)
        for name, a, b in zip(("dq", "dk", "dv"), got, want):
            limit = (2e-6 if name == "dv" else 1e-6) * float(b.abs().max())
            assert float((a - b).abs().max()) <= limit, (rate, name)


@pytest.mark.parametrize("causal", [False, True])
def test_kernel8_emulation_matches_jax_whole_sequence(causal):
    # (b) the same emulation against the JAX whole-sequence backward
    # (_mh_bwd_kernel in interpret mode), rate 0, S 128 = the block, on
    # bf16-valued inputs
    q, k, v, do, mask = _inputs(seq=128, head_dim=64, seed=18,
                                lens=(128, 85))
    q, k, v, do = _bf16_values(q, k, v, do)
    _, _, grads = _jax_base(q, k, v, mask, do, causal=causal, block=128)
    t = [torch.from_numpy(a) for a in (q, k, v, do)]
    bias = make_attention_bias(torch.from_numpy(mask))
    o = fa.reference_whole_fwd(*t[:3], bias, causal=causal)
    got = _kernel8_bwd(*t[:3], bias, o, t[3], causal=causal)
    for name, a, b in zip(("dq", "dk", "dv"), got, grads):
        np.testing.assert_allclose(a.numpy(), b, rtol=TOL, atol=TOL,
                                   err_msg=name)


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_two_pass_backward_forms_delta_once(rate, monkeypatch):
    # (d) the two-pass route forms delta = rowsum(dO o) once (flash_delta)
    # and hands the same tensor to flash_dq and flash_dkv, as the JAX
    # _vjp_bwd does; the fused route forms it inside flash_bwd
    formed, handed = [], []
    real_delta = fa._delta

    def count_delta(o, do):
        formed.append(o.shape)
        return real_delta(o, do)

    def spy(name):
        real = getattr(fa, name)

        def wrapped(*args, **kw):
            handed.append((name, kw.get("delta")))
            return real(*args, **kw)
        return wrapped

    monkeypatch.setattr(fa, "_delta", count_delta)
    for name in ("flash_dq", "flash_dkv"):
        monkeypatch.setattr(fa, name, spy(name))
    monkeypatch.setenv("PDT_FLASH_TWO_PASS", "1")
    q, k, v, do, mask = _inputs(seed=19)
    _port_base(q, k, v, mask, do, causal=True, block=16, rate=rate,
               seed=5 if rate else None)
    assert len(formed) == 1
    assert [n for n, _ in handed] == ["flash_dq", "flash_dkv"]
    assert handed[0][1] is handed[1][1] is not None
    assert handed[0][1].shape == (2, 2, 64)
