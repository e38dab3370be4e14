"""Port parity, int8 serving: the PyTorch package's quantizers
(``ops/quant.py``), int8-pool paged attention (``ops/paged_attention.py``
with scale pools) and the int8-weight and int8-KV engines against the JAX
package on the same numpy inputs and bridged gpt2-tiny weights, on the CPU
(every kernel through its plain version)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_training_tpu.models.gpt2 import GPT2LMModel as JaxGPT2
from pytorch_distributed_training_tpu.ops import paged_attention as jax_pa
from pytorch_distributed_training_tpu.ops import quant as jax_quant
from pytorch_distributed_training_tpu.ops.flash_attention import (
    tpu_interpret_mode,
)
from pytorch_distributed_training_tpu.serve import (
    EngineConfig as JaxEngineConfig,
)
from pytorch_distributed_training_tpu.serve import (
    InferenceServer as JaxServer,
)
from pytorch_distributed_training_tpu.serve.server import wait_until
from pytorch_distributed_training_tpu.utils.config import (
    model_preset as jax_preset,
)
from pytorch_distributed_training_tpu_torch.models.convert import (
    params_from_jax,
    params_to_jax,
)
from pytorch_distributed_training_tpu_torch.models.gpt2 import GPT2LMModel
from pytorch_distributed_training_tpu_torch.ops import quant
from pytorch_distributed_training_tpu_torch.ops.paged_attention import (
    paged_attention,
)
from pytorch_distributed_training_tpu_torch.serve import (
    EngineConfig,
    InferenceServer,
)
from pytorch_distributed_training_tpu_torch.utils.config import model_preset

torch.set_num_threads(2)

# gpt2-tiny: 2 layers, 4 heads of head_dim 16
LAYERS, HEADS, HEAD_DIM = 2, 4, 16
BUCKETS = (8, 16)


@pytest.fixture(scope="module")
def lms():
    """The JAX gpt2-tiny (fp32) and its params, and the port's model on the
    same weights snapped to the int8 grid (quantization is then lossless:
    a float engine and an int8-weight engine run identical projections)."""
    cfg = jax_preset(
        "gpt2-tiny", compute_dtype="float32", attention_impl="reference",
        hidden_dropout=0.0, attention_dropout=0.0,
    )
    jmodel = JaxGPT2(cfg)
    params = jmodel.init(jax.random.key(0), jnp.ones((2, 16), jnp.int32))[
        "params"
    ]
    snapped = jax_quant.dequantize_serve_params(
        jax_quant.quantize_serve_params(params))
    model = GPT2LMModel(model_preset("gpt2-tiny", compute_dtype="float32"))
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, snapped)))
    return (jmodel, params, snapped), model


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _prompts(lengths, seed=7, vocab=1024):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, n).astype(np.int32) for n in lengths]


def _serve(server, prompts, T, *, serial=False):
    """Greedy streams of ``prompts`` (one at a time with ``serial``, so each
    prompt's pages are in the prefix cache before the next matches)."""
    server.start()
    try:
        reqs = []
        for i, p in enumerate(prompts):
            reqs.append(server.submit(p, max_new_tokens=T, seed=i))
            if serial:
                assert wait_until(reqs[-1].done.is_set, timeout=120)
        assert wait_until(lambda: all(r.done.is_set() for r in reqs),
                          timeout=120)
    finally:
        server.close()
    assert all(r.status == "done" for r in reqs), [r.status for r in reqs]
    return [list(r.tokens) for r in reqs], server.stats()


def _cfg(T, kw):
    kw.setdefault("prompt_buckets", BUCKETS)
    kw.setdefault("page_size", 4)
    return dict(num_slots=2, max_new_tokens=T, **kw)


def _port(model, T, **kw):
    return InferenceServer(model, EngineConfig(**_cfg(T, kw)), device="cpu",
                           queue_depth=16)


def _jax(jlm, T, *, params=None, **kw):
    jmodel, _, snapped = jlm
    return JaxServer(jmodel, snapped if params is None else params,
                     JaxEngineConfig(**_cfg(T, kw)), queue_depth=16)


# ------------------------------------------------------------ quantizers


def _kv_values():
    """Seeded K/V-like rows, plus an all-zero row (the 1e-12 floor) and a
    row of exact half-step ties (absmax 127 -> scale 1: x.5 rounds to the
    even neighbour)."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(5, 4, HEADS, HEAD_DIM)).astype(np.float32) * 3.0
    x[1, 2, 0] = 0.0
    ties = np.arange(HEAD_DIM, dtype=np.float32) - 7.5      # -7.5 .. 7.5
    ties[0] = 127.0
    x[2, 1, 3] = ties
    return x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kv_bit_identical_to_jax(dtype):
    x = _kv_values()
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    q, s = quant.quantize_kv(tx)
    jq, js = jax_quant.quantize_kv(jx)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert tuple(s.shape) == x.shape[:3]
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    # the floor: an all-zero row is zeros at scale 1e-12 / 127
    assert not q[1, 2, 0].any() and float(s[1, 2, 0]) > 0
    if dtype == "float32":
        # the ties round half to even
        assert q[2, 1, 3, 1:].tolist() == [-6, -6, -4, -4, -2, -2, 0, 0, 2,
                                           2, 4, 4, 6, 6, 8]


@pytest.mark.parametrize("shape,n_contract", [((64, 4, 16), 1),
                                              ((4, 16, 64), 2),
                                              ((64, 128), 1)])
def test_quantize_kernel_bit_identical_to_jax(shape, n_contract):
    rng = np.random.default_rng(n_contract)
    w = (rng.normal(size=shape) * 0.02).astype(np.float32)
    w[..., 0] = 0.0       # an all-zero output channel
    q, s = quant.quantize_kernel(torch.from_numpy(w), n_contract)
    jq, js = jax_quant.quantize_kernel(jnp.asarray(w), n_contract)
    assert s.shape == js.shape and s.shape[:n_contract] == (1,) * n_contract
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))


def test_quantize_serve_params_matches_jax_and_round_trips(lms):
    """The port's state-dict quantizer gives the JAX tree's int8 kernels and
    scales bit for bit (through the weight bridge, both ways), quantizes
    exactly the six projections of every block, and its inverse, variant
    test and idempotence agree with the JAX package's."""
    (_, params, _), _ = lms
    sd = params_from_jax(_np_tree(params))
    got = quant.quantize_serve_params(sd)
    want = params_from_jax(_np_tree(jax_quant.quantize_serve_params(params)))
    assert got.keys() == want.keys()
    for name in want:
        assert got[name].dtype == want[name].dtype, name
        np.testing.assert_array_equal(got[name].numpy(), want[name].numpy(),
                                      err_msg=name)
    scaled = sorted(n[: -len(".kernel_scale")] for n in got
                    if n.endswith(".kernel_scale"))
    assert scaled == sorted(
        f"blocks.{i}.{m}" for i in range(LAYERS)
        for m in ("attention.query", "attention.key", "attention.value",
                  "attention.out", "mlp_up", "mlp_down"))
    assert got["wte.embedding"].dtype == torch.float32
    # variants and the inverse, both packages
    assert quant.serve_params_variant(got) == "int8"
    assert quant.serve_params_variant(sd) == "fp32"
    back = quant.dequantize_serve_params(got)
    jback = params_from_jax(_np_tree(jax_quant.dequantize_serve_params(
        jax_quant.quantize_serve_params(params))))
    assert back.keys() == sd.keys() == jback.keys()
    for name in back:
        np.testing.assert_array_equal(back[name].numpy(),
                                      jback[name].numpy(), err_msg=name)
    assert quant.dequantize_serve_params(sd) == sd
    # idempotent: an int8 dict stays as it is, a snapped one requantizes
    # to the same int8 kernels and scales
    again = quant.quantize_serve_params(got)
    snap = quant.quantize_serve_params(back)
    for name in got:
        assert again[name] is got[name]
        np.testing.assert_array_equal(snap[name].numpy(), got[name].numpy())
    # the bridge keeps int8 kernels int8 on the way back to flax
    tree = params_to_jax(got)
    jq = jax_quant.quantize_serve_params(params)
    kernel = tree["block_0"]["attention"]["query"]["kernel"]
    assert kernel.dtype == np.int8
    np.testing.assert_array_equal(
        kernel, np.asarray(jq["block_0"]["attention"]["query"]["kernel"]))
    assert jax_quant.serve_params_variant(tree) == "int8"


def test_int8_tree_from_jax_loads_unchanged_and_dequantizes_per_call(lms):
    """An int8 tree from the JAX package loads into the port as it is (int8
    kernels, fp32 scales, no grad); the model's forward equals one on the
    dequantized weights, and ``cast_for_serving("int8")`` on the float
    weights builds the same resident layout."""
    (_, params, _), _ = lms
    jq = _np_tree(jax_quant.quantize_serve_params(params))
    cfg = model_preset("gpt2-tiny", compute_dtype="float32")
    loaded = GPT2LMModel(cfg)
    loaded.load_state_dict(params_from_jax(jq))
    att = loaded.blocks[1].attention
    assert att.out.kernel.dtype == torch.int8
    assert not att.out.kernel.requires_grad
    assert att.out.kernel_scale.shape == (1, 1, cfg.hidden_size)
    np.testing.assert_array_equal(att.out.kernel.numpy(),
                                  jq["block_1"]["attention"]["out"]["kernel"])
    cast = GPT2LMModel(cfg)
    cast.load_state_dict(params_from_jax(_np_tree(params)))
    cast.cast_for_serving("int8")
    deq = GPT2LMModel(cfg)
    deq.load_state_dict(params_from_jax(_np_tree(
        jax_quant.dequantize_serve_params(jq))))
    sd_loaded, sd_cast = loaded.state_dict(), cast.state_dict()
    assert sd_loaded.keys() == sd_cast.keys()
    for name in sd_loaded:
        assert torch.equal(sd_loaded[name], sd_cast[name]), name
    ids = torch.from_numpy(_prompts([12], seed=3)[0].astype(np.int64))[None]
    with torch.no_grad():
        for m in (loaded, cast):
            np.testing.assert_array_equal(m(ids).numpy(), deq(ids).numpy())


# ------------------------------------------------ int8-pool paged attention


def _pools():
    """The JAX test's pools: 6 pages of 4, 3 sequences on permuted pages
    with null-page tails, lengths 6, 11 and 3."""
    rng = np.random.default_rng(0)
    P, S, B = 6, 4, 3
    k = rng.normal(size=(P, S, HEADS, HEAD_DIM)).astype(np.float32)
    v = rng.normal(size=(P, S, HEADS, HEAD_DIM)).astype(np.float32)
    q = rng.normal(size=(B, 3, HEADS, HEAD_DIM)).astype(np.float32)
    bt = np.asarray([[1, 2, 0], [3, 4, 5], [2, 0, 0]], np.int32)
    lengths = np.asarray([6, 11, 3], np.int32)
    return q, k, v, bt, lengths


@pytest.mark.parametrize("q_rows", [0, 1, 3])
@pytest.mark.parametrize("q_dtype", ["float32", "bfloat16"])
def test_int8_paged_attention_matches_jax_reference_and_pallas(q_rows,
                                                               q_dtype):
    """3-D q (``q_rows`` 0) and 4-D q blocks on int8 pools: the port's plain
    int8 path equals the JAX reference and the Pallas kernel in interpret
    mode on the same int8 pools and scales; float32 out; within 0.05 of
    the float pools."""
    q, k, v, bt, lengths = _pools()
    q = q[:, 0] if q_rows == 0 else q[:, :q_rows]
    scale = HEAD_DIM ** -0.5
    kq, ks = quant.quantize_kv(torch.from_numpy(k))
    vq, vs = quant.quantize_kv(torch.from_numpy(v))
    tq = torch.from_numpy(q).to(getattr(torch, q_dtype))
    jq = jnp.asarray(q).astype(getattr(jnp, q_dtype))
    tables = (torch.from_numpy(bt), torch.from_numpy(lengths))
    got = paged_attention(tq, kq, vq, *tables, scale=scale, k_scales=ks,
                          v_scales=vs)
    assert got.dtype == torch.float32 and got.shape == tq.shape
    jargs = [jnp.asarray(a.numpy()) for a in (kq, vq)] + [jnp.asarray(bt),
                                                         jnp.asarray(lengths)]
    jscales = dict(k_scales=jnp.asarray(ks.numpy()),
                   v_scales=jnp.asarray(vs.numpy()))
    ref = jax_pa.paged_attention(jq, *jargs, scale=scale, impl="reference",
                                 **jscales)
    with tpu_interpret_mode():
        pal = jax_pa.paged_attention(jq, *jargs, scale=scale, impl="pallas",
                                     **jscales)
    assert ref.dtype == jnp.float32
    for want in (ref, pal):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                                   rtol=1e-5)
    exact = paged_attention(tq.float(), torch.from_numpy(k),
                            torch.from_numpy(v), *tables, scale=scale)
    assert float((got - exact).abs().max()) < 0.05


def test_scale_pool_validation_named_axes():
    """The counterpart of the JAX package's named-axis scale-pool contract:
    the same cases raise the same errors in both packages."""
    q, k, v, bt, lengths = _pools()
    q = q[:, 0]
    kq, ks = quant.quantize_kv(torch.from_numpy(k))
    vq, vs = quant.quantize_kv(torch.from_numpy(v))
    t = dict(q=torch.from_numpy(q), bt=torch.from_numpy(bt),
             lengths=torch.from_numpy(lengths))
    fk, fv = torch.from_numpy(k), torch.from_numpy(v)
    cases = [
        ("k_scales is missing", (kq, vq), dict(v_scales=vs)),
        ("v_scales is missing", (kq, vq), dict(k_scales=ks)),
        (r"rank 2, want 3", (kq, vq), dict(k_scales=ks[0], v_scales=vs)),
        (r"page_size \(axis 1\): got 2, want 4", (kq, vq),
         dict(k_scales=ks[:, :2], v_scales=vs)),
        (r"heads \(axis 2\): got 3, want 4", (kq, vq),
         dict(k_scales=ks, v_scales=vs[:, :, :3])),
        ("must be float32", (kq, vq),
         dict(k_scales=ks.half(), v_scales=vs)),
        ("int8 pages only", (fk, fv), dict(k_scales=ks, v_scales=vs)),
        ("int8 pages only", (fk, fv), dict(v_scales=vs)),
    ]
    for match, pools, kw in cases:
        with pytest.raises(ValueError, match=match):
            paged_attention(t["q"], *pools, t["bt"], t["lengths"], scale=1.0,
                            **kw)
        jkw = {n: jnp.asarray(x.float().numpy()).astype(
            jnp.float16 if x.dtype == torch.float16 else jnp.float32)
            for n, x in kw.items()}
        with pytest.raises(ValueError, match=match):
            jax_pa.paged_attention(
                jnp.asarray(q), *(jnp.asarray(p.numpy()) for p in pools),
                jnp.asarray(bt), jnp.asarray(lengths), scale=1.0,
                impl="reference", **jkw)


# ------------------------------------------------------------- engines


def test_weight_only_int8_greedy_bit_identical_on_snapped_grid(lms):
    """On weights snapped to the int8 grid, weight-only int8 is a storage
    change: the port's int8-weight greedy streams equal its float engine's
    and the JAX int8-weight engine's, with the prefix cache on as well."""
    jlm, model = lms
    T = 6
    prompts = _prompts([3, 6, 9, 14, 5])
    fp, st_fp = _serve(_port(model, T), prompts, T)
    q, st_q = _serve(_port(model, T, weights_dtype="int8"), prompts, T)
    want, _ = _serve(_jax(jlm, T, weights_dtype="int8"), prompts, T)
    assert q == fp == want
    assert st_fp["variant"] == "fp32" and st_q["variant"] == "int8"
    assert (st_q["weights_dtype"], st_q["kv_dtype"]) == ("int8", "float32")
    assert st_q["kv_bytes_per_token"] == st_fp["kv_bytes_per_token"]
    # int8 kernels + one fp32 scale a channel: well under the float bytes
    assert st_q["weight_bytes"] < st_fp["weight_bytes"]
    shared = [np.concatenate([prompts[3], p]) for p in prompts[:3]]
    kw = dict(prefix_cache=True, prompt_buckets=(24,))
    fp, _ = _serve(_port(model, T, **kw), shared, T, serial=True)
    q, st = _serve(_port(model, T, weights_dtype="int8", **kw), shared, T,
                   serial=True)
    want, _ = _serve(_jax(jlm, T, weights_dtype="int8", **kw), shared, T,
                     serial=True)
    assert q == fp == want
    assert st["prefix_cache"]["prefix_hits"] == 2


def test_int8_kv_engine_band_pools_and_accounting(lms):
    """Weights and KV int8: the first token of every stream equals the
    float-KV engine's (prefill attends the unquantized K/V), at least 80%
    of tokens agree, the pools are int8 beside fp32 scales of the pools'
    leading shape, and the allocator is dtype-blind."""
    _, model = lms
    T = 8
    prompts = _prompts([3, 6, 9, 14], seed=5)
    fp, st_fp = _serve(_port(model, T, weights_dtype="int8"), prompts, T)
    server = _port(model, T, weights_dtype="int8", kv_dtype="int8")
    engine = server.engine
    q8, st_q8 = _serve(server, prompts, T)
    agree = total = 0
    for i, (a, b) in enumerate(zip(fp, q8)):
        assert a[0] == b[0], f"request {i}: first token drifted"
        agree += sum(x == y for x, y in zip(a, b))
        total += len(a)
    assert agree / total >= 0.8, (agree, total)
    assert len(engine._pools) == len(engine._scales) == LAYERS
    for pools, scales in zip(engine._pools, engine._scales):
        for pool, sc in zip(pools, scales):
            assert pool.dtype == torch.int8 and sc.dtype == torch.float32
            assert sc.shape == pool.shape[:3]
    assert st_fp["kv_pages_total"] == st_q8["kv_pages_total"]
    assert st_fp["kv_page_size"] == st_q8["kv_page_size"]
    assert st_fp["page_exhausted"] == st_q8["page_exhausted"] == 0
    assert st_fp["kv_bytes_per_token"] == 2 * LAYERS * HEADS * HEAD_DIM * 4
    assert st_q8["kv_bytes_per_token"] == 2 * LAYERS * HEADS * (HEAD_DIM + 4)
    assert st_q8["kv_dtype"] == "int8" and st_q8["variant"] == "int8"


@pytest.mark.parametrize("option", [
    {}, dict(spec_k=3), dict(prefill_chunk=4),
    dict(prefix_cache=True, prompt_buckets=(24,)),
])
def test_int8_kv_streams_equal_jax_int8_kv_engine(lms, option):
    """Both packages' int8-KV engines on the same bridged weights give the
    same greedy streams, plain and with each serving option."""
    jlm, model = lms
    T = 6
    if option.get("prefix_cache"):
        base = _prompts([10, 4, 7, 5], seed=13)
        prompts = [np.concatenate([base[0], p]) for p in base[1:]] + [base[0]]
    else:
        prompts = _prompts([3, 6, 9, 14, 5], seed=9)
    serial = bool(option.get("prefix_cache"))
    kw = dict(weights_dtype="int8", kv_dtype="int8", **option)
    want, _ = _serve(_jax(jlm, T, **kw), prompts, T, serial=serial)
    got, stats = _serve(_port(model, T, **kw), prompts, T, serial=serial)
    assert got == want
    if option.get("prefix_cache"):
        assert stats["prefix_cache"]["prefix_hits"] >= 2
        assert stats["prefix_cache"]["cow_copies"] >= 1


def test_int8_kv_pages_after_one_prefill_match_jax(lms, capsys):
    """After one bucket prefill each layer's int8 pages and scales equal the
    JAX engine's; an int8 entry may differ by 1 only where its
    pre-quantization value lies within float rounding of a half step (the
    two packages' K/V differ in the last float32 bits). The count of such
    entries is printed."""
    jlm, model = lms
    prompt = _prompts([13], seed=21)
    kw = dict(weights_dtype="int8", kv_dtype="int8")
    jserver = _jax(jlm, 1, **kw)
    _serve(jserver, prompt, 1)
    server = _port(model, 1, **kw)
    engine = server.engine
    captured, tables = {}, []

    def keep(name):
        def hook(_mod, _inp, out):
            captured[name] = out[0].clone()
        return hook

    for i, block in enumerate(engine._model.blocks):
        block.attention.key.register_forward_hook(keep(("k", i)))
        block.attention.value.register_forward_hook(keep(("v", i)))
    paged = engine._paged
    engine._paged = lambda bt, *a, **k: (tables.append(bt.clone()),
                                         paged(bt, *a, **k))[1]
    _serve(server, prompt, 1)
    leaves = {
        "/".join(str(getattr(p, "key", p)) for p in path): np.asarray(x)
        for path, x in jax.tree_util.tree_leaves_with_path(
            jserver.engine._cache)
    }
    page_size = engine.config.page_size
    (bt,) = tables
    pos = np.arange(captured[("k", 0)].shape[0])
    page, off = bt[0].numpy()[pos // page_size], pos % page_size
    ties = 0
    for i in range(LAYERS):
        for j, kind in enumerate("kv"):
            pool = engine._pools[i][j].numpy()
            sc = engine._scales[i][j].numpy()
            jpool = leaves[f"block_{i}/attention/{kind}_pages"]
            jsc = leaves[f"block_{i}/attention/{kind}_scales"]
            np.testing.assert_allclose(sc, jsc, rtol=1e-6, atol=0)
            diff = np.abs(pool.astype(np.int32) - jpool.astype(np.int32))
            assert diff.max() <= 1, (i, kind, diff.max())
            # the entries that differ sit on a half step of the grid
            x = captured[(kind, i)].numpy() / sc[page, off][..., None]
            frac = np.abs(x - np.trunc(x))
            off_by_one = diff[page, off] == 1
            assert (np.abs(frac[off_by_one] - 0.5) < 1e-4).all()
            assert diff.sum() == off_by_one.sum()
            ties += int(off_by_one.sum())
    with capsys.disabled():
        print(f"\n[int8 pages] entries 1 apart from the JAX engine's "
              f"(half-step ties): {ties}")


def test_int8_kv_option_parity_within_port(lms):
    """Under int8 KV, speculative and chunked streams equal the port's plain
    int8 streams; a prefix-cache hit (its COW copy carrying the scales)
    equals the same engine's cold chunked run of that prompt on pages
    holding the quantized prefix."""
    _, model = lms
    T = 6
    prompts = _prompts([3, 6, 9, 14, 5], seed=17)
    kw = dict(weights_dtype="int8", kv_dtype="int8")
    plain, _ = _serve(_port(model, T, **kw), prompts, T)
    spec, st_spec = _serve(_port(model, T, spec_k=3, **kw), prompts, T)
    chunked, st_chunk = _serve(_port(model, T, prefill_chunk=4, **kw),
                               prompts, T)
    assert spec == plain and chunked == plain
    assert st_spec["spec_dispatches"] > 0 and st_chunk["prefill_chunks"] > 0
    # each prompt twice in a row: the second run is a hit; lengths 8 and
    # 12 (multiples of the page) end their matched head mid-page (COW)
    again = [p for p in _prompts([8, 12, 7], seed=19) for _ in range(2)]
    server = _port(model, T, prefix_cache=True, prefill_chunk=4, **kw)
    engine, copied = server.engine, []
    page_copy = engine._page_copy

    def cow(src, dst):
        page_copy(src, dst)
        copied.append(all(torch.equal(leaf[dst], leaf[src])
                          for pair in engine._pools + engine._scales
                          for leaf in pair))

    engine._page_copy = cow
    got, stats = _serve(server, again, T, serial=True)
    assert got[0::2] == got[1::2]
    pc = stats["prefix_cache"]
    assert pc["prefix_hits"] == 3 and pc["cow_copies"] == 2
    assert copied == [True, True]


@pytest.mark.parametrize("field", ["weights_dtype", "kv_dtype"])
@pytest.mark.parametrize("value,ok", [("float32", True), ("int8", True),
                                      ("bf16", False), ("int4", False)])
def test_engine_config_dtype_values_like_jax(field, value, ok):
    if ok:
        assert getattr(EngineConfig(**{field: value}), field) == value
        JaxEngineConfig(**{field: value})
        return
    with pytest.raises(ValueError, match=f"{field} must be float32/int8"):
        EngineConfig(**{field: value})
    with pytest.raises(ValueError, match=f"{field} must be float32/int8"):
        JaxEngineConfig(**{field: value})


def test_serve_lm_dtype_flags_reach_the_engine():
    from pytorch_distributed_training_tpu_torch.cli import serve_lm

    args = serve_lm.build_parser().parse_args(
        ["--model", "gpt2-tiny", "--device", "cpu", "--prompt-buckets",
         "16,32", "--max-new-tokens-cap", "8", "--weights-dtype", "int8",
         "--kv-dtype", "int8"])
    server, _ = serve_lm.build_server(args)
    stats = server.stats()
    assert (stats["weights_dtype"], stats["kv_dtype"], stats["variant"]) == (
        "int8", "int8", "int8")
    # gpt2-tiny's preset computes in bf16: int8 pools cost (16 + 4) bytes a
    # head and token against 2 x 16
    assert stats["kv_bytes_per_token"] == 2 * LAYERS * HEADS * (HEAD_DIM + 4)
    with pytest.raises(SystemExit):
        serve_lm.build_parser().parse_args(["--kv-dtype", "fp8"])
    server.close()
