"""Port parity, serving options on the 4-D-query paged path: the PyTorch
package's multi-query paged attention, ``spec_accept``, speculative
decoding and chunked prefill against the JAX package on the same numpy
inputs and bridged gpt2-tiny weights, on the CPU (every kernel through its
plain version). Fixed-seed sampled streams are pinned within the port
(its sampler's stream is not JAX's threefry by design)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_training_tpu.models.gpt2 import GPT2LMModel as JaxGPT2
from pytorch_distributed_training_tpu.ops import paged_attention as jax_pa
from pytorch_distributed_training_tpu.ops.flash_attention import (
    tpu_interpret_mode,
)
from pytorch_distributed_training_tpu.serve import (
    EngineConfig as JaxEngineConfig,
)
from pytorch_distributed_training_tpu.serve import (
    InferenceServer as JaxServer,
)
from pytorch_distributed_training_tpu.serve.paged_cache import (
    PageAllocator as JaxPageAllocator,
)
from pytorch_distributed_training_tpu.serve.sampling import (
    spec_accept as jax_spec_accept,
)
from pytorch_distributed_training_tpu.serve.server import wait_until
from pytorch_distributed_training_tpu.utils.config import (
    model_preset as jax_preset,
)
from pytorch_distributed_training_tpu_torch.models.convert import (
    params_from_jax,
)
from pytorch_distributed_training_tpu_torch.models.gpt2 import GPT2LMModel
from pytorch_distributed_training_tpu_torch.ops.paged_attention import (
    paged_attention,
)
from pytorch_distributed_training_tpu_torch.serve import (
    EngineConfig,
    InferenceServer,
)
from pytorch_distributed_training_tpu_torch.serve.engine import DecodeEngine
from pytorch_distributed_training_tpu_torch.serve.paged_cache import (
    PageAllocator,
)
from pytorch_distributed_training_tpu_torch.serve.sampling import (
    device_sample,
    spec_accept,
)
from pytorch_distributed_training_tpu_torch.utils.config import model_preset

torch.set_num_threads(2)

BUCKETS = (4, 8, 16)


@pytest.fixture(scope="module")
def lms():
    """The JAX gpt2-tiny (fp32) and the port's model on the same weights."""
    cfg = jax_preset(
        "gpt2-tiny", compute_dtype="float32", attention_impl="reference",
        hidden_dropout=0.0, attention_dropout=0.0,
    )
    jmodel = JaxGPT2(cfg)
    params = jmodel.init(jax.random.key(0), jnp.ones((2, 16), jnp.int32))[
        "params"
    ]
    model = GPT2LMModel(model_preset("gpt2-tiny", compute_dtype="float32"))
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    return (jmodel, params), model


def _prompts(lengths, seed=7, vocab=1024):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, n).astype(np.int32) for n in lengths]


def _serve(server, prompts, T, *, spec_flags=None, mutate=None, **kw):
    if mutate is not None:
        mutate(server.engine)
    server.start()
    try:
        reqs = [
            server.submit(p, max_new_tokens=T, seed=kw.get("seed", 0) + i,
                          **{k: v for k, v in kw.items() if k != "seed"},
                          **({} if spec_flags is None
                             else {"spec": spec_flags[i]}))
            for i, p in enumerate(prompts)
        ]
        assert wait_until(lambda: all(r.done.is_set() for r in reqs),
                          timeout=120)
    finally:
        server.close()
    assert all(r.status == "done" for r in reqs), [r.status for r in reqs]
    return [list(r.tokens) for r in reqs], server.stats()


def _port(model, T, **cfg):
    cfg.setdefault("prompt_buckets", BUCKETS)
    return InferenceServer(
        model, EngineConfig(num_slots=2, max_new_tokens=T, **cfg),
        device="cpu", queue_depth=16,
    )


def _jax(jlm, T, **cfg):
    cfg.setdefault("prompt_buckets", BUCKETS)
    jmodel, params = jlm
    return JaxServer(
        jmodel, params,
        JaxEngineConfig(num_slots=2, max_new_tokens=T, **cfg),
        queue_depth=16,
    )


# --------------------------------------------- the 4-D paged attention


def _mq_fixture(q_len, seed, batch=4, heads=2, head_dim=16, page_size=4):
    """Pools of noise (the null page 0 included), each sequence's pages in
    a permuted order, null-page tails past each live length, and lengths
    on and off page boundaries; the last sequence's horizon for row 0
    ends before its last computed page (a row fully masked on it)."""
    rng = np.random.default_rng(seed)
    windows = -(-(q_len + 2 * page_size + 1) // page_size) + 1
    num_pages = 1 + batch * windows
    shape = (num_pages, page_size, heads, head_dim)
    k_pages = rng.standard_normal(shape).astype(np.float32)
    v_pages = rng.standard_normal(shape).astype(np.float32)
    lengths = np.asarray(
        [q_len, q_len + 3, max(q_len, 2 * page_size),
         q_len + 2 * page_size + 1],
        np.int32)[:batch]
    perm = rng.permutation(np.arange(1, num_pages))
    bt = np.zeros((batch, windows), np.int32)
    used = 0
    for b, n in enumerate(lengths):
        need = -(-int(n) // page_size)
        bt[b, :need] = perm[used: used + need]
        used += need
    q = rng.standard_normal((batch, q_len, heads, head_dim)).astype(np.float32)
    return q, k_pages, v_pages, bt, lengths


@pytest.mark.parametrize("q_len", [1, 3, 5, 16])
def test_paged_attention_mq_plain_matches_jax(q_len):
    q, kp, vp, bt, lengths = _mq_fixture(q_len, seed=q_len)
    scale = q.shape[-1] ** -0.5
    args = [jnp.asarray(a) for a in (q, kp, vp, bt, lengths)]
    ref = jax_pa.paged_attention(*args, scale=scale, impl="reference")
    with tpu_interpret_mode():
        pal = jax_pa.paged_attention(*args, scale=scale, impl="pallas")
    got = paged_attention(*(torch.from_numpy(a) for a in
                            (q, kp, vp, bt, lengths)), scale=scale).numpy()
    assert got.shape == q.shape
    np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got, np.asarray(pal), rtol=1e-5, atol=1e-5)
    # what the null page holds never reaches a live row
    kp0, vp0 = kp.copy(), vp.copy()
    kp0[0], vp0[0] = 1e4, -1e4
    again = paged_attention(*(torch.from_numpy(a) for a in
                              (q, kp0, vp0, bt, lengths)), scale=scale)
    np.testing.assert_array_equal(again.numpy(), got)


def test_paged_attention_mq_row_equals_single_query_decode():
    # row j of a 4-D block is the 3-D decode step at length
    # lengths - (q_len - 1) + j
    q, kp, vp, bt, lengths = _mq_fixture(5, seed=11)
    scale = q.shape[-1] ** -0.5
    t = [torch.from_numpy(a) for a in (q, kp, vp, bt, lengths)]
    block = paged_attention(*t, scale=scale)
    for j in range(5):
        step = paged_attention(t[0][:, j], t[1], t[2], t[3],
                               t[4] - (5 - 1) + j, scale=scale)
        torch.testing.assert_close(block[:, j], step, rtol=1e-6, atol=1e-6)


# ----------------------------------------------------------- acceptance


def test_spec_accept_matches_jax_on_greedy_logits():
    """The same greedy verify logits give the same per-position targets
    and the same leading-match acceptance in both packages (drafts agree
    on 3, 0 and 1 leading positions)."""
    rng = np.random.default_rng(0)
    S, Q, V = 3, 4, 32
    logits = rng.normal(size=(S, Q, V)).astype(np.float32)
    want = logits.argmax(-1)
    draft = want[:, : Q - 1].copy()
    draft[1, 0] = (draft[1, 0] + 1) % V
    draft[2, 1] = (draft[2, 1] + 1) % V
    seeds, steps0 = [5, 6, 7], [1, 3, 9]
    temps, top_ks = [0.0, 0.0, 0.0], [0, 4, 0]
    jt, ja = jax_spec_accept(
        jnp.asarray(logits), jnp.asarray(draft, jnp.int32),
        jnp.asarray(seeds, jnp.int32), jnp.asarray(steps0, jnp.int32),
        jnp.asarray(temps, jnp.float32), jnp.asarray(top_ks, jnp.int32))
    pt, pa = spec_accept(torch.from_numpy(logits), torch.from_numpy(draft),
                         seeds, steps0, temps, top_ks)
    np.testing.assert_array_equal(pt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(pa.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(pa.numpy(), [3, 0, 1])


def test_spec_accept_samples_each_row_on_its_own_step():
    # a sampled row j is device_sample's draw at step steps0 + j
    rng = np.random.default_rng(1)
    logits = torch.from_numpy(rng.normal(size=(2, 3, 16)).astype(np.float32))
    seeds, steps0, temps, top_ks = [9, 4], [2, 5], [0.9, 0.0], [5, 0]
    target, _ = spec_accept(logits, torch.zeros(2, 2, dtype=torch.long),
                            seeds, steps0, temps, top_ks)
    for j in range(3):
        row = device_sample(logits[:, j], seeds, [s + j for s in steps0],
                            temps, top_ks)
        assert torch.equal(target[:, j], row)


# ------------------------------------------------------ engine streams


@pytest.mark.parametrize("k", [2, 3])
def test_spec_greedy_streams_equal_jax_engine(lms, k):
    jlm, model = lms
    T = 6
    prompts = _prompts([3, 6, 9, 14, 5])
    want, _ = _serve(_jax(jlm, T, spec_k=k), prompts, T)
    got, stats = _serve(_port(model, T, spec_k=k), prompts, T)
    assert got == want
    assert stats["spec_k"] == k and stats["spec_draft"] == "ngram"
    assert stats["spec_dispatches"] == stats["decode_dispatches"] > 0
    assert 0 < stats["spec_accepted"] <= stats["spec_drafted"]
    assert stats["tokens_per_dispatch"] > 1.0
    assert stats["kv_pages_used"] == 0 and stats["page_exhausted"] == 0


def test_chunked_prefill_equals_jax_engine_across_ragged_boundaries(lms):
    """Prompt lengths on, under and over the chunk boundary (len % chunk in
    {0, 1, chunk - 1})."""
    jlm, model = lms
    T = 5
    lengths = [3, 4, 5, 8, 9, 14, 16]
    prompts = _prompts(lengths, seed=5)
    want, _ = _serve(_jax(jlm, T, prefill_chunk=4), prompts, T)
    got, stats = _serve(_port(model, T, prefill_chunk=4), prompts, T)
    assert got == want
    assert stats["prefill_chunk"] == 4
    assert stats["prefill_chunks"] == sum(-(-n // 4) for n in lengths)
    assert stats["prefill_dispatches"] == 0
    assert stats["prefill_tokens"] == sum(lengths)


def test_spec_plus_chunked_equals_jax_and_port_plain(lms):
    jlm, model = lms
    T = 5
    prompts = _prompts([3, 9, 14, 16, 5], seed=2)
    want, _ = _serve(_jax(jlm, T, spec_k=3, prefill_chunk=4), prompts, T)
    got, stats = _serve(_port(model, T, spec_k=3, prefill_chunk=4),
                        prompts, T)
    plain, _ = _serve(_port(model, T), prompts, T)
    assert got == want == plain
    assert stats["spec_dispatches"] > 0 and stats["prefill_chunks"] > 0


def test_mixed_spec_and_nonspec_slots_share_verify_ticks(lms):
    _, model = lms
    T = 6
    prompts = _prompts([3, 6, 9, 14, 5])
    plain, _ = _serve(_port(model, T), prompts, T)
    got, stats = _serve(_port(model, T, spec_k=3), prompts, T,
                        spec_flags=[True, False, True, False, None])
    assert got == plain
    # opted-out slots drafted nothing
    assert 0 < stats["spec_drafted"] < stats["spec_dispatches"] * 2 * 3


@pytest.mark.parametrize("option", [dict(spec_k=3),
                                    dict(spec_k=2, prefill_chunk=4)])
def test_fixed_seed_sampled_spec_equals_plain_within_port(lms, option):
    _, model = lms
    T = 6
    prompts = _prompts([3, 7, 12], seed=3)
    kw = dict(temperature=0.8, top_k=5, seed=11)
    plain, _ = _serve(_port(model, T), prompts, T, **kw)
    got, stats = _serve(_port(model, T, **option), prompts, T, **kw)
    assert got == plain
    assert stats["spec_dispatches"] > 0


def test_all_reject_rollback_releases_every_page(lms):
    """A drafter that never matches: every verify rejects the whole block,
    the streams stay the plain ones, one token per slot per dispatch, and
    rollback leaks nothing (every page back in the pool)."""
    _, model = lms
    T = 6
    prompts = _prompts([3, 6, 9, 14, 5])
    plain, _ = _serve(_port(model, T), prompts, T)
    never = next(t for t in range(1, 1024)
                 if all(t not in s for s in plain))

    def sabotage(engine):
        engine._ngram_draft = lambda hist, k: [never] * k

    got, stats = _serve(_port(model, T, spec_k=3), prompts, T,
                        mutate=sabotage)
    assert got == plain
    assert stats["spec_drafted"] > 0 and stats["spec_accepted"] == 0
    assert stats["spec_accept_rate"] == 0.0
    assert 1.0 <= stats["tokens_per_dispatch"] <= 2.0
    assert stats["page_exhausted"] == 0
    assert stats["kv_pages_used"] == 0
    assert stats["kv_pages_free"] == stats["kv_pages_total"]


def test_pages_reserved_equals_jax_formula_and_exact_pool_suffices(lms):
    for total, k, page in [(10, 0, 4), (5, 1, 2), (8, 3, 4), (17, 7, 4),
                           (40, 5, 8), (3, 2, 16), (64, 3, 8)]:
        args = (128, page, 64, 1)
        assert (PageAllocator(*args).pages_reserved(total, k)
                == JaxPageAllocator(*args).pages_reserved(total, k))
    for k in (0, 3):
        cfg = EngineConfig(prompt_buckets=(8, 16), max_new_tokens=8,
                           page_size=4, spec_k=k)
        jcfg = JaxEngineConfig(prompt_buckets=(8, 16), max_new_tokens=8,
                               page_size=4, spec_k=k)
        assert cfg.pages_per_slot == jcfg.pages_per_slot
        assert cfg.total_pages == jcfg.total_pages
    # a pool sized exactly to the formula serves full-length speculative
    # requests with no page exhaustion
    _, model = lms
    T, k, page_size = 8, 3, 4
    num_pages = 2 * (-(-(8 + T + k) // page_size)) + 1
    prompts = _prompts([8, 5, 8, 6, 7, 8], seed=1)
    plain, _ = _serve(_port(model, T, prompt_buckets=(8,),
                            page_size=page_size), prompts, T)
    got, stats = _serve(_port(model, T, spec_k=k, prompt_buckets=(8,),
                              page_size=page_size, num_pages=num_pages),
                        prompts, T)
    assert got == plain and all(len(s) == T for s in got)
    assert stats["page_exhausted"] == 0
    assert stats["kv_pages_free"] == num_pages - 1


def test_chunked_admission_holds_under_prefill_concurrency(lms):
    # with one streaming slot allowed, the second prompt waits while the
    # first streams its 4 chunks; the hold is not page exhaustion
    _, model = lms
    T = 3
    prompts = _prompts([16, 16], seed=9)
    got, stats = _serve(_port(model, T, prefill_chunk=4,
                              prefill_concurrency=1), prompts, T)
    plain, _ = _serve(_port(model, T), prompts, T)
    assert got == plain
    assert stats["page_exhausted"] == 0 and stats["prefill_chunks"] == 8


def test_multiquery_paged_call_continues_an_existing_context(lms):
    """A fresh paged prefill of 5 tokens, then ``PagedKV(multiquery=True)``
    appending 7 more over the same weights: the logits equal the
    full-sequence forward's at those positions."""
    _, model = lms
    from pytorch_distributed_training_tpu_torch.models.bert import PagedKV

    cfg = model.config
    ids = torch.from_numpy(_prompts([12], seed=11)[0].astype(np.int64))[None]
    pools = [(torch.zeros(8, 4, cfg.num_heads, cfg.head_dim),
              torch.zeros(8, 4, cfg.num_heads, cfg.head_dim))
             for _ in range(cfg.num_layers)]
    bt = torch.tensor([[3, 1, 6, 0]], dtype=torch.int32)
    with torch.no_grad():
        want = model(ids)[0, 5:]
        model(ids[:, :5], position_ids=torch.arange(5)[None],
              paged=PagedKV(pools, bt, torch.zeros(1, dtype=torch.int32)))
        got = model(ids[:, 5:], position_ids=torch.arange(5, 12)[None],
                    paged=PagedKV(pools, bt,
                                  torch.full((1,), 5, dtype=torch.int32),
                                  multiquery=True))[0]
    assert not model.config.paged_multiquery
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)


def test_engine_config_validates_the_new_fields_like_jax():
    for bad in (dict(spec_k=-1), dict(prefill_chunk=-1),
                dict(prefill_concurrency=0)):
        with pytest.raises(ValueError):
            JaxEngineConfig(**bad)
        with pytest.raises(ValueError):
            EngineConfig(**bad)
    cfg = EngineConfig(spec_k=4, prefill_chunk=32, prefix_cache=True)
    assert cfg.pages_per_slot == -(-(64 + 64 + 4) // 16)


def test_serve_lm_flags_and_per_request_spec_field():
    """``serve_lm``'s option flags reach the engine, and a JSONL line's
    ``spec`` opts that request out (it drafts nothing) or is refused when
    it is not a boolean."""
    import io
    import json

    from pytorch_distributed_training_tpu_torch.cli import serve_lm
    from pytorch_distributed_training_tpu_torch.serve import serve_stdio

    args = serve_lm.build_parser().parse_args(
        ["--model", "gpt2-tiny", "--device", "cpu", "--prompt-buckets",
         "16,32", "--max-new-tokens-cap", "8", "--num-slots", "1",
         "--spec-k", "2", "--prefill-chunk", "8", "--prefill-concurrency",
         "2", "--prefix-cache"])
    server, tok = serve_lm.build_server(args)
    cfg = server.engine.config
    assert (cfg.spec_k, cfg.prefill_chunk, cfg.prefill_concurrency,
            cfg.prefix_cache) == (2, 8, 2, True)
    lines = [{"id": "off", "prompt": "abcabcabcabc", "max_new_tokens": 6,
              "spec": False},
             {"id": "bad", "prompt": "abc", "spec": "yes"}]
    out = io.StringIO()
    server.start()
    try:
        serve_stdio(server, tok,
                    io.StringIO("".join(json.dumps(x) + "\n" for x in lines)),
                    out)
    finally:
        server.close()
    events = [json.loads(x) for x in out.getvalue().splitlines()]
    errors = [e for e in events if e["event"] == "error"]
    assert len(errors) == 1 and "spec must be a boolean" in errors[0]["error"]
    done = [e for e in events if e.get("id") == "off" and
            e["event"] == "done"]
    assert done and done[0]["new_tokens"] == 6
    stats = server.stats()
    assert stats["spec_dispatches"] > 0 and stats["spec_drafted"] == 0
