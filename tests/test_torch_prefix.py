"""Port parity, the shared-KV prefix cache: the PyTorch package's
refcounted page allocator and prefix trie replay the same operation
sequences as the JAX package's and end in the same free lists, refcounts,
block tables and matches; its prefix-cache engine's greedy streams equal
the JAX engine's on bridged gpt2-tiny weights (copy-on-write included) and
its own cache-off streams, on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_training_tpu.models.gpt2 import GPT2LMModel as JaxGPT2
from pytorch_distributed_training_tpu.serve import (
    EngineConfig as JaxEngineConfig,
)
from pytorch_distributed_training_tpu.serve import (
    InferenceServer as JaxServer,
)
from pytorch_distributed_training_tpu.serve.paged_cache import (
    PageAllocator as JaxPageAllocator,
)
from pytorch_distributed_training_tpu.serve.prefix_cache import (
    PrefixCache as JaxPrefixCache,
)
from pytorch_distributed_training_tpu.serve.server import wait_until
from pytorch_distributed_training_tpu.utils.config import (
    model_preset as jax_preset,
)
from pytorch_distributed_training_tpu_torch.models.convert import (
    params_from_jax,
)
from pytorch_distributed_training_tpu_torch.models.gpt2 import GPT2LMModel
from pytorch_distributed_training_tpu_torch.serve import (
    EngineConfig,
    InferenceServer,
)
from pytorch_distributed_training_tpu_torch.serve.paged_cache import (
    PageAllocator,
)
from pytorch_distributed_training_tpu_torch.serve.prefix_cache import (
    PrefixCache,
)
from pytorch_distributed_training_tpu_torch.utils.config import model_preset

torch.set_num_threads(2)


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


# ---------------------------------------------------- allocator replays


def _pair(num_pages=12, page_size=4, pages_per_slot=6, num_slots=4):
    args = (num_pages, page_size, pages_per_slot, num_slots)
    return PageAllocator(*args), JaxPageAllocator(*args)


def _same_state(port, ref):
    np.testing.assert_array_equal(port.block_table, ref.block_table)
    assert port._free == ref._free
    assert port._ref == ref._ref
    assert port.pages_used == ref.pages_used
    assert port.pages_shared == ref.pages_shared
    assert port.peak_used == ref.peak_used
    for s in range(port.num_slots):
        assert port.slot_pages(s) == ref.slot_pages(s)


def _replay(port, ref, ops):
    """Apply each (method, *args) to both allocators; the same result or
    the same exception type, then the same state."""
    for name, *args in ops:
        out = []
        for a in (port, ref):
            try:
                out.append(("ok", getattr(a, name)(*args)))
            except (RuntimeError, ValueError) as e:
                out.append((type(e).__name__, None))
        assert out[0] == out[1], (name, args, out)
        _same_state(port, ref)


def test_refcounts_share_and_release_like_jax():
    port, ref = _pair()
    _replay(port, ref, [("admit", 0, 3), ("admit_shared", 1, [1, 2], 2)])
    a = port.slot_pages(0)
    _replay(port, ref, [
        ("acquire", a[0]), ("release", 0), ("decref", a[0]),
        ("admit_shared", 2, [a[1]], 3), ("release", 1), ("admit", 0, 2),
        ("release", 2), ("release", 0),
    ])
    assert port.pages_used == 0 and port.pages_free == 11


def test_allocator_misuse_raises_like_jax():
    port, ref = _pair(num_pages=6, pages_per_slot=8, num_slots=2)
    _replay(port, ref, [("admit", 0, 2)])
    a, b = port.slot_pages(0)
    free_page = next(p for p in range(1, 6) if port.refcount(p) == 0)
    _replay(port, ref, [
        ("acquire", free_page), ("acquire", 0), ("acquire", 6),
        ("release", 0), ("decref", a), ("admit", 0, 1),
    ])
    (p,) = port.slot_pages(0)
    _replay(port, ref, [
        ("admit_shared", 0, [p], 1), ("admit_shared", 1, [p], 8),
        ("admit_shared", 1, [p], port.pages_free + 1),
    ])
    assert port.refcount(p) == 1 and port.slot_pages(1) == ()


def test_cow_repoints_like_jax():
    port, ref = _pair(num_pages=6, pages_per_slot=8, num_slots=2)
    _replay(port, ref, [("admit", 0, 1), ("cow", 0, 0)])
    (shared,) = port.slot_pages(0)
    _replay(port, ref, [("admit_shared", 1, [shared], 1), ("cow", 1, 0)])
    assert port.refcount(shared) == 1 and port.block_table[1][0] != shared
    _replay(port, ref, [("release", 1),
                        ("admit_shared", 1, [shared], port.pages_free),
                        ("cow", 1, 0)])


def test_release_keeps_lifo_order_under_sharing_like_jax():
    port, ref = _pair(num_pages=9, pages_per_slot=3, num_slots=2)
    _replay(port, ref, [("admit", 0, 3)])
    first = port.slot_pages(0)
    _replay(port, ref, [("admit_shared", 1, list(first[:2]), 1),
                        ("release", 0), ("release", 1), ("admit", 0, 3)])
    assert port.slot_pages(0)[:2] == first[:2]


# ---------------------------------------------------------- trie replays


def _tries(num_pages=16, page_size=4, num_slots=4):
    port, ref = _pair(num_pages, page_size, num_pages, num_slots)
    return (PrefixCache(port), port), (JaxPrefixCache(ref), ref)


def _plain(result):
    """A ``PrefixMatch`` of either package as a plain tuple."""
    if hasattr(result, "cow_src"):
        return ("match", result.pages, result.cached_len, result.cow_src,
                result.hit)
    return result


def _both(pair, fn):
    """``fn(cache, alloc)`` on the port's and JAX's (cache, allocator);
    asserts the results and the allocator states equal."""
    (pc, pa), (jc, ja) = pair
    got, want = _plain(fn(pc, pa)), _plain(fn(jc, ja))
    assert got == want
    _same_state(pa, ja)
    assert pc.stats() == jc.stats()
    return got


def test_trie_insert_match_exact_partial_and_miss_like_jax():
    pair = _tries()
    toks = list(range(100, 110))             # 2 full pages + 2 leftover
    _both(pair, lambda c, a: a.admit(0, 3))
    pages = pair[0][1].slot_pages(0)
    assert _both(pair, lambda c, a: c.insert(toks, a.slot_pages(0))) == 2
    for query in (toks[:8], toks[:6] + [999, 998], toks[:3] + [999],
                  [1, 2, 3, 4, 5], toks[:9]):
        _both(pair, lambda c, a: c.match(query))
    m = pair[0][0].match(toks[:6] + [999, 998])
    assert m.pages == pages[:1] and m.cached_len == 6
    assert m.cow_src == pages[1]
    _both(pair, lambda c, a: (c.note(True), c.note(False)))


def test_trie_first_writer_wins_like_jax():
    pair = _tries()
    toks = list(range(200, 208))
    toks2 = toks[:4] + [777, 778, 779, 780]
    for slot in range(3):
        _both(pair, lambda c, a: a.admit(slot, 2))
    assert _both(pair, lambda c, a: c.insert(toks, a.slot_pages(0))) == 2
    assert _both(pair, lambda c, a: c.insert(toks, a.slot_pages(1))) == 0
    assert _both(pair, lambda c, a: c.insert(toks2, a.slot_pages(2))) == 1
    for c, a in pair:
        with pytest.raises(ValueError, match="full pages"):
            c.insert(list(range(12)), a.slot_pages(0)[:2])


def test_trie_evict_lru_protect_idle_and_invalidate_like_jax():
    pair = _tries()
    runs = []
    for slot, base in enumerate((100, 200, 300)):
        toks = [base + i for i in range(8)]
        _both(pair, lambda c, a: a.admit(slot, 2))
        _both(pair, lambda c, a: c.insert(toks, a.slot_pages(slot)))
        runs.append((toks, pair[0][1].slot_pages(slot)))
        _both(pair, lambda c, a: a.release(slot))
    _both(pair, lambda c, a: c.match(runs[0][0]))
    assert _both(pair, lambda c, a: c.evict_until(1)) == 1
    protected = set(runs[0][1])
    _both(pair, lambda c, a: c.evict_until(100, protect=protected))
    _both(pair, lambda c, a: a.admit_shared(3, list(runs[0][1]), 0))
    assert _both(pair, lambda c, a: c.evict_until(100)) == 0
    _both(pair, lambda c, a: a.release(3))
    assert _both(pair, lambda c, a: c.evict_idle()) == 2
    # an in-flight sharer keeps its pages through invalidate_all
    _both(pair, lambda c, a: a.admit(0, 2))
    _both(pair, lambda c, a: c.insert(runs[1][0], a.slot_pages(0)))
    _both(pair, lambda c, a: a.admit_shared(1, list(a.slot_pages(0)), 0))
    assert _both(pair, lambda c, a: c.invalidate_all()) == 2
    assert not pair[0][0].match(runs[1][0]).hit
    _both(pair, lambda c, a: (a.release(0), a.release(1)))
    assert pair[0][1].pages_used == 0


# ------------------------------------------------------- engine streams


def _shared_prompts(prefix_len, tail_lens, seed=0, vocab=1024):
    rng = np.random.default_rng(seed)
    prefix = rng.integers(1, vocab, prefix_len).astype(np.int32)
    return [np.concatenate([prefix, rng.integers(1, vocab, n).astype(
        np.int32)]) for n in tail_lens]


def _serve_serial(server, prompts, T, **kw):
    """One request at a time, so each inserts before the next matches."""
    server.start()
    try:
        toks = []
        for p in prompts:
            r = server.submit(p, max_new_tokens=T, **kw)
            assert wait_until(r.done.is_set, timeout=120), r.status
            assert r.status == "done", r.status
            toks.append(list(r.tokens))
    finally:
        server.close()
    return toks, server.stats()


def _cfg(T, **kw):
    kw.setdefault("prompt_buckets", (24,))
    kw.setdefault("page_size", 4)
    kw.setdefault("num_pages", 64)
    return dict(num_slots=2, max_new_tokens=T, **kw)


def _port(model, T, **kw):
    return InferenceServer(model, EngineConfig(**_cfg(T, **kw)),
                           device="cpu", queue_depth=16)


def _jax(jlm, T, **kw):
    jmodel, params = jlm
    return JaxServer(jmodel, params, JaxEngineConfig(**_cfg(T, **kw)),
                     queue_depth=16)


@pytest.mark.parametrize("variant", ["plain", "chunked", "spec"])
def test_cached_greedy_equals_jax_engine_and_cold_with_cow(lms, variant):
    """The shared prefix (14 tokens) is not page-aligned at page size 4, so
    every hit copies its partly matched page; the cached streams equal the
    JAX prefix-cache engine's and the port's own cache-off streams."""
    jlm, model = lms
    T = 5
    opt = {"plain": {}, "chunked": dict(prefill_chunk=4),
           "spec": dict(spec_k=2)}[variant]
    prompts = _shared_prompts(14, [4, 6, 3], seed=3)
    want, _ = _serve_serial(_jax(jlm, T, prefix_cache=True, **opt),
                            prompts, T)
    got, stats = _serve_serial(_port(model, T, prefix_cache=True, **opt),
                               prompts, T)
    cold, _ = _serve_serial(_port(model, T, **opt), prompts, T)
    assert got == want == cold
    pc = stats["prefix_cache"]
    assert pc["prefix_hits"] == 2 and pc["prefix_lookups"] == 3
    assert pc["cow_copies"] == 2 and stats["page_exhausted"] == 0
    assert pc["prefill_tokens_skipped"] >= 2 * 12
    assert stats["prefill_tokens"] <= sum(len(p) for p in prompts) - 2 * 12
    # after the run only the cache holds pages
    assert stats["kv_pages_used"] == pc["prefix_cached_pages"] > 0


def test_cached_sampled_fixed_seed_equals_cache_off_within_port(lms):
    _, model = lms
    T = 6
    prompts = _shared_prompts(12, [5, 7, 4], seed=11)
    kw = dict(temperature=0.8, top_k=5, seed=9)
    cached, stats = _serve_serial(_port(model, T, prefix_cache=True),
                                  prompts, T, **kw)
    cold, _ = _serve_serial(_port(model, T), prompts, T, **kw)
    assert cached == cold
    assert stats["prefix_cache"]["prefix_hits"] == 2


def test_eviction_under_pressure_never_corrupts_streams(lms):
    """8 usable pages, 5 reserved per request and 2-3 cached per finished
    prompt: from the third admission on, pages free only by evicting cached
    runs, with a hit's own matched pages protected. Streams equal the JAX
    engine's and the cold ones, with no page exhaustion."""
    jlm, model = lms
    T = 4
    shared = _shared_prompts(8, [4, 5, 6, 3], seed=23)
    foreign = _shared_prompts(8, [4], seed=24)
    prompts = shared[:2] + foreign + shared[2:]
    kw = dict(prompt_buckets=(16,), num_pages=9, prefix_cache=True)
    want, _ = _serve_serial(_jax(jlm, T, **kw), prompts, T)
    got, stats = _serve_serial(_port(model, T, **kw), prompts, T)
    cold, _ = _serve_serial(_port(model, T, prompt_buckets=(16,)),
                            prompts, T)
    assert got == want == cold
    pc = stats["prefix_cache"]
    assert pc["prefix_evictions"] > 0 and pc["prefix_hits"] >= 2
    assert stats["page_exhausted"] == 0
    assert stats["kv_pages_used"] == pc["prefix_cached_pages"]


def test_concurrent_hits_share_pages_and_count_them(lms):
    """Submitted together, later prompts hit pages the first inserted in
    the same admission pass; while they run the shared pages are counted,
    and every stream equals the cold one."""
    _, model = lms
    T = 4
    prompts = _shared_prompts(16, [3, 5, 2, 6], seed=31)
    cold, _ = _serve_serial(_port(model, T), prompts, T)
    server = _port(model, T, prefix_cache=True)
    shared_seen = []
    real_tick = server.engine._tick_body

    def tick():
        worked = real_tick()
        shared_seen.append(server.engine._pages.pages_shared)
        return worked

    server.engine._tick_body = tick
    server.start()
    try:
        reqs = [server.submit(p, max_new_tokens=T) for p in prompts]
        assert wait_until(lambda: all(r.done.is_set() for r in reqs),
                          timeout=120)
    finally:
        server.close()
    assert [list(r.tokens) for r in reqs] == cold
    assert max(shared_seen) > 0
    assert sum(r.prefix_hit for r in reqs) == 3
    assert all(r.cached_tokens >= 15 for r in reqs[1:])


def test_prefix_engine_builds_with_every_option_and_validates():
    cfg = EngineConfig(spec_k=2, prefill_chunk=8, prefix_cache=True,
                       prefill_concurrency=2)
    jcfg = JaxEngineConfig(spec_k=2, prefill_chunk=8, prefix_cache=True,
                           prefill_concurrency=2)
    assert cfg.pages_per_slot == jcfg.pages_per_slot
    assert cfg.total_pages == jcfg.total_pages
    # tenant quotas are ported: they need the prefix cache, as in JAX
    assert EngineConfig(prefix_cache=True,
                        tenant_page_quota=0.5).tenant_page_quota == 0.5
    for bad in (dict(tenant_page_quota=0.5),
                dict(prefix_cache=True, tenant_page_quota=1.5)):
        with pytest.raises(ValueError):
            JaxEngineConfig(**bad)
        with pytest.raises(ValueError):
            EngineConfig(**bad)
