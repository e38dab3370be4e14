"""Port parity, the rest of the serving options: the PyTorch package's queue
tier and tenant lanes, tenant page quotas, the draft-model lane
(``spec_draft="model"``, also int8 and at tp 2 over gloo), the dense KV
layout and host sampling, against the JAX package's engine and queue on
the same numpy inputs and bridged gpt2-tiny weights (float32, reference
attention, dropout off), on the CPU, held to the JAX tests that pin them:
``tests/test_storm.py`` (tier lanes), ``tests/test_prefix.py`` (tenant
lanes and quotas), ``tests/test_spec.py`` (the draft lane) and
``tests/test_paged.py`` (dense and paged greedy equal to ``generate``;
device sampling bit-equal to host sampling). Also the ``EngineConfig``
cross-checks beside JAX's, and a ``serve_lm`` run for each new flag.

Tolerances: greedy streams token for token (the JAX streams and JAX
``generate``); int8 runs on weights snapped to the int8 grid, as JAX's
int8 tests; the port's sampled streams are pinned within the port (its
draw is not JAX's threefry by design)."""

import io
import json
import os
import socket
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_training_tpu.models.generate import generate
from pytorch_distributed_training_tpu.models.gpt2 import GPT2LMModel as JaxGPT2
from pytorch_distributed_training_tpu.ops import quant as jax_quant
from pytorch_distributed_training_tpu.serve import (
    EngineConfig as JaxEngineConfig,
)
from pytorch_distributed_training_tpu.serve import (
    InferenceServer as JaxServer,
)
from pytorch_distributed_training_tpu.serve.queue import (
    GenRequest as JaxGenRequest,
)
from pytorch_distributed_training_tpu.serve.queue import (
    RequestQueue as JaxRequestQueue,
)
from pytorch_distributed_training_tpu.serve.server import wait_until
from pytorch_distributed_training_tpu.utils.config import (
    model_preset as jax_preset,
)
from pytorch_distributed_training_tpu_torch.cli import serve_lm, train_lm
from pytorch_distributed_training_tpu_torch.models.convert import (
    params_from_jax,
)
from pytorch_distributed_training_tpu_torch.models.gpt2 import GPT2LMModel
from pytorch_distributed_training_tpu_torch.serve import (
    EngineConfig,
    GenRequest,
    InferenceServer,
    RequestQueue,
)
from pytorch_distributed_training_tpu_torch.serve.sampling import (
    device_sample,
    host_sample,
)
from pytorch_distributed_training_tpu_torch.utils.config import model_preset

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VOCAB = 1024
QUEUES = {"jax": (JaxRequestQueue, JaxGenRequest),
          "port": (RequestQueue, GenRequest)}


@pytest.fixture(scope="module")
def lms():
    """The JAX gpt2-tiny (float32, reference attention) with its params and
    the params snapped to the int8 grid, and the port's model on each."""
    cfg = jax_preset("gpt2-tiny", compute_dtype="float32",
                     attention_impl="reference", hidden_dropout=0.0,
                     attention_dropout=0.0)
    jmodel = JaxGPT2(cfg)
    params = jmodel.init(jax.random.key(0), jnp.ones((2, 16), jnp.int32))[
        "params"]
    snapped = jax_quant.dequantize_serve_params(
        jax_quant.quantize_serve_params(params))
    models = {}
    for key, tree in (("float", params), ("snapped", snapped)):
        models[key] = GPT2LMModel(model_preset("gpt2-tiny",
                                               compute_dtype="float32"))
        models[key].load_state_dict(
            params_from_jax(jax.tree.map(np.asarray, tree)))
    return jmodel, {"float": params, "snapped": snapped}, models


def _prompts(lengths, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, VOCAB, n).astype(np.int32) for n in lengths]


def _shared_prompts(prefix_len, tail_lens, seed):
    """JAX ``tests/test_prefix.py``'s: one random prefix, random tails."""
    rng = np.random.default_rng(seed)
    prefix = rng.integers(1, VOCAB, prefix_len).astype(np.int32)
    return [np.concatenate([prefix, rng.integers(1, VOCAB, n).astype(
        np.int32)]) for n in tail_lens]


def _want(jmodel, params, prompts, T):
    return [list(np.asarray(generate(jmodel, params, p[None],
                                     max_new_tokens=T))[0, len(p):])
            for p in prompts]


def _run(server, prompts, T, **submit):
    """Serve ``prompts`` at once; the streams and the engine's stats."""
    server.start()
    try:
        reqs = [server.submit(p, max_new_tokens=T,
                              **{k: v[i] if isinstance(v, list) else v
                                 for k, v in submit.items()})
                for i, p in enumerate(prompts)]
        assert wait_until(lambda: all(r.done.is_set() for r in reqs),
                          timeout=120), [r.status for r in reqs]
    finally:
        server.close()
    assert all(r.status == "done" for r in reqs), [r.status for r in reqs]
    return [[int(t) for t in r.tokens] for r in reqs], server.stats()


def _port(model, T, draft=None, **cfg):
    cfg.setdefault("prompt_buckets", (4, 8, 16))
    return InferenceServer(model, EngineConfig(num_slots=2, max_new_tokens=T,
                                               **cfg),
                           device="cpu", queue_depth=16, draft_model=draft)


def _jax(jmodel, params, T, draft=False, **cfg):
    cfg.setdefault("prompt_buckets", (4, 8, 16))
    kw = dict(draft_model=jmodel, draft_params=params) if draft else {}
    return JaxServer(jmodel, params, JaxEngineConfig(
        num_slots=2, max_new_tokens=T, **cfg), queue_depth=16, **kw)


# ------------------------------------------------------------ tier lanes


def _req(cls, rid, tier="interactive", tenant=None):
    return cls(id=rid, prompt_ids=np.ones((3,), np.int32), max_new_tokens=4,
               tier=tier, tenant=tenant)


@pytest.mark.parametrize("pkg", sorted(QUEUES))
def test_tier_lanes_weighted_share_under_contention(pkg):
    queue_cls, req = QUEUES[pkg]
    q = queue_cls(max_depth=64, prompt_buckets=(8, 16), max_new_tokens=64)
    for i in range(8):
        q.submit(_req(req, f"i{i}", "interactive"))
        q.submit(_req(req, f"b{i}", "batch"))
    order = [q.pop_ready().id for _ in range(16)]
    # 4 interactive then 1 batch a cycle; the idle lane takes no turn
    assert order == ["i0", "i1", "i2", "i3", "b0", "i4", "i5", "i6", "i7",
                     "b1", "b2", "b3", "b4", "b5", "b6", "b7"]
    assert q.depth() == 0 and q.pop_ready() is None


@pytest.mark.parametrize("pkg", sorted(QUEUES))
def test_tier_lanes_no_bypass_is_per_lane(pkg):
    queue_cls, req = QUEUES[pkg]
    q = queue_cls(max_depth=64, prompt_buckets=(8, 16), max_new_tokens=64)
    q.submit(_req(req, "big-batch", "batch"))
    q.submit(_req(req, "b2", "batch"))
    q.submit(_req(req, "i1", "interactive"))
    assert q.pop_ready(accept=lambda r: r.tier != "batch").id == "i1"
    assert q.pop_ready(accept=lambda r: r.tier != "batch") is None
    assert q.depth_by_tier() == {"interactive": 0, "batch": 2}
    assert q.pop_ready().id == "big-batch"
    assert q.pop_ready().id == "b2"


@pytest.mark.parametrize("pkg", sorted(QUEUES))
def test_tier_validation_weights_and_depth_by_tier(pkg):
    queue_cls, req = QUEUES[pkg]
    q = queue_cls(max_depth=64, prompt_buckets=(8, 16), max_new_tokens=64)
    with pytest.raises(ValueError, match="tier"):
        q.submit(_req(req, "x", "bulk"))
    for rid, tier in (("a", "interactive"), ("b", "batch"), ("c", "batch")):
        q.submit(_req(req, rid, tier))
    assert q.depth() == 3
    assert q.depth_by_tier() == {"interactive": 1, "batch": 2}
    for bad in ({"interactive": 1}, {"interactive": 1, "batch": 0}):
        with pytest.raises(ValueError, match="tier_weights"):
            queue_cls(max_depth=4, prompt_buckets=(8,), max_new_tokens=4,
                      tier_weights=bad)
    # 1:1 alternates the lanes
    q = queue_cls(max_depth=8, prompt_buckets=(8,), max_new_tokens=4,
                  tier_weights={"interactive": 1, "batch": 1})
    for i in range(2):
        q.submit(_req(req, f"i{i}", "interactive"))
        q.submit(_req(req, f"b{i}", "batch"))
    assert [q.pop_ready().id for _ in range(4)] == ["i0", "b0", "i1", "b1"]


# ---------------------------------------------------------- tenant lanes


@pytest.mark.parametrize("pkg", sorted(QUEUES))
def test_queue_tenant_lanes_blocked_tenant_does_not_freeze_others(pkg):
    queue_cls, req = QUEUES[pkg]
    q = queue_cls(max_depth=8, prompt_buckets=(8,), max_new_tokens=4)
    a1 = q.submit(_req(req, "a1", tenant="ta"))
    a2 = q.submit(_req(req, "a2", tenant="ta"))
    b1 = q.submit(_req(req, "b1", tenant="tb"))
    assert q.pop_ready(accept=lambda r: r.tenant != "ta") is b1
    assert q.depth() == 2
    assert q.pop_ready() is a1 and q.pop_ready() is a2
    assert q.pop_ready() is None
    c1, c2 = q.submit(_req(req, "c1")), q.submit(_req(req, "c2"))
    assert q.pop_ready(accept=lambda r: r is not c1) is None
    assert q.pop_ready() is c1 and q.pop_ready() is c2
    with pytest.raises(ValueError, match="tenant"):
        q.submit(_req(req, "bad", tenant=""))


def test_tenant_quota_holds_flood_without_page_exhaustion(lms):
    """JAX ``tests/test_prefix.py``'s flood: tenant ta's requests would
    pass its 6-page quota two at a time, so the quota serializes them
    (``tenant_blocked``) while tb rides alongside, with no page
    exhaustion; every stream equals the JAX engine's and ``generate``'s."""
    jmodel, params, models = lms
    T = 4
    prompts = _shared_prompts(8, [4, 5, 3, 6, 4], seed=17)
    cfg = dict(prompt_buckets=(16,), page_size=4, num_pages=33,
               prefix_cache=True, tenant_page_quota=0.1875)
    tenants = ["ta" if i != 2 else "tb" for i in range(len(prompts))]
    got, stats = _run(_port(models["float"], T, **cfg), prompts, T,
                      tenant=tenants)
    want, jstats = _run(_jax(jmodel, params["float"], T, **cfg), prompts, T,
                        tenant=tenants)
    assert got == want == _want(jmodel, params["float"], prompts, T)
    for s in (stats, jstats):
        assert s["prefix_cache"]["tenant_blocked"] > 0
        assert s["page_exhausted"] == 0
        assert s["prefix_cache"]["tenant_page_quota"] == 0.1875
    assert stats["kv_pages_used"] == stats["prefix_cache"][
        "prefix_cached_pages"]


def test_tiers_and_tenants_through_the_engine(lms):
    """Tiers and tenants on ``submit`` reach the queue: a mixed batch of
    interactive and batch requests of two tenants all finish, greedy as
    ``generate``."""
    jmodel, params, models = lms
    T = 4
    prompts = _shared_prompts(8, [4, 5, 3, 6], seed=5)
    tiers = ["batch", "interactive", "batch", "interactive"]
    got, stats = _run(_port(models["float"], T, prompt_buckets=(16,),
                            page_size=4, prefix_cache=True,
                            tenant_page_quota=0.5),
                      prompts, T, tier=tiers, tenant=["a", "b", "a", "b"])
    assert got == _want(jmodel, params["float"], prompts, T)
    assert stats["queue_depth_by_tier"] == {"interactive": 0, "batch": 0}


# ------------------------------------------------------ draft-model lane


@pytest.mark.parametrize("case", ["plain", "chunked", "prefix", "int8"])
def test_draft_model_lane_identity_and_acceptance(lms, case):
    """JAX ``tests/test_spec.py``'s draft lane: the base model drafting for
    itself, greedy; the streams equal the JAX engine's with the same
    lane and ``generate``'s, and acceptance is above 0.9."""
    jmodel, params, models = lms
    T = 6
    prompts = _prompts([3, 6, 9, 14, 5], seed=7)
    cfg = {"plain": {}, "chunked": dict(prefill_chunk=4),
           "prefix": dict(prefix_cache=True),
           "int8": dict(weights_dtype="int8", kv_dtype="int8")}[case]
    weights = "snapped" if case == "int8" else "float"
    model = models[weights]
    got, stats = _run(_port(model, T, draft=model, spec_k=3,
                            spec_draft="model", **cfg), prompts, T)
    want, jstats = _run(_jax(jmodel, params[weights], T, draft=True,
                             spec_k=3, spec_draft="model", **cfg),
                        prompts, T)
    assert got == want == _want(jmodel, params[weights], prompts, T)
    assert stats["spec_draft"] == "model"
    assert stats["spec_accept_rate"] > 0.9, stats["spec_accept_rate"]
    assert jstats["spec_accept_rate"] > 0.9


def test_draft_lane_checks(lms):
    _, _, models = lms
    cfg = EngineConfig(num_slots=2, prompt_buckets=(4, 8), max_new_tokens=4,
                       spec_k=2, spec_draft="model")
    with pytest.raises(ValueError, match="needs a draft_model"):
        InferenceServer(models["float"], cfg, device="cpu")
    other = GPT2LMModel(model_preset("gpt2-tiny", vocab_size=512))
    with pytest.raises(ValueError, match="draft vocab 512 != base vocab"):
        InferenceServer(models["float"], cfg, device="cpu",
                        draft_model=other)


_TP_SCRIPT = textwrap.dedent("""
    import json, sys
    import numpy as np
    import torch
    from pytorch_distributed_training_tpu_torch.comms.bootstrap import (
        initialize, shutdown)
    from pytorch_distributed_training_tpu_torch.comms.mesh import build_mesh
    from pytorch_distributed_training_tpu_torch.models.gpt2 import (
        GPT2LMModel)
    from pytorch_distributed_training_tpu_torch.serve import (
        EngineConfig, InferenceServer, run_follower)
    from pytorch_distributed_training_tpu_torch.utils.config import (
        MeshConfig, model_preset)


    def main(out, weights, spec):
        info = initialize(torch.device("cpu"))
        shard = build_mesh(MeshConfig(data=1, model=2), rank=info.rank,
                           world_size=info.world_size).shard("model")
        model = GPT2LMModel(model_preset("gpt2-tiny",
                                         compute_dtype="float32"))
        model.load_state_dict(torch.load(weights))
        cfg = EngineConfig(num_slots=2, prompt_buckets=(4, 8, 16),
                           max_new_tokens=spec["T"], tp=2, spec_k=3,
                           spec_draft="model", **spec["cfg"])
        if shard.index:
            stats = run_follower(model, cfg, device="cpu", shard=shard,
                                 draft_model=model)
            rec = dict(calls=stats["calls"])
        else:
            server = InferenceServer(model, cfg, device="cpu", shard=shard,
                                     draft_model=model).start()
            reqs = [server.submit(np.asarray(p, np.int32),
                                  max_new_tokens=spec["T"])
                    for p in spec["prompts"]]
            for r in reqs:
                r.done.wait(120)
            server.close()
            stats = server.stats()
            rec = dict(streams=[list(map(int, r.tokens)) for r in reqs],
                       status=[r.status for r in reqs],
                       stats={k: stats[k] for k in (
                           "spec_accept_rate", "spec_draft", "tp")})
        with open(f"{out}.{info.rank}.json", "w") as f:
            json.dump(rec, f)


    torch.set_num_threads(1)
    # every object holding the group is gone before it is destroyed
    main(sys.argv[1], sys.argv[2], json.loads(sys.argv[3]))
    shutdown()
""")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_draft_model_lane_tp2_over_gloo(lms, tmp_path):
    """The draft lane of a replica over two gloo processes (the draft cut
    into head slices beside the base; every rank runs the chain of draft
    decodes on its slice): float and int8 streams equal one process's
    and the JAX engine's."""
    jmodel, params, models = lms
    T = 6
    prompts = _prompts([3, 6, 9, 14, 5], seed=7)
    runs = {"float": ("float", {}),
            "int8": ("snapped", dict(weights_dtype="int8", kv_dtype="int8"))}
    base = dict(os.environ, CUDA_VISIBLE_DEVICES="", MASTER_ADDR="127.0.0.1",
                GLOO_SOCKET_IFNAME="lo", PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = []
    for name, (weights, cfg) in runs.items():
        path = tmp_path / f"{weights}.pt"
        torch.save(models[weights].state_dict(), path)
        spec = dict(T=T, cfg=cfg, prompts=[p.tolist() for p in prompts])
        port = str(_free_port())
        for r in range(2):
            env = dict(base, MASTER_PORT=port, WORLD_SIZE="2", RANK=str(r),
                       LOCAL_RANK=str(r))
            procs.append(subprocess.Popen(
                [sys.executable, "-c", _TP_SCRIPT, str(tmp_path / name),
                 str(path), json.dumps(spec)], cwd=REPO, env=env,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    try:
        for p in procs:
            _, err = p.communicate(timeout=300)
            assert p.returncode == 0, err[-3000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for name, (weights, cfg) in runs.items():
        lead = json.loads((tmp_path / f"{name}.0.json").read_text())
        follow = json.loads((tmp_path / f"{name}.1.json").read_text())
        assert lead["status"] == ["done"] * len(prompts)
        one, _ = _run(_port(models[weights], T, draft=models[weights],
                            spec_k=3, spec_draft="model", **cfg), prompts, T)
        want = _want(jmodel, params[weights], prompts, T)
        assert lead["streams"] == one == want, name
        assert lead["stats"]["tp"] == 2
        assert lead["stats"]["spec_accept_rate"] > 0.9
        assert follow["calls"] > 0


# ------------------------------------------------ dense layout, sampling


def test_paged_greedy_token_identical_to_dense_and_generate(lms):
    """JAX ``tests/test_paged.py``'s pin: paged + device and dense + host
    greedy streams equal ``generate`` at the exact prompt length, and the
    JAX engines' streams."""
    jmodel, params, models = lms
    T = 5
    prompts = _prompts([3, 6, 9, 14, 5], seed=7)
    want = _want(jmodel, params["float"], prompts, T)
    paged, pstats = _run(_port(models["float"], T), prompts, T)
    dense, dstats = _run(_port(models["float"], T, kv_layout="dense",
                               sampling="host"), prompts, T)
    jdense, _ = _run(_jax(jmodel, params["float"], T, kv_layout="dense",
                          sampling="host"), prompts, T)
    assert paged == dense == jdense == want
    assert pstats["kv_layout"] == "paged" and pstats["kv_pages_peak"] > 0
    assert dstats["kv_layout"] == "dense" and dstats["kv_pages_total"] is None
    assert dstats["sampling"] == "host" and dstats["kv_bytes_per_token"] is None


@pytest.mark.parametrize("layout,sampling", [("dense", "device"),
                                             ("paged", "host")])
def test_dense_and_host_apart_greedy_identical(lms, layout, sampling):
    jmodel, params, models = lms
    T = 5
    prompts = _prompts([3, 6, 9, 14, 5], seed=9)
    got, _ = _run(_port(models["float"], T, kv_layout=layout,
                        sampling=sampling), prompts, T)
    assert got == _want(jmodel, params["float"], prompts, T)


def test_device_sample_bitwise_matches_host_sampler():
    """JAX ``tests/test_paged.py``'s cells: ``device_sample`` and
    ``host_sample`` pick the same token for every (temperature, top_k,
    seed, step), greedy ties, k 0, 1 and above the vocabulary included."""
    vocab = 32
    rng = np.random.default_rng(0)
    cases = [(0.0, 0), (0.0, 5), (0.7, 0), (0.7, 5), (1.3, 1),
             (0.9, vocab + 100)]
    drawn = set()
    for seed in (0, 11):
        for step in (0, 1, 5):
            logits = rng.standard_normal((len(cases), vocab)).astype(
                np.float32)
            logits[0, 3] = logits[0, 7] = logits[0].max() + 1.0
            got = device_sample(torch.from_numpy(logits),
                                [seed] * len(cases), [step] * len(cases),
                                [t for t, _ in cases], [k for _, k in cases])
            for i, (temp, top_k) in enumerate(cases):
                want = host_sample(logits[i], seed, step, temp, top_k)
                assert int(got[i]) == want, (temp, top_k, seed, step)
                drawn.add((i, want))
            assert int(got[0]) == 3  # the first of the tied maxima
            for i in (1, 4):  # greedy ignores top_k; k = 1 is the argmax
                assert int(got[i]) == int(np.argmax(logits[i]))
    assert len(drawn) > len(cases) + 2  # the streams move


def test_sampled_device_matches_host_under_fixed_seed(lms):
    """JAX ``tests/test_paged.py``'s: fixed-seed sampled streams equal
    across the sampling place and the cache layout (paged + device ==
    dense + host), within the port."""
    _, _, models = lms
    T = 6
    prompts = _prompts([3, 7, 12], seed=3)
    kw = dict(temperature=0.8, top_k=5, seed=[11, 12, 13])
    device, _ = _run(_port(models["float"], T), prompts, T, **kw)
    host, _ = _run(_port(models["float"], T, kv_layout="dense",
                         sampling="host"), prompts, T, **kw)
    assert device == host
    greedy, _ = _run(_port(models["float"], T), prompts, T)
    assert device != greedy


# ------------------------------------------------------- cross-checks


BAD_CONFIGS = {
    "spec_dense": dict(spec_k=2, kv_layout="dense"),
    "spec_host": dict(spec_k=2, sampling="host"),
    "chunk_dense": dict(prefill_chunk=4, kv_layout="dense"),
    "chunk_host": dict(prefill_chunk=4, sampling="host"),
    "tp_dense": dict(tp=2, kv_layout="dense"),
    "tp_host": dict(tp=2, sampling="host"),
    "prefix_dense": dict(prefix_cache=True, kv_layout="dense"),
    "prefix_host": dict(prefix_cache=True, sampling="host"),
    "int8_kv_dense": dict(kv_dtype="int8", kv_layout="dense"),
    "quota_no_prefix": dict(tenant_page_quota=0.25),
    "quota_range": dict(prefix_cache=True, tenant_page_quota=1.5),
    "layout": dict(kv_layout="ragged"),
    "sampling": dict(sampling="gpu"),
    "draft": dict(spec_draft="oracle"),
}


@pytest.mark.parametrize("case", sorted(BAD_CONFIGS))
def test_engine_config_cross_checks_as_jax(case):
    for cls in (JaxEngineConfig, EngineConfig):
        with pytest.raises(ValueError):
            cls(**BAD_CONFIGS[case])


def test_engine_config_good_combinations_build():
    for kw in (dict(kv_layout="dense", sampling="host"),
               dict(kv_layout="dense", weights_dtype="int8"),
               dict(spec_k=2, spec_draft="model", prefill_chunk=4,
                    prefix_cache=True, tenant_page_quota=0.5, tp=2,
                    kv_dtype="int8")):
        port, ref = EngineConfig(**kw), JaxEngineConfig(**kw)
        assert port.pages_per_slot == ref.pages_per_slot
        assert port.total_pages == ref.total_pages


# --------------------------------------------------------- serve_lm flags


_CPU = ["--model", "gpt2-tiny", "--device", "cpu", "--prompt-buckets",
        "16,32", "--max-new-tokens-cap", "6"]
LINES = [dict(id=f"q{i}", prompt=p, max_new_tokens=6) for i, p in
         enumerate(("hello there", "hello there, friend", "a b c d"))]


def _stdio(argv, lines=LINES):
    out = io.StringIO()
    stats = serve_lm.main(argv, in_stream=io.StringIO(
        "".join(json.dumps(m) + "\n" for m in lines)), out_stream=out)
    events = [json.loads(line) for line in out.getvalue().splitlines()]
    done = {e["id"]: e for e in events if e["event"] == "done"}
    return {k: done[k]["text"] for k in sorted(done)}, stats, events


@pytest.fixture(scope="module")
def plain_stdio():
    return _stdio(_CPU)[0]


@pytest.mark.parametrize("flags", [
    ["--kv-layout", "dense"], ["--sampling", "host"],
    ["--kv-layout", "dense", "--sampling", "host"],
])
def test_serve_lm_dense_and_host_flags(plain_stdio, flags):
    texts, stats, _ = _stdio(_CPU + flags)
    assert texts == plain_stdio
    assert stats["kv_layout"] == flags[flags.index("--kv-layout") + 1] if (
        "--kv-layout" in flags) else stats["kv_layout"] == "paged"


def test_serve_lm_tenant_page_quota_and_request_lanes(plain_stdio):
    lines = [dict(m, tenant=t, tier=tier) for m, t, tier in zip(
        LINES, ("a", "b", "a"), ("batch", "interactive", "batch"))]
    texts, stats, _ = _stdio(_CPU + ["--prefix-cache", "--page-size", "4",
                                     "--tenant-page-quota", "0.5"], lines)
    assert texts == plain_stdio
    assert stats["prefix_cache"]["tenant_page_quota"] == 0.5
    bad = [dict(LINES[0], tier="bulk"), dict(LINES[1], tenant="")]
    _, _, events = _stdio(_CPU, bad)
    assert [e["event"] for e in events] == ["error", "error"]
    assert "tier" in events[0]["error"] and "tenant" in events[1]["error"]
    with pytest.raises(ValueError, match="requires prefix_cache"):
        _stdio(_CPU + ["--tenant-page-quota", "0.5"])


def test_serve_lm_draft_checkpoint(tmp_path):
    """``--spec-k --draft-checkpoint DIR --draft-model gpt2-tiny`` on a
    checkpoint the port's ``train_lm`` wrote (its scanned trunk): the
    draft lane serves the base model's greedy streams, the base model
    loaded from the same checkpoint drafting for itself."""
    ck = str(tmp_path / "ck")
    train_lm.main(["--model", "gpt2-tiny", "--device", "cpu",
                   "--train-size", "32", "--eval-size", "16",
                   "--global-batch-size", "16", "--micro-batch-size", "8",
                   "--num-epochs", "1", "--log-every", "0",
                   "--checkpoint-dir", ck])
    argv = _CPU + ["--checkpoint-dir", ck]
    want, _, _ = _stdio(argv)
    got, stats, _ = _stdio(argv + ["--spec-k", "3", "--draft-checkpoint", ck,
                                   "--draft-model", "gpt2-tiny"])
    assert got == want
    assert stats["spec_draft"] == "model" and stats["weights_step"] == 2
    assert stats["spec_accept_rate"] > 0.9
    ngram, nstats, _ = _stdio(argv + ["--spec-k", "3"])
    assert ngram == want and nstats["spec_draft"] == "ngram"
