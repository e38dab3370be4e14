"""Port parity, tensor-parallel serving: the PyTorch package's serving specs
(``parallel/sharding.serve_param_specs``, ``serve_pool_shape``) against
the JAX package's ``serve_param_shardings`` and ``serve_pool_pspec`` on a
2-device ``model`` mesh, the cut of int8 weights quantized whole, the
engine's ``tp`` checks (JAX ``tests/test_tp_serve.py:197``), and a replica
over two gloo processes (the leader's ``DecodeEngine`` and a follower,
``serve/tp_worker.py``) against one process and the JAX references:
greedy, sampled, speculative, chunked, prefix-cache and int8 streams
(JAX ``tests/test_tp_serve.py:140-188``, ``test_prefix.py:443``,
``test_quant_serve.py:303``), ``serve_lm --tp 2`` over stdio, and a
leader whose dispatch fails ending its follower. gpt2-tiny (2 layers,
hidden 64, 4 heads: 2 a rank), float32, reference attention, weights
bridged from the JAX params. Every gloo run of the file starts at once
(``runs``)."""

import json
import os
import socket
import subprocess
import sys
import textwrap
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_training_tpu.comms.mesh import (
    build_mesh as jax_build_mesh,
)
from pytorch_distributed_training_tpu.models.generate import generate
from pytorch_distributed_training_tpu.models.gpt2 import GPT2LMModel as JaxGPT2
from pytorch_distributed_training_tpu.ops import quant as jax_quant
from pytorch_distributed_training_tpu.parallel.sharding import (
    serve_param_shardings,
    serve_pool_pspec,
)
from pytorch_distributed_training_tpu.serve import (
    EngineConfig as JaxEngineConfig,
)
from pytorch_distributed_training_tpu.serve import (
    InferenceServer as JaxServer,
)
from pytorch_distributed_training_tpu.serve.server import wait_until
from pytorch_distributed_training_tpu.utils.config import (
    MeshConfig as JaxMeshConfig,
)
from pytorch_distributed_training_tpu.utils.config import (
    model_preset as jax_preset,
)
from pytorch_distributed_training_tpu_torch.cli import serve_lm
from pytorch_distributed_training_tpu_torch.comms.mesh import AxisShard
from pytorch_distributed_training_tpu_torch.models.convert import (
    params_from_jax,
)
from pytorch_distributed_training_tpu_torch.models.gpt2 import (
    GPT2LMModel,
    unscanned,
)
from pytorch_distributed_training_tpu_torch.parallel import (
    serve_param_specs,
    serve_pool_shape,
)
from pytorch_distributed_training_tpu_torch.serve import (
    DecodeEngine,
    EngineConfig,
    InferenceServer,
    RequestQueue,
)
from pytorch_distributed_training_tpu_torch.serve.engine import ServeSlice
from pytorch_distributed_training_tpu_torch.utils.config import model_preset
from test_torch_fsdp import _jax_path

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TP = 2
HEADS, HEAD_DIM, VOCAB = 4, 16, 1024
# the first decode dispatch's logits against one process: float32 sums of
# the heads' and columns' partials in another order
LOGITS_ATOL = 1e-5


def _prompts(lengths, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, VOCAB, n).astype(np.int32) for n in lengths]


def _shared_prompts(prefix_len, tail_lens, seed):
    """JAX ``tests/test_prefix.py``'s: one random prefix, random tails."""
    rng = np.random.default_rng(seed)
    prefix = rng.integers(1, VOCAB, prefix_len).astype(np.int32)
    return [np.concatenate([prefix, rng.integers(1, VOCAB, n).astype(
        np.int32)]) for n in tail_lens]


def _engine_cfg(**kw):
    kw.setdefault("prompt_buckets", (4, 8, 16))
    kw.setdefault("page_size", 4)
    return dict(num_slots=2, **kw)


# each scenario of the gloo replica (JAX's tests' prompts and knobs):
# (prompts, new tokens, engine knobs, submit knobs, weights, serial)
SCENARIOS = {
    "greedy": (_prompts([3, 6, 9, 14, 5], 7), 6, {}, {}, "float", False),
    "sampled": (_prompts([3, 7, 12], 3), 6, {},
                dict(temperature=0.8, top_k=5, seed=11), "float", False),
    "spec": (_prompts([3, 9, 14, 16, 5], 2), 5, dict(spec_k=3), {}, "float",
             False),
    "chunked": (_prompts([3, 9, 14, 16, 5], 2), 5, dict(prefill_chunk=4), {},
                "float", False),
    "prefix": (_shared_prompts(14, [4, 6], 5), 5,
               dict(prompt_buckets=(24,), num_pages=64, prefix_cache=True),
               {}, "float", True),
    "int8": (_prompts([3, 6, 9, 14, 5], 11), 6,
             dict(weights_dtype="int8", kv_dtype="int8"), {}, "snapped",
             False),
}
STDIO_LINES = "".join(json.dumps({"id": f"q{i}", "prompt": p,
                                  "max_new_tokens": 6}) + "\n"
                      for i, p in enumerate(("hi there", "The quick brown",
                                             "tensor parallel serving")))
STDIO_ARGV = ["--model", "gpt2-tiny", "--device", "cpu", "--prompt-buckets",
              "16,32", "--max-new-tokens-cap", "8"]


@pytest.fixture(scope="module")
def lms():
    """The JAX gpt2-tiny (float32, reference attention) and its params,
    the params snapped to the int8 grid, and the port's model on each."""
    cfg = jax_preset(
        "gpt2-tiny", compute_dtype="float32", attention_impl="reference",
        hidden_dropout=0.0, attention_dropout=0.0,
    )
    jmodel = JaxGPT2(cfg)
    params = jmodel.init(jax.random.key(0), jnp.ones((2, 16), jnp.int32))[
        "params"]
    snapped = jax_quant.dequantize_serve_params(
        jax_quant.quantize_serve_params(params))
    models = {}
    for key, tree in (("float", params), ("snapped", snapped)):
        models[key] = GPT2LMModel(
            model_preset("gpt2-tiny", compute_dtype="float32"))
        models[key].load_state_dict(params_from_jax(jax.tree.map(np.asarray,
                                                                 tree)))
    return (jmodel, params, snapped), models


def _jax_mesh():
    return jax_build_mesh(JaxMeshConfig(data=1, fsdp=1, stage=1, model=TP,
                                        seq=1), devices=jax.devices()[:TP])


def _flat(tree) -> dict:
    return {tuple(k.key for k in path): leaf for path, leaf in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _serving(model, weights_dtype):
    import copy

    m = copy.deepcopy(model)
    m.cast_for_serving(weights_dtype)
    return m


# ------------------------------------------------------- specs and pools


@pytest.mark.parametrize("weights_dtype", ["float32", "int8"])
def test_serve_param_specs_match_jax_serve_param_shardings(lms,
                                                           weights_dtype):
    (_, params, _), models = lms
    model = _serving(models["float"], weights_dtype)
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    got = serve_param_specs(shapes, TP)
    tree = (jax_quant.quantize_serve_params(params)
            if weights_dtype == "int8" else params)
    want = _flat(serve_param_shardings(tree, _jax_mesh()))
    leaves = _flat(tree)
    assert got.keys() == shapes.keys()
    assert {_jax_path(n, False) for n in got} == set(want)
    split = 0
    for name, spec in got.items():
        path = _jax_path(name, False)
        assert tuple(leaves[path].shape) == shapes[name], name
        jspec = tuple(want[path].spec)
        jspec += (None,) * (len(shapes[name]) - len(jspec))
        assert spec == jspec, (name, spec, jspec)
        split += "model" in spec
    # q, k, v kernels and biases, out and mlp_down kernels, mlp_up kernel
    # and bias, and under int8 the scales of q, k, v, mlp_up: a layer
    per_layer = 10 + (4 if weights_dtype == "int8" else 0)
    assert split == per_layer * model.config.num_layers


@pytest.mark.parametrize("shape", [(13, 4, HEADS, HEAD_DIM), (13, 4, HEADS)])
def test_serve_pool_shape_matches_jax_serve_pool_pspec(shape):
    from jax.sharding import NamedSharding

    want = NamedSharding(_jax_mesh(), serve_pool_pspec(len(shape)))
    assert serve_pool_shape(shape, TP) == tuple(want.shard_shape(shape))
    assert serve_pool_shape(shape, 1) == shape


def test_int8_weights_quantized_whole_then_cut(lms):
    """Each rank's int8 kernels and scales are its slice of JAX's
    ``quantize_serve_params`` of the whole tree sharded by
    ``serve_param_shardings``, bit for bit: a row-parallel scale (``out``,
    ``mlp_down``) is a max over the input dim the cut splits, so
    quantizing a slice would give others."""
    (_, params, _), models = lms
    qtree = jax_quant.quantize_serve_params(params)
    mesh = _jax_mesh()
    shardings = _flat(serve_param_shardings(qtree, mesh))
    leaves = {k: np.asarray(v) for k, v in _flat(qtree).items()}
    cfg = EngineConfig(**_engine_cfg(tp=TP, weights_dtype="int8",
                                     kv_dtype="int8"))
    row_parallel = 0
    for r in range(TP):
        shard = AxisShard(group=None, index=r, size=TP, ranks=(0, 1))
        part = ServeSlice(models["float"], cfg, device="cpu", shard=shard)
        for name, p in part._model.named_parameters():
            path = _jax_path(name, False)
            index = shardings[path].devices_indices_map(
                leaves[path].shape)[mesh.devices.reshape(-1)[r]]
            want = leaves[path][index]
            np.testing.assert_array_equal(p.numpy(), want, err_msg=name)
            if name.endswith(("out.kernel_scale", "mlp_down.kernel_scale")):
                row_parallel += 1
        # its pools at heads / tp, the page axis whole
        pools, scales = part._pools[0][0], part._scales[0][0]
        assert tuple(pools.shape) == (cfg.total_pages, 4, HEADS // TP,
                                      HEAD_DIM)
        assert tuple(scales.shape) == (cfg.total_pages, 4, HEADS // TP)
    assert row_parallel == TP * 2 * models["float"].config.num_layers


def test_unscanned_trunk_serves_the_same_values():
    """A scanned trunk is laid out a block a module before the cut (JAX
    unstacks it before serving): the same logits, bit for bit."""
    gen = torch.Generator().manual_seed(3)
    scanned = GPT2LMModel(model_preset("gpt2-tiny", compute_dtype="float32",
                                       scan_layers=True), generator=gen)
    flat = unscanned(scanned)
    assert not flat.config.scan_layers and hasattr(flat, "blocks")
    ids = torch.randint(1, VOCAB, (2, 9), generator=gen)
    with torch.no_grad():
        assert torch.equal(flat(ids), scanned(ids))
    shapes = {n: tuple(p.shape) for n, p in flat.named_parameters()}
    assert any("model" in s for s in serve_param_specs(shapes, TP).values())


# ------------------------------------------------------------ validation


def _engine(model, tp, shard=None):
    return DecodeEngine(
        model, EngineConfig(**_engine_cfg(tp=tp)),
        RequestQueue(max_depth=4, prompt_buckets=(4, 8, 16),
                     max_new_tokens=4),
        device="cpu", shard=shard)


def test_tp_head_divisibility_rejected(lms):
    _, models = lms
    shard = AxisShard(group=None, index=0, size=3, ranks=(0, 1, 2))
    with pytest.raises(ValueError, match=r"tp=3 does not divide.*num_heads=4"):
        _engine(models["float"], 3, shard)


@pytest.mark.parametrize("size", [None, 4])
def test_tp_group_size_must_equal_tp(lms, size):
    _, models = lms
    shard = None if size is None else AxisShard(
        group=None, index=0, size=size, ranks=tuple(range(size)))
    with pytest.raises(ValueError,
                       match=rf"tp=2 needs a model group of 2 ranks, got "
                             rf"{size or 1}"):
        _engine(models["float"], 2, shard)


def test_tp_below_one_rejected():
    with pytest.raises(ValueError, match="tp must be >= 1, got 0"):
        EngineConfig(tp=0)


def test_serve_lm_tp_must_equal_world_size(monkeypatch):
    for name in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(name, raising=False)
    with pytest.raises(ValueError,
                       match=r"--tp 2 must equal the world size 1"):
        serve_lm.main(STDIO_ARGV + ["--tp", "2"])


# --------------------------------------------------------- gloo replicas

_SCRIPT = textwrap.dedent("""
import json, sys, time
import torch
from pytorch_distributed_training_tpu_torch.comms.bootstrap import (
    initialize, shutdown)
from pytorch_distributed_training_tpu_torch.comms.mesh import build_mesh
from pytorch_distributed_training_tpu_torch.models.gpt2 import GPT2LMModel
from pytorch_distributed_training_tpu_torch.serve import (
    EngineConfig, InferenceServer)
from pytorch_distributed_training_tpu_torch.serve.tp_worker import TPFollower
from pytorch_distributed_training_tpu_torch.utils.config import (
    MeshConfig, model_preset)


def shapes(pairs):
    return [list(t.shape) for pair in pairs or () for t in pair]


def follow(model, cfg, shard):
    follower = TPFollower(model, cfg, device="cpu", shard=shard)
    calls = follower.run()
    return dict(calls=calls, stats=follower.stats(), end_t=time.time(),
                pools=shapes(follower._pools),
                scales=shapes(follower._scales))


def lead(model, cfg, shard, sc):
    server = InferenceServer(model, cfg, device="cpu", queue_depth=16,
                             shard=shard)
    engine, first = server.engine, []
    forward = engine._forward

    def record(ids, *args, **kw):
        logits = forward(ids, *args, **kw)
        if not first and ids.shape == (cfg.num_slots, 1):
            first.append(logits[:, 0].tolist())
        return logits

    engine._forward = record
    if sc.get("fail_after") is not None:
        dispatch, done = engine._dispatch, []

        def failing(*args, **kw):
            done.append(1)
            if len(done) > sc["fail_after"]:
                raise RuntimeError("injected dispatch failure")
            return dispatch(*args, **kw)

        engine._dispatch = failing
    server.start()
    reqs = []
    for i, p in enumerate(sc["prompts"]):
        kw = dict(sc["submit"])
        kw["seed"] = kw.get("seed", 0) + i
        reqs.append(server.submit(p, max_new_tokens=sc["T"], **kw))
        if sc["serial"]:
            reqs[-1].done.wait(120)
    for r in reqs:
        r.done.wait(120)
    failed_t = time.time()
    server.close()
    return dict(tokens=[list(r.tokens) for r in reqs],
                status=[r.status for r in reqs], stats=server.stats(),
                first_logits=first[0] if first else None, failed_t=failed_t,
                pools=shapes(engine._pools), scales=shapes(engine._scales))


def main(out, spec):
    info = initialize(torch.device("cpu"))
    shard = build_mesh(MeshConfig(data=1, model=2), rank=info.rank,
                       world_size=info.world_size).shard("model")
    models = {}
    for key, path in spec["weights"].items():
        models[key] = GPT2LMModel(model_preset("gpt2-tiny",
                                               compute_dtype="float32"))
        models[key].load_state_dict(torch.load(path))
    results = {}
    for name, sc in spec["scenarios"].items():
        cfg = EngineConfig(tp=2, **sc["config"])
        model = models[sc["weights"]]
        results[name] = (follow(model, cfg, shard) if shard.index
                         else lead(model, cfg, shard, sc))
    with open(f"{out}.{info.rank}.json", "w") as f:
        json.dump(results, f)


torch.set_num_threads(1)
# every object holding the group is gone before it is destroyed
main(sys.argv[1], json.loads(sys.argv[2]))
shutdown()
""")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _start(world, argv, stdin="") -> list:
    """``world`` processes of ``argv`` (after ``python``) over gloo on a
    free localhost port, rank 0 reading ``stdin``."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(_free_port()), WORLD_SIZE=str(world),
               GLOO_SOCKET_IFNAME="lo", PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = []
    for r in range(world):
        p = subprocess.Popen(
            [sys.executable, "-X", "faulthandler"] + argv, cwd=REPO,
            env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
            stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
        p.stdin.write(stdin if r == 0 else "")
        p.stdin.close()
        p.stdin = None  # written whole: communicate() has nothing to send
        procs.append(p)
    return procs


def _wait(procs, timeout=240) -> list:
    """Each process's stdout; raises unless every one exits 0 within
    ``timeout`` seconds."""
    t0, out = time.monotonic(), []
    try:
        for p in procs:
            left = max(1.0, timeout - (time.monotonic() - t0))
            stdout, err = p.communicate(timeout=left)
            assert p.returncode == 0, err[-3000:]
            out.append(stdout)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return out


def _spec(scenarios: dict, weights: dict) -> dict:
    return dict(weights=weights, scenarios={
        name: dict(prompts=[p.tolist() for p in prompts], T=T,
                   config=_engine_cfg(max_new_tokens=T, **cfg),
                   submit=submit,
                   weights=key, serial=serial, **extra)
        for name, (prompts, T, cfg, submit, key, serial, extra) in
        scenarios.items()})


def _serve_port(model, prompts, T, cfg, submit, serial):
    """One process: the streams, stats and first decode dispatch's logits
    of the port's engine (``cfg``: the engine knobs, tp among them)."""
    server = InferenceServer(
        model, EngineConfig(**_engine_cfg(max_new_tokens=T, **cfg)),
        device="cpu", queue_depth=16)
    engine, first = server.engine, []
    forward = engine._forward

    def record(ids, *args, **kw):
        logits = forward(ids, *args, **kw)
        if not first and ids.shape == (engine.config.num_slots, 1):
            first.append(logits[:, 0].clone())
        return logits

    engine._forward = record
    server.start()
    try:
        reqs = []
        for i, p in enumerate(prompts):
            kw = dict(submit)
            kw["seed"] = kw.get("seed", 0) + i
            reqs.append(server.submit(p, max_new_tokens=T, **kw))
            if serial:
                assert reqs[-1].done.wait(120)
        assert wait_until(lambda: all(r.done.is_set() for r in reqs),
                          timeout=120)
    finally:
        server.close()
    assert all(r.status == "done" for r in reqs), [r.status for r in reqs]
    return ([list(r.tokens) for r in reqs], server.stats(),
            first[0] if first else None)


def _want(jlm, prompts, T, params):
    jmodel = jlm[0]
    return [np.asarray(generate(jmodel, params, p[None],
                                max_new_tokens=T))[0, len(p):].tolist()
            for p in prompts]


@pytest.fixture(scope="module")
def runs(lms, tmp_path_factory):
    """Every gloo run of the file, started at once: the six scenarios on
    one replica of two processes, ``serve_lm --tp 2`` over stdio, and a
    leader whose fourth dispatch raises; meanwhile in this process, each
    scenario at tp=1, ``serve_lm`` at tp=1 and the JAX references."""
    jlm, models = lms
    tmp = tmp_path_factory.mktemp("tp_serve")
    weights = {}
    for key, model in models.items():
        weights[key] = str(tmp / f"{key}.pt")
        torch.save(model.state_dict(), weights[key])
    scenarios = {k: v + ({},) for k, v in SCENARIOS.items()}
    fail = {"fail": (_prompts([3, 6, 9], 1), 6, {}, {}, "float", False,
                     dict(fail_after=3))}
    procs = {
        "replica": _start(TP, ["-c", _SCRIPT, str(tmp / "replica"),
                               json.dumps(_spec(scenarios, weights))]),
        "fail": _start(TP, ["-c", _SCRIPT, str(tmp / "fail"),
                            json.dumps(_spec(fail, weights))]),
        "stdio": _start(TP, ["-m",
                             "pytorch_distributed_training_tpu_torch.cli."
                             "serve_lm"] + STDIO_ARGV + ["--tp", str(TP)],
                        stdin=STDIO_LINES),
    }
    try:
        import io

        one = {name: _serve_port(models[key], prompts, T, cfg, submit,
                                 serial)
               for name, (prompts, T, cfg, submit, key, serial) in
               SCENARIOS.items()}
        stdio_one = io.StringIO()
        serve_lm.main(STDIO_ARGV, in_stream=io.StringIO(STDIO_LINES),
                      out_stream=stdio_one)
        jax_want = {name: _want(jlm, SCENARIOS[name][0], SCENARIOS[name][1],
                                jlm[1])
                    for name in ("greedy", "spec", "prefix")}
        jmodel, params, _ = jlm
        prompts, T = SCENARIOS["greedy"][:2]
        jserver = JaxServer(jmodel, params, JaxEngineConfig(
            **_engine_cfg(max_new_tokens=T, kv_layout="paged",
                          sampling="device", tp=TP)), queue_depth=16).start()
        try:
            jreqs = [jserver.submit(p, max_new_tokens=T, seed=i)
                     for i, p in enumerate(prompts)]
            assert wait_until(lambda: all(r.done.is_set() for r in jreqs),
                              timeout=120)
        finally:
            jserver.close()
        jax_tp2 = [np.asarray(r.tokens).tolist() for r in jreqs]
    finally:
        outs = {name: _wait(p) for name, p in procs.items()}

    def ranks(name):
        return [json.loads((tmp / f"{name}.{r}.json").read_text())
                for r in range(TP)]

    return dict(replica=ranks("replica"), fail=ranks("fail"),
                stdio=outs["stdio"], stdio_one=stdio_one.getvalue(), one=one,
                jax_want=jax_want, jax_tp2=jax_tp2)


def _ended(runs, name):
    leader, follower = runs["replica"][0][name], runs["replica"][1][name]
    assert leader["status"] == ["done"] * len(SCENARIOS[name][0])
    return leader, follower


def test_tp2_greedy_equals_tp1_generate_and_jax_tp2(runs):
    leader, _ = _ended(runs, "greedy")
    assert leader["tokens"] == runs["one"]["greedy"][0]
    assert leader["tokens"] == runs["jax_want"]["greedy"]
    assert leader["tokens"] == runs["jax_tp2"]


def test_tp2_fixed_seed_sampled_equals_tp1(runs):
    leader, _ = _ended(runs, "sampled")
    assert leader["tokens"] == runs["one"]["sampled"][0]
    assert all(len(t) == SCENARIOS["sampled"][1] for t in leader["tokens"])


@pytest.mark.parametrize("name,count", [("spec", "spec_dispatches"),
                                        ("chunked", "prefill_chunks")])
def test_tp2_spec_and_chunked_equal_generate(runs, name, count):
    leader, follower = _ended(runs, name)
    assert leader["tokens"] == runs["jax_want"]["spec"]
    assert leader["tokens"] == runs["one"][name][0]
    assert leader["stats"][count] > 0
    assert leader["stats"][count] == runs["one"][name][1][count]


def test_tp2_prefix_cache_hit_and_cow_equal_generate(runs):
    leader, follower = _ended(runs, "prefix")
    assert leader["tokens"] == runs["jax_want"]["prefix"]
    pc = leader["stats"]["prefix_cache"]
    assert pc["prefix_hits"] == 1 and pc["cow_copies"] == 1
    # the follower ran every forward and the one page copy
    one = runs["one"]["prefix"][1]
    assert follower["calls"] == (one["prefill_dispatches"]
                                 + one["prefill_chunks"]
                                 + one["decode_dispatches"] + 1)


def test_tp2_int8_weights_and_kv_equal_tp1_int8(runs):
    leader, follower = _ended(runs, "int8")
    assert leader["tokens"] == runs["one"]["int8"][0]
    assert leader["stats"]["variant"] == follower["stats"]["variant"] == (
        "int8")


def test_tp2_stats_and_pools(runs):
    """``stats()["tp"]``, page counts equal to tp=1's, and each rank's
    pools at heads / tp with the page axis whole; slice bytes a rank."""
    for name in SCENARIOS:
        leader, follower = _ended(runs, name)
        one = runs["one"][name][1]
        st = leader["stats"]
        assert st["tp"] == follower["stats"]["tp"] == TP and one["tp"] == 1
        for key in ("kv_pages_total", "kv_page_size"):
            assert st[key] == one[key], (name, key)
        assert st["kv_heads"] == follower["stats"]["kv_heads"] == HEADS // TP
        assert st["kv_bytes_per_token"] * TP == one["kv_bytes_per_token"]
        assert st["weight_bytes"] < one["weight_bytes"]
        pages = one["kv_pages_total"] + 1
        page = SCENARIOS[name][2].get("page_size", 4)
        for rank in (leader, follower):
            assert rank["pools"] == [[pages, page, HEADS // TP, HEAD_DIM]] * 4
            int8 = SCENARIOS[name][2].get("kv_dtype") == "int8"
            assert rank["scales"] == ([[pages, page, HEADS // TP]] * 4
                                      if int8 else [])


def test_tp2_first_decode_logits_match_tp1(runs):
    for name in ("greedy", "int8"):
        leader, _ = _ended(runs, name)
        got = torch.tensor(leader["first_logits"])
        want = runs["one"][name][2]
        torch.testing.assert_close(got, want, rtol=0, atol=LOGITS_ATOL)


def test_serve_lm_tp2_stdio_equals_tp1(runs):
    """Rank 0's events are ``serve_lm``'s at tp=1 (but for the time to
    the first token); the follower writes none; both exit 0."""
    def events(text):
        return [{k: v for k, v in json.loads(line).items() if k != "ttft_s"}
                for line in text.splitlines()]

    leader, follower = runs["stdio"]
    got, want = events(leader), events(runs["stdio_one"])
    assert sorted(map(json.dumps, got)) == sorted(map(json.dumps, want))
    assert sum(e["event"] == "done" for e in got) == 3
    assert follower == ""


def test_leader_dispatch_failure_ends_the_follower(runs):
    leader, follower = (r["fail"] for r in runs["fail"])
    assert set(leader["status"]) <= {"cancelled", "error"}
    assert "cancelled" in leader["status"]
    assert follower["calls"] == 3
    assert follower["end_t"] - leader["failed_t"] < 30
