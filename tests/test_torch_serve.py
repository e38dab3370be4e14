"""Port parity, serving: the PyTorch package's paged decode engine, stdio
front-end and their parts against the JAX package on the same bridged
weights and prompts, on the CPU (``--device cpu``, every kernel through its
plain version). Also: the port imports neither JAX nor the JAX package, and
its GPU entry point refuses to run without a GPU."""

import io
import json
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_training_tpu.data.bpe import (
    ByteLevelBPETokenizer as JaxBPE,
)
from pytorch_distributed_training_tpu.data.bpe import (
    ByteTokenizer as JaxByteTokenizer,
)
from pytorch_distributed_training_tpu.models.gpt2 import GPT2LMModel as JaxGPT2
from pytorch_distributed_training_tpu.serve import (
    EngineConfig as JaxEngineConfig,
)
from pytorch_distributed_training_tpu.serve import (
    InferenceServer as JaxServer,
)
from pytorch_distributed_training_tpu.serve import serve_stdio as jax_stdio
from pytorch_distributed_training_tpu.serve.paged_cache import (
    PageAllocator as JaxPageAllocator,
)
from pytorch_distributed_training_tpu.serve.server import wait_until
from pytorch_distributed_training_tpu.utils.config import (
    model_preset as jax_preset,
)
from pytorch_distributed_training_tpu_torch.data.bpe import (
    ByteLevelBPETokenizer,
    ByteTokenizer,
)
from pytorch_distributed_training_tpu_torch.models.convert import (
    params_from_jax,
)
from pytorch_distributed_training_tpu_torch.models.gpt2 import GPT2LMModel
from pytorch_distributed_training_tpu_torch.serve import (
    BackpressureError,
    EngineConfig,
    GenRequest,
    InferenceServer,
    RequestQueue,
    serve_stdio,
)
from pytorch_distributed_training_tpu_torch.serve.paged_cache import (
    PageAllocator,
)
from pytorch_distributed_training_tpu_torch.serve.sampling import device_sample
from pytorch_distributed_training_tpu_torch.utils.config import model_preset

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T = 5
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


def _run(server, prompts, **kw):
    server.start()
    try:
        reqs = [server.submit(p, max_new_tokens=T, **kw) for p in prompts]
        assert wait_until(lambda: all(r.done.is_set() for r in reqs),
                          timeout=120)
    finally:
        server.close()
    return reqs


def _port_server(model, num_slots=2, queue_depth=8, **kw):
    return InferenceServer(
        model, EngineConfig(num_slots=num_slots, prompt_buckets=BUCKETS,
                            max_new_tokens=T, **kw),
        device="cpu", queue_depth=queue_depth,
    )


def _jax_server(jlm, num_slots=2, queue_depth=8):
    jmodel, params = jlm
    return JaxServer(
        jmodel, params,
        JaxEngineConfig(num_slots=num_slots, prompt_buckets=BUCKETS,
                        max_new_tokens=T),
        queue_depth=queue_depth,
    )


# ------------------------------------------------------ slice end to end


def test_engine_greedy_streams_identical_to_jax_engine(lms):
    """Five ragged prompts through 2 slots (every slot evicted and reused,
    prompts padded to their bucket): the port's greedy token ids equal the
    JAX engine's on the same bridged fp32 weights."""
    jlm, model = lms
    lengths = [3, 5, 9, 14, 6]
    prompts = _prompts(lengths)
    want = _run(_jax_server(jlm), prompts)
    server = _port_server(model)
    got = _run(server, prompts)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.status == "done" and g.finish_reason == "length"
        assert w.status == "done"
        assert g.tokens == w.tokens, f"request {i} (len {lengths[i]})"
    stats = server.stats()
    assert stats["admitted"] == 5 and stats["finished"] == 5
    assert stats["prefill_buckets_used"] == [4, 8, 16]
    assert stats["kv_pages_used"] == 0 and stats["slot_occupancy"] == 0.0
    assert stats["decode_tokens"] == 5 * (T - 1)
    assert stats["device"] == "cpu"


def test_stdio_event_sequence_matches_jax(lms):
    """Both stdio front-ends answer the same JSONL with the same events:
    per request T ``token`` events, then ``done`` with ``new_tokens``."""
    jlm, model = lms
    lines = [
        json.dumps({"id": f"q{i}", "prompt": p, "max_new_tokens": T})
        for i, p in enumerate(["hi", "hello there", "abcdefghijk", "xyz"])
    ]
    lines.insert(2, "not json")
    text = "\n".join(lines) + "\n"

    def events(server, stdio, tok):
        out = io.StringIO()
        server.start()
        try:
            stdio(server, tok, io.StringIO(text), out)
        finally:
            server.close()
        return [json.loads(l) for l in out.getvalue().splitlines()]

    want = events(_jax_server(jlm), jax_stdio, JaxByteTokenizer())
    got = events(_port_server(model), serve_stdio, ByteTokenizer())

    def shape(evs):
        per = {}
        for e in evs:
            per.setdefault(e.get("id"), []).append(
                (e["event"], e.get("token_id"), e.get("new_tokens"),
                 e.get("status"))
            )
        return per

    assert shape(got) == shape(want)
    for i in range(4):
        seq = shape(got)[f"q{i}"]
        assert [s[0] for s in seq] == ["token"] * T + ["done"]
        assert seq[-1][2] == T and seq[-1][3] == "done"
    assert shape(got)[None] == [("error", None, None, None)]


def test_engine_eot_and_backpressure(lms):
    _, model = lms
    prompt = _prompts([5], seed=2)
    probe = _run(_port_server(model, num_slots=1), prompt)[0]
    eot = probe.tokens[0]
    req = _run(_port_server(model, num_slots=1), prompt, eot_id=eot)[0]
    assert req.finish_reason == "eot" and req.tokens == [eot]
    # an unstarted server's queue fills and then refuses, never hangs
    server = _port_server(model, queue_depth=2)
    for p in _prompts([3, 3]):
        server.submit(p, max_new_tokens=T)
    with pytest.raises(BackpressureError):
        server.submit(prompt[0], max_new_tokens=T)
    server.close(drain=False)


@pytest.mark.parametrize("option,value", [
    ("kv_layout", "dense"), ("sampling", "host"), ("spec_k", 2),
    ("prefill_chunk", 8), ("prefix_cache", True), ("tp", 2),
    ("kv_dtype", "int8"),
])
def test_engine_config_unported_options_raise(option, value):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        EngineConfig(**{option: value})


# --------------------------------------------------------------- the parts


def test_page_allocator_matches_jax_allocator():
    """The same admit/release sequence leaves both allocators with the same
    block tables and counts (null page 0, LIFO reuse)."""
    args = (12, 4, 3, 3)
    port, ref = PageAllocator(*args), JaxPageAllocator(*args)
    ops = [("admit", 0, 3), ("admit", 1, 2), ("release", 0, 0),
           ("admit", 2, 3), ("admit", 0, 1), ("release", 1, 0),
           ("admit", 1, 3)]
    for op, slot, n in ops:
        for a in (port, ref):
            a.admit(slot, n) if op == "admit" else a.release(slot)
        np.testing.assert_array_equal(port.block_table, ref.block_table)
        assert port.pages_free == ref.pages_free
        assert port.pages_used == ref.pages_used
        assert port.slot_pages(slot) == ref.slot_pages(slot)
    for tokens in (1, 4, 5, 11):
        assert port.pages_needed(tokens) == ref.pages_needed(tokens)
        assert port.pages_reserved(tokens) == ref.pages_reserved(tokens)
    assert 0 not in {p for s in range(3) for p in port.slot_pages(s)}


def test_device_sample_greedy_first_max_and_top_k_ties():
    logits = torch.tensor([[1.0, 3.0, 3.0, 0.0],
                           [2.0, 2.0, 1.0, 2.0],
                           [0.0, 5.0, 5.0, 1.0]])
    out = device_sample(logits, [0, 0, 0], [1, 1, 1], [0.0, 0.0, 0.0],
                        [0, 0, 0])
    assert out.tolist() == [1, 0, 1]   # the first maximum, as jnp.argmax
    # top_k=1 keeps the tied maxima only; a draw lands on one of them
    seen = set()
    for seed in range(16):
        tok = device_sample(logits[2:], [seed], [3], [1.0], [1])
        seen.add(int(tok[0]))
    assert seen <= {1, 2} and len(seen) == 2
    # a fixed (seed, step) is reproducible; the step moves the stream
    a = [int(device_sample(logits[:1], [7], [s], [2.0], [0])[0])
         for s in range(20)]
    b = [int(device_sample(logits[:1], [7], [s], [2.0], [0])[0])
         for s in range(20)]
    assert a == b and len(set(a)) > 1


def test_request_queue_buckets_fifo_and_validation():
    q = RequestQueue(max_depth=4, prompt_buckets=(4, 8), max_new_tokens=5)
    reqs = [
        q.submit(GenRequest(id=str(i), prompt_ids=np.ones(n, np.int32),
                            max_new_tokens=2))
        for i, n in enumerate([6, 2, 7])
    ]
    assert [r.bucket for r in reqs] == [8, 4, 8]
    assert [q.pop_ready().id for _ in range(3)] == ["0", "1", "2"]
    assert q.pop_ready() is None
    with pytest.raises(ValueError, match="largest bucket"):
        q.submit(GenRequest(id="x", prompt_ids=np.ones(9, np.int32),
                            max_new_tokens=2))
    with pytest.raises(ValueError, match="max_new_tokens"):
        q.submit(GenRequest(id="y", prompt_ids=np.ones(3, np.int32),
                            max_new_tokens=6))
    late = q.submit(GenRequest(id="z", prompt_ids=np.ones(3, np.int32),
                               max_new_tokens=2, deadline_s=0.0))
    assert q.expire_overdue(now=late.submit_t + 1.0) == [late]


def test_bpe_tokenizer_matches_jax(tmp_path):
    enc = {c: i for i, c in enumerate("abcdĠ")}
    enc.update({"ab": 5, "Ġa": 6, "abc": 7, "<|endoftext|>": 8})
    (tmp_path / "encoder.json").write_text(json.dumps(enc))
    (tmp_path / "merges.txt").write_text("#version: 0.2\na b\nĠ a\nab c\n")
    paths = (str(tmp_path / "encoder.json"), str(tmp_path / "merges.txt"))
    port, ref = ByteLevelBPETokenizer(*paths), JaxBPE(*paths)
    for text in ["abc", "abcd abc", "dcba a", "a b c d"]:
        assert port.text_ids(text) == ref.text_ids(text), text
        assert port.decode(port.text_ids(text)) == text
    assert port.eot_id == ref.eot_id == 8
    assert port.vocab_size == ref.vocab_size
    b = ByteTokenizer()
    assert b.text_ids("hé") == JaxByteTokenizer().text_ids("hé")


# ------------------------------------------------------- package boundary


def test_port_imports_no_jax_and_cuda_entry_point_refuses_without_gpu():
    """Every port module imports with JAX, flax, optax and the JAX package
    blocked, and ``serve_lm --device cuda`` and ``train_dp --device cuda``
    raise on a machine without a GPU instead of carrying on on the CPU."""
    script = textwrap.dedent("""
        import importlib, pkgutil, sys
        for name in ("jax", "flax", "optax",
                     "pytorch_distributed_training_tpu"):
            sys.modules[name] = None
        import pytorch_distributed_training_tpu_torch as pkg
        mods = [m.name for m in pkgutil.walk_packages(pkg.__path__,
                                                       pkg.__name__ + ".")]
        for m in mods:
            importlib.import_module(m)
        for m in ("train.loop", "train.step", "cli.train_dp",
                  "comms.bootstrap", "data.pipeline", "ops.dropout"):
            assert pkg.__name__ + "." + m in mods, m
        import torch
        assert not torch.cuda.is_available()
        from pytorch_distributed_training_tpu_torch.cli import (
            serve_lm, train_dp)
        for main, argv in ((serve_lm.main, ["--model", "gpt2-tiny"]),
                           (train_dp.main, ["--model", "tiny", "--task",
                                            "synthetic"])):
            try:
                main(argv + ["--device", "cuda"])
            except RuntimeError as e:
                assert "cuda" in str(e), e
            else:
                raise SystemExit(f"{main.__module__} --device cuda ran "
                                 f"without a GPU")
        print("REFUSED", len(mods))
    """)
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, "-c", script], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    refused, count = proc.stdout.split()[-2:]
    assert refused == "REFUSED" and int(count) >= 35
