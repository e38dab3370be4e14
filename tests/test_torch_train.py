"""Port parity, training: the PyTorch package's BERT data-parallel
fine-tuning path (data, optimizer, train and eval steps, metrics, the
Trainer and ``cli/train_dp``) against the JAX package on the same numpy
inputs and bridged weights, on the CPU (every kernel through its plain
version), and two gloo processes against one."""

import json
import os
import socket
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from pytorch_distributed_training_tpu.comms.mesh import build_mesh
from pytorch_distributed_training_tpu.data import synthetic as jax_synthetic
from pytorch_distributed_training_tpu.data.glue import (
    load_task_arrays as jax_load_task_arrays,
)
from pytorch_distributed_training_tpu.data.pipeline import (
    ShardedLoader as JaxShardedLoader,
)
from pytorch_distributed_training_tpu.models.bert import (
    BertForSequenceClassification as JaxBert,
)
from pytorch_distributed_training_tpu.train import (
    MetricAccumulator as JaxMetricAccumulator,
)
from pytorch_distributed_training_tpu.train import (
    adamw_with_schedule,
    create_train_state,
)
from pytorch_distributed_training_tpu.train import (
    linear_warmup_schedule as jax_schedule,
)
from pytorch_distributed_training_tpu.train import (
    make_eval_step as jax_make_eval_step,
)
from pytorch_distributed_training_tpu.train import (
    make_train_step as jax_make_train_step,
)
from pytorch_distributed_training_tpu.utils.config import MeshConfig
from pytorch_distributed_training_tpu.utils.config import (
    TrainConfig as JaxTrainConfig,
)
from pytorch_distributed_training_tpu.utils.config import (
    model_preset as jax_preset,
)
from pytorch_distributed_training_tpu_torch.cli import train_dp
from pytorch_distributed_training_tpu_torch.data import synthetic
from pytorch_distributed_training_tpu_torch.data.glue import load_task_arrays
from pytorch_distributed_training_tpu_torch.data.pipeline import ShardedLoader
from pytorch_distributed_training_tpu_torch.models.bert import (
    BertForSequenceClassification,
)
from pytorch_distributed_training_tpu_torch.models.convert import (
    params_from_jax,
)
from pytorch_distributed_training_tpu_torch.train.metrics import (
    MetricAccumulator,
)
from pytorch_distributed_training_tpu_torch.train.optim import (
    AdamW,
    linear_warmup_schedule,
)
from pytorch_distributed_training_tpu_torch.train.state import (
    create_train_state as port_train_state,
)
from pytorch_distributed_training_tpu_torch.train.step import (
    make_eval_step,
    make_train_step,
)
from pytorch_distributed_training_tpu_torch.utils.config import model_preset

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NO_DROPOUT = dict(compute_dtype="float32", hidden_dropout=0.0,
                  attention_dropout=0.0)


def _batch(rng, lead, seq=16, vocab=1024):
    """Classification rows of shape ``lead + (seq,)`` with padded tails."""
    ids = rng.integers(0, vocab, (*lead, seq)).astype(np.int32)
    lens = rng.integers(seq // 2, seq + 1, lead)
    mask = (np.arange(seq) < lens[..., None]).astype(np.int32)
    types = (np.arange(seq) >= seq // 2).astype(np.int32) * mask
    labels = rng.integers(0, 2, lead).astype(np.int32)
    return {"input_ids": ids, "attention_mask": mask,
            "token_type_ids": types, "labels": labels}


def _jax_state(tcfg, total_steps):
    model = JaxBert(jax_preset("tiny", **NO_DROPOUT))
    tx, _ = adamw_with_schedule(tcfg, total_steps)
    example = {"input_ids": jnp.ones((2, 16), jnp.int32),
               "attention_mask": jnp.ones((2, 16), jnp.int32),
               "token_type_ids": jnp.zeros((2, 16), jnp.int32)}
    return create_train_state(model, tx, jax.random.key(0), example)


def _port_model(params):
    model = BertForSequenceClassification(model_preset("tiny", **NO_DROPOUT))
    model.load_state_dict(params_from_jax(params))
    return model


# -------------------------------------------------------------- train step


def test_three_train_steps_match_jax_make_train_step():
    # (i) accumulation 2, dropout off, fp32. warmup_steps=1 so updates 2
    # and 3 have a non-zero learning rate (update 1's is 0); lr 1e-3
    # rather than the recipe's 2e-5 so the parameters move well past the
    # tolerance.
    jcfg = JaxTrainConfig(learning_rate=1e-3, warmup_steps=1)
    state = _jax_state(jcfg, total_steps=10)
    start = params_from_jax(jax.tree.map(np.asarray, state.params))
    model = _port_model(jax.tree.map(np.asarray, state.params))
    opt = AdamW(model.parameters(), linear_warmup_schedule(1e-3, 1, 10))
    pstate = port_train_state(model, opt, seed=0)
    jstep = jax_make_train_step(grad_accum_steps=2)
    pstep = make_train_step(grad_accum_steps=2)
    rng = np.random.default_rng(0)
    for _ in range(3):
        batch = _batch(rng, (2, 4))
        state, jm = jstep(state, jax.tree.map(jnp.asarray, batch))
        pm = pstep(pstate, {k: torch.from_numpy(v) for k, v in batch.items()})
        np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(pm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-5)
    assert pstate.step == int(state.step) == 3
    want = params_from_jax(jax.tree.map(np.asarray, state.params))
    got = model.state_dict()
    moved = 0.0
    for name, w in want.items():
        np.testing.assert_allclose(got[name].numpy(), w.numpy(), rtol=0,
                                   atol=1e-5, err_msg=name)
        moved = max(moved, float((w - start[name]).abs().max()))
    assert moved > 1e-3  # the comparison is not of unmoved weights


def test_schedule_and_adamw_match_optax_chain():
    # (j) the warmup + linear decay values, then five AdamW updates with
    # weight decay and with global-norm clipping against the JAX chain
    port, ref = linear_warmup_schedule(2e-5, 100, 1000), jax_schedule(
        2e-5, 100, 1000)
    for k in (0, 1, 50, 99, 100, 101, 550, 999, 1000, 1200):
        np.testing.assert_allclose(port(k), float(ref(k)), rtol=1e-6,
                                   atol=1e-12)
    assert port(0) == 0.0
    rng = np.random.default_rng(1)
    for extra in (dict(weight_decay=0.01), dict(max_grad_norm=0.5)):
        jcfg = JaxTrainConfig(learning_rate=1e-2, warmup_steps=2, **extra)
        tx, _ = adamw_with_schedule(jcfg, 8)
        p0 = {"a": rng.standard_normal((3, 5)).astype(np.float32),
              "b": rng.standard_normal(7).astype(np.float32)}
        jp = jax.tree.map(jnp.asarray, p0)
        st = tx.init(jp)
        tp = [torch.nn.Parameter(torch.from_numpy(p0[k].copy()))
              for k in ("a", "b")]
        opt = AdamW(tp, linear_warmup_schedule(1e-2, 2, 8),
                    weight_decay=extra.get("weight_decay", 0.0),
                    max_grad_norm=extra.get("max_grad_norm", 0.0))
        for _ in range(5):
            g = {k: rng.standard_normal(v.shape).astype(np.float32)
                 for k, v in p0.items()}
            up, st = tx.update(jax.tree.map(jnp.asarray, g), st, jp)
            jp = optax.apply_updates(jp, up)
            for p, k in zip(tp, ("a", "b")):
                p.grad = torch.from_numpy(g[k])
            opt.step()
            for p, k in zip(tp, ("a", "b")):
                np.testing.assert_allclose(p.detach().numpy(),
                                           np.asarray(jp[k]), rtol=1e-6,
                                           atol=1e-7)


# ------------------------------------------------------- data and metrics


def test_synthetic_task_and_loader_order_match_jax():
    # (k) the same arrays, the same train batch order (one rank, and two
    # ranks side by side), the same eval padding and valid mask
    for kw in (dict(seed=42), dict(seed=7, num_labels=3)):
        a = synthetic.synthetic_pair_task(50, vocab_size=1024, **kw)
        b = jax_synthetic.synthetic_pair_task(50, vocab_size=1024, **kw)
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    sizes = (100, 40)
    for split in ("train", "validation"):
        a, na = load_task_arrays("synthetic", split, max_length=32,
                                 vocab_size=1024, synthetic_sizes=sizes)
        b, nb = jax_load_task_arrays("synthetic", split, max_length=32,
                                     vocab_size=1024, synthetic_sizes=sizes)
        assert na == nb == 2
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    train, _ = load_task_arrays("synthetic", "train", max_length=32,
                                vocab_size=1024, synthetic_sizes=sizes)
    evald, _ = load_task_arrays("synthetic", "validation", max_length=32,
                                vocab_size=1024, synthetic_sizes=sizes)
    mesh = build_mesh(MeshConfig())
    for train_mode, data, gb in ((True, train, 32), (False, evald, 16)):
        kw = dict(global_batch_size=gb, grad_accum_steps=2, train=train_mode,
                  seed=42)
        ref = JaxShardedLoader(data, mesh, **kw)
        one = ShardedLoader(data, **kw)
        two = [ShardedLoader(data, rank=r, world_size=2, **kw)
               for r in range(2)]
        assert one.steps_per_epoch == ref.steps_per_epoch
        for epoch in (0, 1):
            rows = zip(ref.epoch(epoch), one.epoch(epoch),
                       *(t.epoch(epoch) for t in two))
            for want, got, r0, r1 in rows:
                assert want.keys() == got.keys()
                for k in want:
                    w = np.asarray(want[k])
                    np.testing.assert_array_equal(got[k].numpy(), w)
                    axis = 1 if train_mode else 0
                    np.testing.assert_array_equal(
                        np.concatenate([r0[k].numpy(), r1[k].numpy()],
                                       axis), w)
    last = list(ShardedLoader(evald, global_batch_size=16,
                              train=False).epoch())[-1]
    assert last["valid"].tolist() == [1] * 8 + [0] * 8
    assert torch.equal(last["input_ids"][8:],
                       torch.from_numpy(evald["input_ids"][-1:]).expand(8, -1))


def test_eval_counts_and_metrics_match_jax():
    # (l) masked counts of one padded eval batch on bridged weights, then
    # the accumulators on the same counts
    state = _jax_state(JaxTrainConfig(), total_steps=10)
    model = _port_model(jax.tree.map(np.asarray, state.params))
    pstate = port_train_state(model, AdamW(model.parameters(), lambda k: 0.0),
                              seed=0)
    batch = _batch(np.random.default_rng(3), (16,))
    batch["valid"] = (np.arange(16) < 11).astype(np.int32)
    want = jax_make_eval_step()(state, jax.tree.map(jnp.asarray, batch))
    got = make_eval_step()(pstate, {k: torch.from_numpy(v)
                                    for k, v in batch.items()})
    assert want.keys() == got.keys()
    for k in want:
        assert float(got[k]) == float(want[k]), k
    assert float(got["total"]) == 11.0
    for counts in ({k: float(v) for k, v in want.items()},
                   dict(correct=3.0, total=8.0, tp=0.0, fp=0.0, fn=0.0)):
        a, b = MetricAccumulator(2), JaxMetricAccumulator(2)
        a.update(counts)
        b.update(counts)
        assert a.compute() == b.compute()


# ---------------------------------------------------------- entry points


def test_train_dp_cli_runs_an_epoch_with_the_jax_history_keys(tmp_path):
    # (m) the JAX trainer's record keys, from its own artifact
    with open(os.path.join(REPO, "HISTORY_bert_large_recipe_seed42.json")) as f:
        jax_keys = list(json.load(f)[0])
    out = tmp_path / "history.json"
    history = train_dp.main([
        "--model", "tiny", "--task", "synthetic", "--device", "cpu",
        "--train-size", "64", "--eval-size", "40", "--global-batch-size",
        "16", "--micro-batch-size", "8", "--eval-batch-size", "16",
        "--num-epochs", "1", "--log-every", "2",
        "--history-out", str(out),
    ])
    assert len(history) == 1 and list(history[0]) == jax_keys
    rec = history[0]
    assert np.isfinite(rec["train_loss"]) and rec["samples_per_sec"] > 0
    assert 0.0 <= rec["accuracy"] <= 1.0 and 0.0 <= rec["f1"] <= 1.0
    assert json.loads(out.read_text()) == history


_DP_SCRIPT = textwrap.dedent("""
    import json, sys
    import torch
    torch.set_num_threads(1)
    from pytorch_distributed_training_tpu_torch.comms.bootstrap import shutdown
    from pytorch_distributed_training_tpu_torch.train.loop import Trainer
    from pytorch_distributed_training_tpu_torch.utils.config import (
        TrainConfig, model_preset)
    t = Trainer(
        model_preset("tiny", compute_dtype="float32", hidden_dropout=0.0,
                     attention_dropout=0.0),
        TrainConfig(num_epochs=1, train_size=32, eval_size=24,
                    global_batch_size=16, micro_batch_size=8,
                    eval_batch_size=8, warmup_steps=1, learning_rate=1e-3,
                    log_every=0),
        task="synthetic", device="cpu")
    t.run()
    if t.info.rank == 0:
        torch.save(t.state.module.state_dict(), sys.argv[1] + ".pt")
        with open(sys.argv[1], "w") as f:
            json.dump({"steps": t.step_log, "history": t.history,
                       "world": t.info.world_size}, f)
    shutdown()
""")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_gloo_processes_equal_one(tmp_path):
    # (n) dropout off, 2 optimizer steps of accumulation 2: 2 ranks x 4
    # rows per microbatch against 1 x 8, DDP averaging the gradients
    base = dict(os.environ, CUDA_VISIBLE_DEVICES="", MASTER_ADDR="127.0.0.1",
                GLOO_SOCKET_IFNAME="lo", PYTHONPATH=REPO)
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        base.pop(k, None)
    port = str(_free_port())
    runs = {"one": [dict(base)]}
    runs["two"] = [dict(base, MASTER_PORT=port, WORLD_SIZE="2", RANK=str(r),
                        LOCAL_RANK=str(r)) for r in range(2)]
    procs = []
    for name, envs in runs.items():
        for env in envs:
            procs.append(subprocess.Popen(
                [sys.executable, "-c", _DP_SCRIPT, str(tmp_path / name)],
                cwd=REPO, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True,
            ))
    try:
        for p in procs:
            _, err = p.communicate(timeout=180)
            assert p.returncode == 0, err[-3000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    one = json.loads((tmp_path / "one").read_text())
    two = json.loads((tmp_path / "two").read_text())
    assert (one["world"], two["world"]) == (1, 2)
    assert len(one["steps"]) == len(two["steps"]) == 2
    for a, b in zip(one["steps"], two["steps"]):
        np.testing.assert_allclose(b["loss"], a["loss"], rtol=1e-5)
        np.testing.assert_allclose(b["grad_norm"], a["grad_norm"], rtol=1e-5)
    for k in ("accuracy", "f1"):
        assert one["history"][0][k] == two["history"][0][k]
    p1 = torch.load(str(tmp_path / "one") + ".pt")
    p2 = torch.load(str(tmp_path / "two") + ".pt")
    for name in p1:
        torch.testing.assert_close(p2[name], p1[name], rtol=0, atol=1e-6)
