"""Port parity, the optimizer-state and carry dtypes: the port's AdamW with
float32 and bfloat16 moments against JAX ``adamw_fused``, the bfloat16
accumulation carry of the train step and of the 1F1B step against JAX's
``make_train_step`` / ``make_1f1b_train_step`` on bridged weights, DDP 2
and fsdp 2 over gloo against one process and JAX, and a checkpoint round
trip of bfloat16 moments, on the CPU."""

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
import pytest
import torch

from pytorch_distributed_training_tpu.comms.ingest import make_global_batch
from pytorch_distributed_training_tpu.comms.mesh import TRAIN_BATCH_PSPEC
from pytorch_distributed_training_tpu.comms.mesh import (
    build_mesh as jax_build_mesh,
)
from pytorch_distributed_training_tpu.models import (
    BertForSequenceClassification as JaxBert,
)
from pytorch_distributed_training_tpu.parallel import (
    ShardingPolicy as JaxShardingPolicy,
)
from pytorch_distributed_training_tpu.parallel import state_shardings
from pytorch_distributed_training_tpu.parallel.pipeline import (
    make_1f1b_train_step as jax_make_1f1b_train_step,
)
from pytorch_distributed_training_tpu.parallel.sharding import shard_state
from pytorch_distributed_training_tpu.train import (
    adamw_with_schedule,
    create_train_state,
)
from pytorch_distributed_training_tpu.train import (
    linear_warmup_schedule as jax_schedule,
)
from pytorch_distributed_training_tpu.train import (
    make_train_step as jax_make_train_step,
)
from pytorch_distributed_training_tpu.train.fused_adamw import adamw_fused
from pytorch_distributed_training_tpu.utils.config import (
    MeshConfig as JaxMeshConfig,
)
from pytorch_distributed_training_tpu.utils.config import (
    TrainConfig as JaxTrainConfig,
)
from pytorch_distributed_training_tpu.utils.config import (
    model_preset as jax_preset,
)
from pytorch_distributed_training_tpu_torch.comms.mesh import build_mesh
from pytorch_distributed_training_tpu_torch.models.bert import (
    BertForSequenceClassification,
)
from pytorch_distributed_training_tpu_torch.models.convert import (
    params_from_jax,
    params_to_jax,
)
from pytorch_distributed_training_tpu_torch.parallel.pipeline import (
    make_1f1b_train_step,
)
from pytorch_distributed_training_tpu_torch.train.loop import Trainer
from pytorch_distributed_training_tpu_torch.train.optim import (
    AdamW,
    linear_warmup_schedule,
    torch_dtype,
)
from pytorch_distributed_training_tpu_torch.train.state import (
    create_train_state as port_train_state,
)
from pytorch_distributed_training_tpu_torch.train.step import (
    make_train_step,
)
from pytorch_distributed_training_tpu_torch.utils.config import (
    TrainConfig,
    model_preset,
)

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NO_DROPOUT = dict(compute_dtype="float32", hidden_dropout=0.0,
                  attention_dropout=0.0)
EXAMPLE = {"input_ids": jnp.ones((2, 16), jnp.int32),
           "attention_mask": jnp.ones((2, 16), jnp.int32),
           "token_type_ids": jnp.zeros((2, 16), jnp.int32)}


def _batch(rng, lead, seq=16, vocab=1024):
    ids = rng.integers(0, vocab, (*lead, seq)).astype(np.int32)
    lens = rng.integers(seq // 2, seq + 1, lead)
    mask = (np.arange(seq) < lens[..., None]).astype(np.int32)
    types = (np.arange(seq) >= seq // 2).astype(np.int32) * mask
    labels = rng.integers(0, 2, lead).astype(np.int32)
    return {"input_ids": ids, "attention_mask": mask,
            "token_type_ids": types, "labels": labels}


def _jax_state(cfg, jcfg, total_steps, params=None):
    tx, _ = adamw_with_schedule(jcfg, total_steps)
    state = create_train_state(JaxBert(cfg), tx, jax.random.key(0), EXAMPLE)
    if params is not None:
        params = jax.tree.map(jnp.asarray, params)
        state = state.replace(params=params, opt_state=tx.init(params))
    return state


# ------------------------------------------------------------ the moments


DTYPES = ("float32", "bfloat16")


@pytest.mark.parametrize("grad_dtype", DTYPES)
@pytest.mark.parametrize("mu,nu", [(a, b) for a in DTYPES for b in DTYPES])
def test_adamw_moment_dtypes_match_jax_adamw_fused(mu, nu, grad_dtype):
    # five updates with weight decay from float32 or bfloat16 gradients:
    # the moments equal JAX's in their dtype, bit for bit, the parameters
    # to rtol 1e-6 (JAX's own bound, train/fused_adamw.py:11-16)
    rng = np.random.default_rng(3)
    tx = adamw_fused(jax_schedule(1e-2, 2, 8), weight_decay=0.01,
                     mu_dtype=mu, nu_dtype=nu)
    p0 = {"a": rng.standard_normal((3, 5)).astype(np.float32),
          "b": rng.standard_normal(7).astype(np.float32)}
    jp = jax.tree.map(jnp.asarray, p0)
    st = tx.init(jp)
    tp = [torch.nn.Parameter(torch.from_numpy(p0[k].copy()))
          for k in ("a", "b")]
    opt = AdamW(tp, linear_warmup_schedule(1e-2, 2, 8), weight_decay=0.01,
                mu_dtype=mu, nu_dtype=nu)
    gdt = torch_dtype(grad_dtype)
    for _ in range(5):
        g = {k: torch.from_numpy(
            rng.standard_normal(v.shape).astype(np.float32)).to(gdt)
            for k, v in p0.items()}
        up, st = tx.update({k: jnp.asarray(v.float().numpy()).astype(
            jnp.dtype(grad_dtype)) for k, v in g.items()}, st, jp)
        jp = optax.apply_updates(jp, up)
        opt.step(grads={p: g[k] for p, k in zip(tp, ("a", "b"))})
        for p, k in zip(tp, ("a", "b")):
            np.testing.assert_allclose(p.detach().numpy(),
                                       np.asarray(jp[k]), rtol=1e-6,
                                       atol=1e-7)
            m, n = opt.moments(p)
            assert (m.dtype, n.dtype) == (torch_dtype(mu), torch_dtype(nu))
            jm, jn = st[0].mu[k], st[0].nu[k]
            np.testing.assert_array_equal(
                m.float().numpy(), np.asarray(jm.astype(jnp.float32)), k)
            np.testing.assert_array_equal(
                n.float().numpy(), np.asarray(jn.astype(jnp.float32)), k)


def test_unknown_moment_dtype_raises_type_error():
    with pytest.raises(TypeError, match="not understood"):
        AdamW([torch.nn.Parameter(torch.zeros(2))], lambda c: 0.0,
              mu_dtype="bfloat17")


# ---------------------------------------------------------- the carry


def test_bf16_carry_steps_match_jax_make_train_step():
    # accumulation 2, dropout off, clipping on, bfloat16 carry (and
    # bfloat16 moments):
    # loss and grad norm to rtol 1e-5, as test_torch_train.py holds the
    # float32 carry; the weights after three steps to atol 3e-5: a
    # gradient element whose float32 value differs by an ulp between the
    # packages may round to the neighbouring bfloat16, which moves that
    # weight's update by up to ~1% of the learning rate (1e-5) a step
    cfg = jax_preset("tiny", **NO_DROPOUT)
    jcfg = JaxTrainConfig(learning_rate=1e-3, warmup_steps=1,
                          max_grad_norm=0.05, adam_mu_dtype="bfloat16",
                          adam_nu_dtype="bfloat16")
    state = _jax_state(cfg, jcfg, 10)
    start = params_from_jax(jax.tree.map(np.asarray, state.params))
    model = BertForSequenceClassification(model_preset("tiny", **NO_DROPOUT))
    model.load_state_dict(start)
    opt = AdamW(model.parameters(), linear_warmup_schedule(1e-3, 1, 10),
                max_grad_norm=0.05, mu_dtype="bfloat16", nu_dtype="bfloat16")
    pstate = port_train_state(model, opt, seed=0)
    jstep = jax_make_train_step(grad_accum_steps=2, accum_dtype="bfloat16")
    pstep = make_train_step(grad_accum_steps=2, accum_dtype="bfloat16")
    fstep = jax_make_train_step(grad_accum_steps=2)
    rng = np.random.default_rng(0)
    for i in range(3):
        batch = _batch(rng, (2, 4))
        jb = jax.tree.map(jnp.asarray, batch)
        if i == 0:  # the carry rounds: the float32 norm differs
            f32 = float(fstep(jax.tree.map(jnp.copy, state),
                              jb)[1]["grad_norm"])
        state, jm = jstep(state, jb)
        pm = pstep(pstate, {k: torch.from_numpy(v) for k, v in batch.items()})
        np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(pm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-5)
        if i == 0:
            assert float(jm["grad_norm"]) != f32
    want = params_from_jax(jax.tree.map(np.asarray, state.params))
    moved = 0.0
    for name, w in want.items():
        got = model.state_dict()[name]
        np.testing.assert_allclose(got.numpy(), w.numpy(), rtol=0,
                                   atol=3e-5, err_msg=name)
        moved = max(moved, float((w - start[name]).abs().max()))
    assert moved > 1e-3


def test_1f1b_bf16_carry_matches_jax_make_1f1b_train_step(eight_devices):
    # JAX's 1F1B step at (data 2, stage 4) with accum_dtype bfloat16,
    # n_micro 4, accumulation 2, dropout 0, against the port's 1F1B step
    # at world size 1 (one stage): two steps, loss to rtol 2e-5 and the
    # weights to atol 3e-5, test_torch_pipeline.py's bounds
    cfg = jax_preset("tiny", num_layers=4, scan_layers=True, **NO_DROPOUT)
    mesh = jax_build_mesh(JaxMeshConfig(data=2, stage=4))
    state = _jax_state(cfg, JaxTrainConfig(learning_rate=1e-3,
                                           warmup_steps=1), 100)
    shardings = state_shardings(state, JaxShardingPolicy(stage=True), mesh)
    state = shard_state(state, shardings)
    start = params_from_jax(jax.tree.map(np.asarray, state.params),
                            scan_layers=False)
    rng = np.random.default_rng(5)
    batch = _batch(rng, (2, 8))
    batch["attention_mask"][..., 0] = 1
    step = jax_make_1f1b_train_step(cfg, mesh, shardings, n_micro=4,
                                    grad_accum_steps=2,
                                    accum_dtype="bfloat16")
    placed = make_global_batch(mesh, batch, pspec=TRAIN_BATCH_PSPEC)
    losses = []
    for _ in range(2):
        state, metrics = step(state, placed)
        losses.append(float(metrics["loss"]))
    want = params_from_jax(jax.tree.map(np.asarray, state.params),
                           scan_layers=False)

    pcfg = model_preset("tiny", num_layers=4, **NO_DROPOUT)
    model = BertForSequenceClassification(pcfg)
    model.load_state_dict(start)
    pstate = port_train_state(
        model, AdamW(model.parameters(), linear_warmup_schedule(1e-3, 1,
                                                                100)), 0)
    pstep = make_1f1b_train_step(pcfg, build_mesh(), n_micro=4,
                                 grad_accum_steps=2, accum_dtype="bfloat16")
    pb = {k: torch.from_numpy(v.reshape(8, 2, *v.shape[2:]))
          for k, v in batch.items()}
    got_losses = [float(pstep(pstate, pb)["loss"]) for _ in range(2)]
    np.testing.assert_allclose(got_losses, losses, rtol=2e-5)
    got = model.state_dict()
    moved = 0.0
    for name, w in want.items():
        np.testing.assert_allclose(got[name].numpy(), w.numpy(), rtol=0,
                                   atol=3e-5, err_msg=name)
        moved = max(moved, float((w - start[name]).abs().max()))
    assert moved > 1e-4


# ------------------------------------------------------------ over gloo


TRAIN = dict(num_epochs=1, train_size=48, eval_size=16, global_batch_size=16,
             micro_batch_size=8, eval_batch_size=8, warmup_steps=1,
             learning_rate=1e-3, log_every=0, grad_accum_dtype="bfloat16", adam_mu_dtype="bfloat16",
             adam_nu_dtype="bfloat16")

_SCRIPT = textwrap.dedent("""
    import json, sys
    import torch
    torch.set_num_threads(1)
    from pytorch_distributed_training_tpu_torch.comms.bootstrap import shutdown
    from pytorch_distributed_training_tpu_torch.parallel import (
        ShardingPolicy)
    from pytorch_distributed_training_tpu_torch.train.loop import Trainer
    from pytorch_distributed_training_tpu_torch.train.optim import local
    from pytorch_distributed_training_tpu_torch.train.step import (
        _forward, _loss)
    from pytorch_distributed_training_tpu_torch.utils.config import (
        MeshConfig, TrainConfig, model_preset)
    out, spec = sys.argv[1], json.loads(sys.argv[2])
    t = Trainer(model_preset("tiny", compute_dtype="float32",
                             hidden_dropout=0.0, attention_dropout=0.0),
                TrainConfig(**spec["train"]), task="synthetic", device="cpu",
                mesh_config=MeshConfig(**spec["mesh"]),
                policy=ShardingPolicy(fsdp=spec["fsdp"],
                                      fsdp_min_size=128))
    init = {k: v.full_tensor() if hasattr(v, "full_tensor") else v.clone()
            for k, v in t.state.module.state_dict().items()}
    n = spec.get("shards", 1)
    if n > 1:  # one process standing for n batch shards
        from pytorch_distributed_training_tpu_torch.parallel.sharding import (
            param_specs)
        names = {p: k for k, p in t.state.module.named_parameters()}
        sharded = set()  # rounded after the average: FSDP's shards
        if spec.get("like_fsdp"):
            specs = param_specs(
                {k: p.shape for p, k in names.items()},
                ShardingPolicy(fsdp=True, fsdp_min_size=128),
                dict(data=1, fsdp=n, stage=1, model=1, seq=1))
            sharded = {p for p, k in names.items() if "fsdp" in specs[k]}

        def add(carry, p, g):
            g = g.bfloat16()
            carry[p] = g if p not in carry else carry[p] + g

        def step(state, batch, accum=2):
            params = list(state.module.parameters())
            each, whole = [{} for _ in range(n)], {}
            total = torch.zeros(())
            for m in range(accum):
                micro = {k: v[m] for k, v in batch.items()}
                rows = micro["input_ids"].shape[0] // n
                grads = []
                for r in range(n):
                    part = {k: v[r * rows:(r + 1) * rows]
                            for k, v in micro.items()}
                    state.optimizer.zero_grad(set_to_none=True)
                    loss = _loss("classification", _forward(state.model,
                                                             part), part)
                    (loss / accum).backward()
                    total = total + loss.detach() / (accum * n)
                    grads.append({p: p.grad for p in params})
                for p in params:
                    if p in sharded:
                        add(whole, p, sum(g[p] for g in grads) / n)
                    else:
                        for r in range(n):
                            add(each[r], p, grads[r][p])
            out = {p: whole[p] if p in sharded else
                   (sum(c[p].float() for c in each) / n).bfloat16()
                   for p in params}
            norm = state.optimizer.grad_norm(params,
                                             [out[p] for p in params])
            state.optimizer.step(grads=out)
            state.step += 1
            return {"loss": total, "grad_norm": norm}
        t.train_step = step
    t.run()
    sd = t.state.module.state_dict()
    full = {k: v.full_tensor() if hasattr(v, "full_tensor") else v
            for k, v in sd.items()}
    moments = [(str(m.dtype), list(m.shape), list(local(p).shape),
                list(p.shape))
               for p in t.state.module.parameters()
               for m in t.state.optimizer.moments(p)]
    rec = {"steps": t.step_log, "moments": moments,
           "sharded": [k for k, v in sd.items()
                       if hasattr(v, "full_tensor")]}
    rank = t.info.rank
    torch.save({"final": full, "init": init}, f"{out}.{rank}.pt")
    with open(f"{out}.{rank}.json", "w") as f:
        json.dump(rec, f)
    shutdown()
""")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run(tmp_path, runs: dict) -> dict:
    base = dict(os.environ, CUDA_VISIBLE_DEVICES="", MASTER_ADDR="127.0.0.1",
                GLOO_SOCKET_IFNAME="lo", PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_PORT"):
        base.pop(k, None)
    procs = []
    for name, (world, spec) in runs.items():
        port = str(_free_port())
        for r in range(world):
            env = dict(base)
            if world > 1:
                env.update(MASTER_PORT=port, WORLD_SIZE=str(world),
                           RANK=str(r), LOCAL_RANK=str(r))
            procs.append(subprocess.Popen(
                [sys.executable, "-c", _SCRIPT, str(tmp_path / name),
                 json.dumps(spec)], cwd=REPO, env=env,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    try:
        for p in procs:
            _, err = p.communicate(timeout=240)
            assert p.returncode == 0, err[-3000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return {name: dict(
        recs=[json.loads((tmp_path / f"{name}.{r}.json").read_text())
              for r in range(world)],
        weights=torch.load(str(tmp_path / f"{name}.0.pt")))
        for name, (world, _) in runs.items()}


def _jax_run(init: dict, n_steps: int = 3):
    """JAX's steps with a bfloat16 carry and bfloat16 moments on one
    device from ``init`` on the port loader's global batches: the losses
    and the final weights."""
    one = Trainer(model_preset("tiny", **NO_DROPOUT),
                  TrainConfig(**dict(TRAIN, native_loader="off",
                                     prefetch_depth=0)),
                  task="synthetic", device="cpu")
    jcfg = JaxTrainConfig(learning_rate=1e-3, warmup_steps=1,
                          adam_mu_dtype="bfloat16", adam_nu_dtype="bfloat16")
    state = _jax_state(jax_preset("tiny", **NO_DROPOUT), jcfg,
                       one.train_loader.steps_per_epoch,
                       params=params_to_jax(init))
    step = jax_make_train_step(grad_accum_steps=2, accum_dtype="bfloat16")
    losses = []
    for batch in list(one.train_loader.epoch(0))[:n_steps]:
        state, m = step(state, {k: jnp.asarray(v.numpy())
                                for k, v in batch.items()})
        losses.append(float(m["loss"]))
    return losses, params_from_jax(jax.tree.map(np.asarray, state.params))


def _close(got: dict, want: dict, atol: float) -> None:
    for s_got, s_want in zip(got["recs"][0]["steps"],
                             want["recs"][0]["steps"]):
        np.testing.assert_allclose(s_got["loss"], s_want["loss"], rtol=1e-5)
        np.testing.assert_allclose(s_got["grad_norm"], s_want["grad_norm"],
                                   rtol=1e-5)
    for name, w in want["weights"]["final"].items():
        torch.testing.assert_close(got["weights"]["final"][name], w, rtol=0,
                                   atol=atol, msg=name)


def test_bf16_carry_ddp2_and_fsdp2_equal_one_process_and_jax(tmp_path):
    # DDP over data 2 rounds each rank's microbatch gradient before the
    # once-a-step average; fsdp 2 reduce-scatters each microbatch and
    # rounds the global gradient of a sharded parameter, as JAX does, and
    # rounds a replicated one's before its average. Each against one
    # process rounding the same way on the same sums (atol 1e-6), and
    # against JAX's bfloat16 carry on one device, which rounds every
    # global gradient: losses to rtol 1e-4, 98% of the weights to atol
    # 1e-5 and all to 2e-3, one learning-rate step for each of the two
    # updates with a non-zero rate: where a gradient element nearly
    # cancels across the microbatches or the ranks, rounding it before
    # the average leaves a residue where JAX's rounding leaves zero (or
    # the reverse), and AdamW's normalization makes either a whole step.
    # Clipping is off here, since a clip factor from such a norm moves
    # the same way (the one-device test above clips)
    res = _run(tmp_path, {
        "ddp2": (2, dict(mesh=dict(data=2), fsdp=False, train=TRAIN)),
        "local": (1, dict(mesh={}, fsdp=False, train=TRAIN, shards=2)),
        "fsdp2": (2, dict(mesh=dict(data=1, fsdp=2), fsdp=True,
                          train=TRAIN)),
        "mixed": (1, dict(mesh={}, fsdp=False, train=TRAIN, shards=2,
                          like_fsdp=True)),
    })
    assert len(res["ddp2"]["recs"][0]["steps"]) == 3
    _close(res["ddp2"], res["local"], atol=1e-6)
    _close(res["fsdp2"], res["mixed"], atol=1e-6)
    for run in ("ddp2", "fsdp2"):
        recs = res[run]["recs"]
        for rec in recs:  # every rank reports the same run
            assert rec["steps"] == recs[0]["steps"]
            assert {m[0] for m in rec["moments"]} == {"torch.bfloat16"}
            assert all(m[1] == m[2] for m in rec["moments"])
    # under FSDP a sharded parameter's moments have its shard's shape
    assert res["fsdp2"]["recs"][0]["sharded"]
    assert any(m[1] != m[3] for m in res["fsdp2"]["recs"][0]["moments"])
    init = res["ddp2"]["weights"]["init"]
    losses, want = _jax_run(init)
    for run in ("ddp2", "fsdp2"):
        got = res[run]
        np.testing.assert_allclose(
            [s["loss"] for s in got["recs"][0]["steps"]], losses, rtol=1e-4)
        diff = torch.cat([(got["weights"]["final"][name] - w).abs().ravel()
                          for name, w in want.items()])
        assert float(diff.max()) <= 2e-3, (run, float(diff.max()))
        assert float((diff > 1e-5).float().mean()) <= 0.02, run


# ------------------------------------------------------------ checkpoints


def test_bf16_moments_checkpoint_round_trip_bit_for_bit(tmp_path):
    kw = dict(TRAIN, num_epochs=1, train_size=32,
              checkpoint_dir=str(tmp_path / "ck"))
    cfg = model_preset("tiny", **NO_DROPOUT)
    t = Trainer(cfg, TrainConfig(**kw), task="synthetic", device="cpu")
    t.run()
    r = Trainer(cfg, TrainConfig(**dict(kw, resume=True)), task="synthetic",
                device="cpu")
    assert r.state.step == t.state.step == 2
    assert r.state.optimizer.count == 2
    for p, q in zip(t.state.module.parameters(), r.state.module.parameters()):
        for a, b in zip(t.state.optimizer.moments(p),
                        r.state.optimizer.moments(q)):
            assert a.dtype == b.dtype == torch.bfloat16
            assert torch.equal(a, b)
            assert a.abs().sum() > 0


def test_narrow_update_in_chunks_equals_one_chunk(monkeypatch):
    # every update runs in chunks of CHUNK elements (float32 temporaries
    # a chunk at a time): the moments and weights equal one chunk's, bit
    # for bit, with clipping on, for narrow, mixed and float32 moments
    # and gradients
    from pytorch_distributed_training_tpu_torch.train import optim

    shapes = [(3, 5), (7,), (2, 2), (11,)]
    whole = optim.CHUNK
    for mu, nu, gdt in (("bfloat16", "bfloat16", torch.bfloat16),
                        ("bfloat16", "float32", torch.float32),
                        ("float32", "float32", torch.float32)):
        out = {}
        for chunk in (whole, 7):
            monkeypatch.setattr(optim, "CHUNK", chunk)
            ps = [torch.nn.Parameter(torch.from_numpy(
                np.random.default_rng(1).standard_normal(s).astype(
                    np.float32))) for s in shapes]
            opt = AdamW(ps, linear_warmup_schedule(1e-2, 1, 8),
                        weight_decay=0.01, max_grad_norm=0.5,
                        mu_dtype=mu, nu_dtype=nu)
            rng = np.random.default_rng(4)
            for _ in range(3):
                opt.step(grads={p: torch.from_numpy(rng.standard_normal(
                    p.shape).astype(np.float32)).to(gdt) for p in ps})
            out[chunk] = [t.clone() for p in ps
                          for t in (p, *opt.moments(p))]
        for a, b in zip(*out.values()):
            assert torch.equal(a, b), (mu, nu, gdt)
    assert [len(c) for c in optim._chunks(ps, 7)] == [1, 1, 1, 1]
    assert [len(c) for c in optim._chunks(ps, 100)] == [4]
