"""Port parity, hybrid parallel training: the PyTorch package's process mesh
(``comms/mesh.py``) against the JAX package's ``MeshConfig``, ``cli/
train_mp`` (its errors, the int8 and seq flags, and its modes at world
1), and runs over several gloo processes (branch and stage splits, data ×
model) against one process, on the CPU. ``tests/test_torch_pipeline.py``
runs the pipeline schedules on the same harness (``_MP_SCRIPT``,
``_run``)."""

import json
import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch
import torch.distributed as dist

from pytorch_distributed_training_tpu.utils.config import (
    MeshConfig as JaxMeshConfig,
)
from pytorch_distributed_training_tpu_torch.cli import train_dp, train_mp
from pytorch_distributed_training_tpu_torch.comms.mesh import (
    AXIS_NAMES,
    axis_size,
    build_mesh,
    dp_degree,
)
from pytorch_distributed_training_tpu_torch.train.loop import Trainer
from pytorch_distributed_training_tpu_torch.utils.config import (
    MeshConfig,
    TrainConfig,
    model_preset,
)

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["--model", "tiny", "--task", "synthetic", "--device", "cpu",
        "--train-size", "32", "--eval-size", "24", "--global-batch-size",
        "16", "--micro-batch-size", "8", "--eval-batch-size", "8",
        "--num-epochs", "1", "--log-every", "0", "--no-bf16",
        "--warmup-steps", "1", "--learning-rate", "1e-3"]


# --------------------------------------------------------------- the mesh


MESHES = [
    (dict(), 1), (dict(), 4), (dict(data=2, model=2), 4),
    (dict(model=4), 4), (dict(data=-1, stage=2), 4),
    (dict(data=2, stage=2, model=2), 8), (dict(data=3, model=-1), 12),
    (dict(data=1, stage=2, model=3), 6),
]


@pytest.mark.parametrize("kw,world", MESHES)
def test_mesh_coords_and_groups_match_jax_meshconfig(kw, world):
    # each rank in turn on torch's fake backend (no other process): the
    # shape is JAX MeshConfig.resolved_shape's, the coordinates row-major
    # as the JAX mesh's reshape of the device list, and each axis's group
    # the ranks that differ from this one on that axis only
    from torch.testing._internal.distributed.fake_pg import FakeStore

    shape = JaxMeshConfig(**kw).resolved_shape(world)
    grid = np.arange(world).reshape(shape)
    for rank in range(world):
        if world > 1:
            dist.init_process_group("fake", store=FakeStore(), rank=rank,
                                    world_size=world)
        try:
            mesh = build_mesh(MeshConfig(**kw), rank=rank, world_size=world)
            assert tuple(mesh.shape[a] for a in AXIS_NAMES) == shape
            coords = tuple(int(c) for c in np.unravel_index(rank, shape))
            assert tuple(mesh.coord(a) for a in AXIS_NAMES) == coords
            assert mesh.rank_at() == rank
            for i, axis in enumerate(AXIS_NAMES):
                line = grid[coords[:i] + (slice(None),) + coords[i + 1:]]
                group = mesh.group(axis)
                if shape[i] == 1:
                    assert group is None
                else:
                    assert dist.get_process_group_ranks(group) == list(line)
            assert dp_degree(mesh) == shape[0] * shape[1]
            assert axis_size(mesh, "stage", "model") == shape[2] * shape[3]
        finally:
            if dist.is_initialized():
                dist.destroy_process_group()


@pytest.mark.parametrize("kw,world", [
    (dict(data=-1, model=-1), 4), (dict(data=3, model=-1), 4),
    (dict(data=2, model=2), 8), (dict(model=0), 1),
])
def test_mesh_errors_match_jax_meshconfig(kw, world):
    with pytest.raises(ValueError) as want:
        JaxMeshConfig(**kw).resolved_shape(world)
    with pytest.raises(ValueError) as got:
        build_mesh(MeshConfig(**kw), world_size=world)
    assert str(got.value) == str(want.value)


# ------------------------------------------------------------- the CLI


@pytest.mark.parametrize("flags,item", [
    (["--mesh-seq", "2"], "item 4b"),
    (["--matmul-impl", "int8"], "item 6"),
    (["--matmul-impl", "int8_full"], "item 6"),
    (["--quant-delayed"], "item 6"),
])
def test_train_mp_flags_not_ported_raise(flags, item):
    # the flags of slice 5 items 4b and 6 are ported: none raises
    # NotImplementedError; at world 1 a seq axis of 2 is JAX's mesh
    # ValueError, --quant-delayed alone JAX's SystemExit, int8 runs
    if item == "item 4b":
        with pytest.raises(ValueError, match="not divisible by fixed axes"):
            train_mp.train(TINY + flags)
    elif flags == ["--quant-delayed"]:
        with pytest.raises(SystemExit, match="requires --matmul-impl"):
            train_mp.train(TINY + flags)
    else:
        t = train_mp.train(TINY + flags + ["--train-size", "16"])
        assert t.mcfg.matmul_impl == flags[1]
        assert all(np.isfinite(s["loss"]) for s in t.step_log)


@pytest.mark.parametrize("flags,error,match", [
    (["--n-branches", "3", "--mesh-model", "2"], SystemExit, None),
    (["--mp-mode", "stage", "--mesh-stage", "4"], SystemExit, None),
    (["--n-branches", "2", "--mesh-data", "1", "--mesh-model", "2"],
     ValueError, "available devices 1"),
    (["--model", "gpt2-tiny"], SystemExit, None),
])
def test_train_mp_errors(flags, error, match):
    with pytest.raises(error, match=match):
        train_mp.train(TINY + flags)


def test_train_mp_raises_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: the default device runs")
    argv = [a for a in TINY if a not in ("--device", "cpu")]
    with pytest.raises(RuntimeError, match="cuda"):
        train_mp.train(argv)


@pytest.mark.parametrize("preset,mode,match", [
    ("tiny", "tensor", "mp_mode must be one of"),
    ("gpt2-tiny", "branch", "encoder classifier"),
])
def test_trainer_rejects_what_no_mode_splits(preset, mode, match):
    with pytest.raises(ValueError, match=match):
        Trainer(model_preset(preset), TrainConfig(), task="synthetic",
                device="cpu", mp_mode=mode)


def test_train_mp_cli_runs_branch_mode_with_the_jax_history_keys(tmp_path):
    with open(os.path.join(REPO, "HISTORY_bert_large_recipe_seed42.json")) as f:
        jax_keys = list(json.load(f)[0])
    out = tmp_path / "history.json"
    trainer = train_mp.train(TINY + ["--history-out", str(out)])
    history = trainer.history
    assert len(history) == 1 and list(history[0]) == jax_keys
    assert json.loads(out.read_text()) == history
    module = trainer.state.module
    assert type(module).__name__ == "BranchEnsembleClassifier"
    assert sorted(module.branches) == ["0", "1", "2"]
    assert len(trainer.step_log) == 2 and all(
        np.isfinite([s["loss"], s["grad_norm"]]).all()
        for s in trainer.step_log)


@pytest.mark.parametrize("mode", ["pipeline", "1f1b"])
def test_train_mp_cli_runs_the_schedules_with_the_jax_history_keys(mode):
    # at world 1 (one stage) both schedules are microbatching: auto n_micro
    # 4 of 2 rows each, the same steps as stage mode at micro 2, bit for bit
    with open(os.path.join(REPO, "HISTORY_bert_large_recipe_seed42.json")) as f:
        jax_keys = list(json.load(f)[0])
    trainer = train_mp.train(TINY + ["--mp-mode", mode])
    assert trainer.n_micro == 4 and trainer.train_loader.accum == 8
    assert list(trainer.history[0]) == jax_keys
    assert [s["pipeline_bubble"] for s in trainer.step_log] == [0.0, 0.0]
    stage = train_mp.train(TINY + ["--mp-mode", "stage",
                                   "--micro-batch-size", "2"])
    assert [(s["loss"], s["grad_norm"]) for s in trainer.step_log] == [
        (s["loss"], s["grad_norm"]) for s in stage.step_log]
    assert trainer.history[0]["accuracy"] == stage.history[0]["accuracy"]


def test_train_mp_stage_mode_at_world_one_equals_train_dp():
    # dropout on: the same model, the same masks, the same steps
    stage = train_mp.train(TINY + ["--mp-mode", "stage"])
    assert type(stage.state.module).__name__ == (
        "BertForSequenceClassification")
    plain = train_dp.train(TINY)
    assert stage.step_log == plain.step_log
    assert stage.history[0]["accuracy"] == plain.history[0]["accuracy"]


# ---------------------------------------------------- several processes


_MP_SCRIPT = textwrap.dedent("""
    import json, sys
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    from pytorch_distributed_training_tpu_torch.comms.bootstrap import shutdown
    from pytorch_distributed_training_tpu_torch.models.branch import (
        BranchEnsembleClassifier)
    from pytorch_distributed_training_tpu_torch.train.loop import Trainer
    from pytorch_distributed_training_tpu_torch.utils.config import (
        MeshConfig, TrainConfig, model_preset)
    from pytorch_distributed_training_tpu_torch.parallel import (
        ShardingPolicy)
    from pytorch_distributed_training_tpu_torch.train.step import (
        _forward, _loss, microbatch_seed)
    out, spec = sys.argv[1], json.loads(sys.argv[2])
    rate = spec["dropout"]
    model = None
    if spec["mode"] == "branch":
        def model(cfg, *, seed, mesh):
            return BranchEnsembleClassifier(cfg, spec["n"], seed=seed,
                                            mesh=mesh)
    t = Trainer(
        model_preset("tiny", compute_dtype="float32", hidden_dropout=rate,
                     attention_dropout=rate,
                     num_layers=spec.get("layers", 2),
                     attention_impl=spec.get("attention", "reference"),
                     **spec.get("quant", {})),
        TrainConfig(num_epochs=1, train_size=32, eval_size=24,
                    global_batch_size=16,
                    micro_batch_size=spec.get("micro", 8),
                    eval_batch_size=8, warmup_steps=1, learning_rate=1e-3,
                    max_grad_norm=spec["clip"], log_every=0,
                    max_seq_length=spec.get("seq_len", 128)),
        task="synthetic", device="cpu",
        mesh_config=MeshConfig(**spec["mesh"]), mp_mode=spec["mode"],
        model=model, n_micro=spec.get("n_micro"),
        policy=ShardingPolicy(fsdp=spec.get("fsdp", False),
                              fsdp_min_size=128))
    if "calibrate_rows" in spec:  # calibrate on these first rows
        from pytorch_distributed_training_tpu_torch.train.step import (
            calibrate_quant, quant_buffers)
        for b in quant_buffers(t.state.module).values():
            b.zero_()
        micro0 = t.train_loader.first_micro(spec["calibrate_rows"])
        for _ in range(2):
            calibrate_quant(t.state, micro0, mesh=t.mesh)
    n = spec.get("shards", 1)
    if n > 1:  # one process standing for n batch shards: shard r of each
        def step(state, batch):  # microbatch seeded as rank r
            accum = len(batch["input_ids"])
            state.optimizer.zero_grad(set_to_none=True)
            total = torch.zeros(())
            for m in range(accum):
                micro = {k: v[m] for k, v in batch.items()}
                rows = micro["input_ids"].shape[0] // n
                for r in range(n):
                    part = {k: v[r * rows:(r + 1) * rows]
                            for k, v in micro.items()}
                    seed = microbatch_seed(state.dropout_seed, state.step,
                                           m, r)
                    loss = _loss(t.objective, _forward(state.model, part,
                                                       seed), part)
                    loss = loss / (accum * n)
                    loss.backward()
                    total = total + loss.detach()
            params = [p for p in state.module.parameters()
                      if p.grad is not None]
            norm = state.optimizer.grad_norm(params,
                                             [p.grad for p in params])
            state.optimizer.step()
            state.step += 1
            return {"loss": total, "grad_norm": norm}
        t.train_step = step
    t.run()
    rank = t.info.rank
    sd = t.state.module.state_dict()
    torch.save({k: v.full_tensor() if hasattr(v, "full_tensor") else v
                for k, v in sd.items()}, f"{out}.{rank}.pt")
    groups = {a: None if g is None else dist.get_process_group_ranks(g)
              for a, g in t.mesh.groups.items()}
    with open(f"{out}.{rank}.json", "w") as f:
        json.dump({"steps": t.step_log, "history": t.history,
                   "world": t.info.world_size, "coords": t.mesh.coords,
                   "groups": groups,
                   "sharded": [k for k, v in sd.items()
                               if hasattr(v, "full_tensor")]}, f)
    shutdown()
""")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run(tmp_path, runs: dict, script: str = _MP_SCRIPT) -> dict:
    """Start every run (name -> (world size, spec)) of ``script`` at once,
    one process a rank, and read back each run's per-rank records and
    state dicts."""
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
                [sys.executable, "-c", script, str(tmp_path / name),
                 json.dumps(spec)],
                cwd=REPO, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True,
            ))
    try:
        for p in procs:
            _, err = p.communicate(timeout=240)
            assert p.returncode == 0, err[-3000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    out = {}
    for name, (world, _) in runs.items():
        recs = [json.loads((tmp_path / f"{name}.{r}.json").read_text())
                for r in range(world)]
        dicts = [torch.load(str(tmp_path / f"{name}.{r}.pt"))
                 for r in range(world)]
        merged = {}
        for sd in dicts:
            for k, v in sd.items():
                if k in merged:  # replicated: bit-identical on every rank
                    assert torch.equal(merged[k], v), (name, k)
                merged[k] = v
        out[name] = dict(recs=recs, weights=merged)
    return out


def _assert_same_run(got, want, rtol=1e-5):
    a, b = want["recs"][0], got["recs"][0]
    assert len(a["steps"]) == len(b["steps"]) == 2
    for sa, sb in zip(a["steps"], b["steps"]):
        np.testing.assert_allclose(sb["loss"], sa["loss"], rtol=rtol)
        np.testing.assert_allclose(sb["grad_norm"], sa["grad_norm"],
                                   rtol=rtol)
    for rec in got["recs"]:  # every rank reports the same run
        assert rec["steps"] == b["steps"]
        for k in ("train_loss", "accuracy", "f1"):
            assert rec["history"][0][k] == b["history"][0][k]
    for k in ("accuracy", "f1"):
        assert b["history"][0][k] == a["history"][0][k]
    assert got["weights"].keys() == want["weights"].keys()
    for name, w in want["weights"].items():
        torch.testing.assert_close(got["weights"][name], w, rtol=0,
                                   atol=1e-6, msg=name)


def test_branch_split_over_two_ranks_equals_one(tmp_path):
    # (model 2) == (model 1) with dropout on and clipping on (the norm of
    # the whole model), at 2 and 4 branches: each rank holds 1 or 2
    runs = {}
    for n in (2, 4):
        spec = dict(mode="branch", n=n, dropout=0.1, clip=0.05)
        runs[f"one{n}"] = (1, dict(spec, mesh={}))
        runs[f"two{n}"] = (2, dict(spec, mesh=dict(data=1, model=2)))
    res = _run(tmp_path, runs)
    for n in (2, 4):
        two = res[f"two{n}"]
        _assert_same_run(two, res[f"one{n}"])
        norms = [s["grad_norm"] for s in two["recs"][0]["steps"]]
        assert min(norms) > 0.05  # every step clipped
        for r, rec in enumerate(two["recs"]):
            assert rec["coords"]["model"] == r
            assert rec["groups"]["model"] == [0, 1]
            assert rec["groups"]["data"] is None


def test_data_by_model_mesh_equals_one_process(tmp_path):
    # (data 2 x model 2) == one process, dropout off: each data slice
    # reads half the rows, DDP averages over the data group only
    spec = dict(mode="branch", n=2, dropout=0.0, clip=0.0)
    res = _run(tmp_path, {
        "one": (1, dict(spec, mesh={})),
        "four": (4, dict(spec, mesh=dict(data=2, model=2))),
    })
    _assert_same_run(res["four"], res["one"])
    recs = res["four"]["recs"]
    assert [(r["coords"]["data"], r["coords"]["model"]) for r in recs] == [
        (0, 0), (0, 1), (1, 0), (1, 1)]
    assert [r["groups"]["data"] for r in recs] == [[0, 2], [1, 3]] * 2
    assert [r["groups"]["model"] for r in recs] == [[0, 1]] * 2 + [[2, 3]] * 2


def test_stage_split_over_two_ranks_equals_one(tmp_path):
    # (stage 2) == (stage 1) with dropout on and clipping on: the
    # activation and its gradient pass between the ranks per microbatch
    spec = dict(mode="stage", dropout=0.1, clip=0.05)
    res = _run(tmp_path, {
        "one": (1, dict(spec, mesh={})),
        "two": (2, dict(spec, mesh=dict(data=1, stage=2))),
    })
    _assert_same_run(res["two"], res["one"])
    recs = res["two"]["recs"]
    assert [r["groups"]["stage"] for r in recs] == [[0, 1], [0, 1]]
    w0 = torch.load(str(tmp_path / "two.0.pt"))
    w1 = torch.load(str(tmp_path / "two.1.pt"))
    assert any(k.startswith("bert.embeddings.") for k in w0)
    assert not any(k.startswith("bert.layers.1.") for k in w0)
    assert any(k.startswith("classifier.") for k in w1)
    assert not set(w0) & set(w1)
