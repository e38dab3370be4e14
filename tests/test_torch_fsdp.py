"""Port parity, FSDP over the (data, fsdp) mesh: the PyTorch package's
placements (``parallel/sharding.py``) against the JAX package's
``_leaf_spec`` leaf by leaf, the batch axes of the mesh and its FSDP
``DeviceMesh`` against ``MeshConfig``, the per-shard dropout seed, the CLI
flags against the JAX CLIs', and FSDP runs over several gloo processes
against one process, on the CPU."""

import json
import os
import socket
import subprocess
import sys
import textwrap
import types

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from pytorch_distributed_training_tpu.cli import train_dp as jax_train_dp
from pytorch_distributed_training_tpu.cli import train_lm as jax_train_lm
from pytorch_distributed_training_tpu.cli import train_mp as jax_train_mp
from pytorch_distributed_training_tpu.parallel.sharding import (
    ShardingPolicy as JaxShardingPolicy,
)
from pytorch_distributed_training_tpu.parallel.sharding import _leaf_spec
from pytorch_distributed_training_tpu.utils.config import (
    MeshConfig as JaxMeshConfig,
)
from pytorch_distributed_training_tpu_torch.cli import (
    train_dp,
    train_lm,
    train_mp,
)
from pytorch_distributed_training_tpu_torch.comms.mesh import (
    AXIS_NAMES,
    Mesh,
    batch_index,
    build_mesh,
    fsdp_device_mesh,
)
from pytorch_distributed_training_tpu_torch.models.bert import (
    BertForSequenceClassification,
)
from pytorch_distributed_training_tpu_torch.models.branch import (
    BranchEnsembleClassifier,
)
from pytorch_distributed_training_tpu_torch.models.convert import params_to_jax
from pytorch_distributed_training_tpu_torch.models.gpt2 import GPT2LMModel
from pytorch_distributed_training_tpu_torch.models.stage import BertStage
from pytorch_distributed_training_tpu_torch.parallel import (
    ShardingPolicy,
    param_placements,
)
from pytorch_distributed_training_tpu_torch.train.step import microbatch_seed
from pytorch_distributed_training_tpu_torch.utils.config import (
    MeshConfig,
    model_preset,
)

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ------------------------------------------------- placements vs _leaf_spec


def _mesh(**sizes) -> Mesh:
    """A mesh of this shape seen from rank 0, no process group."""
    shape = {a: sizes.get(a, 1) for a in AXIS_NAMES}
    return Mesh(shape=shape, coords={a: 0 for a in AXIS_NAMES},
                groups={a: None for a in AXIS_NAMES})


def _jax_path(name: str, stage: bool) -> tuple:
    """The flax path of a port parameter, a branch's or (``stage``) a
    layer's as the stacked leaf JAX holds."""
    parts, out, i = name.split("."), [], 0
    while i < len(parts):
        p = parts[i]
        if p == "branches":
            out.append(p)
            i += 2
        elif p in ("layers", "blocks") and i + 1 < len(parts) and (
                parts[i + 1].isdigit()):
            kind = "layer" if p == "layers" else "block"
            out += ["layers_scan", kind] if stage else [f"{kind}_{parts[i + 1]}"]
            i += 2
        else:
            out.append(p)
            i += 1
    return tuple(out)


def _cases():
    """(name, the rank's module, the whole model (JAX's tree), mesh shape,
    policy flags, stacked per module)."""
    tiny = model_preset("tiny", compute_dtype="float32")
    gen = lambda: torch.Generator().manual_seed(0)  # noqa: E731
    bert = BertForSequenceClassification(tiny, generator=gen())
    scan = dict(scan_layers=True)
    yield ("bert", bert, bert, {}, {}, False, False)
    bert_s = BertForSequenceClassification(
        model_preset("tiny", **scan), generator=gen())
    yield ("bert-scan", bert_s, bert_s, {}, {}, False, True)
    gpt = GPT2LMModel(model_preset("gpt2-tiny"), generator=gen())
    yield ("gpt2", gpt, gpt, {}, {}, False, False)
    gpt_s = GPT2LMModel(model_preset("gpt2-tiny", **scan), generator=gen())
    yield ("gpt2-scan", gpt_s, gpt_s, {}, {}, False, True)
    tri = BranchEnsembleClassifier(tiny, 3, seed=0)
    yield ("tribert", tri, tri, {}, dict(branch=True), True, False)
    whole = BranchEnsembleClassifier(tiny, 4, seed=0)
    rank0 = BranchEnsembleClassifier(tiny, 4, seed=0, mesh=_mesh(model=2))
    yield ("tribert-model2", rank0, whole, dict(model=2), dict(branch=True),
           True, False)
    stage0 = BertStage(BertForSequenceClassification(tiny, generator=gen()),
                       _mesh(stage=2))
    yield ("bert-stage2", stage0, bert, dict(stage=2), dict(stage=True),
           True, True)


CASES = {c[0]: c[1:] for c in _cases()}


@pytest.mark.parametrize("min_size", [128, 2**16])
@pytest.mark.parametrize("fsdp", [2, 4, 8])
@pytest.mark.parametrize("case", sorted(CASES))
def test_placements_match_jax_leaf_spec(case, fsdp, min_size):
    from torch.distributed.tensor import Replicate, Shard

    module, whole, sizes, flags, per_module, scanned = CASES[case]
    stage = flags.get("stage", False)
    sizes = dict(sizes, fsdp=fsdp)
    shape = {a: sizes.get(a, 1) for a in AXIS_NAMES}
    got = param_placements(
        {n: tuple(p.shape) for n, p in module.named_parameters()},
        ShardingPolicy(fsdp=True, fsdp_min_size=min_size, **flags), shape)
    tree = jax.tree.map(np.asarray,
                        params_to_jax(whole.state_dict(), scan_layers=scanned))
    flat = {tuple(k.key for k in path): leaf for path, leaf in
            jax.tree_util.tree_flatten_with_path(tree)[0]}
    jax_policy = JaxShardingPolicy(fsdp=True, fsdp_min_size=min_size,
                                   **flags)
    stand_in = types.SimpleNamespace(shape=shape)  # all _leaf_spec reads
    kinds = set()
    assert got.keys() == dict(module.named_parameters()).keys()
    for name, placement in got.items():
        path = _jax_path(name, stage)
        leaf = flat[path]
        spec = list(_leaf_spec([jax.tree_util.DictKey(k) for k in path],
                               leaf, jax_policy, stand_in))
        spec += [None] * (leaf.ndim - len(spec))
        stacked = per_module and ("branches" in path or "layers_scan" in path)
        if stacked:
            assert spec[0] != "fsdp", (name, spec)
            spec = spec[1:]
        want = Shard(spec.index("fsdp")) if "fsdp" in spec else Replicate()
        assert placement == want, (name, spec, placement)
        kinds.add(type(placement))
    if min_size == 128:
        assert kinds == {Shard, Replicate}


def test_placements_off_policy_and_tp():
    from torch.distributed.tensor import Replicate, Shard

    shapes = {"a.kernel": (1024, 4096)}
    mesh = {a: 1 for a in AXIS_NAMES} | {"fsdp": 4}
    assert param_placements(shapes, ShardingPolicy(), mesh) == {
        "a.kernel": Replicate()}
    assert param_placements(shapes, ShardingPolicy(fsdp=True),
                            mesh | {"fsdp": 1}) == {"a.kernel": Replicate()}
    # tp: the model dim first (the heads), then fsdp on the largest other
    qkv = {"attention.query.kernel": (1024, 16, 64)}
    assert param_placements(qkv, ShardingPolicy(tp=True, fsdp=True),
                            mesh | {"model": 2}) == {
        "attention.query.kernel": Shard(0)}
    up = {"mlp_up.kernel": (64, 4096)}
    for tp, dim in ((True, 0), (False, 1)):
        assert param_placements(up, ShardingPolicy(tp=tp, fsdp=True),
                                mesh | {"model": 2}) == {
            "mlp_up.kernel": Shard(dim)}


# --------------------------------------------- the batch axes and the seeds


FSDP_MESHES = [
    (dict(data=1, fsdp=2), 2), (dict(data=2, fsdp=2), 4),
    (dict(data=1, fsdp=-1), 4), (dict(data=1, fsdp=2, model=2), 4),
    (dict(data=2, fsdp=2, model=2), 8), (dict(data=-1, fsdp=2, stage=2), 8),
]


@pytest.mark.parametrize("kw,world", FSDP_MESHES)
def test_batch_axes_device_mesh_and_seeds(kw, world):
    # each rank in turn on torch's fake backend: the shape is JAX's, the
    # batch shard the linear index over (data, fsdp), the batch group the
    # ranks of this rank's stage/model/seq coordinates, FSDP's DeviceMesh
    # on the mesh's own data and fsdp groups, and the microbatch seed one
    # per batch shard, alike on its model and stage ranks
    from torch.testing._internal.distributed.fake_pg import FakeStore

    shape = JaxMeshConfig(**kw).resolved_shape(world)
    grid = np.arange(world).reshape(shape)
    seeds = {}
    for rank in range(world):
        dist.init_process_group("fake", store=FakeStore(), rank=rank,
                                world_size=world)
        try:
            mesh = build_mesh(MeshConfig(**kw), rank=rank, world_size=world)
            c = tuple(int(x) for x in np.unravel_index(rank, shape))
            assert tuple(mesh.coord(a) for a in AXIS_NAMES) == c
            assert batch_index(mesh) == c[0] * shape[1] + c[1]
            sub = grid[:, :, c[2], c[3], c[4]]
            assert dist.get_process_group_ranks(mesh.batch_group) == sorted(
                sub.ravel().tolist())
            dm = fsdp_device_mesh(mesh, "cpu")
            assert dm.mesh.tolist() == (sub.tolist() if shape[0] > 1
                                        else sub[0].tolist())
            for axis in ("data", "fsdp"):
                if mesh.shape[axis] > 1:
                    assert dist.get_process_group_ranks(
                        dm.get_group(axis)) == dist.get_process_group_ranks(
                            mesh.group(axis))
            seeds[c] = microbatch_seed(1234, 3, 1, batch_index(mesh))
        finally:
            dist.destroy_process_group()
    shards = {}
    for c, seed in seeds.items():
        shards.setdefault(c[:2], set()).add(seed)
    assert all(len(s) == 1 for s in shards.values())  # alike per shard
    assert len({s.pop() for s in shards.values()}) == shape[0] * shape[1]


def test_one_rank_device_mesh_and_fsdp_of_one_raises():
    with pytest.raises(ValueError, match="fsdp axis of 1"):
        fsdp_device_mesh(_mesh(), "cpu")


# ------------------------------------------------------------------ the CLIs


MESH_FLAGS = ("fsdp", "tp", "scan_layers", "mesh_data", "mesh_fsdp",
              "mesh_stage", "mesh_model", "mesh_seq", "attention")


@pytest.mark.parametrize("port,jax_cli", [
    (train_dp, jax_train_dp), (train_lm, jax_train_lm),
    (train_mp, jax_train_mp)], ids=["train_dp", "train_lm", "train_mp"])
def test_cli_mesh_flags_default_as_jax(port, jax_cli):
    got = vars(port.build_parser().parse_args([]))
    want = vars(jax_cli.build_parser().parse_args([]))
    flags = [f for f in MESH_FLAGS if f in want]
    assert flags and all(f in got for f in flags)
    assert {f: got[f] for f in flags} == {f: want[f] for f in flags}


TINY = ["--task", "synthetic", "--device", "cpu", "--train-size", "32",
        "--eval-size", "16", "--global-batch-size", "16",
        "--num-epochs", "1", "--log-every", "0"]


def test_train_lm_defaults_scan_and_shard_policy():
    # one process: an fsdp axis of one, the model unwrapped and scanned
    trainer = train_lm.train(["--model", "gpt2-tiny"] + TINY[:-4]
                             + ["--task", "lm", "--num-epochs", "1",
                                "--log-every", "0"])
    assert trainer.policy.fsdp and trainer.mcfg.scan_layers
    assert trainer.mesh.shape["fsdp"] == 1
    assert any(n.startswith("layers_scan.block.")
               for n, _ in trainer.state.module.named_parameters())


# ---------------------------------------------------- several processes


_FSDP_SCRIPT = textwrap.dedent("""
    import json, sys
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    from pytorch_distributed_training_tpu_torch.comms.bootstrap import shutdown
    from pytorch_distributed_training_tpu_torch.comms.mesh import batch_index
    from pytorch_distributed_training_tpu_torch.models.branch import (
        BranchEnsembleClassifier)
    from pytorch_distributed_training_tpu_torch.models.convert import (
        params_from_jax, params_to_jax)
    from pytorch_distributed_training_tpu_torch.parallel import (
        ShardingPolicy)
    from pytorch_distributed_training_tpu_torch.train.loop import Trainer
    from pytorch_distributed_training_tpu_torch.train.step import (
        _forward, _loss, microbatch_seed)
    from pytorch_distributed_training_tpu_torch.utils.config import (
        MeshConfig, TrainConfig, model_preset)
    out, spec = sys.argv[1], json.loads(sys.argv[2])
    rate, lm = spec["dropout"], spec["model"] == "lm"
    model, mode = None, None
    if spec["model"] == "stage":
        mode = "stage"
    if spec["model"] == "branch":
        mode = "branch"
        def model(cfg, *, seed, mesh):
            return BranchEnsembleClassifier(cfg, spec["n"], seed=seed,
                                            mesh=mesh)
    t = Trainer(
        model_preset("gpt2-tiny" if lm else "tiny", compute_dtype="float32",
                     hidden_dropout=rate, attention_dropout=rate,
                     scan_layers=lm),
        TrainConfig(num_epochs=1, train_size=48, eval_size=24,
                    global_batch_size=16, micro_batch_size=8,
                    eval_batch_size=8, warmup_steps=1, learning_rate=1e-3,
                    max_grad_norm=spec["clip"], log_every=0),
        task="lm" if lm else "synthetic", device="cpu",
        mesh_config=MeshConfig(**spec["mesh"]), mp_mode=mode, model=model,
        policy=ShardingPolicy(fsdp=True, fsdp_min_size=128))
    n = spec.get("shards", 1)
    if n > 1:  # one process standing for n batch shards: shard r of each
        def step(state, batch, accum=2):  # microbatch seeded as rank r
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
    full = {k: v.full_tensor() if hasattr(v, "full_tensor") else v
            for k, v in sd.items()}
    sharded = [k for k, v in sd.items() if hasattr(v, "full_tensor")]
    rec = {"steps": t.step_log, "history": t.history, "sharded": sharded,
           "shard": batch_index(t.mesh),
           "seed": microbatch_seed(t.state.dropout_seed, 0, 0,
                                   batch_index(t.mesh))}
    if sharded:
        p = dict(t.state.module.named_parameters())[sharded[0]]
        dm = p.device_mesh
        rec["mesh_groups"] = {
            a: dist.get_process_group_ranks(dm.get_group(a))
            for a in dm.mesh_dim_names}
        rec["groups"] = {
            a: dist.get_process_group_ranks(t.mesh.group(a))
            for a in dm.mesh_dim_names}
    if mode is None:  # the weight bridge takes the sharded model whole
        back = params_from_jax(params_to_jax(sd, scan_layers=lm),
                               scan_layers=lm)
        rec["bridge_equal"] = all(torch.equal(back[k], full[k].float())
                                  for k in full)
    torch.save(full, f"{out}.{rank}.pt")
    with open(f"{out}.{rank}.json", "w") as f:
        json.dump(rec, f)
    shutdown()
""")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run(tmp_path, runs: dict) -> dict:
    """Start every run (name -> (world size, spec)) at once, one process a
    rank; each run's per-rank records and merged weights."""
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
                [sys.executable, "-c", _FSDP_SCRIPT, str(tmp_path / name),
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
        merged = {}
        for r in range(world):
            for k, v in torch.load(str(tmp_path / f"{name}.{r}.pt")).items():
                if k in merged:  # held by several ranks: the same values
                    assert torch.equal(merged[k], v), (name, k)
                merged[k] = v
        out[name] = dict(recs=recs, weights=merged)
    return out


def _assert_same_run(got, want, steps=3):
    a, b = want["recs"][0], got["recs"][0]
    assert len(a["steps"]) == len(b["steps"]) == steps
    for sa, sb in zip(a["steps"], b["steps"]):
        np.testing.assert_allclose(sb["loss"], sa["loss"], rtol=1e-5)
        np.testing.assert_allclose(sb["grad_norm"], sa["grad_norm"],
                                   rtol=1e-5)
    metrics = [k for k in a["history"][0] if not k.startswith("samples")]
    for rec in got["recs"]:  # every rank reports the same run
        assert rec["steps"] == b["steps"]
        assert all(rec["history"][0][k] == b["history"][0][k]
                   for k in metrics)
    for k in metrics:
        np.testing.assert_allclose(b["history"][0][k], a["history"][0][k],
                                   rtol=1e-5)
    assert got["weights"].keys() == want["weights"].keys()
    for name, w in want["weights"].items():
        torch.testing.assert_close(got["weights"][name], w, rtol=0,
                                   atol=1e-6, msg=name)


SPEC = dict(dropout=0.1, clip=0.05)


@pytest.mark.parametrize("model", ["bert", "lm"])
def test_fsdp_runs_equal_one_process(tmp_path, model):
    # (data 1 x fsdp 2) and (data 2 x fsdp 2, HSDP) against one process
    # standing for 2 and 4 batch shards, dropout and clipping on: BERT
    # (a unit a layer) and the scanned GPT-2 (the stacked trunk one unit)
    spec = dict(SPEC, model=model)
    res = _run(tmp_path, {
        "one2": (1, dict(spec, mesh={}, shards=2)),
        "f2": (2, dict(spec, mesh=dict(data=1, fsdp=2))),
        "one4": (1, dict(spec, mesh={}, shards=4)),
        "d2f2": (4, dict(spec, mesh=dict(data=2, fsdp=2))),
    })
    _assert_same_run(res["f2"], res["one2"])
    _assert_same_run(res["d2f2"], res["one4"])
    assert not res["one2"]["recs"][0]["sharded"]
    for name, shards in (("f2", [0, 1]), ("d2f2", [0, 1, 2, 3])):
        recs = res[name]["recs"]
        assert [r["shard"] for r in recs] == shards
        assert len({r["seed"] for r in recs}) == len(shards)
        for r in recs:
            assert r["sharded"] == recs[0]["sharded"] != []
            assert r["bridge_equal"]
            assert r["mesh_groups"] == r["groups"]
        norms = [s["grad_norm"] for s in recs[0]["steps"]]
        assert min(norms) > 0.05  # every step clipped
    if model == "lm":
        assert any(k.startswith("layers_scan.block.")
                   for k in res["f2"]["recs"][0]["sharded"])
    assert [r["mesh_groups"] for r in res["d2f2"]["recs"]] == [
        {"data": [0, 2], "fsdp": [0, 1]}, {"data": [1, 3], "fsdp": [0, 1]},
        {"data": [0, 2], "fsdp": [2, 3]}, {"data": [1, 3], "fsdp": [2, 3]}]


def test_fsdp_by_model_branch_mode_equals_one_process(tmp_path):
    # (fsdp 2 x model 2), 4 branches: each model rank's 2 branches and the
    # shared head sharded over its fsdp pair; the batch over fsdp only, so
    # the seeds differ across fsdp and agree across model
    spec = dict(SPEC, model="branch", n=4)
    res = _run(tmp_path, {
        "one": (1, dict(spec, mesh={}, shards=2)),
        "f2m2": (4, dict(spec, mesh=dict(data=1, fsdp=2, model=2))),
    })
    _assert_same_run(res["f2m2"], res["one"])
    recs = res["f2m2"]["recs"]
    assert [r["shard"] for r in recs] == [0, 0, 1, 1]
    assert recs[0]["seed"] == recs[1]["seed"] != recs[2]["seed"] == (
        recs[3]["seed"])
    assert [r["mesh_groups"] for r in recs] == [
        {"fsdp": [0, 2]}, {"fsdp": [1, 3]}] * 2
    assert any(k.startswith("branches.") for k in recs[0]["sharded"])


def test_fsdp_by_stage_equals_one_process(tmp_path):
    # (fsdp 2 x stage 2): each stage's layers sharded over its fsdp pair,
    # the activation and its gradient passed between the stages
    spec = dict(SPEC, model="stage")
    res = _run(tmp_path, {
        "one": (1, dict(spec, mesh={}, shards=2)),
        "f2s2": (4, dict(spec, mesh=dict(data=1, fsdp=2, stage=2))),
    })
    _assert_same_run(res["f2s2"], res["one"])
    recs = res["f2s2"]["recs"]
    assert [r["shard"] for r in recs] == [0, 0, 1, 1]
    assert [r["mesh_groups"] for r in recs] == [
        {"fsdp": [0, 2]}, {"fsdp": [1, 3]}] * 2
    assert any(k.startswith("bert.layers.0.") for k in recs[0]["sharded"])
    assert any(k.startswith("bert.layers.1.") for k in recs[1]["sharded"])
