"""Port parity, the pipeline schedules (``parallel/pipeline.py``): the GPipe
forward and two 1F1B steps against the JAX package's ``GPipeClassifier``
and ``make_1f1b_train_step`` (JAX on the 8 virtual CPU devices, the port
over 4 gloo processes, the weights across by ``params_from_jax``), GPipe
and 1F1B against one process of stage mode over gloo at stage 2, stage 4,
data 2 × stage 2 and fsdp 2 × stage 2, the activations each schedule
saves, and the errors and ``resolve_n_micro``'s choices, on the CPU."""

import textwrap
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_training_tpu.cli import train_mp as jax_train_mp
from pytorch_distributed_training_tpu.comms.ingest import make_global_batch
from pytorch_distributed_training_tpu.comms.mesh import (
    TRAIN_BATCH_PSPEC,
)
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
    GPipeClassifier as JaxGPipeClassifier,
)
from pytorch_distributed_training_tpu.parallel.pipeline import (
    gpipe_apply as jax_gpipe_apply,
)
from pytorch_distributed_training_tpu.parallel.pipeline import (
    make_1f1b_train_step as jax_make_1f1b_train_step,
)
from pytorch_distributed_training_tpu.parallel.sharding import shard_state
from pytorch_distributed_training_tpu.train import (
    adamw_with_schedule,
    create_train_state,
)
from pytorch_distributed_training_tpu.utils.config import (
    MeshConfig as JaxMeshConfig,
)
from pytorch_distributed_training_tpu.utils.config import (
    TrainConfig as JaxTrainConfig,
)
from pytorch_distributed_training_tpu.utils.config import (
    model_preset as jax_preset,
)
from pytorch_distributed_training_tpu_torch.cli import train_mp
from pytorch_distributed_training_tpu_torch.comms.mesh import AXIS_NAMES, Mesh
from pytorch_distributed_training_tpu_torch.models.convert import (
    params_from_jax,
)
from pytorch_distributed_training_tpu_torch.parallel.pipeline import (
    GPipeClassifier,
    StageWire,
    bubble,
    gpipe_apply,
    make_1f1b_train_step,
    make_pipeline_train_step,
    one_f_one_b_grads,
)
from pytorch_distributed_training_tpu_torch.train.loop import Trainer
from pytorch_distributed_training_tpu_torch.utils.config import (
    TrainConfig,
    model_preset,
)
from test_torch_mp import TINY, _assert_same_run, _run

torch.set_num_threads(2)

NO_DROPOUT = dict(compute_dtype="float32", hidden_dropout=0.0,
                  attention_dropout=0.0)


_PIPE_SCRIPT = textwrap.dedent("""
    import json, sys, weakref
    import numpy as np
    import torch
    torch.set_num_threads(1)
    from pytorch_distributed_training_tpu_torch.comms.bootstrap import (
        initialize, shutdown)
    from pytorch_distributed_training_tpu_torch.comms.mesh import build_mesh
    from pytorch_distributed_training_tpu_torch.models.bert import (
        BertForSequenceClassification)
    from pytorch_distributed_training_tpu_torch.models.stage import BertStage
    from pytorch_distributed_training_tpu_torch.parallel.pipeline import (
        GPipeClassifier, make_1f1b_train_step, make_pipeline_train_step)
    from pytorch_distributed_training_tpu_torch.train.optim import (
        AdamW, linear_warmup_schedule)
    from pytorch_distributed_training_tpu_torch.train.state import (
        create_train_state)
    from pytorch_distributed_training_tpu_torch.utils.config import (
        MeshConfig, model_preset)
    out, spec = sys.argv[1], json.loads(sys.argv[2])
    info = initialize(torch.device("cpu"))
    mesh = build_mesh(MeshConfig(**spec["mesh"]), rank=info.rank,
                      world_size=info.world_size)
    cfg = model_preset("tiny", compute_dtype="float32", hidden_dropout=0.0,
                       attention_dropout=0.0, num_layers=spec["layers"])
    full = BertForSequenceClassification(
        cfg, generator=torch.Generator().manual_seed(0))
    if "weights" in spec:
        full.load_state_dict(torch.load(spec["weights"]))
    module = BertStage(full, mesh)
    data = ({k: torch.from_numpy(v)
             for k, v in np.load(spec["inputs"]).items()}
            if "inputs" in spec else None)
    rec = {}
    if spec["kind"] == "forward":
        clf = GPipeClassifier(cfg, mesh, spec["n_micro"], module)
        with torch.no_grad():
            logits = clf(data["input_ids"], data["attention_mask"])
        rec["logits"] = None if logits is None else logits.tolist()
    elif spec["kind"] == "1f1b":
        opt = AdamW(module.parameters(), linear_warmup_schedule(*spec["lr"]))
        state = create_train_state(module, opt, 0)
        step = make_1f1b_train_step(cfg, mesh, n_micro=spec["n_micro"],
                                    grad_accum_steps=spec["accum"])
        rec["steps"] = []
        for _ in range(spec["steps"]):
            m = step(state, data)
            rec["steps"].append(dict(loss=float(m["loss"]),
                                     bubble=m["pipeline_bubble"]))
    else:  # the bytes of the saved activations, at their peak
        weights = {p.untyped_storage().data_ptr()
                   for p in module.parameters()}
        live = {"now": 0, "peak": 0}

        class Held:
            __slots__ = ("t", "__weakref__")

        def release(n):
            live["now"] -= n

        def pack(t):
            held = Held()
            held.t = t
            if t.untyped_storage().data_ptr() not in weights:
                n = t.nelement() * t.element_size()
                live["now"] += n
                live["peak"] = max(live["peak"], live["now"])
                weakref.finalize(held, release, n)
            return held

        state = create_train_state(
            module, AdamW(module.parameters(), lambda count: 0.0), 0)
        rng = np.random.default_rng(1)
        for schedule in ("pipeline", "1f1b"):
            for n in spec["n_micros"]:
                batch = {
                    "input_ids": torch.from_numpy(rng.integers(
                        0, cfg.vocab_size, (n, spec["rows"], 16))),
                    "attention_mask": torch.ones(n, spec["rows"], 16),
                    "labels": torch.from_numpy(rng.integers(
                        0, 2, (n, spec["rows"])))}
                step = make_pipeline_train_step(
                    cfg, mesh, schedule=schedule, n_micro=n,
                    grad_accum_steps=1)
                live["peak"] = 0
                with torch.autograd.graph.saved_tensors_hooks(
                        pack, lambda held: held.t):
                    step(state, batch)
                rec[f"{schedule}{n}"] = live["peak"]
                rec[f"{schedule}{n}_left"] = live["now"]
    torch.save(module.state_dict(), f"{out}.{info.rank}.pt")
    with open(f"{out}.{info.rank}.json", "w") as f:
        json.dump(rec, f)
    shutdown()
""")


def _jax_inputs(rng, cfg, rows, seq=16):
    ids = rng.integers(0, cfg.vocab_size, (rows, seq)).astype(np.int32)
    mask = rng.integers(0, 2, (rows, seq)).astype(np.int32)
    mask[:, 0] = 1
    return ids, mask


# ------------------------------------------------- against the JAX package


def test_gpipe_forward_matches_jax_gpipe_classifier(tmp_path, eight_devices):
    # JAX at (data 2, stage 4), the port over 4 gloo ranks at stage 4:
    # 4 pipeline microbatches of 2 rows, tiny with 4 layers, float32,
    # dropout 0 (the oracle of JAX tests/test_pipeline.py:140-150)
    cfg = jax_preset("tiny", num_layers=4, scan_layers=True, **NO_DROPOUT)
    model = JaxGPipeClassifier(cfg, jax_build_mesh(
        JaxMeshConfig(data=2, stage=4)), n_micro=4)
    ids, mask = _jax_inputs(np.random.default_rng(0), cfg, 8)
    params = model.init(jax.random.key(0), ids, mask)["params"]
    want = np.asarray(model.apply({"params": params}, ids, mask,
                                  deterministic=True))
    torch.save(params_from_jax(jax.tree.map(np.asarray, params),
                               scan_layers=False), tmp_path / "w.pt")
    np.savez(tmp_path / "in.npz", input_ids=ids, attention_mask=mask)
    res = _run(tmp_path, {"fwd": (4, dict(
        kind="forward", mesh=dict(data=1, stage=4), layers=4, n_micro=4,
        weights=str(tmp_path / "w.pt"),
        inputs=str(tmp_path / "in.npz")))}, _PIPE_SCRIPT)
    recs = res["fwd"]["recs"]
    assert [r["logits"] is None for r in recs] == [True] * 3 + [False]
    np.testing.assert_allclose(np.asarray(recs[3]["logits"]), want,
                               atol=1e-5, rtol=1e-5)


def test_1f1b_steps_match_jax_make_1f1b_train_step(tmp_path, eight_devices):
    # JAX's 1F1B step at (data 2, stage 4), n_micro 4, accumulation 2,
    # dropout 0, against the port's over 4 gloo ranks at stage 4, with the
    # tolerances of JAX tests/test_pipeline.py:407-489; two steps, since
    # the schedule's first learning rate is 0 and the second moves them
    cfg = jax_preset("tiny", num_layers=4, scan_layers=True, **NO_DROPOUT)
    mesh = jax_build_mesh(JaxMeshConfig(data=2, stage=4))
    tx, _ = adamw_with_schedule(
        JaxTrainConfig(learning_rate=1e-3, warmup_steps=1), 100)
    example = {"input_ids": jnp.ones((2, 16), jnp.int32),
               "attention_mask": jnp.ones((2, 16), jnp.int32),
               "token_type_ids": jnp.zeros((2, 16), jnp.int32)}
    state = create_train_state(JaxBert(cfg), tx, jax.random.key(0), example)
    shardings = state_shardings(state, JaxShardingPolicy(stage=True), mesh)
    state = shard_state(state, shardings)
    start = params_from_jax(jax.tree.map(np.asarray, state.params),
                            scan_layers=False)
    rng = np.random.default_rng(5)
    ids, mask = _jax_inputs(rng, cfg, 16)
    batch = {"input_ids": ids.reshape(2, 8, 16),
             "attention_mask": mask.reshape(2, 8, 16),
             "token_type_ids": np.zeros((2, 8, 16), np.int32),
             "labels": rng.integers(0, 2, (2, 8)).astype(np.int32)}
    step = jax_make_1f1b_train_step(cfg, mesh, shardings, n_micro=4,
                                    grad_accum_steps=2)
    placed = make_global_batch(mesh, batch, pspec=TRAIN_BATCH_PSPEC)
    losses = []
    for _ in range(2):
        state, metrics = step(state, placed)
        losses.append(float(metrics["loss"]))
    np.testing.assert_allclose(float(metrics["pipeline_bubble"]), 0.6)
    want = params_from_jax(jax.tree.map(np.asarray, state.params),
                           scan_layers=False)
    # the port's batch: [accum x n_micro, 2 rows, ...], pipeline
    # microbatch j of micro-batch m its rows [2j, 2j + 2)
    torch.save(start, tmp_path / "w.pt")
    np.savez(tmp_path / "in.npz",
             **{k: v.reshape(8, 2, *v.shape[2:]) for k, v in batch.items()})
    res = _run(tmp_path, {"f1b": (4, dict(
        kind="1f1b", mesh=dict(data=1, stage=4), layers=4, n_micro=4,
        accum=2, steps=2, lr=[1e-3, 1, 100], weights=str(tmp_path / "w.pt"),
        inputs=str(tmp_path / "in.npz")))}, _PIPE_SCRIPT)
    for rec in res["f1b"]["recs"]:
        assert [s["bubble"] for s in rec["steps"]] == [0.6, 0.6]
        np.testing.assert_allclose([s["loss"] for s in rec["steps"]],
                                   losses, rtol=2e-5)
    got = res["f1b"]["weights"]
    assert got.keys() == want.keys()
    moved = 0.0
    for name, w in want.items():
        np.testing.assert_allclose(got[name].numpy(), w.numpy(), rtol=0,
                                   atol=3e-5, err_msg=name)
        moved = max(moved, float((w - start[name]).abs().max()))
    assert moved > 1e-4


# ----------------------------------------- the schedules against stage mode


SCHEDULE_CASES = {
    # name: (ranks, mesh, n_micro, layers, batch shards of the reference)
    "stage2": (2, dict(data=1, stage=2), 4, 2, 1),
    "stage4": (4, dict(data=1, stage=4), 4, 4, 1),
    "data2_stage2": (4, dict(data=2, stage=2), 4, 2, 2),
}


@pytest.mark.parametrize("case", list(SCHEDULE_CASES))
def test_schedules_equal_stage_mode(tmp_path, case):
    # dropout and clipping on: GPipe and 1F1B at (A 2, N 4, micro 8) equal
    # one process of stage mode at 8 microbatches of 2 rows (standing for
    # 2 batch shards at data 2), and each other bit for bit
    world, mesh, n_micro, layers, shards = SCHEDULE_CASES[case]
    spec = dict(dropout=0.1, clip=0.05, layers=layers)
    res = _run(tmp_path, {
        "one": (1, dict(spec, mode="stage", mesh={}, micro=2,
                        shards=shards)),
        **{mode: (world, dict(spec, mode=mode, mesh=mesh, n_micro=n_micro))
           for mode in ("pipeline", "1f1b")},
    })
    for mode in ("pipeline", "1f1b"):
        _assert_same_run(res[mode], res["one"], rtol=1e-6)
        norms = [s["grad_norm"] for s in res[mode]["recs"][0]["steps"]]
        assert min(norms) > 0.05  # every step clipped
    stages = mesh["stage"]
    want = {"pipeline": bubble("pipeline", stages, 4),
            "1f1b": bubble("1f1b", stages, 4)}
    assert want == {"pipeline": (stages - 1) / (stages + 3),
                    "1f1b": 2 * (stages - 1) / (2 * stages + 2)}
    for mode in ("pipeline", "1f1b"):
        for rec in res[mode]["recs"]:
            assert [s["pipeline_bubble"] for s in rec["steps"]] == [
                want[mode]] * 2
    gpipe, f1b = res["pipeline"], res["1f1b"]
    strip = [[(s["loss"], s["grad_norm"]) for s in r["steps"]]
             for r in gpipe["recs"]]
    assert strip == [[(s["loss"], s["grad_norm"]) for s in r["steps"]]
                     for r in f1b["recs"]]
    for name, w in gpipe["weights"].items():
        assert torch.equal(f1b["weights"][name], w), name


def test_1f1b_fsdp_by_stage_equals_one_process(tmp_path):
    # (fsdp 2 x stage 2): each stage's layers sharded over its fsdp pair,
    # the gradients reduce-scattered in the step's last backward only
    spec = dict(dropout=0.1, clip=0.05)
    res = _run(tmp_path, {
        "one": (1, dict(spec, mode="stage", mesh={}, micro=2, shards=2)),
        "f2s2": (4, dict(spec, mode="1f1b", mesh=dict(data=1, fsdp=2,
                                                      stage=2),
                         n_micro=4, fsdp=True)),
    })
    _assert_same_run(res["f2s2"], res["one"], rtol=1e-6)
    recs = res["f2s2"]["recs"]
    assert [r["coords"]["fsdp"] for r in recs] == [0, 0, 1, 1]
    assert any(k.startswith("bert.layers.0.") for k in recs[0]["sharded"])
    assert any(k.startswith("bert.layers.1.") for k in recs[1]["sharded"])
    assert [r["steps"][0]["pipeline_bubble"] for r in recs] == [1 / 3] * 4


def test_1f1b_saved_activations_do_not_grow_with_microbatches(tmp_path):
    # stage 2, 2 rows a pipeline microbatch, N 4 then 8: on stage 0 1F1B
    # holds at most 2(S - s) - 1 = 3 graphs, GPipe all N (the counterpart
    # of JAX tests/test_pipeline.py:518-606)
    res = _run(tmp_path, {"mem": (2, dict(
        kind="memory", mesh=dict(data=1, stage=2), layers=2, rows=2,
        n_micros=[4, 8]))}, _PIPE_SCRIPT)
    recs = res["mem"]["recs"]
    for rec in recs:
        assert all(rec[f"{s}{n}_left"] == 0 for s in ("pipeline", "1f1b")
                   for n in (4, 8))
    first = recs[0]
    assert first["1f1b8"] == first["1f1b4"] > 0
    assert first["pipeline4"] == pytest.approx(first["1f1b4"] * 4 / 3,
                                               rel=0.05)
    assert first["pipeline8"] == pytest.approx(2 * first["pipeline4"],
                                               rel=0.05)
    last = recs[1]  # one graph at a time: F and B share a tick
    assert last["1f1b8"] == last["1f1b4"] < last["pipeline4"]


# ----------------------------------------------------- errors and choices


def _mesh(**sizes) -> Mesh:
    shape = {a: sizes.get(a, 1) for a in AXIS_NAMES}
    return Mesh(shape=shape, coords={a: 0 for a in AXIS_NAMES},
                groups={a: None for a in AXIS_NAMES})


def test_schedule_errors_match_jax(eight_devices):
    jmesh = jax_build_mesh(JaxMeshConfig(data=4, stage=2))
    xs = jnp.zeros((4, 1, 1, 1))

    def jax_error(stacked, n):
        with pytest.raises(ValueError) as e:
            jax_gpipe_apply(jmesh, None, stacked, xs[:n], xs[:n])
        return str(e.value)

    def port_error(fn):
        with pytest.raises(ValueError) as e:
            fn()
        return str(e.value)

    layers3 = {"w": jnp.zeros((3, 1))}
    layers4 = {"w": jnp.zeros((4, 1))}
    cfg3 = model_preset("tiny", num_layers=3)
    assert port_error(lambda: GPipeClassifier(cfg3, _mesh(stage=2), 2)) == (
        jax_error(layers3, 4))
    assert port_error(lambda: make_1f1b_train_step(
        cfg3, _mesh(stage=2), n_micro=2, grad_accum_steps=1)) == (
        jax_error(layers3, 4))
    want = jax_error(layers4, 1)
    cfg = model_preset("tiny")
    assert port_error(lambda: GPipeClassifier(cfg, _mesh(stage=2), 1)) == want
    for schedule in ("pipeline", "1f1b"):
        assert port_error(lambda: make_pipeline_train_step(
            cfg, _mesh(stage=2), schedule=schedule, n_micro=1,
            grad_accum_steps=1)) == want
    wire = types.SimpleNamespace(n_stages=2, stage=0)
    for schedule in (gpipe_apply, one_f_one_b_grads):
        assert port_error(lambda: schedule(None, 1, wire)) == want
    causal = model_preset("gpt2-tiny")
    jcausal = jax_preset("gpt2-tiny", scan_layers=True)
    with pytest.raises(ValueError) as e:
        JaxGPipeClassifier(jcausal, jmesh, 2)
    assert port_error(lambda: GPipeClassifier(causal, _mesh(), 2)) == str(
        e.value)
    with pytest.raises(ValueError) as e:
        jax_make_1f1b_train_step(jcausal, jmesh, None, n_micro=2,
                                 grad_accum_steps=1)
    assert port_error(lambda: make_1f1b_train_step(
        causal, _mesh(), n_micro=2, grad_accum_steps=1)) == str(e.value)


@pytest.mark.parametrize("rows,data,match", [
    (6, 1, "micro-batch size 6 not divisible by n_micro=4"),
    (2, 2, r"pipeline microbatch size 1 \(= 4/4\) must divide over the "
           r"data axes \(dataxfsdp = 2\)"),
])
def test_gpipe_classifier_refuses_a_micro_batch_that_does_not_split(
        rows, data, match):
    # this batch shard's rows, JAX's checks of all the shards' rows
    clf = GPipeClassifier(model_preset("tiny"), _mesh(data=data), 4)
    with pytest.raises(ValueError, match=match):
        clf(torch.zeros(rows, 16, dtype=torch.long))


def test_trainer_refuses_a_micro_batch_that_does_not_split():
    with pytest.raises(ValueError, match="size 8 not divisible by n_micro=3"):
        Trainer(model_preset("tiny"), TrainConfig(train_size=32),
                task="synthetic", device="cpu", mp_mode="pipeline",
                n_micro=3)
    with pytest.raises(ValueError, match="needs n_micro"):
        Trainer(model_preset("tiny"), TrainConfig(train_size=32),
                task="synthetic", device="cpu", mp_mode="1f1b")
    with pytest.raises(SystemExit, match="--pipeline-microbatches 3"):
        train_mp.train(TINY + ["--mp-mode", "pipeline",
                               "--pipeline-microbatches", "3"])


# (stages, data, fsdp, micro) -> resolve_n_micro(n=0), worked out from
# JAX cli/train_mp.py:114-136: the deepest of 4S, 2S, S that divides the
# micro-batch with its rows divisible by data x fsdp
AUTO = [
    ((1, 1, 1, 8), 4), ((2, 1, 1, 8), 8), ((2, 2, 1, 8), 4),
    ((2, 1, 2, 8), 4), ((4, 1, 1, 8), 8), ((4, 2, 1, 8), 4),
    ((2, 4, 1, 8), 2), ((2, 2, 2, 8), 2), ((3, 1, 1, 12), 12),
    ((2, 1, 1, 6), 2), ((1, 1, 1, 96), 4), ((4, 1, 1, 2), None),
    ((4, 4, 1, 8), None), ((2, 1, 1, 3), None),
]


@pytest.mark.parametrize("case,want", AUTO)
def test_resolve_n_micro_auto_choices(case, want):
    stages, data, fsdp, micro = case
    mesh = types.SimpleNamespace(shape=dict(stage=stages, data=data,
                                            fsdp=fsdp))
    if want is None:
        with pytest.raises(SystemExit, match=(
                rf"no pipeline microbatch count in \{{4,2,1\}}x{stages} "
                rf"divides micro-batch {micro} with per-microbatch rows "
                rf"divisible by data\*fsdp={data * fsdp}")):
            train_mp.resolve_n_micro(mesh, 0, micro, "micro-batch")
    else:
        assert train_mp.resolve_n_micro(mesh, 0, micro, "micro-batch") == want


@pytest.mark.parametrize("n,data,micro,ok", [
    (4, 1, 8, True), (2, 2, 8, True), (8, 1, 8, True), (3, 1, 8, False),
    (4, 4, 8, False), (16, 1, 8, False),
])
def test_resolve_n_micro_explicit(n, data, micro, ok):
    mesh = types.SimpleNamespace(shape=dict(stage=2, data=data, fsdp=1))
    if ok:
        assert train_mp.resolve_n_micro(mesh, n, micro, "micro-batch") == n
    else:
        with pytest.raises(SystemExit, match=(
                f"--pipeline-microbatches {n}: micro-batch {micro} must "
                f"split into {n} microbatches whose size divides "
                rf"data\*fsdp={data}")):
            train_mp.resolve_n_micro(mesh, n, micro, "micro-batch")


def test_pipeline_microbatches_flag_as_jax():
    port = train_mp.build_parser()
    ref = jax_train_mp.build_parser()
    (a,) = [x for x in port._actions if x.dest == "pipeline_microbatches"]
    (b,) = [x for x in ref._actions if x.dest == "pipeline_microbatches"]
    assert (a.default, a.type, a.help) == (b.default, b.type, b.help)
    (m,) = [x for x in port._actions if x.dest == "mp_mode"]
    assert m.choices == ["branch", "stage", "pipeline", "1f1b"]
    args = port.parse_args(["--mp-mode", "1f1b",
                            "--pipeline-microbatches", "8"])
    assert (args.mp_mode, args.pipeline_microbatches) == ("1f1b", 8)


def test_stage_wire_neighbours_on_the_stage_axis():
    # ranks row-major over (data, fsdp, stage, model, seq): at data 2 x
    # stage 4, rank 6 is (data 1, stage 2) and its neighbours 5 and 7
    mesh = Mesh(shape=dict(data=2, fsdp=1, stage=4, model=1, seq=1),
                coords=dict(data=1, fsdp=0, stage=2, model=0, seq=0),
                groups={a: None for a in AXIS_NAMES})
    wire = StageWire(mesh, (2, 16, 64), torch.float32, "cpu")
    assert (wire.prev, wire.next, wire.first, wire.last) == (5, 7, False,
                                                             False)
    assert wire.exchange() == (None, None)
