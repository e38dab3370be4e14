"""Port parity, tensor parallelism over the mesh's ``model`` axis: the
PyTorch package's specs (``parallel/sharding.param_specs``, JAX
``_tp_spec`` and ``_add_fsdp``) against the JAX package's ``_leaf_spec``
leaf by leaf, the model-axis cut (``tensor_parallel``), a block's slices
run in one process against the whole block, and runs over several gloo
processes: tiny BERT at (data 2, model 2) against the JAX package's step
(JAX ``tests/test_train.py:210``) and one process, and ``train_lm --tp``
(per-layer and scanned trunks, fsdp 2 by default) against one process,
on the CPU. ``_launch`` is shared with ``tests/test_torch_ring.py``."""

import json
import os
import socket
import subprocess
import sys
import textwrap
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_training_tpu.models.bert import (
    BertForSequenceClassification as JaxBert,
)
from pytorch_distributed_training_tpu.parallel.sharding import (
    ShardingPolicy as JaxShardingPolicy,
)
from pytorch_distributed_training_tpu.parallel.sharding import _leaf_spec
from pytorch_distributed_training_tpu.train import (
    adamw_with_schedule,
    create_train_state,
)
from pytorch_distributed_training_tpu.train import (
    make_train_step as jax_make_train_step,
)
from pytorch_distributed_training_tpu.train.metrics import (
    LMMetricAccumulator as JaxLMMetricAccumulator,
)
from pytorch_distributed_training_tpu.utils.config import (
    TrainConfig as JaxTrainConfig,
)
from pytorch_distributed_training_tpu.utils.config import (
    model_preset as jax_preset,
)
from pytorch_distributed_training_tpu_torch.comms.mesh import (
    AXIS_NAMES,
    AxisShard,
)
from pytorch_distributed_training_tpu_torch.models.bert import (
    BertForSequenceClassification,
)
from pytorch_distributed_training_tpu_torch.models.convert import (
    params_from_jax,
    params_to_jax,
)
from pytorch_distributed_training_tpu_torch.models.gpt2 import GPT2LMModel
from pytorch_distributed_training_tpu_torch.parallel import (
    ShardingPolicy,
    param_placements,
    param_specs,
    tensor_parallel,
)
from pytorch_distributed_training_tpu_torch.parallel.sharding import (
    model_dims,
    placements_of,
)
from pytorch_distributed_training_tpu_torch.train.loop import Trainer
from pytorch_distributed_training_tpu_torch.utils.config import (
    TrainConfig,
    model_preset,
)
from test_torch_fsdp import _jax_path

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402


# ------------------------------------------------- specs vs _leaf_spec


def _models():
    """(name, module, scanned): the whole models JAX's tree is made of."""
    gen = lambda: torch.Generator().manual_seed(0)  # noqa: E731
    for scan in (False, True):
        tag = "-scan" if scan else ""
        yield (f"bert{tag}", BertForSequenceClassification(
            model_preset("tiny", scan_layers=scan), generator=gen()), scan)
        yield (f"gpt2{tag}", GPT2LMModel(
            model_preset("gpt2-tiny", scan_layers=scan), generator=gen()),
            scan)
    int8 = GPT2LMModel(model_preset("gpt2-tiny"), generator=gen())
    int8.cast_for_serving("int8")  # kernel_scale leaves follow kernels
    yield ("gpt2-int8", int8, False)


MODELS = {name: (m, scan) for name, m, scan in _models()}
TP_MESHES = {"d2f2m2": dict(data=2, fsdp=2, model=2), "m4": dict(model=4)}


@pytest.mark.parametrize("mesh", sorted(TP_MESHES))
@pytest.mark.parametrize("case", sorted(MODELS))
def test_tp_specs_match_jax_leaf_spec(case, mesh):
    module, scanned = MODELS[case]
    shape = {a: TP_MESHES[mesh].get(a, 1) for a in AXIS_NAMES}
    policy = dict(tp=True, fsdp=True, fsdp_min_size=128)
    shapes = {n: tuple(p.shape) for n, p in module.named_parameters()}
    got = param_specs(shapes, ShardingPolicy(**policy), shape)
    tree = params_to_jax(module.state_dict(), scan_layers=scanned)
    flat = {tuple(k.key for k in path): leaf for path, leaf in
            jax.tree_util.tree_flatten_with_path(tree)[0]}
    stand_in = types.SimpleNamespace(shape=shape)  # all _leaf_spec reads
    assert got.keys() == shapes.keys()
    for name, spec in got.items():
        path = _jax_path(name, False)
        leaf = flat[path]
        want = list(_leaf_spec([jax.tree_util.DictKey(k) for k in path],
                               leaf, JaxShardingPolicy(**policy), stand_in))
        want += [None] * (leaf.ndim - len(want))
        assert spec == tuple(want), (name, spec, want)
    on_model = [n for n, s in got.items() if "model" in s]
    # JAX's finding: the stacked trunk's shapes match no _tp_spec rule;
    # int8's column-parallel scales follow their kernels (the row-parallel
    # ones keep only the size-1 contracted dims there)
    assert len(on_model) == (0 if scanned else
                             28 if case == "gpt2-int8" else 20)
    assert param_placements(shapes, ShardingPolicy(**policy), shape) == (
        placements_of(got))


def _shard(index, size):
    return AxisShard(group=None, index=index, size=size,
                     ranks=tuple(range(size)))


def test_tp_cut_slices_and_raises_naming_both_numbers():
    # each rank keeps its contiguous heads and MLP columns; the slices
    # tile the whole leaf; heads that do not divide raise
    cfg = model_preset("tiny", compute_dtype="float32")
    whole = BertForSequenceClassification(
        cfg, generator=torch.Generator().manual_seed(0))
    shapes = {n: tuple(p.shape) for n, p in whole.named_parameters()}
    specs = param_specs(shapes, ShardingPolicy(tp=True),
                        {a: 2 if a == "model" else 1 for a in AXIS_NAMES})
    dims = model_dims(specs)
    parts = []
    for r in range(2):
        part = BertForSequenceClassification(
            cfg, generator=torch.Generator().manual_seed(0))
        assert tensor_parallel(part, specs, _shard(r, 2)) == set(dims)
        parts.append(dict(part.named_parameters()))
        attn = part.bert.layers[0].attention
        assert attn.tp_shard.index == r and attn.query.out_shape == (2, 16)
        assert attn.out.in_shape == (2, 16)
        assert part.bert.layers[0].mlp_down.in_shape == (64,)
    for name, p in whole.named_parameters():
        if name in dims:
            torch.testing.assert_close(
                torch.cat([q[name] for q in parts], dims[name]), p,
                rtol=0, atol=0)
        else:
            assert all(torch.equal(q[name], p) for q in parts)
    three = {a: 3 if a == "model" else 1 for a in AXIS_NAMES}
    with pytest.raises(ValueError, match="size 4 does not divide by the "
                                         "model axis of 3"):
        tensor_parallel(whole, param_specs(shapes, ShardingPolicy(tp=True),
                                           three), _shard(0, 3))


@pytest.mark.parametrize("m", [2, 4])
def test_tp_slices_in_one_process_equal_the_whole_block(m):
    # chip_smoke's tp-split phase at gpt2-tiny width in float32: each
    # slice's forward and backward, the row-parallel partials summed,
    # against the whole block (hidden dropout on, same seeds)
    res = chip_smoke.tp_split_check(
        model_preset("gpt2-tiny", compute_dtype="float32",
                     attention_dropout=0.0),
        m, device="cpu", batch=2, seq=16, tol=1e-5, timed=False)
    assert res["max_rel_err"] < 1e-5
    assert res["leaves"] == 16


# ---------------------------------------------------- several processes


_SCRIPT = textwrap.dedent("""
    import json, sys
    import torch
    torch.set_num_threads(1)
    from pytorch_distributed_training_tpu_torch.cli import train_dp, train_lm
    from pytorch_distributed_training_tpu_torch.comms.bootstrap import (
        shutdown)
    from pytorch_distributed_training_tpu_torch.models.convert import (
        params_to_jax, quant_to_jax)
    from pytorch_distributed_training_tpu_torch.parallel import (
        ShardingPolicy)
    from pytorch_distributed_training_tpu_torch.parallel.sharding import (
        model_dims)
    from pytorch_distributed_training_tpu_torch.train.loop import Trainer
    from pytorch_distributed_training_tpu_torch.utils.config import (
        MeshConfig, TrainConfig, model_preset)
    out, spec = sys.argv[1], json.loads(sys.argv[2])
    rate = spec.get("dropout")
    if "argv" in spec:
        cli = {"train_dp": train_dp, "train_lm": train_lm}[spec["cli"]]
        if rate is not None:  # the presets' dropout rates, set
            preset = cli.model_preset
            cli.model_preset = lambda name, **kw: preset(
                name, **dict(kw, hidden_dropout=rate,
                             attention_dropout=rate))
        t = cli.build_trainer(cli.build_parser().parse_args(spec["argv"]))
    else:
        t = Trainer(
            model_preset(spec["preset"], compute_dtype="float32",
                         hidden_dropout=rate, attention_dropout=rate,
                         attention_impl=spec.get("attention", "reference"),
                         **spec.get("quant", {})),
            TrainConfig(**spec["train"]), task=spec["task"], device="cpu",
            mesh_config=MeshConfig(**spec["mesh"]),
            policy=ShardingPolicy(tp=spec.get("tp", False),
                                  fsdp=spec.get("fsdp", False),
                                  fsdp_min_size=128))
    t.run()
    sd = t.state.module.state_dict()
    tp = (model_dims(t.specs), t.mesh.shard("model")) if t.tp_split else None
    def walk(node, flat, path=()):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, flat, path + (k,))
            else:
                flat["/".join(path + (k,))] = torch.from_numpy(v)
        return flat
    flat = walk(params_to_jax(sd, scan_layers=t.mcfg.scan_layers, tp=tp), {})
    quant = quant_to_jax(sd, scan_layers=t.mcfg.scan_layers)
    quant = {k: v.tolist() for k, v in walk(quant or {}, {}).items()}
    local = {k: v.full_tensor() if hasattr(v, "full_tensor") else v
             for k, v in sd.items()}
    rank = t.info.rank
    torch.save({"whole": flat, "local": local}, f"{out}.{rank}.pt")
    with open(f"{out}.{rank}.json", "w") as f:
        json.dump({"steps": t.step_log, "history": t.history,
                   "coords": t.mesh.coords, "tp_split": sorted(t.tp_split),
                   "quant": quant,
                   "sharded": [k for k, v in sd.items()
                               if hasattr(v, "full_tensor")]}, f)
    shutdown()
""")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch(tmp_path, runs: dict) -> dict:
    """Start every run (name -> (world size, spec)) of ``_SCRIPT`` at
    once, one process a rank; each run's per-rank records, its whole
    weights in the flax layout (every rank's gathered tree, bit-identical
    across the ranks) and each rank's local state dict."""
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
        recs, locs, whole = [], [], None
        for r in range(world):
            recs.append(json.loads((tmp_path / f"{name}.{r}.json")
                                   .read_text()))
            saved = torch.load(str(tmp_path / f"{name}.{r}.pt"))
            locs.append(saved["local"])
            if whole is None:
                whole = saved["whole"]
            assert saved["whole"].keys() == whole.keys()
            for k, v in saved["whole"].items():  # every rank, bit for bit
                assert torch.equal(v, whole[k]), (name, r, k)
        out[name] = dict(recs=recs, whole=whole, local=locs)
    return out


def assert_same_run(got, want, *, rtol, atol, norm_rtol=1e-5, steps=2):
    """``got`` (several ranks) against ``want`` (one process): the step
    losses within ``rtol`` and grad norms within ``norm_rtol`` (float32
    squares summed in another order), every rank reporting the same steps
    and history, the eval metrics within ``rtol``, and the whole weights
    within ``atol``."""
    a, b = want["recs"][0], got["recs"][0]
    assert len(a["steps"]) == len(b["steps"]) == steps
    for sa, sb in zip(a["steps"], b["steps"]):
        np.testing.assert_allclose(sb["loss"], sa["loss"], rtol=rtol)
        np.testing.assert_allclose(sb["grad_norm"], sa["grad_norm"],
                                   rtol=norm_rtol)
    metrics = [k for k in a["history"][0] if not k.startswith("samples")]
    assert list(a["history"][0]) == list(b["history"][0])
    for rec in got["recs"]:
        assert rec["steps"] == b["steps"]
        assert all(rec["history"][0][k] == b["history"][0][k]
                   for k in metrics)
    for k in metrics:
        np.testing.assert_allclose(b["history"][0][k], a["history"][0][k],
                                   rtol=rtol)
    assert got["whole"].keys() == want["whole"].keys()
    for name, w in want["whole"].items():
        torch.testing.assert_close(got["whole"][name], w, rtol=0,
                                   atol=atol, msg=name)


TRAIN = dict(num_epochs=1, train_size=32, eval_size=24, global_batch_size=16,
             micro_batch_size=8, eval_batch_size=8, warmup_steps=1,
             learning_rate=1e-3, max_grad_norm=1e-3, log_every=0)
BERT = dict(preset="tiny", task="synthetic", dropout=0.0, train=TRAIN)


def _jax_steps(n_steps=2):
    """JAX's data-parallel steps (one device: the JAX test's DP side) from
    the port's initial weights on the port's batches: the losses and the
    final params."""
    one = Trainer(model_preset("tiny", compute_dtype="float32",
                               hidden_dropout=0.0, attention_dropout=0.0),
                  TrainConfig(**TRAIN), task="synthetic", device="cpu")
    start = params_to_jax(one.state.module.state_dict())
    jcfg = JaxTrainConfig(learning_rate=1e-3, warmup_steps=1,
                          max_grad_norm=TRAIN["max_grad_norm"])
    tx, _ = adamw_with_schedule(jcfg, one.train_loader.steps_per_epoch)
    model = JaxBert(jax_preset("tiny", compute_dtype="float32",
                               hidden_dropout=0.0, attention_dropout=0.0))
    example = {"input_ids": jnp.ones((2, 16), jnp.int32),
               "attention_mask": jnp.ones((2, 16), jnp.int32),
               "token_type_ids": jnp.zeros((2, 16), jnp.int32)}
    state = create_train_state(model, tx, jax.random.key(0), example)
    params = jax.tree.map(jnp.asarray, start)
    state = state.replace(params=params, opt_state=tx.init(params))
    step = jax_make_train_step(grad_accum_steps=2)
    losses = []
    for batch in list(one.train_loader.epoch(0))[:n_steps]:
        state, m = step(state, {k: jnp.asarray(v.numpy())
                                for k, v in batch.items()})
        losses.append(float(m["loss"]))
    return losses, params_from_jax(jax.tree.map(np.asarray, state.params))


def test_tp_bert_data2_model2_equals_jax_dp_and_one_process(tmp_path):
    # (data 2 x model 2): each model rank 2 of the 4 heads and 64 of the
    # 128 MLP columns, dropout off, clipping on (the whole model's norm)
    res = _launch(tmp_path, {
        "one": (1, dict(BERT, mesh={})),
        "tp": (4, dict(BERT, mesh=dict(data=2, model=2), tp=True)),
    })
    tp, one = res["tp"], res["one"]
    assert_same_run(tp, one, rtol=1e-6, atol=1e-6)
    assert min(s["grad_norm"] for s in tp["recs"][0]["steps"]) > 1e-3
    recs = tp["recs"]
    assert [(r["coords"]["data"], r["coords"]["model"]) for r in recs] == [
        (0, 0), (0, 1), (1, 0), (1, 1)]
    split = set(recs[0]["tp_split"])
    assert len(split) == 20 and any(".mlp_up." in k for k in split)
    for name, w in tp["local"][0].items():  # replicated: bit for bit
        if name in split:
            assert not torch.equal(w, tp["local"][1][name]), name
        else:
            assert all(torch.equal(w, loc[name]) for loc in tp["local"])
    losses, want = _jax_steps()
    for s, loss in zip(recs[0]["steps"], losses):
        np.testing.assert_allclose(s["loss"], loss, rtol=2e-5)
    got = params_from_jax(_nest(tp["whole"]))
    for name, w in want.items():
        np.testing.assert_allclose(got[name].numpy(), w.numpy(), rtol=0,
                                   atol=3e-5, err_msg=name)


def _nest(flat: dict) -> dict:
    tree: dict = {}
    for path, leaf in flat.items():
        node = tree
        *head, last = path.split("/")
        for p in head:
            node = node.setdefault(p, {})
        node[last] = leaf.numpy()
    return tree


LM = ["--model", "gpt2-tiny", "--device", "cpu", "--train-size", "32",
      "--eval-size", "16", "--max-seq-length", "32", "--global-batch-size",
      "16", "--micro-batch-size", "8", "--eval-batch-size", "8",
      "--num-epochs", "1", "--log-every", "0", "--no-bf16",
      "--warmup-steps", "1", "--learning-rate", "1e-3",
      "--max-grad-norm", "0.05"]


def lm_spec(*flags):
    return dict(cli="train_lm", argv=LM + list(flags), dropout=0.0)


def test_train_lm_tp_over_gloo_equals_one_process(tmp_path):
    # --tp --no-scan-layers --mesh-model 2 over 4 ranks (fsdp 2 by
    # --mesh-fsdp -1: FSDP shards each TP slice), and --tp on the scanned
    # trunk, where the policy splits nothing and the model ranks train alike
    res = _launch(tmp_path, {
        "one_loop": (1, lm_spec("--no-scan-layers")),
        "one_scan": (1, lm_spec()),
        "tp_loop": (4, lm_spec("--tp", "--no-scan-layers", "--mesh-model",
                               "2")),
        "tp_scan": (4, lm_spec("--tp", "--mesh-model", "2")),
    })
    jax_keys = (["epoch", "train_loss", "samples_per_sec",
                 "samples_per_sec_per_chip"]
                + list(JaxLMMetricAccumulator().compute()))
    for tag in ("loop", "scan"):
        got = res[f"tp_{tag}"]
        assert list(got["recs"][0]["history"][0]) == jax_keys
        assert_same_run(got, res[f"one_{tag}"], rtol=1e-5, atol=1e-5)
        recs = got["recs"]
        assert [(r["coords"]["fsdp"], r["coords"]["model"]) for r in recs] \
            == [(0, 0), (0, 1), (1, 0), (1, 1)]
        assert recs[0]["sharded"]
    assert len(res["tp_loop"]["recs"][0]["tp_split"]) == 20
    assert res["tp_scan"]["recs"][0]["tp_split"] == []
