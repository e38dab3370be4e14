"""Port parity, remat: per-layer remat (``remat``, ``remat_policy``) and MLP
remat (``remat_mlp``) in the PyTorch package (``models/bert.remat_call``,
``call_layer``) against the same runs without remat, and against the JAX
package's steps with the same settings, on the CPU.

Tolerances: bit for bit against no remat (losses, every gradient, the
delayed-int8 amaxes; dropout on through the kernels' plain versions, whose
masks are keyed by seed and element index); rtol = atol = 1e-6 against
JAX on bridged float32 weights with dropout off, JAX's own tolerance for
its remat policies (``tests/test_models.py``
``test_remat_policies_preserve_gradients``). Cases: BERT and GPT-2, the
per-layer and the scanned trunk, native and delayed-int8 matmuls, the
TriBert branches and the stage split in one process, and over gloo FSDP
at fsdp 2, TP at model 2 (its recomputed all-reduces counted) and the
GPipe and 1F1B schedules at stage 2 with delayed int8."""

import json
import os
import socket
import subprocess
import sys
import textwrap
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_training_tpu.models.bert import (
    BertForSequenceClassification as JaxBert,
)
from pytorch_distributed_training_tpu.models.gpt2 import GPT2LMModel as JaxGPT2
from pytorch_distributed_training_tpu.utils.config import (
    model_preset as jax_preset,
)
from pytorch_distributed_training_tpu_torch.cli import train_lm, train_mp
from pytorch_distributed_training_tpu_torch.models.bert import (
    BertForSequenceClassification,
)
from pytorch_distributed_training_tpu_torch.models.branch import (
    BranchEnsembleClassifier,
)
from pytorch_distributed_training_tpu_torch.models.convert import (
    params_from_jax,
    params_to_jax,
)
from pytorch_distributed_training_tpu_torch.models.gpt2 import GPT2LMModel
from pytorch_distributed_training_tpu_torch.utils.config import model_preset

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODELS = {"bert": ("tiny", BertForSequenceClassification, JaxBert),
          "gpt2": ("gpt2-tiny", GPT2LMModel, JaxGPT2)}
SETTINGS = {
    "nothing": dict(remat=True),
    "dots": dict(remat=True, remat_policy="dots"),
    "weight_dots": dict(remat=True, remat_policy="weight_dots"),
    "mlp": dict(remat_mlp=True),
}
DELAYED = dict(matmul_impl="int8_full", quant_delayed=True,
               quant_delayed_grads=True)


def _cases():
    for kind in sorted(MODELS):
        for scan in (False, True):
            for quant in ("native", "delayed"):
                for name in SETTINGS:
                    if name == "mlp" and kind == "bert":
                        continue  # remat_mlp is the GPT-2 block's
                    yield kind, scan, quant, name


def _ids(seed, batch=2, seq=16):
    return torch.from_numpy(np.random.default_rng(seed).integers(
        1, 1000, (batch, seq)))


def _two_microbatches(kind, scan, quant, **setting):
    """Two microbatches' forward and backward, dropout on (BERT through
    reference attention, whose core ``attention_remat`` checkpoints inside
    the layer's checkpoint; GPT-2 through the flash plain versions): the
    losses, the accumulated gradients and every buffer (the delayed
    amaxes) after them."""
    preset, cls, _ = MODELS[kind]
    cfg = model_preset(
        preset, compute_dtype="float32", scan_layers=scan,
        attention_impl="reference" if kind == "bert" else "flash",
        **(DELAYED if quant == "delayed" else {}), **setting)
    model = cls(cfg, generator=torch.Generator().manual_seed(0))
    losses = []
    for m in range(2):
        out = model(_ids(m), dropout_seed=100 + m)
        loss = (out.float() ** 2).mean()
        loss.backward()
        losses.append(loss.detach())
    return (losses, {n: p.grad for n, p in model.named_parameters()},
            dict(model.named_buffers()))


@pytest.fixture(scope="module")
def baselines():
    cache = {}

    def get(kind, scan, quant):
        key = (kind, scan, quant)
        if key not in cache:
            cache[key] = _two_microbatches(kind, scan, quant)
        return cache[key]

    return get


@pytest.mark.parametrize("kind,scan,quant,setting", list(_cases()))
def test_remat_bit_equal_to_no_remat(baselines, kind, scan, quant, setting):
    want = baselines(kind, scan, quant)
    got = _two_microbatches(kind, scan, quant, **SETTINGS[setting])
    for a, b in zip(got[0], want[0]):
        assert torch.equal(a, b)
    for part in (1, 2):  # gradients, then buffers (the delayed amaxes)
        assert got[part].keys() == want[part].keys()
        for name in want[part]:
            assert torch.equal(got[part][name], want[part][name]), name
    if quant == "delayed":
        assert any("amax" in n and b.abs().sum() > 0
                   for n, b in got[2].items())


# ------------------------------------------------------------- against JAX


def _jax_grads(kind, scan, setting, ids, mask):
    preset, _, jax_cls = MODELS[kind]
    cfg = jax_preset(preset, compute_dtype="float32", hidden_dropout=0.0,
                     attention_dropout=0.0, attention_impl="reference",
                     scan_layers=scan, **setting)
    model = jax_cls(cfg)
    params = model.init(jax.random.key(0), jnp.asarray(ids))["params"]

    def loss(p):
        return jnp.mean(model.apply({"params": p}, ids, mask) ** 2)

    return (jax.tree.map(np.asarray, params),
            jax.tree.map(np.asarray, jax.grad(loss)(params)))


@pytest.mark.parametrize("kind,scan,setting", sorted(
    {(k, s, n) for k, s, _, n in _cases()}))
def test_remat_matches_jax_remat(kind, scan, setting):
    ids = np.asarray(np.arange(2 * 16).reshape(2, 16) % 50, np.int32)
    mask = np.ones_like(ids)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        params, want = _jax_grads(kind, scan, SETTINGS[setting], ids, mask)
    preset, cls, _ = MODELS[kind]
    model = cls(model_preset(preset, compute_dtype="float32",
                             hidden_dropout=0.0, attention_dropout=0.0,
                             attention_impl="reference", scan_layers=scan,
                             **SETTINGS[setting]))
    model.load_state_dict(params_from_jax(params, scan_layers=scan))
    out = model(torch.from_numpy(ids).long(), torch.from_numpy(mask))
    (out ** 2).mean().backward()
    got = params_to_jax({n: p.grad for n, p in model.named_parameters()},
                        scan_layers=scan)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)


def test_remat_config_checks_match_jax():
    from pytorch_distributed_training_tpu.utils.config import (
        ModelConfig as JaxModelConfig,
    )
    from pytorch_distributed_training_tpu_torch.utils.config import (
        ModelConfig,
    )

    for cls in (JaxModelConfig, ModelConfig):
        with pytest.raises(ValueError, match="remat_policy must be "
                                             "nothing/dots/weight_dots"):
            cls(remat=True, remat_policy="bogus")
        with pytest.warns(UserWarning, match="has no effect without "
                                             "remat=True"):
            cls(remat_policy="weight_dots")
        with pytest.warns(UserWarning, match="redundant under remat=True"):
            cls(remat=True, remat_mlp=True)
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            cls(remat=True, remat_policy="dots")
            cls(remat_mlp=True)


def test_train_lm_remat_flags_as_jax():
    from pytorch_distributed_training_tpu.cli import train_lm as jax_cli

    for argv in ([], ["--remat", "--remat-policy", "weight_dots"],
                 ["--remat-mlp"]):
        got, want = (vars(c.build_parser().parse_args(argv))
                     for c in (train_lm, jax_cli))
        for flag in ("remat", "remat_policy", "remat_mlp"):
            assert got[flag] == want[flag], (argv, flag)
    with pytest.raises(SystemExit):
        train_lm.build_parser().parse_args(["--remat-policy", "bogus"])


# -------------------------------------------------- branches, stage split


def test_remat_tribert_branches_bit_equal():
    def run(**setting):
        cfg = model_preset("tiny", compute_dtype="float32", **DELAYED,
                           **setting)
        model = BranchEnsembleClassifier(cfg, 3, seed=0)
        out = model(_ids(3), dropout_seed=7)
        (out ** 2).mean().backward()
        return ({n: p.grad for n, p in model.named_parameters()},
                dict(model.named_buffers()))

    want = run()
    for setting in ("nothing", "dots"):
        got = run(**SETTINGS[setting])
        for part in (0, 1):
            for name in want[part]:
                assert torch.equal(got[part][name], want[part][name]), name


_TINY_MP = ["--model", "tiny", "--task", "synthetic", "--device", "cpu",
            "--train-size", "32", "--eval-size", "16", "--global-batch-size",
            "16", "--micro-batch-size", "8", "--num-epochs", "1",
            "--log-every", "0", "--no-bf16"]


def _trainer(cli, argv, **setting):
    preset = cli.model_preset
    cli.model_preset = lambda name, **kw: preset(name, **dict(kw, **setting))
    try:
        t = cli.build_trainer(cli.build_parser().parse_args(argv))
    finally:
        cli.model_preset = preset
    t.run()
    return t


def test_remat_stage_mode_bit_equal():
    """``train_mp --mp-mode stage`` at world 1: the stage model's layer run
    (``run_layers(first=lo)``) under remat, delayed int8 on, trained
    bit-equal to no remat (losses, grad norms, weights, amaxes)."""
    argv = _TINY_MP + ["--mp-mode", "stage", "--matmul-impl", "int8_full",
                       "--quant-delayed"]
    want = _trainer(train_mp, argv)
    got = _trainer(train_mp, argv, remat=True, remat_policy="weight_dots")
    assert got.step_log == want.step_log
    a, b = got.state.module.state_dict(), want.state.module.state_dict()
    for name in b:
        assert torch.equal(a[name], b[name]), name


# ------------------------------------------------------------ over gloo


_SCRIPT = textwrap.dedent("""
    import json, sys
    import torch
    import torch.distributed as dist
    from pytorch_distributed_training_tpu_torch.cli import train_lm, train_mp
    from pytorch_distributed_training_tpu_torch.comms.bootstrap import (
        shutdown)


    def main(out, spec):
        cli = {"train_lm": train_lm, "train_mp": train_mp}[spec["cli"]]
        over = spec.get("over", {})
        preset = cli.model_preset
        cli.model_preset = lambda name, **kw: preset(name,
                                                     **dict(kw, **over))
        calls = {"all_reduce": 0}
        all_reduce = dist.all_reduce

        def counted(*a, **k):
            calls["all_reduce"] += 1
            return all_reduce(*a, **k)

        dist.all_reduce = counted
        t = cli.build_trainer(cli.build_parser().parse_args(spec["argv"]))
        t.run()
        sd = t.state.module.state_dict()
        local = {k: v.to_local() if hasattr(v, "to_local") else v
                 for k, v in sd.items()}
        torch.save(local, f"{out}.{t.info.rank}.pt")
        with open(f"{out}.{t.info.rank}.json", "w") as f:
            json.dump({"steps": t.step_log, "calls": calls}, f)


    torch.set_num_threads(1)
    # every object holding the group is gone before it is destroyed
    main(sys.argv[1], json.loads(sys.argv[2]))
    shutdown()
""")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch(tmp_path, runs: dict, world: int) -> dict:
    """Every run (name -> spec) of ``_SCRIPT`` at ``world`` ranks, all at
    once; each run's per-rank records and local state dicts."""
    base = dict(os.environ, CUDA_VISIBLE_DEVICES="", MASTER_ADDR="127.0.0.1",
                GLOO_SOCKET_IFNAME="lo", PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = []
    for name, spec in runs.items():
        port = str(_free_port())
        for r in range(world):
            env = dict(base, MASTER_PORT=port, WORLD_SIZE=str(world),
                       RANK=str(r), LOCAL_RANK=str(r))
            procs.append(subprocess.Popen(
                [sys.executable, "-c", _SCRIPT, str(tmp_path / name),
                 json.dumps(spec)], cwd=REPO, env=env,
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
    return {name: [(json.loads((tmp_path / f"{name}.{r}.json").read_text()),
                    torch.load(str(tmp_path / f"{name}.{r}.pt")))
                   for r in range(world)] for name in runs}


_LM = ["--model", "gpt2-tiny", "--device", "cpu", "--train-size", "32",
       "--eval-size", "16", "--max-seq-length", "32", "--global-batch-size",
       "16", "--micro-batch-size", "4", "--eval-batch-size", "8",
       "--num-epochs", "1", "--log-every", "0", "--no-bf16",
       "--warmup-steps", "1", "--learning-rate", "1e-3",
       "--max-grad-norm", "0.05"]
_PIPE = _TINY_MP + ["--mesh-data", "1", "--mesh-stage", "2",
                    "--pipeline-microbatches", "2", "--matmul-impl",
                    "int8_full", "--quant-delayed"]
# name -> (plain run, remat run); dropout at the presets' 0.1 throughout
GLOO = {
    "fsdp2": (dict(cli="train_lm", argv=_LM),
              dict(cli="train_lm", argv=_LM + ["--remat"])),
    "fsdp2_mlp": (dict(cli="train_lm", argv=_LM),
                  dict(cli="train_lm", argv=_LM + ["--remat-mlp"])),
    "tp2": (dict(cli="train_lm", argv=_LM + ["--tp", "--no-scan-layers",
                                             "--mesh-model", "2"]),
            dict(cli="train_lm", argv=_LM + ["--tp", "--no-scan-layers",
                                             "--mesh-model", "2", "--remat",
                                             "--remat-policy", "dots"])),
    "gpipe2": (dict(cli="train_mp", argv=_PIPE + ["--mp-mode", "pipeline"]),
               dict(cli="train_mp", argv=_PIPE + ["--mp-mode", "pipeline"],
                    over=dict(remat=True))),
    "1f1b2": (dict(cli="train_mp", argv=_PIPE + ["--mp-mode", "1f1b"]),
              dict(cli="train_mp", argv=_PIPE + ["--mp-mode", "1f1b"],
                   over=dict(remat=True))),
}


@pytest.mark.parametrize("case", sorted(GLOO))
def test_remat_over_gloo_bit_equal(tmp_path, case):
    """Two gloo ranks, with and without remat: every step's loss and grad
    norm and each rank's final local state (FSDP shards, TP slices,
    stages, the delayed amaxes) bit-equal. Under FSDP the recompute runs
    inside the unit's backward, where its parameters are gathered again;
    under TP it repeats the row-parallel all-reduce of the attention's
    output projection, one a layer a microbatch (the recompute stops at
    the last tensor the backward needs, ``mlp_down``'s input, so the MLP's
    all-reduce is not run again)."""
    plain, remat = GLOO[case]
    res = _launch(tmp_path, {"plain": plain, "remat": remat}, world=2)
    for (got, got_sd), (want, want_sd) in zip(res["remat"], res["plain"]):
        assert got["steps"] == want["steps"]
        assert len(want["steps"]) == 2
        assert got_sd.keys() == want_sd.keys()
        for name in want_sd:
            assert torch.equal(got_sd[name], want_sd[name]), name
        extra = got["calls"]["all_reduce"] - want["calls"]["all_reduce"]
        if case == "tp2":
            # 2 layers x 1 recomputed site x 4 microbatches x 2 steps
            assert extra == 2 * 1 * 4 * 2
        else:
            assert extra == 0
