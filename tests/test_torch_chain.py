"""Port parity, the trainer's step options: chained steps (``chain_steps``)
against unchained ones bit for bit and against JAX's Trainer, the cadence
checks and the mid-chain resume error with JAX's messages, ``unroll_accum``'s
check and its refusal (and ``chain_steps``') under the pipeline schedules,
the new flags of the three train CLIs parsed as JAX's parse them, and the
``TrainConfig`` fields against JAX's, on the CPU."""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from pytorch_distributed_training_tpu.cli import train_dp as jax_train_dp
from pytorch_distributed_training_tpu.cli import train_lm as jax_train_lm
from pytorch_distributed_training_tpu.cli import train_mp as jax_train_mp
from pytorch_distributed_training_tpu.parallel import (
    ShardingPolicy as JaxShardingPolicy,
)
from pytorch_distributed_training_tpu.train.loop import Trainer as JaxTrainer
from pytorch_distributed_training_tpu.utils.config import (
    MeshConfig as JaxMeshConfig,
)
from pytorch_distributed_training_tpu.utils.config import (
    TrainConfig as JaxTrainConfig,
)
from pytorch_distributed_training_tpu.utils.config import (
    model_preset as jax_preset,
)
from pytorch_distributed_training_tpu_torch.cli import (
    train_dp,
    train_lm,
    train_mp,
)
from pytorch_distributed_training_tpu_torch.models.convert import (
    params_from_jax,
)
from pytorch_distributed_training_tpu_torch.train.loop import Trainer
from pytorch_distributed_training_tpu_torch.utils.config import (
    TrainConfig,
    model_preset,
)

torch.set_num_threads(2)

RUN = dict(num_epochs=1, global_batch_size=32, micro_batch_size=16,
           eval_batch_size=32, learning_rate=3e-3, warmup_steps=2,
           log_every=0, bf16=False, train_size=128, eval_size=40)
NO_DROPOUT = dict(compute_dtype="float32", hidden_dropout=0.0,
                  attention_dropout=0.0)


def _trainer(mcfg_kw=None, **kw):
    return Trainer(model_preset("tiny", **(mcfg_kw or
                                            dict(compute_dtype="float32"))),
                   TrainConfig(**dict(RUN, **kw)), task="synthetic",
                   device="cpu")


def _params(t) -> torch.Tensor:
    return torch.cat([p.detach().flatten()
                      for p in t.state.module.parameters()])


def _error(fn) -> str:
    with pytest.raises((ValueError, RuntimeError)) as e:
        fn()
    return str(e.value)


# ------------------------------------------------------------ the chain


def test_chain2_walks_the_chain1_trajectory_bit_for_bit(tmp_path):
    # dropout on: the seeds follow the step, so the chain changes nothing;
    # the chain's loss is the float32 mean of its steps' losses, its grad
    # norm the last step's, and the step records fall on chain ends
    one = _trainer(metrics_dir=str(tmp_path / "m1"))
    one.run()
    two = _trainer(chain_steps=2, metrics_dir=str(tmp_path / "m2"))
    two.run()
    assert one.state.step == two.state.step == 4
    assert torch.equal(_params(one), _params(two))
    losses = [s["loss"] for s in one.step_log]
    assert [s["step"] for s in two.step_log] == [2, 4]
    for i, s in enumerate(two.step_log):
        pair = torch.tensor(losses[2 * i:2 * i + 2], dtype=torch.float32)
        assert s["loss"] == float(pair.mean())
        assert s["grad_norm"] == one.step_log[2 * i + 1]["grad_norm"]
    np.testing.assert_allclose(two.history[0]["train_loss"],
                               one.history[0]["train_loss"], rtol=1e-6)
    assert two.history[0]["accuracy"] == one.history[0]["accuracy"]
    assert two.history[0]["samples_per_sec"] > 0
    recs = [json.loads(line) for line in
            open(os.path.join(str(tmp_path / "m2"), "metrics.jsonl"))]
    assert [r["step"] for r in recs if r["record"] == "step"] == [2, 4]


def test_chain_history_matches_jax_trainer(eight_devices):
    # JAX's Trainer at chain_steps 2 on its 8-device mesh and the port's at
    # world size 1 from the same weights, dropout off: the epoch's loss
    # (the mean of the chain means) and the eval metrics, and the weights
    # to atol 2e-5 (JAX's own bound for a chain against single steps,
    # tests/test_trainer_integration.py:263-284)
    jt = JaxTrainer(jax_preset("tiny", **NO_DROPOUT),
                    JaxTrainConfig(**RUN, chain_steps=2, guards="off"),
                    JaxMeshConfig(data=8), JaxShardingPolicy(),
                    task="synthetic")
    start = params_from_jax(jax.tree.map(np.asarray, jt.state.params))
    jh = jt.run()
    pt = _trainer(NO_DROPOUT, chain_steps=2)
    pt.state.module.load_state_dict(start)
    ph = pt.run()
    np.testing.assert_allclose(ph[0]["train_loss"], jh[0]["train_loss"],
                               rtol=1e-5)
    for k in ("accuracy", "f1"):
        np.testing.assert_allclose(ph[0][k], jh[0][k], atol=1e-6)
    want = params_from_jax(jax.tree.map(np.asarray, jt.state.params))
    got = pt.state.module.state_dict()
    for name, w in want.items():
        np.testing.assert_allclose(got[name].numpy(), w.numpy(), rtol=0,
                                   atol=2e-5, err_msg=name)


@pytest.mark.parametrize("kw,want", [
    (dict(train_size=96), "chain_steps=2 must divide steps_per_epoch=3"),
    (dict(checkpoint_every_steps=3),
     "chain_steps=2 must divide checkpoint_every_steps=3"),
    (dict(crash_at_step=3), "chain_steps=2 must divide crash_at_step=3"),
], ids=["steps_per_epoch", "checkpoint_every_steps", "crash_at_step"])
def test_chain_cadence_errors_as_jax(kw, want, eight_devices):
    got = _error(lambda: _trainer(chain_steps=2, **kw))
    jax_got = _error(lambda: JaxTrainer(
        jax_preset("tiny", compute_dtype="float32"),
        JaxTrainConfig(**dict(RUN, chain_steps=2, guards="off", **kw)),
        JaxMeshConfig(data=8), JaxShardingPolicy(), task="synthetic"))
    assert got == jax_got == want


def test_resume_inside_a_chain_raises(tmp_path):
    # a checkpoint at step 1, taken by an unchained run, resumed chained
    ck = str(tmp_path / "ck")
    t = _trainer(checkpoint_dir=ck)
    t.train_step(t.state, next(iter(t.train_loader.epoch(0))))
    t.checkpointer.save(t.state)
    t.checkpointer.close()
    for loader in t.loaders:
        loader.close()
    r = _trainer(checkpoint_dir=ck, resume=True, chain_steps=2)
    assert r.state.step == 1
    with pytest.raises(RuntimeError, match="resume step 1 is mid-chain"):
        r.run()


# ------------------------------------------------------ unroll_accum


def test_unroll_accum_is_checked_and_changes_nothing():
    assert _error(lambda: _trainer(unroll_accum="maybe")) == (
        "unroll_accum must be auto/on/off, got 'maybe'")
    runs = {}
    for mode in ("auto", "on", "off"):
        t = _trainer(unroll_accum=mode, train_size=64)
        t.run()
        runs[mode] = _params(t)
    assert torch.equal(runs["auto"], runs["on"])
    assert torch.equal(runs["auto"], runs["off"])


@pytest.mark.parametrize("kw,want", [
    (dict(chain_steps=2),
     "chain_steps > 1 is not supported with a custom train_step_factory"),
    (dict(unroll_accum="off"),
     "unroll_accum is not supported with a custom train_step_factory (the "
     "schedule owns its scan policy)"),
], ids=["chain_steps", "unroll_accum"])
@pytest.mark.parametrize("mode", ["pipeline", "1f1b"])
def test_schedules_refuse_chain_and_unroll(mode, kw, want):
    assert _error(lambda: Trainer(
        model_preset("tiny", compute_dtype="float32"),
        TrainConfig(**dict(RUN, **kw)), task="synthetic", device="cpu",
        mp_mode=mode, n_micro=2)) == want


# ------------------------------------------------------ flags and fields


NEW_FLAGS = {
    "unroll_accum": (["--unroll-accum", "off"], "off"),
    "chain_steps": (["--chain-steps", "4"], 4),
    "native_loader": (["--native-loader", "on"], "on"),
    "prefetch_depth": (["--prefetch-depth", "0"], 0),
    "profile_dir": (["--profile-dir", "/tmp/prof"], "/tmp/prof"),
    "debug_nans": (["--debug-nans"], True),
    "adam_mu_dtype": (["--adam-mu-dtype", "bfloat16"], "bfloat16"),
    "adam_nu_dtype": (["--adam-nu-dtype", "bfloat16"], "bfloat16"),
    "grad_accum_dtype": (["--grad-accum-dtype", "bfloat16"], "bfloat16"),
}


@pytest.mark.parametrize("port,jax_cli", [
    (train_dp, jax_train_dp), (train_lm, jax_train_lm),
    (train_mp, jax_train_mp)], ids=["train_dp", "train_lm", "train_mp"])
def test_new_flags_parse_as_jax(port, jax_cli):
    got = vars(port.build_parser().parse_args([]))
    want = vars(jax_cli.build_parser().parse_args([]))
    assert {f: got[f] for f in NEW_FLAGS} == {f: want[f] for f in NEW_FLAGS}
    for f, (argv, value) in NEW_FLAGS.items():
        a = vars(port.build_parser().parse_args(argv))[f]
        b = vars(jax_cli.build_parser().parse_args(argv))[f]
        assert a == b == value, f
    assert vars(port.build_parser().parse_args(["--no-debug-nans"]))[
        "debug_nans"] is False


def test_train_config_has_every_jax_field_but_four():
    port = {f.name: f.default for f in dataclasses.fields(TrainConfig)}
    jax_fields = {f.name: f.default
                  for f in dataclasses.fields(JaxTrainConfig)}
    assert set(jax_fields) - set(port) == {"prng_impl"}
    assert set(port) <= set(jax_fields)
    for name, default in port.items():
        assert default == jax_fields[name], name
    assert (port["native_loader"], port["prefetch_depth"],
            port["chain_steps"], port["unroll_accum"]) == ("auto", 2, 1,
                                                           "auto")
