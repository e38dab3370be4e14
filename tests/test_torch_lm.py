"""Port parity, causal-LM training: the PyTorch package's GPT-2 training
path (flash attention in the model, the LM data, loss, train and eval
steps, metrics, the Trainer and ``cli/train_lm``) against the JAX package
on the same numpy inputs and bridged weights, on the CPU (every kernel
through its plain version)."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pytorch_distributed_training_tpu.data import synthetic as jax_synthetic
from pytorch_distributed_training_tpu.data.glue import (
    load_task_arrays as jax_load_task_arrays,
)
from pytorch_distributed_training_tpu.models.gpt2 import (
    GPT2LMModel as JaxGPT2,
)
from pytorch_distributed_training_tpu.ops.flash_attention import (
    tpu_interpret_mode,
)
from pytorch_distributed_training_tpu.train import (
    adamw_with_schedule,
    create_train_state,
)
from pytorch_distributed_training_tpu.train import (
    make_eval_step as jax_make_eval_step,
)
from pytorch_distributed_training_tpu.train import (
    make_train_step as jax_make_train_step,
)
from pytorch_distributed_training_tpu.train.metrics import (
    LMMetricAccumulator as JaxLMMetricAccumulator,
)
from pytorch_distributed_training_tpu.train.step import (
    _lm_shift_and_mask as jax_lm_shift_and_mask,
)
from pytorch_distributed_training_tpu.utils.config import (
    TrainConfig as JaxTrainConfig,
)
from pytorch_distributed_training_tpu.utils.config import (
    model_preset as jax_preset,
)
from pytorch_distributed_training_tpu_torch.cli import train_lm
from pytorch_distributed_training_tpu_torch.data import synthetic
from pytorch_distributed_training_tpu_torch.data.glue import load_task_arrays
from pytorch_distributed_training_tpu_torch.models import bert
from pytorch_distributed_training_tpu_torch.models.convert import (
    params_from_jax,
)
from pytorch_distributed_training_tpu_torch.models.gpt2 import GPT2LMModel
from pytorch_distributed_training_tpu_torch.train.metrics import (
    LMMetricAccumulator,
)
from pytorch_distributed_training_tpu_torch.train.optim import (
    AdamW,
    linear_warmup_schedule,
)
from pytorch_distributed_training_tpu_torch.train.state import (
    create_train_state as port_train_state,
)
from pytorch_distributed_training_tpu_torch.train.step import (
    causal_lm_loss,
    lm_shift_and_mask,
    make_eval_step,
    make_train_step,
)
from pytorch_distributed_training_tpu_torch.train.loop import Trainer
from pytorch_distributed_training_tpu_torch.utils.config import (
    TrainConfig,
    model_preset,
)

torch.set_num_threads(2)

NO_DROPOUT = dict(compute_dtype="float32", hidden_dropout=0.0,
                  attention_dropout=0.0)


def _lm_batch(rng, lead, seq=32, vocab=1024, padded=True):
    """LM rows of shape ``lead + (seq,)``; with ``padded``, ragged tails."""
    ids = rng.integers(0, vocab, (*lead, seq)).astype(np.int32)
    lens = (rng.integers(seq // 2, seq + 1, lead) if padded
            else np.full(lead, seq))
    mask = (np.arange(seq) < lens[..., None]).astype(np.int32)
    return {"input_ids": ids, "attention_mask": mask}


def _jax_state(attention_impl, tcfg=None, total_steps=10):
    model = JaxGPT2(jax_preset("gpt2-tiny", attention_impl=attention_impl,
                               **NO_DROPOUT))
    tx, _ = adamw_with_schedule(tcfg or JaxTrainConfig(), total_steps)
    example = {"input_ids": jnp.ones((2, 32), jnp.int32),
               "attention_mask": jnp.ones((2, 32), jnp.int32)}
    return create_train_state(model, tx, jax.random.key(0), example)


def _port_model(params, attention_impl="flash"):
    model = GPT2LMModel(model_preset("gpt2-tiny",
                                     attention_impl=attention_impl,
                                     **NO_DROPOUT))
    model.load_state_dict(params_from_jax(params))
    return model


def _jax_lm_loss(apply_fn, params, batch):
    logits = apply_fn({"params": params}, batch["input_ids"],
                      batch["attention_mask"])
    targets, mask = jax_lm_shift_and_mask(batch)
    ce = optax.softmax_cross_entropy_with_integer_labels(
        logits.astype(jnp.float32), targets)
    return (ce * mask).sum() / jnp.maximum(mask.sum(), 1.0)


# ------------------------------------------------------------------ model


def test_gpt2_flash_loss_and_every_gradient_match_flax():
    # case 6: gpt2-tiny with attention_impl="flash" on both sides (the
    # JAX kernels in interpret mode; S 32 takes the whole-sequence pair),
    # dropout 0, float32, padded tails
    state = _jax_state("flash")
    params = jax.tree.map(np.asarray, state.params)
    batch = _lm_batch(np.random.default_rng(0), (3,))
    jbatch = jax.tree.map(jnp.asarray, batch)
    with tpu_interpret_mode():
        want_loss, want_grads = jax.value_and_grad(
            lambda p: _jax_lm_loss(state.apply_fn, p, jbatch))(state.params)
    want_grads = params_from_jax(jax.tree.map(np.asarray, want_grads))
    model = _port_model(params)
    micro = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss = causal_lm_loss(model(micro["input_ids"],
                                micro["attention_mask"]), micro)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                               rtol=1e-6)
    grads = dict(model.named_parameters())
    assert grads.keys() == want_grads.keys()
    for name, want in want_grads.items():
        np.testing.assert_allclose(grads[name].grad.numpy(), want.numpy(),
                                   rtol=1e-4, atol=1e-6, err_msg=name)


def test_gpt2_dropout_sites_and_serving_signature():
    # the training signature takes token_type_ids and ignores it; a seed
    # drops (hidden and probs), None is deterministic; the serving
    # engine's keyword call still works
    torch.manual_seed(0)
    cfg = model_preset("gpt2-tiny", compute_dtype="float32",
                       attention_impl="flash")
    model = GPT2LMModel(cfg, generator=torch.Generator().manual_seed(1))
    ids = torch.from_numpy(_lm_batch(np.random.default_rng(1), (2,),
                                     padded=False)["input_ids"])
    with torch.no_grad():
        a = model(ids)
        b = model(ids, None, torch.zeros_like(ids))
        c = model(ids, dropout_seed=7)
        d = model(ids, dropout_seed=7)
        e = model(ids, position_ids=torch.arange(32)[None].expand(2, 32))
    assert torch.equal(a, b) and torch.equal(a, e)
    assert torch.equal(c, d) and not torch.allclose(a, c)


def test_flash_branch_stays_out_of_checkpoint(monkeypatch):
    # case 10: attention_remat recomputes only the "reference" core, as
    # the JAX package's models/bert.py applies it
    calls = []

    def spy(fn, *args, **kw):
        calls.append(fn)
        return fn(*args)

    monkeypatch.setattr(bert, "checkpoint", spy)
    x = torch.randn(2, 16, 64, requires_grad=True)
    for impl, expect in (("flash", 0), ("reference", 1)):
        calls.clear()
        cfg = model_preset("tiny", compute_dtype="float32",
                           attention_impl=impl)
        assert cfg.attention_remat
        attn = bert.BertSelfAttention(cfg)
        attn(x, None, dropout_seed=3).sum().backward()
        assert len(calls) == expect, impl


# ----------------------------------------------------------- train steps


def test_three_lm_train_steps_match_jax_make_train_step():
    # case 8: accumulation 2, dropout off, float32; the port's flash
    # (plain versions on the CPU) against the JAX einsum attention.
    # warmup_steps=1 so updates 2 and 3 move; lr 1e-3 so they move well
    # past the tolerance.
    jcfg = JaxTrainConfig(learning_rate=1e-3, warmup_steps=1)
    state = _jax_state("reference", jcfg)
    start = params_from_jax(jax.tree.map(np.asarray, state.params))
    model = _port_model(jax.tree.map(np.asarray, state.params))
    opt = AdamW(model.parameters(), linear_warmup_schedule(1e-3, 1, 10))
    pstate = port_train_state(model, opt, seed=0)
    jstep = jax_make_train_step(grad_accum_steps=2, objective="causal_lm")
    pstep = make_train_step(grad_accum_steps=2, objective="causal_lm")
    rng = np.random.default_rng(0)
    for _ in range(3):
        batch = _lm_batch(rng, (2, 4))
        state, jm = jstep(state, jax.tree.map(jnp.asarray, batch))
        pm = pstep(pstate, {k: torch.from_numpy(v) for k, v in batch.items()})
        np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(pm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-5)
    want = params_from_jax(jax.tree.map(np.asarray, state.params))
    got = model.state_dict()
    moved = 0.0
    for name, w in want.items():
        np.testing.assert_allclose(got[name].numpy(), w.numpy(), rtol=0,
                                   atol=1e-5, err_msg=name)
        moved = max(moved, float((w - start[name]).abs().max()))
    assert moved > 1e-3


# ------------------------------------------------------- data and metrics


def test_lm_data_shift_mask_eval_counts_and_metrics_match_jax():
    # case 7
    for kw in (dict(seed=42), dict(seed=7, order=2, row_seed=9)):
        a = synthetic.synthetic_lm_task(20, max_length=24, vocab_size=1024,
                                        **kw)
        b = jax_synthetic.synthetic_lm_task(20, max_length=24,
                                            vocab_size=1024, **kw)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
    for split in ("train", "validation"):
        a, na = load_task_arrays("lm", split, max_length=16, vocab_size=1024,
                                 synthetic_sizes=(12, 8))
        b, nb = jax_load_task_arrays("lm", split, max_length=16,
                                     vocab_size=1024,
                                     synthetic_sizes=(12, 8))
        assert na == nb == 0 and a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])

    batch = _lm_batch(np.random.default_rng(3), (6,), seq=16)
    batch["valid"] = (np.arange(6) < 4).astype(np.int32)
    jt, jm = jax_lm_shift_and_mask(jax.tree.map(jnp.asarray, batch))
    pt, pm = lm_shift_and_mask({k: torch.from_numpy(v)
                                for k, v in batch.items()})
    np.testing.assert_array_equal(pt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(pm.numpy(), np.asarray(jm))

    state = _jax_state("reference")
    model = _port_model(jax.tree.map(np.asarray, state.params))
    pstate = port_train_state(model, AdamW(model.parameters(), lambda k: 0.0),
                              seed=0)
    batch = _lm_batch(np.random.default_rng(4), (6,))
    batch["valid"] = (np.arange(6) < 5).astype(np.int32)
    want = jax_make_eval_step(objective="causal_lm")(
        state, jax.tree.map(jnp.asarray, batch))
    got = make_eval_step("causal_lm")(
        pstate, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert want.keys() == got.keys()
    np.testing.assert_allclose(float(got["nll_sum"]), float(want["nll_sum"]),
                               rtol=1e-5)
    for k in ("token_count", "token_correct"):
        assert float(got[k]) == float(want[k]), k
    for counts in ({k: float(v) for k, v in want.items()},
                   dict(nll_sum=3100.0, token_count=100.0,
                        token_correct=7.0),
                   dict(nll_sum=0.0, token_count=0.0, token_correct=0.0)):
        a, b = LMMetricAccumulator(), JaxLMMetricAccumulator()
        a.update(counts)
        b.update(counts)
        assert a.compute() == b.compute()


# ---------------------------------------------------------- entry points


def test_train_lm_cli_runs_an_epoch_with_the_jax_history_keys(tmp_path):
    # case 9: the JAX trainer's record layout (epoch, train loss, rates,
    # then the eval metrics of LMMetricAccumulator)
    jax_keys = (["epoch", "train_loss", "samples_per_sec",
                 "samples_per_sec_per_chip"]
                + list(JaxLMMetricAccumulator().compute()))
    out = tmp_path / "history.json"
    history = train_lm.main([
        "--model", "gpt2-tiny", "--device", "cpu", "--attention", "flash",
        "--train-size", "32", "--eval-size", "20", "--max-seq-length", "32",
        "--global-batch-size", "16", "--micro-batch-size", "8",
        "--eval-batch-size", "8", "--num-epochs", "1", "--log-every", "1",
        "--history-out", str(out),
    ])
    assert len(history) == 1 and list(history[0]) == jax_keys
    rec = history[0]
    assert np.isfinite(rec["train_loss"]) and rec["samples_per_sec"] > 0
    assert rec["perplexity"] > 1.0 and 0.0 <= rec["token_accuracy"] <= 1.0
    assert json.loads(out.read_text()) == history


def test_trainer_refuses_a_mismatched_objective():
    tcfg = TrainConfig(num_epochs=1, train_size=16, eval_size=8,
                       global_batch_size=8, micro_batch_size=8)
    with pytest.raises(ValueError, match="causal=False"):
        Trainer(model_preset("tiny"), tcfg, task="lm", device="cpu")
    with pytest.raises(ValueError, match="causal=True"):
        Trainer(model_preset("gpt2-tiny"), tcfg, task="synthetic",
                device="cpu")
