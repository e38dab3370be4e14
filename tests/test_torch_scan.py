"""Port parity, the scanned trunk: the PyTorch package's ``ScannedLayers``
(``layers_scan``) BERT and GPT-2 against the JAX models with
``scan_layers=True`` (logits and gradients), the ``layers_scan`` weight
bridge both ways, and scanned against unscanned in the port bit for bit,
down to training runs, on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_training_tpu.models.bert import (
    BertForSequenceClassification as JaxBert,
)
from pytorch_distributed_training_tpu.models.gpt2 import GPT2LMModel as JaxGPT2
from pytorch_distributed_training_tpu.models.relayout import (
    stack_layer_params,
    unstack_scanned_params,
)
from pytorch_distributed_training_tpu.utils.config import (
    model_preset as jax_preset,
)
from pytorch_distributed_training_tpu_torch.cli import train_lm
from pytorch_distributed_training_tpu_torch.models.bert import (
    BertForSequenceClassification,
    ScannedLayers,
)
from pytorch_distributed_training_tpu_torch.models.convert import (
    params_from_jax,
    params_to_jax,
)
from pytorch_distributed_training_tpu_torch.models.gpt2 import GPT2LMModel
from pytorch_distributed_training_tpu_torch.train.loop import Trainer
from pytorch_distributed_training_tpu_torch.utils.config import (
    TrainConfig,
    model_preset,
)

torch.set_num_threads(2)

MODELS = {
    "bert": ("tiny", JaxBert, BertForSequenceClassification),
    "gpt2": ("gpt2-tiny", JaxGPT2, GPT2LMModel),
}


def _batch(kind, seed=0, batch=3, seq=16):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 1024, (batch, seq)).astype(np.int32)
    mask = np.ones_like(ids)
    mask[1, 11:] = 0
    return ids, mask


def _jax_model(kind, scan_layers=True):
    preset, jax_cls, _ = MODELS[kind]
    cfg = jax_preset(preset, compute_dtype="float32", hidden_dropout=0.0,
                     attention_dropout=0.0, attention_impl="reference",
                     scan_layers=scan_layers)
    ids = jnp.ones((2, 16), jnp.int32)
    params = jax_cls(cfg).init(jax.random.key(1), ids, ids)["params"]
    return jax_cls(cfg), jax.tree.map(np.asarray, params)


def _port_model(kind, scan_layers=True, seed=0, **over):
    preset, _, cls = MODELS[kind]
    cfg = model_preset(preset, compute_dtype=over.pop("compute_dtype",
                                                      "float32"),
                       scan_layers=scan_layers, **over)
    return cls(cfg, generator=torch.Generator().manual_seed(seed))


@pytest.mark.parametrize("kind", sorted(MODELS))
def test_scanned_logits_and_grads_match_jax_scan(kind):
    # atol 1e-5, as the JAX package pins its loop against its scan; the
    # loss weighs the logits by random w / sqrt(n), so gradients are O(1)
    jmodel, params = _jax_model(kind)
    ids, mask = _batch(kind)
    shape = np.asarray(jmodel.apply({"params": params}, ids, mask)).shape
    w = (np.random.default_rng(5).standard_normal(shape)
         / np.sqrt(np.prod(shape))).astype(np.float32)

    def loss(p):
        return jnp.sum(jmodel.apply({"params": p}, ids, mask) * w)

    want_logits = np.asarray(jmodel.apply({"params": params}, ids, mask))
    want_grads = jax.tree.map(np.asarray, jax.grad(loss)(params))
    model = _port_model(kind, hidden_dropout=0.0, attention_dropout=0.0,
                        attention_impl="reference")
    model.load_state_dict(params_from_jax(params, scan_layers=True))
    logits = model(torch.from_numpy(ids).long(), torch.from_numpy(mask))
    np.testing.assert_allclose(logits.detach().numpy(), want_logits, rtol=0,
                               atol=1e-5)
    (logits * torch.from_numpy(w)).sum().backward()
    got = params_to_jax({n: p.grad for n, p in model.named_parameters()},
                        scan_layers=True)
    assert jax.tree.structure(got) == jax.tree.structure(want_grads)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want_grads)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)


@pytest.mark.parametrize("kind", sorted(MODELS))
def test_layers_scan_bridge_both_ways(kind):
    _, scanned = _jax_model(kind)
    unscanned = jax.tree.map(np.asarray, unstack_scanned_params(scanned))
    model = _port_model(kind)
    own = model.state_dict()
    for tree in (scanned, unscanned):  # either flax trunk -> the scanned one
        sd = params_from_jax(tree, scan_layers=True)
        assert {k: v.shape for k, v in sd.items()} == {
            k: v.shape for k, v in own.items()}
        model.load_state_dict(sd)
    flat = params_from_jax(scanned)  # -> per-layer entries
    assert not any("layers_scan" in k for k in flat)
    for scan, want in ((True, scanned), (False, unscanned)):
        back = params_to_jax(model.state_dict(), scan_layers=scan)
        assert jax.tree.structure(back) == jax.tree.structure(want)
        for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(want)):
            np.testing.assert_array_equal(a, b)
    # an unscanned port dict stacks back to the scanned tree too
    restacked = params_to_jax(flat, scan_layers=True)
    for a, b in zip(jax.tree.leaves(restacked), jax.tree.leaves(scanned)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        jax.tree.leaves(stack_layer_params(unscanned))[0],
        jax.tree.leaves(scanned)[0])


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", sorted(MODELS))
def test_scanned_equals_unscanned_bit_for_bit(kind, compute_dtype):
    # one generator, dropout on: the same logits and gradients
    over = dict(compute_dtype=compute_dtype)
    loop = _port_model(kind, scan_layers=False, seed=3, **dict(over))
    scan = _port_model(kind, scan_layers=True, seed=3, **dict(over))
    trunk = scan.bert.layers_scan if kind == "bert" else scan.layers_scan
    assert isinstance(trunk, ScannedLayers) and trunk.num_layers == 2
    before = dict(scan.named_parameters())
    ids, mask = (torch.from_numpy(a).long() for a in _batch(kind, seed=2))
    a = loop(ids, mask, dropout_seed=11)
    b = scan(ids, mask, dropout_seed=11)
    assert torch.equal(a, b)
    a.float().square().sum().backward()
    b.float().square().sum().backward()
    after = dict(scan.named_parameters())
    assert all(after[k] is before[k] for k in before)  # put back
    want = params_from_jax(params_to_jax(
        {n: p.grad for n, p in loop.named_parameters()}), scan_layers=True)
    for name, p in scan.named_parameters():
        assert torch.equal(p.grad, want[name]), name
    assert torch.equal(b, scan(ids, mask, dropout_seed=11))


ARGS = ["--model", "gpt2-tiny", "--attention", "flash", "--device", "cpu",
        "--train-size", "48", "--eval-size", "16", "--global-batch-size",
        "16", "--micro-batch-size", "8", "--num-epochs", "1",
        "--warmup-steps", "1", "--learning-rate", "1e-3", "--log-every",
        "0", "--seed", "7"]


def _weights(trainer, scanned):
    return params_to_jax(trainer.state.module.state_dict(),
                         scan_layers=scanned)


@pytest.mark.parametrize("kind", ["train_lm", "bert"])
def test_scanned_training_equals_unscanned(kind):
    # dropout on, 3 steps: the losses bit for bit, the grad norms (the
    # stacked gradient's squares sum in another order) and the weights
    # within rtol 1e-6
    runs = {}
    for scan in (True, False):
        if kind == "train_lm":
            t = train_lm.train(ARGS + [
                "--scan-layers" if scan else "--no-scan-layers"])
        else:
            t = Trainer(
                model_preset("tiny", scan_layers=scan),
                TrainConfig(num_epochs=1, train_size=48, eval_size=16,
                            global_batch_size=16, micro_batch_size=8,
                            warmup_steps=1, learning_rate=1e-3, log_every=0),
                task="synthetic", device="cpu")
            t.run()
        assert t.mcfg.scan_layers == scan
        runs[scan] = t
    scan, loop = runs[True], runs[False]
    assert len(scan.step_log) == 3
    assert [s["loss"] for s in scan.step_log] == [
        s["loss"] for s in loop.step_log]
    np.testing.assert_allclose([s["grad_norm"] for s in scan.step_log],
                               [s["grad_norm"] for s in loop.step_log],
                               rtol=1e-6)
    a, b = _weights(scan, False), _weights(loop, False)
    for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        np.testing.assert_allclose(x, y, rtol=1e-6, atol=0)
    metric = "eval_loss" if kind == "train_lm" else "accuracy"
    assert scan.history[0][metric] == loop.history[0][metric]


@pytest.mark.parametrize("mode", ["branch", "stage"])
def test_model_parallel_modes_keep_per_layer_modules(mode):
    with pytest.raises(ValueError, match="per-layer"):
        Trainer(model_preset("tiny", scan_layers=True), TrainConfig(),
                task="synthetic", device="cpu", mp_mode=mode)
