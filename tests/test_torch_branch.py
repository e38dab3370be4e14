"""Port parity, hybrid parallel models: the PyTorch package's branch
ensemble (``models/branch.py``) and the stage mode's model
(``models/stage.py``, BERT) against the JAX package's
``BranchEnsembleClassifier`` and scanned BERT on the same numpy inputs and
bridged weights, on the CPU (every kernel through its plain version):
logits, gradients, three train steps, and the weight bridge of the
``branches`` axis."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_training_tpu.models.bert import (
    BertForSequenceClassification as JaxBert,
)
from pytorch_distributed_training_tpu.models.branch import (
    BranchEnsembleClassifier as JaxEnsemble,
)
from pytorch_distributed_training_tpu.train import (
    adamw_with_schedule,
    create_train_state,
)
from pytorch_distributed_training_tpu.train import (
    make_train_step as jax_make_train_step,
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
    pool_cls,
)
from pytorch_distributed_training_tpu_torch.models.branch import (
    BranchEnsembleClassifier,
    branch_init_seed,
)
from pytorch_distributed_training_tpu_torch.models.convert import (
    params_from_jax,
    params_to_jax,
)
from pytorch_distributed_training_tpu_torch.models.stage import BertStage
from pytorch_distributed_training_tpu_torch.ops.attention import (
    make_attention_bias,
)
from pytorch_distributed_training_tpu_torch.train.optim import (
    AdamW,
    linear_warmup_schedule,
)
from pytorch_distributed_training_tpu_torch.train.state import (
    create_train_state as port_train_state,
)
from pytorch_distributed_training_tpu_torch.train.step import (
    classification_loss,
    make_train_step,
)
from pytorch_distributed_training_tpu_torch.utils.config import model_preset

torch.set_num_threads(2)

NO_DROPOUT = dict(compute_dtype="float32", hidden_dropout=0.0,
                  attention_dropout=0.0)
GRAD_RTOL = 1e-5


def _batch(rng, lead, seq=16, vocab=1024):
    """Classification rows of shape ``lead + (seq,)`` with padded tails."""
    ids = rng.integers(0, vocab, (*lead, seq)).astype(np.int32)
    lens = rng.integers(seq // 2, seq + 1, lead)
    mask = (np.arange(seq) < lens[..., None]).astype(np.int32)
    types = (np.arange(seq) >= seq // 2).astype(np.int32) * mask
    labels = rng.integers(0, 2, lead).astype(np.int32)
    return {"input_ids": ids, "attention_mask": mask,
            "token_type_ids": types, "labels": labels}


def _jax_params(model, seed=0):
    ex = {k: jnp.asarray(v) for k, v in _batch(
        np.random.default_rng(seed), (2,)).items()}
    params = model.init(jax.random.key(seed), ex["input_ids"],
                        ex["attention_mask"], ex["token_type_ids"])["params"]
    return jax.tree.map(np.asarray, params)


def _port_ensemble(params, n_branches):
    model = BranchEnsembleClassifier(model_preset("tiny", **NO_DROPOUT),
                                     n_branches)
    model.load_state_dict(params_from_jax(params))
    return model


def _logits(model, batch):
    return model(*(torch.from_numpy(batch[k]) for k in (
        "input_ids", "attention_mask", "token_type_ids")))


def _jax_loss(model, params, batch):
    import optax

    logits = model.apply({"params": params}, batch["input_ids"],
                         batch["attention_mask"], batch["token_type_ids"])
    return optax.softmax_cross_entropy_with_integer_labels(
        logits, batch["labels"]).mean()


def _check_grads(model, jax_model, params, batch):
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jgrads = params_from_jax(jax.tree.map(np.asarray, jax.grad(
        lambda p: _jax_loss(jax_model, p, jb))(params)))
    loss = classification_loss(_logits(model, batch),
                               torch.from_numpy(batch["labels"]))
    loss.backward()
    grads = {n: p.grad for n, p in model.named_parameters()}
    assert grads.keys() == jgrads.keys()
    # rtol, and as much of the largest gradient for the elements that are
    # zero but for rounding (a key bias's, by softmax's shift invariance)
    scale = max(float(g.abs().max()) for g in jgrads.values())
    for name, g in jgrads.items():
        np.testing.assert_allclose(grads[name].numpy(), g.numpy(),
                                   rtol=GRAD_RTOL, atol=GRAD_RTOL * scale,
                                   err_msg=name)


# ------------------------------------------------------------ the ensemble


@pytest.mark.parametrize("n_branches", [3, 2])
def test_ensemble_logits_match_jax_and_are_the_mean_of_the_branches(
        n_branches):
    cfg = jax_preset("tiny", **NO_DROPOUT)
    jmodel = JaxEnsemble(cfg, n_branches=n_branches)
    params = _jax_params(jmodel)
    model = _port_ensemble(params, n_branches)
    batch = _batch(np.random.default_rng(1), (4,))
    want = np.asarray(jmodel.apply(
        {"params": params}, *(jnp.asarray(batch[k]) for k in (
            "input_ids", "attention_mask", "token_type_ids"))))
    with torch.no_grad():
        got = _logits(model, batch)
        assert got.shape == (4, cfg.num_labels)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
        # the mean of the branches run one by one on the shared embeddings
        ids = torch.from_numpy(batch["input_ids"]).long()
        x = model.embeddings(
            ids, torch.from_numpy(batch["token_type_ids"]).long(),
            torch.arange(16)[None].expand(4, 16))
        bias = make_attention_bias(torch.from_numpy(batch["attention_mask"]))
        outs = [model.branches[str(b)](x, bias) for b in range(n_branches)]
        fused = torch.stack(outs).mean(0)
        manual = model.classifier(pool_cls(model.pooler, fused))
    np.testing.assert_allclose(got.numpy(), manual.numpy(), rtol=0,
                               atol=1e-5)
    assert not torch.allclose(outs[0], outs[1], atol=1e-3)


def test_ensemble_gradients_match_jax_grad():
    jmodel = JaxEnsemble(jax_preset("tiny", **NO_DROPOUT), n_branches=3)
    params = _jax_params(jmodel, seed=2)
    _check_grads(_port_ensemble(params, 3), jmodel, params,
                 _batch(np.random.default_rng(3), (4,)))


def test_three_ensemble_train_steps_match_jax_make_train_step():
    # accumulation 2, dropout off, float32, lr 1e-3 with warmup 1 so
    # updates 2 and 3 move the weights well past the tolerance
    jmodel = JaxEnsemble(jax_preset("tiny", **NO_DROPOUT), n_branches=3)
    tx, _ = adamw_with_schedule(
        JaxTrainConfig(learning_rate=1e-3, warmup_steps=1), 10)
    example = {"input_ids": jnp.ones((2, 16), jnp.int32),
               "attention_mask": jnp.ones((2, 16), jnp.int32),
               "token_type_ids": jnp.zeros((2, 16), jnp.int32)}
    state = create_train_state(jmodel, tx, jax.random.key(0), example)
    start = params_from_jax(jax.tree.map(np.asarray, state.params))
    model = _port_ensemble(jax.tree.map(np.asarray, state.params), 3)
    opt = AdamW(model.parameters(), linear_warmup_schedule(1e-3, 1, 10))
    pstate = port_train_state(model, opt, seed=0)
    jstep = jax_make_train_step(grad_accum_steps=2)
    pstep = make_train_step(grad_accum_steps=2)
    rng = np.random.default_rng(4)
    for _ in range(3):
        batch = _batch(rng, (2, 4))
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


def test_branch_weights_bridge_both_ways_with_the_branches_axis():
    jmodel = JaxEnsemble(jax_preset("tiny", **NO_DROPOUT), n_branches=3)
    params = _jax_params(jmodel, seed=5)
    sd = params_from_jax(params)
    port = BranchEnsembleClassifier(model_preset("tiny", **NO_DROPOUT), 3)
    assert sd.keys() == port.state_dict().keys()
    q = params["branches"]["layer_1"]["attention"]["query"]["kernel"]
    assert q.shape[0] == 3
    for b in range(3):
        np.testing.assert_array_equal(
            sd[f"branches.{b}.layers.1.attention.query.kernel"].numpy(), q[b])
    back = params_to_jax(sd)
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    back_flat = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat) == len(back_flat)
    for path, leaf in flat:
        np.testing.assert_array_equal(back_flat[path], leaf)
    # a rank's partial dict (one branch of three) cannot stack alone
    part = {k: v for k, v in sd.items() if not k.startswith("branches.1.")}
    with pytest.raises(ValueError, match="merge every rank"):
        params_to_jax(part)


def test_branch_weights_depend_on_seed_and_branch_only():
    cfg = model_preset("tiny", **NO_DROPOUT)
    whole = BranchEnsembleClassifier(cfg, 4, seed=7).state_dict()
    assert branch_init_seed(7, 0) != branch_init_seed(7, 1)
    assert not torch.equal(whole["branches.0.layers.0.mlp_up.kernel"],
                           whole["branches.1.layers.0.mlp_up.kernel"])
    again = BranchEnsembleClassifier(cfg, 4, seed=7).state_dict()
    for name, w in whole.items():
        assert torch.equal(again[name], w), name
    other = BranchEnsembleClassifier(cfg, 4, seed=8).state_dict()
    assert not torch.equal(other["embeddings.word_embeddings.embedding"],
                           whole["embeddings.word_embeddings.embedding"])
    with pytest.raises(ValueError, match="non-causal"):
        BranchEnsembleClassifier(model_preset("gpt2-tiny"), 3)


# --------------------------------------------------------------- stage mode


def test_stage_model_matches_jax_scanned_bert():
    # JAX stage mode trains the scanned trunk (scan_layers=True); the port
    # keeps per-layer modules and reads the scanned tree through the bridge
    jmodel = JaxBert(jax_preset("tiny", scan_layers=True, **NO_DROPOUT))
    params = _jax_params(jmodel, seed=6)
    assert "layers_scan" in params["bert"]
    full = BertForSequenceClassification(model_preset("tiny", **NO_DROPOUT))
    full.load_state_dict(params_from_jax(params))
    batch = _batch(np.random.default_rng(7), (4,))
    want = np.asarray(jmodel.apply(
        {"params": params}, *(jnp.asarray(batch[k]) for k in (
            "input_ids", "attention_mask", "token_type_ids"))))
    with torch.no_grad():
        np.testing.assert_allclose(_logits(full, batch).numpy(), want,
                                   rtol=0, atol=1e-5)
    # one stage (world 1) is the whole model, and its gradients jax.grad's
    stage = BertStage(full, build_mesh())
    assert stage.state_dict().keys() == full.state_dict().keys()
    _check_grads(stage, jmodel, params, batch)
