"""Port parity, RoBERTa (``roberta_style``): the PyTorch package's position
ids, model, MNLI task and HF loader against the JAX package's, and its
context-parallel and branch-ensemble runs over gloo against one process,
on the CPU.

Tolerances: position ids, the MNLI fallback arrays and the HF loader's
tensors bit for bit; the tiny model's loss and logits at rtol 1e-5 and its
gradients at atol 1e-6 (float32, dropout off, bridged weights); the gloo
runs' per-step losses and grad norms at rtol 1e-5 against one process
(``test_torch_train.py``'s)."""

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
import torch.nn.functional as F
import transformers

from pytorch_distributed_training_tpu.data import glue as jax_glue
from pytorch_distributed_training_tpu.models.bert import (
    BertForSequenceClassification as JaxBert,
)
from pytorch_distributed_training_tpu.models.bert import (
    default_position_ids as jax_positions,
)
from pytorch_distributed_training_tpu.models.hf_loader import (
    load_bert_classifier as jax_load_bert,
)
from pytorch_distributed_training_tpu.train.metrics import (
    MetricAccumulator as JaxMetrics,
)
from pytorch_distributed_training_tpu.utils.config import (
    ModelConfig as JaxModelConfig,
)
from pytorch_distributed_training_tpu.utils.config import (
    model_preset as jax_preset,
)
from pytorch_distributed_training_tpu_torch.data import glue
from pytorch_distributed_training_tpu_torch.models.bert import (
    BertForSequenceClassification,
    default_position_ids,
)
from pytorch_distributed_training_tpu_torch.models.convert import (
    params_from_jax,
)
from pytorch_distributed_training_tpu_torch.models.hf_loader import (
    load_bert_classifier,
)
from pytorch_distributed_training_tpu_torch.train.loop import Trainer
from pytorch_distributed_training_tpu_torch.utils.config import (
    ModelConfig,
    TrainConfig,
    model_preset,
)

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROBERTA = dict(roberta_style=True, pad_token_id=1, type_vocab_size=1,
               layer_norm_eps=1e-5)
NO_DROPOUT = dict(compute_dtype="float32", hidden_dropout=0.0,
                  attention_dropout=0.0)


@pytest.fixture
def offline_datasets(monkeypatch):
    """A ``datasets`` stand-in whose ``load_dataset`` fails as an offline
    image does, so both packages take their synthetic fallback."""
    def load_dataset(*a, **k):
        raise ConnectionError("offline")

    monkeypatch.setitem(sys.modules, "datasets",
                        types.SimpleNamespace(load_dataset=load_dataset))


def test_roberta_large_preset_matches_jax():
    import dataclasses

    port, ref = model_preset("roberta-large"), jax_preset("roberta-large")
    for f in dataclasses.fields(port):
        assert getattr(port, f.name) == getattr(ref, f.name), f.name
    assert (port.vocab_size, port.max_position_embeddings,
            port.type_vocab_size, port.pad_token_id, port.layer_norm_eps
            ) == (50265, 514, 1, 1, 1e-5)


@pytest.mark.parametrize("pad", (0, 1))
def test_position_ids_match_jax(pad):
    g = np.random.default_rng(pad)
    ids = g.integers(0, 6, (4, 24)).astype(np.int32)  # pads inside rows
    ids[1, 10:] = pad  # a padded tail
    for style in (dict(ROBERTA, pad_token_id=pad), {}):
        kw = dict(max_position_embeddings=64, **style)
        got = default_position_ids(ModelConfig(**kw), torch.from_numpy(ids))
        want = jax_positions(JaxModelConfig(**kw), jnp.asarray(ids))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the table's limit: seq + pad + 1 positions under RoBERTa
    cfg = dict(ROBERTA, pad_token_id=pad, max_position_embeddings=24 + pad)
    with pytest.raises(ValueError, match="max_position_embeddings"):
        default_position_ids(ModelConfig(**cfg), torch.from_numpy(ids))
    with pytest.raises(ValueError, match="max_position_embeddings"):
        jax_positions(JaxModelConfig(**cfg), jnp.asarray(ids))


def test_tiny_roberta_loss_logits_gradients_match_jax():
    opts = dict(NO_DROPOUT, **ROBERTA)
    jmodel = JaxBert(jax_preset("tiny", **opts))
    g = np.random.default_rng(5)
    ids = g.integers(0, 1024, (3, 16)).astype(np.int32)
    ids[0, 12:] = 1  # RoBERTa's pad id in a tail
    mask = (ids != 1).astype(np.int32)
    types_ = np.zeros_like(ids)
    types_[:, 8:] = 1  # pair ids clamp into the one-row table
    labels = np.array([0, 1, 1])
    params = jax.tree.map(np.asarray, jmodel.init(
        jax.random.key(0), jnp.asarray(ids))["params"])

    def loss(p):
        logits = jmodel.apply({"params": p}, ids, mask, types_)
        return (jnp.mean(-jax.nn.log_softmax(logits)[np.arange(3), labels]),
                logits)

    (jl, jlogits), jg = jax.value_and_grad(loss, has_aux=True)(params)
    model = BertForSequenceClassification(model_preset("tiny", **opts))
    model.load_state_dict(params_from_jax(params))
    assert model.bert.embeddings.token_type_embeddings.embedding.shape[0] == 1
    logits = model(torch.from_numpy(ids), torch.from_numpy(mask),
                   torch.from_numpy(types_))
    pl = F.cross_entropy(logits, torch.from_numpy(labels))
    pl.backward()
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(pl.item(), float(jl), rtol=1e-5)
    want = params_from_jax(jax.tree.map(np.asarray, jg))
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   rtol=0, atol=1e-6, err_msg=name)


def test_pooler_pre_dropout_draws_only_under_roberta():
    # RobertaClassificationHead drops the CLS row before the pooler: with
    # dropout on the logits depend on it, BERT's head has no such site
    ids = torch.from_numpy(np.random.default_rng(0).integers(2, 1024, (2, 8)))
    for style, sites in ((ROBERTA, 2), ({}, 1)):
        model = BertForSequenceClassification(
            model_preset("tiny", **style),
            generator=torch.Generator().manual_seed(0))
        drawn = []
        for head in filter(None, (model.bert.pool_dropout, model.dropout)):
            head.register_forward_hook(lambda m, i, o: drawn.append(o))
        model(ids, dropout_seed=3)
        assert len(drawn) == sites


def test_mnli_fallback_arrays_and_metric_keys_match_jax(offline_datasets):
    kw = dict(max_length=32, vocab_size=1024, seed=42,
              synthetic_sizes=(48, 16))
    assert glue.eval_splits("mnli") == jax_glue.eval_splits("mnli")
    for split in ("train", "validation", "validation_mismatched"):
        got, n = glue.load_task_arrays("mnli", split, **kw)
        want, jn = jax_glue.load_task_arrays("mnli", split, **kw)
        assert n == jn == 3
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # the history record: JAX's metric names, unprefixed for the first
    # split and suffixed for both
    mcfg = model_preset("tiny", **ROBERTA)
    t = Trainer(mcfg, TrainConfig(
        num_epochs=1, train_size=32, eval_size=16, global_batch_size=16,
        micro_batch_size=8, eval_batch_size=16, warmup_steps=1, log_every=0,
        max_seq_length=32), task="mnli", device="cpu")
    rec = t.run()[0]
    raw = set(JaxMetrics(3).compute())
    assert set(rec) == {"epoch", "train_loss", "samples_per_sec",
                        "samples_per_sec_per_chip"} | raw | {
        f"{k}_{s}" for k in raw for s in ("matched", "mismatched")}
    assert t.mcfg.num_labels == 3


def _hf_roberta():
    torch.manual_seed(0)
    return transformers.RobertaForSequenceClassification(
        transformers.RobertaConfig(
            vocab_size=512, hidden_size=64, num_hidden_layers=2,
            num_attention_heads=4, intermediate_size=128,
            max_position_embeddings=66, type_vocab_size=1, pad_token_id=1,
            hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
            num_labels=3)).eval()


def test_hf_roberta_loader_bit_equal_to_jax_and_the_hf_forward(tmp_path):
    cfg = dict(vocab_size=512, hidden_size=64, num_layers=2, num_heads=4,
               intermediate_size=128, max_position_embeddings=66,
               num_labels=3, **NO_DROPOUT, **ROBERTA)
    hf = _hf_roberta()
    hf.save_pretrained(tmp_path / "hf")
    want = params_from_jax(jax_load_bert(hf, JaxModelConfig(**cfg)))
    for source in (hf, str(tmp_path / "hf")):
        got = load_bert_classifier(source, ModelConfig(**cfg))
        assert sorted(got) == sorted(want)
        for k in want:
            assert torch.equal(got[k], want[k]), k
    model = BertForSequenceClassification(ModelConfig(**cfg))
    model.load_state_dict(got)
    g = np.random.default_rng(1)
    ids = torch.from_numpy(g.integers(3, 512, (2, 12)))
    ids[1, 9:] = 1
    mask = (ids != 1).long()
    with torch.no_grad():
        theirs = hf(input_ids=ids, attention_mask=mask).logits
        ours = model(ids, mask)
    np.testing.assert_allclose(ours.numpy(), theirs.numpy(), rtol=2e-4,
                               atol=2e-4)


# ------------------------------------------------------- gloo: CP, TriBert

_SCRIPT = textwrap.dedent("""
    import json, sys
    import torch
    torch.set_num_threads(1)
    from pytorch_distributed_training_tpu_torch.comms.bootstrap import (
        shutdown)
    from pytorch_distributed_training_tpu_torch.models.branch import (
        BranchEnsembleClassifier)
    from pytorch_distributed_training_tpu_torch.train.loop import Trainer
    from pytorch_distributed_training_tpu_torch.utils.config import (
        MeshConfig, TrainConfig, model_preset)
    out, spec = sys.argv[1], json.loads(sys.argv[2])
    mcfg = model_preset("tiny", compute_dtype="float32", hidden_dropout=0.0,
                        attention_dropout=0.0, roberta_style=True,
                        pad_token_id=1, type_vocab_size=1,
                        attention_impl="ring")
    tcfg = TrainConfig(num_epochs=1, train_size=64, eval_size=16,
                       global_batch_size=16, micro_batch_size=8,
                       eval_batch_size=16, warmup_steps=1,
                       learning_rate=1e-3, log_every=0, bf16=False,
                       max_seq_length=32)
    model = None
    if spec["mode"] == "branch":
        def model(cfg, *, seed, mesh):
            return BranchEnsembleClassifier(cfg, 2, seed=seed, mesh=mesh)
    t = Trainer(mcfg, tcfg, task="synthetic", device="cpu",
                mesh_config=MeshConfig(**spec["mesh"]), mp_mode=spec["mode"],
                model=model)
    t.run()
    if t.info.rank == 0:
        json.dump({"steps": t.step_log, "history": t.history}, open(out, "w"))
    shutdown()
""")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_cp_and_branches_over_gloo_equal_one_process(tmp_path):
    runs = {
        "one": (1, dict(mode=None, mesh=dict(data=1))),
        "cp": (2, dict(mode=None, mesh=dict(data=1, seq=2))),
        "branch1": (1, dict(mode="branch", mesh=dict(data=1))),
        "branch2": (2, dict(mode="branch", mesh=dict(data=1, model=2))),
    }
    base = dict(os.environ, CUDA_VISIBLE_DEVICES="", MASTER_ADDR="127.0.0.1",
                GLOO_SOCKET_IFNAME="lo", PYTHONPATH=REPO)
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
    got = {n: json.loads((tmp_path / n).read_text()) for n in runs}
    for many, one in (("cp", "one"), ("branch2", "branch1")):
        a, b = got[one]["steps"], got[many]["steps"]
        assert len(a) == len(b) == 4
        for x, y in zip(a, b):
            np.testing.assert_allclose(y["loss"], x["loss"], rtol=1e-5)
            np.testing.assert_allclose(y["grad_norm"], x["grad_norm"],
                                       rtol=1e-5)
        assert got[one]["history"][0]["accuracy"] == \
            got[many]["history"][0]["accuracy"]
