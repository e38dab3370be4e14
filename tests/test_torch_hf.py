"""Port parity, HF weight loading: the PyTorch package's
``models/hf_loader.py`` on random-init ``transformers`` models built from a
config (nothing downloads), against the HF forward and against the JAX
package's loader bridged through ``models/convert.py``, on the CPU; and
``train_dp --hf-checkpoint``.

Tolerances: the HF forward at JAX ``tests/test_models.py``'s (BERT 2e-4,
GPT-2 3e-4, float32); the JAX loader's tensors bit for bit."""

import numpy as np
import pytest
import torch
import transformers

from pytorch_distributed_training_tpu.models.hf_loader import (
    load_bert_classifier as jax_load_bert,
)
from pytorch_distributed_training_tpu.models.hf_loader import (
    load_gpt2_lm as jax_load_gpt2,
)
from pytorch_distributed_training_tpu.utils.config import (
    ModelConfig as JaxModelConfig,
)
from pytorch_distributed_training_tpu_torch.cli import train_dp
from pytorch_distributed_training_tpu_torch.models.bert import (
    BertForSequenceClassification,
)
from pytorch_distributed_training_tpu_torch.models.convert import (
    params_from_jax,
)
from pytorch_distributed_training_tpu_torch.models.gpt2 import GPT2LMModel
from pytorch_distributed_training_tpu_torch.models.hf_loader import (
    load_bert_classifier,
    load_gpt2_lm,
    state_dict_from,
)
from pytorch_distributed_training_tpu_torch.utils.config import (
    ModelConfig,
    model_preset,
)

torch.set_num_threads(2)

BERT = dict(vocab_size=512, hidden_size=64, num_layers=2, num_heads=4,
            intermediate_size=128, max_position_embeddings=64,
            type_vocab_size=2, num_labels=2, hidden_dropout=0.0,
            attention_dropout=0.0, compute_dtype="float32")
GPT2 = dict(vocab_size=512, hidden_size=64, num_layers=2, num_heads=4,
            intermediate_size=128, max_position_embeddings=64,
            type_vocab_size=0, causal=True, layer_norm_eps=1e-5,
            hidden_dropout=0.0, attention_dropout=0.0,
            compute_dtype="float32")


def _hf_bert(**over):
    torch.manual_seed(0)
    cfg = dict(vocab_size=512, hidden_size=64, num_hidden_layers=2,
               num_attention_heads=4, intermediate_size=128,
               max_position_embeddings=64, type_vocab_size=2,
               hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
               num_labels=2)
    cfg.update(over)
    return transformers.BertForSequenceClassification(
        transformers.BertConfig(**cfg)).eval()


def _hf_gpt2():
    torch.manual_seed(0)
    return transformers.GPT2LMHeadModel(transformers.GPT2Config(
        vocab_size=512, n_positions=64, n_embd=64, n_layer=2, n_head=4,
        n_inner=128, resid_pdrop=0.0, embd_pdrop=0.0, attn_pdrop=0.0,
        layer_norm_epsilon=1e-5)).eval()


def _same(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == torch.float32, k
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("scan_layers", [False, True])
def test_bert_classifier_matches_hf_and_jax(scan_layers):
    hf = _hf_bert()
    rng = np.random.default_rng(0)
    ids = rng.integers(5, 500, size=(3, 20))
    mask = np.ones((3, 20), np.int64)
    mask[:, 15:] = 0
    types = (np.arange(20) >= 10).astype(np.int64)[None].repeat(3, 0)
    with torch.no_grad():
        want = hf(input_ids=torch.tensor(ids),
                  attention_mask=torch.tensor(mask),
                  token_type_ids=torch.tensor(types)).logits
    cfg = ModelConfig(**BERT, scan_layers=scan_layers)
    state = load_bert_classifier(hf, cfg)
    model = BertForSequenceClassification(cfg)
    model.load_state_dict(state)
    with torch.no_grad():
        got = model(torch.tensor(ids), torch.tensor(mask),
                    torch.tensor(types))
    torch.testing.assert_close(got, want, atol=2e-4, rtol=2e-4)
    jax_tree = jax_load_bert(hf, JaxModelConfig(**BERT))
    _same(state, params_from_jax(jax_tree, scan_layers=scan_layers))


@pytest.mark.parametrize("scan_layers", [False, True])
def test_gpt2_lm_matches_hf_and_jax(scan_layers):
    hf = _hf_gpt2()
    ids = np.random.default_rng(1).integers(5, 500, size=(3, 20))
    with torch.no_grad():
        want = hf(input_ids=torch.tensor(ids)).logits
    cfg = ModelConfig(**GPT2, scan_layers=scan_layers)
    state = load_gpt2_lm(hf, cfg)
    model = GPT2LMModel(cfg)
    model.load_state_dict(state)
    with torch.no_grad():
        got = model(torch.tensor(ids))
    torch.testing.assert_close(got, want, atol=3e-4, rtol=3e-4)
    jax_tree = jax_load_gpt2(hf, JaxModelConfig(**GPT2,
                                                scan_layers=scan_layers))
    _same(state, params_from_jax(jax_tree, scan_layers=scan_layers))


@pytest.mark.parametrize("source", ["safetensors", "pytorch_model.bin",
                                    "state_dict", "numpy"])
def test_sources_give_the_same_state(source, tmp_path):
    hf = _hf_gpt2()
    want = load_gpt2_lm(hf, ModelConfig(**GPT2))
    if source == "safetensors":
        hf.save_pretrained(tmp_path, safe_serialization=True)
        src = str(tmp_path)
    elif source == "pytorch_model.bin":
        torch.save(hf.state_dict(), tmp_path / "pytorch_model.bin")
        src = str(tmp_path)
    elif source == "state_dict":
        src = {k: v.to(torch.bfloat16) if k.endswith("wpe.weight") else v
               for k, v in hf.state_dict().items()}
        want["wpe.embedding"] = want["wpe.embedding"].to(
            torch.bfloat16).float()
    else:
        src = {k: v.numpy() for k, v in hf.state_dict().items()}
    got = load_gpt2_lm(src, ModelConfig(**GPT2))
    _same(got, want)


def test_bad_sources_and_roberta_raise(tmp_path):
    with pytest.raises(FileNotFoundError):
        state_dict_from(str(tmp_path))
    with pytest.raises(TypeError):
        state_dict_from(3)
    torch.manual_seed(0)
    roberta = transformers.RobertaForSequenceClassification(
        transformers.RobertaConfig(
            vocab_size=512, hidden_size=64, num_hidden_layers=2,
            num_attention_heads=4, intermediate_size=128,
            max_position_embeddings=66, type_vocab_size=1))
    # RoBERTa is ported: its head's dense and out_proj fill the pooler and
    # classifier slots, as the JAX loader maps them
    cfg = dict(BERT, type_vocab_size=1, max_position_embeddings=66,
               roberta_style=True, pad_token_id=1, layer_norm_eps=1e-5)
    got = load_bert_classifier(roberta, ModelConfig(**cfg))
    sd = roberta.state_dict()
    assert torch.equal(got["bert.pooler.kernel"],
                       sd["classifier.dense.weight"].t())
    assert torch.equal(got["classifier.kernel"],
                       sd["classifier.out_proj.weight"].t())


def test_train_dp_starts_from_an_hf_checkpoint(tmp_path):
    cfg = model_preset("tiny")
    hf = _hf_bert(vocab_size=cfg.vocab_size,
                  max_position_embeddings=cfg.max_position_embeddings)
    hf.save_pretrained(tmp_path / "hf")
    argv = ["--model", "tiny", "--task", "synthetic", "--device", "cpu",
            "--train-size", "32", "--eval-size", "16",
            "--global-batch-size", "16", "--micro-batch-size", "8",
            "--num-epochs", "1", "--log-every", "0", "--warmup-steps", "1",
            "--hf-checkpoint", str(tmp_path / "hf")]
    trainer = train_dp.build_trainer(train_dp.build_parser().parse_args(argv))
    want = load_bert_classifier(str(tmp_path / "hf"), cfg)
    got = trainer.state.module.state_dict()
    assert sorted(got) == sorted(want)
    assert all(torch.equal(got[k], want[k]) for k in want)
    trainer.run()
    assert trainer.state.step == 2  # the first update's rate is 0
    assert not torch.equal(trainer.state.module.classifier.kernel,
                           want["classifier.kernel"])


def test_train_dp_hf_checkpoint_with_delayed_int8(tmp_path):
    """The HF weights replace the parameters only: the delayed-int8 amaxes
    (buffers the HF state lacks) stay and are calibrated, as JAX replaces
    ``params`` alone and calibrates its quant state afterwards."""
    cfg = model_preset("tiny")
    hf = _hf_bert(vocab_size=cfg.vocab_size,
                  max_position_embeddings=cfg.max_position_embeddings)
    hf.save_pretrained(tmp_path / "hf")
    argv = ["--model", "tiny", "--task", "synthetic", "--device", "cpu",
            "--train-size", "32", "--eval-size", "16",
            "--global-batch-size", "16", "--micro-batch-size", "8",
            "--num-epochs", "1", "--log-every", "0", "--warmup-steps", "1",
            "--matmul-impl", "int8", "--quant-delayed",
            "--hf-checkpoint", str(tmp_path / "hf")]
    trainer = train_dp.build_trainer(train_dp.build_parser().parse_args(argv))
    want = load_bert_classifier(str(tmp_path / "hf"), cfg)
    got = trainer.state.module.state_dict()
    amaxes = {k: v for k, v in got.items() if k not in want}
    assert amaxes and all(k.endswith("amax") for k in amaxes)
    assert all(torch.equal(got[k], want[k]) for k in want)
    assert all(bool((v > 0).all()) for v in amaxes.values())  # calibrated
    trainer.run()
    assert trainer.state.step == 2
    assert all(np.isfinite(r["train_loss"]) for r in trainer.history)
