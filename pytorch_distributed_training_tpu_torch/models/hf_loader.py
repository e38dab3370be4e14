"""HuggingFace checkpoint -> the port's ``state_dict`` (counterpart: the JAX
package's ``models/hf_loader.py``).

The reference starts from HF pretrained weights. This maps a torch BERT
``state_dict`` (or an in-memory ``transformers`` model, a mapping of numpy
arrays, or a local directory holding ``model.safetensors`` or
``pytorch_model.bin``) onto ``BertForSequenceClassification``, and a GPT-2
one onto ``GPT2LMModel``, in the port's own names and layouts
(``DenseGeneral`` kernels ``in_shape + out_shape``, ``models/bert.py``):

- BERT's ``nn.Linear`` weights are [out, in] and transpose; Q/K/V go to
  [hidden, heads, head_dim] and the attention output to [heads, head_dim,
  hidden];
- GPT-2's ``Conv1D`` weights are already [in, out]: the fused ``c_attn``
  [hidden, 3 hidden] splits into query, key and value; the head is tied
  to ``wte``, so only the embedding loads;
- RoBERTa (``roberta.*``, ``RobertaForSequenceClassification``) is BERT's
  trunk: its classification head's ``classifier.dense`` goes into the
  pooler slot (tanh pooling is RobertaClassificationHead's) and
  ``classifier.out_proj`` into the classifier, as the JAX loader maps
  them.

Float tensors come out float32 (``param_dtype``), whatever the checkpoint
was saved in; with ``scan_layers`` the layers stack into the
``layers_scan`` trunk (``models/relayout.py``). Nothing here downloads;
``safetensors`` and ``transformers`` are imported only when a source needs
them.
"""

from __future__ import annotations

import os
from typing import Any, Mapping

import numpy as np
import torch

from pytorch_distributed_training_tpu_torch.utils.config import ModelConfig


def _tensor(t) -> torch.Tensor:
    t = t.detach().cpu() if isinstance(t, torch.Tensor) else torch.from_numpy(
        np.array(t, copy=True))
    return t.float() if t.is_floating_point() else t


def state_dict_from(source: Any) -> dict[str, torch.Tensor]:
    """A ``transformers`` model, a torch ``state_dict``, a mapping of numpy
    arrays, or a local directory with ``model.safetensors`` /
    ``pytorch_model.bin`` -> ``{name: CPU tensor}``, floats float32."""
    if isinstance(source, (str, os.PathLike)):
        st_path = os.path.join(source, "model.safetensors")
        pt_path = os.path.join(source, "pytorch_model.bin")
        if os.path.exists(st_path):
            from safetensors.numpy import load_file

            return {k: _tensor(v) for k, v in load_file(st_path).items()}
        if os.path.exists(pt_path):
            sd = torch.load(pt_path, map_location="cpu", weights_only=True)
            return {k: _tensor(v) for k, v in sd.items()}
        raise FileNotFoundError(f"no checkpoint found under {source!r}")
    if hasattr(source, "state_dict"):
        source = source.state_dict()
    if isinstance(source, Mapping):
        return {k: _tensor(v) for k, v in source.items()}
    raise TypeError(f"unsupported checkpoint source {type(source)!r}")


def _stacked(state: dict, config: ModelConfig) -> dict:
    if not config.scan_layers:
        return state
    from pytorch_distributed_training_tpu_torch.models.relayout import (
        stack_layer_params,
    )

    return stack_layer_params(state)


def load_bert_classifier(source: Any, config: ModelConfig) -> dict:
    """``BertForSequenceClassification``'s ``state_dict`` from an HF BERT or
    RoBERTa sequence-classification checkpoint."""
    sd = state_dict_from(source)
    n, d, h = config.num_heads, config.head_dim, config.hidden_size
    # HF prefixes: bert.* (BertForSequenceClassification) or roberta.*
    prefix = "bert." if any(k.startswith("bert.") for k in sd) else (
        "roberta." if any(k.startswith("roberta.") for k in sd) else "")
    out: dict[str, torch.Tensor] = {}

    def linear(dst, key, in_shape=None, out_shape=None):
        w = sd[key + ".weight"].t()  # [out, in] -> [in, out]
        b = sd[key + ".bias"]
        out[dst + ".kernel"] = w.reshape(*(in_shape or w.shape[:1]),
                                         *(out_shape or w.shape[1:]))
        out[dst + ".bias"] = b.reshape(*(out_shape or b.shape))

    def norm(dst, key):
        out[dst + ".scale"] = sd[key + ".weight"]
        out[dst + ".bias"] = sd[key + ".bias"]

    emb = prefix + "embeddings."
    out["bert.embeddings.word_embeddings.embedding"] = sd[
        emb + "word_embeddings.weight"]
    out["bert.embeddings.position_embeddings.embedding"] = sd[
        emb + "position_embeddings.weight"]
    if config.type_vocab_size:
        out["bert.embeddings.token_type_embeddings.embedding"] = sd[
            emb + "token_type_embeddings.weight"]
    norm("bert.embeddings.norm", emb + "LayerNorm")
    for i in range(config.num_layers):
        src, dst = f"{prefix}encoder.layer.{i}.", f"bert.layers.{i}."
        for qkv in ("query", "key", "value"):
            linear(dst + f"attention.{qkv}", src + f"attention.self.{qkv}",
                   (h,), (n, d))
        linear(dst + "attention.out", src + "attention.output.dense",
               (n, d), (h,))
        norm(dst + "attention_norm", src + "attention.output.LayerNorm")
        linear(dst + "mlp_up", src + "intermediate.dense")
        linear(dst + "mlp_down", src + "output.dense")
        norm(dst + "mlp_norm", src + "output.LayerNorm")
    if prefix + "pooler.dense.weight" in sd:
        linear("bert.pooler", prefix + "pooler.dense")
    elif "classifier.dense.weight" in sd:
        # RoBERTa's head carries its own dense: the pooler slot
        linear("bert.pooler", "classifier.dense")
    if "classifier.weight" in sd:
        linear("classifier", "classifier")
    elif "classifier.out_proj.weight" in sd:
        linear("classifier", "classifier.out_proj")
    return _stacked({k: v.contiguous() for k, v in out.items()}, config)


def load_gpt2_lm(source: Any, config: ModelConfig) -> dict:
    """``GPT2LMModel``'s ``state_dict`` from an HF ``GPT2LMHeadModel``
    checkpoint."""
    sd = state_dict_from(source)
    n, d, h = config.num_heads, config.head_dim, config.hidden_size
    prefix = ("transformer."
              if any(k.startswith("transformer.") for k in sd) else "")
    out: dict[str, torch.Tensor] = {
        "wte.embedding": sd[prefix + "wte.weight"],
        "wpe.embedding": sd[prefix + "wpe.weight"],
    }

    def norm(dst, key):
        out[dst + ".scale"] = sd[key + ".weight"]
        out[dst + ".bias"] = sd[key + ".bias"]

    for i in range(config.num_layers):
        src, dst = f"{prefix}h.{i}.", f"blocks.{i}."
        norm(dst + "ln_1", src + "ln_1")
        kernels = sd[src + "attn.c_attn.weight"].split(h, dim=1)
        biases = sd[src + "attn.c_attn.bias"].split(h)
        for name, k, b in zip(("query", "key", "value"), kernels, biases):
            out[dst + f"attention.{name}.kernel"] = k.reshape(h, n, d)
            out[dst + f"attention.{name}.bias"] = b.reshape(n, d)
        out[dst + "attention.out.kernel"] = sd[
            src + "attn.c_proj.weight"].reshape(n, d, h)
        out[dst + "attention.out.bias"] = sd[src + "attn.c_proj.bias"]
        norm(dst + "ln_2", src + "ln_2")
        for mine, theirs in (("mlp_up", "mlp.c_fc"),
                             ("mlp_down", "mlp.c_proj")):
            out[dst + mine + ".kernel"] = sd[src + theirs + ".weight"]
            out[dst + mine + ".bias"] = sd[src + theirs + ".bias"]
    norm("ln_f", prefix + "ln_f")
    return _stacked({k: v.contiguous() for k, v in out.items()}, config)
