"""GPT-2 causal language model (counterpart: the JAX package's
``models/gpt2.py``): wte + wpe embeddings, pre-LN blocks with tanh GELU
and residuals, a final ``ln_f`` and a weight-tied LM head.

dtype policy, as in the JAX package: parameters float32; embeddings,
matmuls and the residual stream in the compute dtype; LayerNorm and
softmax statistics in float32; logits float32, computed as the float32
product of the compute-dtype-rounded operands (the JAX head is a bf16 x
bf16 product with float32 accumulation; ``torch.matmul`` on bf16 would
round the logits to bf16). Parameter names follow the flax tree with
``block_i`` as ``blocks.i`` (``models/convert.py``).

``forward(..., paged=PagedKV(...))`` runs the serving engine's paged
prefill/decode; without it, full-sequence causal attention through
``cfg.attention_impl`` (the flash kernels for ``gpt2-medium``).

Training: ``forward(input_ids, attention_mask=None, token_type_ids=None,
position_ids=None, dropout_seed=None)``, the JAX model's uniform signature
(``token_type_ids`` is taken and ignored), so the train and eval steps
drive it as they drive the BERT classifier. Dropout at ``hidden_dropout``
on the embeddings, after attention and after ``mlp_down``, and on the
attention probabilities at ``attention_dropout`` (the JAX package's
``models/gpt2.py``). Seeds, as ``models/bert.py`` derives them: the
embeddings draw from ``fold_in(seed, 0)`` (site 0), block i from
``fold_in(seed, i + 1)``, where the attention output is site 0
(``_SITE_ATTENTION_NORM``), the MLP output site 1 (``_SITE_MLP_NORM``) and
the probs site 2 (``_SITE_PROBS``). ``dropout_seed`` None is
deterministic (eval and serving).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from pytorch_distributed_training_tpu_torch.models.bert import (
    _SITE_ATTENTION_NORM,
    _SITE_MLP_NORM,
    BertSelfAttention,
    DenseGeneral,
    Embed,
    PagedKV,
    _child_seed,
    compute_dtype,
    dense,
    layer_norm_module,
    param_dtype,
)
from pytorch_distributed_training_tpu_torch.ops.attention import (
    make_attention_bias,
)
from pytorch_distributed_training_tpu_torch.ops.dropout import Dropout
from pytorch_distributed_training_tpu_torch.utils.config import ModelConfig


class GPT2Block(nn.Module):
    """Pre-LN transformer block (LN before each sublayer)."""

    def __init__(self, cfg: ModelConfig, device=None, generator=None):
        super().__init__()
        h = cfg.hidden_size
        self.ln_1 = layer_norm_module(cfg, device)
        self.attention = BertSelfAttention(cfg, device, generator)
        self.ln_2 = layer_norm_module(cfg, device)
        self.mlp_up = dense(cfg, (h,), (cfg.intermediate_size,), device,
                            generator)
        self.mlp_down = dense(cfg, (cfg.intermediate_size,), (h,), device,
                              generator)
        self.dropout = Dropout(cfg.hidden_dropout)

    def forward(self, x, attention_bias=None, paged=None, dropout_seed=None):
        h = self.attention(self.ln_1(x), attention_bias, paged,
                           dropout_seed=dropout_seed)
        x = x + self.dropout(h, dropout_seed, _SITE_ATTENTION_NORM)
        h = self.mlp_up(self.ln_2(x))
        h = F.gelu(h, approximate="tanh")  # GPT-2's tanh approximation
        return x + self.dropout(self.mlp_down(h), dropout_seed,
                                _SITE_MLP_NORM)


class GPT2LMModel(nn.Module):
    """wte+wpe embeddings -> N pre-LN blocks -> ln_f -> tied-head logits."""

    def __init__(self, cfg: ModelConfig, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if not cfg.causal:
            raise ValueError("GPT2LMModel needs a causal config")
        self.config = cfg
        kw = dict(dtype=compute_dtype(cfg), param_dtype=param_dtype(cfg),
                  device=device, generator=generator)
        self.wte = Embed(cfg.vocab_size, cfg.hidden_size, **kw)
        self.wpe = Embed(cfg.max_position_embeddings, cfg.hidden_size, **kw)
        self.blocks = nn.ModuleList(
            GPT2Block(cfg, device, generator) for _ in range(cfg.num_layers)
        )
        self.ln_f = layer_norm_module(cfg, device)
        self.dropout = Dropout(cfg.hidden_dropout)
        # float32 copy of the compute-dtype head, set by cast_for_serving
        self.head_weight: Optional[torch.Tensor] = None

    @torch.no_grad()
    def cast_for_serving(self) -> None:
        """Cast the embeddings and matmul weights to the compute dtype once,
        in place (LayerNorm parameters stay float32), and keep the float32
        copy of the rounded tied head. Values are unchanged: every forward
        casts them to the compute dtype anyway, as flax does per call."""
        cdt = compute_dtype(self.config)
        for mod in self.modules():
            if isinstance(mod, DenseGeneral):
                mod.kernel.data = mod.kernel.data.to(cdt)
                mod.bias.data = mod.bias.data.to(cdt)
            elif isinstance(mod, Embed):
                mod.embedding.data = mod.embedding.data.to(cdt)
        self.head_weight = self.wte.embedding.data.float()

    def forward(self, input_ids, attention_mask=None, token_type_ids=None,
                position_ids=None, dropout_seed: Optional[int] = None, *,
                paged: Optional[PagedKV] = None):
        cfg = self.config
        input_ids = input_ids.long()
        batch, seq = input_ids.shape
        if seq > cfg.max_position_embeddings:
            raise ValueError(
                f"sequence length {seq} exceeds max_position_embeddings "
                f"{cfg.max_position_embeddings}"
            )
        if position_ids is None:
            position_ids = torch.arange(
                seq, device=input_ids.device
            )[None, :].expand(batch, seq)
        x = self.wte(input_ids) + self.wpe(position_ids)
        x = self.dropout(x, _child_seed(dropout_seed, 0))
        bias = make_attention_bias(attention_mask)
        for i, block in enumerate(self.blocks):
            layer = None
            if paged is not None:
                k_pages, v_pages = paged.pools[i]
                layer = (k_pages, v_pages, paged.block_table,
                         paged.context_len)
            x = block(x, bias, layer, _child_seed(dropout_seed, i + 1))
        x = self.ln_f(x)
        head = self.head_weight
        if head is None:
            head = self.wte.embedding.to(compute_dtype(cfg)).float()
        return torch.matmul(x.float(), head.t())
