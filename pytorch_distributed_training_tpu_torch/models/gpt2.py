"""GPT-2 causal language model (counterpart: the JAX package's
``models/gpt2.py``): wte + wpe embeddings, pre-LN blocks with tanh GELU
and residuals, a final ``ln_f`` and a weight-tied LM head.

dtype policy, as in the JAX package: parameters float32; embeddings,
matmuls and the residual stream in the compute dtype; LayerNorm and
softmax statistics in float32; logits float32, computed as the float32
product of the compute-dtype-rounded operands (the JAX head is a bf16 x
bf16 product with float32 accumulation; ``torch.matmul`` on bf16 would
round the logits to bf16). Parameter names follow the flax tree with
``block_i`` as ``blocks.i`` (``models/convert.py``); with ``scan_layers``
the blocks are one ``ScannedLayers`` (``layers_scan.block...``, each
parameter stacked on a leading [num_layers] dim, as flax's ``nn.scan``
trunk; ``models/bert.py``).

int8 training (``matmul_impl`` int8/int8_full, ``quant_delayed``): each
block's four attention projections and its ``mlp_up`` and ``mlp_down``
take ``DenseGeneral``'s int8 path (``models/bert.py``; the amax buffers
stack on ``layers_scan`` as the parameters do); the tied head stays
native, as in JAX.

``forward(..., paged=PagedKV(...))`` runs the serving engine's paged
prefill, decode and (with ``PagedKV.multiquery`` or
``cfg.paged_multiquery``) multi-token query; ``forward(...,
cache=DenseKV(...))`` the dense decode cache of ``models/generate.py``
(position ids from the cache's index unless given, the index advanced by
the chunk after the forward);
without either, full-sequence causal attention through
``cfg.attention_impl`` (the flash kernels for ``gpt2-medium``).

Remat: ``remat`` checkpoints each block (``models/bert.call_layer``,
JAX ``_gpt2_layer_cls``), ``remat_mlp`` only its MLP tail (mlp_up ->
gelu -> mlp_down -> dropout; JAX ``nn.remat(_mlp_body)``); both through
``models/bert.remat_call``, losses and gradients unchanged.

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

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from pytorch_distributed_training_tpu_torch.models.bert import (
    _SITE_ATTENTION_NORM,
    _SITE_MLP_NORM,
    BertSelfAttention,
    DenseGeneral,
    DenseKV,
    Embed,
    PagedKV,
    call_layer,
    child_seed,
    compute_dtype,
    dense,
    dropout_module,
    layer_norm_module,
    make_trunk,
    model_input,
    param_dtype,
    remat_call,
    seq_offset,
    trunk_seed,
)
from pytorch_distributed_training_tpu_torch.ops.attention import (
    make_attention_bias,
)
from pytorch_distributed_training_tpu_torch.ops.quant import (
    _SERVE_QUANT_MODULES,
)
from pytorch_distributed_training_tpu_torch.utils.config import ModelConfig


class GPT2Block(nn.Module):
    """Pre-LN transformer block (LN before each sublayer)."""

    def __init__(self, cfg: ModelConfig, device=None, generator=None):
        super().__init__()
        self.config = cfg
        h = cfg.hidden_size
        self.ln_1 = layer_norm_module(cfg, device)
        self.attention = BertSelfAttention(cfg, device, generator)
        self.ln_2 = layer_norm_module(cfg, device)
        self.mlp_up = dense(cfg, (h,), (cfg.intermediate_size,), device,
                            generator, int8=True)
        self.mlp_down = dense(cfg, (cfg.intermediate_size,), (h,), device,
                              generator, int8=True)
        self.dropout = dropout_module(cfg)
        self.tp_shard = None  # the model axis, under tensor parallelism

    def forward(self, x, attention_bias=None, paged=None, dropout_seed=None):
        h = self.attention(self.ln_1(x), attention_bias, paged,
                           dropout_seed=dropout_seed)
        x = x + self.dropout(h, dropout_seed, _SITE_ATTENTION_NORM)
        h = model_input(self.ln_2(x), self.tp_shard)
        if self.config.remat_mlp and torch.is_grad_enabled():
            # JAX ``nn.remat(_mlp_body)``: a plain checkpoint of the tail,
            # dropping the [B, S, 4 hidden] GELU input and output for one
            # more ``mlp_up`` in the backward
            return x + remat_call(lambda h: self._mlp(h, dropout_seed),
                                  (h,), (self.mlp_up, self.mlp_down))
        return x + self._mlp(h, dropout_seed)

    def _mlp(self, h, dropout_seed):
        """The MLP tail (JAX ``_mlp_body``): mlp_up -> tanh GELU ->
        mlp_down -> dropout."""
        h = self.mlp_up(h)
        h = F.gelu(h, approximate="tanh")  # GPT-2's tanh approximation
        return self.dropout(self.mlp_down(h), dropout_seed, _SITE_MLP_NORM)


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
        trunk = make_trunk(cfg, lambda: GPT2Block(cfg, device, generator),
                           "block")
        if cfg.scan_layers:
            self.layers_scan = trunk
        else:
            self.blocks = trunk
        self.ln_f = layer_norm_module(cfg, device)
        self.dropout = dropout_module(cfg)
        # float32 copy of the compute-dtype head, set by cast_for_serving
        self.head_weight: Optional[torch.Tensor] = None
        self.seq_shard = None  # the seq axis, under context parallelism

    @torch.no_grad()
    def cast_for_serving(self, weights_dtype: str = "float32") -> None:
        """Cast the embeddings and matmul weights to the compute dtype once,
        in place (LayerNorm parameters stay float32), and keep the float32
        copy of the rounded tied head. Values are unchanged: every forward
        casts them to the compute dtype anyway, as flax does per call.

        ``weights_dtype="int8"``: the six projections of every block
        (``ops/quant._SERVE_QUANT_MODULES``) are quantized instead, from
        their float32 values, to an int8 ``kernel`` and an fp32
        ``kernel_scale`` (the JAX engine's ``quantize_serve_params``), and
        dequantize per call; embeddings, LayerNorms, biases and the tied
        head are cast as for float32. Projections that arrive int8 (an int8
        checkpoint) stay int8 under either value."""
        if weights_dtype not in ("float32", "int8"):
            raise ValueError(
                f"weights_dtype must be float32/int8, got {weights_dtype!r}")
        if weights_dtype == "int8" and self.config.scan_layers:
            raise ValueError("int8 serving weights take the unscanned trunk "
                             "(scan_layers=False)")
        cdt = compute_dtype(self.config)
        for name, mod in self.named_modules():
            if isinstance(mod, DenseGeneral):
                if (weights_dtype == "int8"
                        and name.rpartition(".")[2] in _SERVE_QUANT_MODULES):
                    mod.quantize()
                if mod.kernel_scale is None:
                    mod.kernel.data = mod.kernel.data.to(cdt)
                mod.bias.data = mod.bias.data.to(cdt)
            elif isinstance(mod, Embed):
                mod.embedding.data = mod.embedding.data.to(cdt)
        self.head_weight = self.wte.embedding.data.float()

    def forward(self, input_ids, attention_mask=None, token_type_ids=None,
                position_ids=None, dropout_seed: Optional[int] = None, *,
                paged: Optional[PagedKV] = None,
                cache: Optional[DenseKV] = None):
        cfg = self.config
        input_ids = input_ids.long()
        batch, seq = input_ids.shape
        # under context parallelism this rank's columns start at offset;
        # a dense cache's chunk at its index
        offset = (cache.index if cache is not None
                  else seq_offset(input_ids, self.seq_shard))
        # a dense cache may hold an index a row (the serving engine's,
        # with its bound from the host)
        last = (cache.index_max if cache is not None
                and cache.index_max is not None
                else int(offset.max()) if torch.is_tensor(offset)
                else offset)
        if last + seq > cfg.max_position_embeddings:
            raise ValueError(
                f"sequence length {last + seq} exceeds "
                f"max_position_embeddings {cfg.max_position_embeddings}"
            )
        if position_ids is None:
            steps = torch.arange(seq, device=input_ids.device)[None, :]
            position_ids = (offset[:, None] + steps if torch.is_tensor(offset)
                            else (offset + steps).expand(batch, seq))
        dropout_seed = trunk_seed(dropout_seed, self.seq_shard)
        x = self.wte(input_ids) + self.wpe(position_ids)
        x = self.dropout(x, child_seed(dropout_seed, 0))
        bias = make_attention_bias(attention_mask)
        kv = paged if cache is None else cache  # either has .layer(i)
        if cfg.scan_layers:
            x = self.layers_scan(x, bias, dropout_seed, kv)
        else:
            for i, block in enumerate(self.blocks):
                x = call_layer(block, cfg, x, bias,
                               child_seed(dropout_seed, i + 1),
                               None if kv is None else kv.layer(i))
        if cache is not None:
            cache.index += seq
        x = self.ln_f(x)
        head = self.head_weight
        if head is None:
            head = self.wte.embedding.to(compute_dtype(cfg)).float()
        return torch.matmul(x.float(), head.t())


def unscanned(model: GPT2LMModel) -> GPT2LMModel:
    """``model`` with a stacked trunk (``layers_scan``) laid out a block a
    module, on the same values (``models/relayout.unstack_scanned_params``,
    which the JAX engine and ``generate`` run too); a model whose trunk is
    per block comes back as it is. Tensor-parallel serving cuts the
    per-block leaves: the JAX policy splits no ``layers_scan`` leaf."""
    from pytorch_distributed_training_tpu_torch.models.relayout import (
        unstack_scanned_params,
    )

    cfg = model.config
    if not cfg.scan_layers:
        return model
    flat = GPT2LMModel(dataclasses.replace(cfg, scan_layers=False),
                       device="meta")
    whole = model.state_dict()
    # the trunk's slices copied out of their stacks, the rest as they are
    state = {name: t if name in whole else t.clone() for name, t in
             unstack_scanned_params(whole).items()}
    flat.load_state_dict(state, assign=True)
    return flat
