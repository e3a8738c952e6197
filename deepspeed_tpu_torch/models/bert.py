"""BERT pretraining model (MLM + optional NSP).

The port of ``BertForPreTraining`` from ``deepspeed_tpu/models/bert.py`` at
mp = 1: post-LN encoder, MLM head tied to the word embedding, both MLM
batch formats (dense labels; masked positions ``[B, P]``), the optional NSP
head and the ``mlm_gather_budget`` sparse head.  Parameter names and shapes
are the JAX pytree's (``wte``, ``blocks.qkv_w``, ``mlm_bias``, ...), so
``weights.py`` copies weights across name for name.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from deepspeed_tpu_torch.models import layers as L
from deepspeed_tpu_torch.models import transformer as T

BERT_SIZES = {
    "tiny":  dict(num_layers=2,  hidden_size=128, num_heads=4,
                  max_seq_len=128, vocab_size=512),
    "base":  dict(num_layers=12, hidden_size=768, num_heads=12,
                  vocab_size=30528, max_seq_len=512),
    "large": dict(num_layers=24, hidden_size=1024, num_heads=16,
                  vocab_size=30528, max_seq_len=512),
}


class BertForPreTraining(nn.Module):
    """``forward(input_ids, attention_mask, token_type_ids, *rest)`` returns
    the scalar fp32 loss.  ``rest`` is ``mlm_labels[, nsp_labels]`` (dense
    labels, < 0 ignored) or ``mlm_positions, mlm_ids, mlm_weights[,
    nsp_labels]`` (masked positions, ``[B, P]`` each)."""

    def __init__(self, config: T.TransformerConfig, use_nsp: bool = False,
                 mlm_gather_budget=None, generator=None, device=None):
        super().__init__()
        config.validate()
        self.config = config
        self.use_nsp = use_nsp
        #: dense-labels MLM only: gather up to this many masked positions
        #: per sequence before the vocab projection (exact while every
        #: sequence's masked count fits; see the JAX field docstring)
        self.mlm_gather_budget = mlm_gather_budget
        h, std = config.hidden_size, config.init_std

        def normal(*shape):
            t = torch.empty(shape, dtype=torch.float32, device=device)
            return nn.Parameter(t.normal_(0.0, std, generator=generator))

        def const(value, *shape):
            return nn.Parameter(torch.full(shape, value, dtype=torch.float32,
                                           device=device))

        self.wte = normal(config.vocab_size, h)
        self.wpe = normal(config.max_seq_len, h)
        self.wtt = normal(2, h)
        self.ln_emb_s = const(1.0, h)
        self.ln_emb_b = const(0.0, h)
        self.blocks = T.TransformerStack(config, generator, device)
        self.mlm_dense_w = normal(h, h)
        self.mlm_dense_b = const(0.0, h)
        self.mlm_ln_s = const(1.0, h)
        self.mlm_ln_b = const(0.0, h)
        self.mlm_bias = const(0.0, config.vocab_size)
        if use_nsp:
            self.pool_w = normal(h, h)
            self.pool_b = const(0.0, h)
            self.nsp_w = const(0.0, h, 2)
            self.nsp_b = const(0.0, 2)

    @classmethod
    def from_size(cls, size: str, use_nsp: bool = False,
                  mlm_gather_budget=None, generator=None, device=None,
                  **overrides):
        kw = dict(BERT_SIZES[size])
        kw.update(overrides)
        kw.setdefault("pre_ln", False)   # BERT is post-LN
        kw.setdefault("causal", False)
        return cls(T.TransformerConfig(**kw), use_nsp=use_nsp,
                   mlm_gather_budget=mlm_gather_budget, generator=generator,
                   device=device)

    def validate(self, mp_size: int = 1):
        """Engine hook: shape checks against the model-parallel degree."""
        self.config.validate(mp_size)

    def with_config(self, **changes) -> None:
        """Replace config fields (the engine's activation-checkpointing
        override), keeping the weights."""
        self.config = dataclasses.replace(self.config, **changes)

    def _encode(self, input_ids, attention_mask, token_type_ids):
        cfg = self.config
        T_len = input_ids.shape[1]
        x = L.vocab_parallel_embedding(input_ids, self.wte)
        x = x + self.wpe[:T_len].to(x.dtype)[None]
        x = x + torch.nn.functional.embedding(token_type_ids.long(),
                                              self.wtt.to(x.dtype))
        x = L.layer_norm(x, self.ln_emb_s, self.ln_emb_b, cfg.ln_eps)
        return T.stack_apply(x, dict(self.blocks.named_parameters()), cfg,
                             attn_mask=attention_mask)

    def _mlm_head(self, h):
        """Dense + GELU + LN + tied vocab decoder on [..., H]."""
        g = L.gelu(h @ self.mlm_dense_w.to(h.dtype)
                   + self.mlm_dense_b.to(h.dtype))
        g = L.layer_norm(g, self.mlm_ln_s, self.mlm_ln_b, self.config.ln_eps)
        logits = L.vocab_parallel_logits(g, self.wte)
        return logits + self.mlm_bias.to(logits.dtype)

    def forward(self, input_ids, attention_mask, token_type_ids, *rest):
        if len(rest) in (1, 2):
            mlm_labels = rest[0]
            nsp_labels = rest[1] if len(rest) == 2 else None
            mlm_positions = None
        elif len(rest) in (3, 4):
            mlm_positions, mlm_ids, mlm_weights = rest[:3]
            nsp_labels = rest[3] if len(rest) == 4 else None
        else:
            raise TypeError(
                f"BertForPreTraining: expected mlm_labels[, nsp] or "
                f"mlm_positions, mlm_ids, mlm_weights[, nsp], got "
                f"{len(rest)} trailing args")

        x = self._encode(input_ids, attention_mask, token_type_ids)

        if mlm_positions is None:
            budget = self.mlm_gather_budget
            mlm_labels = mlm_labels.long()
            if budget:
                # masked positions first, in order: top_k of the 0/1 mask
                # must be STABLE, as jax.lax.top_k is, so sort instead
                P_ = min(int(budget), mlm_labels.shape[1])
                maskf = (mlm_labels >= 0).float()
                w, pos = torch.sort(maskf, dim=1, descending=True,
                                    stable=True)
                w, pos = w[:, :P_], pos[:, :P_]
                ids = torch.clamp(torch.gather(mlm_labels, 1, pos), min=0)
                logits = self._mlm_head(L.gather_positions(x, pos))
                tok_loss = L.vocab_parallel_cross_entropy(logits, ids)
                loss = (torch.sum(tok_loss * w)
                        / torch.clamp(torch.sum(w), min=1.0))
            else:
                logits = self._mlm_head(x)
                tok_loss = L.vocab_parallel_cross_entropy(logits, mlm_labels)
                loss = L.masked_mean_loss(tok_loss, mlm_labels >= 0)
        else:
            logits = self._mlm_head(L.gather_positions(x, mlm_positions))
            tok_loss = L.vocab_parallel_cross_entropy(logits, mlm_ids)
            w = mlm_weights.float()
            loss = torch.sum(tok_loss * w) / torch.clamp(torch.sum(w),
                                                         min=1.0)

        if self.use_nsp and nsp_labels is not None:
            pooled = torch.tanh(x[:, 0] @ self.pool_w.to(x.dtype)
                                + self.pool_b.to(x.dtype))
            nsp_logits = (pooled @ self.nsp_w.to(pooled.dtype)
                          + self.nsp_b.to(pooled.dtype))
            logp = torch.log_softmax(nsp_logits.float(), dim=-1)
            nsp = -torch.mean(torch.gather(
                logp, 1, nsp_labels.long()[:, None])[:, 0])
            loss = loss + nsp
        return loss
