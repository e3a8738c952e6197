"""BERT pretraining (MLM + optional NSP) and the SQuAD span model.

The port of ``BertForPreTraining`` and ``BertForQuestionAnswering`` from
``deepspeed_tpu/models/bert.py``: post-LN encoder, MLM head tied to the
word embedding, both MLM batch formats (dense labels; masked positions
``[B, P]``), the optional NSP head, the ``mlm_gather_budget`` sparse head,
and the span head of the fine-tune.  Parameter names and shapes are the
JAX pytree's (``wte``, ``blocks.qkv_w``, ``mlm_bias``, ...), so
``weights.py`` copies weights across name for name.  Under tensor
parallelism (``partition_specs``, ``bert.py:52-57,147-156``) ``wte`` and
``mlm_bias`` ride the vocab shard, the blocks are Megatron-sharded, and the
pooler, NSP, MLM dense and MLM LayerNorm, the span head and the other
embeddings are replicated.  Under ZeRO-3 (``zero3_dims``, set by the
engine, ``bert.py:77-109``) the leaves outside the block stack are
gathered at entry and each layer's weights inside the block body
(``transformer.zero3_enter``, ``stack_apply``).  Under sequence
parallelism (``seq_group``, set by the engine, which hands each rank its
block of the sequence by ``batch_specs``) the encoder runs on the rank's
block and the dense-labels MLM loss counts tokens over the seq group;
what needs the whole sequence on one rank raises the JAX package's
errors: the masked-positions MLM, NSP and the span logits.
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


class _BertBackbone(nn.Module):
    """The embeddings (word, position, token type) and the encoder stack
    that pretraining and fine-tuning share, under the JAX leaf names."""

    def __init__(self, config: T.TransformerConfig, generator=None,
                 device=None):
        super().__init__()
        config.validate()
        self.config = config
        h = config.hidden_size
        self.wte = self._normal(generator, device, config.vocab_size, h)
        self.wpe = self._normal(generator, device, config.max_seq_len, h)
        self.wtt = self._normal(generator, device, 2, h)
        self.ln_emb_s = self._const(device, 1.0, h)
        self.ln_emb_b = self._const(device, 0.0, h)
        self.blocks = T.TransformerStack(config, generator, device)
        #: the model process group (None: one model shard); the engine
        #: sets it after narrowing the parameters to this rank's slices
        self.model_group = None
        #: ZeRO-3 partition dims, the data group they gather over, and the
        #: gather prefetch; the engine sets them at stage 3
        self.zero3_dims = None
        self.data_group = None
        self.zero3_prefetch = False
        #: the seq process group (None: the whole sequence on this rank);
        #: the engine sets it under context parallelism
        self.seq_group = None

    def _normal(self, generator, device, *shape):
        t = torch.empty(shape, dtype=torch.float32, device=device)
        return nn.Parameter(t.normal_(0.0, self.config.init_std,
                                      generator=generator))

    @staticmethod
    def _const(device, value, *shape):
        return nn.Parameter(torch.full(shape, value, dtype=torch.float32,
                                       device=device))

    @staticmethod
    def _size_config(size: str, overrides) -> T.TransformerConfig:
        kw = dict(BERT_SIZES[size])
        kw.update(overrides)
        kw.setdefault("pre_ln", False)   # BERT is post-LN
        kw.setdefault("causal", False)
        return T.TransformerConfig(**kw)

    def validate(self, mp_size: int = 1):
        """Engine hook: shape checks against the model-parallel degree."""
        self.config.validate(mp_size)

    def partition_specs(self):
        """The sharded dim of each leaf over the model group (None:
        replicated): the vocab-parallel ``wte`` and ``mlm_bias``, the
        Megatron blocks, every other leaf replicated."""
        specs = {k: None for k, _ in self.named_parameters()
                 if not k.startswith("blocks.")}
        specs.update(wte=0, blocks=T.block_partition_specs())
        if "mlm_bias" in specs:
            specs["mlm_bias"] = 0
        return specs

    def zero3_min_dims(self):
        """Engine hook (stage 3): the lowest partitionable dim per leaf.
        Block leaves pin dim >= 1: their dim 0 is the layer stack."""
        return T.zero3_min_dims(self)

    def with_config(self, **changes) -> None:
        """Replace config fields (the engine's activation-checkpointing
        override), keeping the weights."""
        self.config = dataclasses.replace(self.config, **changes)

    def _enter(self):
        """``(params, block dims)``: the parameters by dotted name, those
        outside the block stack gathered under ZeRO-3."""
        p, z3 = T.zero3_enter(dict(self.named_parameters()), self.zero3_dims,
                              self.data_group)
        return p, z3.get("blocks")

    def _encode(self, p, z3, input_ids, attention_mask, token_type_ids):
        cfg = self.config
        T_len = input_ids.shape[1]
        x = L.vocab_parallel_embedding(input_ids, p["wte"], self.model_group)
        x = x + L.seq_shard_positions(p["wpe"], T_len, self.seq_group).to(
            x.dtype)[None]
        x = x + torch.nn.functional.embedding(token_type_ids.long(),
                                              p["wtt"].to(x.dtype))
        x = L.layer_norm(x, p["ln_emb_s"], p["ln_emb_b"], cfg.ln_eps)
        return T.stack_apply(x, T.subtree(p, "blocks"), cfg,
                             attn_mask=attention_mask,
                             group=self.model_group, z3_dims=z3,
                             z3_group=self.data_group,
                             z3_prefetch=self.zero3_prefetch,
                             seq_group=self.seq_group)


class BertForPreTraining(_BertBackbone):
    """``forward(input_ids, attention_mask, token_type_ids, *rest)`` returns
    the scalar fp32 loss.  ``rest`` is ``mlm_labels[, nsp_labels]`` (dense
    labels, < 0 ignored) or ``mlm_positions, mlm_ids, mlm_weights[,
    nsp_labels]`` (masked positions, ``[B, P]`` each)."""

    def __init__(self, config: T.TransformerConfig, use_nsp: bool = False,
                 mlm_gather_budget=None, generator=None, device=None):
        super().__init__(config, generator, device)
        self.use_nsp = use_nsp
        #: dense-labels MLM only: gather up to this many masked positions
        #: per sequence before the vocab projection (exact while every
        #: sequence's masked count fits; see the JAX field docstring)
        self.mlm_gather_budget = mlm_gather_budget
        h = config.hidden_size
        self.mlm_dense_w = self._normal(generator, device, h, h)
        self.mlm_dense_b = self._const(device, 0.0, h)
        self.mlm_ln_s = self._const(device, 1.0, h)
        self.mlm_ln_b = self._const(device, 0.0, h)
        self.mlm_bias = self._const(device, 0.0, config.vocab_size)
        if use_nsp:
            self.pool_w = self._normal(generator, device, h, h)
            self.pool_b = self._const(device, 0.0, h)
            self.nsp_w = self._const(device, 0.0, h, 2)
            self.nsp_b = self._const(device, 0.0, 2)

    @classmethod
    def from_size(cls, size: str, use_nsp: bool = False,
                  mlm_gather_budget=None, generator=None, device=None,
                  **overrides):
        return cls(cls._size_config(size, overrides), use_nsp=use_nsp,
                   mlm_gather_budget=mlm_gather_budget, generator=generator,
                   device=device)

    def batch_specs(self, batch):
        """Engine hook, by batch format: the ids, mask and token types and
        dense ``mlm_labels`` are [B, T], cut along the sequence; the
        masked-positions leaves are [B, P] (P is not the sequence) and the
        NSP labels [B]: every rank of the seq group takes them whole."""
        rest = len(tuple(batch)) - 3
        if rest in (1, 2):
            specs = [1, 1, 1, 1]
        elif rest in (3, 4):
            specs = [1, 1, 1, None, None, None]
        else:
            raise TypeError(
                f"BertForPreTraining batch: expected 4-7 leaves, "
                f"got {len(tuple(batch))}")
        if rest in (2, 4):
            specs.append(None)
        return tuple(specs)

    def _mlm_head(self, p, h):
        """Dense + GELU + LN + tied vocab decoder on [..., H]."""
        g = L.gelu(h @ p["mlm_dense_w"].to(h.dtype)
                   + p["mlm_dense_b"].to(h.dtype))
        g = L.layer_norm(g, p["mlm_ln_s"], p["mlm_ln_b"], self.config.ln_eps)
        logits = L.vocab_parallel_logits(g, p["wte"], self.model_group)
        return logits + p["mlm_bias"].to(logits.dtype)

    def forward(self, input_ids, attention_mask, token_type_ids, *rest):
        if len(rest) in (1, 2):
            mlm_labels = rest[0]
            nsp_labels = rest[1] if len(rest) == 2 else None
            mlm_positions = None
        elif len(rest) in (3, 4):
            mlm_positions, mlm_ids, mlm_weights = rest[:3]
            nsp_labels = rest[3] if len(rest) == 4 else None
            if self.seq_group is not None:
                raise NotImplementedError(
                    "masked-positions MLM gathers global sequence positions "
                    "— use dense mlm_labels under context_parallel_size > 1")
        else:
            raise TypeError(
                f"BertForPreTraining: expected mlm_labels[, nsp] or "
                f"mlm_positions, mlm_ids, mlm_weights[, nsp], got "
                f"{len(rest)} trailing args")

        p, z3 = self._enter()
        x = self._encode(p, z3, input_ids, attention_mask, token_type_ids)

        if mlm_positions is None:
            budget = self.mlm_gather_budget
            mlm_labels = mlm_labels.long()
            if budget and self.seq_group is None:
                # masked positions first, in order: top_k of the 0/1 mask
                # must be STABLE, as jax.lax.top_k is, so sort instead
                P_ = min(int(budget), mlm_labels.shape[1])
                maskf = (mlm_labels >= 0).float()
                w, pos = torch.sort(maskf, dim=1, descending=True,
                                    stable=True)
                w, pos = w[:, :P_], pos[:, :P_]
                ids = torch.clamp(torch.gather(mlm_labels, 1, pos), min=0)
                logits = self._mlm_head(p, L.gather_positions(x, pos))
                tok_loss = L.vocab_parallel_cross_entropy(logits, ids,
                                                         self.model_group)
                loss = (torch.sum(tok_loss * w)
                        / torch.clamp(torch.sum(w), min=1.0))
            else:
                logits = self._mlm_head(p, x)
                tok_loss = L.vocab_parallel_cross_entropy(
                    logits, mlm_labels, self.model_group)
                loss = L.masked_mean_loss(tok_loss, mlm_labels >= 0,
                                          self.seq_group)
        else:
            logits = self._mlm_head(p, L.gather_positions(x, mlm_positions))
            tok_loss = L.vocab_parallel_cross_entropy(logits, mlm_ids,
                                                     self.model_group)
            w = mlm_weights.float()
            loss = torch.sum(tok_loss * w) / torch.clamp(torch.sum(w),
                                                         min=1.0)

        if self.use_nsp and nsp_labels is not None:
            if self.seq_group is not None:
                raise NotImplementedError(
                    "NSP pools the global [CLS] token, which lives only on "
                    "sequence shard 0 — NSP is not supported under "
                    "context_parallel_size > 1")
            pooled = torch.tanh(x[:, 0] @ p["pool_w"].to(x.dtype)
                                + p["pool_b"].to(x.dtype))
            nsp_logits = (pooled @ p["nsp_w"].to(pooled.dtype)
                          + p["nsp_b"].to(pooled.dtype))
            logp = torch.log_softmax(nsp_logits.float(), dim=-1)
            nsp = -torch.mean(torch.gather(
                logp, 1, nsp_labels.long()[:, None])[:, 0])
            loss = loss + nsp
        return loss


class BertForQuestionAnswering(_BertBackbone):
    """The SQuAD span-extraction fine-tune model (the port of the JAX
    package's ``BertForQuestionAnswering``): the backbone and a span head
    ``qa_w [h, 2]``, ``qa_b [2]``.  ``forward(input_ids, attention_mask,
    token_type_ids, start_positions, end_positions)`` returns the mean of
    the start and end cross-entropies over the unpadded positions."""

    def __init__(self, config: T.TransformerConfig, generator=None,
                 device=None):
        super().__init__(config, generator, device)
        self.qa_w = self._normal(generator, device, config.hidden_size, 2)
        self.qa_b = self._const(device, 0.0, 2)

    @classmethod
    def from_size(cls, size: str, generator=None, device=None, **overrides):
        return cls(cls._size_config(size, overrides), generator=generator,
                   device=device)

    def batch_specs(self, batch):
        """Engine hook: the ids, mask and token types are [B, T], cut along
        the sequence; the start and end positions are per example."""
        return (1, 1, 1, None, None)

    def span_logits(self, input_ids, attention_mask, token_type_ids):
        """(start_logits, end_logits), each fp32 [B, T]."""
        if self.seq_group is not None:
            raise NotImplementedError(
                "span extraction softmaxes over the FULL sequence and "
                "indexes global positions — not supported under "
                "context_parallel_size > 1 (fine-tune lengths don't need it)")
        p, z3 = self._enter()
        x = self._encode(p, z3, input_ids, attention_mask, token_type_ids)
        logits = (x @ p["qa_w"].to(x.dtype)
                  + p["qa_b"].to(x.dtype)).float()
        return logits[..., 0], logits[..., 1]

    def forward(self, input_ids, attention_mask, token_type_ids,
                start_positions, end_positions):
        start_logits, end_logits = self.span_logits(
            input_ids, attention_mask, token_type_ids)
        valid = attention_mask.bool()

        def span_loss(lg, pos):
            lg = torch.where(valid, lg, torch.full_like(lg, -1e9))
            logp = torch.log_softmax(lg, dim=-1)
            return -torch.mean(torch.gather(
                logp, 1, pos.long()[:, None])[:, 0])

        return 0.5 * (span_loss(start_logits, start_positions)
                      + span_loss(end_logits, end_positions))
