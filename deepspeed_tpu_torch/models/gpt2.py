"""GPT-2 causal LM.

The port of ``GPT2`` from ``deepspeed_tpu/models/gpt2.py``: pre-LN causal
blocks, learned position embeddings, the LM head tied to the token
embedding, and the per-token cross-entropy averaged over labels >= 0.
Parameter names, shapes and init distributions are the JAX pytree's
(``wte``, ``wpe``, ``blocks.*``, ``lnf_s``, ``lnf_b``), so ``weights.py``
copies weights across name for name.  Under tensor parallelism
(``partition_specs``, ``gpt2.py:97-103``) ``wte`` is vocab-parallel, the
blocks Megatron-sharded, and the rest replicated.

Under ZeRO-3 (``zero3_dims``, set by the engine, ``gpt2.py:50-58``) the
leaves outside the block stack are gathered at entry and each layer's
weights inside the block body (``transformer.zero3_enter``,
``stack_apply``).  Under sequence parallelism (``seq_group``, set by the
engine, which hands each rank its block of the sequence by
``batch_specs``) the positions are the rank's block of the table and the
loss's token count sums over the seq group.  The block stack runs
through the ``_stack`` hook, ``(x, aux)``, whose aux term joins the loss
(the JAX ``gpt2.py:119-124``, ``:199-204``); ``models/gpt2_moe.py``'s
``GPT2MoE`` overrides it, with ``_init_blocks`` and ``_block_specs``.

Serving (``gpt2.py:126-187``): ``kv_cache_dims`` declares what the KV page
pool holds per token, and ``apply_extend`` / ``apply_decode`` run a block
of new tokens / one token a slot against the pool, which they write in
place (``deepspeed_tpu_torch/inference/``).  Both take a JAX-layout tree of
tensors (``params``: the serving engine's, or its int8 tree; None: the
module's own parameters).
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from deepspeed_tpu_torch.models import layers as L
from deepspeed_tpu_torch.models import transformer as T

# The published GPT-2 size ladder and the reference's perf-test shapes.
GPT2_SIZES = {
    "tiny":   dict(num_layers=2,  hidden_size=128,  num_heads=4,
                   max_seq_len=128, vocab_size=512),
    "small":  dict(num_layers=12, hidden_size=768,  num_heads=12),
    "medium": dict(num_layers=24, hidden_size=1024, num_heads=16),
    "large":  dict(num_layers=24, hidden_size=1536, num_heads=16),
    "xl-1.5b": dict(num_layers=48, hidden_size=1600, num_heads=25),
    # 16 heads, not the published 25, so tensor parallelism divides evenly
    "xl-1.5b-perf": dict(num_layers=48, hidden_size=1600, num_heads=16),
    "4b":     dict(num_layers=64, hidden_size=2304, num_heads=24),
    "8b":     dict(num_layers=72, hidden_size=3072, num_heads=24),
    "20b":    dict(num_layers=111, hidden_size=3808, num_heads=32),
}


class GPT2(nn.Module):
    """``forward(tokens, labels)`` returns the scalar fp32 mean LM loss;
    tokens and labels are int [B, T], labels < 0 are ignored."""

    def __init__(self, config: T.TransformerConfig, generator=None,
                 device=None):
        super().__init__()
        config.validate()
        self.config = config
        h, std = config.hidden_size, config.init_std

        def normal(s, *shape):
            t = torch.empty(shape, dtype=torch.float32, device=device)
            return nn.Parameter(t.normal_(0.0, s, generator=generator))

        self.wte = normal(std, config.vocab_size, h)
        self.wpe = normal(std * 0.5, config.max_seq_len, h)
        self.blocks = T.TransformerStack(config, generator, device,
                                         init=self._init_blocks)
        self.lnf_s = nn.Parameter(torch.ones(h, device=device))
        self.lnf_b = nn.Parameter(torch.zeros(h, device=device))
        #: the model process group (None: one model shard); the engine
        #: sets it after narrowing the parameters to this rank's slices
        self.model_group = None
        #: ZeRO-3 partition dims ({dotted name: dim}, -1 replicated) and
        #: the data group the partitioned leaves gather over; the engine
        #: sets both at stage 3
        self.zero3_dims = None
        self.data_group = None
        #: ZeRO-3 gather prefetch (the engine's overlap_comm): layer
        #: pairs, the second layer's gather issued before the first runs
        self.zero3_prefetch = False
        #: the seq process group (None: the whole sequence on this rank);
        #: the engine sets it under context parallelism
        self.seq_group = None

    @classmethod
    def from_size(cls, size: str, generator=None, device=None, **overrides):
        kw = dict(GPT2_SIZES[size])
        kw.update(overrides)
        kw.setdefault("pre_ln", True)
        kw.setdefault("causal", True)
        return cls(T.TransformerConfig(**kw), generator=generator,
                   device=device)

    def validate(self, mp_size: int = 1):
        """Engine hook: shape checks against the model-parallel degree."""
        self.config.validate(mp_size)

    def partition_specs(self):
        """The sharded dim of each leaf over the model group (None:
        replicated)."""
        return {"wte": 0, "wpe": None, "blocks": self._block_specs(),
                "lnf_s": None, "lnf_b": None}

    # block-stack hooks (GPT2MoE overrides all three)
    _init_blocks = staticmethod(T.init_block_params)
    _block_specs = staticmethod(T.block_partition_specs)

    def _stack(self, x, blocks, z3_dims=None):
        """The block stack on ``x``: ``(x, aux)``, aux a scalar loss term
        or None."""
        return T.stack_apply(x, blocks, self.config, group=self.model_group,
                             z3_dims=z3_dims, z3_group=self.data_group,
                             z3_prefetch=self.zero3_prefetch,
                             seq_group=self.seq_group), None

    def zero3_min_dims(self):
        """Engine hook (stage 3): the lowest partitionable dim per leaf.
        Block leaves pin dim >= 1: their dim 0 is the layer stack."""
        return T.zero3_min_dims(self)

    def batch_specs(self, batch):
        """Engine hook: tokens and labels are [B, T], cut along the
        sequence over the seq group."""
        return T.token_batch_specs(batch)

    def with_config(self, **changes) -> None:
        """Replace config fields (the engine's activation-checkpointing
        override), keeping the weights."""
        self.config = dataclasses.replace(self.config, **changes)

    def forward(self, tokens, labels):
        cfg = self.config
        T_len = tokens.shape[1]
        group = self.model_group
        p, z3 = T.zero3_enter(dict(self.named_parameters()), self.zero3_dims,
                              self.data_group)
        x = L.vocab_parallel_embedding(tokens, p["wte"], group)
        x = x + L.seq_shard_positions(p["wpe"], T_len, self.seq_group).to(
            x.dtype)[None]
        x, aux = self._stack(x, T.subtree(p, "blocks"), z3.get("blocks"))
        x = L.layer_norm(x, p["lnf_s"], p["lnf_b"], cfg.ln_eps)
        logits = L.vocab_parallel_logits(x, p["wte"], group)
        loss = L.vocab_parallel_cross_entropy(logits, labels, group)
        loss = L.masked_mean_loss(loss, labels >= 0, self.seq_group)
        return loss if aux is None else loss + aux

    # ------------------------------------------------- serving (inference/)

    def kv_cache_dims(self, mp_size: int = 1):
        """(num_layers, local kv heads, head_dim): what the serving KV pool
        holds per token on one model shard."""
        cfg = self.config
        return (cfg.num_layers, cfg.num_heads // mp_size,
                cfg.hidden_size // cfg.num_heads)

    def _serve_params(self, params):
        if params is not None:
            return params
        from deepspeed_tpu_torch import weights
        return weights.unflatten_tree(dict(self.named_parameters()))

    @torch.no_grad()
    def apply_extend(self, params, tokens, k, v, pos, n_new, rows):
        """A block of new tokens forwarded against the KV page pool:
        prefill (``pos`` 0), tail prefill over a reused prefix (``pos`` =
        the reused tokens) and the speculative verify, one program shape.

        tokens: int [B, E], left-aligned (``n_new[b]`` real); k, v: [L, R +
        1, n_local, d] pools (row R the drop row), written in place; pos:
        int [B], each slot's first new position; rows: int [B, cap], the
        page-table row map.  Returns ``(logits [B, E, vocab / mp], k, v)``:
        logits for every block position (pad positions' are garbage)."""
        cfg, group = self.config, self.model_group
        p = self._serve_params(params)
        E = tokens.shape[1]
        x = L.vocab_parallel_embedding(tokens, p["wte"], group)
        wpe = p["wpe"]
        positions = torch.clamp(
            pos.long()[:, None]
            + torch.arange(E, dtype=torch.int64, device=tokens.device)[None],
            0, wpe.shape[0] - 1)
        x = x + wpe[positions].to(x.dtype)
        x, k, v = T.stack_extend(x, p["blocks"], cfg, k, v, rows, pos, n_new,
                                 group=group)
        x = L.layer_norm(x, p["lnf_s"], p["lnf_b"], cfg.ln_eps)
        return L.vocab_parallel_logits(x, p["wte"], group), k, v

    @torch.no_grad()
    def apply_decode(self, params, tokens, k, v, pos, active, rows,
                     ring: bool = False):
        """One incremental decode step.

        tokens: int [B], each slot's input token; k, v: [L, R + 1, n_local,
        d] pools, written in place; pos: int [B], the position the new
        token takes; active: bool [B] (an inactive slot writes only the
        drop row and keeps its position; its logits are meaningless);
        rows: int [B, cap].  Returns ``(logits [B, vocab / mp], k, v,
        pos')`` with ``pos' = pos + active``."""
        cfg, group = self.config, self.model_group
        p = self._serve_params(params)
        cap = rows.shape[1]
        pos_l = pos.long()
        write_idx = (pos_l % cap) if ring else torch.clamp(pos_l, 0, cap - 1)
        wrow = torch.gather(rows.long(), 1, write_idx[:, None])[:, 0]
        wrow = torch.where(active, wrow, k.shape[1] - 1)    # the drop row
        x = L.vocab_parallel_embedding(tokens[:, None], p["wte"], group)
        wpe = p["wpe"]
        prow = wpe[torch.clamp(pos_l, 0, wpe.shape[0] - 1)]
        x = x + prow[:, None].to(x.dtype)
        x, k, v = T.stack_decode(x, p["blocks"], cfg, k, v, pos, rows, wrow,
                                 ring=ring, group=group)
        x = L.layer_norm(x, p["lnf_s"], p["lnf_b"], cfg.ln_eps)
        logits = L.vocab_parallel_logits(x[:, 0], p["wte"], group)
        return logits, k, v, pos + active.to(pos.dtype)
