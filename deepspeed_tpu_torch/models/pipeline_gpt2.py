"""GPT-2 with pipeline-parallel layer stages.

The port of ``deepspeed_tpu/models/pipeline_gpt2.py`` (``GPT2Pipelined``):
the same parameters and math as ``models.gpt2.GPT2``, but the stacked
block leaves are cut along their layer dim over the pipe axis
(``pipe_specs``: the JAX ``partition_specs`` put dim 0 of every block
leaf on ``pipe``), and the forward runs through
``parallel.pipeline.pipeline_loss``: stage 0 embeds, each stage applies
its ``L / pp`` layers to ``num_micro_batches`` micro-batches, and the head
is sharded over the stages when the micro-batch size divides by pp.  The
embeddings and the final LayerNorm are held whole by every stage; their
gradients sum over the pipe group inside the schedule.

The engine cuts the parameters by ``pipe_specs()`` (and, under tensor
parallelism, by ``partition_specs()``) and sets ``pipe``, this process's
``PipeContext``; without one the model runs as a one-stage pipeline.
``schedule`` is ``"gpipe"`` or ``"1f1b"``; the engine's
``pipeline_schedule`` config key overrides it.

Under ZeRO-3 the leaves outside the block stack are gathered at entry
(``transformer.zero3_enter``) and the stage stack gathers each layer's
weights inside the block body, in both schedules and in 1F1B's recompute
(the JAX ``pipeline_gpt2.py:72-111``).  Under sequence parallelism the
pipeline streams this rank's sequence block (activations ``[mb, T / sp,
h]``), ring or Ulysses attention runs inside the stage body, and the
loss's token count is this block's, as in the JAX package: the engine's
mean over the seq group is then the mean of the blocks' means (ROADMAP
Queue 3, the pp x sp loss).
"""

from __future__ import annotations

import torch

from deepspeed_tpu_torch.models import layers as L
from deepspeed_tpu_torch.models import transformer as T
from deepspeed_tpu_torch.models.gpt2 import GPT2, GPT2_SIZES
from deepspeed_tpu_torch.parallel import pipeline as pipe_mod


class GPT2Pipelined(GPT2):
    """``num_micro_batches`` micro-batches stream through the stages per
    forward; the batch must divide evenly.  ``last_pipe_stats`` holds
    ``max_held_inputs`` of the last forward (1F1B's held stage inputs)."""

    def __init__(self, config: T.TransformerConfig, num_micro_batches=2,
                 schedule="gpipe", generator=None, device=None):
        super().__init__(config, generator=generator, device=device)
        self.num_micro_batches = int(num_micro_batches)
        self.schedule = schedule
        #: this process's stage of the pipeline (the engine sets it)
        self.pipe = None
        self.last_pipe_stats = {}

    @classmethod
    def from_size(cls, size: str, num_micro_batches: int = 2,
                  schedule: str = "gpipe", generator=None, device=None,
                  **overrides):
        kw = dict(GPT2_SIZES[size])
        kw.update(overrides)
        kw.setdefault("pre_ln", True)
        kw.setdefault("causal", True)
        return cls(T.TransformerConfig(**kw), num_micro_batches, schedule,
                   generator=generator, device=device)

    def pipe_specs(self):
        """The dim of each leaf cut over the pipe axis (None: every stage
        holds it whole): dim 0, the layer stack, of every block leaf."""
        return {"wte": None, "wpe": None,
                "blocks": {k: 0 for k in self._block_specs()},
                "lnf_s": None, "lnf_b": None}

    def forward(self, tokens, labels):
        cfg = self.config
        B, T_len = tokens.shape
        m = self.num_micro_batches
        if B % m:
            raise ValueError(f"per-shard batch {B} not divisible by "
                             f"num_micro_batches={m}")
        if self.schedule not in pipe_mod.SCHEDULES:
            raise ValueError(f"unknown pipeline schedule {self.schedule!r} "
                             f"(expected 'gpipe' or '1f1b')")
        mb, group = B // m, self.model_group
        params, z3 = T.zero3_enter(dict(self.named_parameters()),
                                   self.zero3_dims, self.data_group)
        toks = tokens.reshape(m, mb, T_len)

        def embed(p, i):
            x = L.vocab_parallel_embedding(toks[i], p["wte"], group)
            return x + L.seq_shard_positions(p["wpe"], T_len,
                                             self.seq_group).to(x.dtype)[None]

        def stage(p, u):
            return self._pipe_stack(u, T.subtree(p, "blocks"),
                                    z3_dims=z3.get("blocks"))

        def head(p, y, lab):
            h = L.layer_norm(y, p["lnf_s"], p["lnf_b"], cfg.ln_eps)
            logits = L.vocab_parallel_logits(h, p["wte"], group)
            ce = L.vocab_parallel_cross_entropy(logits, lab, group)
            return torch.sum(ce * (lab >= 0).float())

        count = torch.clamp(torch.sum(labels >= 0).float(), min=1.0)
        self.last_pipe_stats = {}
        return pipe_mod.pipeline_loss(
            self.pipe, self.schedule, params, embed, stage, head,
            labels.reshape(m, mb, T_len), count, m,
            act_shape=(mb, T_len, cfg.hidden_size),
            act_dtype=params["wte"].dtype,
            replicated=[k for k in params if not k.startswith("blocks.")],
            stats=self.last_pipe_stats)

    def _pipe_stack(self, u, blocks, z3_dims=None):
        """Stage-stack hook: returns ``(y, aux)``, aux a scalar loss term
        (0.0 here; the MoE variant returns its weighted load-balancing
        term).  Under ZeRO-3 ``z3_dims`` are the stacked leaves' partition
        dims."""
        y, aux = self._stack(u, blocks, z3_dims)
        return y, 0.0 if aux is None else aux
