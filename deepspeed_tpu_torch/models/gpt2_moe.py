"""GPT-2 with Switch-style Mixture-of-Experts FFNs (expert parallelism).

The port of ``deepspeed_tpu/models/gpt2_moe.py``: every block's FFN is a
capacity-routed top-k MoE (``models/moe.py``), the expert dim is cut over
the model group, and the Switch load-balancing aux loss joins the LM loss
weighted by ``aux_weight``.  Thin subclasses: only the block-stack hooks
differ (``_init_blocks``, ``_block_specs``, ``_stack``); the embeddings,
the vocab-parallel head and the engine hooks are GPT-2's.

``GPT2MoEPipelined`` is MoE x pipeline parallelism: the expert-stacked
leaves are cut along their layer dim over the stages AND along their
expert dim over the model group; each stage's weighted aux term rides the
schedule's aux channel (``parallel/pipeline.py``: summed over the stages
and divided by the number of micro-batches, its gradient seeded with
``1 / m`` in both schedules).
"""

from __future__ import annotations

from deepspeed_tpu_torch.models import moe as M
from deepspeed_tpu_torch.models.gpt2 import GPT2, GPT2_SIZES
from deepspeed_tpu_torch.models.pipeline_gpt2 import GPT2Pipelined


def _moe_config(size, num_experts, capacity_factor, aux_weight,
                router_top_k, overrides) -> M.MoEConfig:
    kw = dict(GPT2_SIZES[size])
    kw.update(overrides)
    kw.setdefault("pre_ln", True)
    kw.setdefault("causal", True)
    return M.MoEConfig(num_experts=num_experts,
                       capacity_factor=capacity_factor,
                       aux_weight=aux_weight, router_top_k=router_top_k,
                       **kw)


class GPT2MoE(GPT2):
    """``forward(tokens, labels)``: the mean LM loss plus ``aux_weight``
    times the layers' summed load-balancing terms."""

    @classmethod
    def from_size(cls, size: str, num_experts: int = 8,
                  capacity_factor: float = 1.25, aux_weight: float = 0.01,
                  router_top_k: int = 1, generator=None, device=None,
                  **overrides) -> "GPT2MoE":
        return cls(_moe_config(size, num_experts, capacity_factor,
                               aux_weight, router_top_k, overrides),
                   generator=generator, device=device)

    _init_blocks = staticmethod(M.init_moe_block_params)
    _block_specs = staticmethod(M.moe_block_partition_specs)

    def _stack(self, x, blocks, z3_dims=None):
        x, aux = M.moe_stack_apply(
            x, blocks, self.config, group=self.model_group,
            z3_dims=z3_dims, z3_group=self.data_group,
            z3_prefetch=self.zero3_prefetch, seq_group=self.seq_group)
        return x, self.config.aux_weight * aux


class GPT2MoEPipelined(GPT2Pipelined):
    """MoE x pipeline parallelism (see the module docstring)."""

    @classmethod
    def from_size(cls, size: str, num_experts: int = 8,
                  capacity_factor: float = 1.25, aux_weight: float = 0.01,
                  router_top_k: int = 1, num_micro_batches: int = 2,
                  schedule: str = "gpipe", generator=None, device=None,
                  **overrides) -> "GPT2MoEPipelined":
        return cls(_moe_config(size, num_experts, capacity_factor,
                               aux_weight, router_top_k, overrides),
                   num_micro_batches, schedule, generator=generator,
                   device=device)

    _init_blocks = staticmethod(M.init_moe_block_params)
    _block_specs = staticmethod(M.moe_block_partition_specs)
    _stack = GPT2MoE._stack
