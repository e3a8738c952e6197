"""Mixture-of-Experts blocks with expert parallelism (Switch-style).

The port of ``deepspeed_tpu/models/moe.py``:

* **Routing** is the GShard/Switch dense dispatch-combine formulation: one-
  hot slot tensors contracted with einsums, static shapes, no scatter.
  ``router_top_k=1`` is Switch (the gate is the raw router probability);
  ``router_top_k=2`` is GShard top-2, the gates normalised over the chosen
  pair, the second choices queued behind the first (sequential slot
  assignment by ``cumsum`` plus the earlier choices' ``counts``).
* **Expert parallelism rides the model group**: the expert-stacked FFN
  weights cut their expert dim (dim 1 of the stacked leaves) over the model
  group (``E % mp == 0``), the router is replicated.  Activations are
  model-replicated, so each rank computes the whole router, runs only ITS
  experts' capacity slots, and the partial combines sum over the model
  group.  With the port's Megatron pair (``parallel/comm.py``) that sum is
  ``reduce_from_model`` (identity backward), and the tensors entering the
  rank's own experts (the tokens and the gates) pass ``copy_to_model``
  (all-reduce backward): so the router and the block input get their true
  gradient on every rank, the aux term's share counted once, as every
  replicated leaf of the port does (the JAX mp 1 gradient).
* **Load balancing**: the Switch aux loss ``E * sum_e f_e * P_e`` (the
  first choice's token fraction times the mean router probability, over
  the valid positions), per block, summed over the stack by
  ``transformer.stack_apply_aux``; the model weighs it by ``aux_weight``.

Capacity: ``C = ceil(S * router_top_k * capacity_factor / E)`` slots per
expert (the same Python expression as the JAX package); an overflowing
token falls through with a zero FFN delta for that choice.  The dispatch
and combine are fp32, the expert FFN runs in the activation dtype, and its
first product is named ``ffn1`` for the ``"selective"`` remat policy.

``torch.topk`` guarantees no order among equal values, where
``jax.lax.top_k`` takes the lower index; a stable descending sort
reproduces the JAX choice (it matters when router rows tie, as with a zero
router).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict

import torch
import torch.distributed as dist
import torch.nn.functional as F

from deepspeed_tpu_torch.models import layers as L
from deepspeed_tpu_torch.models import transformer as T
from deepspeed_tpu_torch.parallel import comm

#: the dense FFN leaves the MoE leaves replace
_DENSE_FFN = ("fc_w", "fc_b", "fc2_w", "fc2_b")


@dataclasses.dataclass(frozen=True)
class MoEConfig(T.TransformerConfig):
    num_experts: int = 8
    capacity_factor: float = 1.25
    aux_weight: float = 0.01
    # 1 = Switch (top-1); 2 = GShard-style top-2 with normalised gates
    router_top_k: int = 1

    def validate(self, mp_size: int = 1):
        super().validate(mp_size)
        if self.num_experts % mp_size:
            raise ValueError(
                f"num_experts {self.num_experts} not divisible by the "
                f"model/expert-parallel degree {mp_size}")
        if not 1 <= self.router_top_k <= self.num_experts:
            raise ValueError(
                f"router_top_k {self.router_top_k} must be in "
                f"[1, num_experts={self.num_experts}]")


def init_moe_block_params(cfg: MoEConfig, generator=None,
                          device=None) -> Dict[str, torch.Tensor]:
    """Stacked [L, ...] block parameters: the dense stack's attention and
    LayerNorm leaves plus the router ``[L, h, E]`` and the expert-stacked
    FFN ``exp1_w [L, E, h, ff]``, ``exp1_b``, ``exp2_w [L, E, ff, h]``
    (residual std), ``exp2_b``, in place of ``fc*``.  Same shapes and
    distributions as the JAX package; the random values differ."""
    base = T.init_block_params(cfg, generator, device)
    for k in _DENSE_FFN:
        del base[k]
    lyr, h, e = cfg.num_layers, cfg.hidden_size, cfg.num_experts
    ff = cfg.mlp_ratio * h
    std = cfg.init_std
    resid_std = std / math.sqrt(2.0 * lyr)

    def normal(shape, s):
        t = torch.empty(shape, dtype=torch.float32, device=device)
        return t.normal_(0.0, s, generator=generator)

    base.update({
        "router_w": normal((lyr, h, e), std),
        "exp1_w": normal((lyr, e, h, ff), std),
        "exp1_b": torch.zeros((lyr, e, ff), device=device),
        "exp2_w": normal((lyr, e, ff, h), resid_std),
        "exp2_b": torch.zeros((lyr, e, h), device=device),
    })
    return base


def moe_block_partition_specs() -> Dict[str, object]:
    """The expert dim (dim 1 of the stacked leaves) over the model group;
    the router replicated (the JAX ``moe_block_partition_specs``)."""
    specs = T.block_partition_specs()
    for k in _DENSE_FFN:
        del specs[k]
    specs.update({"router_w": None, "exp1_w": 1, "exp1_b": 1, "exp2_w": 1,
                  "exp2_b": 1})
    return specs


def top_k(probs, k: int):
    """``(values, indices)`` of the ``k`` largest entries of each row,
    largest first, the lower index first among equal values (as
    ``jax.lax.top_k``)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def moe_ffn(x, p, cfg: MoEConfig, group=None, valid=None, seq_group=None):
    """The Switch FFN on this rank's experts.  ``x`` [B, Tk, h] is
    model-replicated; ``p`` holds this rank's slices (the expert dim is
    E / ep local experts).  ``valid`` is an optional [B, Tq] mask (1 real
    token, 0 padding; under sequence parallelism Tq may be the whole
    sequence, and this rank's block of ``seq_group`` is cut from it):
    padding takes no part in the balance statistics and no capacity slot.
    Returns ``(y [B, Tk, h], aux)``."""
    B, Tk, h = x.shape
    E = cfg.num_experts
    S = B * Tk
    e_local = p["exp1_w"].shape[0]
    # each token occupies router_top_k slots, so capacity scales with k
    cap = int(-(-S * cfg.router_top_k * cfg.capacity_factor // E))  # ceil
    xf = x.reshape(S, h)
    v = None
    if valid is not None:
        if seq_group is not None and valid.shape[1] != Tk:
            start = dist.get_rank(seq_group) * Tk
            valid = valid[:, start:start + Tk]
        v = valid.reshape(S).float()

    # -- the router: every rank computes it for every token
    logits = (xf @ p["router_w"].to(xf.dtype)).float()
    probs = torch.softmax(logits, dim=-1)                     # [S, E]
    k = cfg.router_top_k
    topv, topi = top_k(probs, k)                              # [S, k]

    # the aux loss on the FIRST choice, over the valid positions
    oh0 = F.one_hot(topi[:, 0], E).float()
    if v is None:
        frac, pmean = oh0.mean(0), probs.mean(0)
    else:
        n = torch.clamp(v.sum(), min=1.0)
        frac = (oh0 * v[:, None]).sum(0) / n
        pmean = (probs * v[:, None]).sum(0) / n
    aux = E * torch.sum(frac * pmean)

    # -- this rank's experts only: each choice's expert one-hot is sliced
    # BEFORE the outer products, so dispatch and combine stay [S, e, C].
    # The gates enter this rank's share of the combine: their gradient
    # sums over the model group (the aux path above is whole here)
    gates = comm.copy_to_model(topv, group)
    gate_norm = gates.sum(-1)
    lo = (0 if group is None else dist.get_rank(group)) * e_local
    disp = torch.zeros((S, e_local, cap), dtype=torch.float32,
                       device=x.device)
    comb = torch.zeros_like(disp)
    counts = torch.zeros((E,), dtype=torch.float32, device=x.device)
    for j in range(k):
        oh = F.one_hot(topi[:, j], E).float()                 # [S, E]
        if v is not None:
            oh = oh * v[:, None]    # padding takes no capacity slot
        # the slot of each token in its expert's queue, behind the earlier
        # choices' tokens (GShard's sequential assignment)
        pos = torch.sum((torch.cumsum(oh, 0) + counts[None, :] - 1.0) * oh,
                        dim=-1)
        keep = (pos < cap) & (pos >= 0)
        # jax.nn.one_hot gives a zero row out of range; F.one_hot raises
        onehot_c = F.one_hot(pos.long().clamp(0, cap - 1), cap).float() \
            * keep[:, None].float()
        disp_j = oh[:, lo:lo + e_local, None] * onehot_c[:, None, :]
        disp = disp + disp_j
        if k == 1:
            gate_j = gates[:, 0]    # Switch: the raw router probability
        else:
            gate_j = gates[:, j] / torch.clamp(gate_norm, min=1e-9)
        comb = comb + disp_j * gate_j[:, None, None]
        counts = counts + oh.sum(0)

    # gather the capacity slots and run the local experts' FFN batched
    xe = comm.copy_to_model(xf, group)
    ein = torch.einsum("sec,sh->ech", disp, xe.float()).to(x.dtype)
    y = L.gelu(L.named_linear(ein, p["exp1_w"], p["exp1_b"], name="ffn1"))
    y = L.named_linear(y, p["exp2_w"], p["exp2_b"])
    # combine back to token order: this rank's experts' part, summed over
    # the model group
    out = torch.einsum("sec,ech->sh", comb, y.float())
    out = comm.reduce_from_model(out, group)
    return out.to(x.dtype).reshape(B, Tk, h), aux


def moe_stack_apply(x, stacked, cfg: MoEConfig, attn_mask=None, group=None,
                    z3_dims=None, z3_group=None, z3_prefetch=False,
                    seq_group=None):
    """The MoE blocks over the stacked [L, ...] leaves (the attention mask
    doubles as the router's validity mask); returns ``(x, aux_sum)``.
    Every route of ``stack_apply`` applies: remat, the ZeRO-3 per-layer
    gather and its layer-pair prefetch."""
    def ffn(u, p):
        return moe_ffn(u, p, cfg, group=group, valid=attn_mask,
                       seq_group=seq_group)

    return T.stack_apply_aux(x, stacked, cfg, attn_mask, group, z3_dims,
                             z3_group, z3_prefetch, seq_group, ffn=ffn)
