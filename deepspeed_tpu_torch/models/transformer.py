"""The transformer stack BERT builds on.

The port of ``deepspeed_tpu/models/transformer.py``.  Block
parameters stay STACKED on a leading layer axis, one ``nn.Parameter``
``[L, ...]`` per weight kind, exactly the JAX leaves: LAMB's per-tensor trust
ratio spans all L layers of a kind in both packages.  ``stack_apply`` walks
the layers with a Python loop over ``unbind(0)`` views (one stack in the
backward, not L full-size scatters), where the JAX package scans.

Rematerialisation (``TransformerConfig.remat``/``remat_policy``):

* ``remat=False``: nothing recomputed;
* ``"full"``: each block under ``torch.utils.checkpoint`` (non-reentrant);
* ``"dots"``: a selective-checkpoint policy that saves every matrix-product
  output and recomputes the rest (``jax.checkpoint_policies.dots_saveable``);
* ``"selective"``: saves only the named ``qkv`` and ``ffn1`` (pre-GELU)
  products and recomputes the rest (``save_only_these_names("qkv",
  "ffn1")``): ``_SelectiveRemat`` runs the block without a graph, keeping
  its input and the two named outputs (``layers.named_saves``), and its
  backward replays the block with the saved products handed back, so it
  replays neither product.  PyTorch's selective checkpointing would select
  by operator through a dispatch mode in Python on every op of the block,
  which made a BERT-large step at seq 512 2.4x slower on an H100 (PERF.md).

ZeRO-3 (``zero3.py``): ``zero3_enter`` gathers the leaves outside the block
stack at the model's entry, and ``stack_apply`` gathers each layer's slice
of the partitioned stack inside the (rematerialised) block body, pairing
the gathers under ``z3_prefetch``.

Sequence parallelism: ``stack_apply`` hands the seq group and
``TransformerConfig.sp_impl`` (``"ring"`` or ``"ulysses"``) to every
block's attention; a recompute replays the ring's shifts and Ulysses'
all-to-alls in the same order on every rank.  ``token_batch_specs`` is the
batch layout of the [B, T] token models: the dim of each batch leaf cut
over the seq group.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Dict

import torch
from torch import nn
from torch.utils import checkpoint as torch_checkpoint

from deepspeed_tpu_torch import zero3 as Z
from deepspeed_tpu_torch.models import layers as L

REMAT_POLICIES = ("full", "dots", "selective")


def token_batch_specs(batch) -> tuple:
    """The seq-sharded dim of each leaf of a token batch (the JAX
    ``token_batch_specs``, ``transformer.py:28-47``, as data): a leaf of
    two or more dims is ``[B, T, ...]`` and is cut along dim 1, the
    sequence; a leaf of fewer dims is per example (None: every rank of the
    seq group takes it whole)."""
    return tuple(1 if x.ndim >= 2 else None for x in batch)
#: the named activations the "selective" policy saves
SELECTIVE_SAVES = frozenset({"qkv", "ffn1"})


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 50304
    max_seq_len: int = 1024
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    mlp_ratio: int = 4
    pre_ln: bool = True           # GPT-2 pre-LN; BERT uses post-LN
    causal: bool = True
    remat: bool = True            # per-block activation checkpointing
    # sequence-parallel attention under context_parallel_size > 1: "ring"
    # (K/V rotation) or "ulysses" (head <-> sequence all-to-all); the
    # engine's sequence_parallel_impl key overrides it
    sp_impl: str = "ring"
    remat_policy: str = "full"
    init_std: float = 0.02
    ln_eps: float = 1e-5

    def validate(self, mp_size: int = 1):
        h, n = self.hidden_size, self.num_heads
        if h % n:
            raise ValueError(f"hidden {h} not divisible by heads {n}")
        if n % mp_size:
            raise ValueError(f"heads {n} not divisible by mp {mp_size}")
        if self.vocab_size % mp_size:
            raise ValueError(
                f"vocab {self.vocab_size} not divisible by mp {mp_size}")


def init_block_params(cfg: TransformerConfig, generator=None,
                      device=None) -> Dict[str, torch.Tensor]:
    """Stacked [L, ...] block parameters, GPT-2 style init (normal 0.02;
    residual projections scaled by 1/sqrt(2L)).  Same shapes and
    distributions as the JAX package; the random values differ (tests share
    weights through ``weights.py``)."""
    Lyr, h = cfg.num_layers, cfg.hidden_size
    ff = cfg.mlp_ratio * h
    std = cfg.init_std
    resid_std = std / math.sqrt(2.0 * Lyr)

    def normal(shape, s):
        t = torch.empty(shape, dtype=torch.float32, device=device)
        return t.normal_(0.0, s, generator=generator)

    ones = lambda shape: torch.ones(shape, dtype=torch.float32, device=device)
    zeros = lambda shape: torch.zeros(shape, dtype=torch.float32,
                                      device=device)
    return {
        "ln1_s": ones((Lyr, h)),
        "ln1_b": zeros((Lyr, h)),
        # packed head-major (n, 3, d) on the out dim, as in layers.py
        "qkv_w": normal((Lyr, h, 3 * h), std),
        "qkv_b": zeros((Lyr, 3 * h)),
        "proj_w": normal((Lyr, h, h), resid_std),
        "proj_b": zeros((Lyr, h)),
        "ln2_s": ones((Lyr, h)),
        "ln2_b": zeros((Lyr, h)),
        "fc_w": normal((Lyr, h, ff), std),
        "fc_b": zeros((Lyr, ff)),
        "fc2_w": normal((Lyr, ff, h), resid_std),
        "fc2_b": zeros((Lyr, h)),
    }


def block_partition_specs() -> Dict[str, object]:
    """The sharded dim of each stacked block leaf (None: replicated), the
    JAX ``block_partition_specs`` (``transformer.py:109-121``) as data;
    dim 0 is the layer stack."""
    return {
        "ln1_s": None, "ln1_b": None,
        "qkv_w": 2, "qkv_b": 1,
        "proj_w": 1, "proj_b": None,
        "ln2_s": None, "ln2_b": None,
        "fc_w": 2, "fc_b": 1,
        "fc2_w": 1, "fc2_b": None,
    }


def _mlp(x, p, group=None):
    y = L.gelu(L.column_parallel_linear(x, p["fc_w"], p["fc_b"], name="ffn1",
                                        group=group))
    return L.row_parallel_linear(y, p["fc2_w"], p["fc2_b"], group=group)


def block_with_ffn(x, p, cfg: TransformerConfig, attn_mask=None, group=None,
                   seq_group=None, ffn=None):
    """One block with a pluggable FFN (the JAX ``block_with_ffn``,
    ``transformer.py:133-154``): ``ffn(u, p) -> (delta, aux)`` replaces
    the dense MLP (the MoE plugs in here, ``models/moe.py``).  ``p``
    leaves have no layer axis and are this rank's slices of the model
    group ``group``; ``x`` is this rank's sequence block of the seq group
    ``seq_group`` (None: the whole sequence).  Returns ``(x, aux)``, aux
    None for the dense MLP."""
    f = ffn if ffn is not None else (lambda u, pp: (_mlp(u, pp, group),
                                                    None))
    attn = lambda u: L.multihead_attention(
        u, p["qkv_w"], p["qkv_b"], p["proj_w"], p["proj_b"],
        n_heads=cfg.num_heads, causal=cfg.causal, attn_mask=attn_mask,
        group=group, sp_impl=cfg.sp_impl, seq_group=seq_group)
    ln1 = lambda u: L.layer_norm(u, p["ln1_s"], p["ln1_b"], cfg.ln_eps)
    ln2 = lambda u: L.layer_norm(u, p["ln2_s"], p["ln2_b"], cfg.ln_eps)
    if cfg.pre_ln:
        x = x + attn(ln1(x))
        delta, aux = f(ln2(x), p)
        return x + delta, aux
    x = ln1(x + attn(x))            # post-LN (BERT)
    delta, aux = f(x, p)
    return ln2(x + delta), aux


def block_apply(x, p, cfg: TransformerConfig, attn_mask=None, group=None,
                seq_group=None):
    """One dense block (``block_with_ffn`` with the dense MLP)."""
    return block_with_ffn(x, p, cfg, attn_mask, group, seq_group)[0]


_MATMUL_OPS = frozenset({torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
                         torch.ops.aten.addmm.default,
                         torch.ops.aten.baddbmm.default})


def _dots_policy(ctx, op, *args, **kwargs):
    if op in _MATMUL_OPS:
        return torch_checkpoint.CheckpointPolicy.MUST_SAVE
    return torch_checkpoint.CheckpointPolicy.PREFER_RECOMPUTE


class _SelectiveRemat(torch.autograd.Function):
    """``body(x, mask, *leaves)`` run without a graph, keeping ``x``, the
    leaves and the ``SELECTIVE_SAVES`` products; the backward re-runs it
    with the graph, the saved products handed back, and takes the
    gradients of its inputs from that graph.  The body returns one tensor,
    or a tuple (the MoE block's ``(x, aux)``), each output with its own
    incoming gradient."""

    @staticmethod
    def forward(ctx, body, x, mask, *leaves):
        with L.named_saves(SELECTIVE_SAVES) as saved:
            out = body(x, mask, *leaves)
        ctx.body, ctx.n_saved = body, len(saved)
        ctx.save_for_backward(x, mask, *leaves, *saved)
        return out

    @staticmethod
    def backward(ctx, *grads):
        x, mask, *rest = ctx.saved_tensors
        leaves, saved = rest[:len(rest) - ctx.n_saved], \
            rest[len(rest) - ctx.n_saved:]
        inputs = [t.detach().requires_grad_(need) for t, need in
                  zip([x, *leaves], [ctx.needs_input_grad[1],
                                     *ctx.needs_input_grad[3:]])]
        with torch.enable_grad(), L.named_saves(SELECTIVE_SAVES,
                                                replay=saved):
            out = ctx.body(inputs[0], mask, *inputs[1:])
        outs = out if isinstance(out, tuple) else (out,)
        pairs = [(o, g) for o, g in zip(outs, grads)
                 if g is not None and o.requires_grad]
        wanted = [t for t in inputs if t.requires_grad]
        got = iter(torch.autograd.grad([o for o, _ in pairs], wanted,
                                       [g for _, g in pairs],
                                       allow_unused=True))
        grads = [next(got) if t.requires_grad else None for t in inputs]
        return (None, grads[0], None, *grads[1:])


def check_remat(cfg: TransformerConfig) -> None:
    if cfg.remat and cfg.remat_policy not in REMAT_POLICIES:
        raise ValueError(
            f"unknown remat_policy {cfg.remat_policy!r} "
            "(expected 'full', 'dots' or 'selective')")


def remat_wrap(body, cfg: TransformerConfig):
    """The configured per-block rematerialisation around ``body``."""
    check_remat(cfg)
    if not cfg.remat:
        return body
    if cfg.remat_policy == "selective":
        def selective(x, mask, *leaves):
            if not torch.is_grad_enabled():
                return body(x, mask, *leaves)
            return _SelectiveRemat.apply(body, x, mask, *leaves)
        return selective
    kwargs = {"use_reentrant": False}
    if cfg.remat_policy == "dots":
        kwargs["context_fn"] = functools.partial(
            torch_checkpoint.create_selective_checkpoint_contexts,
            _dots_policy)

    def wrapped(*args):
        if not torch.is_grad_enabled():
            return body(*args)
        return torch_checkpoint.checkpoint(body, *args, **kwargs)
    return wrapped


def zero3_enter(params: Dict[str, torch.Tensor], dims, group,
                deferred=("blocks",)):
    """The ZeRO-3 entry gather (``deepspeed_tpu/models/transformer.py``
    ``zero3_enter``): every partitioned leaf of ``params`` (``{dotted
    name: tensor}``) outside the ``deferred`` subtrees gathered now, as
    one collective; the block stacks stay partitioned for the per-layer
    gather.  Returns ``(params, deferred_dims)``: ``deferred_dims[key]``
    holds the dims of subtree ``key``'s STACKED leaves, by name within
    it.  ``params`` unchanged when ``dims`` is None (stage < 3)."""
    if dims is None:
        return params, {}
    deferred_dims = {key: {} for key in deferred}
    names, shards, leaf_dims = [], [], []
    for name, t in params.items():
        head, _, rest = name.partition(".")
        dim = dims.get(name, Z.REPLICATED)
        if head in deferred_dims and rest:
            deferred_dims[head][rest] = dim
        elif dim >= 0:
            names.append(name)
            shards.append(t)
            leaf_dims.append(dim)
    out = dict(params)
    out.update(zip(names, Z.gather_leaves(shards, leaf_dims, group)))
    return out, deferred_dims


def subtree(params: Dict[str, torch.Tensor], key: str):
    """``{name: tensor}`` of the leaves under ``key.`` in ``params``."""
    head = key + "."
    return {k[len(head):]: t for k, t in params.items()
            if k.startswith(head)}


def zero3_min_dims(model: nn.Module) -> Dict[str, int]:
    """The family models' ``zero3_min_dims``: 1 for the stacked block
    leaves (dim 0 is the layer stack, which the body slices), 0 else."""
    return {k: 1 if k.startswith("blocks.") else 0
            for k, _ in model.named_parameters()}


def stack_apply(x, stacked: Dict[str, torch.Tensor], cfg: TransformerConfig,
                attn_mask=None, group=None, z3_dims=None, z3_group=None,
                z3_prefetch=False, seq_group=None):
    """The dense stack (``stack_apply_aux`` without an FFN hook); returns
    ``x``."""
    return stack_apply_aux(x, stacked, cfg, attn_mask, group, z3_dims,
                           z3_group, z3_prefetch, seq_group)[0]


def stack_apply_aux(x, stacked: Dict[str, torch.Tensor],
                    cfg: TransformerConfig, attn_mask=None, group=None,
                    z3_dims=None, z3_group=None, z3_prefetch=False,
                    seq_group=None, ffn=None):
    """All layers over the stacked [L, ...] params (this rank's slices of
    the model group ``group``; under pipeline parallelism this stage's
    layers), on this rank's sequence block of ``seq_group``.  A recompute
    replays a block's forward collectives, in the same order on every
    rank.  Returns ``(x, aux)``: with an FFN hook ``ffn(u, p) -> (delta,
    aux)`` (``block_with_ffn``), the sum of the layers' aux terms, carried
    through every route below (the JAX ``scan_layers`` stacks them and
    ``moe_stack_apply`` sums); without one, None.

    ZeRO-3 (``z3_dims``: the stacked leaves' partition dims over the data
    group ``z3_group``): each layer's slice of the partitioned stack is
    gathered INSIDE the block body, so under remat the gather replays in
    the backward and no gathered layer is kept for it.  ``z3_prefetch``
    (the engine's ``overlap_comm``) runs the body over pairs of layers and
    issues layer b's gather (an async work handle) before block a runs;
    a gather is exact, so the pair computes bitwise what two on-demand
    bodies do.  An odd layer count falls back to on-demand, as in the JAX
    package."""
    names = sorted(stacked)
    per_layer = [stacked[k].unbind(0) for k in names]
    z3 = Z.partitioned_any(z3_dims) and z3_group is not None
    if z3:
        shifted = Z.shift_dims(z3_dims)
        body_dims = [shifted[k] for k in names]

    def block(x_, mask_, leaves):
        """``x`` (dense), or ``(x, aux)`` with the FFN hook: a block
        function's outputs are tensors only."""
        out, aux = block_with_ffn(x_, dict(zip(names, leaves)), cfg, mask_,
                                  group, seq_group, ffn)
        return out if ffn is None else (out, aux)

    def body(x_, mask_, *leaves):
        if z3:
            leaves = Z.gather_leaves(leaves, body_dims, z3_group)
        return block(x_, mask_, leaves)

    aux_sum = None

    def carry(out):
        nonlocal aux_sum
        if ffn is None:
            return out
        out, aux = out
        aux_sum = aux if aux_sum is None else aux_sum + aux
        return out

    # the stack's own depth: under pipeline parallelism this stage's layers
    n, layers = len(names), len(per_layer[0])
    if not (z3 and z3_prefetch and layers >= 2 and layers % 2 == 0):
        body = remat_wrap(body, cfg)
        for i in range(layers):
            x = carry(body(x, attn_mask,
                           *(leaves[i] for leaves in per_layer)))
        return x, aux_sum

    def pair(x_, mask_, *leaves):
        a, b = leaves[:n], leaves[n:]
        pending = Z.start_gather(b, body_dims, z3_group)
        out = block(x_, mask_, Z.gather_leaves(a, body_dims, z3_group))
        aux_a = None
        if ffn is not None:
            out, aux_a = out
        out = block(out, mask_, Z.gather_leaves(b, body_dims, z3_group,
                                                pending=pending))
        if ffn is None:
            return out
        return out[0], aux_a + out[1]

    pair = remat_wrap(pair, cfg)
    for i in range(0, layers, 2):
        x = carry(pair(x, attn_mask, *(leaves[i] for leaves in per_layer),
                       *(leaves[i + 1] for leaves in per_layer)))
    return x, aux_sum


class TransformerStack(nn.Module):
    """The stacked block parameters as ``nn.Parameter``s named like the JAX
    leaves (``qkv_w``, ``fc2_b``, ...); ``stack_apply`` runs them.
    ``init`` makes them (``init_block_params``; the MoE's
    ``moe.init_moe_block_params``)."""

    def __init__(self, cfg: TransformerConfig, generator=None, device=None,
                 init=None):
        super().__init__()
        init = init or init_block_params
        for name, t in init(cfg, generator, device).items():
            self.register_parameter(name, nn.Parameter(t))
