"""The transformer stack BERT builds on.

The port of ``deepspeed_tpu/models/transformer.py`` at mp = 1.  Block
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
* ``"selective"`` (save the named ``qkv`` and ``ffn1`` activations) raises:
  PyTorch's selective checkpointing selects by operator, not by name, and a
  policy that trained differently would be a silent change.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Dict

import torch
from torch import nn
from torch.utils import checkpoint as torch_checkpoint

from deepspeed_tpu_torch.models import layers as L

REMAT_POLICIES = ("full", "dots")


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
    sp_impl: str = "ring"         # parsed for config parity; sp = 1 here
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


def _mlp(x, p):
    y = L.gelu(L.column_parallel_linear(x, p["fc_w"], p["fc_b"]))
    return L.row_parallel_linear(y, p["fc2_w"], p["fc2_b"])


def block_apply(x, p, cfg: TransformerConfig, attn_mask=None):
    """One dense block; ``p`` leaves have no layer axis."""
    attn = lambda u: L.multihead_attention(
        u, p["qkv_w"], p["qkv_b"], p["proj_w"], p["proj_b"],
        n_heads=cfg.num_heads, causal=cfg.causal, attn_mask=attn_mask)
    ln1 = lambda u: L.layer_norm(u, p["ln1_s"], p["ln1_b"], cfg.ln_eps)
    ln2 = lambda u: L.layer_norm(u, p["ln2_s"], p["ln2_b"], cfg.ln_eps)
    if cfg.pre_ln:
        x = x + attn(ln1(x))
        return x + _mlp(ln2(x), p)
    x = ln1(x + attn(x))            # post-LN (BERT)
    return ln2(x + _mlp(x, p))


_MATMUL_OPS = frozenset({torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
                         torch.ops.aten.addmm.default,
                         torch.ops.aten.baddbmm.default})


def _dots_policy(ctx, op, *args, **kwargs):
    if op in _MATMUL_OPS:
        return torch_checkpoint.CheckpointPolicy.MUST_SAVE
    return torch_checkpoint.CheckpointPolicy.PREFER_RECOMPUTE


def check_remat(cfg: TransformerConfig) -> None:
    if cfg.remat and cfg.remat_policy not in REMAT_POLICIES:
        if cfg.remat_policy == "selective":
            raise NotImplementedError(
                "remat_policy 'selective' (save the named qkv/ffn1 "
                "activations) is not ported to deepspeed_tpu_torch yet "
                "(ROADMAP.md, Queue 1 item 4); use 'full', 'dots' or "
                "activation_checkpointing false")
        raise ValueError(
            f"unknown remat_policy {cfg.remat_policy!r} "
            "(expected 'full', 'dots' or 'selective')")


def remat_wrap(body, cfg: TransformerConfig):
    """The configured per-block rematerialisation around ``body``."""
    check_remat(cfg)
    if not cfg.remat:
        return body
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


def stack_apply(x, stacked: Dict[str, torch.Tensor], cfg: TransformerConfig,
                attn_mask=None):
    """All layers over the stacked [L, ...] params."""
    names = sorted(stacked)
    per_layer = [stacked[k].unbind(0) for k in names]

    def body(x_, mask_, *leaves):
        return block_apply(x_, dict(zip(names, leaves)), cfg, mask_)

    body = remat_wrap(body, cfg)
    for i in range(cfg.num_layers):
        x = body(x, attn_mask, *(leaves[i] for leaves in per_layer))
    return x


class TransformerStack(nn.Module):
    """The stacked block parameters as ``nn.Parameter``s named like the JAX
    leaves (``qkv_w``, ``fc2_b``, ...); ``stack_apply`` runs them."""

    def __init__(self, cfg: TransformerConfig, generator=None, device=None):
        super().__init__()
        for name, t in init_block_params(cfg, generator, device).items():
            self.register_parameter(name, nn.Parameter(t))
