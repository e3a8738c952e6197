"""Attention with the forward and the backward chosen independently.

The port of the hybrid section of ``deepspeed_tpu/ops/pallas_attention.py``
(``:626-773``): the einsum path ``xla_attention`` (with the ``_qk_scores``
precision convention, and optionally the logsumexp a streaming backward
needs), and ``dispatch_attention``, the autograd shell that runs the forward
by one of ``{"xla", "block", "stream"}`` and the backward by another.
``models/layers.attention_plan`` picks the pair; the single-impl pairs go to
the kernels' own autograd functions directly.
"""

from __future__ import annotations

import math

import torch

from deepspeed_tpu_torch.ops import block_attention as battn
from deepspeed_tpu_torch import precision as prec
from deepspeed_tpu_torch.ops import stream_attention as sattn

ATTN_IMPLS = ("xla", "block", "stream")


def check_impls(fwd_impl: str, bwd_impl: str) -> None:
    if fwd_impl not in ATTN_IMPLS or bwd_impl not in ATTN_IMPLS:
        raise ValueError(
            f"attention impls must be one of {ATTN_IMPLS}, got "
            f"fwd={fwd_impl!r} bwd={bwd_impl!r}")
    if bwd_impl == "stream" and fwd_impl == "block":
        raise ValueError(
            "bwd_impl='stream' needs the forward logsumexp, which the "
            "whole-tile kernel does not emit — use fwd_impl 'stream' or "
            "'xla'")


class _QKScores(torch.autograd.Function):
    """``q @ k^T`` scores in fp32 from low-precision q, k [B, T, n, d].

    The port of ``pallas_attention._qk_scores``: the products accumulate
    and return in fp32 (``precision.f32_bmm``, the JAX
    ``preferred_element_type=fp32``: on the card the operands stay in the
    compute dtype).  The backward rounds the fp32 score cotangent to the
    compute dtype BEFORE the dq/dk products, then accumulates them in fp32
    and casts to the compute dtype (``pallas_attention.py:670-677``).  In
    fp32 the casts are identities."""

    @staticmethod
    def forward(ctx, q, k):
        ctx.save_for_backward(q, k)
        if not _lowp_on_card(q):
            return torch.einsum("btnd,bsnd->bnts", q.float(), k.float())
        B, T, n, d = q.shape
        S = k.shape[1]
        s = prec.f32_bmm(q.permute(0, 2, 1, 3).reshape(B * n, T, d),
                         k.permute(0, 2, 3, 1).reshape(B * n, d, S))
        return s.view(B, n, T, S)

    @staticmethod
    def backward(ctx, g):
        q, k = ctx.saved_tensors
        if not _lowp_on_card(q):
            gl = g.to(q.dtype).float()
            dq = torch.einsum("bnts,bsnd->btnd", gl, k.float()).to(q.dtype)
            dk = torch.einsum("bnts,btnd->bsnd", gl, q.float()).to(k.dtype)
            return dq, dk
        B, T, n, d = q.shape
        S = k.shape[1]
        gl = g.to(q.dtype).reshape(B * n, T, S)
        kb = k.permute(0, 2, 1, 3).reshape(B * n, S, d)
        qb = q.permute(0, 2, 1, 3).reshape(B * n, T, d)
        dq = prec.f32_bmm(gl, kb).view(B, n, T, d).permute(0, 2, 1, 3)
        dk = prec.f32_bmm(gl.transpose(1, 2), qb).view(
            B, n, S, d).permute(0, 2, 1, 3)
        return dq.to(q.dtype), dk.to(k.dtype)


def _lowp_on_card(t) -> bool:
    return t.device.type == "cuda" and t.dtype in (torch.bfloat16,
                                                   torch.float16)


def xla_attention(q, k, v, attn_mask=None, causal=False, with_lse=False):
    """The einsum path on q, k, v [B, T, n, d] (fp32 scores and softmax,
    mask value -1e9, probabilities cast to the compute dtype before the
    product with V); ``attn_mask`` optional [B, T] with 1 = attend.  Returns
    [B, T, n, d] in q's dtype, and with ``with_lse`` also the fp32
    logsumexp of the masked scores in the streaming kernels' [B*n, 1, T]
    layout."""
    B, T, n, d = q.shape
    scores = _QKScores.apply(q, k) / math.sqrt(d)
    if causal:
        cmask = torch.tril(torch.ones((T, T), dtype=torch.bool,
                                      device=q.device))
        scores = torch.where(cmask[None, None], scores,
                             scores.new_tensor(-1e9))
    if attn_mask is not None:
        keep = attn_mask.to(torch.bool)[:, None, None, :]
        scores = torch.where(keep, scores, scores.new_tensor(-1e9))
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bnts,bsnd->btnd", probs, v)
    if not with_lse:
        return out
    return out, torch.logsumexp(scores, dim=-1).reshape(B * n, 1, T)


def _stream_operands(q, k, v, attn_mask):
    B, T, n, _ = q.shape
    return (sattn.fold_gtd(q), sattn.fold_gtd(k), sattn.fold_gtd(v),
            sattn.mask_gtd(attn_mask, B, T, n))


class DispatchAttention(torch.autograd.Function):
    """``pallas_attention.dispatch_attention`` with its custom VJP: q, k, v
    [B, T, n, d], attn_mask fp32 [B, T] (1 = attend) -> [B, T, n, d].  The
    forward keeps ``(o, lse)`` in the folded layout only for a streaming
    backward; an einsum backward recomputes and differentiates the einsum
    forward."""

    @staticmethod
    def forward(ctx, q, k, v, attn_mask, causal, fwd_impl, bwd_impl):
        B, _, n, _ = q.shape
        stream_bwd = bwd_impl == "stream"
        extra = ()
        if fwd_impl == "stream":
            o, lse = sattn.stream_fwd(*_stream_operands(q, k, v, attn_mask),
                                      causal)
            out = sattn.unfold_gtd(o, B, n)
            if stream_bwd:
                extra = (o, lse)
        elif fwd_impl == "block":
            out = battn.block_fwd(*battn.one_layout(q, k, v), attn_mask,
                                  causal)
        elif stream_bwd:
            out, lse = xla_attention(q, k, v, attn_mask, causal,
                                     with_lse=True)
            extra = (sattn.fold_gtd(out), lse)
        else:
            out = xla_attention(q, k, v, attn_mask, causal)
        ctx.save_for_backward(q, k, v, attn_mask, *extra)
        ctx.causal, ctx.bwd_impl = causal, bwd_impl
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, attn_mask, *extra = ctx.saved_tensors
        causal = ctx.causal
        if ctx.bwd_impl == "stream":
            B, _, n, _ = q.shape
            o, lse = extra
            grads = sattn.stream_backward(
                *_stream_operands(q, k, v, attn_mask), o, lse,
                sattn.fold_gtd(g), causal)
            dq, dk, dv = (sattn.unfold_gtd(x, B, n) for x in grads)
        elif ctx.bwd_impl == "block":
            dq, dk, dv = battn.block_bwd(*battn.one_layout(q, k, v),
                                         attn_mask, g.contiguous(), causal)
        else:
            # recompute and differentiate the einsum forward (the work a
            # rematerialised einsum attention does in its replay)
            with torch.enable_grad():
                leaves = [t.detach().requires_grad_() for t in (q, k, v)]
                out = xla_attention(*leaves, attn_mask, causal)
                dq, dk, dv = torch.autograd.grad(out, leaves, g)
        # the mask is a float selector, not a trainable input
        return dq, dk, dv, None, None, None, None


def dispatch_attention(q, k, v, attn_mask, causal=False, fwd_impl="xla",
                       bwd_impl="xla"):
    """Attention with independently chosen forward/backward kernels.

    q/k/v: [B, T, n, d]; attn_mask: fp32 [B, T] (1 = attend).  The impls
    are {"xla", "block", "stream"}; bwd "stream" after fwd "block" is
    rejected (no logsumexp).  Callers gate shapes per impl
    (``block_attention.supported`` / ``kernel_supported``,
    ``stream_attention.stream_supported``)."""
    check_impls(fwd_impl, bwd_impl)
    return DispatchAttention.apply(q, k, v, attn_mask, causal, fwd_impl,
                                   bwd_impl)
