"""Transformer layer primitives at model-parallel size 1.

The port of the mp = 1 subset of ``deepspeed_tpu/models/layers.py``.  With
one model shard every collective there is the identity, so the
column/row-parallel linears are ``x @ w`` with weights kept in the JAX
``[in, out]`` layout, and the vocab-parallel embedding, logits and
cross-entropy act on the whole vocabulary.

Attention follows the JAX package's ``core_attention`` and
``attention_plan`` (``layers.py:545-600``).  ``xla_attention`` is the port of
``pallas_attention.xla_attention`` (fp32 scores and softmax, mask value
-1e9, probabilities cast to the compute dtype before the product with V),
which the JAX package runs for BERT at seq 128.  From seq 256 the streaming
kernels of ``ops/stream_attention.py`` take over (see ``attention_plan``).
"""

from __future__ import annotations

import math
import os

import torch

from deepspeed_tpu_torch.ops import stream_attention as sattn


def column_parallel_linear(x, w, b=None):
    """x: [..., in]; w: [in, out].  Returns [..., out]."""
    y = x @ w.to(x.dtype)
    if b is not None:
        y = y + b.to(y.dtype)
    return y


def row_parallel_linear(x, w, b=None):
    """x: [..., in]; w: [in, out].  At mp = 1 the same product as
    ``column_parallel_linear``: the JAX psum over ``model`` is the
    identity."""
    return column_parallel_linear(x, w, b)


def vocab_parallel_embedding(tokens, wte):
    """tokens: int [...]; wte: [vocab, h] -> [..., h]."""
    return torch.nn.functional.embedding(tokens.long(), wte)


def vocab_parallel_logits(h, wte):
    """Weight-tied LM head: h [..., hid] @ wte[vocab, hid]^T."""
    return h @ wte.to(h.dtype).t()


def vocab_parallel_cross_entropy(logits, labels):
    """Per-token cross-entropy in fp32; labels outside [0, vocab) get the
    log-partition only (callers mask them out).  logits [..., vocab],
    labels int [...] -> fp32 [...]."""
    logits = logits.float()
    vocab = logits.shape[-1]
    lmax = torch.max(logits.detach(), dim=-1).values
    shifted = logits - lmax[..., None]
    sumexp = torch.sum(torch.exp(shifted), dim=-1)
    labels = labels.long()
    valid = (labels >= 0) & (labels < vocab)
    idx = torch.clamp(labels, 0, vocab - 1)
    tgt = torch.gather(shifted, -1, idx[..., None])[..., 0]
    return torch.log(sumexp) - tgt * valid.float()


def gather_positions(x, positions):
    """x [B, T, H], positions int [B, P] -> [B, P, H] (the ``take`` form)."""
    idx = positions.long()[..., None].expand(-1, -1, x.shape[-1])
    return torch.gather(x, 1, idx)


def masked_mean_loss(loss, mask):
    """Masked mean of a per-token loss (sequence parallel size 1)."""
    mask = mask.float()
    return torch.sum(loss * mask) / torch.clamp(torch.sum(mask), min=1.0)


def layer_norm(x, scale, bias, eps=1e-5):
    """LayerNorm with fp32 moments; returns x's dtype."""
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    y = y * scale.float() + bias.float()
    return y.to(x.dtype)


def gelu(x):
    """tanh-approximation GELU in fp32 (GPT-2/BERT); returns x's dtype."""
    xf = x.float()
    y = 0.5 * xf * (1.0 + torch.tanh(
        0.7978845608028654 * (xf + 0.044715 * xf ** 3)))
    return y.to(x.dtype)


class _QKScores(torch.autograd.Function):
    """``q @ k^T`` scores in fp32 from low-precision q, k [B, T, n, d].

    The port of ``pallas_attention._qk_scores``: products of bf16/fp16
    values are exact in fp32, so both operands go up to fp32 and the sum
    runs in fp32 (the JAX ``preferred_element_type=fp32``).  The backward
    rounds the fp32 score cotangent to the compute dtype BEFORE the dq/dk
    products, then accumulates them in fp32 and casts to the compute dtype
    (``pallas_attention.py:670-677``).  In fp32 the casts are identities."""

    @staticmethod
    def forward(ctx, q, k):
        ctx.save_for_backward(q, k)
        return torch.einsum("btnd,bsnd->bnts", q.float(), k.float())

    @staticmethod
    def backward(ctx, g):
        q, k = ctx.saved_tensors
        gl = g.to(q.dtype).float()
        dq = torch.einsum("bnts,bsnd->btnd", gl, k.float()).to(q.dtype)
        dk = torch.einsum("bnts,btnd->bsnd", gl, q.float()).to(k.dtype)
        return dq, dk


def xla_attention(q, k, v, *, causal, attn_mask=None):
    """The einsum path on q, k, v [B, T, n, d]; ``attn_mask`` optional
    [B, T] with 1 = attend.  Returns [B, T, n, d] in q's dtype."""
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
    return torch.einsum("bnts,bsnd->btnd", probs, v)


def _attn_mode() -> str:
    mode = os.environ.get("DSTPU_FUSED_ATTN", "auto")
    if mode not in ("auto", "1", "0"):
        # fail loudly, not open: "off"/"false"/"" must not silently enable
        # the kernel the operator meant to disable
        raise ValueError(
            f"DSTPU_FUSED_ATTN={mode!r} is not a valid mode: use 'auto' "
            f"(the streaming kernels wherever they take the shape), '1' "
            f"(force a kernel), or '0' (the einsum path only)")
    return mode


def _block_supported(T, n, d) -> bool:
    """The JAX package's whole-tile gate (``pallas_attention.supported``):
    where it holds and streaming does not, the JAX plan picks "block"."""
    hb = 8 if n % 8 == 0 else n
    return T % 8 == 0 and d % 8 == 0 and hb * T * T * 4 <= 1024 * 1024


def attention_plan(T, n, d, causal):
    """(fwd_impl, bwd_impl) in {"xla", "stream"}, the port's counterpart of
    ``attention_plan``.  ``DSTPU_FUSED_ATTN`` takes the JAX values:

    * "0": the einsum path;
    * "auto": the streaming kernels wherever ``stream_supported(T, d)``
      holds, on the card and on the CPU (plain versions) alike, else the
      einsum path.  The JAX package's thresholds (``STREAM_AUTO_MIN*``) are
      v5e measurements and are not carried over; seq 256 as the start is
      the kernels' own granule, NOT a measured H100 crossover.
      ``chip_smoke.py``'s ``attn_sweep`` times both paths to supply one.
    * "1": the streaming kernels where supported; a shape where the JAX
      plan would force the whole-tile kernel raises, since that kernel and
      the hybrid ``dispatch_attention`` are not ported yet.

    ``causal`` is part of the JAX signature; the port's plan does not
    depend on it until the whole-tile kernel lands."""
    mode = _attn_mode()
    if mode == "0":
        return "xla", "xla"
    if sattn.stream_supported(T, d):
        return "stream", "stream"
    if mode == "1" and _block_supported(T, n, d):
        raise NotImplementedError(
            f"DSTPU_FUSED_ATTN=1 at seq {T}, head dim {d}: the JAX package "
            f"forces its whole-tile kernel here, which is not ported to "
            f"deepspeed_tpu_torch yet (ROADMAP.md, Queue 2: whole-tile "
            f"_fwd_kernel + _bwd_kernel with dispatch_attention)")
    return "xla", "xla"


def core_attention(q, k, v, *, causal, attn_mask=None):
    """Attention on q, k, v [B, T, n, d] by ``attention_plan``;
    ``attn_mask`` optional [B, T] with 1 = attend.  Returns [B, T, n, d] in
    q's dtype."""
    B, T, n, d = q.shape
    fwd_impl, _ = attention_plan(T, n, d, causal)
    if fwd_impl == "stream":
        mvec = (torch.ones((B, T), dtype=torch.float32, device=q.device)
                if attn_mask is None else attn_mask.to(torch.float32))
        return sattn.stream_attention(q, k, v, mvec, causal)
    return xla_attention(q, k, v, causal=causal, attn_mask=attn_mask)


def multihead_attention(x, qkv_w, qkv_b, proj_w, proj_b, *, n_heads,
                        causal, attn_mask=None):
    """Multi-head attention with the packed head-major qkv projection:
    the output dim of ``qkv_w`` [h, 3h] is laid out (n, 3, d), as in
    ``layers.py:627``."""
    B, T, h = x.shape
    d = h // n_heads
    qkv = column_parallel_linear(x, qkv_w, qkv_b).reshape(B, T, n_heads, 3, d)
    q, k, v = qkv[..., 0, :], qkv[..., 1, :], qkv[..., 2, :]
    ctx = core_attention(q, k, v, causal=causal, attn_mask=attn_mask)
    return row_parallel_linear(ctx.reshape(B, T, h), proj_w, proj_b)
