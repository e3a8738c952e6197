"""Transformer layer primitives, tensor-parallel over a model group.

The port of ``deepspeed_tpu/models/layers.py`` (``:173-271``).  Weights
keep the JAX ``[in, out]`` layout; each function takes this rank's local
slice and the model process group (``group``; None is one model shard,
where every collective is the identity).  Where the JAX functions psum
over the ``model`` mesh axis inside ``shard_map``, these use the Megatron
pair of ``parallel/comm.py``: ``copy_to_model`` in front of every
column-parallel input and of the tied LM head, ``reduce_from_model`` after
every row-parallel product and vocab-parallel lookup.  So autograd gives
every leaf its true gradient on every model rank, and a replicated leaf
the same gradient on all of them.

Attention follows the JAX package's ``core_attention`` and
``attention_plan`` (``layers.py:69-160``, ``:545-600``): per direction, the
einsum path ``xla_attention`` (``ops/dispatch_attention.py``), the
whole-tile kernels of ``ops/block_attention.py`` for short causal shapes,
or the streaming kernels of ``ops/stream_attention.py`` from seq 256.

Under sequence parallelism (a seq process group ``seq_group``, the
sequence cut over it) ``multihead_attention`` runs ring attention
(``models/ring_attention.py``) or Ulysses (``models/ulysses.py``) by the
model's ``sp_impl``; ``seq_shard_positions`` offsets the position table by
the rank's block and ``masked_mean_loss`` sums the valid-token count over
the seq group (the JAX ``layers.py:273-278``, ``:316-331``).
"""

from __future__ import annotations

import contextlib
import functools
import os
import threading

import torch
import torch.distributed as dist

from deepspeed_tpu_torch.ops import block_attention as battn
from deepspeed_tpu_torch.ops import dispatch_attention as dattn
from deepspeed_tpu_torch.ops import stream_attention as sattn
from deepspeed_tpu_torch.parallel import comm
# the einsum path lives with the dispatch shell; it keeps its name here
from deepspeed_tpu_torch.ops.dispatch_attention import (  # noqa: F401
    _QKScores, xla_attention)


class _NamedLinear(torch.autograd.Function):
    """``x @ w + b`` whose backward needs only its inputs.  Given
    ``saved`` (the output of the same product from an earlier run) it
    returns that and computes nothing: a recompute that replays the
    forward gets the product's graph node without the product.  ``w`` is
    ``[in, out]``, or ``[e, in, out]`` with ``x`` ``[e, ..., in]`` and
    ``b`` ``[e, out]`` (one product per expert, the MoE's ``ffn1``)."""

    @staticmethod
    def forward(ctx, x, w, b, saved):
        ctx.save_for_backward(x, w)
        ctx.b_dtype = None if b is None else b.dtype
        if saved is not None:
            return saved.detach()
        y = x @ w.to(x.dtype)
        if b is not None:
            y = y + _bias(b, w).to(y.dtype)
        return y

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        gx = gw = gb = None
        if ctx.needs_input_grad[0]:
            gx = g @ w.to(g.dtype).transpose(-1, -2)
        if w.dim() == 3:
            if ctx.needs_input_grad[1]:
                gw = (x.transpose(-1, -2) @ g).to(w.dtype)
            if ctx.b_dtype is not None and ctx.needs_input_grad[2]:
                gb = g.sum(-2).to(ctx.b_dtype)
            return gx, gw, gb, None
        g2 = g.reshape(-1, g.shape[-1])
        if ctx.needs_input_grad[1]:
            gw = (x.reshape(-1, x.shape[-1]).t() @ g2).to(w.dtype)
        if ctx.b_dtype is not None and ctx.needs_input_grad[2]:
            gb = g2.sum(0).to(ctx.b_dtype)
        return gx, gw, gb, None


def _bias(b, w):
    """``b`` broadcast over the rows of ``x @ w``: per expert for a stacked
    ``w`` ``[e, in, out]``."""
    return b[:, None, :] if w.dim() == 3 else b


class _NamedSaves(threading.local):
    """The named products a selective recompute keeps (``keep``): their
    outputs recorded in a run (``record``), or handed back in order to the
    recompute (``replay``, consumed from ``pos``)."""
    keep = frozenset()
    record = None
    replay = None
    pos = 0


_SAVES = _NamedSaves()


@contextlib.contextmanager
def named_saves(keep, replay=None):
    """Within the block, a named linear whose name is in ``keep`` records
    its output into the list this yields; with ``replay`` (such a list) it
    returns the recorded output instead, in the same order, and the block
    must consume all of them."""
    st = _SAVES
    prev = (st.keep, st.record, st.replay, st.pos)
    st.keep, st.record, st.replay, st.pos = frozenset(keep), [], replay, 0
    try:
        yield st.record
        if replay is not None and st.pos != len(replay):
            raise RuntimeError(
                f"selective recompute consumed {st.pos} of the "
                f"{len(replay)} saved products: the block took another path "
                f"than in its forward")
    finally:
        st.keep, st.record, st.replay, st.pos = prev


def column_parallel_linear(x, w, b=None, name=None, group=None):
    """x: [..., in], replicated over the model group; w: [in, out / mp].
    Returns [..., out / mp], sharded on the feature dim.

    ``name`` is the port of ``jax.ad_checkpoint.checkpoint_name`` on the
    product (``"qkv"``, ``"ffn1"``): a named product runs as
    ``_NamedLinear``, whose output the ``"selective"`` remat policy saves
    by name (``named_saves``) and whose recompute then costs nothing.  The
    name goes on the product itself: an identity tag after it would leave
    the product to be replayed."""
    return named_linear(comm.copy_to_model(x, group), w, b, name)


def named_linear(x, w, b=None, name=None):
    """``x @ w + b`` (``w`` ``[in, out]``, or ``[e, in, out]`` per expert)
    as the product named ``name`` for the ``"selective"`` remat policy
    (see ``column_parallel_linear``); a plain product without a name."""
    if name is None:
        y = x @ w.to(x.dtype)
        if b is not None:
            y = y + _bias(b, w).to(y.dtype)
        return y
    st = _SAVES
    if name not in st.keep:
        return _NamedLinear.apply(x, w, b, None)
    if st.replay is None:
        y = _NamedLinear.apply(x, w, b, None)
        st.record.append(y)
        return y
    if st.pos >= len(st.replay):
        raise RuntimeError(f"selective recompute: no saved product left "
                           f"for {name!r}")
    saved = st.replay[st.pos]
    st.pos += 1
    return _NamedLinear.apply(x, w, b, saved)


def row_parallel_linear(x, w, b=None, group=None):
    """x: [..., in / mp]; w: [in / mp, out]; b: [out], replicated.  The
    partial products sum over the model group in the compute dtype (the
    JAX ``psum`` of ``x_local @ w_local.astype(x.dtype)``); the result is
    replicated."""
    y = comm.reduce_from_model(x @ w.to(x.dtype), group)
    if b is not None:
        y = y + b.to(y.dtype)
    return y


def _vocab_start(local_vocab, group):
    """The first vocabulary row of this rank's shard."""
    return 0 if group is None else dist.get_rank(group) * local_vocab


def vocab_parallel_embedding(tokens, wte, group=None):
    """tokens: int [...]; wte: [vocab / mp, h] -> [..., h]: the masked
    lookup of the rows this rank owns (zeros elsewhere), summed over the
    model group (Megatron's VocabParallelEmbedding)."""
    if group is None:
        return torch.nn.functional.embedding(tokens.long(), wte)
    local = wte.shape[0]
    idx = tokens.long() - _vocab_start(local, group)
    valid = (idx >= 0) & (idx < local)
    emb = torch.nn.functional.embedding(torch.clamp(idx, 0, local - 1), wte)
    emb = emb * valid[..., None].to(emb.dtype)
    return comm.reduce_from_model(emb, group)


def vocab_parallel_logits(h, wte, group=None):
    """Weight-tied LM head: h [..., hid] replicated @ wte [vocab / mp,
    hid]^T -> logits [..., vocab / mp], sharded on the vocab dim and never
    gathered (``vocab_parallel_cross_entropy`` takes them as they are)."""
    return comm.copy_to_model(h, group) @ wte.to(h.dtype).t()


class _VocabParallelCE(torch.autograd.Function):
    """Megatron's vocab-parallel softmax cross-entropy in fp32: the MAX of
    the (detached) local maxima, the SUM of the local sums of exponentials
    and of the masked target logit.  The backward is ``(softmax_local -
    onehot_local) * grad`` on this rank's vocab slice: no collective, and
    the full-vocab softmax is never materialised."""

    @staticmethod
    def forward(ctx, logits, labels, group):
        lf = logits.float()
        local = lf.shape[-1]
        lmax = comm.model_max_(torch.amax(lf, dim=-1), group)
        e = torch.exp(lf - lmax[..., None])
        sumexp = comm.model_sum_(torch.sum(e, dim=-1), group)
        idx = labels.long() - _vocab_start(local, group)
        valid = (idx >= 0) & (idx < local)
        idx = torch.clamp(idx, 0, local - 1)
        tgt = torch.gather(lf, -1, idx[..., None])[..., 0] - lmax
        tgt = comm.model_sum_(tgt * valid.float(), group)
        ctx.save_for_backward(e, sumexp, idx, valid)
        ctx.dtype = logits.dtype
        return torch.log(sumexp) - tgt

    @staticmethod
    def backward(ctx, g):
        e, sumexp, idx, valid = ctx.saved_tensors
        grad = e / sumexp[..., None]
        grad.scatter_add_(-1, idx[..., None], -valid.float()[..., None])
        return grad.mul_(g[..., None]).to(ctx.dtype), None, None


def vocab_parallel_cross_entropy(logits, labels, group=None):
    """Per-token cross-entropy in fp32 over vocab-sharded logits; labels
    outside [0, vocab) get the log-partition only (callers mask them out).
    logits [..., vocab / mp], labels int [...] -> fp32 [...], replicated
    over the model group."""
    return _VocabParallelCE.apply(logits, labels.long(), group)


def gather_positions(x, positions):
    """x [B, T, H], positions int [B, P] -> [B, P, H] (the ``take`` form)."""
    idx = positions.long()[..., None].expand(-1, -1, x.shape[-1])
    return torch.gather(x, 1, idx)


def seq_shard_positions(wpe, t_local, seq_group=None):
    """The position embeddings of this rank's sequence block: rows
    ``[r * t_local, (r + 1) * t_local)`` of ``wpe`` for rank ``r`` of the
    seq group, the first ``t_local`` without one."""
    pos0 = 0 if seq_group is None else dist.get_rank(seq_group) * t_local
    return wpe[pos0:pos0 + t_local]


def masked_mean_loss(loss, mask, seq_group=None):
    """Masked mean of a per-token loss.  Under sequence parallelism the
    value's mean over the seq group is the global masked mean (the
    sum of the masked losses over the total valid count): the local sum
    times ``sp`` over the count summed over the seq group, since shards may
    hold different valid counts.  The engine's sum of the ranks' gradients
    over ``sp`` is then the global mean's gradient."""
    mask = mask.float()
    local_sum = torch.sum(loss * mask)
    local_cnt = torch.sum(mask)
    if seq_group is not None:
        sp = dist.get_world_size(seq_group)
        total = comm.seq_sum_(local_cnt.detach().clone(), seq_group)
        return local_sum * sp / torch.clamp(total, min=1.0)
    return local_sum / torch.clamp(local_cnt, min=1.0)


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


#: per-device-kind streaming thresholds, {"causal": (fwd_min, bwd_min),
#: "noncausal": (fwd_min, bwd_min)}, keyed by ``torch.cuda.get_device_name()``:
#: the smallest seq where the kernels' fwd+bwd is >= 1.05x the einsum path's
#: (``calibrate_stream_threshold``'s rule), from ``chip_smoke.py``'s
#: ``attn_sweep`` on an H100 (PERF.md section 6): they win from 256, the
#: smallest seq they take, causal and not.  The JAX package's v5e entries
#: are not carried over.  fwd == bwd until a direction-split sweep exists.
STREAM_AUTO_MIN_BY_KIND = {
    "NVIDIA H100 80GB HBM3": {"causal": (256, 256), "noncausal": (256, 256)},
}
#: the streaming default for a device not in the table (and the CPU tests):
#: the kernels' granule ``STREAM_TILE_MIN``, not a measurement
STREAM_AUTO_MIN = STREAM_AUTO_MIN_CAUSAL = sattn.STREAM_TILE_MIN
#: whole-tile kernel auto threshold for causal shapes below the streaming
#: one, measured as above (``attn_sweep_block`` on an H100, PERF.md section
#: 6): the kernels win from 64, the smallest seq swept.  One constant,
#: since the port has one card kind, so the CPU plan takes the card's path.
#: Non-causal short shapes keep the einsum path, as in the JAX plan.  Env
#: pin: DSTPU_BLOCK_ATTN_MIN_CAUSAL (0 disables).
BLOCK_AUTO_MIN_CAUSAL = 64


def _env_int(name):
    env = os.environ.get(name)
    if not env:
        return None
    try:
        v = int(env)
    except ValueError:
        raise ValueError(
            f"{name}={env!r} is not an integer token count") from None
    if v < 0:
        raise ValueError(f"{name}={env!r} must be a non-negative count")
    return v


@functools.lru_cache(maxsize=None)
def _device_kind():
    return (torch.cuda.get_device_name(0) if torch.cuda.is_available()
            else None)


def stream_auto_min(causal: bool = False, direction: str = "fwd") -> int:
    """The streaming auto-dispatch threshold for the current card and the
    given pass direction ("fwd" | "bwd").  Resolution order, as in the JAX
    package (``layers.py:56-66``): the causal direction pin
    ``DSTPU_STREAM_ATTN_MIN_CAUSAL_FWD|_BWD``, the causal pin, the direction
    pin ``DSTPU_STREAM_ATTN_MIN_FWD|_BWD``, ``DSTPU_STREAM_ATTN_MIN``, the
    per-kind table, the default."""
    if direction not in ("fwd", "bwd"):
        raise ValueError(f"direction must be 'fwd' or 'bwd', "
                         f"got {direction!r}")
    suff = direction.upper()
    names = ((f"DSTPU_STREAM_ATTN_MIN_CAUSAL_{suff}",
              "DSTPU_STREAM_ATTN_MIN_CAUSAL",
              f"DSTPU_STREAM_ATTN_MIN_{suff}",
              "DSTPU_STREAM_ATTN_MIN") if causal else
             (f"DSTPU_STREAM_ATTN_MIN_{suff}", "DSTPU_STREAM_ATTN_MIN"))
    for name in names:
        v = _env_int(name)
        if v is None:
            continue
        if v == 0:
            raise ValueError(
                f"{name}=0 is not a valid token count (use "
                f"DSTPU_FUSED_ATTN=0 to disable kernels)")
        return v
    entry = STREAM_AUTO_MIN_BY_KIND.get(_device_kind())
    if entry is None:
        return STREAM_AUTO_MIN_CAUSAL if causal else STREAM_AUTO_MIN
    pair = entry["causal" if causal else "noncausal"]
    return pair[0] if direction == "fwd" else pair[1]


def block_auto_min_causal():
    """Whole-tile kernel auto threshold for causal shapes; None disables
    (env pin 0)."""
    v = _env_int("DSTPU_BLOCK_ATTN_MIN_CAUSAL")
    if v is None:
        v = BLOCK_AUTO_MIN_CAUSAL
    return None if v == 0 else v


def _attn_mode() -> str:
    mode = os.environ.get("DSTPU_FUSED_ATTN", "auto")
    if mode not in ("auto", "1", "0"):
        # fail loudly, not open: "off"/"false"/"" must not silently enable
        # the kernel the operator meant to disable
        raise ValueError(
            f"DSTPU_FUSED_ATTN={mode!r} is not a valid mode: use 'auto' "
            f"(the kernels from their thresholds, DSTPU_STREAM_ATTN_MIN and "
            f"DSTPU_BLOCK_ATTN_MIN_CAUSAL), '1' (force a kernel), or '0' "
            f"(the einsum path only)")
    return mode


_KERNEL_GATES = {"stream": "stream_attention.stream_supported",
                 "block": "block_attention.kernel_supported"}


def attention_plan(T, n, d, causal):
    """(fwd_impl, bwd_impl), each in {"xla", "block", "stream"}: the JAX
    package's per-direction dispatch table (``layers.py:545-573``) on the
    port's kernels.  ``DSTPU_FUSED_ATTN`` takes the JAX values:

    * "0": the einsum path;
    * "1": the streaming kernels where the JAX gate takes the shape, else
      the whole-tile kernels, else the einsum path, one impl for both
      directions;
    * "auto": per direction, streaming from ``stream_auto_min``, else the
      whole-tile kernels for causal shapes from ``block_auto_min_causal``,
      else the einsum path; a streaming backward after a whole-tile forward
      becomes a whole-tile backward (no logsumexp).

    Where the JAX gate takes a shape and the CUDA kernels' gate refuses it,
    "auto" treats the kernel as unsupported (the einsum path instead) and
    "1" raises ``NotImplementedError``.  Off the card (the CPU tests) the
    plan is the same, so the CPU runs the card's path in plain versions."""
    mode = _attn_mode()
    if mode == "0":
        return "xla", "xla"
    # (the JAX gate, the CUDA kernels' gate) of each kernel
    gates = {"stream": (sattn.jax_stream_supported(T, d),
                        sattn.stream_supported(T, d)),
             "block": (battn.supported(T, n, d), battn.kernel_supported(T, d))}
    if mode == "1":
        for impl, (jax_ok, kernel_ok) in gates.items():
            if jax_ok and not kernel_ok:
                raise NotImplementedError(
                    f"DSTPU_FUSED_ATTN=1 at seq {T}, head dim {d}: the JAX "
                    f"plan forces its {impl} kernel here, and the CUDA "
                    f"kernels' gate ({_KERNEL_GATES[impl]}) refuses the "
                    f"shape")
            if jax_ok:
                return impl, impl
        return "xla", "xla"
    stream_ok, block_ok = (all(gates[k]) for k in ("stream", "block"))

    def pick(direction):
        if stream_ok and T >= stream_auto_min(causal, direction):
            return "stream"
        bmin = block_auto_min_causal()
        if block_ok and causal and bmin is not None and T >= bmin:
            return "block"
        return "xla"

    fwd, bwd = pick("fwd"), pick("bwd")
    if bwd == "stream" and fwd == "block":
        # a streaming backward needs the forward's logsumexp, which the
        # whole-tile kernel does not emit
        bwd = "block"
    return fwd, bwd


def core_attention(q, k, v, *, causal, attn_mask=None):
    """Attention on q, k, v [B, T, n, d] by ``attention_plan``: the single-
    impl pairs through the kernels' own autograd functions or the einsum
    path, the mixed pairs through ``dispatch_attention``.  ``attn_mask``
    optional [B, T] with 1 = attend.  Returns [B, T, n, d] in q's dtype."""
    B, T, n, d = q.shape
    fwd_impl, bwd_impl = attention_plan(T, n, d, causal)
    if (fwd_impl, bwd_impl) == ("xla", "xla"):
        return xla_attention(q, k, v, attn_mask, causal)
    mvec = (torch.ones((B, T), dtype=torch.float32, device=q.device)
            if attn_mask is None else attn_mask.to(torch.float32))
    if fwd_impl == bwd_impl == "stream":
        return sattn.stream_attention(q, k, v, mvec, causal)
    if fwd_impl == bwd_impl == "block":
        return battn.fused_attention(q, k, v, mvec, causal)
    return dattn.dispatch_attention(q, k, v, mvec, causal, fwd_impl,
                                    bwd_impl)


def multihead_attention(x, qkv_w, qkv_b, proj_w, proj_b, *, n_heads,
                        causal, attn_mask=None, group=None, sp_impl="ring",
                        seq_group=None):
    """Multi-head attention over this rank's heads, with the packed
    head-major qkv projection: the output dim of ``qkv_w`` [h, 3h] is laid
    out (n, 3, d), as in ``layers.py:627``, so a rank's slice [h, 3h / mp]
    is a contiguous block of n / mp whole heads, (n / mp, 3, d), never a
    third each of q, k and v.  ``n_heads`` is the global head count;
    ``proj_w`` [h / mp, h] is row-parallel and ``proj_b`` replicated.

    With a ``seq_group`` (x is this rank's sequence block) ``sp_impl``
    picks the sequence-parallel attention: ``"ring"`` (K/V rotation) or
    ``"ulysses"`` (the head <-> sequence all-to-all round the plain
    attention), as the JAX ``layers.py:604-651``."""
    B, T, h = x.shape
    d = h // n_heads
    qkv = column_parallel_linear(x, qkv_w, qkv_b, name="qkv", group=group)
    n_local = qkv.shape[-1] // (3 * d)
    qkv = qkv.reshape(B, T, n_local, 3, d)
    if seq_group is not None and sp_impl == "ulysses":
        # packed: one all-to-all moves q, k and v together
        from deepspeed_tpu_torch.models.ulysses import \
            ulysses_attention_packed
        ctx = ulysses_attention_packed(qkv, causal=causal,
                                       attn_mask=attn_mask, group=seq_group)
        return row_parallel_linear(ctx.reshape(B, T, n_local * d), proj_w,
                                   proj_b, group=group)
    q, k, v = qkv[..., 0, :], qkv[..., 1, :], qkv[..., 2, :]
    if seq_group is not None:
        if sp_impl != "ring":
            raise ValueError(
                f"unknown sequence_parallel_impl {sp_impl!r} "
                "(expected 'ring' or 'ulysses')")
        from deepspeed_tpu_torch.models.ring_attention import ring_attention
        ctx = ring_attention(q, k, v, causal=causal, kv_mask=attn_mask,
                             group=seq_group)
    else:
        ctx = core_attention(q, k, v, causal=causal, attn_mask=attn_mask)
    return row_parallel_linear(ctx.reshape(B, T, n_local * d), proj_w,
                               proj_b, group=group)
