"""Whole-tile attention: the hand-written CUDA kernels, their plain PyTorch
versions, and the autograd function around them.

The port of the whole-tile half of ``deepspeed_tpu/ops/pallas_attention.py``
(``supported``, ``fused_attention`` and its custom VJP, ``:41-221``).  The
kernels live in ``deepspeed_tpu_torch/csrc/block_attention.cu`` (its header
says which Pallas kernel each replaces, what bounds it and how it is laid
out); ``build()`` compiles that file with ``nvcc`` for ``sm_90a`` into
``build/kernels/`` at first use and loads it with ctypes.  Two routes share
the wrappers (``wide_route``): route 0 at T a multiple of 16 up to 128,
the wgmma kernels in bf16/fp16 (d up to 128, padded to 64 or 128) and FMA
kernels in fp32 (d up to 64), and the wide route
(``block_fwd_wide_kernel``, ``block_bwd_wide_dq_kernel`` +
``block_bwd_wide_dkv_kernel``) at every other shape the JAX gate takes up
to d 128.  Each route counts its own launches.

The kernels take q, k, v in the public ``[B, T, n, d]`` layout through their
strides (the views of the packed qkv projection need no copy) and an fp32
``[B, T]`` key mask (1 = attend); they write contiguous ``[B, T, n, d]``.
Every wrapper takes the same arguments on either device:

* on CUDA tensors it launches its route's kernels on the current stream,
  adds one to ``LAUNCHES[name]`` (``name + "_wide"`` on the wide route),
  and raises if the launch fails.  There is no fallback.
* on CPU tensors it runs the plain version beside it (the CPU tests hold the
  plain versions against the JAX package).

The numerics are the Pallas whole-tile kernels' (``pallas_attention.py:78-
147``), which are not the streaming kernels': scores ``q.k * scale``, the
causal band and then the key mask set to -1e9, an exact softmax over the
whole row normalised BEFORE the cast and the product with V (a row whose
keys are all masked is uniform over all T keys), and a backward that takes
``rowsum(dP * P)`` over the whole row in fp32, casts dS to the input type
without the scale and multiplies the fp32 dQ and dK products by it.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Tuple

import torch

from deepspeed_tpu_torch.ops import _build

SOURCE = _build.CSRC / "block_attention.cu"

#: fp32 score-tile budget per TPU program (``pallas_attention``'s); the JAX
#: gate ``supported`` keeps to half of it
SCORE_TILE_BUDGET = 2 * 1024 * 1024
#: the kernels' gate (``kernel_supported``): the wide route keeps whole fp32
#: score rows of up to 512 keys in shared memory and pads the head dim to
#: 64, 96 or 128; T comes in the JAX gate's steps of 8
KERNEL_MAX_SEQ = 512
KERNEL_SEQ_GRANULE = 8
KERNEL_MAX_HEAD_DIM = 128
#: the route-0 kernels' shapes (``wide_route``): a score row of at most 128
#: keys in registers, T in steps of 16 (a k16 product slice), d padded to 64
#: or 128 by the wgmma kernels (bf16, fp16) and to 32 or 64 by the fp32 ones
WG_MAX_SEQ, WG_SEQ_GRANULE = 128, 16
WG_MAX_HEAD_DIM = {torch.float32: 64, torch.bfloat16: 128,
                   torch.float16: 128}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

#: launches per kernel since the last ``reset_launch_counts()``; each
#: wrapper adds one where it launches its kernel, and nowhere else
LAUNCHES = {"block_fwd": 0, "block_bwd": 0, "block_fwd_wide": 0,
            "block_bwd_wide": 0}

_lib = None
_lib_lock = threading.Lock()
#: compiler output of the last build (ptxas register/spill lines)
build_log = ""


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def build() -> ctypes.CDLL:
    """Compile (once per source version) and load the kernel library."""
    global _lib, build_log
    with _lib_lock:
        if _lib is not None:
            return _lib
        lib, build_log = _build.build_library(SOURCE)
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        # the q/k/v strides, B, n, T, d, scale, causal, stream
        tail = [i64] * 3 + [i32] * 4 + [ctypes.c_float, i32, ptr]
        # dtype, route, then the tensors (the backward's: and the stats)
        lib.dstt_block_fwd.argtypes = [i32, i32] + [ptr] * 5 + tail
        lib.dstt_block_bwd.argtypes = [i32, i32] + [ptr] * 9 + tail
        lib.dstt_block_fwd.restype = lib.dstt_block_bwd.restype = i32
        _lib = lib
        return lib


def _head_block(n_heads: int) -> int:
    return 8 if n_heads % 8 == 0 else n_heads


def supported(seq_len: int, n_heads: int, head_dim: int) -> bool:
    """``pallas_attention.supported`` (``:62-68``): the JAX plan's gate for
    the whole-tile kernel, on the TPU's backward score-tile budget."""
    hb = _head_block(n_heads)
    return (seq_len % 8 == 0 and head_dim % 8 == 0
            and hb * seq_len * seq_len * 4 <= SCORE_TILE_BUDGET // 2)


def kernel_supported(seq_len: int, head_dim: int) -> bool:
    """The CUDA kernels' gate, in every input type: T a multiple of 8 in
    [8, 512], d a multiple of 8 up to 128.  With ``supported`` it is the
    JAX gate wherever d <= 128 (the score-tile budget keeps T <= 512)."""
    return (seq_len % KERNEL_SEQ_GRANULE == 0
            and KERNEL_SEQ_GRANULE <= seq_len <= KERNEL_MAX_SEQ
            and head_dim % 8 == 0 and 0 < head_dim <= KERNEL_MAX_HEAD_DIM)


def wide_route(seq_len: int, head_dim: int, dtype: torch.dtype) -> bool:
    """Whether a shape of ``kernel_supported`` runs the wide route in
    ``dtype``: every shape but T a multiple of 16 in [16, 128] with d up to
    128 (bf16, fp16) or 64 (fp32)."""
    return not (seq_len % WG_SEQ_GRANULE == 0
                and WG_SEQ_GRANULE <= seq_len <= WG_MAX_SEQ
                and head_dim <= WG_MAX_HEAD_DIM[dtype])


# --------------------------------------------------------- plain versions

def _probs(q, k, mask, causal):
    """``_softmax(_scores(...))``: fp32 [B, n, T, T] probabilities from q, k
    [B, T, n, d] (products of the input type summed in fp32) and the [B, T]
    key mask."""
    T, d = q.shape[1], q.shape[3]
    s = torch.einsum("btnd,bsnd->bnts", q.float(), k.float()) * (
        1.0 / d ** 0.5)
    masked = s.new_tensor(-1e9)
    if causal:
        keep = torch.ones((T, T), dtype=torch.bool, device=q.device).tril()
        s = torch.where(keep, s, masked)
    s = torch.where(mask[:, None, None, :] != 0, s, masked)
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    return e / e.sum(dim=-1, keepdim=True)


def block_fwd_plain(q, k, v, mask, causal):
    """``o [B, T, n, d]``: what ``block_fwd_kernel`` computes."""
    p = _probs(q, k, mask, causal)
    o = torch.einsum("bnts,bsnd->btnd", p.to(v.dtype).float(), v.float())
    return o.to(q.dtype)


def block_bwd_plain(q, k, v, mask, do, causal):
    """``(dq, dk, dv)``: what ``block_bwd_kernel`` computes."""
    cdt, scale = q.dtype, 1.0 / q.shape[3] ** 0.5
    p = _probs(q, k, mask, causal)
    dof = do.float()
    dv = torch.einsum("bnts,btnd->bsnd", p.to(cdt).float(), dof)
    dp = torch.einsum("btnd,bsnd->bnts", dof, v.float())
    ds = (p * (dp - (dp * p).sum(dim=-1, keepdim=True))).to(cdt).float()
    dq = torch.einsum("bnts,bsnd->btnd", ds, k.float()) * scale
    dk = torch.einsum("bnts,btnd->bsnd", ds, q.float()) * scale
    return dq.to(cdt), dk.to(k.dtype), dv.to(v.dtype)


# ----------------------------------------------------------------- wrappers

def _check(name, q, mask, k, v, do=None):
    """The kernels take q, k, v of one type (fp32, bf16 or fp16) and one
    layout [B, T, n, d] (last dim contiguous, 16-byte aligned rows), dO
    contiguous, and an fp32 contiguous [B, T] mask, on one device."""
    B, T, n, d = q.shape
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"{name}: q must be float32, bfloat16 or float16, "
                        f"got {q.dtype}")
    if not kernel_supported(T, d):
        raise ValueError(
            f"{name}: the kernels take T a multiple of {KERNEL_SEQ_GRANULE} "
            f"up to {KERNEL_MAX_SEQ} and d a multiple of 8 up to "
            f"{KERNEL_MAX_HEAD_DIM}, got T={T}, d={d}")
    elt = q.element_size()
    for arg, t in (("q", q), ("k", k), ("v", v), ("do", do)):
        if t is None:
            continue
        if tuple(t.shape) != (B, T, n, d) or t.dtype != q.dtype:
            raise ValueError(f"{name}: {arg} must be {q.dtype} "
                             f"{(B, T, n, d)}, got {t.dtype} "
                             f"{tuple(t.shape)}")
        if arg == "do" and not t.is_contiguous():
            raise ValueError(f"{name}: do must be contiguous")
        if t.stride() != q.stride() and arg != "do":
            raise ValueError(f"{name}: q, k and v must share one layout, "
                             f"got strides {q.stride()} and {t.stride()}")
        if (t.stride(-1) != 1 or t.data_ptr() % 16
                or any(s * elt % 16 for s in t.stride()[:3])):
            raise ValueError(f"{name}: {arg} must have a contiguous last "
                             f"dim and 16-byte aligned rows")
        if t.device != q.device:
            raise ValueError(f"{name}: {arg} is on {t.device}, expected "
                             f"{q.device}")
    if (tuple(mask.shape) != (B, T) or mask.dtype != torch.float32
            or not mask.is_contiguous()):
        raise ValueError(f"{name}: mask must be contiguous float32 "
                         f"{(B, T)}, got {mask.dtype} {tuple(mask.shape)}")
    if mask.device != q.device:
        raise ValueError(f"{name}: mask is on {mask.device}, expected "
                         f"{q.device}")


def _launch(name, fn, q, *ptrs, causal):
    B, T, n, d = q.shape
    wide = wide_route(T, d, q.dtype)
    rc = fn(_DTYPE_CODE[q.dtype], int(wide), *ptrs, *q.stride()[:3], B, n, T,
            d, 1.0 / d ** 0.5, int(bool(causal)),
            torch.cuda.current_stream(q.device).cuda_stream)
    _build.raise_on(name, _lib, rc)
    LAUNCHES[name + "_wide" if wide else name] += 1


def _fwd_fake(q, k, v, mask, causal):
    return torch.empty(q.shape, dtype=q.dtype, device=q.device)


def _bwd_fake(q, k, v, mask, do, causal):
    return tuple(torch.empty(q.shape, dtype=q.dtype, device=q.device)
                 for _ in range(3))


@_build.kernel_op("block_fwd", _fwd_fake)
def block_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              mask: torch.Tensor, causal: bool) -> torch.Tensor:
    """``o`` contiguous [B, T, n, d]."""
    if not _build.on_cuda("block_fwd", q):
        return block_fwd_plain(q, k, v, mask, causal)
    _check("block_fwd", q, mask, k, v)
    lib = build()
    o = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _launch("block_fwd", lib.dstt_block_fwd, q, q.data_ptr(), k.data_ptr(),
            v.data_ptr(), mask.data_ptr(), o.data_ptr(), causal=causal)
    return o


@_build.kernel_op("block_bwd", _bwd_fake)
def block_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              mask: torch.Tensor, do: torch.Tensor, causal: bool
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dq, dk, dv)``, each contiguous [B, T, n, d]."""
    if not _build.on_cuda("block_bwd", q):
        return block_bwd_plain(q, k, v, mask, do, causal)
    _check("block_bwd", q, mask, k, v, do)
    lib = build()
    dq, dk, dv = (torch.empty(q.shape, dtype=q.dtype, device=q.device)
                  for _ in range(3))
    B, T, n, d = q.shape
    # the wide route's row max, sum and t, from its dq kernel to its dkv
    # kernel
    stats = (torch.empty((3, B, n, T), dtype=torch.float32, device=q.device)
             if wide_route(T, d, q.dtype) else None)
    _launch("block_bwd", lib.dstt_block_bwd, q, q.data_ptr(), k.data_ptr(),
            v.data_ptr(), mask.data_ptr(), do.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(),
            None if stats is None else stats.data_ptr(), causal=causal)
    return dq, dk, dv


def one_layout(q, k, v):
    """q, k, v as they are when they share one layout with a contiguous last
    dim (the views of one qkv tensor), else contiguous copies."""
    if q.stride() == k.stride() == v.stride() and q.stride(-1) == 1:
        return q, k, v
    return q.contiguous(), k.contiguous(), v.contiguous()


class FusedAttention(torch.autograd.Function):
    """``pallas_attention.fused_attention`` with its custom VJP: q, k, v
    [B, T, n, d], attn_mask fp32 [B, T] (1 = attend) -> [B, T, n, d].  The
    forward saves q, k, v and the mask; the backward recomputes the
    probabilities in the kernel."""

    @staticmethod
    def forward(ctx, q, k, v, attn_mask, causal):
        q, k, v = one_layout(q, k, v)
        ctx.save_for_backward(q, k, v, attn_mask)
        ctx.causal = causal
        return block_fwd(q, k, v, attn_mask, causal)

    @staticmethod
    def backward(ctx, g):
        q, k, v, attn_mask = ctx.saved_tensors
        dq, dk, dv = block_bwd(q, k, v, attn_mask, g.contiguous(), ctx.causal)
        # the mask is a float selector, not a trainable input
        return dq, dk, dv, None, None


def fused_attention(q, k, v, attn_mask, causal=False):
    """Whole-tile attention on public-layout q, k, v [B, T, n, d] with an
    fp32 [B, T] mask; callers gate on ``supported`` and, on the card,
    ``kernel_supported``."""
    return FusedAttention.apply(q, k, v, attn_mask, causal)
