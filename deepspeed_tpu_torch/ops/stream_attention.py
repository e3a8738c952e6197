"""Streaming (online-softmax) attention: the hand-written CUDA kernels, their
plain PyTorch versions, and the autograd function around them.

The port of the stream half of ``deepspeed_tpu/ops/pallas_attention.py``
(``stream_attention`` and its custom VJP).  The kernels live in
``deepspeed_tpu_torch/csrc/stream_attention.cu`` (its header says which
Pallas kernel each replaces, what bounds it and how it is laid out);
``build()`` compiles that file with ``nvcc`` for ``sm_90a`` into
``build/kernels/`` at first use and loads it with ctypes.

The kernels work on head-folded ``[G = B*n, T, d]`` operands with an fp32
``[G, 1, T]`` key mask (1 = attend), logsumexp and delta.  Every wrapper
takes the same arguments on either device:

* on CUDA tensors it launches its kernel on the current stream, adds one to
  ``LAUNCHES[name]``, and raises if the launch fails.  There is no fallback.
* on CPU tensors it runs the plain version beside it (the CPU tests hold the
  plain versions against the JAX package).

The numerics are the Pallas kernels' (``pallas_attention.py:268-327``):
masked scores -1e9, unnormalised probabilities cast to the input type
before ``.V``, normalised by ``max(l, 1e-30)`` afterwards, the backward's
``dS`` cast to the input type before the dQ/dK products, and
``delta = rowsum(dO * O)`` in fp32 outside the kernels.
"""

from __future__ import annotations

import ctypes
import math
import os
import threading
from typing import Tuple

import torch

from deepspeed_tpu_torch.ops import _build

SOURCE = _build.CSRC / "stream_attention.cu"

#: the stream gate's sequence granule (``pallas_attention.STREAM_TILE_MIN``)
STREAM_TILE_MIN = 256
#: the kernels stage the head dim in shared memory padded to 64, 128 or
#: 256 (the port's own gate; the Pallas kernels have none)
STREAM_MAX_HEAD_DIM = 256
#: query/kv rows per kernel tile: the sequence must be a multiple of it
KERNEL_TILE = 64

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

#: launches per kernel since the last ``reset_launch_counts()``; each
#: wrapper adds one where it launches its kernel, and nowhere else
LAUNCHES = {"stream_fwd": 0, "stream_bwd_fused": 0, "stream_dkv": 0,
            "stream_dq": 0}

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
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        # dtype code, the pointers, then G, T, d, scale, causal, stream
        shape = [i32, i32, i32, f32, i32, ptr]
        lib.dstt_stream_fwd.argtypes = [i32] + [ptr] * 6 + shape
        lib.dstt_stream_bwd_fused.argtypes = [i32] + [ptr] * 11 + shape
        lib.dstt_stream_dkv.argtypes = [i32] + [ptr] * 9 + shape
        lib.dstt_stream_dq.argtypes = [i32] + [ptr] * 8 + shape
        for fn in (lib.dstt_stream_fwd, lib.dstt_stream_bwd_fused,
                   lib.dstt_stream_dkv, lib.dstt_stream_dq):
            fn.restype = i32
        lib.dstt_stream_bwd_fused_scratch.argtypes = [i32] * 4 + [
            ctypes.POINTER(ctypes.c_longlong)]
        lib.dstt_stream_bwd_fused_scratch.restype = ctypes.c_longlong
        _lib = lib
        return lib


def jax_stream_supported(seq_len: int, head_dim: int) -> bool:
    """``pallas_attention.stream_supported`` (``:252-254``): the JAX plan's
    gate for the streaming kernels."""
    return (seq_len % STREAM_TILE_MIN == 0 and seq_len >= STREAM_TILE_MIN
            and head_dim % 8 == 0)


def stream_supported(seq_len: int, head_dim: int) -> bool:
    """The JAX gate plus the kernels' head-dim limit."""
    return (jax_stream_supported(seq_len, head_dim)
            and head_dim <= STREAM_MAX_HEAD_DIM)


def _stream_bwd_mode() -> str:
    mode = os.environ.get("DSTPU_STREAM_BWD", "auto")
    if mode not in ("auto", "fused", "split"):
        raise ValueError(
            f"DSTPU_STREAM_BWD={mode!r} is not a valid mode: use 'auto' "
            f"(the fused single-pass backward while its dQ scratch fits "
            f"STREAM_FUSED_SCRATCH_BUDGET, else the split pair), 'fused', "
            f"or 'split' (the two-kernel dK/dV + dQ backward)")
    return mode


#: bytes of fused-backward scratch up to which ``auto`` takes the fused
#: kernel; past it ``auto`` takes the split pair, which needs no scratch
#: (``pallas_attention._fused_bwd_fits`` gates on VMEM the same way).
#:
#: The rule: the scratch is cached per device and stream for the life of
#: the process, so the cap is 256 MiB; below it the budget is the largest
#: fused scratch of ``chip_smoke.py``'s ``bwd_sweep`` (16 heads, d 64,
#: 4,096 tokens a call, T 256-2048, causal and not, bf16 and fp32;
#: CUDA-graph device time, the forward excluded) such that the fused
#: kernel is no slower than the pair at every swept shape whose scratch is
#: no larger, for every dtype.  0: ``auto`` always takes the pair.
#:
#: The sweep, on an NVIDIA H100 80GB HBM3 at 700 W, ms fused / pair,
#: non-causal then causal, at T 256, 512, 1024, 2048.  bf16 (fused scratch
#: 32, 64, 128, 256 MiB and 4 KB of counters):
#:   0.1289/0.1069 0.1092/0.08742, 0.242/0.1717 0.1752/0.1308,
#:   0.5211/0.3043 0.3313/0.2232, 1.108/0.5826 0.6392/0.4064.
#: fp32, the FMA route (fused scratch 16 MiB at every T):
#:   1.405/1.714 0.8089/0.977, 3.525/3.371 1.797/1.791,
#:   13.8/6.694 6.8/3.448, 54.71/13.33 26.23/6.742.
#: The bf16 pair is faster at every T.  The fp32 fused kernel wins only at
#: T 256, with the same scratch as where it loses, so no scratch size
#: separates the two: the budget is 0 for both.
STREAM_FUSED_SCRATCH_BUDGET = 0


def _bwd_warps(T: int, d: int) -> int:
    """``bwd_warps`` (csrc/stream_attention.cu): groups of 16 keys per
    fused-backward block (one warp each; two at head dims past 128, each
    with half the columns of dK and dV, so the keys a block stay 64)."""
    return 8 if d <= 64 and T % 128 == 0 else 4


def fused_scratch_words(dtype, G: int, T: int, d: int):
    """``(words, counter words)`` of the fused backward's scratch, as
    ``dstt_stream_bwd_fused_scratch`` computes them: fp32 [G, T, d] for
    fp32; for bf16/fp16 one int counter per (g, 64-row query tile), padded
    to a multiple of 4, then fp32 partials [T / BK, G, T, d]."""
    gtd = G * T * d
    if dtype == torch.float32:
        return gtd, 0
    counters = (G * (T // KERNEL_TILE) + 3) // 4 * 4
    return counters + T // (16 * _bwd_warps(T, d)) * gtd, counters


def release_fused_scratch() -> None:
    """Drop the fused backward's cached scratch on every device and
    stream (the next fused call allocates it anew): at head dim 256 and
    seq 2048 it is ``4 T / 64 G T d`` bytes, 2.1 GB at G = 32."""
    _scratch.clear()


def _fused_bwd_fits(dtype, G: int, T: int, d: int) -> bool:
    return 4 * fused_scratch_words(dtype, G, T, d)[0] <= \
        STREAM_FUSED_SCRATCH_BUDGET


# ------------------------------------------------------------------ layout

def fold_gtd(x: torch.Tensor) -> torch.Tensor:
    """public [B, T, n, d] -> contiguous kernel [B*n, T, d]."""
    B, T, n, d = x.shape
    return x.movedim(2, 1).reshape(B * n, T, d).contiguous()


def unfold_gtd(x: torch.Tensor, B: int, n: int) -> torch.Tensor:
    """kernel [B*n, T, d] -> public [B, T, n, d] (a view)."""
    G, T, d = x.shape
    return x.reshape(B, n, T, d).movedim(1, 2)


def mask_gtd(attn_mask: torch.Tensor, B: int, T: int, n: int):
    """[B, T] mask -> contiguous fp32 [B*n, 1, T] (``_mask_gtd``)."""
    return (attn_mask.to(torch.float32)[:, None, :].expand(B, n, T)
            .reshape(B * n, 1, T).contiguous())


# --------------------------------------------------------- plain versions

def _scores(qg, kg, maskg, causal, scale):
    """Masked fp32 scores [G, T, T]: products of the input type summed in
    fp32 (both operands go up to fp32, where their products are exact)."""
    s = torch.matmul(qg.float(), kg.float().transpose(1, 2)) * scale
    s = torch.where(maskg != 0, s, s.new_tensor(-1e9))
    if causal:
        T = qg.shape[1]
        keep = torch.ones((T, T), dtype=torch.bool, device=qg.device).tril()
        s = torch.where(keep, s, s.new_tensor(-1e9))
    return s


def _mm(a, b, dtype):
    """``a @ b`` with both rounded to ``dtype`` and summed in fp32."""
    return torch.matmul(a.to(dtype).float(), b.to(dtype).float())


def stream_fwd_plain(qg, kg, vg, maskg, causal):
    """``(o, lse)``: what ``stream_fwd_kernel`` computes, over the whole row
    at once (the Pallas kernel's one-tile case, T <= 512)."""
    scale = 1.0 / math.sqrt(qg.shape[-1])
    s = _scores(qg, kg, maskg, causal, scale)
    m = torch.maximum(s.amax(dim=-1), s.new_tensor(-1e30))
    p = torch.exp(s - m[..., None])
    l = torch.clamp(p.sum(dim=-1), min=1e-30)
    o = _mm(p, vg, vg.dtype) / l[..., None]
    return o.to(qg.dtype), (m + torch.log(l))[:, None, :]


def _p_ds_plain(qg, kg, vg, maskg, dog, lse, delta, causal):
    """``_recompute_p_ds``: fp32 probabilities from the logsumexp and dS with
    the scale folded in, both [G, T, T]."""
    scale = 1.0 / math.sqrt(qg.shape[-1])
    s = _scores(qg, kg, maskg, causal, scale)
    p = torch.exp(s - lse.reshape(lse.shape[0], -1, 1))
    dp = torch.matmul(dog.float(), vg.float().transpose(1, 2))
    ds = p * (dp - delta.reshape(delta.shape[0], -1, 1)) * scale
    return p, ds


def stream_dkv_plain(qg, kg, vg, maskg, dog, lse, delta, causal):
    """``(dk, dv)``: what ``stream_dkv_kernel`` computes."""
    p, ds = _p_ds_plain(qg, kg, vg, maskg, dog, lse, delta, causal)
    cdt = qg.dtype
    dk = _mm(ds.transpose(1, 2), qg, cdt)
    dv = _mm(p.transpose(1, 2), dog, cdt)
    return dk.to(kg.dtype), dv.to(vg.dtype)


def stream_dq_plain(qg, kg, vg, maskg, dog, lse, delta, causal):
    """``dq``: what ``stream_dq_kernel`` computes."""
    _, ds = _p_ds_plain(qg, kg, vg, maskg, dog, lse, delta, causal)
    return _mm(ds, kg, qg.dtype).to(qg.dtype)


def stream_bwd_plain(qg, kg, vg, maskg, dog, lse, delta, causal):
    """``(dq, dk, dv)``: what ``stream_bwd_fused_kernel`` computes, with one
    recompute of p and dS."""
    p, ds = _p_ds_plain(qg, kg, vg, maskg, dog, lse, delta, causal)
    cdt = qg.dtype
    dq = _mm(ds, kg, cdt)
    dk = _mm(ds.transpose(1, 2), qg, cdt)
    dv = _mm(p.transpose(1, 2), dog, cdt)
    return dq.to(qg.dtype), dk.to(kg.dtype), dv.to(vg.dtype)


# ----------------------------------------------------------------- wrappers

def _check(name, qg, rows=(), **tensors):
    """The kernels take contiguous [G, T, d] operands of one type (fp32,
    bf16 or fp16) and fp32 [G, 1, T] row vectors, 16-byte aligned, on one
    device."""
    G, T, d = qg.shape
    if qg.dtype not in _DTYPE_CODE:
        raise TypeError(f"{name}: q must be float32, bfloat16 or float16, "
                        f"got {qg.dtype}")
    if T % KERNEL_TILE or d % 8 or d > STREAM_MAX_HEAD_DIM:
        raise ValueError(f"{name}: the kernels take T a multiple of "
                         f"{KERNEL_TILE} and d a multiple of 8 up to "
                         f"{STREAM_MAX_HEAD_DIM}, got T={T}, d={d}")
    for arg, t in tensors.items():
        want = ((G, 1, T), torch.float32) if arg in rows else (
            (G, T, d), qg.dtype)
        if tuple(t.shape) != want[0] or t.dtype != want[1]:
            raise ValueError(f"{name}: {arg} must be {want[1]} {want[0]}, "
                             f"got {t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: {arg} must be contiguous and "
                             f"16-byte aligned")
        if t.device != qg.device:
            raise ValueError(f"{name}: {arg} is on {t.device}, expected "
                             f"{qg.device}")


def _launch(name, fn, qg, *ptrs, causal):
    G, T, d = qg.shape
    rc = fn(_DTYPE_CODE[qg.dtype], *ptrs, G, T, d, 1.0 / math.sqrt(d),
            int(bool(causal)), torch.cuda.current_stream(qg.device).cuda_stream)
    _build.raise_on(name, _lib, rc)
    LAUNCHES[name] += 1


def _fwd_fake(qg, kg, vg, maskg, causal):
    return torch.empty_like(qg), torch.empty_like(maskg)


def _bwd_fake(qg, kg, vg, maskg, dog, lse, delta, causal):
    return tuple(torch.empty_like(qg) for _ in range(3))


def _dkv_fake(qg, kg, vg, maskg, dog, lse, delta, causal):
    return torch.empty_like(kg), torch.empty_like(vg)


def _dq_fake(qg, kg, vg, maskg, dog, lse, delta, causal):
    return torch.empty_like(qg)


@_build.kernel_op("stream_fwd", _fwd_fake)
def stream_fwd(qg: torch.Tensor, kg: torch.Tensor, vg: torch.Tensor,
               maskg: torch.Tensor, causal: bool
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(o [G, T, d], lse fp32 [G, 1, T])``."""
    if not _build.on_cuda("stream_fwd", qg):
        return stream_fwd_plain(qg, kg, vg, maskg, causal)
    _check("stream_fwd", qg, ("mask",), q=qg, k=kg, v=vg, mask=maskg)
    lib = build()
    o = torch.empty_like(qg)
    lse = torch.empty_like(maskg)
    _launch("stream_fwd", lib.dstt_stream_fwd, qg, qg.data_ptr(),
            kg.data_ptr(), vg.data_ptr(), maskg.data_ptr(), o.data_ptr(),
            lse.data_ptr(), causal=causal)
    return o, lse


_BWD_ROWS = ("mask", "lse", "delta")


#: the fused backward's scratch per (device, stream): [buffer, words at its
#: start known to be zero].  The bf16/fp16 kernel wants its int counters
#: (at the start) zero and leaves them zero, so launches in stream order
#: share one buffer and only a wider counter block needs a memset.
_scratch = {}


def _fused_scratch(lib, qg):
    """The scratch the library asks for at this shape; the ``auto`` gate's
    mirror must give the same size, or the gate would misjudge it."""
    G, T, d = qg.shape
    c_counters = ctypes.c_longlong(0)
    words = lib.dstt_stream_bwd_fused_scratch(_DTYPE_CODE[qg.dtype], G, T, d,
                                              ctypes.byref(c_counters))
    counters = c_counters.value
    if (words, counters) != fused_scratch_words(qg.dtype, G, T, d):
        raise RuntimeError(
            f"fused_scratch_words{(qg.dtype, G, T, d)} = "
            f"{fused_scratch_words(qg.dtype, G, T, d)} disagrees with "
            f"dstt_stream_bwd_fused_scratch = {(words, counters)}")
    key = (qg.device, torch.cuda.current_stream(qg.device).cuda_stream)
    entry = _scratch.get(key)
    if entry is None or entry[0].numel() < words:
        entry = _scratch[key] = [torch.zeros(words, dtype=torch.float32,
                                             device=qg.device), words]
    buf, zeroed = entry
    if counters > zeroed:
        buf[:counters].zero_()
    # the call overwrites whatever lies after its counters
    entry[1] = counters
    return buf


@_build.kernel_op("stream_bwd_fused", _bwd_fake)
def stream_bwd_fused(
        qg: torch.Tensor, kg: torch.Tensor, vg: torch.Tensor,
        maskg: torch.Tensor, dog: torch.Tensor, lse: torch.Tensor,
        delta: torch.Tensor, causal: bool
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dq, dk, dv)`` in one pass.  dQ is summed in a scratch that stays
    allocated between calls: ``fused_scratch_words`` (fp32 [G, T, d] for
    fp32; for bf16/fp16 the counters and the fp32 partials
    [T / BK, G, T, d], quadratic in T)."""
    if not _build.on_cuda("stream_bwd_fused", qg):
        return stream_bwd_plain(qg, kg, vg, maskg, dog, lse, delta, causal)
    _check("stream_bwd_fused", qg, _BWD_ROWS, q=qg, k=kg, v=vg, mask=maskg,
           do=dog, lse=lse, delta=delta)
    lib = build()
    dq, dk, dv = (torch.empty_like(qg) for _ in range(3))
    dq_acc = _fused_scratch(lib, qg)
    _launch("stream_bwd_fused", lib.dstt_stream_bwd_fused, qg, qg.data_ptr(),
            kg.data_ptr(), vg.data_ptr(), maskg.data_ptr(), dog.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), dq_acc.data_ptr(), causal=causal)
    return dq, dk, dv


@_build.kernel_op("stream_dkv", _dkv_fake)
def stream_dkv(
        qg: torch.Tensor, kg: torch.Tensor, vg: torch.Tensor,
        maskg: torch.Tensor, dog: torch.Tensor, lse: torch.Tensor,
        delta: torch.Tensor, causal: bool
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(dk, dv)``, the first kernel of the split backward."""
    if not _build.on_cuda("stream_dkv", qg):
        return stream_dkv_plain(qg, kg, vg, maskg, dog, lse, delta, causal)
    _check("stream_dkv", qg, _BWD_ROWS, q=qg, k=kg, v=vg, mask=maskg,
           do=dog, lse=lse, delta=delta)
    lib = build()
    dk, dv = torch.empty_like(kg), torch.empty_like(vg)
    _launch("stream_dkv", lib.dstt_stream_dkv, qg, qg.data_ptr(),
            kg.data_ptr(), vg.data_ptr(), maskg.data_ptr(), dog.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            causal=causal)
    return dk, dv


@_build.kernel_op("stream_dq", _dq_fake)
def stream_dq(
        qg: torch.Tensor, kg: torch.Tensor, vg: torch.Tensor,
        maskg: torch.Tensor, dog: torch.Tensor, lse: torch.Tensor,
        delta: torch.Tensor, causal: bool) -> torch.Tensor:
    """``dq``, the second kernel of the split backward."""
    if not _build.on_cuda("stream_dq", qg):
        return stream_dq_plain(qg, kg, vg, maskg, dog, lse, delta, causal)
    _check("stream_dq", qg, _BWD_ROWS, q=qg, k=kg, v=vg, mask=maskg,
           do=dog, lse=lse, delta=delta)
    lib = build()
    dq = torch.empty_like(qg)
    _launch("stream_dq", lib.dstt_stream_dq, qg, qg.data_ptr(),
            kg.data_ptr(), vg.data_ptr(), maskg.data_ptr(), dog.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), causal=causal)
    return dq


def stream_backward(qg, kg, vg, maskg, o, lse, dog, causal):
    """``_stream_bwd_impl``: delta = rowsum(dO * O) in fp32, then the fused
    kernel (``fused``; ``auto`` while its scratch fits
    ``STREAM_FUSED_SCRATCH_BUDGET``) or the split pair (``split``; ``auto``
    past the budget)."""
    delta = (dog.float() * o.float()).sum(dim=-1)[:, None, :]
    mode = _stream_bwd_mode()
    if mode == "split" or (mode == "auto" and not _fused_bwd_fits(
            qg.dtype, *qg.shape)):
        dk, dv = stream_dkv(qg, kg, vg, maskg, dog, lse, delta, causal)
        return stream_dq(qg, kg, vg, maskg, dog, lse, delta, causal), dk, dv
    return stream_bwd_fused(qg, kg, vg, maskg, dog, lse, delta, causal)


class StreamAttention(torch.autograd.Function):
    """``pallas_attention.stream_attention`` with its custom VJP: q, k, v
    [B, T, n, d], attn_mask [B, T] (1 = attend) -> [B, T, n, d].  The
    forward saves the folded operands, ``o`` and ``lse``; the backward
    recomputes the probabilities from ``lse``."""

    @staticmethod
    def forward(ctx, q, k, v, attn_mask, causal):
        B, T, n, d = q.shape
        qg, kg, vg = fold_gtd(q), fold_gtd(k), fold_gtd(v)
        maskg = mask_gtd(attn_mask, B, T, n)
        o, lse = stream_fwd(qg, kg, vg, maskg, causal)
        ctx.save_for_backward(qg, kg, vg, maskg, o, lse)
        ctx.causal, ctx.bn = causal, (B, n)
        return unfold_gtd(o, B, n)

    @staticmethod
    def backward(ctx, g):
        qg, kg, vg, maskg, o, lse = ctx.saved_tensors
        dq, dk, dv = stream_backward(qg, kg, vg, maskg, o, lse, fold_gtd(g),
                                     ctx.causal)
        B, n = ctx.bn
        # the mask is a float selector, not a trainable input
        return (unfold_gtd(dq, B, n), unfold_gtd(dk, B, n),
                unfold_gtd(dv, B, n), None, None)


def stream_attention(q, k, v, attn_mask, causal=False):
    """Streaming attention on public-layout q, k, v [B, T, n, d] with an
    [B, T] mask; callers gate on ``stream_supported(T, d)``."""
    return StreamAttention.apply(q, k, v, attn_mask, causal)


# ------------------------------------------------------------ calibration

#: the calibration's winning margin: the kernels' fwd+bwd must be this
#: many times faster than the einsum path's
CALIBRATE_WIN = 1.05


def threshold_from_ratios(ratios, fallback: int,
                          win: float = CALIBRATE_WIN) -> int:
    """The rule of ``calibrate_stream_threshold``: the smallest sequence
    length whose ``einsum_ms / kernel_ms`` in ``ratios`` ({seq: ratio}) is
    at least ``win``, else ``fallback``."""
    for T in sorted(ratios):
        if ratios[T] >= win:
            return int(T)
    return int(fallback)


def calibrate_stream_threshold(seq_lens=(256, 512, 1024, 2048), batch=8,
                               n_heads=12, head_dim=64, steps=6,
                               verbose=True, rows=None) -> int:
    """Measure the streaming kernels' crossover against the einsum path
    on the current CUDA device and return the smallest winning sequence
    length (``deepspeed_tpu/ops/pallas_attention.py``
    ``calibrate_stream_threshold``): fwd+bwd of both paths on bf16,
    causal ``[batch, T, n_heads, head_dim]`` operands, timed between CUDA
    events over ``steps`` calls after a warm-up, and the first length
    where the kernels are >= 1.05x faster.  When none is, the causal entry
    of ``models/layers.STREAM_AUTO_MIN_BY_KIND`` for this card (else the
    default), ignoring any environment pin, as the reference does.  Pin
    the result with ``DSTPU_STREAM_ATTN_MIN_CAUSAL``.  ``rows``: a list
    that receives one dict per measured length.  Needs a CUDA device."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "calibrate_stream_threshold needs a CUDA device (the kernels "
            "never run off the card)")
    from deepspeed_tpu_torch.models import layers as L
    from deepspeed_tpu_torch.ops.dispatch_attention import xla_attention
    device = torch.device("cuda", torch.cuda.current_device())

    def time_ms(T, use_kernel):
        gen = torch.Generator(device=device).manual_seed(0)
        q, k, v = (torch.randn((batch, T, n_heads, head_dim), generator=gen,
                               device=device).to(torch.bfloat16)
                   for _ in range(3))
        mask = torch.ones((batch, T), device=device)

        def run():
            leaves = [x.detach().requires_grad_() for x in (q, k, v)]
            o = (stream_attention(*leaves, mask, True) if use_kernel
                 else xla_attention(*leaves, causal=True))
            return torch.autograd.grad((o.float() ** 2).sum(), leaves)

        run()                                    # warm-up (and the build)
        start, stop = (torch.cuda.Event(enable_timing=True)
                       for _ in range(2))
        start.record()
        for _ in range(steps):
            run()
        stop.record()
        stop.synchronize()
        return start.elapsed_time(stop) / steps

    ratios = {}
    for T in sorted(seq_lens):
        if not stream_supported(T, head_dim):
            continue
        t_xla, t_ker = time_ms(T, False), time_ms(T, True)
        ratios[T] = t_xla / t_ker
        if rows is not None:
            rows.append({"seq": T, "einsum_ms": t_xla, "stream_ms": t_ker,
                         "einsum_over_stream": ratios[T]})
        if verbose:
            print(f"seq {T}: einsum {t_xla:.3f} ms, kernels {t_ker:.3f} ms, "
                  f"{ratios[T]:.2f}x")
    entry = L.STREAM_AUTO_MIN_BY_KIND.get(torch.cuda.get_device_name(device))
    fallback = (min(entry["causal"]) if entry
                else L.STREAM_AUTO_MIN_CAUSAL)
    threshold = threshold_from_ratios(ratios, fallback)
    if verbose:
        print(f"crossover at seq {threshold}: export "
              f"DSTPU_STREAM_ATTN_MIN_CAUSAL={threshold}"
              if threshold in ratios and ratios[threshold] >= CALIBRATE_WIN
              else f"kernels never won >= {CALIBRATE_WIN}x; keeping "
                   f"{threshold}")
    return threshold
