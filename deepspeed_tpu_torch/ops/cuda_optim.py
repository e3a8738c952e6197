"""Fused LAMB and Adam steps: the hand-written CUDA kernels and their plain
PyTorch versions.

The kernels live in ``deepspeed_tpu_torch/csrc/fused_optim.cu`` (its header
says which Pallas kernel each replaces, what bounds it and how it is laid
out).  ``build()`` compiles that file with ``nvcc`` for ``sm_90a`` into
``build/kernels/`` at first use and loads it with ctypes.

Every wrapper takes the same arguments on either device:

* on a CUDA tensor it launches its kernel on the current stream, adds one
  to ``LAUNCHES[name]``, and raises if the launch fails.  There is no
  fallback.
* on a CPU tensor it runs the plain version beside it (the CPU tests hold
  the plain versions against the JAX package).

``p``, ``m`` and ``v`` are updated IN PLACE on both routes.  All state is
fp32 and contiguous.  The runtime scalars of one tensor are one row of the
fp32 buffer that ``make_scalars`` builds on the tensors' device:
``[beta1, beta2, 1/combined_scale, step_size, weight_decay, lr, 0, 0]``.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Sequence, Tuple

import torch

from deepspeed_tpu_torch.ops import _build

SOURCE = _build.CSRC / "fused_optim.cu"
NVCC_FLAGS = _build.NVCC_FLAGS

#: columns of a scalars row
B1, B2, INV_SCALE, STEP_SIZE, WEIGHT_DECAY, LR = range(6)
SCALAR_COLS = 8

_THREADS = 256
_MAX_BLOCKS = 1024

#: launches per kernel since the last ``reset_launch_counts()``; each
#: wrapper adds one where it launches its kernel, and nowhere else
LAUNCHES = {"lamb_phase1": 0, "lamb_phase2": 0, "adam": 0}

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
        ptr, i32, i64, f32 = (ctypes.c_void_p, ctypes.c_int,
                              ctypes.c_int64, ctypes.c_float)
        lib.dstt_lamb_phase1.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr, i32,
                                         ptr, i64, f32, i32, ptr]
        lib.dstt_lamb_phase2.argtypes = [ptr, ptr, ptr, i32, ptr, i64, f32,
                                         f32, ptr]
        lib.dstt_adam.argtypes = [ptr, ptr, ptr, ptr, i32, ptr, i64, f32,
                                  i32, i32, ptr]
        for fn in (lib.dstt_lamb_phase1, lib.dstt_lamb_phase2, lib.dstt_adam):
            fn.restype = i32
        _lib = lib
        return lib


def _grid(n: int) -> int:
    return max(1, min(-(-n // (_THREADS * 4)), _MAX_BLOCKS))


def _check(name: str, n: int, device: torch.device, **tensors) -> None:
    for arg, t in tensors.items():
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: {arg} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
        if t.device != device:
            raise ValueError(f"{name}: {arg} is on {t.device}, "
                             f"expected {device}")
        if arg != "scal" and t.numel() != n:
            raise ValueError(f"{name}: {arg} has {t.numel()} elements, "
                             f"expected {n}")
    scal = tensors.get("scal")
    if scal is not None and scal.numel() < SCALAR_COLS:
        raise ValueError(f"{name}: scalars row needs {SCALAR_COLS} values")


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


# ------------------------------------------------------------------ scalars

def make_scalars(rows: Sequence[Tuple[float, float, float, float, float]],
                 combined_scale, device) -> torch.Tensor:
    """``[len(rows), 8]`` fp32 on ``device`` from host rows of
    ``(beta1, beta2, step_size, weight_decay, lr)``.  ``combined_scale``
    (a float or a 0-d tensor on ``device``) fills the 1/scale column on
    the device, so a scale computed there is never read by the host."""
    host = torch.zeros((len(rows), SCALAR_COLS), dtype=torch.float32)
    for i, (b1, b2, step_size, wd, lr) in enumerate(rows):
        host[i, B1], host[i, B2] = b1, b2
        host[i, STEP_SIZE], host[i, WEIGHT_DECAY], host[i, LR] = (
            step_size, wd, lr)
    scale_on_host = not isinstance(combined_scale, torch.Tensor)
    if scale_on_host:
        host[:, INV_SCALE] = 1.0 / float(combined_scale)
    device = torch.device(device)
    if device.type == "cuda":
        scal = host.pin_memory().to(device, non_blocking=True)
    else:
        scal = host.to(device)
    if not scale_on_host:
        scal[:, INV_SCALE] = torch.reciprocal(
            combined_scale.to(device=device, dtype=torch.float32))
    return scal


# --------------------------------------------------------- plain versions

def lamb_phase1_plain(p, g, m, v, scal, *, eps, eps_inside_sqrt=False):
    """Moments (in place), update vector ``u = m/denom + wd*p`` and the sums
    ``[[sum p^2, sum u^2]]``: what ``lamb_phase1_kernel`` computes."""
    b1, b2, inv, wd = scal[B1], scal[B2], scal[INV_SCALE], scal[WEIGHT_DECAY]
    gs = g * inv
    m.mul_(b1).add_((1.0 - b1) * gs)
    v.mul_(b2).add_((1.0 - b2) * gs * gs)
    denom = torch.sqrt(v + eps) if eps_inside_sqrt else torch.sqrt(v) + eps
    u = m / denom + wd * p
    return u, torch.stack([torch.sum(p * p), torch.sum(u * u)]).view(1, 2)


def lamb_phase2_plain(p, u, partials, scal, *, min_coeff, max_coeff):
    """Trust ratio from the summed partials, then ``p -= step_size*coeff*u``
    in place: what ``lamb_phase2_kernel`` computes."""
    sums = partials.view(-1, 2).sum(dim=0)
    w_norm, u_norm = torch.sqrt(sums[0]), torch.sqrt(sums[1])
    coeff = torch.where((w_norm > 0) & (u_norm > 0),
                        torch.clamp(w_norm / u_norm, min_coeff, max_coeff),
                        torch.ones_like(w_norm))
    p.sub_((scal[STEP_SIZE] * coeff) * u)


def adam_plain(p, g, m, v, scal, *, eps, eps_inside_sqrt=False,
               decoupled=False):
    """One Adam/AdamW step in place: what ``adam_kernel`` computes."""
    b1, b2, inv = scal[B1], scal[B2], scal[INV_SCALE]
    step_size, wd, lr = scal[STEP_SIZE], scal[WEIGHT_DECAY], scal[LR]
    gs = g * inv
    m.mul_(b1).add_((1.0 - b1) * gs)
    v.mul_(b2).add_((1.0 - b2) * gs * gs)
    denom = torch.sqrt(v + eps) if eps_inside_sqrt else torch.sqrt(v) + eps
    upd = m / denom
    if decoupled:
        p.sub_(step_size * upd + (lr * wd) * p)
    else:
        p.sub_(step_size * (upd + wd * p))


# ----------------------------------------------------------------- wrappers

def lamb_phase1(p, g, m, v, scal, *, eps, eps_inside_sqrt=False):
    """Returns ``(u, partials)``; m and v are updated in place."""
    if not _build.on_cuda("lamb_phase1", p):
        return lamb_phase1_plain(p, g, m, v, scal, eps=eps,
                                 eps_inside_sqrt=eps_inside_sqrt)
    n = p.numel()
    _check("lamb_phase1", n, p.device, p=p, g=g, m=m, v=v, scal=scal)
    lib = build()
    nblocks = _grid(n)
    u = torch.empty_like(p)
    partials = torch.empty((nblocks, 2), dtype=torch.float32,
                           device=p.device)
    rc = lib.dstt_lamb_phase1(
        p.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr(), u.data_ptr(),
        partials.data_ptr(), nblocks, scal.data_ptr(), n, float(eps),
        int(bool(eps_inside_sqrt)), _stream(p.device))
    _build.raise_on("lamb_phase1", lib, rc)
    LAUNCHES["lamb_phase1"] += 1
    return u, partials


def lamb_phase2(p, u, partials, scal, *, min_coeff, max_coeff):
    """``p -= step_size * trust_ratio * u`` in place."""
    if not _build.on_cuda("lamb_phase2", p):
        lamb_phase2_plain(p, u, partials, scal, min_coeff=min_coeff,
                          max_coeff=max_coeff)
        return
    n = p.numel()
    _check("lamb_phase2", n, p.device, p=p, u=u, scal=scal)
    nblocks = _grid(n)
    if (partials.dtype != torch.float32 or not partials.is_contiguous()
            or partials.shape != (nblocks, 2)
            or partials.device != p.device):
        raise ValueError(f"lamb_phase2: partials must be fp32 [{nblocks}, 2] "
                         f"on {p.device} (lamb_phase1's output)")
    lib = build()
    rc = lib.dstt_lamb_phase2(
        p.data_ptr(), u.data_ptr(), partials.data_ptr(), nblocks,
        scal.data_ptr(), n, float(min_coeff), float(max_coeff),
        _stream(p.device))
    _build.raise_on("lamb_phase2", lib, rc)
    LAUNCHES["lamb_phase2"] += 1


def fused_lamb_update(p, g, m, v, scal, *, eps, min_coeff, max_coeff,
                      eps_inside_sqrt=False) -> None:
    """One LAMB step on one tensor (two phases), p/m/v in place: the port
    of ``deepspeed_tpu.ops.pallas_optim.fused_lamb_update``."""
    u, partials = lamb_phase1(p, g, m, v, scal, eps=eps,
                              eps_inside_sqrt=eps_inside_sqrt)
    lamb_phase2(p, u, partials, scal, min_coeff=min_coeff,
                max_coeff=max_coeff)


def fused_adam_update(p, g, m, v, scal, *, eps, eps_inside_sqrt=False,
                      decoupled=False) -> None:
    """One Adam/AdamW step on one tensor, p/m/v in place: the port of
    ``deepspeed_tpu.ops.pallas_optim.fused_adam_update``."""
    if not _build.on_cuda("adam", p):
        adam_plain(p, g, m, v, scal, eps=eps,
                   eps_inside_sqrt=eps_inside_sqrt, decoupled=decoupled)
        return
    n = p.numel()
    _check("adam", n, p.device, p=p, g=g, m=m, v=v, scal=scal)
    lib = build()
    nblocks = max(1, min(-(-n // (_THREADS * 4)), 4 * _MAX_BLOCKS))
    rc = lib.dstt_adam(
        p.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr(), nblocks,
        scal.data_ptr(), n, float(eps), int(bool(eps_inside_sqrt)),
        int(bool(decoupled)), _stream(p.device))
    _build.raise_on("adam", lib, rc)
    LAUNCHES["adam"] += 1
