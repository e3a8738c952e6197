"""Mixed precision: loss-scaling state machines and overflow detection.

The port of ``deepspeed_tpu/precision.py``.  The loss-scale state is a small
NamedTuple of 0-d tensors that lives on the training device, and every
transition is ``torch.where`` arithmetic, so the fp16 boundary step needs no
host read to advance the FSM.  (The engine still reads the overflow flag once
per boundary under fp16, to skip the in-place optimizer update.)

Both FSM variants of upstream DeepSpeed are kept exactly:

* ``update_loss_scale(..., variant=INLINE)``: the FP16_Optimizer inline FSM
  (fp16_optimizer.py:245-272).  It halves on every overflow (floored at
  min_scale) and doubles when the stable interval
  ``(cur_iter - last_overflow_iter) - 1`` is a positive multiple of
  ``scale_window``.  No hysteresis.
* ``update_loss_scale(..., variant=MEGATRON)``: ``DynamicLossScaler``
  (loss_scaler.py:143-167).  ``delayed_shift`` hysteresis absorbs the first
  overflows, and it doubles when
  ``(cur_iter - last_overflow_iter) % scale_window == 0``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

# Keys of the dynamic_loss_scale_args dict (upstream loss_scaler.py:21-24)
INITIAL_LOSS_SCALE = "init_scale"
SCALE_WINDOW = "scale_window"
DELAYED_SHIFT = "delayed_shift"
MIN_LOSS_SCALE = "min_scale"

# FSM variants
INLINE = "inline"          # fp16_optimizer.py:245-272
MEGATRON = "megatron"      # loss_scaler.py:143-167 (DynamicLossScaler)

#: The master-weight dtype: bf16/fp16 training accumulates its optimizer
#: updates into fp32 masters (upstream fp16_optimizer.py:158-165).
MASTER_DTYPE = torch.float32


class LossScaleState(NamedTuple):
    """0-d tensors on the training device."""
    cur_scale: torch.Tensor          # f32
    cur_iter: torch.Tensor           # i32
    last_overflow_iter: torch.Tensor  # i32
    cur_hysteresis: torch.Tensor     # i32 (MEGATRON variant only)
    # static config carried in the state, as in the JAX package
    scale_factor: torch.Tensor       # f32
    scale_window: torch.Tensor       # i32
    min_scale: torch.Tensor          # f32
    delayed_shift: torch.Tensor      # i32
    dynamic: torch.Tensor            # bool


def make_loss_scale_state(init_scale: float = 2.0 ** 32,
                          scale_factor: float = 2.0,
                          scale_window: int = 1000,
                          min_scale: float = 1.0,
                          delayed_shift: int = 1,
                          dynamic: bool = True,
                          device=None) -> LossScaleState:
    """Initial state (upstream loss_scaler.py:96-112: cur_iter=0,
    last_overflow_iter=-1)."""
    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=device)
    i32 = lambda v: torch.tensor(v, dtype=torch.int32, device=device)
    return LossScaleState(
        cur_scale=f32(init_scale),
        cur_iter=i32(0),
        last_overflow_iter=i32(-1),
        cur_hysteresis=i32(delayed_shift),
        scale_factor=f32(scale_factor),
        scale_window=i32(scale_window),
        min_scale=f32(min_scale),
        delayed_shift=i32(delayed_shift),
        dynamic=torch.tensor(bool(dynamic), device=device),
    )


def static_loss_scale_state(scale: float, device=None) -> LossScaleState:
    return make_loss_scale_state(init_scale=scale, dynamic=False,
                                 device=device)


def from_dynamic_args(args: Optional[dict],
                      initial_dynamic_scale: float = 2.0 ** 32,
                      variant: str = INLINE, device=None) -> LossScaleState:
    """State from a config ``dynamic_loss_scale_args`` dict.  The MEGATRON
    variant honours delayed_shift; the INLINE variant ignores it (the
    upstream inline FSM has no hysteresis)."""
    if args is None:
        return make_loss_scale_state(init_scale=initial_dynamic_scale,
                                     device=device)
    return make_loss_scale_state(
        init_scale=args.get(INITIAL_LOSS_SCALE, initial_dynamic_scale),
        scale_window=args.get(SCALE_WINDOW, 1000),
        min_scale=args.get(MIN_LOSS_SCALE, 1.0),
        delayed_shift=args.get(DELAYED_SHIFT, 1) if variant == MEGATRON else 1,
        device=device,
    )


# --------------------------------------------------------------------- updates

def _inline_update(state: LossScaleState, overflow) -> LossScaleState:
    """fp16_optimizer.py:245-272."""
    halved = torch.maximum(state.cur_scale / state.scale_factor,
                           state.min_scale)
    stable_interval = (state.cur_iter - state.last_overflow_iter) - 1
    grow = (stable_interval > 0) & (
        torch.remainder(stable_interval, state.scale_window) == 0)
    new_scale = torch.where(
        overflow, halved,
        torch.where(grow, state.cur_scale * state.scale_factor,
                    state.cur_scale))
    return state._replace(
        cur_scale=torch.where(state.dynamic, new_scale, state.cur_scale),
        last_overflow_iter=torch.where(overflow, state.cur_iter,
                                       state.last_overflow_iter),
        cur_iter=state.cur_iter + 1,
    )


def _megatron_update(state: LossScaleState, overflow) -> LossScaleState:
    """loss_scaler.py:143-167 (consecutive_hysteresis=False)."""
    shift_exhausted = (state.delayed_shift == 1) | (state.cur_hysteresis == 1)
    halved = torch.maximum(state.cur_scale / state.scale_factor,
                           state.min_scale)
    scale_on_overflow = torch.where(shift_exhausted, halved, state.cur_scale)
    hyst_on_overflow = torch.where(shift_exhausted, state.cur_hysteresis,
                                   state.cur_hysteresis - 1)
    grow = torch.remainder(state.cur_iter - state.last_overflow_iter,
                           state.scale_window) == 0
    scale_on_clean = torch.where(grow, state.cur_scale * state.scale_factor,
                                 state.cur_scale)
    hyst_on_clean = torch.where(grow, state.delayed_shift,
                                state.cur_hysteresis)
    new_scale = torch.where(overflow, scale_on_overflow, scale_on_clean)
    return state._replace(
        cur_scale=torch.where(state.dynamic, new_scale, state.cur_scale),
        cur_hysteresis=torch.where(
            state.dynamic,
            torch.where(overflow, hyst_on_overflow, hyst_on_clean),
            state.cur_hysteresis),
        last_overflow_iter=torch.where(overflow, state.cur_iter,
                                       state.last_overflow_iter),
        cur_iter=state.cur_iter + 1,
    )


def update_loss_scale(state: LossScaleState, overflow,
                      variant: str = INLINE) -> LossScaleState:
    """One FSM transition.  ``overflow`` may be a python bool or a 0-d
    bool tensor."""
    overflow = torch.as_tensor(overflow, dtype=torch.bool,
                               device=state.cur_scale.device)
    if variant == INLINE:
        return _inline_update(state, overflow)
    if variant == MEGATRON:
        return _megatron_update(state, overflow)
    raise ValueError(f"unknown loss-scale variant {variant!r}")


# ---------------------------------------------------------------- overflow

def has_overflow(grads) -> torch.Tensor:
    """0-d bool tensor: True if any grad (an iterable of tensors or a dict
    of them; None entries skipped) holds an inf or nan."""
    if isinstance(grads, dict):
        grads = grads.values()
    leaves = [g for g in grads if g is not None]
    if not leaves:
        return torch.tensor(False)
    finite = torch.stack([torch.isfinite(g).all() for g in leaves])
    return ~finite.all()


def scale_loss(loss, state: LossScaleState) -> torch.Tensor:
    """loss * cur_scale in fp32 (upstream fp16_optimizer.py:242-243)."""
    return torch.as_tensor(loss).float() * state.cur_scale


def unscale(grads: dict, state: LossScaleState) -> dict:
    """Divide every grad by the current scale (fp32 math)."""
    inv = 1.0 / state.cur_scale
    return {k: (None if g is None else g.float() * inv)
            for k, g in grads.items()}


def combined_unscale_and_clip_factor(total_norm, state: LossScaleState,
                                     clip_grad: float):
    """The one divisor that unscales and clips (upstream
    fp16_optimizer.py:221-228, zero_optimizer.py:443-458): grads /=
    combined, where combined is the scale, or scale*clip_ratio when the
    unscaled norm exceeds clip_grad.  ``total_norm`` is the norm of the
    *scaled* grads."""
    combined = state.cur_scale
    if clip_grad > 0.0:
        clip = ((total_norm / state.cur_scale) + 1e-6) / clip_grad
        combined = torch.where(clip > 1.0, clip * state.cur_scale, combined)
    return combined


# ----------------------------------------------------------------- policies

class Policy(NamedTuple):
    """Params live in fp32 masters; compute and grads in ``compute_dtype``."""
    compute_dtype: torch.dtype
    needs_loss_scale: bool


def policy_from_config(fp16_enabled: bool, bf16_enabled: bool) -> Policy:
    if fp16_enabled:
        return Policy(torch.float16, True)
    if bf16_enabled:
        return Policy(torch.bfloat16, False)
    return Policy(torch.float32, False)


def f32_bmm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` (3-D) in fp32: the counterpart of the JAX
    ``preferred_element_type=jnp.float32``.  On a CUDA device low-precision
    operands stay low-precision and the product accumulates and returns in
    fp32 (``bmm`` with ``out_dtype``); elsewhere (the CPU has no such
    product) both go up to fp32 first.  Products of bf16/fp16 values are
    exact in fp32, so both routes compute the same sums."""
    if a.device.type == "cuda" and a.dtype in (torch.bfloat16,
                                               torch.float16) \
            and b.dtype == a.dtype:
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())

