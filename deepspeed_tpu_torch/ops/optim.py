"""Optimizers over fp32 masters: Adam, AdamW, LAMB, SGD, Lion, RMSprop and
Adagrad, and ``register_optimizer`` for a third party's.

The port of ``deepspeed_tpu/ops/optim.py``, with the same numerics (upstream
DeepSpeed's fused-LAMB kernel and apex FusedAdam):

* moments without bias correction: ``m = b1*m + (1-b1)*g/scale``,
  ``v = b2*v + (1-b2)*(g/scale)^2``;
* the bias-corrected step size computed on the host,
  ``lr * sqrt(1-b2^t) / (1-b1^t)`` (fused_lamb_cuda_kernel.cu:396-404), in
  fp32 as the JAX package computes it;
* ``denom = sqrt(v) + eps``, or ``sqrt(v + eps)`` with ``eps_inside_sqrt``;
* L2 decay inside the update (Adam, LAMB) or decoupled ``lr*wd*p`` (AdamW);
* the LAMB trust ratio per tensor, ``clamp(|w|/|u|, min_coeff, max_coeff)``,
  and 1.0 when either norm is zero.

Parameters, grads and moments are ``{name: tensor}`` dicts with one entry
per JAX pytree leaf, so LAMB's per-tensor trust ratio spans the same
elements in both packages (the stacked ``[L, ...]`` block leaves).  Updates
run IN PLACE on the parameter and moment tensors.  Adam, AdamW and LAMB go
through ``ops.cuda_optim``, which launches the CUDA kernels on CUDA tensors
and runs the plain versions on CPU tensors.  SGD, Lion, RMSprop and Adagrad
have no kernel in the JAX package either: they are plain tensor ops on
every device.  ``use_pallas`` is accepted so that the same JSON parses; it
selects nothing here.

The state of every optimizer is the JAX ``OptimizerState``'s: ``m`` None
for RMSprop, Adagrad and SGD without momentum, ``v`` None for SGD and
Lion, so the optimizer ``state_dict`` and the checkpoint files carry the
same Nones in both packages.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from deepspeed_tpu_torch.ops import cuda_optim


@dataclasses.dataclass
class OptimizerState:
    step: int                                # shared across leaves
    m: Optional[Dict[str, torch.Tensor]]     # exp_avg
    v: Optional[Dict[str, torch.Tensor]]     # exp_avg_sq; None for SGD


def _zeros_like(params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for k, p in params.items()}


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """Hyperparameters are fields; ``lr``, the betas and weight decay may
    be overridden per step and per leaf (the LR scheduler's param groups)."""
    lr: float = 1e-3
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    bias_correction: bool = True
    eps_inside_sqrt: bool = False
    use_pallas: Optional[bool] = None
    name: str = "base"

    # whether update() reads beta1/beta2 (engine param-group validation)
    uses_betas = True

    def init(self, params) -> OptimizerState:
        return OptimizerState(step=0, m=_zeros_like(params),
                              v=_zeros_like(params))

    def _step_size(self, lr, step, beta1, beta2) -> float:
        """fp32 host-side step size (fused_lamb_cuda_kernel.cu:396-404)."""
        f32 = np.float32
        if self.bias_correction:
            bc1 = f32(1.0) - f32(beta1) ** f32(step)
            bc2 = f32(1.0) - f32(beta2) ** f32(step)
            return float(f32(lr) * np.sqrt(bc2) / bc1)
        return float(f32(lr))

    @staticmethod
    def _leaf_hyper(h, name):
        """A hyper is a scalar shared by every leaf or a {name: value}
        dict (the engine's param groups); None means the default."""
        return h.get(name) if isinstance(h, dict) else h

    def _resolve(self, name, lr, beta1, beta2, weight_decay):
        vals = [self._leaf_hyper(h, name)
                for h in (lr, beta1, beta2, weight_decay)]
        defaults = (self.lr, self.beta1, self.beta2, self.weight_decay)
        return tuple(float(d if x is None else x)
                     for x, d in zip(vals, defaults))

    def update(self, params, grads, state: OptimizerState, *, lr=None,
               beta1=None, beta2=None, weight_decay=None,
               combined_scale=1.0):
        """Step every leaf whose grad is not None, in place; returns
        ``(params, state)``.  ``combined_scale`` is a float or a 0-d
        tensor on the leaves' device (the unscale-and-clip divisor)."""
        raise NotImplementedError

    def _scalars(self, names, params, step, hypers, combined_scale):
        rows = []
        for k in names:
            lr_l, b1, b2, wd = self._resolve(k, *hypers)
            rows.append((b1, b2, self._step_size(lr_l, step, b1, b2), wd,
                         lr_l))
        device = params[names[0]].device
        return cuda_optim.make_scalars(rows, combined_scale, device)

    def _fused(self, params, grads, state, hypers, combined_scale, leaf_fn):
        step = state.step + 1
        names = [k for k in params if grads.get(k) is not None]
        if names:
            scal = self._scalars(names, params, step, hypers, combined_scale)
            for i, k in enumerate(names):
                leaf_fn(params[k], grads[k], state.m[k], state.v[k], scal[i])
        state.step = step
        return params, state


@dataclasses.dataclass(frozen=True)
class Adam(Optimizer):
    """FusedAdam (apex semantics: L2 decay folded into the update)."""
    name: str = "adam"
    decoupled_decay: bool = False

    def update(self, params, grads, state, *, lr=None, beta1=None,
               beta2=None, weight_decay=None, combined_scale=1.0):
        def leaf(p, g, m, v, scal):
            cuda_optim.fused_adam_update(
                p, g, m, v, scal, eps=self.eps,
                eps_inside_sqrt=self.eps_inside_sqrt,
                decoupled=self.decoupled_decay)
        return self._fused(params, grads, state,
                           (lr, beta1, beta2, weight_decay), combined_scale,
                           leaf)

    def update_flat(self, p, g, state, segments, *, lr=None, beta1=None,
                    beta2=None, weight_decay=None, combined_scale=1.0):
        """One step on a flat segment of the ZeRO layout, in place: ``p``,
        ``g``, ``state.m["flat"]`` and ``state.v["flat"]`` are 1-D slices
        of one length.  ``segments`` cuts it into ``(start, stop, name)``
        pieces, each updated by one kernel launch with the hypers of leaf
        ``name`` (None: the defaults); a single piece when no param groups
        exist.  The per-element function is ``update``'s, so a leaf cut
        at a partition or bucket boundary updates as if whole (the JAX
        package expands per-element hyper vectors instead,
        ``deepspeed_tpu/ops/optim.py:176-181``).  The bias correction is
        that of step ``state.step + 1``; ``state.step`` is not advanced:
        the caller advances it once, after the last segment of the
        step."""
        m, v = state.m["flat"], state.v["flat"]
        hypers = (lr, beta1, beta2, weight_decay)
        rows = []
        for _, _, name in segments:
            lr_l, b1, b2, wd = self._resolve(name, *hypers)
            rows.append((b1, b2, self._step_size(lr_l, state.step + 1, b1,
                                                 b2), wd, lr_l))
        scal = cuda_optim.make_scalars(rows, combined_scale, p.device)
        for i, (s, e, _) in enumerate(segments):
            cuda_optim.fused_adam_update(
                p[s:e], g[s:e], m[s:e], v[s:e], scal[i], eps=self.eps,
                eps_inside_sqrt=self.eps_inside_sqrt,
                decoupled=self.decoupled_decay)


@dataclasses.dataclass(frozen=True)
class AdamW(Adam):
    name: str = "adamw"
    decoupled_decay: bool = True


@dataclasses.dataclass(frozen=True)
class Lamb(Optimizer):
    """Fused LAMB with a per-tensor trust ratio."""
    name: str = "lamb"
    max_coeff: float = 10.0
    min_coeff: float = 0.01

    def update(self, params, grads, state, *, lr=None, beta1=None,
               beta2=None, weight_decay=None, combined_scale=1.0):
        def leaf(p, g, m, v, scal):
            cuda_optim.fused_lamb_update(
                p, g, m, v, scal, eps=self.eps,
                min_coeff=self.min_coeff, max_coeff=self.max_coeff,
                eps_inside_sqrt=self.eps_inside_sqrt)
        return self._fused(params, grads, state,
                           (lr, beta1, beta2, weight_decay), combined_scale,
                           leaf)


@dataclasses.dataclass(frozen=True)
class Sgd(Optimizer):
    """torch.optim.SGD semantics (momentum is a field, not a beta)."""
    name: str = "sgd"
    momentum: float = 0.0
    uses_betas = False

    def init(self, params) -> OptimizerState:
        m = _zeros_like(params) if self.momentum > 0.0 else None
        return OptimizerState(step=0, m=m, v=None)

    def update(self, params, grads, state, *, lr=None, beta1=None,
               beta2=None, weight_decay=None, combined_scale=1.0):
        for k, p in params.items():
            g = grads.get(k)
            if g is None:
                continue
            lr_l, _, _, wd = self._resolve(k, lr, beta1, beta2, weight_decay)
            sg = g.float() / combined_scale + wd * p
            if self.momentum > 0.0:
                m = state.m[k]
                m.mul_(self.momentum).add_(sg)
                sg = m
            p.sub_(lr_l * sg)
        state.step += 1
        return params, state


@dataclasses.dataclass(frozen=True)
class Lion(Optimizer):
    """Lion, EvoLved Sign Momentum (Chen et al. 2023, arXiv:2302.06675):
    ``u = sign(b1*m + (1-b1)*g); p -= lr*(u + wd*p); m = b2*m +
    (1-b2)*g``, the gradient divided by ``combined_scale`` before both.
    Decay is decoupled, the state ``m`` only.  Paper defaults: lr 1e-4,
    betas (0.9, 0.99).  Admitted at ZeRO stage 3, where the update runs
    per leaf on the local shards."""
    name: str = "lion"
    lr: float = 1e-4
    beta1: float = 0.9
    beta2: float = 0.99

    def init(self, params) -> OptimizerState:
        return OptimizerState(step=0, m=_zeros_like(params), v=None)

    def update(self, params, grads, state, *, lr=None, beta1=None,
               beta2=None, weight_decay=None, combined_scale=1.0):
        for k, p in params.items():
            g = grads.get(k)
            if g is None:
                continue
            lr_l, b1, b2, wd = self._resolve(k, lr, beta1, beta2,
                                             weight_decay)
            m = state.m[k]
            sg = g.float() / combined_scale
            u = torch.sign(b1 * m + (1.0 - b1) * sg)
            p.sub_(lr_l * (u + wd * p))
            m.mul_(b2).add_((1.0 - b2) * sg)
        state.step += 1
        return params, state


@dataclasses.dataclass(frozen=True)
class RMSprop(Optimizer):
    """``torch.optim.RMSprop`` without its momentum and centered variants:
    ``v = alpha*v + (1-alpha)*g^2; p -= lr*g / (sqrt(v) + eps)``, L2 decay
    added to the gradient; the state ``v`` only."""
    name: str = "rmsprop"
    alpha: float = 0.99
    eps: float = 1e-8
    uses_betas = False

    def init(self, params) -> OptimizerState:
        return OptimizerState(step=0, m=None, v=_zeros_like(params))

    def _accumulate(self, v, sg):
        v.mul_(self.alpha).add_((1.0 - self.alpha) * sg * sg)

    def update(self, params, grads, state, *, lr=None, beta1=None,
               beta2=None, weight_decay=None, combined_scale=1.0):
        for k, p in params.items():
            g = grads.get(k)
            if g is None:
                continue
            lr_l, _, _, wd = self._resolve(k, lr, beta1, beta2,
                                           weight_decay)
            v = state.v[k]
            sg = g.float() / combined_scale + wd * p
            self._accumulate(v, sg)
            p.sub_(lr_l * sg / (torch.sqrt(v) + self.eps))
        state.step += 1
        return params, state


@dataclasses.dataclass(frozen=True)
class Adagrad(RMSprop):
    """``torch.optim.Adagrad``: ``v += g^2; p -= lr*g / (sqrt(v) + eps)``,
    L2 decay added to the gradient; the state ``v`` only."""
    name: str = "adagrad"
    eps: float = 1e-10

    def _accumulate(self, v, sg):
        v.add_(sg * sg)


# The reference falls through to torch.optim.<name> for an optimizer it
# does not wrap (deepspeed_light.py:479-481); here, as in the JAX package,
# a third party registers a factory instead.
_REGISTRY: dict = {}


def register_optimizer(name: str, factory) -> None:
    """Register ``factory(**params_dict) -> Optimizer`` under a config
    ``optimizer.type`` name (case-insensitive); ``from_config`` consults
    it after the built-in names."""
    _REGISTRY[name.lower()] = factory


def from_config(name: str, params_dict: Optional[dict] = None) -> Optimizer:
    """Instantiate by config name, accepting the JAX package's spellings:
    lr, betas, eps, weight_decay, bias_correction, momentum, use_pallas,
    max_coeff/min_coeff (LAMB) and alpha (RMSprop).  LAMB drops
    ``eps_inside_sqrt`` and Lion ``eps``, as the JAX package does; RMSprop
    ``momentum``/``centered`` and Adagrad ``lr_decay`` raise, as there."""
    p = dict(params_dict or {})
    kw = {}
    if "lr" in p:
        kw["lr"] = float(p.pop("lr"))
    if "betas" in p:
        b1, b2 = p.pop("betas")
        kw["beta1"], kw["beta2"] = float(b1), float(b2)
    for k in ("eps", "weight_decay"):
        if k in p:
            kw[k] = float(p.pop(k))
    if "bias_correction" in p:
        kw["bias_correction"] = bool(p.pop("bias_correction"))
    if "use_pallas" in p:
        up = p.pop("use_pallas")
        kw["use_pallas"] = None if up is None else bool(up)
    name_l = name.lower()
    if name_l == "adam":
        return Adam(**kw)
    if name_l == "adamw":
        return AdamW(**kw)
    if name_l == "lamb":
        for k in ("max_coeff", "min_coeff"):
            if k in p:
                kw[k] = float(p.pop(k))
        return Lamb(**kw)
    if name_l == "sgd":
        if "momentum" in p:
            kw["momentum"] = float(p.pop("momentum"))
        return Sgd(**kw)
    if name_l == "lion":
        kw.pop("eps", None)
        return Lion(**kw)
    if name_l == "rmsprop":
        if "alpha" in p:
            kw["alpha"] = float(p.pop("alpha"))
        if float(p.pop("momentum", 0) or 0) or p.pop("centered", False):
            raise ValueError(
                "RMSprop momentum/centered variants are not implemented — "
                "refusing to silently train with different dynamics")
        return RMSprop(**kw)
    if name_l == "adagrad":
        if float(p.pop("lr_decay", 0) or 0):
            raise ValueError("Adagrad lr_decay is not implemented")
        return Adagrad(**kw)
    if name_l in _REGISTRY:
        return _REGISTRY[name_l](**dict(params_dict or {}))
    raise ValueError(f"Unknown optimizer {name!r}")
