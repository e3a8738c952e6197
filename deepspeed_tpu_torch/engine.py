"""DeepSpeedTorchEngine: the training runtime of the port.

The one-card subset of ``deepspeed_tpu/engine.py`` (``DeepSpeedTpuEngine``),
with the same outward API, ``loss = engine(*batch); engine.backward(loss);
engine.step()`` or the fused ``engine.train_batch(batch)``, and the same
arithmetic:

* fp32 masters, and a compute-dtype (bf16/fp16) copy of every parameter in
  the module, refreshed from the masters after each update
  (``engine.py:2243``); in fp32 the module's parameters ARE the masters;
* the loss multiplied by ``loss_scale / gradient_accumulation_steps`` before
  backward (``engine.py:1421-1470``);
* compute-dtype grads cast to fp32 and summed over the accumulation steps;
* at the boundary: the global grad norm, the overflow flag, the combined
  unscale-and-clip divisor, the optimizer update, the fp16 skip-on-overflow
  with ``skipped_steps``, the loss-scale FSM and the LR scheduler step.

Optimizer updates run in place on the masters and moments (the CUDA kernels
of ``ops/cuda_optim.py`` on the card).  Under fp16 the host reads the
overflow flag once per boundary, before the in-place update it may skip;
bf16 and fp32 boundaries never wait for the device.

What the JAX engine has and this slice does not yet (ZeRO, data loading,
checkpoints, ``train_many``, telemetry, resilience, graph lint) raises
``NotImplementedError`` naming its ROADMAP.md item.
"""

from __future__ import annotations

import json
import logging
import math
import re
from typing import Optional

import torch
from torch import nn

from deepspeed_tpu_torch import constants as C
from deepspeed_tpu_torch import lr_schedules as schedules_mod
from deepspeed_tpu_torch import precision as prec
from deepspeed_tpu_torch import weights as weights_mod
from deepspeed_tpu_torch.config import DeepSpeedConfig, DeepSpeedConfigError
from deepspeed_tpu_torch.ops import optim as optim_mod
from deepspeed_tpu_torch.parallel.topology import make_topology
from deepspeed_tpu_torch.utils.timer import (SynchronizedWallClockTimer,
                                             ThroughputTimer)

logger = logging.getLogger(__name__)

FORWARD_TIMER = "forward"
BACKWARD_TIMER = "backward"
STEP_TIMER = "step"


def _unported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to deepspeed_tpu_torch yet (ROADMAP.md, "
        f"{item})")


def _keystr(name: str) -> str:
    """A dotted parameter name as the JAX pytree path string that
    ``param_groups`` regexes are matched against (``"blocks.qkv_w"`` ->
    ``"['blocks']['qkv_w']"``)."""
    return "".join(f"[{part!r}]" for part in name.split("."))


class OptimizerFacade:
    """The ``optimizer`` returned by ``initialize()``: ``param_groups`` for
    the LR schedulers and the loss-scale observables of upstream
    DeepSpeed's wrapper optimizers (as in the JAX package)."""

    def __init__(self, engine: "DeepSpeedTorchEngine"):
        self._engine = engine
        base = engine.base_optimizer
        self.param_groups = []
        for d in engine._group_defs:
            g = {
                "lr": d.get("lr", base.lr),
                "betas": tuple(d.get("betas", (base.beta1, base.beta2))),
                "weight_decay": d.get("weight_decay", base.weight_decay),
                "name": base.name,
            }
            if "params" in d:
                g["params"] = d["params"]
            self.param_groups.append(g)

    @property
    def dynamic_loss_scale(self):
        return bool(self._engine._dynamic_loss_scale)

    @property
    def cur_scale(self):
        return float(self._engine.loss_scale_state.cur_scale)

    @property
    def loss_scale(self):
        return self.cur_scale

    @property
    def cur_iter(self):
        return int(self._engine.loss_scale_state.cur_iter)

    @property
    def scale_window(self):
        return int(self._engine.loss_scale_state.scale_window)

    @property
    def min_loss_scale(self):
        return float(self._engine.loss_scale_state.min_scale)

    @property
    def overflow(self):
        return bool(self._engine.overflow)

    def state_dict(self):
        raise _unported("optimizer state_dict", "Queue 1 item 8")

    def load_state_dict(self, sd):
        raise _unported("optimizer load_state_dict", "Queue 1 item 8")


class DeepSpeedTorchEngine:
    """See the module docstring.  The engine takes ownership of ``model``:
    it moves it to the device, casts its parameters to the compute dtype
    and may replace its ``config`` (activation checkpointing)."""

    def __init__(self,
                 args=None,
                 model: Optional[nn.Module] = None,
                 optimizer=None,
                 model_parameters=None,
                 training_data=None,
                 lr_scheduler=None,
                 dist_init_required: Optional[bool] = None,
                 collate_fn=None,
                 config=None,
                 config_params=None,
                 param_groups=None,
                 seed: int = 0,
                 device=None):
        if model is None:
            raise ValueError("deepspeed_tpu_torch.initialize: model is "
                             "required")
        if not isinstance(model, nn.Module):
            raise TypeError("model must be a torch.nn.Module returning the "
                            "loss from forward(*batch)")
        if dist_init_required or getattr(args, "deepspeed_mpi", False):
            raise _unported("multi-process training", "Queue 1 item 5")
        if training_data is not None:
            raise _unported("the data loader (training_data)",
                            "Queue 1 item 7")
        self.module = model
        self.client_optimizer = optimizer
        self.client_lr_scheduler = lr_scheduler
        self.collate_fn = collate_fn
        self.training = True
        self.seed = seed

        cfg_src = config if config is not None else config_params
        if cfg_src is None and args is not None:
            ds_cfg = getattr(args, "deepspeed_config", None)
            if ds_cfg is None:
                ds_cfg = getattr(args, "deepscale_config", None)
                if ds_cfg is not None:
                    logger.warning(
                        "DeepSpeedConfig: 'deepscale_config' is deprecated,"
                        " use 'deepspeed_config'")
            cfg_src = ds_cfg
        if cfg_src is None:
            raise DeepSpeedConfigError(
                "DeepSpeed requires --deepspeed_config to specify "
                "configuration file or a config dict")
        if isinstance(cfg_src, str):
            try:
                with open(cfg_src, "r") as f:
                    cfg_src = json.load(f)
            except (OSError, ValueError) as e:
                raise DeepSpeedConfigError(
                    f"Could not read DeepSpeed config file {cfg_src!r}: {e}")

        self.topology = make_topology(cfg_src, device)
        self.device = self.topology.device
        self.dp_world_size = self.topology.dp
        self.mp_world_size = self.topology.mp
        self.config = DeepSpeedConfig(cfg_src,
                                      dp_world_size=self.dp_world_size)
        validate_fn = getattr(model, "validate", None)
        if validate_fn is not None:
            validate_fn(self.mp_world_size)
        self._apply_model_overrides()

        self.policy = prec.policy_from_config(self.config.fp16_enabled,
                                              self.config.bf16_enabled)
        self._dynamic_loss_scale = (self.config.fp16_enabled
                                    and self.config.dynamic_loss_scale)
        self._configure_optimizer()
        if self.config.zero_enabled:
            # the JAX engine's guard first, so LAMB + ZeRO fails the same way
            if self.base_optimizer.name not in ("adam", "adamw"):
                raise DeepSpeedConfigError(
                    f"zero_optimization stage {self.config.zero_stage} is "
                    f"only supported for Adam-family optimizers, got "
                    f"{self.base_optimizer.name!r} (reference guard: "
                    f"deepspeed_light.py:450-457)")
            raise _unported("zero_optimization", "Queue 1 item 6")
        self._refuse_unported()

        # loss scale (INLINE variant: the MEGATRON one serves ZeRO)
        self._ls_variant = prec.INLINE
        if self.config.fp16_enabled and self.config.dynamic_loss_scale:
            self.loss_scale_state = prec.from_dynamic_args(
                self.config.dynamic_loss_scale_args, variant=self._ls_variant,
                device=self.device)
        elif self.config.fp16_enabled:
            self.loss_scale_state = prec.static_loss_scale_state(
                float(self.config.loss_scale) or 1.0, device=self.device)
        else:
            self.loss_scale_state = prec.static_loss_scale_state(
                1.0, device=self.device)
        if (self.config.fp16_enabled and not self.config.dynamic_loss_scale
                and self.base_optimizer.name == "lamb"):
            raise DeepSpeedConfigError(
                "LAMB optimizer requires dynamic loss scaling under fp16")

        if model_parameters is not None:
            weights_mod.params_from_numpy(model, model_parameters)
        if param_groups is None and self.client_optimizer is None:
            param_groups = self.config.optimizer_param_groups
        self._init_parameters()
        self._group_defs, self._group_ids = self._resolve_param_groups(
            param_groups)
        self.opt_state = self.base_optimizer.init(self.master)

        self.micro_steps = 0
        self.global_steps = 0
        self.skipped_steps = 0
        self.overflow = False
        self._acc = None            # fp32 grads summed over micro-steps
        self._last_loss = None

        self.timers = SynchronizedWallClockTimer()
        self.tput_timer = ThroughputTimer(
            batch_size=self.train_micro_batch_size_per_gpu(),
            num_workers=self.dp_world_size,
            steps_per_output=self.steps_per_print())
        self.training_dataloader = None
        self.optimizer = OptimizerFacade(self)
        self._configure_lr_scheduler()

    # ------------------------------------------------------------------ setup

    def _apply_model_overrides(self):
        """Config beats the model's own remat / sequence-parallel fields,
        as in the JAX engine."""
        cfg = self.config
        mcfg = getattr(self.module, "config", None)
        changes = {}
        if cfg.activation_checkpointing is not None:
            changes["remat"] = bool(cfg.activation_checkpointing)
            if cfg.activation_checkpointing_policy is not None:
                changes["remat_policy"] = cfg.activation_checkpointing_policy
        if cfg.sequence_parallel_impl is not None:
            changes["sp_impl"] = cfg.sequence_parallel_impl
        if changes and not (mcfg is not None
                            and hasattr(self.module, "with_config")):
            logger.warning("config overrides %s ignored: the model exposes "
                           "no with_config()", sorted(changes))
        elif changes:
            self.module.with_config(**changes)
        if cfg.pipeline_schedule is not None:
            raise _unported("pipeline_schedule", "Queue 1 item 11")
        from deepspeed_tpu_torch.models.transformer import check_remat
        if mcfg is not None and hasattr(mcfg, "remat_policy"):
            check_remat(self.module.config)

    def _refuse_unported(self):
        cfg = self.config
        refused = [
            (cfg.train_steps_per_dispatch != 1,
             "train_steps_per_dispatch > 1 (train_many)", "Queue 1 item 12"),
            (cfg.sparse_gradients_enabled, "sparse_gradients",
             "Queue 1 item 11"),
            (cfg.graph_lint_mode != "off" or cfg.analysis_mode != "off"
             or cfg.analysis_concurrency_mode != "off",
             "graph lint / analysis", "Queue 1 item 14"),
            (cfg.observability_report_window > 0
             or cfg.observability_trace_num_steps > 0,
             "observability", "Queue 1 item 12"),
            (cfg.resilience_watchdog_timeout_s > 0
             or cfg.resilience_nan_sentinel, "resilience", "Queue 1 item 12"),
            (cfg.tensorboard_enabled, "tensorboard", "Queue 1 item 12"),
            (cfg.profile_enabled, "profile", "Queue 1 item 12"),
            (cfg.compile_cache_dir is not None, "compile_cache",
             "Queue 1 item 12"),
            (cfg.dump_state, "dump_state", "Queue 1 item 12"),
        ]
        for hit, what, item in refused:
            if hit:
                raise _unported(what, item)

    def _configure_optimizer(self):
        """Client optimizer beats JSON (upstream _configure_optimizer)."""
        if self.client_optimizer is not None:
            if not isinstance(self.client_optimizer, optim_mod.Optimizer):
                raise TypeError(
                    "optimizer must be a deepspeed_tpu_torch.ops.Optimizer "
                    "(pass hyperparameters via config for JSON-defined "
                    "optimizers)")
            self.base_optimizer = self.client_optimizer
        elif self.config.optimizer_name is not None:
            self.base_optimizer = optim_mod.from_config(
                self.config.optimizer_name, self.config.optimizer_params)
        else:
            raise DeepSpeedConfigError(
                "No optimizer: pass one to initialize() or define "
                "'optimizer' in the config json")
        self.clip_grad = float(self.config.gradient_clipping or 0.0)
        op = self.config.optimizer_params or {}
        if self.clip_grad == 0.0 and op.get(C.MAX_GRAD_NORM, 0) > 0:
            self.clip_grad = float(op[C.MAX_GRAD_NORM])

    @torch.no_grad()
    def _init_parameters(self):
        """fp32 masters on the device, and the module's parameters in the
        compute dtype (aliasing the masters in fp32)."""
        self.module.to(self.device)
        cdt = self.policy.compute_dtype
        self.master = {}
        for name, p in self.module.named_parameters():
            self.master[name] = p.detach().to(
                dtype=prec.MASTER_DTYPE, copy=True).contiguous()
            p.data = (self.master[name] if cdt == prec.MASTER_DTYPE
                      else self.master[name].to(cdt))
        self._params = dict(self.module.named_parameters())

    def _resolve_param_groups(self, defs):
        """Leaves join the FIRST group whose ``params`` regex matches their
        JAX pytree path (``"['blocks']['qkv_w']"``); unmatched leaves form
        group 0 with the base optimizer's hyperparameters."""
        if not defs:
            return [{}], {k: 0 for k in self.master}
        for d in defs:
            if "params" not in d:
                raise DeepSpeedConfigError(
                    "each param_groups entry needs a 'params' path regex")
            extra = set(d) - {"params", "lr", "betas", "weight_decay"}
            if extra:
                raise DeepSpeedConfigError(
                    f"param_groups entry has unsupported keys {sorted(extra)}:"
                    f" supported per-group hyperparameters are 'lr', 'betas' "
                    f"and 'weight_decay' (reference torch groups, "
                    f"deepspeed_fused_lamb.py:77-100)")
            if "betas" in d and not self.base_optimizer.uses_betas:
                raise DeepSpeedConfigError(
                    f"per-group 'betas' given but optimizer "
                    f"'{self.base_optimizer.name}' does not consume betas")
        pats = [re.compile(d["params"]) for d in defs]
        paths = {k: _keystr(k) for k in self.master}
        for d, pat in zip(defs, pats):
            if not any(pat.search(s) for s in paths.values()):
                raise DeepSpeedConfigError(
                    f"param_groups pattern {d['params']!r} matches no "
                    f"parameter leaf (patterns are searched against pytree "
                    f"paths like {next(iter(paths.values()))!r})")

        def gid(path):
            for i, pat in enumerate(pats):
                if pat.search(path):
                    return i + 1
            return 0

        return ([{}] + [dict(d) for d in defs],
                {k: gid(s) for k, s in paths.items()})

    def _configure_lr_scheduler(self):
        if self.config.scheduler_name is not None:
            cls = schedules_mod.SCHEDULES.get(self.config.scheduler_name)
            if cls is None:
                raise DeepSpeedConfigError(
                    f"Unknown scheduler {self.config.scheduler_name!r}")
            self.lr_scheduler = cls(self.optimizer,
                                    **(self.config.scheduler_params or {}))
            if self.client_lr_scheduler is not None:
                logger.warning(
                    "JSON scheduler overrides the client lr_scheduler "
                    "(reference deepspeed_light.py:317-327)")
        else:
            self.lr_scheduler = self.client_lr_scheduler

    # -------------------------------------------------------- config getters

    def train_batch_size(self):
        return self.config.train_batch_size

    def train_micro_batch_size_per_gpu(self):
        return self.config.train_micro_batch_size_per_gpu

    def gradient_accumulation_steps(self):
        return self.config.gradient_accumulation_steps

    def steps_per_print(self):
        return self.config.steps_per_print

    def zero_optimization(self):
        return self.config.zero_enabled

    def fp16_enabled(self):
        return self.config.fp16_enabled

    def bfloat16_enabled(self):
        return self.config.bf16_enabled

    def gradient_clipping(self):
        return self.clip_grad

    def dynamic_loss_scale(self):
        return self._dynamic_loss_scale

    def wall_clock_breakdown(self):
        return self.config.wall_clock_breakdown

    # ----------------------------------------------------------------- modes

    def train(self):
        self.training = True
        self.module.train(True)
        return self

    def eval(self):
        self.training = False
        self.module.train(False)
        return self

    def is_gradient_accumulation_boundary(self):
        return (self.micro_steps + 1) % self.gradient_accumulation_steps() == 0

    # --------------------------------------------------------------- forward

    def _to_device(self, x):
        if isinstance(x, torch.Tensor):
            return x.to(self.device, non_blocking=True)
        return torch.as_tensor(x).to(self.device, non_blocking=True)

    def forward(self, *inputs):
        """The model's loss on one micro-batch (a tensor that still holds
        its graph in train mode; ``backward`` consumes it)."""
        wcb = self.wall_clock_breakdown()
        if wcb:
            self.timers(FORWARD_TIMER).start()
        batch = tuple(self._to_device(x) for x in inputs)
        if self.training:
            loss = self.module(*batch)
        else:
            self.tput_timer.discard_window()
            with torch.no_grad():
                loss = self.module(*batch)
        self._last_loss = loss
        if wcb:
            self.timers(FORWARD_TIMER).stop(sync_on=loss)
        return loss

    __call__ = forward

    # --------------------------------------------------------------- backward

    def backward(self, loss=None, allreduce_gradients=True):
        """Backward of ``loss`` (default: the last forward's) scaled by
        ``loss_scale / gas``, then the fp32 sum of the grads across
        micro-steps.  Returns ``loss / gas`` when ``loss`` is given."""
        assert self.training, "backward() requires train mode"
        if not allreduce_gradients:
            raise NotImplementedError(
                "allreduce_gradients=False is not supported: the boundary "
                "step owns the gradient reduction")
        out = loss if loss is not None else self._last_loss
        assert out is not None, "backward() must follow a forward()"
        wcb = self.wall_clock_breakdown()
        if wcb:
            self.timers(BACKWARD_TIMER).start()
        gas = float(self.gradient_accumulation_steps())
        if isinstance(out, (tuple, list)):
            total = sum(l.float() for l in out)
        else:
            total = out.float()
        (total * (self.loss_scale_state.cur_scale / gas)).backward()
        self._last_loss = None
        with torch.no_grad():
            if self._acc is None:
                self._acc = {}
            for name, p in self._params.items():
                g = p.grad
                if g is None:
                    continue
                if name in self._acc:
                    self._acc[name].add_(g.float())
                else:
                    # a fp32 grad becomes the accumulator itself
                    self._acc[name] = g.float()
                p.grad = None
        if wcb:
            self.timers(BACKWARD_TIMER).stop(sync_on=list(self._acc.values()))
        if loss is None:
            return None
        if isinstance(loss, (tuple, list)):
            return type(loss)(l.detach() / gas for l in loss)
        return loss.detach() / gas

    # ------------------------------------------------------------------- step

    def _reduce(self, g):
        """The data-parallel reduction envelope of
        ``deepspeed_tpu.parallel.comm.scaled_reduce`` at world size 1: the
        sum is the identity, the pre/post scaling is kept."""
        cfg, world = self.config, float(self.dp_world_size)
        if cfg.prescale_gradients:
            f = cfg.gradient_predivide_factor
            if f != 1.0:
                g = g / f
            if f != world:
                g = g / (world / f)
            return g
        return g / world if world != 1.0 else g

    def _hypers(self):
        """(lr, beta1, beta2, weight_decay), each a float or a per-leaf
        dict when param groups exist, from the facade's live groups."""
        base = self.base_optimizer
        rows = []
        for g in self.optimizer.param_groups:
            b = g.get("betas", (base.beta1, base.beta2))
            rows.append((float(g["lr"]), float(b[0]), float(b[1]),
                         float(g.get("weight_decay", base.weight_decay))))
        if len(rows) == 1:
            return rows[0]
        return tuple({k: rows[gid][j] for k, gid in self._group_ids.items()}
                     for j in range(4))

    @torch.no_grad()
    def _boundary_update(self):
        """Norm, overflow, update, loss-scale FSM; returns the overflow as
        a host bool under fp16 (where it decides the skip) else False."""
        fp16 = self.config.fp16_enabled
        grads = {k: self._reduce(g) for k, g in self._acc.items()}
        self._acc = None
        norms = torch.stack([torch.linalg.vector_norm(g, dtype=torch.float32)
                             for g in grads.values()])
        sq = torch.sum(norms * norms)
        # a non-finite grad makes the squared norm non-finite
        overflow = ~torch.isfinite(sq)
        total_norm = torch.sqrt(sq)
        clip = self.clip_grad
        if fp16:
            combined = prec.combined_unscale_and_clip_factor(
                total_norm, self.loss_scale_state, clip)
        elif clip > 0:
            combined = prec.combined_unscale_and_clip_factor(
                total_norm, prec.static_loss_scale_state(1.0, self.device),
                clip)
        else:
            combined = 1.0
        skip = bool(overflow) if fp16 else False
        if not skip:
            lr, b1, b2, wd = self._hypers()
            self.base_optimizer.update(
                self.master, grads, self.opt_state, lr=lr, beta1=b1,
                beta2=b2, weight_decay=wd, combined_scale=combined)
            if self.policy.compute_dtype != prec.MASTER_DTYPE:
                for name, p in self._params.items():
                    p.copy_(self.master[name])
        if fp16:
            self.loss_scale_state = prec.update_loss_scale(
                self.loss_scale_state, overflow, variant=self._ls_variant)
        return skip

    def _post_boundary_bookkeeping(self, overflow: bool):
        self.global_steps += 1
        self.overflow = overflow
        if overflow:
            self.skipped_steps += 1
        elif self.lr_scheduler is not None:
            self.lr_scheduler.step()
        if self.global_steps % self.steps_per_print() == 0:
            self._report_progress(self.global_steps)

    def step(self):
        """Optimizer boundary step (upstream deepspeed_light.py:709-807)."""
        assert self.training, "step() requires train mode"
        wcb = self.wall_clock_breakdown()
        if wcb:
            self.timers(STEP_TIMER).start()
        if self.is_gradient_accumulation_boundary():
            assert self._acc is not None, "step() with no accumulated grads"
            self._post_boundary_bookkeeping(self._boundary_update())
            self.tput_timer.stop(sync_on=self.master)
        self.micro_steps += 1
        if wcb:
            self.timers(STEP_TIMER).stop(sync_on=self.master)
            self.timers.log([FORWARD_TIMER, BACKWARD_TIMER, STEP_TIMER],
                            memory_breakdown=self.config.memory_breakdown)

    # --------------------------------------------------------- fused hot path

    def train_batch(self, batch):
        """Forward+backward over gas micro-batches, then the boundary step.
        ``batch`` leaves carry a leading [gas * micro] axis; micro-step i
        takes rows [i*micro, (i+1)*micro), as the JAX engine's scan does.
        Returns the last micro-step's loss (fp32, detached)."""
        assert self.training, "train_batch() requires train mode"
        batch = tuple(batch) if isinstance(batch, (tuple, list)) else (batch,)
        gas = self.gradient_accumulation_steps()
        leads = {x.shape[0] for x in batch}
        if len(leads) != 1:
            raise ValueError(
                f"train_batch: batch leaves disagree on the leading dim "
                f"({sorted(leads)}); every leaf must carry the same "
                f"[gas * micro * dp] axis")
        lead = leads.pop()
        if lead % gas != 0:
            raise ValueError(
                f"train_batch: leading batch dim {lead} is not divisible by "
                f"gradient_accumulation_steps={gas}")
        mb = lead // gas
        batch = tuple(self._to_device(x) for x in batch)
        self.tput_timer.start()
        loss = None
        for i in range(gas):
            loss = self.forward(*(x[i * mb:(i + 1) * mb] for x in batch))
            self.backward(loss)
        self._post_boundary_bookkeeping(self._boundary_update())
        self.micro_steps += gas
        self.tput_timer.stop(sync_on=loss)
        if isinstance(loss, (tuple, list)):
            return type(loss)(l.detach().float() for l in loss)
        return loss.detach().float()

    # ------------------------------------------------ not in this slice yet

    def train_many(self, batches):
        raise _unported("train_many", "Queue 1 item 12")

    def save_checkpoint(self, save_dir, tag=None, client_state=None,
                        async_save=None):
        raise _unported("save_checkpoint", "Queue 1 item 8")

    def load_checkpoint(self, load_dir, tag=None, load_optimizer_states=True,
                        load_lr_scheduler_states=True):
        raise _unported("load_checkpoint", "Queue 1 item 8")

    # ------------------------------------------------------------- reporting

    def _report_progress(self, step):
        lr = (self.lr_scheduler.get_last_lr()
              if self.lr_scheduler is not None
              and hasattr(self.lr_scheduler, "get_last_lr")
              else [self.optimizer.param_groups[0]["lr"]])
        mom = self.optimizer.param_groups[0].get("betas", None)
        logger.info("step=%d, skipped=%d, lr=%s, mom=%s",
                    step, self.skipped_steps, lr, mom)

    def num_parameters(self) -> int:
        return sum(math.prod(p.shape) for p in self.master.values())
