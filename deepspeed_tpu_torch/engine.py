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
of ``ops/cuda_optim.py`` on the card).  Under fp16 (and under the NaN
sentinel at any precision) the host reads the overflow flag once per
boundary, before the in-place update it may skip; other bf16 and fp32
boundaries never wait for the device.

Data parallelism (``parallel/topology.py``, ``parallel/comm.py``): one
process per device in a ``torch.distributed`` group (NCCL on cards, gloo on
the CPU), each feeding its own micro-batches.  Without ZeRO the accumulated
fp32 grads are all-reduced at the boundary with the reference's knobs
(``fp32_allreduce``, prescale, ``gradient_predivide_factor``; chunked by
``overlap_comm``'s buckets) and every rank updates every leaf.  Under ZeRO
stage 1 or 2 (``zero.py``; the JAX engine's ``zero_flat`` branches) the
fp32 masters and the Adam moments live in one flat, 128-aligned layout of
which each rank keeps its partition:

* stage 1 accumulates the micro-steps' grads in a flat fp32 buffer (the
  per-leaf accumulators are its views) and reduce-scatters it at the
  boundary; stage 2 reduce-scatters each micro-step's grads into a
  partition-sized accumulator and finishes the cross-sub-group sum once;
* the global grad norm is the owned partition's sum of squares, summed
  within one partition group, and the overflow flag a MAX over the data
  group; the fp16 loss scale runs the MEGATRON FSM;
* the update is the Adam kernel on the owned partition (``overlap_comm``:
  one reduce-scatter, update and all-gather per 32 MB bucket), and the
  all-gather writes the updated weights, cast to the compute dtype, into
  one flat buffer of which the module's parameters are views.

Tensor parallelism (``model_parallel_size`` in the config, or
``initialize(mesh=MeshConfig(model_parallel_size=mp))``): the world is
``dp x mp`` ranks, model axis innermost (``parallel/topology.py``).  The
engine narrows the model's parameters to this rank's slices by its
``partition_specs()`` and hands it the model group; the Megatron layers'
collectives (``models/layers.py``) give every leaf its TRUE gradient on
every model rank, so, unlike the JAX engine (which psums the replicated
leaves and divides every leaf by mp, ``engine.py:1344-1368,1447-1458``),
nothing is rescaled here.  The overflow flag is MAX-agreed over the model
group and the squared norm sums each sharded leaf over it, a replicated
leaf counting once, so every rank takes the same skip, clip and loss-scale
decision.  LAMB's trust ratio stays per local shard, as in the JAX
boundary update inside ``shard_map`` and upstream Megatron + FusedLamb.
Under ZeRO each model rank partitions ITS local flat layout over its data
group.

ZeRO stage 3 (``zero3.py``; the JAX engine's ``zero3`` branches): each
parameter leaf large enough is cut along one dim over the data group
(``zero3.choose_dims``, on the model-local shape under tensor
parallelism), and its compute-dtype parameter, fp32 master and moments
persist as this rank's shard; there is no flat buffer.  The model gathers
the leaves outside its block stack at entry and each layer's weights
inside the block body (``models/transformer.py``), and the gather's
backward reduce-scatters the gradients in the compute dtype.  At the
boundary the partitioned leaves' accumulated grads are divided by the
world size and the replicated ones all-reduced with the knobs; the norm
counts every element once (``zero3.local_sqnorm_and_finite``), the
overflow flag is agreed over the data and model groups, and the update
(Adam and AdamW through the CUDA kernel, or Lion) runs per leaf on the
shards.  ``overlap_comm`` prefetches the next layer's gather.

Pipeline parallelism (``pipeline_parallel_size``, or ``MeshConfig(
pipeline_parallel_size=pp)``): the world is ``dp x pp x mp`` ranks
(``parallel/topology.py``), and each stage is a process.  The engine cuts
the model's block stack along its layer dim by its ``pipe_specs()``,
hands it its ``PipeContext`` (``parallel/pipeline.py``), and lets
``pipeline_schedule`` override its ``schedule``.  The model's loss is the
same on every stage, and ``backward`` runs the schedule's backward; the
leaves every stage holds whole (embeddings, final LayerNorm) leave it
with their gradients summed over the pipe group, so, unlike the JAX
engine (``engine.py:1460-1468``), nothing is divided by pp.  The squared
norm sums the stage-cut leaves over the pipe group and counts the others
once; the overflow flag is MAX-agreed over the pipe group.  Under ZeRO-1/2
each (stage, model rank) partitions ITS local flat layout over its data
group; under ZeRO-3 each stage partitions its leaves over its data group,
and the stage stack gathers per layer in both schedules.

Sequence (context) parallelism (``context_parallel_size``, or
``MeshConfig(context_parallel_size=sp)``): the world is ``dp x pp x sp x
mp`` ranks (``parallel/topology.py``), and the ranks of a seq group are
replicas of the parameters and the optimizer state.  Every rank of a seq
group takes its data rank's rows, and the engine cuts each batch leaf that
the model's ``batch_specs`` marks along its sequence dim, the rank's block
(a model without ``batch_specs`` is refused).  The model's attention runs
ring or Ulysses (``sp_impl``; the ``sequence_parallel_impl`` key
overrides it on an engine-owned copy of the model).  The reported loss is
the mean over the seq group (the JAX ``pmean`` over ``seq``; the data
average stays the caller's, as at sp 1), and the gradients are summed over
the seq group and divided by sp before the data path (the JAX
``engine.py:1441-1446``): the norm, clipping and overflow then see the
same gradients on every seq rank, and nothing sums over the seq group
again.

``sparse_gradients`` (ZeRO off): the leaves a model marks with its
``sparse_grad_specs`` hook reduce as gathered (indices, values) rows with
a dense fallback (``sparse.sparse_psum``; the reference's
``deepspeed_light.py:884-940``).

``train_many(batches)`` runs K ``train_batch``-format batches, bitwise
equal to K ``train_batch`` calls (the JAX ``engine.py:2986-3140``): all K
are staged to the device up front with non-blocking copies, then each runs
``train_batch``'s step.  Without a skip contract (bf16 or fp32 without the
NaN sentinel) the host reads nothing; under fp16 or the sentinel it reads
each boundary's agreed overflow flag, as ``train_batch`` does.  (The JAX
package instead gates each boundary's update on its flag inside the
compiled program.)

Resilience (``deepspeed_tpu_torch/resilience/``, the ``resilience``
config block): the hang watchdog armed around ``backward``, ``step``,
``train_batch``, ``train_many`` (deadline times K), ``save_checkpoint``
and ``load_checkpoint``; the NaN sentinel (a non-finite boundary is
skipped under any precision, and counted in ``COUNTERS.nan_skips``
outside fp16); the chaos stall point inside the armed boundary;
``resilience_counters()``.

``training_data`` becomes a ``data.DeepSpeedDataLoader`` (``deepspeed_io``)
whose batches arrive on the engine's device, each data rank reading its
rows of the global batch (the model ranks of a data group read the same
rows); ``save_checkpoint`` / ``load_checkpoint`` write and read the JAX
package's checkpoint layout, per-model-rank and ZeRO partition files
included (``checkpoint.py``); a load streams every leaf through one read
plan (``checkpoint_restore_threads`` readers, ``restore_readahead_mb`` in
flight).

Observability (``deepspeed_tpu_torch/observability/``, the
``observability`` config block; built last in ``__init__``): the metric
spool appends each boundary's loss, grad norm, loss scale and skip flag to
a device ring and drains it once per ``report_window`` boundaries without
a host wait; the window, startup and fleet events go to TensorBoard and a
JSONL log; a ``torch.profiler`` window, ``dstpu/*`` ranges and the
watchdog's hang capture; the flight recorder, the detectors and the health
endpoints.  Every deliberate host read goes through
``observability.fences`` (under fp16 or the NaN sentinel the boundary's
skip-flag read stays: the port gates the update on the host).  The
``compile_cache`` key points the kernel build directory
(``utils/compile_cache.py``).  ``tensorboard`` writes through a
``SummaryWriter`` on rank 0, the ``profile`` window and
``start_profile``/``stop_profile`` run ``torch.profiler``, and
``dump_state`` logs the config, the engine state and the device's memory
statistics.  What the JAX engine has and the port does not yet (graph lint
and ``analysis/``) raises ``NotImplementedError`` naming its ROADMAP.md
item.
"""

from __future__ import annotations

import contextlib
import copy
import json
import logging
import math
import os
import re
import time
from typing import Optional

import torch
import torch.distributed as dist
from torch import nn

from deepspeed_tpu_torch import constants as C
from deepspeed_tpu_torch import lr_schedules as schedules_mod
from deepspeed_tpu_torch import precision as prec
from deepspeed_tpu_torch import weights as weights_mod
from deepspeed_tpu_torch import zero as zero_mod
from deepspeed_tpu_torch import zero3 as zero3_mod
from deepspeed_tpu_torch.config import DeepSpeedConfig, DeepSpeedConfigError
from deepspeed_tpu_torch.observability import fences as obs_fences
from deepspeed_tpu_torch.observability.flightrec import RECORDER as _flightrec
from deepspeed_tpu_torch.observability.tracing import annotate as _annotate
from deepspeed_tpu_torch.ops import optim as optim_mod
from deepspeed_tpu_torch.parallel import comm
from deepspeed_tpu_torch.parallel.topology import (init_distributed,
                                                   make_topology)
from deepspeed_tpu_torch.resilience import COUNTERS
from deepspeed_tpu_torch.resilience import chaos as _chaos
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


_NO_BATCH_SPECS = (
    "context_parallel_size > 1 requires the model to declare "
    "batch_specs(batch) -> pytree[PartitionSpec]: the engine "
    "will not guess which batch dims are sequences. The "
    "built-in model family declares this; see "
    "models.transformer.token_batch_specs for the standard "
    "[B, T] token-batch layout.")


class _SeqMean(torch.autograd.Function):
    """The mean of ``loss`` over the seq group forward; the gradient goes
    to this rank's ``loss`` unchanged (each rank differentiates its own
    share, and the engine sums the gradients over the group)."""

    @staticmethod
    def forward(ctx, loss, group):
        out = comm.seq_sum_(loss.detach().float().clone(), group)
        return out.div_(dist.get_world_size(group)).to(loss.dtype)

    @staticmethod
    def backward(ctx, g):
        return g, None


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
        """The optimizer state, as the JAX facade's: the live tensors (as
        ``torch.optim``'s state_dict), not copies."""
        return self._engine._optimizer_state_dict()

    def load_state_dict(self, sd):
        self._engine._optimizer_load_state_dict(sd)


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
                 device=None,
                 mesh=None):
        if model is None:
            raise ValueError("deepspeed_tpu_torch.initialize: model is "
                             "required")
        if not isinstance(model, nn.Module):
            raise TypeError("model must be a torch.nn.Module returning the "
                            "loss from forward(*batch)")
        # the JAX engine's bootstrap (engine.py:332-336): an explicit
        # request, MPI discovery, or the launcher's environment
        use_mpi = bool(getattr(args, "deepspeed_mpi", False))
        if dist_init_required or use_mpi or (
                dist_init_required is None
                and "DSTPU_COORDINATOR" in os.environ):
            init_distributed(use_mpi=use_mpi, device=device)
        self.module = self._client_model = model
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

        self.topology = make_topology(cfg_src, device, mesh=mesh)
        self.device = self.topology.device
        self.dp_world_size = self.topology.dp
        self.mp_world_size = self.topology.mp
        self.pp_world_size = self.topology.pp
        self.sp_world_size = self.topology.sp
        self.global_rank = self.topology.rank
        self.mp_rank = self.topology.mp_rank
        self.pp_rank = self.topology.pp_rank
        self.sp_rank = self.topology.sp_rank
        self.config = DeepSpeedConfig(cfg_src,
                                      dp_world_size=self.dp_world_size)
        # the kernel build directory (utils/compile_cache.py): set before
        # any kernel library loads, so a relaunched worker loads the prior
        # attempt's libraries instead of running nvcc
        from deepspeed_tpu_torch.utils import compile_cache as _compile_cache
        self.compile_cache_dir = _compile_cache.enable_from_config(
            self.config)
        # knobs of upstream's NCCL schedule that one collective per bucket
        # leaves without effect: accepted, with the JAX engine's warnings
        if self.config.disable_allgather:
            logger.warning(
                "disable_allgather=true is a no-op: the ZeRO weight "
                "all-gather is one collective per bucket")
        if self.config.allgather_size != C.ALLGATHER_SIZE_DEFAULT:
            logger.warning(
                "allgather_size is a no-op: the all-gather's chunks are the "
                "overlap_comm buckets")
        validate_fn = getattr(model, "validate", None)
        if validate_fn is not None:
            validate_fn(self.mp_world_size)
        if (self.sp_world_size > 1
                and getattr(model, "batch_specs", None) is None):
            raise DeepSpeedConfigError(_NO_BATCH_SPECS)
        self._apply_model_overrides()

        self.policy = prec.policy_from_config(self.config.fp16_enabled,
                                              self.config.bf16_enabled)
        self._dynamic_loss_scale = (self.config.fp16_enabled
                                    and self.config.dynamic_loss_scale)
        self._configure_optimizer()
        self._configure_zero()
        self._refuse_unported()

        # resilience: the NaN/Inf sentinel extends the fp16 skip-on-overflow
        # contract to bf16 and fp32 boundaries; the hang watchdog arms
        # around every blocking engine call
        self._nan_sentinel = bool(self.config.resilience_nan_sentinel)
        self._watchdog = None
        self._watchdog_busy = False
        if self.config.resilience_watchdog_timeout_s > 0:
            from deepspeed_tpu_torch.resilience import Watchdog
            self._watchdog = Watchdog(
                self.config.resilience_watchdog_timeout_s,
                abort=self.config.resilience_watchdog_abort)

        # loss scale: the MEGATRON FSM under ZeRO, the INLINE one otherwise
        # (the JAX engine's engine.py:632)
        self._ls_variant = (prec.MEGATRON if self.zero_enabled
                            and self._dynamic_loss_scale else prec.INLINE)
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
        self._configure_model_parallel()
        self._configure_zero3()
        self._sparse_flags = self._resolve_sparse_flags()
        if param_groups is None and self.client_optimizer is None:
            param_groups = self.config.optimizer_param_groups
        self._init_parameters()
        self._group_defs, self._group_ids = self._resolve_param_groups(
            param_groups)
        if self.zero_flat:
            self.opt_state = optim_mod.OptimizerState(
                step=0, m={"flat": torch.zeros_like(self.master_flat)},
                v={"flat": torch.zeros_like(self.master_flat)})
            lo, part = self._owned_range()
            self._owned_segments = self.flat_meta.segments(lo, lo + part)
            if self._cut_axes():
                weights = dict(zip(self.flat_meta.names,
                                   zero_mod.norm_dedup_weights(
                                       self.flat_meta, self._param_specs,
                                       self.mp_world_size, self._pipe_specs,
                                       self.pp_world_size)))
                self._segment_weights = torch.tensor(
                    [weights.get(name, 1.0) for _, _, name in
                     self._owned_segments], device=self.device)
        else:
            self.opt_state = self.base_optimizer.init(self.master)

        self.micro_steps = 0
        self.global_steps = 0
        self.skipped_steps = 0
        self.overflow = False
        # fp32 grads summed over micro-steps: a {name: tensor} dict; under
        # ZeRO stage 1 a flat [padded] buffer (``_acc_views`` its leaves),
        # under stage 2 the owned [partition]
        self._acc = None
        self._acc_views = None
        self._last_loss = None
        #: the global grad norm of the last boundary (of the loss-scaled
        #: grads under fp16), as the JAX engine's ``_last_grad_norm``; a
        #: device tensor, never read by the engine
        self._last_grad_norm = None

        self.timers = SynchronizedWallClockTimer()
        self.tput_timer = ThroughputTimer(
            batch_size=self.train_micro_batch_size_per_gpu(),
            num_workers=self.dp_world_size,
            steps_per_output=self.steps_per_print())
        self.last_save_bytes = 0
        self.training_dataloader = (self.deepspeed_io(training_data)
                                    if training_data is not None else None)
        self.optimizer = OptimizerFacade(self)
        self._configure_lr_scheduler()

        # tensorboard (the JAX engine's engine.py:757-760): rank 0 writes
        self.summary_writer = (self._get_summary_writer()
                               if self.tensorboard_enabled()
                               and self.global_rank == 0 else None)
        self._profiling = False
        self._profiler = None
        #: the last micro-step's loss (detached): what the spool records
        self._boundary_loss = None
        #: the last boundary's agreed overflow flag (a device tensor)
        self._last_overflow = None

        # telemetry, built LAST: it reads the summary writer, the
        # scheduler and the resilience wiring above
        from deepspeed_tpu_torch.observability import Telemetry
        self._telemetry = Telemetry.from_engine(self)
        if self._watchdog is not None:
            # a tripped hang deadline records a short trace before the
            # optional abort (resilience/watchdog.py on_fire)
            hook = self._telemetry.hang_capture_hook()
            if hook is not None:
                self._watchdog.on_fire = hook
        if self.config.dump_state:
            self.dump_state()

    # ------------------------------------------------------------------ setup

    def _own_model(self):
        """The engine's own shallow copy of the model, taken at the first
        override: the caller's model object keeps its config and schedule
        (the JAX engine's ``_own_model``, ``engine.py:426-440``)."""
        if self.module is self._client_model:
            self.module = copy.copy(self.module)
        return self.module

    def _apply_model_overrides(self):
        """Config beats the model's own remat / sequence-parallel fields
        and its pipeline schedule, as in the JAX engine, on the engine's
        own copy of the model; then the Ulysses head guard."""
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
            self._own_model().with_config(**changes)
        if cfg.pipeline_schedule is not None:
            if hasattr(self.module, "schedule"):
                self._own_model().schedule = cfg.pipeline_schedule
            else:
                logger.warning("pipeline_schedule set but the model exposes "
                               "no schedule field; ignored")
        from deepspeed_tpu_torch.models.transformer import check_remat
        if mcfg is not None and hasattr(mcfg, "remat_policy"):
            check_remat(self.module.config)
        mcfg = getattr(self.module, "config", None)
        if (self.sp_world_size > 1
                and getattr(mcfg, "sp_impl", None) == "ulysses"):
            n_local = mcfg.num_heads // max(self.mp_world_size, 1)
            if n_local % self.sp_world_size:
                raise DeepSpeedConfigError(
                    f"sequence_parallel_impl='ulysses' needs local "
                    f"heads ({mcfg.num_heads}/{self.mp_world_size} = "
                    f"{n_local}) divisible by context_parallel_size "
                    f"({self.sp_world_size}); use 'ring' for "
                    f"head-limited models")

    def _configure_model_parallel(self):
        """The model's ``partition_specs()`` (``_param_specs``, dotted name
        -> sharded dim or None; None without the hook) and ``pipe_specs()``
        (``_pipe_specs``, the same over the stages); under pp > 1 its
        parameters narrowed to this rank's stage and the pipe context
        handed to it, under mp > 1 to its model-rank slices and the model
        group handed to it."""
        specs_fn = getattr(self.module, "partition_specs", None)
        specs = specs_fn() if specs_fn is not None else None
        self._param_specs = (weights_mod.flatten_tree(specs)
                             if specs is not None else None)
        self._global_shapes = {k: tuple(p.shape)
                               for k, p in self.module.named_parameters()}
        pipe_fn = getattr(self.module, "pipe_specs", None)
        self._pipe_specs = (weights_mod.flatten_tree(pipe_fn())
                            if pipe_fn is not None else None)
        if self.pp_world_size > 1:
            if pipe_fn is None:
                raise ValueError(
                    f"pipeline_parallel_size={self.pp_world_size} needs a "
                    f"model with pipe_specs() (the dim each parameter is "
                    f"cut along over the stages), e.g. GPT2Pipelined")
            from deepspeed_tpu_torch.parallel.pipeline import PipeContext
            weights_mod.shard_module_(self.module, pipe_fn(),
                                      self.pp_world_size, self.pp_rank)
            self.module.pipe = PipeContext.from_topology(self.topology)
        if self.sp_world_size > 1:
            self.module.seq_group = self.topology.seq_group
        if self.mp_world_size == 1:
            return
        if specs is None:
            raise ValueError(
                f"model_parallel_size={self.mp_world_size} needs a model "
                f"with partition_specs() (the sharded dim of each "
                f"parameter)")
        weights_mod.shard_module_(self.module, specs, self.mp_world_size,
                                  self.mp_rank)
        self.module.model_group = self.topology.model_group

    def _configure_zero3(self):
        """Stage 3: the partition dim of each leaf (``_zero3_dims``),
        chosen on its model-local shape, handed to the model with the data
        group and the prefetch flag (the JAX engine's
        ``engine.py:680-715``)."""
        self._zero3_dims = None
        if not self.zero3:
            return
        min_fn = getattr(self.module, "zero3_min_dims", None)
        dims = zero3_mod.choose_dims(
            self._global_shapes, self._param_specs, self.mp_world_size,
            self.dp_world_size, min_dims=min_fn() if min_fn else None)
        if not zero3_mod.partitioned_any(dims):
            logger.warning(
                "zero_optimization.stage=3: no parameter leaf is "
                "partitionable at dp=%d (divisibility/min-size); training "
                "proceeds with replicated parameters (stage-1-like memory)",
                self.dp_world_size)
        self._zero3_dims = dims
        self.module.zero3_dims = dims
        self.module.data_group = self.topology.group
        self.module.zero3_prefetch = self.overlap_comm

    def _resolve_sparse_flags(self):
        """``{name: True}`` of the leaves whose gradients take the
        row-sparse reduction, or None (all dense), with a warning whenever
        the flag cannot apply (the JAX engine's ``engine.py:907-940``):
        under ZeRO, without the model's ``sparse_grad_specs`` hook, or
        when it marks nothing."""
        if not self.config.sparse_gradients_enabled:
            return None
        if self.zero_enabled:
            logger.warning(
                "sparse_gradients is ignored under ZeRO: gradients reduce "
                "through the flat partition buffer (reference likewise "
                "routes ZeRO grads densely)")
            return None
        fn = getattr(self.module, "sparse_grad_specs", None)
        if fn is None:
            logger.warning(
                "sparse_gradients=true but the model defines no "
                "sparse_grad_specs(params) hook (the nn.Embedding "
                "auto-marking analog); gradients stay dense")
            return None
        flags = {k: bool(v) for k, v in weights_mod.flatten_tree(
            fn(dict(self.module.named_parameters()))).items() if v}
        if not flags:
            logger.warning(
                "sparse_gradients=true but sparse_grad_specs marked no "
                "leaves; gradients stay dense")
            return None
        return flags

    def _sharded(self, name: str) -> bool:
        """Whether leaf ``name`` is split over the model group."""
        return (self._param_specs is not None
                and self._param_specs.get(name) is not None)

    def _staged(self, name: str) -> bool:
        """Whether leaf ``name`` is cut over the pipe group."""
        return (self._pipe_specs is not None
                and self._pipe_specs.get(name) is not None)

    def _cut_axes(self):
        """``(is_cut(name), group, size)`` of each axis above size 1 that
        parameters are cut over: the model axis, then the pipe axis."""
        topo = self.topology
        axes = []
        if self.mp_world_size > 1:
            axes.append((self._sharded, topo.model_group, self.mp_world_size))
        if self.pp_world_size > 1:
            axes.append((self._staged, topo.pipe_group, self.pp_world_size))
        return axes

    def _refuse_unported(self):
        cfg = self.config
        refused = [
            (cfg.graph_lint_mode != "off" or cfg.analysis_mode != "off"
             or cfg.analysis_concurrency_mode != "off",
             "graph lint / analysis", "Queue 1 item 14"),
        ]
        for hit, what, item in refused:
            if hit:
                raise _unported(what, item)

    def _configure_zero(self):
        """ZeRO stage, partition groups and overlap buckets (the JAX
        engine's ``engine.py:504-586`` at mp = pp = 1)."""
        cfg = self.config
        self.zero_enabled = cfg.zero_enabled
        self.zero_stage = cfg.zero_stage if self.zero_enabled else 0
        self.zero_flat = self.zero_stage in (1, 2)
        self.zero3 = self.zero_stage == 3
        dp = self.dp_world_size
        if self.zero_enabled:
            # the reference's Adam-family guard (the flat layout is built
            # for m + v state; stage 3 updates per leaf, so Lion's m-only
            # state is admitted there), with the JAX engine's message
            stage3_ok = ("lion",) if self.zero3 else ()
            if self.base_optimizer.name not in ("adam", "adamw") + stage3_ok:
                raise DeepSpeedConfigError(
                    f"zero_optimization stage {cfg.zero_stage} is only "
                    f"supported for Adam-family optimizers (Lion is admitted "
                    f"at stage 3, where the update is per-leaf elementwise), "
                    f"got {self.base_optimizer.name!r} (reference guard: "
                    f"deepspeed_light.py:450-457)")
            pps = cfg.zero_parameter_parallel_size
            pps = dp if pps in (None, 0) else int(pps)
            if pps <= 0 or dp % pps != 0:
                raise DeepSpeedConfigError(
                    f"zero_optimization.parameter_parallel_size={pps} must "
                    f"divide the DP world size ({dp})")
            if self.zero3:
                self._check_zero3(pps)
            self.topology = self.topology.with_subgroups(pps)
        self.zero_pps = self.topology.pps if self.zero_flat else dp
        # overlap_comm: the boundary's collectives and update split into
        # 128-aligned buckets; DSTPU_OVERLAP=off|on beats the config
        self.overlap_comm = bool(cfg.zero_overlap_comm)
        mode = os.environ.get("DSTPU_OVERLAP", "").strip().lower()
        if mode in ("off", "0", "false"):
            self.overlap_comm = False
        elif mode in ("on", "1", "true"):
            self.overlap_comm = True
        elif mode:
            raise DeepSpeedConfigError(
                f"DSTPU_OVERLAP={mode!r} is not a valid mode: use 'on' or "
                f"'off'")
        # bucket size in fp32 elements, floored to the 128-element tile
        self.comm_bucket_elems = max(
            128, (int(cfg.zero_comm_bucket_mb * (1 << 20)) // 4 // 128)
            * 128)

    def _check_zero3(self, pps: int):
        """The JAX engine's stage-3 guards (``engine.py:587-629``)."""
        cfg = self.config
        if not hasattr(self.module, "zero3_dims"):
            raise DeepSpeedConfigError(
                "zero_optimization.stage=3 requires a model that "
                "cooperates with parameter partitioning (a zero3_dims "
                "attribute the engine fills and a per-layer gather in "
                "the block scan — the built-in GPT-2/BERT/MoE family "
                "does; see models/transformer.py zero3_enter)")
        if pps != self.dp_world_size:
            raise DeepSpeedConfigError(
                "zero_optimization.parameter_parallel_size is a "
                "stage-1/2 flat-layout knob; stage 3 partitions over "
                "the full DP group")
        # partitioned leaves reduce in the gather's backward (a
        # compute-dtype reduce-scatter before the 1/world division): the
        # knobs reach only the replicated leaves
        inert = [k for k, dflt, v in (
            ("fp32_allreduce", C.FP32_ALLREDUCE_DEFAULT, cfg.fp32_allreduce),
            ("prescale_gradients", C.PRESCALE_GRADIENTS_DEFAULT,
             cfg.prescale_gradients),
            ("gradient_predivide_factor",
             C.GRADIENT_PREDIVIDE_FACTOR_DEFAULT,
             cfg.gradient_predivide_factor)) if v != dflt]
        if inert:
            logger.warning(
                "zero_optimization.stage=3: %s only affect(s) "
                "REPLICATED leaves; partitioned leaves reduce via the "
                "gather transpose's compute-dtype (bf16/fp16) "
                "psum_scatter before the 1/world division, so fp16 "
                "partial sums there can overflow where the prescaled "
                "stage-0 path would not (dynamic loss scaling "
                "recovers but trajectories can diverge)",
                ", ".join(inert))

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
        compute dtype (aliasing the masters in fp32).  Under ZeRO 1-2 the
        masters are this rank's partition of the flat layout
        (``master_flat``; ``master`` is None) and the parameters are views
        of one flat compute-dtype buffer (``_params_flat``), which the
        boundary's all-gather writes."""
        self.module.to(self.device)
        cdt = self.policy.compute_dtype
        self._params = dict(self.module.named_parameters())
        if self.zero3:
            # this data rank's shard of each partitioned leaf (a copy, so
            # the whole leaf is freed)
            for name, p in self._params.items():
                dim = self._zero3_dims[name]
                if dim >= 0:
                    p.data = zero3_mod.shard(p.data, dim, self.dp_world_size,
                                             self.topology.dp_rank).clone()
        if self.zero_flat:
            self.flat_meta = zero_mod.make_flat_meta(self._params,
                                                     self.zero_pps)
            flat32 = zero_mod.flatten_tree(
                {k: p.detach() for k, p in self._params.items()},
                self.flat_meta, dtype=prec.MASTER_DTYPE)
            lo, part = self._owned_range()
            self.master_flat = flat32[lo:lo + part].clone()
            self._params_flat = flat32.to(cdt)
            del flat32
            views = zero_mod.unflatten_tree(self._params_flat,
                                            self.flat_meta)
            for name, p in self._params.items():
                p.data = views[name]
            self.master = None
            return
        self.flat_meta = None
        self.master_flat = None
        self.master = {}
        for name, p in self._params.items():
            self.master[name] = p.detach().to(
                dtype=prec.MASTER_DTYPE, copy=True).contiguous()
            p.data = (self.master[name] if cdt == prec.MASTER_DTYPE
                      else self.master[name].to(cdt))

    def _owned_range(self):
        """``(start, length)`` of this rank's partition in the flat
        layout."""
        part = self.flat_meta.partition
        return self.topology.partition_id * part, part

    def _resolve_param_groups(self, defs):
        """Leaves join the FIRST group whose ``params`` regex matches their
        JAX pytree path (``"['blocks']['qkv_w']"``); unmatched leaves form
        group 0 with the base optimizer's hyperparameters."""
        if not defs:
            return [{}], {k: 0 for k in self._params}
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
        paths = {k: _keystr(k) for k in self._params}
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
        return self.zero_enabled

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

    def tensorboard_enabled(self):
        return self.config.tensorboard_enabled

    def sparse_gradients_enabled(self):
        return self.config.sparse_gradients_enabled

    def postscale_gradients(self):
        return not self.config.prescale_gradients

    def gradient_predivide_factor(self):
        return self.config.gradient_predivide_factor

    def memory_estimate(self) -> dict:
        """This rank's bytes of persistent engine state (the JAX engine's
        ``memory_estimate``, ``engine.py:2338-2380``, with its keys), from
        the local parameter count: this rank's model slices of its stage's
        leaves (its shards under ZeRO-3).

          params           compute-dtype parameters
          optimizer_state  fp32 master + moments; the owned partition,
                           ``padded / min(dp, pps)``, under ZeRO-1/2
          grad_accumulator fp32; the partition under ZeRO-2, else the
                           local parameters (held between ``backward()``
                           and ``step()``)
        """
        cdt_bytes = torch.finfo(self.policy.compute_dtype).bits // 8
        n_params = sum(math.prod(s) for s in self._global_shapes.values())
        local = self.num_parameters()
        moments = ((self.opt_state.m is not None)
                   + (self.opt_state.v is not None))
        if self.zero_flat:
            part = self.flat_meta.padded // self.zero_pps
            opt_state = 4 * (1 + moments) * part
            acc = 4 * part if self.zero_stage >= 2 else 4 * local
        else:
            opt_state = 4 * (1 + moments) * local
            acc = 4 * local
        return {
            "params_bytes": cdt_bytes * local,
            "optimizer_state_bytes": opt_state,
            "grad_accumulator_bytes": acc,
            "total_persistent_bytes": cdt_bytes * local + opt_state,
            "n_params": n_params,
            "zero_stage": self.zero_stage,
        }

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

    # ------------------------------------------------------------ data layer

    def deepspeed_io(self, dataset, batch_size=None, route=C.ROUTE_TRAIN,
                     collate_fn=None, num_local_io_workers=None,
                     data_sampler=None):
        """A ``DeepSpeedDataLoader`` of ``dataset`` whose batches arrive on
        the engine's device, this rank's rows of each global batch of
        ``batch_size`` (default micro-batch x dp; reference
        deepspeed_light.py:535-567).
        ``num_local_io_workers`` > 0 collates on a producer thread, which
        also stages each batch to the device (default: one for the train
        route, none otherwise)."""
        from deepspeed_tpu_torch.data import DeepSpeedDataLoader
        if data_sampler is not None:
            raise NotImplementedError(
                "data_sampler is not supported: the loader shards and "
                "shuffles by itself")
        if batch_size is None:
            batch_size = (self.train_micro_batch_size_per_gpu()
                          * self.dp_world_size)
        if num_local_io_workers is None:
            num_local_io_workers = 1 if route == C.ROUTE_TRAIN else 0
        return DeepSpeedDataLoader(
            dataset,
            batch_size=batch_size,
            device=self.device,
            route=route,
            collate_fn=collate_fn or self.collate_fn,
            tput_timer=self.tput_timer if route == C.ROUTE_TRAIN else None,
            seed=self.seed,
            num_workers=int(num_local_io_workers),
            device_prefetch=True,
            dp_rank=self.topology.dp_rank,
            dp_size=self.dp_world_size)

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
        batch = self._seq_block(tuple(self._to_device(x) for x in inputs))
        if self.training:
            with _annotate("fwd"):
                loss = self._seq_mean(self.module(*batch))
        else:
            self.tput_timer.discard_window()
            with torch.no_grad(), _annotate("eval"):
                loss = self._seq_mean(self.module(*batch))
        self._last_loss = loss
        if wcb:
            self.timers(FORWARD_TIMER).stop(sync_on=loss)
        return loss

    __call__ = forward

    def _seq_block(self, batch):
        """Under sequence parallelism, this rank's block of each leaf that
        the model's ``batch_specs`` cuts along a sequence dim (the JAX
        ``P('data', 'seq')`` leaves); the others whole."""
        sp = self.sp_world_size
        if sp == 1:
            return batch
        out = []
        for x, dim in zip(batch, self.module.batch_specs(batch)):
            if dim is not None:
                if x.shape[dim] % sp:
                    raise ValueError(
                        f"context_parallel_size={sp} must divide the "
                        f"sequence dim {dim} of a batch leaf of shape "
                        f"{tuple(x.shape)}")
                n = x.shape[dim] // sp
                x = x.narrow(dim, self.sp_rank * n, n).contiguous()
            out.append(x)
        return tuple(out)

    def _seq_mean(self, loss):
        """The loss averaged over the seq group (the JAX ``pmean`` over
        ``seq``); its gradient is this rank's own loss's."""
        group = self.topology.seq_group
        if group is None:
            return loss
        if isinstance(loss, (tuple, list)):
            return type(loss)(self._seq_mean(l) for l in loss)
        return _SeqMean.apply(loss, group)

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
        with self._armed("backward (fused fwd+bwd)"), _annotate("bwd"):
            (total * (self.loss_scale_state.cur_scale / gas)).backward()
            self._last_loss = None
            self._boundary_loss = (
                type(out)(l.detach() for l in out)
                if isinstance(out, (tuple, list)) else out.detach())
            with torch.no_grad():
                if self.zero_stage == 2:
                    self._accumulate_partition()
                elif self.zero_flat:
                    self._accumulate_flat()
                else:
                    self._accumulate_leaves()
        if (self.summary_writer is not None and self._spool is None
                and self.is_gradient_accumulation_boundary()):
            self.sample_count = (self.train_micro_batch_size_per_gpu()
                                 * self.dp_world_size * (self.micro_steps + 1))
            # float(l) is a host read; with the metric spool on the loss
            # rides the ring buffer and reaches TensorBoard at the drain
            losses = (self._boundary_loss
                      if isinstance(self._boundary_loss, (tuple, list))
                      else (self._boundary_loss,))
            obs_fences.count_fence()
            self.summary_writer.add_scalar(
                "Train/Samples/train_loss",
                sum(float(l) for l in losses), self.sample_count)
        if wcb:
            self.timers(BACKWARD_TIMER).stop(sync_on=self._acc)
        if loss is None:
            return None
        if isinstance(loss, (tuple, list)):
            return type(loss)(l.detach() / gas for l in loss)
        return loss.detach() / gas

    def _accumulate_leaves(self):
        """Add each parameter's grad, in fp32, to its accumulator."""
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

    def _flat_grads(self, out):
        """The parameters' grads written into the leaf views of ``out`` (a
        flat fp32 [padded] buffer, zeros where a leaf has no grad)."""
        views = zero_mod.unflatten_tree(out, self.flat_meta)
        for name, p in self._params.items():
            if p.grad is not None:
                views[name].copy_(p.grad)
                p.grad = None
        return views

    def _accumulate_flat(self):
        """ZeRO-1: the grads summed into one flat fp32 buffer whose leaf
        views are the per-leaf accumulators; the boundary reduce-scatters
        it whole."""
        if self._acc is None:
            self._acc = torch.zeros(self.flat_meta.padded,
                                    dtype=torch.float32, device=self.device)
            self._acc_views = self._flat_grads(self._acc)
            return
        for name, p in self._params.items():
            if p.grad is not None:
                self._acc_views[name].add_(p.grad)
                p.grad = None

    def _accumulate_partition(self):
        """ZeRO-2: this micro-step's grads reduce-scatter onto the owned
        partition (the cross-sub-group sum waits for the boundary) and add
        up there: the accumulator is [partition], not the model."""
        flat = torch.zeros(self.flat_meta.padded, dtype=torch.float32,
                           device=self.device)
        self._flat_grads(flat)
        self._seq_reduce([flat])
        part = self._scatter(flat, across_subgroups=False)
        del flat
        if self._acc is None:
            self._acc = part
        else:
            self._acc.add_(part)

    # ------------------------------------------------------------------- step

    def _seq_reduce(self, grads):
        """Under sequence parallelism, each fp32 gradient summed over the
        seq group and divided by sp, in place, before the data path (the
        JAX ``psum(g, 'seq') / sp``): the ranks' losses are the blocks'
        shares of the mean, and the ring's and Ulysses' backward sent each
        rank's share of the others' gradients to it.  One collective."""
        group = self.topology.seq_group
        if group is None or not grads:
            return
        comm.sum_fp32_(grads, group)
        for g in grads:
            g.div_(self.sp_world_size)

    def _reduce_knobs(self):
        cfg = self.config
        return dict(fp32_allreduce=cfg.fp32_allreduce,
                    prescale_gradients=cfg.prescale_gradients,
                    gradient_predivide_factor=cfg.gradient_predivide_factor)

    def _subgroups(self):
        return (self.topology.within, self.topology.across)

    def _comm_buckets(self):
        """Bucket bounds over the owned partition under overlap_comm;
        None is the serial boundary (one collective, one update)."""
        if not self.overlap_comm:
            return None
        return comm.bucket_bounds(self.flat_meta.partition,
                                  self.comm_bucket_elems)

    def _scatter(self, flat, across_subgroups=True):
        """Reduce-scatter a flat fp32 [padded] gradient onto the owned
        [partition] (the JAX engine's ``_scatter_grads_local``); ``flat``
        may be overwritten."""
        kw = dict(self._reduce_knobs(), partition_group_size=self.zero_pps,
                  across_subgroups=across_subgroups,
                  subgroups=self._subgroups())
        bounds = self._comm_buckets()
        topo = self.topology
        if bounds is not None:
            return comm.reduce_scatter_grads_bucketed(
                flat, topo.group, self.dp_world_size, bounds, **kw)
        return comm.reduce_scatter_grads(flat, topo.group,
                                         self.dp_world_size, **kw)

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

    def _combined_scale(self, total_norm):
        """The unscale-and-clip divisor of the update (1.0 when neither
        applies)."""
        clip = self.clip_grad
        if self.config.fp16_enabled:
            return prec.combined_unscale_and_clip_factor(
                total_norm, self.loss_scale_state, clip)
        if clip > 0:
            return prec.combined_unscale_and_clip_factor(
                total_norm, prec.static_loss_scale_state(1.0, self.device),
                clip)
        return 1.0

    @torch.no_grad()
    def _boundary_update(self):
        """DP reduction, norm, overflow, update, loss-scale FSM; returns
        the overflow as a host bool under fp16 (where it decides the skip)
        else False."""
        if self.zero_flat:
            return self._zero_boundary_update()
        fp16 = self.config.fp16_enabled
        self._seq_reduce([g for g in self._acc.values() if g is not None])
        grads = self._reduce_grads(self._acc)
        self._acc = None
        # the reduced grads are the same on every data rank: so are the
        # norm and the overflow flag
        sq, overflow = self._sqnorm_and_overflow(grads)
        self._last_overflow = overflow
        self._last_grad_norm = torch.sqrt(sq)
        combined = self._combined_scale(self._last_grad_norm)
        skip = self._skip(overflow)
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

    def _skip(self, overflow) -> bool:
        """Whether this boundary skips its update: under the skip contract
        (fp16, or the NaN sentinel at any precision) the host reads the
        agreed overflow flag."""
        if not (self.config.fp16_enabled or self._nan_sentinel):
            return False
        # the one boundary read the port keeps with the spool on: its
        # update is gated on the host (observability.Telemetry.
        # defers_overflow)
        self._telemetry.defers_overflow(self)
        return bool(obs_fences.read_scalar(overflow))

    def _reduce_grads(self, acc):
        """The data-group reduction of the accumulated per-leaf grads, in
        place where it can be.  At stage 3 the partitioned leaves arrive
        summed and scattered by the gather's backward and are divided by
        the world size; the replicated ones (and every leaf below stage 1)
        all-reduce with the knobs, the ``sparse_gradients`` leaves as
        gathered rows (``sparse.sparse_psum``)."""
        group, world = self.topology.group, self.dp_world_size
        kw = dict(self._reduce_knobs(),
                  bucket_elems=(self.comm_bucket_elems if self.overlap_comm
                                else None))
        special = {}
        if self.zero3:
            for k, g in acc.items():
                if g is not None and self._zero3_dims[k] >= 0:
                    special[k] = g.div_(world) if world != 1 else g
        elif self._sparse_flags is not None:
            from deepspeed_tpu_torch import sparse as sparse_mod
            kw.pop("bucket_elems")
            for k, g in acc.items():
                if g is not None and self._sparse_flags.get(k):
                    special[k] = sparse_mod.sparse_psum(
                        g, group, world,
                        self.config.sparse_gradients_max_rows, **kw)
        dense = comm.allreduce_grads(
            {k: g for k, g in acc.items() if k not in special}, group,
            world, **kw)
        return {k: special[k] if k in special else dense[k] for k in acc}

    def _sqnorm_and_overflow(self, grads):
        """The global squared grad norm and the overflow flag of the
        data-reduced ``grads`` (the JAX ``_global_overflow_and_sqnorm``):
        each leaf's squares summed over exactly the axes it is cut over
        (model, pipe), a leaf held whole counted once, the flag MAX-agreed
        over the model and pipe groups."""
        def sq_sum(names):
            if not names:
                return torch.zeros((), dtype=torch.float32,
                                   device=self.device)
            norms = torch.stack([torch.linalg.vector_norm(
                grads[k], dtype=torch.float32) for k in names])
            return torch.sum(norms * norms)

        names = [k for k, g in grads.items() if g is not None]
        topo = self.topology
        if self.zero3:
            # partitioned shards differ by data rank: sum over the data
            # group, each element once, and agree on the flag there too;
            # then over the model and pipe groups, with the leaves held
            # whole on those counted once
            sq, finite = zero3_mod.local_sqnorm_and_finite(
                grads, self._zero3_dims, self._param_specs,
                self.dp_world_size, self.mp_world_size, self._pipe_specs,
                self.pp_world_size)
            sq = sq.reshape(1)
            if topo.group is not None:
                dist.all_reduce(sq, group=topo.group)
            overflow = comm.overflow_any(~finite, topo.group)
            for group in (topo.model_group, topo.pipe_group):
                if group is not None:
                    comm.model_sum_(sq, group)
                    overflow = comm.overflow_any(overflow, group)
            return sq[0], overflow
        axes = self._cut_axes()
        if not axes:
            sq = sq_sum(names)
            # a non-finite grad makes the squared norm non-finite
            return sq, ~torch.isfinite(sq)
        # one partial sum per combination of the axes a leaf is cut over,
        # each summed over those axes' groups
        keys = {}
        for k in names:
            keys.setdefault(tuple(cut(k) for cut, _, _ in axes), []).append(k)
        sq = torch.zeros((), dtype=torch.float32, device=self.device)
        for key in sorted(keys):
            part = sq_sum(keys[key]).reshape(1)
            for on, (_, group, _) in zip(key, axes):
                if on:
                    comm.model_sum_(part, group)
            sq = sq + part[0]
        overflow = ~torch.isfinite(sq)
        for _, group, _ in axes:
            overflow = comm.overflow_any(overflow, group)
        return sq, overflow

    def _zero_boundary_update(self):
        """The ZeRO-1/2 boundary (the JAX engine's ``_make_step_local``,
        flat branch): the reduced gradient of the owned partition, the
        overflow flag agreed over the data group, the global norm summed
        within one partition group, then per bucket the Adam kernel on the
        partition and the all-gather of the updated weights into the
        module's parameters.  Under fp16 an overflow skips the update on
        every rank (reference zero_optimizer.py:349-359)."""
        topo = self.topology
        if self.zero_stage == 2:
            gpart = comm.finish_subgroup_reduce(
                self._acc, self.dp_world_size, self.zero_pps,
                self._subgroups())
        else:
            self._seq_reduce([self._acc])
            gpart = self._scatter(self._acc)
        self._acc = self._acc_views = None
        if not self._cut_axes():
            norms = torch.linalg.vector_norm(gpart, dtype=torch.float32)
            sq = (norms * norms).reshape(1)
        else:
            # per leaf piece; a leaf held whole on an axis's ranks weighs
            # 1/size there, so the groups' sums count each once (the JAX
            # norm_dedup_weights)
            norms = torch.stack([torch.linalg.vector_norm(
                gpart[s:e], dtype=torch.float32)
                for s, e, _ in self._owned_segments])
            sq = torch.sum(self._segment_weights * norms * norms).reshape(1)
        # a non-finite element makes its piece's norm non-finite
        overflow = comm.overflow_any(~torch.isfinite(norms).all(),
                                     topo.group)
        for group in (topo.model_group, topo.pipe_group):
            if group is not None:
                overflow = comm.overflow_any(overflow, group)
        if topo.within is not None:
            # partitions repeat across the dp / pps sub-groups: sum within
            # one, so each element counts once
            dist.all_reduce(sq, group=topo.within)
        comm.model_sum_(sq, topo.model_group)
        comm.model_sum_(sq, topo.pipe_group)
        self._last_overflow = overflow
        self._last_grad_norm = torch.sqrt(sq[0])
        combined = self._combined_scale(self._last_grad_norm)
        fp16 = self.config.fp16_enabled
        skip = self._skip(overflow)
        if not skip:
            self._zero_update(gpart, combined)
        if fp16:
            self.loss_scale_state = prec.update_loss_scale(
                self.loss_scale_state, overflow, variant=self._ls_variant)
        return skip

    def _zero_update(self, gpart, combined):
        """Per bucket (the whole partition with overlap_comm off): the Adam
        kernel on the owned partition, cut at leaf boundaries where param
        groups differ, then the bucket's all-gather, cast to the compute
        dtype, into ``_params_flat``."""
        lr, b1, b2, wd = self._hypers()
        grouped = len(self._group_defs) > 1
        part = self.flat_meta.partition
        topo = self.topology
        rows = self._params_flat.view(self.zero_pps, part)
        master, st = self.master_flat, self.opt_state
        for s, e in self._comm_buckets() or ((0, part),):
            if grouped:
                segs = [(max(a, s) - s, min(b, e) - s, name)
                        for a, b, name in self._owned_segments
                        if a < e and b > s]
            else:
                segs = [(0, e - s, None)]
            seg_state = optim_mod.OptimizerState(
                step=st.step, m={"flat": st.m["flat"][s:e]},
                v={"flat": st.v["flat"][s:e]})
            self.base_optimizer.update_flat(
                master[s:e], gpart[s:e], seg_state, segs, lr=lr, beta1=b1,
                beta2=b2, weight_decay=wd, combined_scale=combined)
            bucket = master[s:e].to(self.policy.compute_dtype)
            # a [pps, w] column block is contiguous only for one row
            out = rows[:, s:e] if self.zero_pps == 1 else None
            block = comm.allgather_partition_bucket(
                bucket, topo.group, self.dp_world_size, self.zero_pps,
                self._subgroups(), out=out)
            if out is None:
                rows[:, s:e].copy_(block)
        st.step += 1

    def _post_boundary_bookkeeping(self, overflow: bool):
        self.global_steps += 1
        # post-mortem breadcrumb: which boundary this process last
        # completed (the flight recorder)
        _flightrec.record("boundary", step=self.global_steps)
        self._profile_window()
        self._telemetry.maybe_trace(self.global_steps)
        self.overflow = overflow
        if overflow:
            self.skipped_steps += 1
            if self._nan_sentinel and not self.config.fp16_enabled:
                # under fp16 an overflow is the loss-scale FSM's routine
                # calibration: nan_skips counts only the sentinel's skips
                COUNTERS.nan_skips += 1
                logger.warning(
                    "resilience: non-finite gradients at global step %d — "
                    "optimizer boundary skipped (nan_sentinel)",
                    self.global_steps)
        elif self.lr_scheduler is not None:
            self.lr_scheduler.step()
        if self.global_steps % self.steps_per_print() == 0:
            self._report_progress(self.global_steps)
        if self.summary_writer is not None and not self._telemetry.spool_active:
            # per-boundary scalars through the one registry (lr, the
            # resilience and compile-cache counters); with the spool on
            # they ride the window drain instead
            self._telemetry.emit_boundary_scalars(
                getattr(self, "sample_count", self.global_steps))

    def _spool_row(self, offset=None, ls_used=None):
        """This boundary's spool row: the last micro-step's loss, the grad
        norm, the loss scale in effect and the overflow flag (device ops
        only).  ``offset`` None appends it; an int writes row ``offset`` of
        a ``train_many`` block, noted at the block's end."""
        spool = self._spool
        if spool is None:
            return
        self._telemetry.note_spool_base_step(self.global_steps - 1)
        args = (self._boundary_loss, self._last_grad_norm, ls_used,
                self._last_overflow)
        if offset is None:
            spool.append(*args)
        else:
            spool.write_row(offset, *args)

    def _stop_tput(self, sync_on):
        if self._spool is not None:
            # throughput rides the window drains; a report's host wait
            # here would bring back the stall the spool removes
            self.tput_timer.stop(report_speed=False, sync_on=None)
        else:
            self.tput_timer.stop(sync_on=sync_on)

    def step(self):
        """Optimizer boundary step (upstream deepspeed_light.py:709-807)."""
        assert self.training, "step() requires train mode"
        wcb = self.wall_clock_breakdown()
        if wcb:
            self.timers(STEP_TIMER).start()
        if self.is_gradient_accumulation_boundary():
            assert self._acc is not None, "step() with no accumulated grads"
            with self._armed("optimizer boundary step"), \
                    _annotate("boundary"):
                # host-side pre-work clock (the fleet straggler signal)
                t0 = time.monotonic()
                _flightrec.record("arm", label="boundary",
                                  step=self.global_steps)
                _chaos.maybe_stall(self.global_steps)
                t1 = time.monotonic()
                ls_used = self.loss_scale_state.cur_scale
                self._post_boundary_bookkeeping(self._boundary_update())
                # noted before the row: a window edge's delivery must find
                # this boundary's host time in its own window
                self._telemetry.note_boundary_host_seconds(
                    t1 - t0, time.monotonic() - t0)
                self._spool_row(ls_used=ls_used)
            self._stop_tput(self._state_tensor())
        self.micro_steps += 1
        if wcb:
            self.timers(STEP_TIMER).stop(sync_on=self._state_tensor())
            self.timers.log([FORWARD_TIMER, BACKWARD_TIMER, STEP_TIMER],
                            memory_breakdown=self.config.memory_breakdown)

    # --------------------------------------------------------- fused hot path

    def train_batch(self, batch):
        """Forward+backward over gas micro-batches, then the boundary step.
        ``batch`` is this rank's: its leaves carry a leading [gas * micro]
        axis, and micro-step i takes rows [i*micro, (i+1)*micro), as the
        JAX engine's scan does.  (The JAX engine takes the global
        [dp * gas * micro] batch, of which rank r's block is rows [r * gas
        * micro, (r + 1) * gas * micro).)  Returns the last micro-step's
        loss (fp32, detached)."""
        assert self.training, "train_batch() requires train mode"
        batch = self._check_batch(batch, "train_batch")
        batch = tuple(self._to_device(x) for x in batch)
        with self._armed("train_batch"), _annotate("train_batch"):
            # host-side pre-work clock: [region entry, the step's first
            # launch) is time only THIS host pays (GC, data prep, an
            # injected stall) — the fleet straggler signal; a collective
            # wait inside the step is excluded
            t0 = time.monotonic()
            _flightrec.record("arm", label="train_batch",
                              step=self.global_steps)
            _chaos.maybe_stall(self.global_steps)
            t1 = time.monotonic()
            return self._train_step(batch, host_clock=(t0, t1))

    def _check_batch(self, batch, what):
        """``batch`` as a tuple of leaves sharing a leading dim divisible
        by gas."""
        batch = tuple(batch) if isinstance(batch, (tuple, list)) else (batch,)
        gas = self.gradient_accumulation_steps()
        leads = {x.shape[0] for x in batch}
        if len(leads) != 1:
            raise ValueError(
                f"{what}: batch leaves disagree on the leading dim "
                f"({sorted(leads)}); every leaf must carry the same "
                f"[gas * micro] axis")
        lead = leads.pop()
        if lead % gas != 0:
            raise ValueError(
                f"{what}: leading batch dim {lead} is not divisible by "
                f"gradient_accumulation_steps={gas}")
        return batch

    def _train_step(self, batch, spool_offset=None, host_clock=None):
        """One ``train_batch`` on a checked batch already on the device;
        ``spool_offset``: its row in a ``train_many`` block;
        ``host_clock``: ``(region entry, work start)`` of ``train_batch``'s
        region, noted for the telemetry before the spool row."""
        gas = self.gradient_accumulation_steps()
        mb = batch[0].shape[0] // gas
        self.tput_timer.start()
        loss = None
        for i in range(gas):
            loss = self.forward(*(x[i * mb:(i + 1) * mb] for x in batch))
            self.backward(loss)
        ls_used = self.loss_scale_state.cur_scale
        with _annotate("boundary"):
            self._post_boundary_bookkeeping(self._boundary_update())
        if host_clock is not None:
            t0, t1 = host_clock
            self._telemetry.note_boundary_host_seconds(
                t1 - t0, time.monotonic() - t0)
        self._spool_row(spool_offset, ls_used)
        self.micro_steps += gas
        self._stop_tput(loss)
        if isinstance(loss, (tuple, list)):
            return type(loss)(l.detach().float() for l in loss)
        return loss.detach().float()

    def train_many(self, batches):
        """K optimizer steps, one per ``train_batch``-format batch of
        ``batches`` (K is its length, typically
        ``config.train_steps_per_dispatch``, grouped by
        ``data.BlockPrefetcher``): bitwise equal to K ``train_batch``
        calls, the masters, moments, step, loss scale, skip counters, LR
        schedule and returned last loss alike.  All K batches are staged
        to the device first, and the watchdog is armed once with its
        deadline scaled by K.  Preemption (``resilience.run_resumable``)
        polls between calls, so a drain lands on a K boundary."""
        assert self.training, "train_many() requires train mode"
        if not isinstance(batches, (list, tuple)) or len(batches) == 0:
            raise ValueError(
                "train_many: pass a non-empty sequence of train_batch-"
                "format batches (one per fused optimizer step)")
        batches = [tuple(b) if isinstance(b, (tuple, list)) else (b,)
                   for b in batches]
        fmt = [tuple((tuple(x.shape), str(x.dtype)) for x in b)
               for b in batches]
        if any(f != fmt[0] for f in fmt[1:]):
            raise ValueError(
                "train_many: every batch in a K-block must share one "
                "format (pytree structure + leaf shapes/dtypes); mixed "
                "formats must go through separate blocks")
        batches = [self._check_batch(b, "train_many") for b in batches]
        k = len(batches)
        sched = self.lr_scheduler
        if sched is not None and not (hasattr(sched, "state_dict")
                                      and hasattr(sched, "load_state_dict")):
            raise DeepSpeedConfigError(
                f"train_steps_per_dispatch > 1 with an LR scheduler "
                f"needs state_dict/load_state_dict on the scheduler "
                f"(to stage the K prospective hyper rows); "
                f"{type(sched).__name__} has neither")
        staged = [tuple(self._to_device(x) for x in b) for b in batches]
        spool = self._spool
        if spool is not None and spool.would_straddle(k):
            # a stray train_batch left the ring mid-window: this block's K
            # rows would wrap over undrained ones.  Deliver the partial
            # window first (one counted fence, mixed usage only)
            spool.flush()
        with self._armed("train_many", deadline_scale=k), \
                _annotate("train_many"):
            t0 = time.monotonic()
            _flightrec.record("arm", label="train_many",
                              step=self.global_steps, block=k)
            _chaos.maybe_stall(self.global_steps)
            t1 = time.monotonic()
            for i, b in enumerate(staged):
                loss = self._train_step(
                    b, spool_offset=i if spool is not None else None)
            self._telemetry.note_boundary_host_seconds(
                t1 - t0, time.monotonic() - t0)
            if spool is not None:
                # the K rows count at once; the drain fires on the window
                # edge (window % K == 0)
                spool.note_appends(k)
            return loss

    # -------------------------------------------------------------- resilience

    @contextlib.contextmanager
    def _armed(self, label, deadline_scale: float = 1.0):
        """The watchdog armed around a blocking call (nothing when the
        resilience watchdog is off).  ``deadline_scale`` stretches the
        deadline for regions of several optimizer steps (``train_many``).
        Armed regions do not nest: a call inside one (``backward`` inside
        ``train_batch``) runs under the outer arm."""
        if self._watchdog is None or self._watchdog_busy:
            yield
            return
        self._watchdog_busy = True
        try:
            with self._watchdog.armed(label, deadline_scale=deadline_scale):
                yield
        finally:
            self._watchdog_busy = False

    def resilience_counters(self) -> dict:
        """The process-wide resilience counters (restarts, skipped-NaN
        steps, IO retries, watchdog near-misses and fires, the last
        restore's seconds, the compile cache's hits and misses), also
        exported through the telemetry registry as ``Train/Resilience/*``
        scalars."""
        return COUNTERS.as_dict()

    # ------------------------------------------------------------ telemetry

    @property
    def telemetry(self):
        """The engine's ``observability.Telemetry`` (always present; the
        spool, tracer, fleet and health endpoints only when configured)."""
        return self._telemetry

    @property
    def _spool(self):
        """The active MetricSpool, or None (``report_window`` unset)."""
        return self._telemetry.spool

    def flush_telemetry(self, local_only=False, fleet_timeout=None):
        """Deliver the final (possibly partial) metric window now: THE one
        deliberate telemetry fence.  The resilience driver calls it on a
        preemption drain and at run end, ``load_checkpoint`` before a
        restore; idempotent.  ``local_only`` skips the bounded wait for the
        fleet (the preemption drain's, before the emergency save)."""
        self._telemetry.flush(local_only=local_only,
                              fleet_timeout=fleet_timeout)

    def _get_summary_writer(self):
        base = (self.config.tensorboard_output_path
                or os.path.join(os.path.expanduser("~"), "tensorboard"))
        name = self.config.tensorboard_job_name or "DeepSpeedJobName"
        path = os.path.join(base, name)
        try:
            from torch.utils.tensorboard import SummaryWriter
            return SummaryWriter(log_dir=path)
        except Exception:
            logger.warning("tensorboard requested but no writer available")
            return None

    def dump_state(self):
        """The config, the engine state and the device's memory statistics
        in the log (upstream dump_state, deepspeed_light.py:183-185; the
        JAX engine's ``dump_state``)."""
        self.config.print("DeepSpeedTorchEngine config")
        logger.info(
            "engine state: device=%s (dp=%d mp=%d pp=%d sp=%d) zero=%s "
            "stage=%d compute_dtype=%s optimizer=%s groups=%d",
            self.device, self.dp_world_size, self.mp_world_size,
            self.pp_world_size, self.sp_world_size, self.zero_enabled,
            self.zero_stage, str(self.policy.compute_dtype).replace(
                "torch.", ""),
            self.base_optimizer.name, len(self._group_defs))
        logger.info("steps: global=%d micro=%d skipped=%d",
                    self.global_steps, self.micro_steps, self.skipped_steps)
        mem = SynchronizedWallClockTimer.memory_usage()
        if mem:
            logger.info("memory: %s", mem)
        if self.device.type == "cuda":
            stats = torch.cuda.memory_stats(self.device)
            logger.info("memory_stats: %s", {
                k: stats[k] for k in sorted(stats)
                if k.endswith(".all.current") or k.endswith(".all.peak")})

    # ------------------------------------------------------------- profiling

    def start_profile(self, output_path: Optional[str] = None):
        """Start a ``torch.profiler`` capture (CPU, and CUDA on a card); the
        ``profile`` config section drives it over ``[start_step,
        end_step)``.  ``stop_profile`` writes it as a Chrome trace to
        ``<output_path>/trace.json`` (``trace_rank<r>.json`` at world >
        1)."""
        if self._profiling:
            return
        from deepspeed_tpu_torch.observability import tracing as obs_tracing
        path = output_path or self.config.profile_output_path
        world = self.dp_world_size * self.mp_world_size \
            * self.pp_world_size * self.sp_world_size
        name = f"trace_rank{self.global_rank}.json" if world > 1 \
            else "trace.json"
        self._profiler = (obs_tracing.start_capture(
            self.device.type == "cuda"), os.path.join(path, name))
        self._profiling = True
        obs_tracing.note_capture_active(True)
        # write the trace even if training ends inside the window; register
        # once (a bound-method atexit handler pins the engine)
        if not getattr(self, "_profile_atexit", False):
            import atexit
            atexit.register(self.stop_profile)
            self._profile_atexit = True
        logger.info("torch.profiler capture started -> %s",
                    self._profiler[1])

    def stop_profile(self):
        if not self._profiling:
            return
        from deepspeed_tpu_torch.observability import tracing as obs_tracing
        obs_tracing.note_capture_active(False)
        prof, path = self._profiler
        self._profiler = None
        self._profiling = False
        obs_tracing.stop_capture(prof, path)
        logger.info("torch.profiler capture stopped -> %s", path)

    def _profile_window(self):
        cfg = self.config
        if not cfg.profile_enabled:
            return
        # range (not equality) checks: a resume can land past start_step
        # and must still trace the rest of the window
        if (not self._profiling
                and cfg.profile_start_step <= self.global_steps
                < cfg.profile_end_step):
            self.start_profile()
        elif self._profiling and self.global_steps >= cfg.profile_end_step:
            self.stop_profile()

    # ---------------------------------------------------------- checkpointing

    def save_checkpoint(self, save_dir, tag=None, client_state=None,
                        async_save=None):
        """Write a checkpoint (reference deepspeed_light.py:1048-1114) in
        the JAX package's layout; returns its directory.  ``async_save``
        returns after the device-to-host copy and writes on a background
        thread: ``checkpoint_wait()`` blocks until it is on disk."""
        from deepspeed_tpu_torch import checkpoint as ckpt_mod
        # the save's stall is not training throughput
        self.tput_timer.discard_window()
        _flightrec.record("checkpoint.save", step=self.global_steps, tag=tag)
        with self._armed("save_checkpoint"), _annotate("checkpoint.save"):
            return ckpt_mod.save_checkpoint(self, save_dir, tag=tag,
                                            client_state=client_state,
                                            async_save=async_save)

    def checkpoint_wait(self):
        """Block until every queued async checkpoint write is on disk;
        re-raises the first background failure."""
        from deepspeed_tpu_torch import checkpoint as ckpt_mod
        ckpt_mod.ASYNC_SAVER.wait()

    def load_checkpoint(self, load_dir, tag=None, load_optimizer_states=True,
                        load_lr_scheduler_states=True):
        """Restore from a checkpoint (reference deepspeed_light.py:974-1046);
        returns ``(path, client_state)``, ``(None, None)`` if none."""
        from deepspeed_tpu_torch import checkpoint as ckpt_mod
        # deliver the undelivered metric window NOW, with the pre-restore
        # step numbers: stale ring rows must never mix into a window after
        # the restore
        self.flush_telemetry()
        self.tput_timer.discard_window()
        t0 = time.perf_counter()
        _flightrec.record("checkpoint.load", step=self.global_steps, tag=tag)
        with self._armed("load_checkpoint"), _annotate("checkpoint.load"):
            path, client = ckpt_mod.load_checkpoint(
                self, load_dir, tag=tag,
                load_optimizer_states=load_optimizer_states,
                load_lr_scheduler_states=load_lr_scheduler_states)
        if path is not None:
            # the restore is on the resume's critical path (the JAX
            # engine's ``restore_seconds``); the copies to the card are
            # done when the masters are (a counted fence)
            obs_fences.fence_on(self._state_tensor())
            COUNTERS.restore_seconds = time.perf_counter() - t0
            # window step numbering follows the restored step count
            self._telemetry.rebase_steps(self.global_steps)
        return path, client

    def _state_tensor(self):
        """The fp32 masters: what a timer synchronises on."""
        return self.master_flat if self.zero_flat else self.master

    def _optimizer_state_dict(self):
        sd = {"opt_state": {"step": self.opt_state.step,
                            "m": self.opt_state.m, "v": self.opt_state.v},
              "loss_scale_state": self.loss_scale_state._asdict(),
              "zero_enabled": self.zero_enabled,
              "zero_stage": self.zero_stage}
        if self.zero_flat:
            sd["master_flat"] = self.master_flat
        else:
            sd["master"] = self.master
        return sd

    @torch.no_grad()
    def _optimizer_load_state_dict(self, sd):
        """Copy ``sd`` (an ``optimizer.state_dict()``) into the live state;
        the compute-dtype parameters follow the masters."""
        def load(dst, src, what):
            if set(dst) != set(src):
                raise KeyError(f"optimizer state_dict {what} names differ "
                               f"from the engine's")
            for k, t in dst.items():
                t.copy_(src[k])

        opt = sd["opt_state"]
        for key in ("m", "v"):
            live = getattr(self.opt_state, key)
            if live is not None:
                load(live, opt[key], key)
        self.opt_state.step = int(opt["step"])
        self.loss_scale_state = prec.LossScaleState(**{
            k: torch.as_tensor(sd["loss_scale_state"][k]).to(
                device=v.device, dtype=v.dtype)
            for k, v in self.loss_scale_state._asdict().items()})
        if self.zero_flat:
            self.master_flat.copy_(sd["master_flat"])
            self._params_from_master_flat()
            return
        load(self.master, sd["master"], "master")
        for name, p in self._params.items():
            if p.data_ptr() != self.master[name].data_ptr():
                p.copy_(self.master[name])

    @torch.no_grad()
    def _params_from_master_flat(self):
        """The compute-dtype parameters re-derived from the partitioned
        master: every rank's partition, cast, all-gathered into
        ``_params_flat`` (collective: every rank calls it)."""
        comm.allgather_params(
            self.master_flat.to(self.policy.compute_dtype),
            self.topology.group, self.dp_world_size, self.zero_pps,
            self._subgroups(), out=self._params_flat)

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
        return sum(math.prod(p.shape) for p in self._params.values())
