"""JSON config system with batch-size inference.

The port's copy of ``deepspeed_tpu/config.py`` (upstream DeepSpeed's
``deepspeed/pt/deepspeed_config.py:234-421``).  Same JSON schema, same batch
"triangle" solver over {train_batch_size, train_micro_batch_size_per_gpu,
gradient_accumulation_steps}, same error checks: the same JSON gives the same
resolved fields and the same errors in both packages.  Keys that name JAX
features (graph lint, capacity planner, jax.profiler windows) still parse
here so a config file serves both packages; the torch engine refuses the ones
it does not implement (engine.py).
"""

from __future__ import annotations

import json
import logging
import os
from typing import Any, Mapping, Optional

from deepspeed_tpu_torch import constants as C

logger = logging.getLogger(__name__)

#: env fallback for the trace destination (deepspeed_tpu/observability/
#: tracing.py ENV_TRACE_DIR), kept so the same config errors the same way
ENV_TRACE_DIR = "DSTPU_TRACE_DIR"

#: backend-profile names the JAX analyzer knows (deepspeed_tpu/analysis/
#: profiles.py PROFILES); validated here so ``analysis.profile`` gives the
#: same errors in both packages
_PROFILE_NAMES = ("cpu-8", "v4-8", "v5e-8", "v5p-8")
#: the port's own profiles (deepspeed_tpu_torch/analysis/profiles.py); a
#: JAX name above resolves to the profile of the device the engine runs on
_PORT_PROFILE_NAMES = ("h100", "cpu")


def _resolve_profile(name) -> str:
    """Profile by name; bare generations default to the 8-device slice
    (``"v4"`` -> ``"v4-8"``), as in the JAX package."""
    key = str(name).strip().lower()
    if key in _PORT_PROFILE_NAMES:
        return key
    for cand in (key, f"{key}-8"):
        if cand in _PROFILE_NAMES:
            return cand
    # str(KeyError(msg)) is repr(msg): keep the JAX package's exact text
    raise DeepSpeedConfigError(str(KeyError(
        f"unknown backend profile {name!r}; known: "
        f"{sorted(_PROFILE_NAMES)}")))


def get_scalar_param(d: Mapping[str, Any], name: str, default):
    """Fetch ``name`` from dict with default (reference deepspeed_config.py:18-25)."""
    if d is None:
        return default
    return d.get(name, default)


class DeepSpeedConfigError(Exception):
    pass


def _fused_count(value, key_name: str, env_name: str) -> int:
    """Resolve a fused-dispatch count key (``train_steps_per_dispatch``
    K / ``inference.decode_iters_per_dispatch`` D) with its env escape
    hatch — ONE owner of the override policy so the two knobs cannot
    drift: ``off``/``false``/``0`` force 1, an integer overrides, and
    the resolved count must be >= 1."""
    env = os.environ.get(env_name, "").strip().lower()
    if env in ("off", "false", "0"):
        value = 1
    elif env:
        try:
            value = int(env)
        except ValueError:
            raise DeepSpeedConfigError(
                f"{env_name}={env!r} is not a count: use 'off' or an "
                f"integer >= 1")
    try:
        value = int(value)
    except (TypeError, ValueError):
        raise DeepSpeedConfigError(
            f"{key_name} must be an integer >= 1, got {value!r}")
    if value < 1:
        raise DeepSpeedConfigError(
            f"{key_name} must be >= 1 (1 = the unfused per-step path), "
            f"got {value}")
    return value


class FP16Params:
    """fp16 section (reference deepspeed_constants.py:84-118)."""

    def __init__(self, param_dict: Mapping[str, Any]):
        sub = param_dict.get(C.FP16, None)
        self.enabled = get_scalar_param(sub, C.FP16_ENABLED, C.FP16_ENABLED_DEFAULT)
        self.loss_scale = get_scalar_param(sub, C.FP16_LOSS_SCALE, C.FP16_LOSS_SCALE_DEFAULT)
        self.initial_scale_power = get_scalar_param(
            sub, C.FP16_INITIAL_SCALE_POWER, C.FP16_INITIAL_SCALE_POWER_DEFAULT)
        self.loss_scale_window = get_scalar_param(
            sub, C.FP16_LOSS_SCALE_WINDOW, C.FP16_LOSS_SCALE_WINDOW_DEFAULT)
        self.hysteresis = get_scalar_param(sub, C.FP16_HYSTERESIS, C.FP16_HYSTERESIS_DEFAULT)
        self.min_loss_scale = get_scalar_param(
            sub, C.FP16_MIN_LOSS_SCALE, C.FP16_MIN_LOSS_SCALE_DEFAULT)

    @property
    def dynamic_loss_scale(self) -> bool:
        return self.loss_scale == 0


class TensorboardParams:
    def __init__(self, param_dict: Mapping[str, Any]):
        sub = param_dict.get(C.TENSORBOARD, None)
        self.enabled = get_scalar_param(sub, C.TENSORBOARD_ENABLED, C.TENSORBOARD_ENABLED_DEFAULT)
        self.output_path = get_scalar_param(
            sub, C.TENSORBOARD_OUTPUT_PATH, C.TENSORBOARD_OUTPUT_PATH_DEFAULT)
        self.job_name = get_scalar_param(
            sub, C.TENSORBOARD_JOB_NAME, C.TENSORBOARD_JOB_NAME_DEFAULT)


class DeepSpeedConfig:
    """Flat-attribute config object (reference deepspeed_config.py:234-330).

    Args:
      config: path to a JSON file or an already-parsed dict.
      dp_world_size: size of the data-parallel mesh axis.  The reference derives
        this from torch.distributed / the mpu (deepspeed_config.py:236-250);
        here the engine passes it from the mesh.
    """

    def __init__(self, config, dp_world_size: Optional[int] = None):
        if isinstance(config, str):
            try:
                with open(config, "r") as f:
                    self._param_dict = json.load(f)
            except Exception as e:
                raise DeepSpeedConfigError(
                    f"Could not read DeepSpeed config file {config!r}: {e}")
        elif isinstance(config, Mapping):
            self._param_dict = dict(config)
        else:
            raise DeepSpeedConfigError(
                f"config must be a JSON path or dict, got {type(config)}")

        self.world_size = dp_world_size if dp_world_size is not None else 1
        self._initialize_params(self._param_dict)
        self._set_batch_related_parameters()
        self._do_error_check()
        self._do_warning_check()

    # ------------------------------------------------------------------ params

    def _initialize_params(self, pd: Mapping[str, Any]):
        self.train_batch_size = get_scalar_param(
            pd, C.TRAIN_BATCH_SIZE, C.TRAIN_BATCH_SIZE_DEFAULT)
        self.train_micro_batch_size_per_gpu = get_scalar_param(
            pd, C.TRAIN_MICRO_BATCH_SIZE_PER_GPU, C.TRAIN_MICRO_BATCH_SIZE_PER_GPU_DEFAULT)
        self.gradient_accumulation_steps = get_scalar_param(
            pd, C.GRADIENT_ACCUMULATION_STEPS, C.GRADIENT_ACCUMULATION_STEPS_DEFAULT)
        self.steps_per_print = get_scalar_param(
            pd, C.STEPS_PER_PRINT, C.STEPS_PER_PRINT_DEFAULT)
        self.dump_state = get_scalar_param(pd, C.DUMP_STATE, C.DUMP_STATE_DEFAULT)

        # on-device multi-step driver: K optimizer steps fused into ONE
        # compiled dispatch (engine.train_many; docs/features.md
        # "Multi-step driver").  DSTPU_MULTISTEP is the env escape hatch:
        # "off"/"0" force the per-step path, an integer overrides K.
        self.train_steps_per_dispatch = _fused_count(
            get_scalar_param(pd, C.TRAIN_STEPS_PER_DISPATCH,
                             C.TRAIN_STEPS_PER_DISPATCH_DEFAULT),
            C.TRAIN_STEPS_PER_DISPATCH, "DSTPU_MULTISTEP")

        self.disable_allgather = get_scalar_param(
            pd, C.DISABLE_ALLGATHER, C.DISABLE_ALLGATHER_DEFAULT)
        self.allgather_size = get_scalar_param(pd, C.ALLGATHER_SIZE, C.ALLGATHER_SIZE_DEFAULT)
        self.fp32_allreduce = get_scalar_param(pd, C.FP32_ALLREDUCE, C.FP32_ALLREDUCE_DEFAULT)
        self.prescale_gradients = get_scalar_param(
            pd, C.PRESCALE_GRADIENTS, C.PRESCALE_GRADIENTS_DEFAULT)
        self.gradient_predivide_factor = get_scalar_param(
            pd, C.GRADIENT_PREDIVIDE_FACTOR, C.GRADIENT_PREDIVIDE_FACTOR_DEFAULT)
        self.sparse_gradients_enabled = get_scalar_param(
            pd, C.SPARSE_GRADIENTS, C.SPARSE_GRADIENTS_DEFAULT)
        # beyond-reference: background checkpoint writes (the stall is the
        # device→host snapshot only; see checkpoint.save_checkpoint) and the
        # parallel streaming restore (reader pool + readahead window on the
        # preemption-resume critical path; docs/resilience.md)
        ckpt_sec = pd.get(C.CHECKPOINT, {}) or {}
        if not isinstance(ckpt_sec, dict):
            raise DeepSpeedConfigError(
                f"'{C.CHECKPOINT}' must be a JSON object, got {ckpt_sec!r}")
        ckpt_known = {C.CHECKPOINT_ASYNC_SAVE, C.CHECKPOINT_RESTORE_THREADS,
                      C.CHECKPOINT_RESTORE_READAHEAD_MB}
        if set(ckpt_sec) - ckpt_known:
            # a typo'd restore knob would silently run the default path —
            # loud, like the resilience section
            raise DeepSpeedConfigError(
                f"unknown {C.CHECKPOINT} key(s) "
                f"{sorted(set(ckpt_sec) - ckpt_known)}; supported: "
                f"{sorted(ckpt_known)}")
        self.checkpoint_async_save = bool(ckpt_sec.get(
            C.CHECKPOINT_ASYNC_SAVE, C.CHECKPOINT_ASYNC_SAVE_DEFAULT))
        self.checkpoint_restore_threads = int(ckpt_sec.get(
            C.CHECKPOINT_RESTORE_THREADS,
            C.CHECKPOINT_RESTORE_THREADS_DEFAULT))
        if self.checkpoint_restore_threads < 0:
            raise DeepSpeedConfigError(
                f"{C.CHECKPOINT}.{C.CHECKPOINT_RESTORE_THREADS} must be "
                f">= 0 (0 = auto, 1 = serial fallback), got "
                f"{self.checkpoint_restore_threads}")
        try:
            self.checkpoint_restore_readahead_mb = float(ckpt_sec.get(
                C.CHECKPOINT_RESTORE_READAHEAD_MB,
                C.CHECKPOINT_RESTORE_READAHEAD_MB_DEFAULT))
        except (TypeError, ValueError):
            raise DeepSpeedConfigError(
                f"{C.CHECKPOINT}.{C.CHECKPOINT_RESTORE_READAHEAD_MB} must "
                f"be a number of megabytes")
        if self.checkpoint_restore_readahead_mb <= 0:
            raise DeepSpeedConfigError(
                f"{C.CHECKPOINT}.{C.CHECKPOINT_RESTORE_READAHEAD_MB} must "
                f"be > 0 (got {self.checkpoint_restore_readahead_mb})")

        # persistent compilation cache: a relaunched worker reuses the prior
        # attempt's compiled step programs (utils/compile_cache.py; the
        # engine enables it at build, before any step function traces)
        cc = pd.get(C.COMPILE_CACHE, None)
        if isinstance(cc, str):
            cc = {C.COMPILE_CACHE_DIR: cc}       # bare-string shorthand
        if cc is not None and not isinstance(cc, Mapping):
            raise DeepSpeedConfigError(
                f"'{C.COMPILE_CACHE}' must be a directory string or an "
                f"object {{'dir': ..., 'min_entry_size_bytes': ...}}, got "
                f"{cc!r}")
        cc_known = {C.COMPILE_CACHE_DIR, C.COMPILE_CACHE_MIN_ENTRY_SIZE_BYTES}
        if cc is not None and set(cc) - cc_known:
            raise DeepSpeedConfigError(
                f"unknown {C.COMPILE_CACHE} key(s) "
                f"{sorted(set(cc) - cc_known)}; supported: "
                f"{sorted(cc_known)}")
        self.compile_cache_dir = get_scalar_param(
            cc, C.COMPILE_CACHE_DIR, C.COMPILE_CACHE_DIR_DEFAULT)
        if self.compile_cache_dir is not None \
                and not isinstance(self.compile_cache_dir, str):
            raise DeepSpeedConfigError(
                f"{C.COMPILE_CACHE}.{C.COMPILE_CACHE_DIR} must be a "
                f"directory path string, got {self.compile_cache_dir!r}")
        self.compile_cache_min_entry_size_bytes = int(get_scalar_param(
            cc, C.COMPILE_CACHE_MIN_ENTRY_SIZE_BYTES,
            C.COMPILE_CACHE_MIN_ENTRY_SIZE_BYTES_DEFAULT))
        if self.compile_cache_min_entry_size_bytes < 0:
            raise DeepSpeedConfigError(
                f"{C.COMPILE_CACHE}.{C.COMPILE_CACHE_MIN_ENTRY_SIZE_BYTES} "
                f"must be >= 0")
        self.pipeline_parallel_size = get_scalar_param(
            pd, C.PIPELINE_PARALLEL_SIZE, C.PIPELINE_PARALLEL_SIZE_DEFAULT)
        self.pipeline_schedule = get_scalar_param(
            pd, C.PIPELINE_SCHEDULE, C.PIPELINE_SCHEDULE_DEFAULT)
        if self.pipeline_schedule not in (None, "gpipe", "1f1b"):
            raise DeepSpeedConfigError(
                f"{C.PIPELINE_SCHEDULE} must be 'gpipe' or '1f1b', got "
                f"{self.pipeline_schedule!r}")
        self.sequence_parallel_impl = get_scalar_param(
            pd, C.SEQUENCE_PARALLEL_IMPL, C.SEQUENCE_PARALLEL_IMPL_DEFAULT)
        if self.sequence_parallel_impl not in (None, "ring", "ulysses"):
            raise DeepSpeedConfigError(
                f"{C.SEQUENCE_PARALLEL_IMPL} must be 'ring' or 'ulysses', "
                f"got {self.sequence_parallel_impl!r}")
        self.sparse_gradients_max_rows = get_scalar_param(
            pd, C.SPARSE_GRADIENTS_MAX_ROWS,
            C.SPARSE_GRADIENTS_MAX_ROWS_DEFAULT)

        # zero_optimization is a plain boolean in the reference (v0.1.0,
        # deepspeed_constants.py:137-146); also accept {"stage": N} spelling.
        zero = get_scalar_param(pd, C.ZERO_OPTIMIZATION, C.ZERO_OPTIMIZATION_DEFAULT)
        if isinstance(zero, Mapping):
            self.zero_stage = int(zero.get("stage", 0))
            if self.zero_stage not in (0, 1, 2, 3):
                raise DeepSpeedConfigError(
                    f"zero_optimization.stage must be 0-3 (2 = gradient "
                    f"partitioning, 3 = parameter partitioning), got "
                    f"{self.zero_stage}")
            self.zero_enabled = self.zero_stage > 0
            self.zero_parameter_parallel_size = zero.get(
                C.ZERO_PARAMETER_PARALLEL_SIZE, C.ZERO_PARAMETER_PARALLEL_SIZE_DEFAULT)
            self.zero_overlap_comm = bool(zero.get(
                C.ZERO_OVERLAP_COMM, C.ZERO_OVERLAP_COMM_DEFAULT))
            self.zero_comm_bucket_mb = zero.get(
                C.ZERO_COMM_BUCKET_MB, C.ZERO_COMM_BUCKET_MB_DEFAULT)
        else:
            self.zero_enabled = bool(zero)
            self.zero_stage = 1 if self.zero_enabled else 0
            self.zero_parameter_parallel_size = C.ZERO_PARAMETER_PARALLEL_SIZE_DEFAULT
            # the overlap knobs also govern the plain-DP (stage-0) gradient
            # reduction, so they default on even without a zero section
            self.zero_overlap_comm = C.ZERO_OVERLAP_COMM_DEFAULT
            self.zero_comm_bucket_mb = C.ZERO_COMM_BUCKET_MB_DEFAULT
        try:
            self.zero_comm_bucket_mb = float(self.zero_comm_bucket_mb)
        except (TypeError, ValueError):
            raise DeepSpeedConfigError(
                f"zero_optimization.{C.ZERO_COMM_BUCKET_MB} must be a number "
                f"of megabytes, got {self.zero_comm_bucket_mb!r}")
        # a non-positive bucket is only an error when bucketing is actually
        # on — overlap_comm=false with the size zeroed out is a valid way
        # to spell "disabled"
        if self.zero_overlap_comm and self.zero_comm_bucket_mb <= 0:
            raise DeepSpeedConfigError(
                f"zero_optimization.{C.ZERO_COMM_BUCKET_MB} must be > 0 "
                f"(got {self.zero_comm_bucket_mb}); to disable bucketing set "
                f"{C.ZERO_OVERLAP_COMM}=false instead")

        self.gradient_clipping = get_scalar_param(
            pd, C.GRADIENT_CLIPPING, C.GRADIENT_CLIPPING_DEFAULT)

        self.fp16 = FP16Params(pd)
        self.fp16_enabled = self.fp16.enabled
        bf16_sub = pd.get(C.BF16, None)
        self.bf16_enabled = get_scalar_param(bf16_sub, C.BF16_ENABLED, C.BF16_ENABLED_DEFAULT)

        # loss-scale convenience attributes matching the reference getter facade
        # (deepspeed_light.py:252-276)
        self.loss_scale = self.fp16.loss_scale
        self.dynamic_loss_scale = self.fp16.dynamic_loss_scale
        self.dynamic_loss_scale_args = {
            "init_scale": 2 ** self.fp16.initial_scale_power,
            "scale_window": self.fp16.loss_scale_window,
            "delayed_shift": self.fp16.hysteresis,
            "min_scale": self.fp16.min_loss_scale,
        } if self.fp16.dynamic_loss_scale else None

        opt = pd.get(C.OPTIMIZER, None)
        self.optimizer_name = None
        self.optimizer_params = None
        self.optimizer_legacy_fusion = False
        self.optimizer_param_groups = None
        if opt is not None:
            name = opt.get(C.OPTIMIZER_TYPE, None)
            self.optimizer_name = name.lower() if isinstance(name, str) else name
            self.optimizer_params = dict(opt.get(C.OPTIMIZER_PARAMS, {}))
            self.optimizer_legacy_fusion = bool(opt.get("legacy_fusion", False))
            # pure-JSON spelling of initialize(param_groups=...) — same
            # entry dicts ({"params": <path regex>, "lr": ..., ...})
            groups = opt.get("param_groups", None)
            if groups is not None:
                if (not isinstance(groups, (list, tuple))
                        or not all(isinstance(g, Mapping) for g in groups)):
                    raise DeepSpeedConfigError(
                        "optimizer.param_groups must be a list of group "
                        "dicts ({'params': <pytree-path regex>, ...})")
                self.optimizer_param_groups = [dict(g) for g in groups]

        sched = pd.get(C.SCHEDULER, None)
        self.scheduler_name = None
        self.scheduler_params = None
        if sched is not None:
            self.scheduler_name = sched.get(C.SCHEDULER_TYPE, None)
            self.scheduler_params = dict(sched.get(C.SCHEDULER_PARAMS, {}))

        ac = get_scalar_param(pd, C.ACTIVATION_CHECKPOINTING,
                              C.ACTIVATION_CHECKPOINTING_DEFAULT)
        self.activation_checkpointing_policy = None   # None | "full" | "dots"
        if isinstance(ac, Mapping):
            self.activation_checkpointing_policy = ac.get("policy", None)
            ac = bool(ac.get("enabled", True))
        self.activation_checkpointing = ac    # None | bool

        self.wall_clock_breakdown = get_scalar_param(
            pd, C.WALL_CLOCK_BREAKDOWN, C.WALL_CLOCK_BREAKDOWN_DEFAULT)
        self.memory_breakdown = get_scalar_param(
            pd, C.MEMORY_BREAKDOWN, C.MEMORY_BREAKDOWN_DEFAULT)
        self.tensorboard = TensorboardParams(pd)
        self.tensorboard_enabled = self.tensorboard.enabled
        self.tensorboard_output_path = self.tensorboard.output_path
        self.tensorboard_job_name = self.tensorboard.job_name

        # graph lint: jaxpr static analysis at step-build time
        # (docs/analysis.md).  Accepts the {"mode": ..., "suppress": [...]}
        # section or the bare-string shorthand "graph_lint": "error".
        gl = pd.get(C.GRAPH_LINT, None)
        if isinstance(gl, str):
            gl = {C.GRAPH_LINT_MODE: gl}
        if gl is not None and not isinstance(gl, Mapping):
            raise DeepSpeedConfigError(
                f"'{C.GRAPH_LINT}' must be a mode string or an object "
                f"{{'mode': ..., 'suppress': [...]}}, got {gl!r}")
        self.graph_lint_mode = get_scalar_param(
            gl, C.GRAPH_LINT_MODE, C.GRAPH_LINT_MODE_DEFAULT)
        if self.graph_lint_mode not in ("off", "warn", "error"):
            raise DeepSpeedConfigError(
                f"{C.GRAPH_LINT}.{C.GRAPH_LINT_MODE} must be 'off', 'warn' "
                f"or 'error', got {self.graph_lint_mode!r}")
        sup = get_scalar_param(gl, C.GRAPH_LINT_SUPPRESS,
                               C.GRAPH_LINT_SUPPRESS_DEFAULT)
        if (not isinstance(sup, (list, tuple))
                or not all(isinstance(s, str) for s in sup)):
            raise DeepSpeedConfigError(
                f"{C.GRAPH_LINT}.{C.GRAPH_LINT_SUPPRESS} must be a list of "
                f"rule-code prefixes, got {sup!r}")
        self.graph_lint_suppress = list(sup)

        # capacity planner: static per-device peak-HBM + wire-cost
        # analysis at step-build time (analysis/memplan.py,
        # docs/analysis.md "Capacity planner").  Section shape mirrors
        # graph_lint: {"mode": ..., "memory_budget_gb": ...,
        # "profile": ..., "suppress": [...]}.
        an = pd.get(C.ANALYSIS, None)
        if an is not None and not isinstance(an, Mapping):
            raise DeepSpeedConfigError(
                f"'{C.ANALYSIS}' must be an object "
                f"{{'mode': ..., 'memory_budget_gb': ..., 'profile': ..., "
                f"'suppress': [...]}}, got {an!r}")
        an_known = {C.ANALYSIS_MODE, C.ANALYSIS_MEMORY_BUDGET_GB,
                    C.ANALYSIS_PROFILE, C.ANALYSIS_SUPPRESS,
                    C.ANALYSIS_CONCURRENCY}
        if an is not None and set(an) - an_known:
            # a typo'd budget key would silently run ungated — loud, like
            # the resilience section
            raise DeepSpeedConfigError(
                f"unknown {C.ANALYSIS} key(s) {sorted(set(an) - an_known)}; "
                f"supported: {sorted(an_known)}")
        self.analysis_mode = get_scalar_param(
            an, C.ANALYSIS_MODE, C.ANALYSIS_MODE_DEFAULT)
        if self.analysis_mode not in ("off", "warn", "error"):
            raise DeepSpeedConfigError(
                f"{C.ANALYSIS}.{C.ANALYSIS_MODE} must be 'off', 'warn' or "
                f"'error', got {self.analysis_mode!r}")
        budget = get_scalar_param(an, C.ANALYSIS_MEMORY_BUDGET_GB,
                                  C.ANALYSIS_MEMORY_BUDGET_GB_DEFAULT)
        if budget is not None:
            try:
                budget = float(budget)
            except (TypeError, ValueError):
                raise DeepSpeedConfigError(
                    f"{C.ANALYSIS}.{C.ANALYSIS_MEMORY_BUDGET_GB} must be a "
                    f"number of GiB, got {budget!r}")
            if budget <= 0:
                raise DeepSpeedConfigError(
                    f"{C.ANALYSIS}.{C.ANALYSIS_MEMORY_BUDGET_GB} must be "
                    f"> 0 (got {budget})")
        self.analysis_memory_budget_gb = budget
        profile = get_scalar_param(an, C.ANALYSIS_PROFILE,
                                   C.ANALYSIS_PROFILE_DEFAULT)
        if profile is not None:
            if not isinstance(profile, str):
                raise DeepSpeedConfigError(
                    f"{C.ANALYSIS}.{C.ANALYSIS_PROFILE} must be a profile "
                    f"name string, got {profile!r}")
            _resolve_profile(profile)
        self.analysis_profile = profile
        an_sup = get_scalar_param(an, C.ANALYSIS_SUPPRESS,
                                  C.ANALYSIS_SUPPRESS_DEFAULT)
        if (not isinstance(an_sup, (list, tuple))
                or not all(isinstance(s, str) for s in an_sup)):
            raise DeepSpeedConfigError(
                f"{C.ANALYSIS}.{C.ANALYSIS_SUPPRESS} must be a list of "
                f"rule-code prefixes, got {an_sup!r}")
        self.analysis_suppress = list(an_sup)

        # analysis.concurrency: the host-concurrency lint over the
        # serving control plane (analysis/concurrency.py), gated at
        # FleetRouter build.  A bare string is mode shorthand, like
        # graph_lint
        cc = an.get(C.ANALYSIS_CONCURRENCY) if an is not None else None
        if isinstance(cc, str):
            cc = {C.ANALYSIS_MODE: cc}
        if cc is not None and not isinstance(cc, Mapping):
            raise DeepSpeedConfigError(
                f"'{C.ANALYSIS}.{C.ANALYSIS_CONCURRENCY}' must be a mode "
                f"string or an object {{'mode': ..., 'suppress': [...]}}, "
                f"got {cc!r}")
        cc_known = {C.ANALYSIS_MODE, C.ANALYSIS_SUPPRESS}
        if cc is not None and set(cc) - cc_known:
            raise DeepSpeedConfigError(
                f"unknown {C.ANALYSIS}.{C.ANALYSIS_CONCURRENCY} key(s) "
                f"{sorted(set(cc) - cc_known)}; supported: "
                f"{sorted(cc_known)}")
        self.analysis_concurrency_mode = get_scalar_param(
            cc, C.ANALYSIS_MODE, C.ANALYSIS_CONCURRENCY_MODE_DEFAULT)
        if self.analysis_concurrency_mode not in ("off", "warn", "error"):
            raise DeepSpeedConfigError(
                f"{C.ANALYSIS}.{C.ANALYSIS_CONCURRENCY}.{C.ANALYSIS_MODE} "
                f"must be 'off', 'warn' or 'error', got "
                f"{self.analysis_concurrency_mode!r}")
        cc_sup = get_scalar_param(
            cc, C.ANALYSIS_SUPPRESS,
            C.ANALYSIS_CONCURRENCY_SUPPRESS_DEFAULT)
        if (not isinstance(cc_sup, (list, tuple))
                or not all(isinstance(s, str) for s in cc_sup)):
            raise DeepSpeedConfigError(
                f"{C.ANALYSIS}.{C.ANALYSIS_CONCURRENCY}."
                f"{C.ANALYSIS_SUPPRESS} must be a list of rule-code "
                f"prefixes, got {cc_sup!r}")
        self.analysis_concurrency_suppress = list(cc_sup)

        # resilience: preemption-safe training, hang watchdog, NaN
        # sentinel, storage retry (deepspeed_tpu/resilience/,
        # docs/resilience.md)
        res = pd.get(C.RESILIENCE, None)
        if res is not None and not isinstance(res, Mapping):
            raise DeepSpeedConfigError(
                f"'{C.RESILIENCE}' must be a JSON object, got {res!r}")
        known = {C.RESILIENCE_PREEMPT_SAVE, C.RESILIENCE_MAX_RESTARTS,
                 C.RESILIENCE_WATCHDOG_TIMEOUT_S,
                 C.RESILIENCE_WATCHDOG_ABORT, C.RESILIENCE_IO_RETRIES,
                 C.RESILIENCE_NAN_SENTINEL}
        if res is not None and set(res) - known:
            # a typo'd key here would silently run WITHOUT the intended
            # protection — the one config family where that must be loud
            raise DeepSpeedConfigError(
                f"unknown {C.RESILIENCE} key(s) {sorted(set(res) - known)}; "
                f"supported: {sorted(known)}")
        self.resilience_preempt_save = bool(get_scalar_param(
            res, C.RESILIENCE_PREEMPT_SAVE, C.RESILIENCE_PREEMPT_SAVE_DEFAULT))
        self.resilience_max_restarts = int(get_scalar_param(
            res, C.RESILIENCE_MAX_RESTARTS, C.RESILIENCE_MAX_RESTARTS_DEFAULT))
        self.resilience_watchdog_timeout_s = float(get_scalar_param(
            res, C.RESILIENCE_WATCHDOG_TIMEOUT_S,
            C.RESILIENCE_WATCHDOG_TIMEOUT_S_DEFAULT))
        self.resilience_watchdog_abort = bool(get_scalar_param(
            res, C.RESILIENCE_WATCHDOG_ABORT,
            C.RESILIENCE_WATCHDOG_ABORT_DEFAULT))
        self.resilience_io_retries = int(get_scalar_param(
            res, C.RESILIENCE_IO_RETRIES, C.RESILIENCE_IO_RETRIES_DEFAULT))
        self.resilience_nan_sentinel = bool(get_scalar_param(
            res, C.RESILIENCE_NAN_SENTINEL,
            C.RESILIENCE_NAN_SENTINEL_DEFAULT))
        if self.resilience_max_restarts < 0:
            raise DeepSpeedConfigError(
                f"{C.RESILIENCE}.{C.RESILIENCE_MAX_RESTARTS} must be >= 0")
        if self.resilience_watchdog_timeout_s < 0:
            raise DeepSpeedConfigError(
                f"{C.RESILIENCE}.{C.RESILIENCE_WATCHDOG_TIMEOUT_S} must be "
                f">= 0 (0 disables the watchdog)")
        if self.resilience_io_retries < 0:
            raise DeepSpeedConfigError(
                f"{C.RESILIENCE}.{C.RESILIENCE_IO_RETRIES} must be >= 0")

        # observability: spooled on-device metrics, step tracing, goodput
        # accounting (deepspeed_tpu/observability/, docs/observability.md)
        obs = pd.get(C.OBSERVABILITY, None)
        if obs is not None and not isinstance(obs, Mapping):
            raise DeepSpeedConfigError(
                f"'{C.OBSERVABILITY}' must be a JSON object, got {obs!r}")
        obs_known = {C.OBSERVABILITY_REPORT_WINDOW,
                     C.OBSERVABILITY_JSONL_PATH, C.OBSERVABILITY_TRACE_DIR,
                     C.OBSERVABILITY_TRACE_START_STEP,
                     C.OBSERVABILITY_TRACE_NUM_STEPS,
                     C.OBSERVABILITY_HANG_CAPTURE,
                     C.OBSERVABILITY_HANG_CAPTURE_S,
                     C.OBSERVABILITY_PLANNER_DRIFT,
                     C.OBSERVABILITY_FLOPS_PER_SAMPLE,
                     C.OBSERVABILITY_PEAK_TFLOPS,
                     C.OBSERVABILITY_FLEET,
                     C.OBSERVABILITY_FLEET_WAIT_S,
                     C.OBSERVABILITY_STRAGGLER_FACTOR,
                     C.OBSERVABILITY_SPIKE_FACTOR,
                     C.OBSERVABILITY_STARVATION_FRAC,
                     C.OBSERVABILITY_HEALTH_PORT,
                     C.OBSERVABILITY_FLIGHT_RECORDER,
                     C.OBSERVABILITY_FLIGHT_RECORDER_DIR}
        if obs is not None and set(obs) - obs_known:
            # a typo'd window/trace knob would silently run the legacy
            # fenced paths — loud, like the resilience section
            raise DeepSpeedConfigError(
                f"unknown {C.OBSERVABILITY} key(s) "
                f"{sorted(set(obs) - obs_known)}; supported: "
                f"{sorted(obs_known)}")
        def _obs_num(key, default, cast):
            val = get_scalar_param(obs, key, default)
            try:
                return cast(val)
            except (TypeError, ValueError):
                raise DeepSpeedConfigError(
                    f"{C.OBSERVABILITY}.{key} must be a number, got "
                    f"{val!r}")

        self.observability_report_window = _obs_num(
            C.OBSERVABILITY_REPORT_WINDOW,
            C.OBSERVABILITY_REPORT_WINDOW_DEFAULT, int)
        if self.observability_report_window < 0:
            raise DeepSpeedConfigError(
                f"{C.OBSERVABILITY}.{C.OBSERVABILITY_REPORT_WINDOW} must be "
                f">= 0 (0 disables the metric spool)")
        self.observability_jsonl_path = get_scalar_param(
            obs, C.OBSERVABILITY_JSONL_PATH,
            C.OBSERVABILITY_JSONL_PATH_DEFAULT)
        if self.observability_jsonl_path is not None \
                and not isinstance(self.observability_jsonl_path, str):
            raise DeepSpeedConfigError(
                f"{C.OBSERVABILITY}.{C.OBSERVABILITY_JSONL_PATH} must be a "
                f"path string, got {self.observability_jsonl_path!r}")
        if (self.observability_jsonl_path
                and self.observability_report_window < 1):
            # events are emitted at window drains only — without a window
            # the log would be created and stay empty forever, failing any
            # validator-gated workflow long after the misconfiguration
            raise DeepSpeedConfigError(
                f"{C.OBSERVABILITY}.{C.OBSERVABILITY_JSONL_PATH} requires "
                f"{C.OBSERVABILITY_REPORT_WINDOW} >= 1 (the JSONL event "
                f"log carries one line per drained metric window)")
        self.observability_trace_dir = get_scalar_param(
            obs, C.OBSERVABILITY_TRACE_DIR,
            C.OBSERVABILITY_TRACE_DIR_DEFAULT)
        if self.observability_trace_dir is not None \
                and not isinstance(self.observability_trace_dir, str):
            raise DeepSpeedConfigError(
                f"{C.OBSERVABILITY}.{C.OBSERVABILITY_TRACE_DIR} must be a "
                f"directory string, got {self.observability_trace_dir!r}")
        self.observability_trace_start_step = _obs_num(
            C.OBSERVABILITY_TRACE_START_STEP,
            C.OBSERVABILITY_TRACE_START_STEP_DEFAULT, int)
        self.observability_trace_num_steps = _obs_num(
            C.OBSERVABILITY_TRACE_NUM_STEPS,
            C.OBSERVABILITY_TRACE_NUM_STEPS_DEFAULT, int)
        if self.observability_trace_num_steps < 0:
            raise DeepSpeedConfigError(
                f"{C.OBSERVABILITY}.{C.OBSERVABILITY_TRACE_NUM_STEPS} must "
                f"be >= 0 (0 disables the scheduled capture window)")
        if (self.observability_trace_num_steps > 0
                and not self.observability_trace_dir):
            if not os.environ.get(ENV_TRACE_DIR):
                raise DeepSpeedConfigError(
                    f"{C.OBSERVABILITY}.{C.OBSERVABILITY_TRACE_NUM_STEPS} "
                    f"> 0 needs a trace destination: set "
                    f"{C.OBSERVABILITY_TRACE_DIR} or {ENV_TRACE_DIR}")
        self.observability_hang_capture = bool(get_scalar_param(
            obs, C.OBSERVABILITY_HANG_CAPTURE,
            C.OBSERVABILITY_HANG_CAPTURE_DEFAULT))
        self.observability_hang_capture_s = _obs_num(
            C.OBSERVABILITY_HANG_CAPTURE_S,
            C.OBSERVABILITY_HANG_CAPTURE_S_DEFAULT, float)
        if self.observability_hang_capture_s <= 0:
            raise DeepSpeedConfigError(
                f"{C.OBSERVABILITY}.{C.OBSERVABILITY_HANG_CAPTURE_S} must "
                f"be > 0")
        self.observability_planner_drift = bool(get_scalar_param(
            obs, C.OBSERVABILITY_PLANNER_DRIFT,
            C.OBSERVABILITY_PLANNER_DRIFT_DEFAULT))
        fps = get_scalar_param(obs, C.OBSERVABILITY_FLOPS_PER_SAMPLE,
                               C.OBSERVABILITY_FLOPS_PER_SAMPLE_DEFAULT)
        if fps is not None:
            try:
                fps = float(fps)
            except (TypeError, ValueError):
                raise DeepSpeedConfigError(
                    f"{C.OBSERVABILITY}.{C.OBSERVABILITY_FLOPS_PER_SAMPLE} "
                    f"must be a number of FLOPs, got {fps!r}")
            if fps <= 0:
                raise DeepSpeedConfigError(
                    f"{C.OBSERVABILITY}.{C.OBSERVABILITY_FLOPS_PER_SAMPLE} "
                    f"must be > 0")
        self.observability_flops_per_sample = fps
        ptf = get_scalar_param(obs, C.OBSERVABILITY_PEAK_TFLOPS,
                               C.OBSERVABILITY_PEAK_TFLOPS_DEFAULT)
        if ptf is not None:
            try:
                ptf = float(ptf)
            except (TypeError, ValueError):
                raise DeepSpeedConfigError(
                    f"{C.OBSERVABILITY}.{C.OBSERVABILITY_PEAK_TFLOPS} must "
                    f"be a number of TFLOP/s, got {ptf!r}")
            if ptf <= 0:
                raise DeepSpeedConfigError(
                    f"{C.OBSERVABILITY}.{C.OBSERVABILITY_PEAK_TFLOPS} must "
                    f"be > 0")
        self.observability_peak_tflops_per_chip = ptf

        # fleet observability: cross-host aggregation, straggler/anomaly
        # detection, live health endpoints, flight recorder
        # (docs/observability.md "Fleet view")
        self.observability_fleet = bool(get_scalar_param(
            obs, C.OBSERVABILITY_FLEET, C.OBSERVABILITY_FLEET_DEFAULT))
        if (self.observability_fleet
                and self.observability_report_window < 1):
            # fleet reports are derived from window drains — without a
            # window there is nothing to aggregate, ever
            raise DeepSpeedConfigError(
                f"{C.OBSERVABILITY}.{C.OBSERVABILITY_FLEET} requires "
                f"{C.OBSERVABILITY_REPORT_WINDOW} >= 1 (fleet events "
                f"aggregate per-host metric windows)")
        self.observability_fleet_wait_s = _obs_num(
            C.OBSERVABILITY_FLEET_WAIT_S,
            C.OBSERVABILITY_FLEET_WAIT_S_DEFAULT, float)
        if self.observability_fleet_wait_s <= 0:
            raise DeepSpeedConfigError(
                f"{C.OBSERVABILITY}.{C.OBSERVABILITY_FLEET_WAIT_S} must "
                f"be > 0 (the per-window aggregation deadline)")
        self.observability_straggler_factor = _obs_num(
            C.OBSERVABILITY_STRAGGLER_FACTOR,
            C.OBSERVABILITY_STRAGGLER_FACTOR_DEFAULT, float)
        if self.observability_straggler_factor <= 1.0:
            raise DeepSpeedConfigError(
                f"{C.OBSERVABILITY}.{C.OBSERVABILITY_STRAGGLER_FACTOR} "
                f"must be > 1 (1.0 would flag the median host)")
        self.observability_spike_factor = _obs_num(
            C.OBSERVABILITY_SPIKE_FACTOR,
            C.OBSERVABILITY_SPIKE_FACTOR_DEFAULT, float)
        if self.observability_spike_factor <= 1.0:
            raise DeepSpeedConfigError(
                f"{C.OBSERVABILITY}.{C.OBSERVABILITY_SPIKE_FACTOR} must "
                f"be > 1")
        self.observability_starvation_frac = _obs_num(
            C.OBSERVABILITY_STARVATION_FRAC,
            C.OBSERVABILITY_STARVATION_FRAC_DEFAULT, float)
        if not (0.0 < self.observability_starvation_frac <= 1.0):
            raise DeepSpeedConfigError(
                f"{C.OBSERVABILITY}.{C.OBSERVABILITY_STARVATION_FRAC} "
                f"must be in (0, 1]")
        self.observability_health_port = _obs_num(
            C.OBSERVABILITY_HEALTH_PORT,
            C.OBSERVABILITY_HEALTH_PORT_DEFAULT, int)
        if not (0 <= self.observability_health_port <= 65535):
            raise DeepSpeedConfigError(
                f"{C.OBSERVABILITY}.{C.OBSERVABILITY_HEALTH_PORT} must be "
                f"a port in [0, 65535] (0 disables; workers add their "
                f"process index)")
        self.observability_flight_recorder = _obs_num(
            C.OBSERVABILITY_FLIGHT_RECORDER,
            C.OBSERVABILITY_FLIGHT_RECORDER_DEFAULT, int)
        if self.observability_flight_recorder < 0:
            raise DeepSpeedConfigError(
                f"{C.OBSERVABILITY}.{C.OBSERVABILITY_FLIGHT_RECORDER} "
                f"must be >= 0 (entries; 0 disables the recorder)")
        self.observability_flight_recorder_dir = get_scalar_param(
            obs, C.OBSERVABILITY_FLIGHT_RECORDER_DIR,
            C.OBSERVABILITY_FLIGHT_RECORDER_DIR_DEFAULT)
        if self.observability_flight_recorder_dir is not None \
                and not isinstance(self.observability_flight_recorder_dir,
                                   str):
            raise DeepSpeedConfigError(
                f"{C.OBSERVABILITY}.{C.OBSERVABILITY_FLIGHT_RECORDER_DIR} "
                f"must be a directory string, got "
                f"{self.observability_flight_recorder_dir!r}")

        # inference serving: KV-cache layout/sizing, prefill bucket,
        # compute dtype, int8 weight quantization
        # (deepspeed_tpu/inference/, docs/inference.md)
        inf = pd.get(C.INFERENCE, None)
        if inf is not None and not isinstance(inf, Mapping):
            raise DeepSpeedConfigError(
                f"'{C.INFERENCE}' must be a JSON object, got {inf!r}")
        inf_known = {C.INFERENCE_MAX_SLOTS, C.INFERENCE_MAX_TOKENS,
                     C.INFERENCE_PREFILL_BUCKET, C.INFERENCE_KV_LAYOUT,
                     C.INFERENCE_PAGE_TOKENS, C.INFERENCE_DTYPE,
                     C.INFERENCE_QUANTIZE,
                     C.INFERENCE_DECODE_ITERS_PER_DISPATCH,
                     C.INFERENCE_PREFIX_REUSE, C.INFERENCE_POOL_PAGES,
                     C.INFERENCE_TAIL_BUCKET, C.INFERENCE_SPECULATIVE,
                     C.INFERENCE_OBSERVABILITY, C.INFERENCE_FLEET}
        if inf is not None and set(inf) - inf_known:
            # a typo'd serving knob would silently serve with defaults —
            # loud, like the resilience section
            raise DeepSpeedConfigError(
                f"unknown {C.INFERENCE} key(s) "
                f"{sorted(set(inf) - inf_known)}; supported: "
                f"{sorted(inf_known)}")

        def _inf_int(key, default):
            val = get_scalar_param(inf, key, default)
            try:
                return int(val)
            except (TypeError, ValueError):
                raise DeepSpeedConfigError(
                    f"{C.INFERENCE}.{key} must be an integer, got {val!r}")

        self.inference_max_slots = _inf_int(
            C.INFERENCE_MAX_SLOTS, C.INFERENCE_MAX_SLOTS_DEFAULT)
        if self.inference_max_slots < 0:
            raise DeepSpeedConfigError(
                f"{C.INFERENCE}.{C.INFERENCE_MAX_SLOTS} must be >= 0 "
                f"(0 = auto-size against the analysis profile)")
        self.inference_max_tokens = _inf_int(
            C.INFERENCE_MAX_TOKENS, C.INFERENCE_MAX_TOKENS_DEFAULT)
        if self.inference_max_tokens < 0:
            raise DeepSpeedConfigError(
                f"{C.INFERENCE}.{C.INFERENCE_MAX_TOKENS} must be >= 0 "
                f"(0 = the model's max_seq_len)")
        self.inference_prefill_bucket = _inf_int(
            C.INFERENCE_PREFILL_BUCKET, C.INFERENCE_PREFILL_BUCKET_DEFAULT)
        if self.inference_prefill_bucket < 0:
            raise DeepSpeedConfigError(
                f"{C.INFERENCE}.{C.INFERENCE_PREFILL_BUCKET} must be >= 0 "
                f"(0 = the cache capacity)")
        self.inference_kv_layout = get_scalar_param(
            inf, C.INFERENCE_KV_LAYOUT, C.INFERENCE_KV_LAYOUT_DEFAULT)
        if self.inference_kv_layout not in ("paged", "ring"):
            raise DeepSpeedConfigError(
                f"{C.INFERENCE}.{C.INFERENCE_KV_LAYOUT} must be 'paged' "
                f"or 'ring', got {self.inference_kv_layout!r}")
        self.inference_page_tokens = _inf_int(
            C.INFERENCE_PAGE_TOKENS, C.INFERENCE_PAGE_TOKENS_DEFAULT)
        if self.inference_page_tokens < 1:
            raise DeepSpeedConfigError(
                f"{C.INFERENCE}.{C.INFERENCE_PAGE_TOKENS} must be >= 1")
        self.inference_dtype = get_scalar_param(
            inf, C.INFERENCE_DTYPE, C.INFERENCE_DTYPE_DEFAULT)
        if not isinstance(self.inference_dtype, str):
            raise DeepSpeedConfigError(
                f"{C.INFERENCE}.{C.INFERENCE_DTYPE} must be a dtype name "
                f"string, got {self.inference_dtype!r}")
        self.inference_quantize = get_scalar_param(
            inf, C.INFERENCE_QUANTIZE, C.INFERENCE_QUANTIZE_DEFAULT)
        if self.inference_quantize not in (None, "int8"):
            raise DeepSpeedConfigError(
                f"{C.INFERENCE}.{C.INFERENCE_QUANTIZE} must be null or "
                f"'int8', got {self.inference_quantize!r}")
        # fused decode: D iterations per compiled dispatch (the serving
        # analog of train_steps_per_dispatch; docs/inference.md "Fused
        # decode").  DSTPU_DECODE_ITERS overrides, same policy as
        # DSTPU_MULTISTEP (_fused_count is the one owner).
        self.inference_decode_iters_per_dispatch = _fused_count(
            get_scalar_param(inf, C.INFERENCE_DECODE_ITERS_PER_DISPATCH,
                             C.INFERENCE_DECODE_ITERS_PER_DISPATCH_DEFAULT),
            f"{C.INFERENCE}.{C.INFERENCE_DECODE_ITERS_PER_DISPATCH}",
            "DSTPU_DECODE_ITERS")

        # prefix KV reuse over the refcounted page table + the tail
        # prefill bucket that makes a hit's FLOP saving real
        # (docs/inference.md "Prefix reuse")
        self.inference_prefix_reuse = bool(get_scalar_param(
            inf, C.INFERENCE_PREFIX_REUSE, C.INFERENCE_PREFIX_REUSE_DEFAULT))
        self.inference_pool_pages = _inf_int(
            C.INFERENCE_POOL_PAGES, C.INFERENCE_POOL_PAGES_DEFAULT)
        if self.inference_pool_pages < 0:
            raise DeepSpeedConfigError(
                f"{C.INFERENCE}.{C.INFERENCE_POOL_PAGES} must be >= 0 "
                f"(0 = slots * pages_per_slot, no overcommit)")
        self.inference_tail_bucket = _inf_int(
            C.INFERENCE_TAIL_BUCKET, C.INFERENCE_TAIL_BUCKET_DEFAULT)
        if self.inference_tail_bucket < 0:
            raise DeepSpeedConfigError(
                f"{C.INFERENCE}.{C.INFERENCE_TAIL_BUCKET} must be >= 0 "
                f"(0 = page_tokens)")

        # speculative decoding: J draft proposals + target verify fused
        # into one dispatch (docs/inference.md "Speculative decoding")
        spec = get_scalar_param(inf, C.INFERENCE_SPECULATIVE, None)
        if spec is not None and not isinstance(spec, Mapping):
            raise DeepSpeedConfigError(
                f"{C.INFERENCE}.{C.INFERENCE_SPECULATIVE} must be a JSON "
                f"object, got {spec!r}")
        spec_known = {C.INFERENCE_SPEC_DRAFT_TOKENS,
                      C.INFERENCE_SPEC_DRAFT_SIZE,
                      C.INFERENCE_SPEC_DRAFT_CHECKPOINT,
                      C.INFERENCE_SPEC_DRAFT_TAG}
        if spec is not None and set(spec) - spec_known:
            raise DeepSpeedConfigError(
                f"unknown {C.INFERENCE}.{C.INFERENCE_SPECULATIVE} key(s) "
                f"{sorted(set(spec) - spec_known)}; supported: "
                f"{sorted(spec_known)}")
        spec = spec or {}
        try:
            self.inference_spec_draft_tokens = int(spec.get(
                C.INFERENCE_SPEC_DRAFT_TOKENS,
                C.INFERENCE_SPEC_DRAFT_TOKENS_DEFAULT))
        except (TypeError, ValueError):
            raise DeepSpeedConfigError(
                f"{C.INFERENCE}.{C.INFERENCE_SPECULATIVE}."
                f"{C.INFERENCE_SPEC_DRAFT_TOKENS} must be an integer, got "
                f"{spec.get(C.INFERENCE_SPEC_DRAFT_TOKENS)!r}")
        if self.inference_spec_draft_tokens < 0:
            raise DeepSpeedConfigError(
                f"{C.INFERENCE}.{C.INFERENCE_SPECULATIVE}."
                f"{C.INFERENCE_SPEC_DRAFT_TOKENS} must be >= 0 (0 = off)")
        self.inference_spec_draft_size = spec.get(
            C.INFERENCE_SPEC_DRAFT_SIZE, C.INFERENCE_SPEC_DRAFT_SIZE_DEFAULT)
        self.inference_spec_draft_checkpoint = spec.get(
            C.INFERENCE_SPEC_DRAFT_CHECKPOINT,
            C.INFERENCE_SPEC_DRAFT_CHECKPOINT_DEFAULT)
        self.inference_spec_draft_tag = spec.get(
            C.INFERENCE_SPEC_DRAFT_TAG, C.INFERENCE_SPEC_DRAFT_TAG_DEFAULT)
        if self.inference_spec_draft_tokens > 0:
            if self.inference_decode_iters_per_dispatch > 1:
                raise DeepSpeedConfigError(
                    f"{C.INFERENCE}.{C.INFERENCE_SPECULATIVE} and "
                    f"{C.INFERENCE}."
                    f"{C.INFERENCE_DECODE_ITERS_PER_DISPATCH} > 1 both "
                    f"fuse the decode loop — pick one (the speculative "
                    f"dispatch already emits up to draft_tokens+1 tokens)")
            if self.inference_kv_layout == "ring":
                raise DeepSpeedConfigError(
                    f"{C.INFERENCE}.{C.INFERENCE_SPECULATIVE} requires "
                    f"the paged kv_layout: the multi-position verify "
                    f"step cannot wrap a ring window mid-block "
                    f"(docs/inference.md)")

        # fleet serving: the router layer over N replicas + optional
        # prefill/decode disaggregation (docs/inference.md "Fleet
        # serving").  The ENGINE reads only `disaggregate` (it gates the
        # KV export/import programs); the router reads the rest.
        fleet = get_scalar_param(inf, C.INFERENCE_FLEET, None)
        if fleet is not None and not isinstance(fleet, Mapping):
            raise DeepSpeedConfigError(
                f"{C.INFERENCE}.{C.INFERENCE_FLEET} must be a JSON "
                f"object, got {fleet!r}")
        fleet_known = {C.INFERENCE_FLEET_REPLICAS,
                       C.INFERENCE_FLEET_PREFILL_REPLICAS,
                       C.INFERENCE_FLEET_DISAGGREGATE,
                       C.INFERENCE_FLEET_HEALTH_PORT,
                       C.INFERENCE_FLEET_POLL_S,
                       C.INFERENCE_FLEET_AFFINITY,
                       C.INFERENCE_FLEET_HANDOFF_DIR,
                       C.INFERENCE_FLEET_JSONL_PATH}
        if fleet is not None and set(fleet) - fleet_known:
            raise DeepSpeedConfigError(
                f"unknown {C.INFERENCE}.{C.INFERENCE_FLEET} key(s) "
                f"{sorted(set(fleet) - fleet_known)}; supported: "
                f"{sorted(fleet_known)}")
        fleet = fleet or {}

        def _fleet_num(key, default, cast):
            val = fleet.get(key, default)
            try:
                return cast(val)
            except (TypeError, ValueError):
                raise DeepSpeedConfigError(
                    f"{C.INFERENCE}.{C.INFERENCE_FLEET}.{key} must be a "
                    f"number, got {val!r}")

        self.inference_fleet_replicas = _fleet_num(
            C.INFERENCE_FLEET_REPLICAS,
            C.INFERENCE_FLEET_REPLICAS_DEFAULT, int)
        if self.inference_fleet_replicas < 0:
            raise DeepSpeedConfigError(
                f"{C.INFERENCE}.{C.INFERENCE_FLEET}."
                f"{C.INFERENCE_FLEET_REPLICAS} must be >= 0 (0 = no "
                f"fleet)")
        self.inference_fleet_prefill_replicas = _fleet_num(
            C.INFERENCE_FLEET_PREFILL_REPLICAS,
            C.INFERENCE_FLEET_PREFILL_REPLICAS_DEFAULT, int)
        if self.inference_fleet_prefill_replicas < 0:
            raise DeepSpeedConfigError(
                f"{C.INFERENCE}.{C.INFERENCE_FLEET}."
                f"{C.INFERENCE_FLEET_PREFILL_REPLICAS} must be >= 0 "
                f"(0 = mixed pool)")
        if self.inference_fleet_replicas \
                and self.inference_fleet_prefill_replicas \
                >= self.inference_fleet_replicas:
            raise DeepSpeedConfigError(
                f"{C.INFERENCE}.{C.INFERENCE_FLEET}."
                f"{C.INFERENCE_FLEET_PREFILL_REPLICAS} "
                f"({self.inference_fleet_prefill_replicas}) must leave "
                f"at least one DECODE replica (replicas = "
                f"{self.inference_fleet_replicas})")
        self.inference_fleet_disaggregate = bool(fleet.get(
            C.INFERENCE_FLEET_DISAGGREGATE,
            C.INFERENCE_FLEET_DISAGGREGATE_DEFAULT))
        if self.inference_fleet_prefill_replicas > 0 \
                and not self.inference_fleet_disaggregate:
            raise DeepSpeedConfigError(
                f"{C.INFERENCE}.{C.INFERENCE_FLEET}."
                f"{C.INFERENCE_FLEET_PREFILL_REPLICAS} > 0 needs "
                f"{C.INFERENCE_FLEET_DISAGGREGATE}: true (the prefill "
                f"pool hands KV off through the export/import programs)")
        self.inference_fleet_health_port = _fleet_num(
            C.INFERENCE_FLEET_HEALTH_PORT,
            C.INFERENCE_FLEET_HEALTH_PORT_DEFAULT, int)
        if not (0 <= self.inference_fleet_health_port <= 65535):
            raise DeepSpeedConfigError(
                f"{C.INFERENCE}.{C.INFERENCE_FLEET}."
                f"{C.INFERENCE_FLEET_HEALTH_PORT} must be in [0, 65535]")
        self.inference_fleet_poll_s = _fleet_num(
            C.INFERENCE_FLEET_POLL_S, C.INFERENCE_FLEET_POLL_S_DEFAULT,
            float)
        if self.inference_fleet_poll_s <= 0:
            raise DeepSpeedConfigError(
                f"{C.INFERENCE}.{C.INFERENCE_FLEET}."
                f"{C.INFERENCE_FLEET_POLL_S} must be > 0")
        self.inference_fleet_affinity = bool(fleet.get(
            C.INFERENCE_FLEET_AFFINITY,
            C.INFERENCE_FLEET_AFFINITY_DEFAULT))
        self.inference_fleet_handoff_dir = fleet.get(
            C.INFERENCE_FLEET_HANDOFF_DIR,
            C.INFERENCE_FLEET_HANDOFF_DIR_DEFAULT)
        if self.inference_fleet_handoff_dir is not None \
                and not isinstance(self.inference_fleet_handoff_dir, str):
            raise DeepSpeedConfigError(
                f"{C.INFERENCE}.{C.INFERENCE_FLEET}."
                f"{C.INFERENCE_FLEET_HANDOFF_DIR} must be a directory "
                f"string, got {self.inference_fleet_handoff_dir!r}")
        self.inference_fleet_jsonl_path = fleet.get(
            C.INFERENCE_FLEET_JSONL_PATH,
            C.INFERENCE_FLEET_JSONL_PATH_DEFAULT)
        if self.inference_fleet_jsonl_path is not None \
                and not isinstance(self.inference_fleet_jsonl_path, str):
            raise DeepSpeedConfigError(
                f"{C.INFERENCE}.{C.INFERENCE_FLEET}."
                f"{C.INFERENCE_FLEET_JSONL_PATH} must be a path string, "
                f"got {self.inference_fleet_jsonl_path!r}")

        # replica observability: request events, live endpoints, the
        # serve watchdog and anomaly detectors (docs/observability.md
        # "Serving view") — all host-side, trajectory-neutral
        obs = get_scalar_param(inf, C.INFERENCE_OBSERVABILITY, None)
        if obs is not None and not isinstance(obs, Mapping):
            raise DeepSpeedConfigError(
                f"{C.INFERENCE}.{C.INFERENCE_OBSERVABILITY} must be a "
                f"JSON object, got {obs!r}")
        obs_known = {C.INFERENCE_OBS_WINDOW_ITERS,
                     C.INFERENCE_OBS_JSONL_PATH,
                     C.INFERENCE_OBS_REQUEST_EVENTS,
                     C.INFERENCE_OBS_HEALTH_PORT,
                     C.INFERENCE_OBS_WATCHDOG_TIMEOUT_S,
                     C.INFERENCE_OBS_WATCHDOG_ABORT,
                     C.INFERENCE_OBS_FLIGHT_RECORDER_DIR,
                     C.INFERENCE_OBS_STARVATION_WINDOWS,
                     C.INFERENCE_OBS_ACCEPT_FLOOR,
                     C.INFERENCE_OBS_THRASH_RECLAIMS}
        if obs is not None and set(obs) - obs_known:
            raise DeepSpeedConfigError(
                f"unknown {C.INFERENCE}.{C.INFERENCE_OBSERVABILITY} "
                f"key(s) {sorted(set(obs) - obs_known)}; supported: "
                f"{sorted(obs_known)}")
        obs = obs or {}

        def _obs_inf_num(key, default, cast):
            val = obs.get(key, default)
            try:
                return cast(val)
            except (TypeError, ValueError):
                raise DeepSpeedConfigError(
                    f"{C.INFERENCE}.{C.INFERENCE_OBSERVABILITY}.{key} "
                    f"must be a number, got {val!r}")

        self.inference_obs_window_iters = _obs_inf_num(
            C.INFERENCE_OBS_WINDOW_ITERS,
            C.INFERENCE_OBS_WINDOW_ITERS_DEFAULT, int)
        if self.inference_obs_window_iters < 1:
            raise DeepSpeedConfigError(
                f"{C.INFERENCE}.{C.INFERENCE_OBSERVABILITY}."
                f"{C.INFERENCE_OBS_WINDOW_ITERS} must be >= 1")
        self.inference_obs_jsonl_path = obs.get(
            C.INFERENCE_OBS_JSONL_PATH, C.INFERENCE_OBS_JSONL_PATH_DEFAULT)
        if self.inference_obs_jsonl_path is not None \
                and not isinstance(self.inference_obs_jsonl_path, str):
            raise DeepSpeedConfigError(
                f"{C.INFERENCE}.{C.INFERENCE_OBSERVABILITY}."
                f"{C.INFERENCE_OBS_JSONL_PATH} must be a path string, "
                f"got {self.inference_obs_jsonl_path!r}")
        self.inference_obs_request_events = bool(obs.get(
            C.INFERENCE_OBS_REQUEST_EVENTS,
            C.INFERENCE_OBS_REQUEST_EVENTS_DEFAULT))
        self.inference_obs_health_port = _obs_inf_num(
            C.INFERENCE_OBS_HEALTH_PORT,
            C.INFERENCE_OBS_HEALTH_PORT_DEFAULT, int)
        if not (0 <= self.inference_obs_health_port <= 65535):
            raise DeepSpeedConfigError(
                f"{C.INFERENCE}.{C.INFERENCE_OBSERVABILITY}."
                f"{C.INFERENCE_OBS_HEALTH_PORT} must be in [0, 65535]")
        self.inference_obs_watchdog_timeout_s = _obs_inf_num(
            C.INFERENCE_OBS_WATCHDOG_TIMEOUT_S,
            C.INFERENCE_OBS_WATCHDOG_TIMEOUT_S_DEFAULT, float)
        if self.inference_obs_watchdog_timeout_s < 0:
            raise DeepSpeedConfigError(
                f"{C.INFERENCE}.{C.INFERENCE_OBSERVABILITY}."
                f"{C.INFERENCE_OBS_WATCHDOG_TIMEOUT_S} must be >= 0 "
                f"(0 = off)")
        self.inference_obs_watchdog_abort = bool(obs.get(
            C.INFERENCE_OBS_WATCHDOG_ABORT,
            C.INFERENCE_OBS_WATCHDOG_ABORT_DEFAULT))
        self.inference_obs_flight_recorder_dir = obs.get(
            C.INFERENCE_OBS_FLIGHT_RECORDER_DIR,
            C.INFERENCE_OBS_FLIGHT_RECORDER_DIR_DEFAULT)
        if self.inference_obs_flight_recorder_dir is not None \
                and not isinstance(self.inference_obs_flight_recorder_dir,
                                   str):
            raise DeepSpeedConfigError(
                f"{C.INFERENCE}.{C.INFERENCE_OBSERVABILITY}."
                f"{C.INFERENCE_OBS_FLIGHT_RECORDER_DIR} must be a "
                f"directory string, got "
                f"{self.inference_obs_flight_recorder_dir!r}")
        self.inference_obs_starvation_windows = _obs_inf_num(
            C.INFERENCE_OBS_STARVATION_WINDOWS,
            C.INFERENCE_OBS_STARVATION_WINDOWS_DEFAULT, int)
        if self.inference_obs_starvation_windows < 0:
            raise DeepSpeedConfigError(
                f"{C.INFERENCE}.{C.INFERENCE_OBSERVABILITY}."
                f"{C.INFERENCE_OBS_STARVATION_WINDOWS} must be >= 0 "
                f"(0 = off)")
        self.inference_obs_accept_floor = _obs_inf_num(
            C.INFERENCE_OBS_ACCEPT_FLOOR,
            C.INFERENCE_OBS_ACCEPT_FLOOR_DEFAULT, float)
        if not (0.0 <= self.inference_obs_accept_floor < 1.0):
            raise DeepSpeedConfigError(
                f"{C.INFERENCE}.{C.INFERENCE_OBSERVABILITY}."
                f"{C.INFERENCE_OBS_ACCEPT_FLOOR} must be in [0, 1) "
                f"(0 = off)")
        self.inference_obs_thrash_reclaims = _obs_inf_num(
            C.INFERENCE_OBS_THRASH_RECLAIMS,
            C.INFERENCE_OBS_THRASH_RECLAIMS_DEFAULT, int)
        if self.inference_obs_thrash_reclaims < 0:
            raise DeepSpeedConfigError(
                f"{C.INFERENCE}.{C.INFERENCE_OBSERVABILITY}."
                f"{C.INFERENCE_OBS_THRASH_RECLAIMS} must be >= 0 "
                f"(0 = off)")

        # jax.profiler trace window (TPU tracing analog of
        # wall_clock_breakdown; trace viewable in TensorBoard/Perfetto)
        prof = pd.get(C.PROFILE, None) or {}
        self.profile_enabled = bool(prof.get(C.PROFILE_ENABLED,
                                             C.PROFILE_ENABLED_DEFAULT))
        self.profile_start_step = int(prof.get(C.PROFILE_START_STEP,
                                               C.PROFILE_START_STEP_DEFAULT))
        self.profile_end_step = int(prof.get(C.PROFILE_END_STEP,
                                             C.PROFILE_END_STEP_DEFAULT))
        self.profile_output_path = str(prof.get(
            C.PROFILE_OUTPUT_PATH, C.PROFILE_OUTPUT_PATH_DEFAULT))
        if self.profile_enabled and \
                self.profile_end_step <= self.profile_start_step:
            raise DeepSpeedConfigError(
                "profile.end_step must be greater than profile.start_step")
        if self.profile_enabled and self.observability_trace_num_steps > 0:
            # two owners of jax.profiler.start_trace would race; the
            # observability section is the maintained spelling
            raise DeepSpeedConfigError(
                f"the legacy '{C.PROFILE}' section and "
                f"{C.OBSERVABILITY}.{C.OBSERVABILITY_TRACE_NUM_STEPS} both "
                f"schedule a profiler capture window — use the "
                f"'{C.OBSERVABILITY}' section only (docs/observability.md)")

        self.model_parallel_size = get_scalar_param(
            pd, C.MODEL_PARALLEL_SIZE, C.MODEL_PARALLEL_SIZE_DEFAULT)
        self.context_parallel_size = get_scalar_param(
            pd, C.CONTEXT_PARALLEL_SIZE, C.CONTEXT_PARALLEL_SIZE_DEFAULT)

    # ----------------------------------------------------------- batch triangle

    def _batch_assertion(self):
        """All three set: assert positivity + the product identity
        (reference deepspeed_config.py:292-310)."""
        train_batch = self.train_batch_size
        micro_batch = self.train_micro_batch_size_per_gpu
        grad_acc = self.gradient_accumulation_steps
        if not train_batch > 0:
            raise DeepSpeedConfigError(
                f"Train batch size: {train_batch} has to be greater than 0")
        if not micro_batch > 0:
            raise DeepSpeedConfigError(
                f"Micro batch size per gpu: {micro_batch} has to be greater than 0")
        if not grad_acc > 0:
            raise DeepSpeedConfigError(
                f"Gradient accumulation steps: {grad_acc} has to be greater than 0")
        if train_batch != micro_batch * grad_acc * self.world_size:
            raise DeepSpeedConfigError(
                f"Check batch related parameters. train_batch_size is not equal"
                f" to micro_batch_per_gpu * gradient_acc_step * world_size"
                f" {train_batch} != {micro_batch} * {grad_acc} * {self.world_size}")

    def _set_batch_related_parameters(self):
        """Infer whichever of the batch triple is missing
        (reference deepspeed_config.py:312-366)."""
        train_batch = self.train_batch_size
        micro_batch = self.train_micro_batch_size_per_gpu
        grad_acc = self.gradient_accumulation_steps

        # all provided or none
        if all(x is not None for x in (train_batch, micro_batch, grad_acc)):
            self._batch_assertion()
        elif train_batch is not None and micro_batch is not None:
            grad_acc = train_batch // micro_batch
            grad_acc //= self.world_size
            self.gradient_accumulation_steps = grad_acc
            self._batch_assertion()
        elif train_batch is not None and grad_acc is not None:
            micro_batch = train_batch // self.world_size
            micro_batch //= grad_acc
            self.train_micro_batch_size_per_gpu = micro_batch
            self._batch_assertion()
        elif train_batch is not None:
            self.gradient_accumulation_steps = 1
            self.train_micro_batch_size_per_gpu = train_batch // self.world_size
            self._batch_assertion()
        elif micro_batch is not None:
            if grad_acc is None:
                self.gradient_accumulation_steps = 1
            self.train_batch_size = (self.train_micro_batch_size_per_gpu
                                     * self.gradient_accumulation_steps
                                     * self.world_size)
            self._batch_assertion()
        else:
            raise DeepSpeedConfigError(
                "Either train_batch_size or train_micro_batch_size_per_gpu"
                " needs to be provided")

    # ---------------------------------------------------------------- checking

    def _do_error_check(self):
        if self.zero_enabled:
            # Reference requires fp16 for ZeRO (deepspeed_config.py:388-389);
            # on TPU bf16 satisfies the same "low-precision model weights +
            # fp32 sharded masters" contract.
            if not (self.fp16_enabled or self.bf16_enabled):
                raise DeepSpeedConfigError(
                    "DeepSpeedConfig: ZeRO is only supported if fp16 or bf16 is enabled")
        if self.fp16_enabled and self.bf16_enabled:
            raise DeepSpeedConfigError(
                "DeepSpeedConfig: fp16 and bf16 cannot both be enabled")
        if not self.gradient_accumulation_steps:
            raise DeepSpeedConfigError(
                "DeepSpeedConfig: gradient_accumulation_steps is not defined")
        if (self.sparse_gradients_enabled
                and int(self.sparse_gradients_max_rows) <= 0):
            raise DeepSpeedConfigError(
                "DeepSpeedConfig: sparse_gradients_max_rows must be > 0 "
                f"(got {self.sparse_gradients_max_rows}); a non-positive "
                "bound would silently force the dense fallback every step")
        if (self.train_steps_per_dispatch > 1
                and self.observability_report_window >= 1
                and self.observability_report_window
                % self.train_steps_per_dispatch != 0):
            # the spool ring drains on window edges; a K-fused dispatch
            # appends K rows at once, so a window that is not a multiple
            # of K would cross an edge MID-dispatch and overrun the ring
            # before the drain can run (docs/observability.md "Window
            # alignment")
            raise DeepSpeedConfigError(
                f"DeepSpeedConfig: {C.OBSERVABILITY}."
                f"{C.OBSERVABILITY_REPORT_WINDOW} "
                f"({self.observability_report_window}) must be a multiple "
                f"of {C.TRAIN_STEPS_PER_DISPATCH} "
                f"({self.train_steps_per_dispatch}): the metric spool "
                f"drains on window edges and a K-fused dispatch appends K "
                f"rows per call")

    def _do_warning_check(self):
        """Reference deepspeed_config.py:395-421."""
        fp16_enabled = self.fp16_enabled or self.zero_enabled
        if self.gradient_clipping > 0.0 and not fp16_enabled:
            logger.warning(
                "DeepSpeedConfig: gradient clipping enabled without FP16 enabled.")
        vocabulary_size = self._param_dict.get("vocabulary_size", None)
        if vocabulary_size and vocabulary_size % C.MXU_ALIGN_SIZE != 0:
            # Reference warns at align 8 for tensor cores
            # (deepspeed_config.py:402-407); the MXU wants multiples of 128.
            logger.warning(
                "DeepSpeedConfig: vocabulary size %d is not aligned to %d, "
                "may import MXU padding overhead", vocabulary_size, C.MXU_ALIGN_SIZE)
        if (self.optimizer_params is not None
                and C.MAX_GRAD_NORM in self.optimizer_params
                and self.optimizer_params[C.MAX_GRAD_NORM] > 0):
            if fp16_enabled:
                # fp16 mode: pass max_grad_norm through to the fp16 wrapper as
                # the clipping threshold (reference deepspeed_config.py:411-415)
                logger.warning(
                    "DeepSpeedConfig: In FP16 mode, DeepSpeed will pass %s:%s "
                    "to FP16 wrapper", C.MAX_GRAD_NORM,
                    self.optimizer_params[C.MAX_GRAD_NORM])
            else:
                # fp32 mode: not permitted, zero it out
                # (reference deepspeed_config.py:416-421)
                logger.warning(
                    "DeepSpeedConfig: In FP32 mode, DeepSpeed does not permit "
                    "MAX_GRAD_NORM (%s) > 0, setting to zero",
                    self.optimizer_params[C.MAX_GRAD_NORM])
                self.optimizer_params[C.MAX_GRAD_NORM] = 0.0

    # ----------------------------------------------------------------- display

    def print(self, name: str = "DeepSpeedConfig"):
        """Pretty dump (reference deepspeed_config.py:368-385)."""
        logger.info("%s is:", name)
        for key in sorted(vars(self)):
            if key.startswith("_"):
                continue
            logger.info("  %s %s", (key + " " * 30)[:30], getattr(self, key))
        logger.info("  json = %s", json.dumps(self._param_dict, sort_keys=True, indent=2))
