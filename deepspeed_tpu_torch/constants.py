"""Config keys and defaults.

The port's copy of ``deepspeed_tpu/constants.py`` (upstream DeepSpeed's
``deepspeed/pt/deepspeed_constants.py:17-245``).  Keys keep the
reference's JSON spelling so existing DeepSpeed config files parse unchanged;
TPU-only additions (``bf16``, mesh shape) are new keys that default off/auto.
"""

#############################################
# Routes (reference deepspeed_constants.py:1-15)
#############################################
ROUTE_TRAIN = "train"
ROUTE_EVAL = "eval"
ROUTE_PREDICT = "predict"
ROUTE_ENCODE = "encode"

#############################################
# Batch size (reference deepspeed_constants.py:17-73)
#############################################
TRAIN_BATCH_SIZE = "train_batch_size"
TRAIN_BATCH_SIZE_DEFAULT = None

TRAIN_MICRO_BATCH_SIZE_PER_GPU = "train_micro_batch_size_per_gpu"
TRAIN_MICRO_BATCH_SIZE_PER_GPU_DEFAULT = None

GRADIENT_ACCUMULATION_STEPS = "gradient_accumulation_steps"
GRADIENT_ACCUMULATION_STEPS_DEFAULT = None

#############################################
# Optimizer / scheduler sections
#############################################
OPTIMIZER = "optimizer"
OPTIMIZER_TYPE = "type"
OPTIMIZER_PARAMS = "params"
MAX_GRAD_NORM = "max_grad_norm"

SCHEDULER = "scheduler"
SCHEDULER_TYPE = "type"
SCHEDULER_PARAMS = "params"

# Optimizer names understood by the engine (reference deepspeed_config.py:12-15).
ADAM_OPTIMIZER = "adam"
ADAMW_OPTIMIZER = "adamw"
LAMB_OPTIMIZER = "lamb"
SGD_OPTIMIZER = "sgd"
DEEPSPEED_OPTIMIZERS = [ADAM_OPTIMIZER, ADAMW_OPTIMIZER, LAMB_OPTIMIZER, SGD_OPTIMIZER]
# Optimizers whose ZeRO interaction has been validated (reference
# deepspeed_light.py:450-457 restricts ZeRO to Adam).
ZERO_SUPPORTED_OPTIMIZERS = [ADAM_OPTIMIZER, ADAMW_OPTIMIZER, LAMB_OPTIMIZER]

#############################################
# Steps
#############################################
STEPS_PER_PRINT = "steps_per_print"
STEPS_PER_PRINT_DEFAULT = 10

# K optimizer steps fused into ONE compiled dispatch
# (engine.train_many — the on-device multi-step driver,
# docs/features.md "Multi-step driver").  1 = the per-step train_batch
# path.  Env escape hatch DSTPU_MULTISTEP overrides ("off"/"1"
# disables, an integer sets K).  With the metric spool on,
# observability.report_window must be a multiple of K (window drains
# align with K-block edges; enforced at config time).
TRAIN_STEPS_PER_DISPATCH = "train_steps_per_dispatch"
TRAIN_STEPS_PER_DISPATCH_DEFAULT = 1

#############################################
# Training options
#############################################
DISABLE_ALLGATHER = "disable_allgather"
DISABLE_ALLGATHER_DEFAULT = False

SPARSE_GRADIENTS = "sparse_gradients"
SPARSE_GRADIENTS_DEFAULT = False
# static per-step bound on touched embedding rows for the sparse (indices,
# values) gather; above it the reduction falls back to a dense psum.  TPU
# extension knob — the reference's sparse path has no bound because torch
# sparse tensors are dynamically sized, XLA programs are not.
SPARSE_GRADIENTS_MAX_ROWS = "sparse_gradients_max_rows"
SPARSE_GRADIENTS_MAX_ROWS_DEFAULT = 2048

#############################################
# FP16 support (reference deepspeed_constants.py:84-118)
#############################################
FP16 = "fp16"
FP16_ENABLED = "enabled"
FP16_ENABLED_DEFAULT = False

FP16_LOSS_SCALE = "loss_scale"
FP16_LOSS_SCALE_DEFAULT = 0  # 0 => dynamic

FP16_INITIAL_SCALE_POWER = "initial_scale_power"
FP16_INITIAL_SCALE_POWER_DEFAULT = 32

FP16_LOSS_SCALE_WINDOW = "loss_scale_window"
FP16_LOSS_SCALE_WINDOW_DEFAULT = 1000

FP16_HYSTERESIS = "hysteresis"
FP16_HYSTERESIS_DEFAULT = 2

FP16_MIN_LOSS_SCALE = "min_loss_scale"
FP16_MIN_LOSS_SCALE_DEFAULT = 1

#############################################
# BF16 (TPU-native addition; no reference analog — bf16 needs no loss scaling)
#############################################
BF16 = "bf16"
BF16_ENABLED = "enabled"
BF16_ENABLED_DEFAULT = False

#############################################
# Gradient clipping (reference deepspeed_constants.py:120-128)
#############################################
GRADIENT_CLIPPING = "gradient_clipping"
GRADIENT_CLIPPING_DEFAULT = 0.0

#############################################
# ZeRO optimization (reference deepspeed_constants.py:137-146; boolean in v0.1.0)
#############################################
ZERO_OPTIMIZATION = "zero_optimization"
ZERO_OPTIMIZATION_DEFAULT = False

#############################################
# Communication options (reference deepspeed_constants.py:148-182)
#############################################
ALLGATHER_SIZE = "allgather_size"
ALLGATHER_SIZE_DEFAULT = 500000000

FP32_ALLREDUCE = "fp32_allreduce"
FP32_ALLREDUCE_DEFAULT = False

PRESCALE_GRADIENTS = "prescale_gradients"
PRESCALE_GRADIENTS_DEFAULT = False

GRADIENT_PREDIVIDE_FACTOR = "gradient_predivide_factor"
GRADIENT_PREDIVIDE_FACTOR_DEFAULT = 1.0

#############################################
# Logging / dumps (reference deepspeed_constants.py:184-223)
#############################################
DUMP_STATE = "dump_state"
DUMP_STATE_DEFAULT = False

WALL_CLOCK_BREAKDOWN = "wall_clock_breakdown"
WALL_CLOCK_BREAKDOWN_DEFAULT = False

MEMORY_BREAKDOWN = "memory_breakdown"
MEMORY_BREAKDOWN_DEFAULT = False

# TPU-specific: per-block activation rematerialisation (the analog of
# Megatron's --checkpoint-activations the reference trains against,
# tests/model/Megatron_GPT2/ds_gpt2_test.sh).  None = leave the model's own
# setting; true/false overrides it.  Accepts {"enabled": bool} too.
ACTIVATION_CHECKPOINTING = "activation_checkpointing"
ACTIVATION_CHECKPOINTING_DEFAULT = None

#############################################
# Graph lint (TPU-native: jaxpr static analysis of the step programs —
# collective consistency, precision flow, transfer/recompile lint, shard
# specs; docs/analysis.md).  No reference analog: torch graphs only exist
# at runtime, jaxprs exist before any chip executes.
#############################################
GRAPH_LINT = "graph_lint"
GRAPH_LINT_MODE = "mode"
GRAPH_LINT_MODE_DEFAULT = "off"       # "off" | "warn" | "error"
GRAPH_LINT_SUPPRESS = "suppress"      # list of rule-code prefixes
GRAPH_LINT_SUPPRESS_DEFAULT = ()

#############################################
# Capacity planner (TPU-native: static per-device peak-HBM + bytes-on-wire
# analysis of the step programs — analysis/memplan.py, analysis/commplan.py,
# docs/analysis.md "Capacity planner".  No reference analog: predicting the
# fit of a config before compile needs the jaxpr, which torch never has.)
#############################################
ANALYSIS = "analysis"
ANALYSIS_MODE = "mode"
ANALYSIS_MODE_DEFAULT = "off"         # "off" | "warn" | "error"
# per-device peak-HBM budget in GiB; "error" mode raises MemoryPlanError
# when the predicted peak exceeds it.  None + no profile = report-only.
ANALYSIS_MEMORY_BUDGET_GB = "memory_budget_gb"
ANALYSIS_MEMORY_BUDGET_GB_DEFAULT = None
# backend profile name (analysis/profiles.py: "v4-8", "v5e-8", "v5p-8",
# "cpu-8"); supplies the budget when memory_budget_gb is unset and the
# link-bandwidth table for predicted wire time
ANALYSIS_PROFILE = "profile"
ANALYSIS_PROFILE_DEFAULT = None
# rule-code prefixes to suppress (memory.*/comm.* families), same
# exact/dotted-prefix semantics as graph_lint.suppress
ANALYSIS_SUPPRESS = "suppress"
ANALYSIS_SUPPRESS_DEFAULT = ()
# host-concurrency lint (analysis/concurrency.py): AST lock-order +
# blocking-under-lock + thread-role pass over the serving control plane,
# gated at FleetRouter build.  {"mode": off|warn|error, "suppress":
# [...]}; a bare string is mode shorthand, like graph_lint
ANALYSIS_CONCURRENCY = "concurrency"
ANALYSIS_CONCURRENCY_MODE_DEFAULT = "off"
ANALYSIS_CONCURRENCY_SUPPRESS_DEFAULT = ()

#############################################
# Profiler (TPU-native: jax.profiler trace over a step window — the
# tracing analog of wall_clock_breakdown, SURVEY §5 row 1)
#############################################
PROFILE = "profile"
PROFILE_ENABLED = "enabled"
PROFILE_ENABLED_DEFAULT = False
PROFILE_START_STEP = "start_step"
PROFILE_START_STEP_DEFAULT = 10
PROFILE_END_STEP = "end_step"
PROFILE_END_STEP_DEFAULT = 12
PROFILE_OUTPUT_PATH = "output_path"
PROFILE_OUTPUT_PATH_DEFAULT = "/tmp/dstpu_profile"

#############################################
# Observability (TPU-native telemetry layer — deepspeed_tpu/observability/,
# docs/observability.md.  Reference analog: deepspeed_timer.py fenced the
# host with torch.cuda.synchronize on every span; here metrics spool
# through a device-side ring buffer drained once per report window, so the
# per-step path carries ZERO host fences.)
#############################################
OBSERVABILITY = "observability"
# boundaries per metric window: >= 1 enables the MetricSpool (device ring
# buffer + one batched drain callback per window); 0 keeps the legacy
# per-boundary reporting paths
OBSERVABILITY_REPORT_WINDOW = "report_window"
OBSERVABILITY_REPORT_WINDOW_DEFAULT = 0
# schema-versioned JSONL event log, one line per window (process 0);
# validated by `python -m deepspeed_tpu.observability <path>`
OBSERVABILITY_JSONL_PATH = "jsonl_path"
OBSERVABILITY_JSONL_PATH_DEFAULT = None
# jax.profiler capture destination (env fallback DSTPU_TRACE_DIR — how
# `dst --trace_dir` hands it to every worker); also where watchdog hang
# captures land
OBSERVABILITY_TRACE_DIR = "trace_dir"
OBSERVABILITY_TRACE_DIR_DEFAULT = None
OBSERVABILITY_TRACE_START_STEP = "trace_start_step"
OBSERVABILITY_TRACE_START_STEP_DEFAULT = 10
# > 0 schedules a [start, start + num) capture window (supersedes the
# legacy `profile` section; configuring both is a config error)
OBSERVABILITY_TRACE_NUM_STEPS = "trace_num_steps"
OBSERVABILITY_TRACE_NUM_STEPS_DEFAULT = 0
# record a short trace when the resilience watchdog fires (needs trace_dir)
OBSERVABILITY_HANG_CAPTURE = "hang_capture"
OBSERVABILITY_HANG_CAPTURE_DEFAULT = True
OBSERVABILITY_HANG_CAPTURE_S = "hang_capture_s"
OBSERVABILITY_HANG_CAPTURE_S_DEFAULT = 1.0
# report the capacity planner's predicted peak-HBM / boundary wire time
# next to measurement in every window event (drift columns)
OBSERVABILITY_PLANNER_DRIFT = "planner_drift"
OBSERVABILITY_PLANNER_DRIFT_DEFAULT = True
# fwd+bwd matmul FLOPs per sample (model-specific; bench.py's accounting)
# — enables the per-window MFU column together with peak_tflops_per_chip
OBSERVABILITY_FLOPS_PER_SAMPLE = "flops_per_sample"
OBSERVABILITY_FLOPS_PER_SAMPLE_DEFAULT = None
OBSERVABILITY_PEAK_TFLOPS = "peak_tflops_per_chip"
OBSERVABILITY_PEAK_TFLOPS_DEFAULT = None
# fleet observability (docs/observability.md "Fleet view"): ship each
# host's window report out-of-band to rank 0 (coordination-service KV
# store — NEVER a device collective) and emit one dstpu.telemetry.fleet
# event per window with per-host spreads + straggler/anomaly flags
OBSERVABILITY_FLEET = "fleet"
OBSERVABILITY_FLEET_DEFAULT = False
# per-window aggregation deadline: hosts missing after this long are
# listed in missing_hosts (itself a hang precursor) instead of blocking
OBSERVABILITY_FLEET_WAIT_S = "fleet_wait_s"
OBSERVABILITY_FLEET_WAIT_S_DEFAULT = 30.0
# a host whose host-side time exceeds this multiple of the fleet median
# is flagged as a straggler
OBSERVABILITY_STRAGGLER_FACTOR = "straggler_factor"
OBSERVABILITY_STRAGGLER_FACTOR_DEFAULT = 2.0
# window loss/grad-norm beyond this multiple of the rolling median is a
# spike anomaly
OBSERVABILITY_SPIKE_FACTOR = "spike_factor"
OBSERVABILITY_SPIKE_FACTOR_DEFAULT = 5.0
# data-loader wait above this fraction of window step time flags
# data starvation
OBSERVABILITY_STARVATION_FRAC = "starvation_frac"
OBSERVABILITY_STARVATION_FRAC_DEFAULT = 0.5
# > 0 serves /healthz, /status and /metrics (Prometheus text) on
# base_port + process_index; env fallback DSTPU_HEALTH_PORT
# (dst --health_port); 0 disables
OBSERVABILITY_HEALTH_PORT = "health_port"
OBSERVABILITY_HEALTH_PORT_DEFAULT = 0
# host-side flight-recorder ring size (entries; 0 disables) — dumped on
# watchdog fire, preemption drain and crash exit
OBSERVABILITY_FLIGHT_RECORDER = "flight_recorder"
OBSERVABILITY_FLIGHT_RECORDER_DEFAULT = 256
# dump destination (default: the JSONL log's directory, else trace_dir,
# else cwd; env fallback DSTPU_FLIGHTREC_DIR)
OBSERVABILITY_FLIGHT_RECORDER_DIR = "flight_recorder_dir"
OBSERVABILITY_FLIGHT_RECORDER_DIR_DEFAULT = None

#############################################
# Inference serving (TPU-native: deepspeed_tpu/inference/,
# docs/inference.md.  No reference analog: v0.1.0 is training-only —
# an inference engine is on its "explicitly absent" list.)
#############################################
INFERENCE = "inference"
# concurrent decode slots (continuous batching width); 0 = auto-size
# against the analysis profile's HBM after weights (kvcache.plan_slots)
INFERENCE_MAX_SLOTS = "max_slots"
INFERENCE_MAX_SLOTS_DEFAULT = 4
# per-slot KV-cache token capacity (page-rounded); 0 = the model's
# max_seq_len
INFERENCE_MAX_TOKENS = "max_tokens"
INFERENCE_MAX_TOKENS_DEFAULT = 0
# fixed prompt padding bucket of the prefill program (one executable
# serves every prompt); 0 = the cache capacity
INFERENCE_PREFILL_BUCKET = "prefill_bucket"
INFERENCE_PREFILL_BUCKET_DEFAULT = 0
# "paged" (exact up to capacity) | "ring" (sliding window: the cache row
# wraps — approximate beyond capacity, documented in docs/inference.md)
INFERENCE_KV_LAYOUT = "kv_layout"
INFERENCE_KV_LAYOUT_DEFAULT = "paged"
# cache allocation granularity in tokens
INFERENCE_PAGE_TOKENS = "page_tokens"
INFERENCE_PAGE_TOKENS_DEFAULT = 128
# serving compute dtype: "bfloat16" (default) | "float16" | "float32"
INFERENCE_DTYPE = "dtype"
INFERENCE_DTYPE_DEFAULT = "bfloat16"
# weight quantization at load: null | "int8" (per-output-channel scales,
# matmul-dequant dispatch table — inference/quant.py)
INFERENCE_QUANTIZE = "quantize"
INFERENCE_QUANTIZE_DEFAULT = None
# D decode iterations fused into ONE compiled dispatch (greedy sampling
# on-device; admission/eviction every D tokens — docs/inference.md
# "Fused decode").  1 = the per-iteration path.  Env escape hatch
# DSTPU_DECODE_ITERS overrides ("off"/"1" disables, an integer sets D).
INFERENCE_DECODE_ITERS_PER_DISPATCH = "decode_iters_per_dispatch"
INFERENCE_DECODE_ITERS_PER_DISPATCH_DEFAULT = 1
# prefix KV reuse over the refcounted page table (docs/inference.md
# "Prefix reuse"): hash page-aligned prompt prefixes, map hits to shared
# pages, prefill only the tail.  Outputs stay byte-identical to the
# no-reuse path (same weights + same tokens ⇒ the same page bytes).
INFERENCE_PREFIX_REUSE = "prefix_reuse"
INFERENCE_PREFIX_REUSE_DEFAULT = True
# page-pool size in PAGES; 0 = slots * pages_per_slot (no overcommit).
# Fewer pages than the worst case is legal — admission refuses (queues)
# when the pool is exhausted instead of OOMing.
INFERENCE_POOL_PAGES = "pool_pages"
INFERENCE_POOL_PAGES_DEFAULT = 0
# padding bucket of the TAIL prefill program (a prefix hit forwards only
# the uncached tail; a narrower bucket makes the FLOP saving real);
# 0 = page_tokens.  Tails longer than the bucket fall back to the full
# prefill program (same numerics, no saving).
INFERENCE_TAIL_BUCKET = "tail_bucket"
INFERENCE_TAIL_BUCKET_DEFAULT = 0
# speculative decoding (docs/inference.md "Speculative decoding"):
# draft_tokens = J proposals per fused draft+verify dispatch (0 = off).
# The draft model comes from draft_size (a models/gpt2.py GPT2_SIZES
# key, built on the target's vocab/seq) or the InferenceEngine
# draft_model= argument; draft_checkpoint/draft_tag stream its weights
# through a second checkpoint.load_params_only pass.
INFERENCE_SPECULATIVE = "speculative"
INFERENCE_SPEC_DRAFT_TOKENS = "draft_tokens"
INFERENCE_SPEC_DRAFT_TOKENS_DEFAULT = 0
INFERENCE_SPEC_DRAFT_SIZE = "draft_size"
INFERENCE_SPEC_DRAFT_SIZE_DEFAULT = None
INFERENCE_SPEC_DRAFT_CHECKPOINT = "draft_checkpoint"
INFERENCE_SPEC_DRAFT_CHECKPOINT_DEFAULT = None
INFERENCE_SPEC_DRAFT_TAG = "draft_tag"
INFERENCE_SPEC_DRAFT_TAG_DEFAULT = None
# replica observability (docs/observability.md "Serving view"): the
# serving analog of the top-level "observability" section — per-request
# lifecycle events, live /healthz /status /metrics endpoints, a hang
# watchdog armed around every prefill/decode dispatch, and the serve
# anomaly detectors.  All host-side: zero effect on the compiled
# programs, the greedy-output contract, or the fence counter.
INFERENCE_OBSERVABILITY = "observability"
# decode iterations folded into one dstpu.telemetry.serve window event
INFERENCE_OBS_WINDOW_ITERS = "window_iters"
INFERENCE_OBS_WINDOW_ITERS_DEFAULT = 8
# serve telemetry JSONL path (window + startup + request events share
# the stream; the run_serve jsonl_path argument beats it)
INFERENCE_OBS_JSONL_PATH = "jsonl_path"
INFERENCE_OBS_JSONL_PATH_DEFAULT = None
# emit one dstpu.telemetry.request line per completed request
INFERENCE_OBS_REQUEST_EVENTS = "request_events"
INFERENCE_OBS_REQUEST_EVENTS_DEFAULT = True
# > 0 serves /healthz /status /metrics on port + process_index (env
# fallback DSTPU_HEALTH_PORT via dst --health_port / serve_gpt2.py
# --health_port, same resolution as observability.health_port)
INFERENCE_OBS_HEALTH_PORT = "health_port"
INFERENCE_OBS_HEALTH_PORT_DEFAULT = 0
# > 0 arms a hang watchdog around every prefill/decode dispatch (the
# deadline scales by decode_iters_per_dispatch / draft_tokens+1 for the
# fused programs); a fire marks the replica unhealthy (/healthz 503)
# and dumps stacks + the flight-recorder ring
INFERENCE_OBS_WATCHDOG_TIMEOUT_S = "watchdog_timeout_s"
INFERENCE_OBS_WATCHDOG_TIMEOUT_S_DEFAULT = 0.0
# abort the process (exit 44) after a watchdog fire, like
# resilience.watchdog_abort
INFERENCE_OBS_WATCHDOG_ABORT = "watchdog_abort"
INFERENCE_OBS_WATCHDOG_ABORT_DEFAULT = False
# flight-recorder dump destination (default: the JSONL log's directory,
# else cwd; env fallback DSTPU_FLIGHTREC_DIR)
INFERENCE_OBS_FLIGHT_RECORDER_DIR = "flight_recorder_dir"
INFERENCE_OBS_FLIGHT_RECORDER_DIR_DEFAULT = None
# admission-starvation detector: flag a window where requests waited
# the whole window (queue non-empty, zero admissions, refusals grew)
INFERENCE_OBS_STARVATION_WINDOWS = "starvation_windows"
INFERENCE_OBS_STARVATION_WINDOWS_DEFAULT = 1
# speculative accept-rate collapse floor (windows with enough proposals
# whose accept rate falls below it are flagged); 0 disables
INFERENCE_OBS_ACCEPT_FLOOR = "accept_floor"
INFERENCE_OBS_ACCEPT_FLOOR_DEFAULT = 0.25
# page-pool thrash detector: flag a window reclaiming at least this
# many published LRU pages AND more than it served prefix hits
# (the prefix cache churning faster than it helps); 0 disables
INFERENCE_OBS_THRASH_RECLAIMS = "thrash_reclaims"
INFERENCE_OBS_THRASH_RECLAIMS_DEFAULT = 8

# fleet serving (docs/inference.md "Fleet serving"): the router layer
# over N InferenceEngine replicas — least-loaded admission off the
# replica /metrics gauges, /healthz-503 eviction with resubmission, and
# optional prefill/decode disaggregation with KV handoff
# (deepspeed_tpu/inference/router.py)
INFERENCE_FLEET = "fleet"
# serving replicas the router drives (0 = no fleet; serve_gpt2.py
# --fleet / FleetRouter(replicas=...) override)
INFERENCE_FLEET_REPLICAS = "replicas"
INFERENCE_FLEET_REPLICAS_DEFAULT = 0
# of those, how many form the PREFILL pool (0 = mixed pool, no
# disaggregation; > 0 requires disaggregate: true)
INFERENCE_FLEET_PREFILL_REPLICAS = "prefill_replicas"
INFERENCE_FLEET_PREFILL_REPLICAS_DEFAULT = 0
# build + gate the KV export/import programs (the handoff path); the
# engine refuses export_kv/import_kv without it so the exactly-N
# executables promise stays a checked invariant
INFERENCE_FLEET_DISAGGREGATE = "disaggregate"
INFERENCE_FLEET_DISAGGREGATE_DEFAULT = False
# > 0 serves the ROUTER's own /healthz /status /metrics here (replica
# endpoints ride inference.observability.health_port + replica index)
INFERENCE_FLEET_HEALTH_PORT = "health_port"
INFERENCE_FLEET_HEALTH_PORT_DEFAULT = 0
# router health/metrics poll + telemetry-window cadence (seconds)
INFERENCE_FLEET_POLL_S = "poll_s"
INFERENCE_FLEET_POLL_S_DEFAULT = 0.05
# route requests to the replica whose page-hash index already holds
# the prompt's page-aligned prefix (PR 13 reuse at fleet scale)
INFERENCE_FLEET_AFFINITY = "affinity"
INFERENCE_FLEET_AFFINITY_DEFAULT = True
# KV handoff artifact directory (disaggregation; default: a tempdir)
INFERENCE_FLEET_HANDOFF_DIR = "handoff_dir"
INFERENCE_FLEET_HANDOFF_DIR_DEFAULT = None
# router telemetry JSONL (dstpu.telemetry.router windows; the
# FleetRouter jsonl_path argument beats it)
INFERENCE_FLEET_JSONL_PATH = "jsonl_path"
INFERENCE_FLEET_JSONL_PATH_DEFAULT = None

#############################################
# Checkpoint IO (TPU-native: background writer thread + parallel streaming
# restore — checkpoint.py, docs/resilience.md "Time to resume".  No
# reference analog: v0.1.0 saves/loads synchronously through torch.save.)
#############################################
CHECKPOINT = "checkpoint"
# write container files on a background thread; the training stall is the
# device→host snapshot only
CHECKPOINT_ASYNC_SAVE = "async_save"
CHECKPOINT_ASYNC_SAVE_DEFAULT = False
# restore reader-pool width: 0 = auto (2 readers per core, capped at 8),
# 1 = serial fallback (same plan executed inline — bitwise identical)
CHECKPOINT_RESTORE_THREADS = "restore_threads"
CHECKPOINT_RESTORE_THREADS_DEFAULT = 0
# bound on in-flight read results beyond the leaf being placed — the
# restore's peak host RAM is one window + one leaf, not the state tree
CHECKPOINT_RESTORE_READAHEAD_MB = "restore_readahead_mb"
CHECKPOINT_RESTORE_READAHEAD_MB_DEFAULT = 256.0

#############################################
# Persistent compilation cache (TPU-native: jax_compilation_cache_dir wired
# through config so a relaunched/preempted worker reuses the prior
# attempt's compiled step programs — time-to-first-step after a restart
# becomes restore + cache READ instead of restore + full recompile.)
#############################################
COMPILE_CACHE = "compile_cache"
# cache directory (shared across restart attempts; the launcher propagates
# it to relaunched workers via DSTPU_COMPILE_CACHE_DIR).  None = disabled
# unless the env var is set.
COMPILE_CACHE_DIR = "dir"
COMPILE_CACHE_DIR_DEFAULT = None
# skip caching executables smaller than this (tiny programs recompile
# faster than they deserialize; 0 = cache everything)
COMPILE_CACHE_MIN_ENTRY_SIZE_BYTES = "min_entry_size_bytes"
COMPILE_CACHE_MIN_ENTRY_SIZE_BYTES_DEFAULT = 0

#############################################
# Resilience (TPU-native: preemption-safe training, hang watchdog, NaN
# sentinel, storage retry — deepspeed_tpu/resilience/, docs/resilience.md.
# No reference analog: v0.1.0 assumes every host survives the run.)
#############################################
RESILIENCE = "resilience"
# take an emergency checkpoint (tag "emergency/...") before a preemption
# drain exits with RESUME_EXIT_CODE
RESILIENCE_PREEMPT_SAVE = "preempt_save"
RESILIENCE_PREEMPT_SAVE_DEFAULT = True
# launcher relaunch budget after RESUME/WATCHDOG exit codes (the engine
# records it; deepspeed_tpu.launcher --max_restarts consumes it via CLI)
RESILIENCE_MAX_RESTARTS = "max_restarts"
RESILIENCE_MAX_RESTARTS_DEFAULT = 0
# hang watchdog deadline over each blocking step/checkpoint call;
# 0 disables the watchdog
RESILIENCE_WATCHDOG_TIMEOUT_S = "watchdog_timeout_s"
RESILIENCE_WATCHDOG_TIMEOUT_S_DEFAULT = 0.0
# after the stack dump, abort the process with WATCHDOG_EXIT_CODE so the
# restart path takes over (default: dump only)
RESILIENCE_WATCHDOG_ABORT = "watchdog_abort"
RESILIENCE_WATCHDOG_ABORT_DEFAULT = False
# retry-with-backoff budget for checkpoint save/load storage errors
RESILIENCE_IO_RETRIES = "io_retries"
RESILIENCE_IO_RETRIES_DEFAULT = 3
# extend the fp16 skip-on-overflow contract to bf16/fp32: a non-finite
# gradient skips the optimizer boundary (master/moments unchanged) instead
# of poisoning the parameters
RESILIENCE_NAN_SENTINEL = "nan_sentinel"
RESILIENCE_NAN_SENTINEL_DEFAULT = False

#############################################
# TensorBoard (reference deepspeed_constants.py:225-245)
#############################################
TENSORBOARD = "tensorboard"
TENSORBOARD_ENABLED = "enabled"
TENSORBOARD_ENABLED_DEFAULT = False
TENSORBOARD_OUTPUT_PATH = "output_path"
TENSORBOARD_OUTPUT_PATH_DEFAULT = ""
TENSORBOARD_JOB_NAME = "job_name"
TENSORBOARD_JOB_NAME_DEFAULT = "DeepSpeedJobName"

#############################################
# MXU alignment: the reference warns when vocab size isn't a multiple of 8 for
# tensor cores (deepspeed_config.py:402-407).  TPU MXU tiles are 128-wide.
#############################################
MXU_ALIGN_SIZE = 128

#############################################
# Mesh / parallelism (TPU-native additions)
#############################################
MESH = "mesh"
MESH_DATA_AXIS = "data"
MESH_MODEL_AXIS = "model"
MODEL_PARALLEL_SIZE = "model_parallel_size"
MODEL_PARALLEL_SIZE_DEFAULT = 1
MESH_SEQ_AXIS = "seq"
CONTEXT_PARALLEL_SIZE = "context_parallel_size"
CONTEXT_PARALLEL_SIZE_DEFAULT = 1
MESH_PIPE_AXIS = "pipe"
PIPELINE_PARALLEL_SIZE = "pipeline_parallel_size"
PIPELINE_PARALLEL_SIZE_DEFAULT = 1
PIPELINE_SCHEDULE = "pipeline_schedule"
PIPELINE_SCHEDULE_DEFAULT = None          # None | "gpipe" | "1f1b"
SEQUENCE_PARALLEL_IMPL = "sequence_parallel_impl"
SEQUENCE_PARALLEL_IMPL_DEFAULT = None     # None | "ring" | "ulysses"

ZERO_PARAMETER_PARALLEL_SIZE = "parameter_parallel_size"
ZERO_PARAMETER_PARALLEL_SIZE_DEFAULT = None

# Comm/compute overlap: the boundary collectives (reduce-scatter / weight
# all-gather, and the plain-DP grad psum) split into lane-aligned buckets so
# XLA's async collectives can overlap each other and the shard-local update
# (docs/scaling.md "Communication/compute overlap").  Bucketing only re-tiles
# the same elementwise math, so it is bit-exact with the serial path;
# DSTPU_OVERLAP=off restores the monolithic programs.
ZERO_OVERLAP_COMM = "overlap_comm"
ZERO_OVERLAP_COMM_DEFAULT = True
ZERO_COMM_BUCKET_MB = "comm_bucket_mb"
ZERO_COMM_BUCKET_MB_DEFAULT = 32.0
