"""Telemetry: the engine's one observability layer.

The port of ``deepspeed_tpu/observability/``.  Four pieces, one facade:

* :mod:`~deepspeed_tpu_torch.observability.spool`: MetricSpool, the
  per-boundary loss / grad norm / loss scale / skip flag in a device ring
  buffer, copied to the host once per ``report_window`` boundaries behind
  a CUDA event; the training thread never waits for it.
* :mod:`~deepspeed_tpu_torch.observability.tracing`: a ``torch.profiler``
  capture over a configured step window, ``dstpu/*`` ranges, and the
  watchdog's hang capture.
* :mod:`~deepspeed_tpu_torch.observability.registry`: the MetricRegistry
  fan-out: engine throughput, resilience counters and the compile-cache
  (kernel build directory) counters emit through one path to TensorBoard
  and a schema-versioned JSONL event log (:mod:`~.schema`).
* goodput: each window's measured step time, samples/s, optional MFU
  (``flops_per_sample`` and ``peak_tflops_per_chip``, which has no
  default) and peak device memory (``torch.cuda.max_memory_allocated``).
  The planner-drift columns (``predicted_*``, ``*_drift``): the capacity
  planner's predicted peak memory of the fused step and boundary wire
  time (``analysis/``, handed over once by the engine's gate), next to
  the measured ones, when ``planner_drift`` is on.

Beside them: the fleet view (:mod:`~.fleet`, rank 0's per-window roll-up
over the c10d store), the anomaly and straggler detectors
(:mod:`~.detectors`), the flight recorder (:mod:`~.flightrec`), the health
endpoints (:mod:`~.health`) and the fence counter (:mod:`~.fences`).

One difference from the JAX package: the JAX engine may defer the fp16 /
NaN-sentinel overflow read to the window drain, because its compiled step
gates the update on the flag on the device.  The port's update is gated on
the host, so it keeps that one read per boundary under fp16 or the
sentinel, counted as a fence (``defers_overflow`` is always False); a
device-side gate is ROADMAP.md Queue 2 B2.

Config::

    "observability": {
      "report_window": 0,          # >= 1 enables the spool
      "jsonl_path": null,          # JSONL event log (process 0)
      "trace_dir": null,           # or env DSTPU_TRACE_DIR (--trace_dir)
      "trace_start_step": 10,
      "trace_num_steps": 0,        # > 0 schedules a capture window
      "hang_capture": true,        # watchdog fire -> trace under trace_dir
      "hang_capture_s": 1.0,
      "planner_drift": true,       # the predicted_* columns
      "flops_per_sample": null,    # enables the MFU column
      "peak_tflops_per_chip": null,
      "fleet": false,              # rank-0 dstpu.telemetry.fleet events
      "fleet_wait_s": 30.0,        # per-window aggregation deadline
      "straggler_factor": 2.0,     # host-time multiple of fleet median
      "spike_factor": 5.0,         # loss/grad-norm spike multiple
      "starvation_frac": 0.5,      # data-wait fraction of step time
      "health_port": 0,            # > 0 serves /healthz /status /metrics
                                   # (base + rank; env DSTPU_HEALTH_PORT)
      "flight_recorder": 256,      # host-side event ring size (0 = off)
      "flight_recorder_dir": null  # dump destination
    }
"""

from __future__ import annotations

import logging
import os
import threading
import time
import weakref
from typing import Optional

import numpy as np

from deepspeed_tpu_torch.observability import detectors  # noqa: F401
from deepspeed_tpu_torch.observability import fences  # noqa: F401  (re-export)
from deepspeed_tpu_torch.observability import fleet as fleet_mod
from deepspeed_tpu_torch.observability import flightrec  # noqa: F401
from deepspeed_tpu_torch.observability import health as health_mod
from deepspeed_tpu_torch.observability import schema  # noqa: F401
from deepspeed_tpu_torch.observability import spool as spool_mod
from deepspeed_tpu_torch.observability import tracing
from deepspeed_tpu_torch.observability.flightrec import RECORDER  # noqa: F401
from deepspeed_tpu_torch.observability.registry import (JsonlSink, MetricRegistry,
                                                  TensorboardSink)
from deepspeed_tpu_torch.observability.spool import MetricSpool
from deepspeed_tpu_torch.observability.tracing import Tracer, annotate

logger = logging.getLogger(__name__)

__all__ = [
    "Telemetry", "MetricSpool", "MetricRegistry", "TensorboardSink",
    "JsonlSink", "Tracer", "annotate", "detectors", "fences", "fleet_mod",
    "flightrec", "health_mod", "schema", "spool_mod", "tracing", "RECORDER",
]


class Telemetry:
    """Per-engine telemetry driver.  Built by the engine at the end of
    ``__init__`` (after the summary writer and scheduler exist); holds the
    engine by weakref — the drain callback must never keep a dead engine
    alive."""

    def __init__(self, engine):
        cfg = engine.config
        self._engine_ref = weakref.ref(engine)
        self.window = int(cfg.observability_report_window)
        self.registry = MetricRegistry()
        # with the lock sanitizer armed (DSTPU_LOCKWATCH=1 /
        # lockwatch.instrument()), its wait/held counters ride this
        # registry into every snapshot as lockwatch/lock_wait_ms.<name>
        from deepspeed_tpu_torch.analysis import lockwatch
        if lockwatch.armed():
            lockwatch.register_metrics(self.registry)
        self._lock = threading.Lock()
        self._last_drain_ts = None      # set at first drain; window 1 is
        self._base_step = None          # unmeasured (it includes compile)
        self._skip_contract = bool(cfg.fp16_enabled
                                   or cfg.resilience_nan_sentinel)
        self._fp16 = bool(cfg.fp16_enabled)
        self._warned_overflow_read = False
        # the planner handoff's columns: present, null until the engine's
        # gate hands a plan over (note_fused_plan / note_predictions)
        self.predictions = {"predicted_peak_hbm_gb": None,
                            "predicted_boundary_ms": None,
                            "predicted_profile": None}
        self.planner_drift = bool(cfg.observability_planner_drift)
        self._predictions_tried = False
        self.flops_per_sample = cfg.observability_flops_per_sample
        self.peak_tflops = cfg.observability_peak_tflops_per_chip
        self.measured_boundary_ms = None    # set by whoever measures it
        self.samples_per_step = (cfg.train_batch_size or 0)
        self._device = engine.device
        self._rank, self._world = tracing._rank_and_world()
        # one device per process
        self._n_devices = self._world

        # fleet-observability bookkeeping: cold-start timing for the
        # startup event, host-side pre-dispatch/data-wait accumulators
        # for the per-host straggler signal, last-event snapshots for the
        # live health endpoints
        self._built_ts = time.time()
        self._first_step_ts = None
        self.first_dispatch_s = None
        self._startup_emitted = False
        self._host_s = 0.0
        self._host_n = 0
        self._data_wait_s = 0.0
        self._data_wait_n = 0
        self.last_window_event = None
        self.last_fleet_event = None
        self.startup_event = None
        self._window_ordinal = 0

        # flight recorder: the process ring is always on (recording is a
        # locked deque append — ~free); the engine's config sizes it and
        # points the dump directory (default: next to the JSONL log, else
        # the trace dir, else cwd)
        dump_dir = (cfg.observability_flight_recorder_dir
                    or (os.path.dirname(os.path.abspath(
                        cfg.observability_jsonl_path))
                        if cfg.observability_jsonl_path else None)
                    or cfg.observability_trace_dir)
        RECORDER.configure(capacity=cfg.observability_flight_recorder,
                           rank=self._rank, dump_dir=dump_dir)
        flightrec.maybe_register_exit_dump()

        # sinks: TensorBoard rides the engine's writer, resolved LIVE at
        # emit time (rank-0 gated there; tests and users may swap the
        # writer after build); the JSONL event log writes on process 0
        self._tb = TensorboardSink(self._live_writer)
        self.registry.add_sink(self._tb)
        self.jsonl_path = None
        if (cfg.observability_jsonl_path
                and self._rank == 0):
            self.jsonl_path = cfg.observability_jsonl_path
            self.registry.add_sink(JsonlSink(self.jsonl_path))

        # sources: the deduped scalar producers (legacy tag spellings kept:
        # Train/Samples/lr, Train/Resilience/*) + the detector counters
        from deepspeed_tpu_torch.resilience import COUNTERS
        self.registry.register("resilience", COUNTERS.as_dict)
        self.registry.register("samples", self._samples_source)
        self.registry.register("observability",
                               detectors.COUNTERS.as_dict)

        # spool (report_window >= 1)
        self.spool: Optional[MetricSpool] = None
        self._anomaly: Optional[detectors.WindowAnomalyDetector] = None
        if self.window >= 1:
            self.spool = MetricSpool(self.window, self._on_window,
                                     device=engine.device)
            self._anomaly = detectors.WindowAnomalyDetector(
                self._rank,
                spike_factor=cfg.observability_spike_factor,
                starvation_frac=cfg.observability_starvation_frac)
            self.defers_overflow(engine)

        # fleet aggregation: per-host window reports ship OUT OF BAND to
        # rank 0 over the process group's c10d store — host threads only,
        # never a collective, never the delivery thread
        self.fleet: Optional[fleet_mod.FleetAggregator] = None
        if cfg.observability_fleet and self.spool is not None:
            self.fleet = fleet_mod.FleetAggregator(
                world=self._world, rank=self._rank,
                wait_s=cfg.observability_fleet_wait_s,
                straggler_factor=cfg.observability_straggler_factor,
                emit=self._emit_fleet_event)

        # live health endpoints (opt-in: health_port config key or the
        # launcher's --health_port env fallback, offset per process)
        self.health: Optional[health_mod.HealthServer] = None
        port = health_mod.resolve_health_port(
            cfg.observability_health_port, rank=self._rank)
        if port is not None:
            try:
                self.health = health_mod.HealthServer(
                    port, self, rank=self._rank)
            except OSError as e:
                # a taken port must not take down training — loudly
                # degraded, like every other telemetry failure
                logger.warning(
                    "telemetry: health endpoints DISABLED — could not "
                    "bind port %d: %s", port, e)

        # tracer (trace_dir from config or DSTPU_TRACE_DIR)
        self.tracer: Optional[Tracer] = None
        trace_dir = tracing.resolve_trace_dir(cfg.observability_trace_dir)
        if trace_dir is not None:
            self.tracer = Tracer(
                trace_dir,
                start_step=cfg.observability_trace_start_step,
                num_steps=cfg.observability_trace_num_steps,
                hang_capture_s=cfg.observability_hang_capture_s,
                with_cuda=engine.device.type == "cuda")
        self.hang_capture = bool(cfg.observability_hang_capture)

    @classmethod
    def from_engine(cls, engine) -> "Telemetry":
        """Every engine gets a Telemetry: with no ``observability`` config
        the spool/tracer stay off, but the registry still owns ALL scalar
        export (the dedup of the three legacy TensorBoard write loops —
        one path whether metrics ride windows or boundaries)."""
        return cls(engine)

    # ------------------------------------------------------------- sources
    def _live_writer(self):
        engine = self._engine_ref()
        return engine.summary_writer if engine is not None else None

    def _samples_source(self) -> dict:
        engine = self._engine_ref()
        if engine is None:
            return {}
        return {"lr": float(engine.optimizer.param_groups[0]["lr"])}

    # --------------------------------------------------------------- spool
    @property
    def spool_active(self) -> bool:
        return self.spool is not None

    def defers_overflow(self, engine) -> bool:
        """Whether the engine may skip the per-boundary overflow host read.
        Never in the port: its update is gated on the host, so under fp16
        or the NaN sentinel the boundary reads the agreed flag (one counted
        fence) while the spool still batches every other metric.  The JAX
        engine gates the update on the device and defers the read to the
        window drain; the port's counterpart is ROADMAP.md Queue 2 B2."""
        if (self.spool is not None and self._skip_contract
                and not self._warned_overflow_read):
            self._warned_overflow_read = True
            logger.warning(
                "telemetry: per-boundary overflow read RETAINED under %s — "
                "the port gates the update on the host; all other metrics "
                "still spool", "fp16" if self._fp16 else "nan_sentinel")
        return False

    def _on_window(self, rows: np.ndarray, pos: int) -> None:
        """Spool delivery (runtime callback thread on async drains, caller
        thread on flush): aggregate the window, settle the deferred
        skip bookkeeping, emit through the registry, run the per-host
        anomaly detectors and hand the fleet report off."""
        n = int(rows.shape[0])
        now = time.time()
        engine = self._engine_ref()
        with self._lock:
            base = self._base_step or 0
            last_ts, self._last_drain_ts = self._last_drain_ts, now
            host_s, host_n = self._host_s, self._host_n
            self._host_s, self._host_n = 0.0, 0
            wait_s, wait_n = self._data_wait_s, self._data_wait_n
            self._data_wait_s, self._data_wait_n = 0.0, 0
        step = base + pos

        skips = int(np.sum(rows[:, spool_mod.SKIP] > 0)) \
            if self._skip_contract else 0

        event = {
            "step": int(step),
            "window_steps": n,
            "loss": float(rows[-1, spool_mod.LOSS]),
            "loss_mean": float(np.mean(rows[:, spool_mod.LOSS])),
            "grad_norm": float(rows[-1, spool_mod.GRAD_NORM]),
            "loss_scale": float(rows[-1, spool_mod.LOSS_SCALE]),
            "skipped": skips,
            "ts": now,
        }
        if last_ts is not None and now > last_ts:
            elapsed = now - last_ts
            event["step_ms"] = elapsed / n * 1000.0
            if self.samples_per_step:
                sps = n * self.samples_per_step / elapsed
                event["samples_per_sec"] = sps
                if self.flops_per_sample and self.peak_tflops:
                    event["mfu"] = (
                        (sps / self._n_devices)
                        * float(self.flops_per_sample)
                        / (float(self.peak_tflops) * 1e12))
        event.update(self._capacity_columns())
        # per-host fleet-report columns (schema v2): host-side pre-dispatch
        # time is THE straggler signal — in lockstep one slow rank makes
        # every rank's wall time slow, but only the straggler pays
        # host-side time
        event["rank"] = self._rank
        event["host_ms"] = (round(host_s / host_n * 1000.0, 4)
                            if host_n else None)
        event["data_wait_ms"] = (round(wait_s / max(wait_n, n) * 1000.0, 4)
                                 if wait_n else None)
        if self._anomaly is not None:
            event["anomalies"] = self._anomaly.check_window(event)
        sample_count = (getattr(engine, "sample_count", None)
                        if engine is not None else None)
        self._maybe_emit_startup(step - n, sample_count)
        counters = self.registry.counters_snapshot()
        event.setdefault("counters", {}).update(counters)
        self.registry.emit_event(event, sample_count=sample_count)
        RECORDER.record("window", step=int(step), window_steps=n)
        with self._lock:
            self.last_window_event = event
        if self.fleet is not None:
            # enqueue only: the store write is a network call that must
            # not ride the delivery thread.  Ordinal = deliveries so far on
            # this rank: every rank drains at the same append counts
            # (window edges + the lockstep flush sites), so ordinals agree
            # fleet-wide without any collective.
            with self._lock:
                self._window_ordinal += 1
                ordinal = self._window_ordinal
            self.fleet.publish(ordinal, fleet_mod.make_report(
                event, rank=self._rank, counters=counters))

    def _capacity_columns(self) -> dict:
        """Measured-vs-predicted capacity (the planner handoff; the
        predictions are null in the port)."""
        out = dict(self.predictions)
        measured = _measured_peak_hbm_gb(self._device)
        if measured is not None:
            out["measured_peak_hbm_gb"] = round(measured, 4)
            pred = out.get("predicted_peak_hbm_gb")
            if pred:
                out["hbm_drift"] = round(measured / pred, 4)
        if self.measured_boundary_ms is not None:
            out["measured_boundary_ms"] = round(self.measured_boundary_ms, 4)
            pred = out.get("predicted_boundary_ms")
            if pred:
                out["boundary_drift"] = round(
                    self.measured_boundary_ms / pred, 4)
        return out

    # --------------------------------------------------- engine-facing hooks
    def note_fused_plan(self, plan) -> None:
        """Adopt the capacity plan the engine's gate computed: the drift
        columns do not trace the step again for a number that exists."""
        if self.planner_drift and \
                self.predictions["predicted_peak_hbm_gb"] is None:
            self.predictions["predicted_peak_hbm_gb"] = round(
                plan.peak_bytes / 2 ** 30, 6)
            if plan.profile is not None:
                self.predictions["predicted_profile"] = plan.profile.name

    def note_predictions(self, engine, batch) -> None:
        """One-time planner handoff: the predicted peak of the fused step
        (the gate's plan when it ran) and the predicted boundary wire time
        of the split-API plan, reported beside the measured ones in every
        window event (``*_drift``)."""
        if self._predictions_tried or not self.planner_drift:
            return
        self._predictions_tried = True
        batch = (tuple(batch) if isinstance(batch, (tuple, list))
                 else (batch,))
        try:
            if self.predictions["predicted_peak_hbm_gb"] is None:
                self.note_fused_plan(engine.plan_capacity(batch))
            gas = engine.gradient_accumulation_steps()
            micro = tuple(x[:x.shape[0] // gas] for x in batch)
            split = engine.plan_capacity(micro, fused=False)
            if split.boundary_comm is not None:
                self.predictions["predicted_boundary_ms"] = round(
                    split.boundary_comm.predicted_time_ms(), 6)
                if split.profile is not None:
                    self.predictions["predicted_profile"] = \
                        split.profile.name
        except Exception as e:  # noqa: BLE001 - best effort
            logger.warning("telemetry: capacity-plan handoff skipped: %s", e)

    def note_spool_base_step(self, global_steps: int) -> None:
        """Anchor ring positions to engine global steps (set at the first
        spooled boundary; a resumed engine anchors at its restored step)."""
        with self._lock:
            if self._base_step is None:
                self._base_step = int(global_steps)

    def rebase_steps(self, global_steps: int) -> None:
        """Re-anchor window step numbering after a checkpoint restore:
        subsequent events report ``restored step + appends since``."""
        if self.spool is None:
            return
        with self._lock:
            self._base_step = int(global_steps) - self.spool._appended

    def note_boundary_host_seconds(self, pre_s: float,
                                   total_s: float = None) -> None:
        """Engine hook, once per optimizer boundary: ``pre_s`` is the
        host-side time from entering the armed boundary region to the
        start of the step's work (two clock reads — the per-host straggler
        signal: a rank stalling in host code pays it, a rank waiting
        inside a collective does not); ``total_s`` is the whole armed
        region's wall time, kept from the FIRST boundary as the startup
        event's ``first_dispatch_s`` (kernel builds and first launches)."""
        now = time.time()
        with self._lock:
            if self._first_step_ts is None:
                self._first_step_ts = now
                if total_s is not None:
                    self.first_dispatch_s = float(total_s)
            self._host_s += float(pre_s)
            self._host_n += 1

    def note_data_wait_seconds(self, seconds: float) -> None:
        """Driver/loader hook: host time spent blocked waiting for the
        next batch — the data-starvation detector's signal."""
        with self._lock:
            self._data_wait_s += float(seconds)
            self._data_wait_n += 1

    def _maybe_emit_startup(self, start_step: int, sample_count) -> None:
        """One startup event per process, emitted just before the first
        window event: the cold-start cost (kernel builds + restore +
        time-to-first-step) as recorded numbers — the first window's
        ``step_ms`` stays null (it contains the builds), but the cost
        itself must not be a missing value."""
        with self._lock:
            if self._startup_emitted:
                return
            self._startup_emitted = True
            first_ts = self._first_step_ts
        from deepspeed_tpu_torch.resilience import COUNTERS
        import socket as _socket
        event = {
            "schema": schema.STARTUP_SCHEMA_ID,
            "version": 2,
            "ts": time.time(),
            "rank": self._rank,
            "host": _socket.gethostname(),
            "step": max(int(start_step), 0),
            "time_to_first_step_s": (round(first_ts - self._built_ts, 4)
                                     if first_ts is not None else None),
            "first_dispatch_s": (round(self.first_dispatch_s, 4)
                                 if self.first_dispatch_s is not None
                                 else None),
            "restore_seconds": (round(COUNTERS.restore_seconds, 4)
                                or None),
            "compile_cache_hits": COUNTERS.compile_cache_hits,
            "compile_cache_misses": COUNTERS.compile_cache_misses,
        }
        self.startup_event = event
        self.registry.emit_event(event, sample_count=sample_count)

    def _emit_fleet_event(self, event: dict) -> None:
        """Aggregator-thread callback (rank 0): route the fleet event to
        the sinks and the live endpoints."""
        with self._lock:
            self.last_fleet_event = event
        RECORDER.record("fleet_window", window=event.get("window"),
                        step=event.get("step"),
                        stragglers=event.get("stragglers"),
                        missing=event.get("missing_hosts"))
        self.registry.emit_event(event)

    # ------------------------------------------------------ health endpoints
    def healthy(self) -> bool:
        """Liveness verdict for ``/healthz``: alive and not wedged (a
        fired watchdog means the process exists but trains nothing — the
        state an orchestrator should replace)."""
        from deepspeed_tpu_torch.resilience import COUNTERS
        return COUNTERS.watchdog_fires == 0

    def health_snapshot(self) -> dict:
        """``/status`` payload: engine step, last window/fleet events,
        counters — all host-side state, no fences."""
        engine = self._engine_ref()
        with self._lock:
            last_window = self.last_window_event
            last_fleet = self.last_fleet_event
        out = {
            "healthy": self.healthy(),
            "step": (int(engine.global_steps)
                     if engine is not None else None),
            "report_window": self.window,
            "fleet": self.fleet is not None,
            "last_window": last_window,
            "startup": self.startup_event,
            "counters": self.registry.counters_snapshot(),
        }
        if self._rank == 0 and self.fleet is not None:
            out["last_fleet"] = last_fleet
        return out

    def health_metrics(self) -> dict:
        """``/metrics`` payload (flat name -> number; the health server
        renders Prometheus text): counters + the last window's goodput +
        the rank-0 fleet roll-up."""
        engine = self._engine_ref()
        out = {k.replace("/", "_"): v
               for k, v in self.registry.counters_snapshot().items()
               if isinstance(v, (int, float))}
        if engine is not None:
            out["step"] = int(engine.global_steps)
        out["healthy"] = 1 if self.healthy() else 0
        # restart detection for the fleet router: uptime resets and the
        # generation ordinal increments on a --max_restarts relaunch
        from deepspeed_tpu_torch.observability import health as _health
        out["process_uptime_s"] = round(_health.process_uptime_s(), 3)
        out["replica_generation"] = _health.replica_generation()
        with self._lock:
            last_window = self.last_window_event
            last_fleet = self.last_fleet_event
        if last_window:
            for name in ("loss", "loss_mean", "grad_norm", "step_ms",
                         "samples_per_sec", "host_ms", "data_wait_ms",
                         "mfu", "window_steps", "skipped"):
                val = last_window.get(name)
                if isinstance(val, (int, float)):
                    out[f"window_{name}"] = val
        if last_fleet:
            for name in ("reported_hosts", "n_hosts", "straggler_index",
                         "step_ms_max", "step_ms_median", "host_ms_max",
                         "host_ms_median", "samples_per_sec_sum",
                         "skipped_total"):
                val = last_fleet.get(name)
                if isinstance(val, (int, float)):
                    out[f"fleet_{name}"] = val
            out["fleet_stragglers"] = len(last_fleet.get("stragglers")
                                          or [])
            out["fleet_missing_hosts"] = len(
                last_fleet.get("missing_hosts") or [])
        return out

    def emit_boundary_scalars(self, sample_count) -> None:
        """Legacy-cadence TensorBoard export (spool OFF): the same source
        snapshot the window path emits, written per boundary through the
        ONE TensorBoard sink — the dedup of the three historical write
        loops, and one owner of the tag spelling (a counters-only event
        writes no ``Train/Telemetry/*`` window scalars)."""
        self._tb.emit({"step": sample_count,
                       "counters": self.registry.counters_snapshot()},
                      sample_count=sample_count)

    def maybe_trace(self, global_steps: int) -> None:
        if self.tracer is not None:
            self.tracer.maybe_window(global_steps)

    def hang_capture_hook(self):
        """The watchdog ``on_fire`` callable (None when tracing is off)."""
        if self.tracer is None or not self.hang_capture:
            return None
        return lambda: self.tracer.capture_hang()

    def flush(self, local_only: bool = False,
              fleet_timeout: float = None) -> None:
        """Drain the final (possibly partial) window synchronously — run
        end and preemption drain; the ONE deliberate telemetry fence.
        With fleet mode on, also waits (bounded) until this rank's
        reports are published / rank 0's fleet events are emitted.

        ``local_only`` skips the cross-host fleet wait: the preemption
        drain flushes the spool BEFORE the emergency checkpoint (the
        window record must cover the drained step) but must NOT spend
        the grace period waiting on a possibly-dead peer while the
        checkpoint is still unwritten — it re-flushes with a bounded
        ``fleet_timeout`` after the save is durable."""
        if self.spool is not None:
            self.spool.flush()
        if self.fleet is not None and not local_only:
            self.fleet.flush(timeout=fleet_timeout)

    def close(self) -> None:
        self.flush()
        if self.tracer is not None:
            self.tracer.stop()
        if self.fleet is not None:
            self.fleet.close()
        if self.health is not None:
            self.health.close()
        self.registry.close()


def _measured_peak_hbm_gb(device) -> Optional[float]:
    """The device's peak allocated memory in GiB
    (``torch.cuda.max_memory_allocated``); None on the CPU."""
    import torch
    if device is None or torch.device(device).type != "cuda":
        return None
    return torch.cuda.max_memory_allocated(device) / 2 ** 30
