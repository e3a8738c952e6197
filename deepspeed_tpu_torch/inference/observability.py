"""Replica observability: live endpoints, serve watchdog, post-mortems.

The port of ``deepspeed_tpu/inference/observability.py``.
The serving counterpart of the training engine's Telemetry facade
(docs/observability.md "Serving view"), configured by the
``inference.observability`` section and built by :func:`run_serve` (or
explicitly, for long-lived replicas).  Three jobs:

* **Live endpoints** — the :class:`~deepspeed_tpu_torch.observability.
  health.HealthServer` reused verbatim over a serve-side facade:
  ``/healthz`` answers 200 while the replica decodes and 503 once the
  serve watchdog has fired (alive-but-wedged is replaceable — the fleet
  router's eviction signal), ``/status`` carries in-flight slots, queue
  depth and the last window/startup events, ``/metrics`` exposes the
  Prometheus gauges a least-loaded router consumes: slots in use,
  free/shared/LRU pages, prefix hit rate, speculative accept rate,
  admission refusals, tokens/s and the p50/p99 TTFT/ITL.
* **Hang capture** — a dedicated :class:`~deepspeed_tpu_torch.resilience.
  watchdog.Watchdog` armed by the engine around every prefill/decode
  dispatch (``InferenceEngine.attach_watchdog``; fused programs scale
  the deadline by their width, like the multi-step driver).  A
  fire dumps all-thread stacks enriched with the flight-recorder tail
  (admit/evict/refusal/COW/spec breadcrumbs — the dump NAMES the
  stalled program) and flips ``/healthz`` to 503.
* **Anomaly detection** — the serve detectors
  (:class:`~deepspeed_tpu_torch.observability.detectors.ServeAnomalyDetector`)
  checked at every window flush: admission starvation, speculative
  accept-rate collapse, page-pool thrash — one-shot warnings + counters.

Everything here is host-side state read under locks: no fences, no
device interaction, no effect on the serving programs — greedy outputs
and the ``FENCE_COUNT`` contract are identical with it on or off
(tests/test_torch_serve_obs.py pins both).
"""

from __future__ import annotations

import logging
import os
import threading
import time
from typing import Optional

logger = logging.getLogger(__name__)


def configure_flight_recorder(config, jsonl_path=None,
                              rank=None) -> None:
    """Point the process flight recorder at the serve dump destination
    and arm the CI exit dump — the ONE owner of serve dump placement
    (ServeTelemetry and ServeObservability both route here, so a
    configured ``flight_recorder_dir`` wins no matter which of them
    builds first, with or without a ServeObservability driver).

    Resolution: ``inference.observability.flight_recorder_dir`` beats
    the (runtime, then config) JSONL log's directory beats whatever the
    recorder already points at (env ``DSTPU_FLIGHTREC_DIR``/cwd via
    ``resolve_dump_dir``)."""
    from deepspeed_tpu_torch.observability import flightrec
    from deepspeed_tpu_torch.observability.flightrec import RECORDER
    dump_dir = (config.inference_obs_flight_recorder_dir
                or (os.path.dirname(os.path.abspath(jsonl_path))
                    if jsonl_path else None)
                or (os.path.dirname(os.path.abspath(
                    config.inference_obs_jsonl_path))
                    if config.inference_obs_jsonl_path else None)
                or RECORDER.dump_dir)
    kwargs = {"dump_dir": dump_dir}
    if rank is not None:
        kwargs["rank"] = rank
    RECORDER.configure(**kwargs)
    flightrec.maybe_register_exit_dump()


def configured(config) -> bool:
    """Whether the ``inference.observability`` section asks for anything
    the plain telemetry window emitter does not provide (an endpoint or
    a watchdog) — :func:`~deepspeed_tpu_torch.inference.driver.run_serve`
    builds a :class:`ServeObservability` exactly when this is true."""
    from deepspeed_tpu_torch.observability import health as health_mod
    return bool(
        health_mod.resolve_health_port(config.inference_obs_health_port)
        is not None
        or config.inference_obs_watchdog_timeout_s > 0)


class ServeObservability:
    """Per-replica observability driver over one
    :class:`~deepspeed_tpu_torch.inference.engine.InferenceEngine`.

    Duck-types the HealthServer telemetry contract (``healthy()`` /
    ``health_snapshot()`` / ``health_metrics()``); reads live state from
    the engine's page pool, the scheduler the telemetry layer notes, and
    the last emitted window event."""

    def __init__(self, engine, telemetry=None, port=None):
        from deepspeed_tpu_torch.observability import detectors
        from deepspeed_tpu_torch.observability import health as health_mod

        cfg = engine.config
        self.engine = engine
        self.telemetry = telemetry
        self._lock = threading.Lock()
        self._sched = None
        self._rank = health_mod._process_rank()
        self._built_ts = time.time()

        # flight recorder: the serving path must leave the same
        # post-mortems the training path does (one shared resolver)
        configure_flight_recorder(cfg, rank=self._rank)

        # serve watchdog: armed by the engine around every dispatch
        # (InferenceEngine.attach_watchdog); a fire marks the replica
        # unhealthy and dumps stacks + the breadcrumb ring
        self.watchdog = None
        if cfg.inference_obs_watchdog_timeout_s > 0:
            from deepspeed_tpu_torch.resilience.watchdog import Watchdog
            self.watchdog = Watchdog(
                cfg.inference_obs_watchdog_timeout_s,
                abort=cfg.inference_obs_watchdog_abort)
            engine.attach_watchdog(self.watchdog)
            # a chaos stall armed via env ends when the watchdog reacted
            # (the CI chaos leg's contract: stall -> fire -> 503 -> the
            # run completes and the outputs stay exact); every replica
            # in the process registers — the stall lands in whichever
            # replica dispatches first, and only ITS watchdog fires
            from deepspeed_tpu_torch.resilience import chaos
            if chaos._state.stall_step is not None:
                chaos.add_stall_until(self.watchdog.fire_event)

        # serve anomaly detectors (window-delta checks, driver.py feeds
        # them at each flush)
        self.detector = detectors.ServeAnomalyDetector(
            starvation_windows=cfg.inference_obs_starvation_windows,
            accept_floor=cfg.inference_obs_accept_floor,
            thrash_reclaims=cfg.inference_obs_thrash_reclaims)

        # live endpoints (opt-in: inference.observability.health_port,
        # env fallback DSTPU_HEALTH_PORT, which the launcher's
        # --health_port exports; offset by process rank like the training
        # endpoints)
        # `port` overrides the config/env resolution — a fleet router
        # hosting several replicas IN ONE process assigns each its own
        # port explicitly (the rank offset cannot separate co-process
        # replicas); 0 disables, None defers to config/env
        self.health = None
        if port is None:
            port = health_mod.resolve_health_port(
                cfg.inference_obs_health_port)
        elif not port:
            port = None
        if port is not None:
            try:
                self.health = health_mod.HealthServer(
                    port, self, rank=self._rank)
            except OSError as e:
                # a taken port must not take down serving — loudly
                # degraded, like every other telemetry failure
                logger.warning(
                    "serve telemetry: health endpoints DISABLED — could "
                    "not bind port %d: %s", port, e)

    # ------------------------------------------------------------- wiring
    def note_scheduler(self, sched) -> None:
        """Adopt the live scheduler (driver.py calls this at the first
        iteration): /status and /metrics read its slot/queue state."""
        with self._lock:
            self._sched = sched

    @property
    def port(self) -> Optional[int]:
        return self.health.port if self.health is not None else None

    # ----------------------------------------------- HealthServer contract
    def healthy(self) -> bool:
        """Liveness verdict for ``/healthz``: alive and not wedged.  A
        fired serve watchdog means the replica exists but serves nothing
        — the state a fleet router should evict and replace."""
        wd = self.watchdog or self.engine.watchdog
        return not (wd is not None and wd.fired)

    def _last_event(self):
        tel = self.telemetry
        return tel.last_event if tel is not None else None

    def health_snapshot(self) -> dict:
        """``/status`` payload: replica identity, in-flight slots, queue
        depth, pool gauges, the last window + startup events — all
        host-side state, no fences."""
        with self._lock:
            sched = self._sched
        tel = self.telemetry
        out = {
            "healthy": self.healthy(),
            "model_parallel": self.engine.mp_world_size,
            "graphs": self.engine.graphs,
            "slots": self.engine.num_slots,
            "slots_in_use": (sched.active if sched is not None else 0),
            "queue_depth": (sched.pending if sched is not None else 0),
            "decode_iters": (sched.decode_iters
                             if sched is not None else 0),
            "requests_completed": (sched.evicted
                                   if sched is not None else 0),
            "uptime_s": round(time.time() - self._built_ts, 3),
            "loaded_tag": self.engine.loaded_tag,
            "pool": self.engine.pool.gauges(),
            "last_window": self._last_event(),
            "startup": (self.engine.startup_event()
                        if self.engine.first_token_ts else None),
            "watchdog_fired": not self.healthy(),
        }
        if tel is not None:
            out["requests_emitted"] = tel.request_events_emitted
        return out

    def health_metrics(self) -> dict:
        """``/metrics`` payload (flat name -> number; the health server
        renders Prometheus text): the load signals a least-loaded router
        consumes, plus the detector/resilience counters."""
        from deepspeed_tpu_torch.observability import detectors
        from deepspeed_tpu_torch.resilience import COUNTERS
        with self._lock:
            sched = self._sched
        from deepspeed_tpu_torch.observability import health as health_mod
        out = {
            "healthy": 1 if self.healthy() else 0,
            "slots_total": self.engine.num_slots,
            "watchdog_fires": COUNTERS.watchdog_fires,
            # restart detection (the router's replica-identity signals):
            # uptime resets and the generation ordinal increments when
            # the launcher relaunches a wedged/preempted replica
            "process_uptime_s": round(health_mod.process_uptime_s(), 3),
            "replica_generation": health_mod.replica_generation(),
        }
        for k, v in self.engine.pool.gauges().items():
            out[f"pool_{k}"] = v
        for k, v in detectors.SERVE_COUNTERS.as_dict().items():
            out[k] = v
        if self.engine.restore_seconds is not None:
            out["restore_seconds"] = round(self.engine.restore_seconds, 4)
        if sched is not None:
            out["slots_in_use"] = sched.active
            out["queue_depth"] = sched.pending
            out["decode_iters"] = sched.decode_iters
            out["requests_admitted"] = sched.admitted
            out["requests_completed"] = sched.evicted
            out["admission_refusals"] = sched.admission_refusals
            if sched.admitted:
                out["prefix_hit_rate"] = round(
                    sched.prefix_hits / sched.admitted, 4)
            if sched.spec_proposed:
                out["spec_accept_rate"] = round(
                    sched.spec_accepted / sched.spec_proposed, 4)
        last = self._last_event()
        if last:
            for name in ("tokens_per_sec", "ttft_p50_ms", "ttft_p99_ms",
                         "itl_p50_ms", "itl_p99_ms", "itl_mean_ms",
                         "queue_wait_p50_ms", "queue_wait_p99_ms",
                         "tokens_out", "active_slots_mean",
                         "requests_completed"):
                val = last.get(name)
                if isinstance(val, (int, float)) \
                        and not isinstance(val, bool):
                    out[f"window_{name}"] = val
        return out

    def close(self) -> None:
        if self.health is not None:
            self.health.close()
