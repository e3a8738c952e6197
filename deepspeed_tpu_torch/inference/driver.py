"""Synthetic heavy-traffic driver + serve telemetry.

The port of ``deepspeed_tpu/inference/driver.py``.
The driver generates a deterministic request trace (seeded prompt/length
mix — the "millions of users" stand-in every serving bench and CI smoke
run replays identically), runs it through a scheduler, and reports the
serving headline numbers: tokens/s/chip and p50/p99 time-to-first-token
and inter-token latency.

Telemetry rides the port's ``observability/`` machinery, three event kinds
on one stream (``python -m deepspeed_tpu_torch.observability`` validates
all of them, as the JAX CLI does):

* ``dstpu.telemetry.serve`` v3 — one line per window of decode
  iterations, with live slot/page-pool gauges and latency percentiles
  derived from PER-REQUEST records (the old pooled per-token percentiles
  honestly collapsed to 0 under fused decode).
* ``dstpu.telemetry.request`` v1 — one line per COMPLETED request: the
  whole lifecycle (queue wait → prefill → decode → eviction) plus its
  prefix-reuse facts, emitted at eviction via the scheduler's
  ``on_complete`` hook.
* ``dstpu.telemetry.startup`` v2 — the cold-start record (restore
  latency + compile-cache counters), once at the first token.

The serve anomaly detectors run at each window flush; live endpoints and
the serve watchdog are
:class:`~deepspeed_tpu_torch.inference.observability.ServeObservability`'s
job
— :func:`run_serve` builds one automatically when the
``inference.observability`` config asks for it.
"""

from __future__ import annotations

import logging
import time
from typing import List, Optional

import numpy as np
import torch

from deepspeed_tpu_torch.inference.scheduler import (ContinuousScheduler, Request,
                                               latency_samples_ms,
                                               latency_summary, percentile,
                                               request_latency_ms)

logger = logging.getLogger(__name__)


def synthetic_requests(n: int, *, vocab: int, seed: int = 0,
                       prompt_min: int = 4, prompt_max: int = 24,
                       new_min: int = 4, new_max: int = 24,
                       eos_id: Optional[int] = None) -> List[Request]:
    """Deterministic mixed-length trace: uniform prompt lengths and
    token budgets — the variance is what makes continuous batching win
    (uniform-length traffic would let static batching tie)."""
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(n):
        plen = int(rng.integers(prompt_min, prompt_max + 1))
        prompt = rng.integers(0, vocab, size=plen).astype(int).tolist()
        reqs.append(Request(
            rid=i, prompt=prompt,
            max_new_tokens=int(rng.integers(new_min, new_max + 1)),
            eos_id=eos_id))
    return reqs


class ServeTelemetry:
    """Windowed serve-event emitter: every ``window_iters`` scheduler
    iterations fold into one ``dstpu.telemetry.serve`` line (v3: live
    gauges + per-request-derived percentiles); each completed request
    emits one ``dstpu.telemetry.request`` line (``request_events``); the
    startup event goes out once, at the first token (when restore
    latency and the compile-cache counters are all known facts)."""

    def __init__(self, engine, jsonl_path: Optional[str] = None,
                 window_iters: Optional[int] = None,
                 request_events: Optional[bool] = None,
                 observability=None):
        cfg = engine.config
        if jsonl_path is None:
            jsonl_path = cfg.inference_obs_jsonl_path
        if window_iters is None:
            window_iters = cfg.inference_obs_window_iters
        if request_events is None:
            request_events = cfg.inference_obs_request_events
        if window_iters < 1:
            raise ValueError("window_iters must be >= 1")
        self.engine = engine
        self.window_iters = int(window_iters)
        self.request_events = bool(request_events)
        self.request_events_emitted = 0
        self.observability = observability
        self.sink = None
        if jsonl_path:
            from deepspeed_tpu_torch.observability.registry import JsonlSink
            self.sink = JsonlSink(jsonl_path)
        # crash/exit post-mortems (DSTPU_FLIGHTREC_DUMP_AT_EXIT=1 in CI)
        # must work for a serving process exactly like a training one —
        # inference/observability.py owns the dump-dir resolution
        # (configured flight_recorder_dir beats the JSONL directory)
        from deepspeed_tpu_torch.inference.observability import \
            configure_flight_recorder
        configure_flight_recorder(cfg, jsonl_path=jsonl_path)
        self._startup_emitted = False
        self._window = 0
        self._evicted_prev = 0
        self._gauges_prev = dict(engine.pool.gauges())
        self._spec_prev = (0, 0)
        self._reset_window()
        self.last_event = None

    def _reset_window(self):
        self._iters = 0
        self._tokens = 0
        self._admitted = 0
        self._active_sum = 0
        self._queue_depth = 0
        self._t0 = time.perf_counter()

    def _emit(self, event: dict):
        from deepspeed_tpu_torch.observability import schema
        if event.get("schema") == schema.SERVE_SCHEMA_ID:
            # the endpoints' "last window" must be a WINDOW event —
            # request/startup lines share the stream but not the slot
            self.last_event = event
        if self.sink is not None:
            self.sink.emit(event)

    def on_iteration(self, sched, stats: dict):
        """Scheduler hook (``ContinuousScheduler(on_event=...)``)."""
        if not self._startup_emitted and self.engine.first_token_ts:
            self._startup_emitted = True
            self._emit(self.engine.startup_event())
        if self.observability is not None:
            self.observability.note_scheduler(sched)
        self._iters += 1
        self._tokens += stats["tokens_out"]
        self._admitted += stats["admitted"]
        self._active_sum += stats["active"]
        self._queue_depth = stats["queue_depth"]
        if self._iters >= self.window_iters:
            self.flush(sched)

    def on_complete(self, result) -> None:
        """Scheduler hook (``ContinuousScheduler(on_complete=...)``):
        one ``dstpu.telemetry.request`` line per completed request —
        the lifecycle record the summary percentiles are derived from,
        now also a queryable artifact.  Without a JSONL sink there is
        nowhere to write, so nothing is built or COUNTED — the
        summary's ``request_events`` must only claim lines that exist."""
        if not self.request_events or self.sink is None:
            return
        from deepspeed_tpu_torch.observability import schema

        def ms(x):
            return None if x is None else round(x * 1e3, 4)

        itl = result.itl_s
        self.request_events_emitted += 1
        self._emit({
            "schema": schema.REQUEST_SCHEMA_ID,
            "version": schema.REQUEST_SCHEMA_VERSION,
            "ts": result.finished_ts or time.time(),
            "rid": int(result.rid),
            "slot": int(result.slot) if result.slot is not None else -1,
            "prompt_tokens": int(result.prompt_len),
            "tokens_out": len(result.tokens),
            "finish_reason": result.finish_reason,
            "queue_wait_ms": ms(result.queue_wait_s),
            "prefill_ms": ms(result.prefill_s),
            "ttft_ms": ms(result.ttft_s),
            "decode_ms": ms(result.decode_s),
            "itl_mean_ms": ms(result.itl_mean_s),
            "itl_max_ms": ms(max(itl)) if itl else None,
            "prefix_hit": bool(result.prefix_hit),
            "prefix_tokens_reused": int(result.reused_tokens),
            "pages_mapped": int(result.pages_mapped),
        })

    def flush(self, sched):
        """Emit the current (possibly partial) window; final partial
        windows are part of the record, like the training spool's."""
        if self._iters == 0:
            return
        from deepspeed_tpu_torch.observability import detectors, schema
        from deepspeed_tpu_torch.resilience import COUNTERS
        elapsed = time.perf_counter() - self._t0
        # percentiles over the run's completed PER-REQUEST records
        # (each request = one TTFT / mean-ITL / queue-wait sample —
        # meaningful at any decode_iters_per_dispatch; bench/CI traces
        # are bounded, a long-lived replica would swap in reservoir
        # sampling here to bound the per-window cost)
        ttft, itl_req, queue_wait = request_latency_ms(sched.results)
        _, itl_pooled = latency_samples_ms(sched.results)
        self._window += 1
        spec = self.engine.cache_spec
        from deepspeed_tpu_torch.inference import kvcache
        gauges = self.engine.pool.gauges()
        counters = COUNTERS.as_dict()
        counters.update(detectors.SERVE_COUNTERS.as_dict())
        event = {
            "schema": schema.SERVE_SCHEMA_ID,
            "version": schema.SERVE_SCHEMA_VERSION,
            "ts": time.time(),
            "window": self._window,
            "decode_iters": self._iters,
            "tokens_out": self._tokens,
            "admitted": self._admitted,
            "evicted": sched.evicted,
            "active_slots_mean": round(self._active_sum
                                       / max(1, self._iters), 3),
            "queue_depth": self._queue_depth,
            "slots": spec.slots,
            "kv_cache_gb": round(kvcache.cache_bytes(spec) / 2 ** 30, 6),
            "tokens_per_sec": (round(self._tokens / elapsed, 3)
                               if elapsed > 0 else None),
            "ttft_p50_ms": percentile(ttft, 50),
            "ttft_p99_ms": percentile(ttft, 99),
            "itl_p50_ms": percentile(itl_req, 50),
            "itl_p99_ms": percentile(itl_req, 99),
            # ---- v2: prefix reuse + speculative decoding (cumulative
            # over the scheduler's lifetime, like `evicted`)
            "prefix_hits": int(getattr(sched, "prefix_hits", 0)),
            "prefix_tokens_reused": int(getattr(sched,
                                                "prefix_tokens_reused", 0)),
            "spec_proposed": int(getattr(sched, "spec_proposed", 0)),
            "spec_accepted": int(getattr(sched, "spec_accepted", 0)),
            # ---- v3: replica observability (live gauges + per-request
            # latency breakdowns; docs/observability.md "Serving view")
            "requests_completed": sched.evicted - self._evicted_prev,
            "queue_wait_p50_ms": percentile(queue_wait, 50),
            "queue_wait_p99_ms": percentile(queue_wait, 99),
            "itl_mean_ms": (round(float(np.mean(itl_pooled)), 4)
                            if itl_pooled else None),
            "slots_in_use": sched.active,
            "free_pages": gauges["free_pages"],
            "lru_pages": gauges["lru_pages"],
            "shared_pages": gauges["shared_pages"],
            "admission_refusals": int(getattr(sched,
                                              "admission_refusals", 0)),
            "counters": counters,
        }
        self._emit(event)
        self._evicted_prev = sched.evicted
        # serve anomaly detectors: window deltas of the pool/spec
        # counters (one-shot warnings + counters — the next window's
        # event carries the updated roll-up)
        if self.observability is not None:
            spec_prop = event["spec_proposed"]
            spec_acc = event["spec_accepted"]
            self.observability.detector.check_window(
                queue_depth=self._queue_depth,
                admitted=self._admitted,
                refusals_delta=(gauges["admission_refusals"]
                                - self._gauges_prev["admission_refusals"]),
                spec_proposed_delta=spec_prop - self._spec_prev[0],
                spec_accepted_delta=spec_acc - self._spec_prev[1],
                lru_reclaims_delta=(gauges["lru_reclaims"]
                                    - self._gauges_prev["lru_reclaims"]),
                prefix_hits_delta=(gauges["prefix_hits"]
                                   - self._gauges_prev["prefix_hits"]))
            self._spec_prev = (spec_prop, spec_acc)
        self._gauges_prev = gauges
        self._reset_window()

    def close(self):
        if self.sink is not None:
            self.sink.close()


def run_serve(engine, requests, *, jsonl_path: Optional[str] = None,
              window_iters: Optional[int] = None, sampler=None,
              observability=None) -> dict:
    """Run ``requests`` through continuous batching with telemetry;
    returns ``{"results", "summary"}`` where summary is
    :func:`~deepspeed_tpu_torch.inference.scheduler.latency_summary` plus the
    scheduler's utilization counters.

    When the engine's ``inference.observability`` config enables a
    health port or a watchdog (and no ``observability`` driver was
    passed in), a :class:`~deepspeed_tpu_torch.inference.observability.
    ServeObservability` is built for the run and closed with it.  A
    crash anywhere in the drain dumps the flight-recorder ring
    (``flightrec_rank<r>_crash.json``) before propagating — serving
    post-mortems ride the same hook as training ones."""
    from deepspeed_tpu_torch.inference import observability as serve_obs
    from deepspeed_tpu_torch.inference.scheduler import greedy_sampler
    from deepspeed_tpu_torch.observability.flightrec import RECORDER
    obs, own_obs = observability, False
    if obs is None and serve_obs.configured(engine.config):
        obs = serve_obs.ServeObservability(engine)
        own_obs = True
    tel = ServeTelemetry(engine, jsonl_path=jsonl_path,
                         window_iters=window_iters, observability=obs)
    if obs is not None and obs.telemetry is None:
        obs.telemetry = tel
    sched = ContinuousScheduler(engine, sampler=sampler or greedy_sampler,
                                on_event=tel.on_iteration,
                                on_complete=tel.on_complete)
    if obs is not None:
        obs.note_scheduler(sched)
    t0 = time.perf_counter()
    try:
        results = sched.run(requests)
    except BaseException:
        # crash exit: leave the breadcrumb ring on disk so the
        # post-mortem names the admit/decode the replica died in —
        # best-effort, never masks the crash (the training driver's
        # contract, now shared by the serving path)
        RECORDER.record("crash", where="serve",
                        decode_iters=sched.decode_iters,
                        active=sched.active, queued=sched.pending)
        RECORDER.dump("crash")
        raise
    finally:
        if own_obs:
            obs.close()
    elapsed = time.perf_counter() - t0
    tel.flush(sched)
    tel.close()
    summary = latency_summary(results, elapsed, n_chips=1)
    prompt_tokens = sum(r.prompt_len for r in results)
    summary.update({
        "decode_iters": sched.decode_iters,
        "admitted": sched.admitted,
        "evicted": sched.evicted,
        "slots": engine.num_slots,
        "quantize": engine.quantize,
        "dtype": str(engine.compute_dtype).replace("torch.", ""),
        "mp": engine.mp_world_size,
        "platform": "gpu" if engine.device.type == "cuda" else "cpu",
        "device_kind": (torch.cuda.get_device_name(engine.device)
                        if engine.device.type == "cuda" else "cpu"),
        # prefix reuse: hit rate over admissions, prompt tokens whose
        # prefill was served from shared pages instead of recomputed
        "prefix_hit_rate": (round(sched.prefix_hits
                                  / sched.admitted, 4)
                            if sched.admitted else None),
        "prefill_tokens_saved": sched.prefix_tokens_reused,
        "prefill_tokens_total": prompt_tokens,
        "admission_refusals": sched.admission_refusals,
        # speculative decoding: accepted draft proposals / proposed
        "spec_accept_rate": (round(sched.spec_accepted
                                   / sched.spec_proposed, 4)
                             if sched.spec_proposed else None),
        "spec_proposed": sched.spec_proposed,
        "spec_accepted": sched.spec_accepted,
        "draft_params": (_count_tree_params(engine.draft_params)
                         if engine.draft_params is not None else None),
        "request_events": tel.request_events_emitted,
    })
    return {"results": results, "summary": summary}


def _count_tree_params(tree) -> int:
    from deepspeed_tpu_torch.inference.engine import _tree_leaves
    return int(sum(t.numel() for t in _tree_leaves(tree)))
