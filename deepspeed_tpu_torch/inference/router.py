"""Serving fleet: a least-loaded router over N InferenceEngine replicas.

The port of ``deepspeed_tpu/inference/router.py``: the layer above the
replica.  One :class:`FleetRouter` drives N replicas — each an
:class:`~deepspeed_tpu_torch.inference.engine.InferenceEngine` with its own
:class:`~deepspeed_tpu_torch.inference.scheduler.ContinuousScheduler` on
its own driver thread — and owns the fleet-level decisions:

* **Admission** — every request lands on the least-loaded HEALTHY
  replica, scored from the replica's live ``/metrics`` gauges (slots in
  use, queue depth, free pages — scraped over real HTTP when the replica
  serves a port) plus the router's own in-flight accounting.  With
  prefix **affinity** on, a request whose page-aligned prompt prefix was
  already served goes back to the replica whose page-hash index holds
  those pages, so prefix reuse keeps paying at fleet scale instead of
  being diluted 1/N by load balancing.
* **Eviction** — the moment a replica's ``/healthz`` turns 503 (its serve
  watchdog fired: alive-but-wedged is replaceable) the router evicts it
  and RESUBMITS its in-flight requests to the survivors, each with its
  ORIGINAL arrival timestamp (the ``ContinuousScheduler.evacuate``
  contract) — queue-wait and TTFT percentiles keep measuring from the
  user's submit.  Greedy decode re-derives the identical token stream
  from the prompt, so eviction is invisible in the outputs.
* **Disaggregation** — with a prefill pool configured
  (``inference.fleet.prefill_replicas``), prefill and decode run on
  SEPARATE replicas: a prefill replica runs the extend program, its
  slot's written KV page rows ship as a container artifact
  (``checkpoint.write_kv_handoff`` — atomic seal, positioned reads,
  ``io_retry``, named corruption errors) under the router's handoff
  directory, and a decode replica imports them into its own page pool
  and continues BYTE-IDENTICALLY (same weights + same tokens give the
  same page bytes).

Telemetry: one ``dstpu.telemetry.router`` v1 line per router window
(fleet tokens/s, per-replica load map, evictions/resubmits/handoffs,
affinity hits) interleaved with each replica's serve/request events on
one validator-clean stream; ``inference.fleet.health_port`` serves the
router's own /healthz /status /metrics.

Scale model: the IN-PROCESS fleet (replicas as threads over one host's
devices; on one card every replica's programs are CUDA graphs on the same
device).  At ``model_parallel_size`` mp > 1 every replica takes the same
mp ranks: the router and every replica's driver thread run on model rank
0, which sends each engine's commands to its followers on the other ranks
(``engine.lead_fleet``).  The router never closes an engine: its owner
does, after :meth:`FleetRouter.close`, under the engine's command lock,
so a driver thread that outlived its bounded join (a stall) cannot send a
command across the stop; its next dispatch raises instead.  A stall
(``resilience.chaos``) lands before the command is sent, so a stalled
leader leaves its followers waiting for a command, not inside a
collective, and an evicted replica's followers return at that close.
The decisions it encodes (admission scoring off /metrics,
503-eviction, timestamp-preserving resubmission, artifact-based KV
handoff) are the cross-host protocol; a multi-host front end speaks the
same endpoints over the network.
"""

from __future__ import annotations

import logging
import os
import queue as queue_mod
import tempfile
import threading
import time
import urllib.error
import urllib.request
from collections import deque
from typing import List, Optional

from deepspeed_tpu_torch.analysis import concurrency, lockwatch
from deepspeed_tpu_torch.inference import kvcache
from deepspeed_tpu_torch.inference.scheduler import (
    ContinuousScheduler, KVHandoff, Request, RequestResult, _check_request,
    greedy_sampler, latency_summary, percentile, request_latency_ms)

logger = logging.getLogger(__name__)

#: affinity index depth: page-chain hashes recorded per admission (a
#: deeper shared prefix than this still routes, just on its first pages)
_AFFINITY_MAX_PAGES = 16

#: max_age sentinel meaning "serve ANY cached probe result, never
#: scrape" — the only mode allowed under the router lock (the poll
#: loop owns refreshing; a missing cache still scrapes live, which
#: serve() prevents by priming every replica's caches up front)
_CACHE_ANY_AGE = float("inf")

#: affinity index size bound (insertion-ordered, oldest evicted): the
#: replicas' own prefix caches LRU pages out, so unbounded router-side
#: entries would grow forever while going stale — a bounded map keeps
#: the hot prefixes routable and the memory O(1) in requests served
_AFFINITY_MAX_ENTRIES = 4096


class _Flight:
    """Router-side record of one in-flight request — the ownership token
    the eviction path pivots on.  A completion is only accepted from the
    replica that CURRENTLY owns the flight: a wedged replica that
    un-sticks after eviction reports into the void instead of
    double-completing a resubmitted request."""

    __slots__ = ("req", "t_enqueue", "owner", "phase")

    def __init__(self, req, t_enqueue, owner, phase):
        self.req = req
        self.t_enqueue = t_enqueue
        self.owner = owner            # Replica currently serving it
        self.phase = phase            # "prefill" | "decode" | "mixed"


class Replica:
    """One serving replica under the router: engine + scheduler +
    observability endpoints + a driver thread.

    ``role`` is ``"mixed"`` (prefill AND decode — the plain fleet),
    ``"decode"`` (imports KV handoffs, never prefills) or ``"prefill"``
    (prefills + exports, never decodes).  The driver thread owns every
    engine dispatch; the router only touches the thread-safe inbox and
    the read-only load signals."""

    def __init__(self, rid: int, engine, router, role: str = "mixed",
                 health_port: int = 0, telemetry=None):
        from deepspeed_tpu_torch.inference import observability as serve_obs
        self.rid = int(rid)
        self.engine = engine
        self.router = router
        self.role = role
        self.inbox = queue_mod.Queue()
        self.stop = threading.Event()
        self.dead = False             # set by the router at eviction
        self.error = None
        self._health = None           # (monotonic ts, bool) probe cache
        self._load = None             # (monotonic ts, dict) probe cache
        self.telemetry = telemetry    # ServeTelemetry (decode/mixed)
        self.obs = None
        if health_port or serve_obs.configured(engine.config):
            self.obs = serve_obs.ServeObservability(
                engine, telemetry=telemetry, port=health_port or None)
            if telemetry is not None and telemetry.observability is None:
                telemetry.observability = self.obs
        self.sched = None
        if role != "prefill":
            self.sched = ContinuousScheduler(
                engine, sampler=router.sampler,
                on_complete=self._on_complete)
            if self.obs is not None:
                self.obs.note_scheduler(self.sched)
        self.thread = threading.Thread(
            target=self._drive_prefill if role == "prefill" else self._drive,
            daemon=True, name=f"dstpu-replica-{rid}-{role}")

    # ------------------------------------------------------------ signals
    @property
    def port(self) -> Optional[int]:
        return self.obs.port if self.obs is not None else None

    def healthy(self, max_age: Optional[float] = None) -> bool:
        """The router's eviction signal: scraped over real HTTP when the
        replica serves ``/healthz`` (the protocol a cross-host router
        speaks), read in-process otherwise.  An errored driver thread is
        unhealthy regardless.  ``max_age`` serves a cached verdict (the
        admission path must never block on a probe under the router
        lock); the poll loop passes None to force a fresh scrape."""
        if self.dead or self.error is not None:
            return False
        now = time.monotonic()
        if max_age is not None and self._health is not None \
                and now - self._health[0] <= max_age:
            return self._health[1]
        ok = self._healthy_now()
        self._health = (now, ok)
        return ok

    def _healthy_now(self) -> bool:
        if self.port is not None:
            try:
                req = urllib.request.Request(
                    f"http://127.0.0.1:{self.port}/healthz")
                with urllib.request.urlopen(req, timeout=2) as r:
                    return r.getcode() == 200
            except urllib.error.HTTPError as e:
                return e.code == 200
            except Exception:
                return False          # unreachable endpoint = not healthy
        if self.obs is not None:
            return self.obs.healthy()
        wd = self.engine.watchdog
        return not (wd is not None and wd.fired)

    def load(self, max_age: Optional[float] = None) -> dict:
        """Normalized load gauges — the admission score's inputs.  Over
        HTTP (``/metrics`` parsed as Prometheus text) when the replica
        serves a port, else the same ``health_metrics()`` dict the
        endpoint would render — one source either way.  Cached like
        :meth:`healthy` (same reason)."""
        now = time.monotonic()
        if max_age is not None and self._load is not None \
                and now - self._load[0] <= max_age:
            return self._load[1]
        out = {"slots_total": self.engine.num_slots, "slots_in_use": 0,
               "queue_depth": 0, "free_pages":
                   self.engine.pool.gauges()["free_pages"]}
        metrics = None
        if self.port is not None:
            try:
                from deepspeed_tpu_torch.observability.health import \
                    parse_prometheus_text
                req = urllib.request.Request(
                    f"http://127.0.0.1:{self.port}/metrics")
                with urllib.request.urlopen(req, timeout=2) as r:
                    parsed = parse_prometheus_text(r.read().decode())
                metrics = {k[len("dstpu_"):] if k.startswith("dstpu_")
                           else k: v for k, v in parsed.items()}
            except Exception as e:
                logger.debug("replica %d /metrics scrape failed: %s",
                             self.rid, e)
        if metrics is None and self.obs is not None:
            metrics = self.obs.health_metrics()
        if metrics:
            for name, key in (("slots_in_use", "slots_in_use"),
                              ("queue_depth", "queue_depth"),
                              ("free_pages", "pool_free_pages"),
                              ("slots_total", "slots_total")):
                val = metrics.get(key)
                if isinstance(val, (int, float)):
                    out[name] = int(val)
        elif self.sched is not None:
            out["slots_in_use"] = self.sched.active
            out["queue_depth"] = self.sched.pending
        self._load = (now, out)
        return out

    # ------------------------------------------------------------ driving
    def _on_complete(self, result: RequestResult) -> None:
        if self.telemetry is not None:
            self.telemetry.on_complete(result)
        self.router._complete(self, result)

    def _drain_inbox(self) -> int:
        moved = 0
        while True:
            try:
                item = self.inbox.get_nowait()
            except queue_mod.Empty:
                return moved
            moved += 1
            if isinstance(item, KVHandoff):
                self.sched.submit_handoff(item)
            elif item[0] == "kvh":
                # a sealed handoff artifact: positioned reads + named
                # corruption errors (checkpoint.read_kv_handoff); the
                # file is consumed — deleted once the rows are in memory.
                # A corrupt/torn artifact fails THIS request loudly
                # (back to the router for a fresh prefill) — it must
                # never kill the replica, and never import garbage.
                from deepspeed_tpu_torch import checkpoint
                _, path, rid = item
                try:
                    meta, k, v = checkpoint.read_kv_handoff(path)
                except checkpoint.CheckpointReadError as e:
                    logger.error(
                        "replica %d: KV handoff for request %d is "
                        "corrupt (%s) — returning it to the router for "
                        "a fresh prefill", self.rid, rid, e)
                    self.router._handoff_read_failed(self, rid)
                    try:
                        os.remove(path)
                    except OSError:
                        pass
                    continue
                self.sched.submit_handoff(KVHandoff(
                    req=Request(rid=int(meta["rid"]),
                                prompt=list(meta["prompt"]),
                                max_new_tokens=int(meta["max_new_tokens"]),
                                eos_id=meta.get("eos_id")),
                    prompt=list(meta["prompt"]),
                    first_token=int(meta["first_token"]),
                    k=k, v=v, n_tokens=int(meta["n_tokens"]),
                    t_enqueue=float(meta["t_enqueue"]),
                    t_admit=float(meta["t_admit"]),
                    t_first_token=float(meta["t_first_token"]),
                    path=path))
                try:
                    os.remove(path)
                except OSError:
                    pass
            else:
                req, t_enq = item
                self.sched.submit(req, now=t_enq)

    def _drive(self) -> None:
        """Decode/mixed driver: drain the inbox into the scheduler, step
        while there is work, park briefly when idle."""
        try:
            while not self.stop.is_set():
                moved = self._drain_inbox()
                if self.sched.pending or self.sched.active:
                    stats = self.sched.step()
                    if self.telemetry is not None:
                        self.telemetry.on_iteration(self.sched, stats)
                elif not moved:
                    time.sleep(self.router.idle_s)
        except BaseException as e:  # noqa: BLE001 - reported via health
            self.error = e
            logger.error("replica %d driver died: %s", self.rid, e)

    def _drive_prefill(self) -> None:
        """Prefill driver: admit → first token → export the slot's KV
        rows → seal the handoff artifact → hand back to the router.
        One request at a time through slot 0 — prefill is a single
        full-width dispatch, so slots buy nothing here."""
        eng = self.engine
        try:
            while not self.stop.is_set():
                try:
                    item = self.inbox.get(timeout=self.router.idle_s)
                except queue_mod.Empty:
                    continue
                req, t_enq = item
                t_admit = time.perf_counter()
                res = eng.admit(0, req.prompt, req.max_new_tokens)
                if res is None:
                    # transient pool refusal (overcommitted pool): back
                    # off and retry — nothing was allocated
                    self.inbox.put(item)
                    time.sleep(self.router.idle_s)
                    continue
                logits, reused = res
                tok0 = self.router.sampler(logits)
                t_first = time.perf_counter()
                pages = len(eng.pool.slot_pages(0))
                if (req.eos_id is not None and tok0 == req.eos_id) \
                        or req.max_new_tokens <= 1:
                    # one-token request: nothing to hand off — complete
                    # directly (the decode pool would only evict it)
                    eng.release(0)
                    self.router._complete(self, RequestResult(
                        rid=req.rid, tokens=[tok0],
                        finish_reason=("eos" if req.eos_id is not None
                                       and tok0 == req.eos_id
                                       else "length"),
                        ttft_s=t_first - t_enq, itl_s=[],
                        prompt_len=len(req.prompt),
                        queue_wait_s=t_admit - t_enq,
                        prefill_s=t_first - t_admit,
                        finished_ts=time.time(), slot=0,
                        prefix_hit=reused > 0, reused_tokens=reused,
                        pages_mapped=pages))
                    continue
                k, v, n_tokens = eng.export_kv(0)
                eng.release(0)
                path = os.path.join(
                    self.router.handoff_dir,
                    f"handoff_rid{req.rid}_{self.rid}.kvh")
                from deepspeed_tpu_torch import checkpoint
                checkpoint.write_kv_handoff(
                    path, k=k, v=v,
                    meta={"rid": req.rid, "prompt": list(req.prompt),
                          "max_new_tokens": req.max_new_tokens,
                          "eos_id": req.eos_id, "first_token": int(tok0),
                          "n_tokens": n_tokens, "t_enqueue": t_enq,
                          "t_admit": t_admit, "t_first_token": t_first,
                          "reused_tokens": int(reused)})
                self.router._handoff(self, req, t_enq, path)
        except BaseException as e:  # noqa: BLE001 - reported via health
            self.error = e
            logger.error("prefill replica %d driver died: %s",
                         self.rid, e)

    def close(self) -> None:
        """Stop the driver thread and ONLY THEN tear down the
        endpoints: the drive loop reads ``self.obs``/``self.sched``
        mid-tick, so closing the observability server under a live
        driver races a completion against a dead scheduler.  Bounded
        join — a wedged thread is daemonic and dies with the process.
        The engine stays open (its owner closes it, under its command
        lock, which a wedged thread's next dispatch then finds stopped).
        Never called FROM the driver thread (joining yourself
        deadlocks), which the current-thread guard enforces."""
        self.stop.set()
        if self.thread.is_alive() \
                and self.thread is not threading.current_thread():
            self.thread.join(timeout=10)
        if self.obs is not None:
            self.obs.close()


class RouterTelemetry:
    """Windowed ``dstpu.telemetry.router`` emitter over one (possibly
    shared) JSONL sink — the fleet record next to each replica's serve
    events."""

    def __init__(self, router, sink=None):
        from deepspeed_tpu_torch.observability import schema
        self.router = router
        self.sink = sink
        self.schema = schema
        self.window = 0
        self.last_event = None
        self._tokens_prev = 0
        self._t_prev = time.perf_counter()

    def emit(self) -> dict:
        r = self.router
        now = time.perf_counter()
        with r._lock:  # dstpu-lock: FleetRouter._lock
            tokens = r.tokens_out
            completed = len(r.results)
            ttft, _, queue_wait = request_latency_ms(r.results)
            snap = {
                "submitted": r.submitted, "inflight": len(r._inflight),
                "queued": len(r._queue), "evictions": r.evictions,
                "resubmits": r.resubmits, "handoffs": r.handoffs,
                "affinity_hits": r.affinity_hits,
            }
        elapsed = now - self._t_prev
        delta = tokens - self._tokens_prev
        self.window += 1
        per_replica = {}
        healthy = 0
        for rep in r.all_replicas:
            ok = rep.healthy(max_age=_CACHE_ANY_AGE)
            healthy += ok
            per_replica[str(rep.rid)] = dict(
                rep.load(max_age=_CACHE_ANY_AGE), healthy=bool(ok),
                role=rep.role, port=rep.port)
        event = {
            "schema": self.schema.ROUTER_SCHEMA_ID,
            "version": self.schema.ROUTER_SCHEMA_VERSION,
            "ts": time.time(),
            "window": self.window,
            "n_replicas": len(r.all_replicas),
            "healthy_replicas": int(healthy),
            "prefill_replicas": len(r.prefill_pool),
            "requests_submitted": snap["submitted"],
            "requests_completed": completed,
            "requests_inflight": snap["inflight"],
            "queue_depth": snap["queued"],
            "tokens_out": tokens,
            "tokens_per_sec": (round(delta / elapsed, 3)
                               if elapsed > 0 else None),
            "evictions": snap["evictions"],
            "resubmits": snap["resubmits"],
            "handoffs": snap["handoffs"],
            "affinity_hits": snap["affinity_hits"],
            "ttft_p50_ms": percentile(ttft, 50),
            "ttft_p99_ms": percentile(ttft, 99),
            "queue_wait_p50_ms": percentile(queue_wait, 50),
            "queue_wait_p99_ms": percentile(queue_wait, 99),
            "per_replica": per_replica,
        }
        self.last_event = event
        self._tokens_prev = tokens
        self._t_prev = now
        if self.sink is not None:
            self.sink.emit(event)
        return event


class RouterObservability:
    """The router's own live endpoints (``inference.fleet.health_port``)
    — the HealthServer telemetry contract over fleet-level state, so
    one curl answers "is the FLEET serving" next to each replica's
    per-process endpoints."""

    def __init__(self, router, port: int):
        from deepspeed_tpu_torch.observability import health as health_mod
        self.router = router
        self.health = None
        try:
            self.health = health_mod.HealthServer(port, self, rank=0)
        except OSError as e:
            logger.warning("fleet router: health endpoints DISABLED — "
                           "could not bind port %d: %s", port, e)

    @property
    def port(self) -> Optional[int]:
        return self.health.port if self.health is not None else None

    def healthy(self) -> bool:
        """The fleet serves as long as ONE replica is healthy."""
        return any(rep.healthy(max_age=_CACHE_ANY_AGE)
                   for rep in self.router.all_replicas)

    def health_snapshot(self) -> dict:
        r = self.router
        ok = self.healthy()
        states = {str(rep.rid): {"role": rep.role, "port": rep.port,
                                 "healthy": rep.healthy(
                                     max_age=_CACHE_ANY_AGE)}
                  for rep in r.all_replicas}
        with r._lock:  # dstpu-lock: FleetRouter._lock
            out = {
                "healthy": ok,
                "n_replicas": len(r.all_replicas),
                "prefill_replicas": len(r.prefill_pool),
                "requests_submitted": r.submitted,
                "requests_completed": len(r.results),
                "requests_inflight": len(r._inflight),
                "queue_depth": len(r._queue),
                "evictions": r.evictions,
                "resubmits": r.resubmits,
                "handoffs": r.handoffs,
                "affinity_hits": r.affinity_hits,
            }
        out["replicas"] = states
        if r.telemetry is not None:
            out["last_window"] = r.telemetry.last_event
        return out

    def health_metrics(self) -> dict:
        from deepspeed_tpu_torch.observability import health as health_mod
        r = self.router
        ok = self.healthy()
        n_healthy = sum(rep.healthy(max_age=_CACHE_ANY_AGE)
                        for rep in r.all_replicas)
        with r._lock:  # dstpu-lock: FleetRouter._lock
            out = {
                "healthy": 1 if ok else 0,
                "n_replicas": len(r.all_replicas),
                "healthy_replicas": int(n_healthy),
                "prefill_replicas": len(r.prefill_pool),
                "requests_submitted": r.submitted,
                "requests_completed": len(r.results),
                "requests_inflight": len(r._inflight),
                "queue_depth": len(r._queue),
                "tokens_out": r.tokens_out,
                "evictions": r.evictions,
                "resubmits": r.resubmits,
                "handoffs": r.handoffs,
                "affinity_hits": r.affinity_hits,
                "process_uptime_s": round(health_mod.process_uptime_s(),
                                          3),
                "replica_generation": health_mod.replica_generation(),
            }
        last = r.telemetry.last_event if r.telemetry is not None else None
        if last:
            for name in ("tokens_per_sec", "ttft_p50_ms", "ttft_p99_ms",
                         "queue_wait_p50_ms", "queue_wait_p99_ms"):
                val = last.get(name)
                if isinstance(val, (int, float)):
                    out[f"window_{name}"] = val
        return out

    def close(self) -> None:
        if self.health is not None:
            self.health.close()


class FleetRouter:
    """Least-loaded router over N serving replicas (module docstring).

    ``engines`` become the decode/mixed pool; ``prefill_engines`` (each
    built with ``inference.fleet.disaggregate: true``, like the decode
    engines) form the prefill pool — non-empty means disaggregated
    serving with KV handoff.  All engines must hold IDENTICAL weights
    (same checkpoint): greedy identity across replicas — the property
    eviction/resubmission and handoff both lean on — is only as true as
    the weights are.

    Knobs resolve config-first (the FIRST engine's ``inference.fleet``
    section) with constructor overrides; ``replica_ports`` assigns each
    replica's /healthz endpoint explicitly (base+index when the config
    sets ``inference.observability.health_port``)."""

    def __init__(self, engines: List, prefill_engines: List = (),
                 *, sampler=greedy_sampler, jsonl_path: Optional[str] = None,
                 health_port: Optional[int] = None,
                 poll_s: Optional[float] = None,
                 window_s: Optional[float] = None,
                 affinity: Optional[bool] = None,
                 handoff_dir: Optional[str] = None,
                 replica_ports: Optional[List[int]] = None,
                 window_iters: Optional[int] = None):
        if not engines:
            raise ValueError("FleetRouter needs at least one decode/"
                             "mixed replica engine")
        cfg = engines[0].config
        # build-time gate (memoized per process): with config
        # analysis.concurrency on, lint the control-plane sources BEFORE
        # standing up the thread fleet they describe — error mode
        # refuses to build on an error-severity finding
        concurrency.check_control_plane(
            cfg.analysis_concurrency_mode,
            cfg.analysis_concurrency_suppress, where="FleetRouter")
        self.sampler = sampler
        if prefill_engines and sampler is not greedy_sampler:
            raise ValueError(
                "disaggregated serving is greedy-only: the prefill "
                "pool samples the first token and the decode pool "
                "continues it — a custom sampler would have to run on "
                "both sides")
        if prefill_engines:
            for eng in list(engines) + list(prefill_engines):
                if not eng.fleet_disaggregate:
                    raise ValueError(
                        "every engine in a disaggregated fleet needs "
                        "inference.fleet.disaggregate: true (the KV "
                        "export/import programs)")
            # handoff compatibility is a BUILD error, not a replica
            # death: an import_kv shape/dtype mismatch fires inside the
            # decode replica's driver thread, where it reads as a wedge
            # — the router would evict the replica and resubmit its
            # neighbours, and a minimal 1+1 topology deadlocks into the
            # stall timeout instead of naming the misconfiguration
            def _kv_sig(e):
                s = e.cache_spec
                return (s.layers, s.kv_heads_local * s.mp_size,
                        s.head_dim, s.dtype)
            want = _kv_sig(engines[0])
            for eng in list(engines) + list(prefill_engines):
                if _kv_sig(eng) != want:
                    raise ValueError(
                        f"disaggregated fleet KV specs diverge: replica "
                        f"(layers, kv_heads, head_dim, dtype) = "
                        f"{_kv_sig(eng)} vs {want} — prefill and decode "
                        f"pools must share the cache geometry and dtype "
                        f"or the handoff rows cannot import "
                        f"byte-identically")
        self.poll_s = float(poll_s if poll_s is not None
                            else cfg.inference_fleet_poll_s)
        self.window_s = float(window_s if window_s is not None
                              else max(0.25, self.poll_s * 4))
        self.idle_s = min(0.002, self.poll_s)
        self.affinity = bool(affinity if affinity is not None
                             else cfg.inference_fleet_affinity)
        self.handoff_dir = (handoff_dir
                            or cfg.inference_fleet_handoff_dir)
        # a dir the router created is the router's to remove at close
        # (artifacts are unlinked as they are consumed, but the mkdtemp
        # itself would otherwise accumulate one /tmp dir per fleet)
        self._own_handoff_dir = self.handoff_dir is None
        if self.handoff_dir is None:
            self.handoff_dir = tempfile.mkdtemp(prefix="dstpu_handoff_")
        os.makedirs(self.handoff_dir, exist_ok=True)
        jsonl_path = jsonl_path or cfg.inference_fleet_jsonl_path

        # one shared sink: router windows + every replica's serve and
        # request events interleave on ONE validator-clean stream
        self._sink = None
        if jsonl_path:
            from deepspeed_tpu_torch.observability.registry import JsonlSink
            self._sink = JsonlSink(jsonl_path)

        # created through the lockwatch factory: a plain Lock unless
        # the sanitizer is armed (DSTPU_LOCKWATCH=1 / instrument()),
        # then an InstrumentedLock recording order edges and wait/held
        # durations under this canonical name
        self._lock = lockwatch.named_lock("FleetRouter._lock")
        self._queue = deque()          # (request, t_enqueue) unassigned
        self._inflight = {}            # rid -> _Flight
        self.results: List[RequestResult] = []
        self.submitted = 0
        self.tokens_out = 0
        self.evictions = 0
        self.resubmits = 0
        self.handoffs = 0
        self.affinity_hits = 0
        self._affinity_map = {}        # page-chain hash -> replica

        base_port = int(cfg.inference_obs_health_port or 0)
        if not base_port:
            from deepspeed_tpu_torch.observability import health as health_mod
            env_port = health_mod.resolve_health_port(0)
            base_port = int(env_port or 0)

        def _port(i):
            if replica_ports is not None:
                return int(replica_ports[i]) if i < len(replica_ports) \
                    else 0
            return base_port + i if base_port else 0

        self.replicas: List[Replica] = []
        self.prefill_pool: List[Replica] = []
        idx = 0
        from deepspeed_tpu_torch.inference.driver import ServeTelemetry
        for eng in engines:
            tel = None
            if self._sink is not None:
                # jsonl_path="" (not None) suppresses the constructor's
                # config-path fallback — None would open the replica's
                # own configured sink only to leak it when the fleet's
                # shared sink is swapped in below
                tel = ServeTelemetry(eng, jsonl_path="",
                                     window_iters=window_iters,
                                     request_events=True)
                tel.sink = self._sink
            elif eng.config.inference_obs_jsonl_path:
                # no fleet-level sink: the replica's own configured
                # stream must still be honored (the observability knob
                # cannot be silently ignored in fleet mode)
                tel = ServeTelemetry(eng, window_iters=window_iters)
            self.replicas.append(Replica(
                idx, eng, self,
                role="decode" if prefill_engines else "mixed",
                health_port=_port(idx), telemetry=tel))
            idx += 1
        for eng in prefill_engines:
            self.prefill_pool.append(Replica(
                idx, eng, self, role="prefill",
                health_port=_port(idx)))
            idx += 1
        self.all_replicas = self.replicas + self.prefill_pool

        self.telemetry = RouterTelemetry(self, sink=self._sink)
        self.obs = None
        fleet_port = (health_port if health_port is not None
                      else cfg.inference_fleet_health_port)
        if fleet_port:
            self.obs = RouterObservability(self, int(fleet_port))
        self._started = False
        # affinity hashing uses the decode pool's page size (all engines
        # share one cache spec in a coherent fleet)
        self._page_tokens = engines[0].cache_spec.page_tokens

    # ------------------------------------------------------------ intake
    def start(self) -> None:
        """Capture every replica's programs (its CUDA graphs), one replica
        after the other, then start the driver threads: a graph capture
        must not overlap another thread's work on the device."""
        if self._started:
            return
        self._started = True
        for rep in self.all_replicas:
            rep.engine.capture_programs()
        for rep in self.all_replicas:
            rep.thread.start()

    def submit(self, request: Request, now: Optional[float] = None):
        """Accept a request into the fleet (timestamped NOW unless the
        caller preserves an earlier arrival).  Budget-checked HERE,
        before any replica owns it: an over-budget request must be the
        submitter's loud error — handed to a driver thread it would
        kill the replica, be resubmitted by the eviction path, and
        serially wedge the whole fleet."""
        _check_request(self.replicas[0].engine, request)
        with self._lock:
            self._queue.append((request, time.perf_counter()
                                if now is None else now))
            self.submitted += 1

    # --------------------------------------------------------- callbacks
    # dstpu-thread: driver-callback owner-check=owner
    def _complete(self, replica: Replica, result: RequestResult) -> None:
        """Driver-thread completion: accepted only from the CURRENT
        owner — a zombie replica un-sticking after eviction must not
        double-complete a request the fleet already re-served."""
        with self._lock:
            flight = self._inflight.get(result.rid)
            if flight is None or flight.owner is not replica:
                logger.info(
                    "dropping completion of request %d from evicted "
                    "replica %d (re-owned elsewhere)", result.rid,
                    replica.rid)
                return
            del self._inflight[result.rid]
            self.results.append(result)
            self.tokens_out += len(result.tokens)

    # dstpu-thread: prefill-callback owner-check=owner
    def _handoff(self, prefill_rep: Replica, req, t_enq,
                 path: str) -> None:
        """Prefill-thread handoff: route the sealed artifact to the
        least-loaded healthy DECODE replica (ownership moves with it).
        The critical section is bookkeeping ONLY — the artifact unlink
        (file IO) happens after the lock is released, or every
        completion callback in the fleet stalls behind the filesystem."""
        target = None
        with self._lock:
            flight = self._inflight.get(req.rid)
            if flight is None or flight.owner is not prefill_rep:
                pass                  # ownership moved: drop the artifact
            elif (target := self._pick(self.replicas, req,
                                       record_affinity=False)) is None:
                # no healthy decode replica RIGHT NOW: requeue at the
                # router with the original timestamp; the tick loop
                # re-dispatches (possibly re-prefilling elsewhere)
                del self._inflight[req.rid]
                self._queue.appendleft((req, t_enq))
            else:
                flight.owner = target
                flight.phase = "decode"
                self.handoffs += 1
        if target is None:
            try:
                os.remove(path)
            except OSError:
                pass
            return
        target.inbox.put(("kvh", path, req.rid))
        if target.dead:
            # raced an eviction: _evict's inbox drain may have run
            # before the put landed, so nothing would ever consume the
            # artifact (the request itself was already resubmitted from
            # _inflight) — unlink it here; a double-remove is harmless
            try:
                os.remove(path)
            except OSError:
                pass

    # dstpu-thread: decode-callback owner-check=owner
    def _handoff_read_failed(self, replica: Replica, rid: int) -> None:
        """Decode-thread report of a corrupt handoff artifact: the ONE
        affected request re-enters the fleet queue with its original
        timestamp (a fresh prefill re-derives the identical stream);
        the replica stays healthy — a torn file on the handoff path is
        the request's problem, not the replica's."""
        with self._lock:
            flight = self._inflight.get(rid)
            if flight is None or flight.owner is not replica:
                return
            del self._inflight[rid]
            self._queue.appendleft((flight.req, flight.t_enqueue))

    # --------------------------------------------------------- admission
    def _prefix_hashes(self, prompt) -> list:
        return kvcache.prefix_page_hashes(
            prompt, self._page_tokens, max_pages=_AFFINITY_MAX_PAGES)

    # dstpu-thread: admission holds=FleetRouter._lock
    def _pick(self, pool: List[Replica], req,
              record_affinity: bool = True) -> Optional[Replica]:
        """Admission policy (call with the lock held): prefix affinity
        first — the replica whose page-hash index already holds the
        prompt's page-aligned prefix serves it again (the deepest
        recorded chain wins) — then least-loaded by (in-flight share of
        slots, queue depth, -free pages)."""
        candidates = [r for r in pool if not r.dead and r.error is None]
        if not candidates:
            return None
        # cached verdicts only — ANY age: this runs under the router
        # lock (the prefill thread's _handoff too), and a live HTTP
        # probe here would stall every completion callback behind a 2 s
        # socket timeout.  serve() primes both caches before the loop
        # and its poll cadence refreshes them, so "stale" here means at
        # most one poll interval old.
        max_age = _CACHE_ANY_AGE
        healthy = [r for r in candidates if r.healthy(max_age=max_age)]
        if not healthy:
            return None
        counts = {}
        for flight in self._inflight.values():
            counts[flight.owner.rid] = counts.get(flight.owner.rid, 0) + 1
        hashes = self._prefix_hashes(req.prompt) if self.affinity else []
        chosen, via_affinity = None, False
        for h in reversed(hashes):          # deepest chain first
            rep = self._affinity_map.get(h)
            if rep is not None and rep in healthy:
                # affinity yields to overload: a full replica with the
                # prefix is still slower than a re-prefill elsewhere
                if counts.get(rep.rid, 0) < 2 * rep.engine.num_slots:
                    chosen, via_affinity = rep, True
                break
        if chosen is None:
            def score(rep):
                load = rep.load(max_age=max_age)
                inflight = counts.get(rep.rid, 0)
                return (inflight / max(1, load["slots_total"]),
                        load["queue_depth"], -load["free_pages"],
                        rep.rid)
            chosen = min(healthy, key=score)
            if counts.get(chosen.rid, 0) >= 2 * chosen.engine.num_slots:
                return None               # backlogged fleet: stay queued
        if via_affinity:
            self.affinity_hits += 1
        if record_affinity and self.affinity:
            for h in hashes:
                # re-inserting keeps the entry fresh in insertion order
                self._affinity_map.pop(h, None)
                self._affinity_map[h] = chosen
            while len(self._affinity_map) > _AFFINITY_MAX_ENTRIES:
                self._affinity_map.pop(
                    next(iter(self._affinity_map)))
        return chosen

    def _dispatch(self) -> None:
        # a fully-evicted prefill pool falls back to the decode/mixed
        # replicas — they are full engines and can prefill; a dead
        # prefill pool must degrade the fleet to mixed serving, not
        # stall intake until the stall timeout fires
        alive_prefill = [r for r in self.prefill_pool
                         if not r.dead and r.error is None]
        intake = alive_prefill or self.replicas
        phase = "prefill" if alive_prefill else "mixed"
        while True:
            with self._lock:
                if not self._queue:
                    return
                req, t_enq = self._queue[0]
                target = self._pick(intake, req)
                if target is None:
                    return
                self._queue.popleft()
                self._inflight[req.rid] = _Flight(req, t_enq, target,
                                                  phase)
            target.inbox.put((req, t_enq))

    # ----------------------------------------------------------- eviction
    def _evict(self, replica: Replica) -> None:
        """503/wedge: stop routing to the replica and resubmit
        everything it owned — each request re-enters the fleet queue
        with its ORIGINAL arrival timestamp (front of the queue: they
        are the oldest work in the system)."""
        replica.dead = True
        replica.stop.set()
        # drain the inbox for CLEANUP only (unlink sealed handoff
        # artifacts): every inbox item already has an _inflight record —
        # _dispatch/_handoff record ownership BEFORE the put — so the
        # authoritative displaced set comes from _inflight alone, or a
        # request still in the inbox would resubmit twice
        while True:
            try:
                item = replica.inbox.get_nowait()
            except queue_mod.Empty:
                break
            if not isinstance(item, KVHandoff) and item[0] == "kvh":
                try:
                    os.remove(item[1])
                except OSError:
                    pass
        with self._lock:
            self.evictions += 1
            owned = {rid: f for rid, f in self._inflight.items()
                     if f.owner is replica}
            displaced = []
            for rid, flight in owned.items():
                del self._inflight[rid]
                displaced.append((flight.req, flight.t_enqueue))
            # oldest-first back at the FRONT, original timestamps intact
            for req, t_enq in sorted(displaced, key=lambda p: -p[1]):
                self._queue.appendleft((req, t_enq))
            self.resubmits += len(displaced)
            # a dead replica's prefix index is gone with it
            self._affinity_map = {h: r for h, r
                                  in self._affinity_map.items()
                                  if r is not replica}
        logger.warning(
            "router: evicted replica %d (unhealthy); resubmitted %d "
            "in-flight request(s) with original timestamps",
            replica.rid, len(displaced))

    # ------------------------------------------------------------- serving
    def serve(self, requests, timeout_s: float = 600.0,
              stall_timeout_s: float = 120.0) -> dict:
        """Drive ``requests`` through the fleet to completion; returns
        ``{"results", "summary"}`` shaped like
        :func:`~deepspeed_tpu_torch.inference.driver.run_serve` plus the
        router counters.  ``stall_timeout_s`` bounds zero-progress time
        (every replica wedged is an error, not a hang)."""
        self.start()
        # prime every replica's health/load caches BEFORE any dispatch:
        # _pick (under the router lock) reads caches only, so the first
        # admission must never be the first probe
        for rep in self.all_replicas:
            rep.healthy()
            rep.load()
        for r in requests:
            self.submit(r)
        n_total = self.submitted
        t0 = time.perf_counter()
        last_poll = last_window = t0
        last_progress = (t0, 0)
        while True:
            with self._lock:
                done = len(self.results)
            if done >= n_total and not self._inflight:
                break
            now = time.perf_counter()
            if now - t0 > timeout_s:
                raise RuntimeError(
                    f"fleet serve timed out after {timeout_s}s "
                    f"({done}/{n_total} complete)")
            if done > last_progress[1]:
                last_progress = (now, done)
            elif now - last_progress[0] > stall_timeout_s:
                raise RuntimeError(
                    f"fleet made no progress for {stall_timeout_s}s "
                    f"({done}/{n_total} complete, "
                    f"{sum(r.healthy() for r in self.all_replicas)} "
                    f"healthy replicas)")
            if now - last_poll >= self.poll_s:
                last_poll = now
                # the poll loop is the ONE place live probes happen (no
                # router lock held here): health for eviction, load for
                # the admission scores _pick reads from cache
                for rep in self.all_replicas:
                    if rep.dead:
                        continue
                    if not rep.healthy():
                        self._evict(rep)
                    else:
                        rep.load()
            self._dispatch()
            if now - last_window >= self.window_s:
                last_window = now
                self.telemetry.emit()
            time.sleep(self.idle_s)
        elapsed = time.perf_counter() - t0
        self.telemetry.emit()                 # final (partial) window
        for rep in self.replicas:
            if rep.telemetry is not None and rep.sched is not None:
                rep.telemetry.flush(rep.sched)
        with self._lock:
            results = list(self.results)
        # each replica's model group, as the JAX fleet counts its
        # replicas' mesh devices
        summary = latency_summary(
            results, elapsed,
            n_chips=sum(rep.engine.mp_world_size
                        for rep in self.all_replicas))
        summary.update({
            "n_replicas": len(self.all_replicas),
            "prefill_replicas": len(self.prefill_pool),
            "evictions": self.evictions,
            "resubmits": self.resubmits,
            "handoffs": self.handoffs,
            "affinity_hits": self.affinity_hits,
            "router_windows": self.telemetry.window,
        })
        return {"results": results, "summary": summary}

    def close(self) -> None:
        """Stop every driver thread and release the endpoints/sink.
        Wedged threads get a bounded join — a chaos stall ends when its
        watchdog reacted, so they unstick; a truly stuck thread is
        daemonic and dies with the process."""
        for rep in self.all_replicas:
            rep.stop.set()
        for rep in self.all_replicas:
            if rep.thread.is_alive():
                rep.thread.join(timeout=10)
        for rep in self.all_replicas:
            rep.close()
        if self.obs is not None:
            self.obs.close()
        if self._sink is not None:
            self._sink.close()
        if self._own_handoff_dir:
            import shutil
            shutil.rmtree(self.handoff_dir, ignore_errors=True)


def run_fleet(engines, requests, prefill_engines=(), **kwargs) -> dict:
    """Convenience mirror of :func:`~deepspeed_tpu_torch.inference.driver.
    run_serve` for a fleet: build a :class:`FleetRouter`, serve the
    trace, close everything — crash or not."""
    serve_kwargs = {k: kwargs.pop(k) for k in ("timeout_s",
                                               "stall_timeout_s")
                    if k in kwargs}
    router = FleetRouter(engines, prefill_engines, **kwargs)
    try:
        return router.serve(requests, **serve_kwargs)
    finally:
        router.close()
