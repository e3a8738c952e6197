"""Cross-host telemetry aggregation: the fleet view.

The port of ``deepspeed_tpu/observability/fleet.py``.  Each process ships
its window report OUT OF BAND to rank 0, which emits one
``dstpu.telemetry.fleet`` event per window with per-host timing spreads, a
straggler index, anomaly and counter roll-ups.

Transport rules (the hard constraint):

* **never a gloo or NCCL collective**: a collective would join the step's
  collective sequence and add rendezvous stalls to the hot path.
* reports ride the c10d key-value **store** the process group already
  rendezvoused through (a ``TCPStore``, ``FileStore`` or ``PrefixStore``):
  one JSON value per host per window under the fixed key
  ``fleet/<ordinal>/<rank>`` (in a ``PrefixStore`` per engine), written
  by a background publisher thread, read by rank 0's aggregator thread
  after the non-blocking ``check``: a late host is simply absent, which is
  itself the straggler / hang-precursor signal.
* nothing here runs on the training thread: the window delivery only
  enqueues; publishing, polling and aggregation happen on daemon threads.

Aggregation contract: rank 0 emits the fleet event for window *w* when
every host's report arrived, or ``fleet_wait_s`` after the first report,
whichever comes first.  Hosts missing at the deadline are listed in
``missing_hosts`` and counted (``fleet_reports_missing``).
"""

from __future__ import annotations

import json
import logging
import queue
import socket
import statistics
import threading
import time
from typing import Callable, Optional

from deepspeed_tpu_torch.observability import detectors, schema

logger = logging.getLogger(__name__)

#: key namespace of one engine's reports; the instance counter keeps
#: engines built in the same process (in the same order on every rank)
#: apart
_KEY_ROOT = "dstpu"
_instance_counter = 0
_instance_lock = threading.Lock()

#: aggregator poll cadence while waiting for peer reports
_POLL_S = 0.05

#: per-host report fields summarized into the fleet event (the rest of
#: the report rides verbatim under ``per_host``)
_SUMMARY = ("step_ms", "host_ms")


def _next_instance() -> int:
    global _instance_counter
    with _instance_lock:
        _instance_counter += 1
        return _instance_counter


def _default_store():
    """The c10d store the default process group rendezvoused through, or
    None (one process, or no started group)."""
    try:
        import torch.distributed as dist
        if not (dist.is_available() and dist.is_initialized()) \
                or dist.get_world_size() == 1:
            return None
        from torch.distributed import distributed_c10d
        return distributed_c10d._get_default_store()
    except Exception:  # pragma: no cover - defensive
        return None


def _key(ordinal: int, rank: int) -> str:
    return f"fleet/{int(ordinal)}/{int(rank)}"


class FleetAggregator:
    """Per-engine fleet aggregation driver.

    Every rank owns one; ``publish(report)`` is called from the window
    drain with the host's report dict.  Rank 0 additionally runs the
    aggregator thread that collects, detects stragglers and emits fleet
    events through ``emit`` (the Telemetry facade routes them to the
    JSONL/TensorBoard sinks and the health endpoints).
    """

    def __init__(self, world: int, rank: int, *, wait_s: float,
                 straggler_factor: float,
                 emit: Callable[[dict], None], store=None):
        self.world = int(world)
        self.rank = int(rank)
        self.wait_s = float(wait_s)
        self._emit = emit
        base = store if store is not None else _default_store()
        self._prefix = f"{_KEY_ROOT}/i{_next_instance()}"
        self._client = None
        if base is not None:
            import torch.distributed as dist
            self._client = dist.PrefixStore(self._prefix + "/", base)
        self._queue: "queue.Queue" = queue.Queue()
        self._stop = threading.Event()
        self._published = 0         # ordinals this rank handed off
        self._emitted = 0           # ordinals rank 0 emitted (rank 0 only)
        self._detector = detectors.StragglerDetector(straggler_factor)
        self._pending = {}          # ordinal -> {"reports", "first_ts"}
        self._stale = {}            # ordinal -> missing ranks at emit time
                                    # (late-report GC — see _gc_stale)
        self._lock = threading.Lock()
        self._thread = threading.Thread(
            target=self._run, daemon=True,
            name=f"dstpu-fleet-r{self.rank}")
        self._thread.start()

    # ------------------------------------------------------------- publish
    def publish(self, ordinal: int, report: dict) -> None:
        """Hand one window report off (delivery-thread side: enqueue only;
        the store write is a network call and runs on this aggregator's
        thread)."""
        self._published = max(self._published, int(ordinal))
        self._queue.put((int(ordinal), dict(report)))

    # ------------------------------------------------------ worker threads
    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                self._step_thread()
            except Exception as e:  # pragma: no cover - defensive
                logger.warning("fleet aggregator thread error: %s", e)
                time.sleep(_POLL_S)

    def _step_thread(self) -> None:
        try:
            ordinal, report = self._queue.get(timeout=_POLL_S)
        except queue.Empty:
            ordinal = None
        if ordinal is not None:
            try:
                if self.rank == 0:
                    self._note_report(ordinal, self.rank, report)
                else:
                    self._kv_publish(ordinal, report)
            finally:
                # flush() waits on unfinished_tasks, not queue.empty():
                # the dequeue happens BEFORE the KV RPC, and a preemption
                # exit in that gap would kill the daemon thread mid-RPC
                # and silently drop the final window's report
                self._queue.task_done()
        if self.rank == 0:
            self._collect_and_emit()

    def _kv_publish(self, ordinal: int, report: dict) -> None:
        if self._client is None:
            return
        try:
            self._client.set(_key(ordinal, self.rank), json.dumps(report))
        except Exception as e:  # pragma: no cover - transport flake
            logger.warning("fleet: publishing window %d failed: %s",
                           ordinal, e)

    # ------------------------------------------------- rank-0 aggregation
    def _note_report(self, ordinal: int, rank: int, report: dict) -> None:
        with self._lock:
            slot = self._pending.setdefault(
                ordinal, {"reports": {}, "first_ts": time.monotonic()})
            slot["reports"].setdefault(int(rank), report)

    def _poll_kv(self, ordinal: int) -> None:
        if self._client is None:
            return
        with self._lock:
            slot = self._pending.get(ordinal)
            have = set(slot["reports"]) if slot is not None else set()
        for rank in range(self.world):
            if rank in have:
                continue
            key = _key(ordinal, rank)
            try:
                # the non-blocking check first: a get of an absent key
                # would wait for it
                if not self._client.check([key]):
                    continue
                value = self._client.get(key)
                self._note_report(ordinal, rank, json.loads(value))
            except Exception as e:  # pragma: no cover - transport flake
                logger.warning("fleet: reading %r failed: %s", key, e)

    def _collect_and_emit(self) -> None:
        """Emit every pending window that is complete or past deadline, in
        ordinal order (an out-of-order fleet log would break diffing)."""
        while True:
            ordinal = self._emitted + 1
            with self._lock:
                slot = self._pending.get(ordinal)
            if slot is None:
                return
            self._poll_kv(ordinal)
            with self._lock:
                n = len(slot["reports"])
                expired = (time.monotonic() - slot["first_ts"]
                           >= self.wait_s)
            if n < self.world and not expired:
                return
            with self._lock:
                self._pending.pop(ordinal, None)
            self._emitted = ordinal
            try:
                self._emit(self._fleet_event(ordinal, slot["reports"]))
            except Exception as e:  # pragma: no cover - defensive
                logger.warning("fleet event emit failed: %s", e)
            self._kv_cleanup(ordinal, slot["reports"])
            self._gc_stale()

    def _kv_cleanup(self, ordinal: int, reports: dict) -> None:
        if self._client is None:
            return
        for rank in reports:
            if rank == 0:
                continue
            try:
                self._client.delete_key(_key(ordinal, rank))
            except Exception:  # pragma: no cover - best-effort GC
                pass
        missing = set(range(self.world)) - set(reports)
        if missing:
            self._stale[ordinal] = missing

    def _gc_stale(self) -> None:
        """Collect reports that arrived AFTER their window's deadline:
        without this a persistently slow host leaks one KV entry per
        window for the run's lifetime.  Late data is counted
        (``fleet_reports_late``) and deleted — the window already shipped
        with the rank in ``missing_hosts``.  Runs at emit cadence (one
        listing per stale window per emitted window, not per poll
        tick)."""
        if not self._stale or self._client is None:
            return
        for ordinal in sorted(self._stale):
            for rank in sorted(self._stale[ordinal]):
                key = _key(ordinal, rank)
                try:
                    late = self._client.check([key])
                except Exception:  # pragma: no cover - transport flake
                    late = False
                if not late:
                    continue
                detectors.COUNTERS.fleet_reports_late += 1
                logger.warning(
                    "fleet: rank %s reported window %d AFTER the "
                    "aggregation deadline — discarded (the fleet "
                    "event already shipped it as missing)",
                    rank, ordinal)
                self._stale[ordinal].discard(rank)
                try:
                    self._client.delete_key(key)
                except Exception:  # pragma: no cover - best-effort GC
                    pass
            if not self._stale[ordinal]:
                del self._stale[ordinal]
        # bound the tracking set: a host gone for good must not make
        # every future emit re-check dozens of dead windows
        while len(self._stale) > 16:
            self._stale.pop(min(self._stale))

    def _fleet_event(self, ordinal: int, reports: dict) -> dict:
        detectors.COUNTERS.fleet_windows += 1
        missing = sorted(set(range(self.world)) - set(reports))
        if missing:
            detectors.COUNTERS.fleet_reports_missing += len(missing)
            logger.warning(
                "fleet: window %d aggregated with rank(s) %s MISSING after "
                "%.1fs — a host that stops reporting is a hang precursor",
                ordinal, missing, self.wait_s)
        verdict = self._detector.check_fleet(reports)
        anomalies = [{"rank": r, "kind": kind}
                     for r, rep in sorted(reports.items())
                     for kind in (rep.get("anomalies") or [])]
        event = {
            "schema": schema.FLEET_SCHEMA_ID,
            "version": 2,
            "ts": time.time(),
            "window": int(ordinal),
            "step": max((int(r.get("step") or 0)
                         for r in reports.values()), default=0),
            "n_hosts": self.world,
            "reported_hosts": len(reports),
            "missing_hosts": missing,
            "samples_per_sec_sum": _sum_of(reports, "samples_per_sec"),
            "straggler_index": verdict["straggler_index"],
            "stragglers": verdict["stragglers"],
            "anomalies": anomalies,
            "loss_mean": _mean_of(reports, "loss_mean"),
            "loss_spread": _spread_of(reports, "loss_mean"),
            "skipped_total": int(_sum_of(reports, "skipped") or 0),
            "counters": _rollup_counters(reports),
            "per_host": {str(r): rep for r, rep in sorted(reports.items())},
        }
        for name in _SUMMARY:
            vals = [float(r[name]) for r in reports.values()
                    if r.get(name) is not None]
            event[f"{name}_min"] = round(min(vals), 4) if vals else None
            event[f"{name}_median"] = (round(statistics.median(vals), 4)
                                       if vals else None)
            event[f"{name}_max"] = round(max(vals), 4) if vals else None
        return event

    # ---------------------------------------------------------------- flush
    def flush(self, timeout: float = None) -> None:
        """Bounded wait until this rank's handed-off reports are out (the
        KV write for ranks > 0; the fleet-event emit for rank 0).  Called
        from ``Telemetry.flush()`` — run end and preemption drain — so the
        final window's fleet event is in the record before exit."""
        timeout = self.wait_s + 5.0 if timeout is None else float(timeout)
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if self.rank == 0:
                if self._emitted >= self._published:
                    return
            elif self._queue.unfinished_tasks == 0:
                return
            time.sleep(_POLL_S)
        logger.warning(
            "fleet: flush timed out after %.1fs (rank %d, published %d, "
            "emitted %d)", timeout, self.rank, self._published,
            self._emitted if self.rank == 0 else -1)

    def close(self) -> None:
        self.flush()
        self._stop.set()


def make_report(event: dict, *, rank: int, counters: dict) -> dict:
    """The per-host window report shipped to rank 0: the window event's
    numeric core plus identity and the counter snapshot (a few hundred
    bytes of JSON — never arrays, never device data)."""
    return {
        "rank": int(rank),
        "host": socket.gethostname(),
        "ts": event.get("ts"),
        "step": event.get("step"),
        "window_steps": event.get("window_steps"),
        "step_ms": event.get("step_ms"),
        "samples_per_sec": event.get("samples_per_sec"),
        "host_ms": event.get("host_ms"),
        "data_wait_ms": event.get("data_wait_ms"),
        "loss_mean": event.get("loss_mean"),
        "loss": event.get("loss"),
        "grad_norm": event.get("grad_norm"),
        "skipped": event.get("skipped"),
        "anomalies": list(event.get("anomalies") or []),
        "counters": {k: v for k, v in (counters or {}).items()
                     if isinstance(v, (int, float))},
    }


def _sum_of(reports: dict, field: str):
    vals = [float(r[field]) for r in reports.values()
            if r.get(field) is not None]
    return round(sum(vals), 4) if vals else None


def _mean_of(reports: dict, field: str):
    vals = [float(r[field]) for r in reports.values()
            if r.get(field) is not None]
    return round(sum(vals) / len(vals), 6) if vals else None


def _spread_of(reports: dict, field: str):
    vals = [float(r[field]) for r in reports.values()
            if r.get(field) is not None]
    return round(max(vals) - min(vals), 6) if vals else None


def _rollup_counters(reports: dict) -> dict:
    """Sum numeric counters across hosts (the fleet total of nan_skips /
    io_retries / watchdog fires is the number a dashboard alarms on)."""
    out = {}
    for rep in reports.values():
        for k, v in (rep.get("counters") or {}).items():
            if isinstance(v, (int, float)):
                out[k] = out.get(k, 0) + v
    return {k: round(v, 6) if isinstance(v, float) else v
            for k, v in out.items()}
