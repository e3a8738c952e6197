"""Straggler & anomaly detection over telemetry windows.

Two altitudes, both host-side and fence-free (they consume numbers the
window drain already put on the host):

* **per-host detectors** (every rank, ``WindowAnomalyDetector``): rolling
  robust baselines over the rank's own window metrics flag loss spikes,
  grad-norm spikes and data starvation.  Anomalies ride the window event
  (``anomalies`` field), the per-host fleet report, registry counters
  (``Train/Observability/*``) and a one-shot warning naming the rank.
* **fleet straggler detection** (rank 0, ``StragglerDetector``): at each
  aggregated window, a host whose *host-side* time deviates beyond
  ``straggler_factor`` × the median of the other hosts is flagged.  The
  signal is deliberately the host-side pre-dispatch time (plus data wait),
  not wall step time: under lockstep SPMD one slow rank makes EVERY
  rank's wall time slow (the healthy ranks just wait inside the
  collective), so wall time cannot name the culprit — host-side time can,
  because only the straggler spends it outside the device queue.
* **serving detectors** (``ServeAnomalyDetector``, one per replica): over
  each serve telemetry window — admission starvation (requests queued,
  none admitted, pool refusals growing), speculative accept-rate collapse
  (enough proposals, acceptance under the floor: the draft has drifted
  from the target), and page-pool thrash (the prefix-cache LRU reclaiming
  pages faster than it serves hits — cached prefixes churning before
  reuse).  Same contract as the training detectors: one-shot warning,
  counter, ``anomalies`` list on the window event.

Everything is deterministic (median comparisons, explicit factors) so the
chaos legs pin exact flaggings.
"""

from __future__ import annotations

import logging
import statistics
import threading
from collections import deque
from dataclasses import dataclass, fields

logger = logging.getLogger(__name__)

#: windows of history a rolling baseline keeps
BASELINE_WINDOWS = 16
#: windows of history required before a spike can be flagged (a 2-window
#: baseline would flag normal early-training loss movement)
MIN_HISTORY = 3
#: absolute floor (ms) under which host-time deviations are noise, not
#: stragglers — sub-floor jitter on a fast fleet must not page anyone
STRAGGLER_FLOOR_MS = 50.0


@dataclass
class DetectorCounters:
    """Process-wide detection counters, exported through the telemetry
    registry (``Train/Observability/*`` scalars + the ``counters`` dict of
    every window/fleet event)."""
    #: hosts flagged as stragglers across all aggregated windows (rank 0)
    stragglers_flagged: int = 0
    #: per-host window loss spikes
    loss_spikes: int = 0
    #: per-host window grad-norm spikes
    grad_norm_spikes: int = 0
    #: windows whose data wait dominated step time
    data_starvation_windows: int = 0
    #: fleet windows aggregated (rank 0)
    fleet_windows: int = 0
    #: per-host reports missing at the aggregation deadline (rank 0) —
    #: a missing report is itself a hang precursor
    fleet_reports_missing: int = 0
    #: reports that arrived AFTER their window's deadline (rank 0):
    #: discarded by the stale-key GC, but the lateness itself is a
    #: straggler signal worth a counter
    fleet_reports_late: int = 0

    def as_dict(self) -> dict:
        return {f.name: getattr(self, f.name) for f in fields(self)}

    def reset(self) -> None:
        for f in fields(self):
            setattr(self, f.name, f.default)


COUNTERS = DetectorCounters()


@dataclass
class ServeDetectorCounters:
    """Per-process serving-anomaly counters (exported through the serve
    ``/metrics`` endpoint and every serve window event's ``counters``)."""
    #: windows where queued requests starved (no admission, refusals grew)
    serve_admission_starvation: int = 0
    #: windows whose speculative accept rate collapsed under the floor
    serve_accept_collapse: int = 0
    #: windows where the prefix-cache LRU thrashed (reclaims > hits)
    serve_pool_thrash: int = 0

    def as_dict(self) -> dict:
        return {f.name: getattr(self, f.name) for f in fields(self)}

    def reset(self) -> None:
        for f in fields(self):
            setattr(self, f.name, f.default)


SERVE_COUNTERS = ServeDetectorCounters()


class ServeAnomalyDetector:
    """Per-replica anomaly detection over serve telemetry windows.

    Deterministic window-delta checks (no baselines to poison): each
    ``check_window`` call receives the window's ITERATION stats plus the
    pool-gauge DELTAS since the previous window, and returns the anomaly
    kinds — one-shot warning + counter per kind, exactly the training
    detectors' contract."""

    def __init__(self, starvation_windows: int = 1,
                 accept_floor: float = 0.25, thrash_reclaims: int = 8,
                 min_spec_proposals: int = 16):
        self.starvation_windows = int(starvation_windows)
        self.accept_floor = float(accept_floor)
        self.thrash_reclaims = int(thrash_reclaims)
        self.min_spec_proposals = int(min_spec_proposals)
        self._starved_streak = 0
        self._warned = set()

    def _warn_once(self, kind: str, detail: str) -> None:
        if kind in self._warned:
            return
        self._warned.add(kind)
        logger.warning("serve telemetry: %s detected (%s) — further "
                       "occurrences ride counters/events only",
                       kind, detail)

    def check_window(self, *, queue_depth: int, admitted: int,
                     refusals_delta: int, spec_proposed_delta: int,
                     spec_accepted_delta: int, lru_reclaims_delta: int,
                     prefix_hits_delta: int) -> list:
        """Anomaly kinds for one serve window (all inputs are this
        window's deltas except ``queue_depth``, the live value at the
        window edge)."""
        anomalies = []
        # admission starvation: requests are waiting, none got in, and
        # the pool refused — ``starvation_windows`` consecutive windows
        # of it is the flag (1 = flag immediately)
        if (self.starvation_windows > 0 and queue_depth > 0
                and admitted == 0 and refusals_delta > 0):
            self._starved_streak += 1
            if self._starved_streak >= self.starvation_windows:
                anomalies.append("admission_starvation")
                SERVE_COUNTERS.serve_admission_starvation += 1
                self._warn_once(
                    "admission_starvation",
                    f"{queue_depth} queued, 0 admitted, "
                    f"{refusals_delta} refusal(s) this window — raise "
                    f"inference.pool_pages or add replicas")
        else:
            self._starved_streak = 0
        # speculative accept-rate collapse: the draft stopped predicting
        # the target (stale draft weights after a hot-swap, domain
        # shift) — serving still EXACT but the speedup silently died
        if (self.accept_floor > 0
                and spec_proposed_delta >= self.min_spec_proposals):
            rate = spec_accepted_delta / spec_proposed_delta
            if rate < self.accept_floor:
                anomalies.append("spec_accept_collapse")
                SERVE_COUNTERS.serve_accept_collapse += 1
                self._warn_once(
                    "spec_accept_collapse",
                    f"accept rate {rate:.3f} < floor "
                    f"{self.accept_floor} over {spec_proposed_delta} "
                    f"proposals — the draft model has drifted from the "
                    f"target")
        # page-pool thrash: the LRU reclaimed more published prefixes
        # than it served hits — the cache churns before anything reuses
        # it (pool too small for the working set of shared prefixes)
        if (self.thrash_reclaims > 0
                and lru_reclaims_delta >= self.thrash_reclaims
                and lru_reclaims_delta > prefix_hits_delta):
            anomalies.append("pool_thrash")
            SERVE_COUNTERS.serve_pool_thrash += 1
            self._warn_once(
                "pool_thrash",
                f"{lru_reclaims_delta} LRU reclaims vs "
                f"{prefix_hits_delta} prefix hits this window — raise "
                f"inference.pool_pages")
        return anomalies


def _median(values):
    return statistics.median(values) if values else None


class SpikeDetector:
    """Rolling robust spike check: ``value > factor * median(history)``
    with at least :data:`MIN_HISTORY` prior windows.  Non-finite values
    are always spikes (a NaN loss is never baseline)."""

    def __init__(self, factor: float, history: int = BASELINE_WINDOWS,
                 min_history: int = MIN_HISTORY):
        self.factor = float(factor)
        self.min_history = int(min_history)
        self._hist = deque(maxlen=int(history))

    def check(self, value) -> bool:
        """True when ``value`` spikes vs the rolling baseline; the value
        joins the baseline afterwards UNLESS it spiked (a divergence must
        not teach the baseline that divergence is normal)."""
        if value is None:
            return False
        value = float(value)
        if value != value or value in (float("inf"), float("-inf")):
            return True
        spiked = (len(self._hist) >= self.min_history
                  and abs(value) > self.factor * max(
                      1e-12, abs(_median(self._hist))))
        if not spiked:
            self._hist.append(value)
        return spiked


class WindowAnomalyDetector:
    """Per-host anomaly detection over one rank's window events."""

    def __init__(self, rank: int, spike_factor: float,
                 starvation_frac: float):
        self.rank = int(rank)
        self._loss = SpikeDetector(spike_factor)
        self._grad = SpikeDetector(spike_factor)
        self.starvation_frac = float(starvation_frac)
        self._warned = set()

    def _warn_once(self, kind: str, detail: str) -> None:
        if kind in self._warned:
            return
        self._warned.add(kind)
        logger.warning("telemetry: %s detected on rank %d (%s) — further "
                       "occurrences ride counters/events only",
                       kind, self.rank, detail)

    def check_window(self, event: dict) -> list:
        """Anomaly kinds for one window event (fields may be None on the
        unmeasured first window — every check is null-tolerant)."""
        anomalies = []
        if self._loss.check(event.get("loss_mean")):
            anomalies.append("loss_spike")
            COUNTERS.loss_spikes += 1
            self._warn_once("loss_spike",
                            f"loss_mean={event.get('loss_mean')} at step "
                            f"{event.get('step')}")
        if self._grad.check(event.get("grad_norm")):
            anomalies.append("grad_norm_spike")
            COUNTERS.grad_norm_spikes += 1
            self._warn_once("grad_norm_spike",
                            f"grad_norm={event.get('grad_norm')} at step "
                            f"{event.get('step')}")
        step_ms, wait_ms = event.get("step_ms"), event.get("data_wait_ms")
        if (step_ms and wait_ms
                and wait_ms > self.starvation_frac * step_ms
                and wait_ms > STRAGGLER_FLOOR_MS):
            anomalies.append("data_starvation")
            COUNTERS.data_starvation_windows += 1
            self._warn_once("data_starvation",
                            f"data_wait_ms={wait_ms:.1f} vs "
                            f"step_ms={step_ms:.1f}")
        return anomalies


class StragglerDetector:
    """Fleet-level straggler flagging (rank 0's aggregator owns one).

    Leave-one-out comparison: host *r* is a straggler when its host-side
    signal exceeds ``factor`` × the median of the OTHER hosts' signals by
    at least :data:`STRAGGLER_FLOOR_MS` — median-of-others, because with
    few hosts a single straggler drags the whole-fleet median toward itself
    (at n=2 the plain median is the midpoint and the factor test goes
    degenerate).  A rolling per-host baseline rides along so the fleet
    event can report each host's deviation from its own history too."""

    def __init__(self, factor: float, floor_ms: float = STRAGGLER_FLOOR_MS):
        self.factor = float(factor)
        self.floor_ms = float(floor_ms)
        self._baseline = {}     # rank -> deque of host signals
        self._lock = threading.Lock()
        self._warned = set()

    @staticmethod
    def signal(report: dict):
        """The per-host straggler signal: host-side pre-dispatch time plus
        data wait (ms per boundary) — the components only the slow host
        pays.  None when the window was unmeasured."""
        host_ms = report.get("host_ms")
        if host_ms is None:
            return None
        return float(host_ms) + float(report.get("data_wait_ms") or 0.0)

    def check_fleet(self, reports: dict) -> dict:
        """``reports``: rank -> per-host report dict.  Returns
        ``{"stragglers": [ranks], "straggler_index": float|None,
        "baseline_ratio": {rank: ratio}}``."""
        signals = {r: self.signal(rep) for r, rep in reports.items()}
        known = {r: s for r, s in signals.items() if s is not None}
        stragglers = []
        index = None
        if len(known) >= 2:
            med_all = _median(list(known.values()))
            if med_all and med_all > 0:
                index = round(max(known.values()) / med_all, 4)
            for rank, sig in sorted(known.items()):
                others = [s for r, s in known.items() if r != rank]
                med = max(_median(others), 0.0)
                if (sig > self.factor * max(med, self.floor_ms)
                        and sig - med > self.floor_ms):
                    stragglers.append(rank)
                    COUNTERS.stragglers_flagged += 1
                    if rank not in self._warned:
                        self._warned.add(rank)
                        logger.warning(
                            "telemetry: rank %d is a STRAGGLER — host-side "
                            "time %.1f ms/boundary vs fleet median %.1f ms "
                            "(factor %.1f) at step %s", rank, sig, med,
                            self.factor, reports[rank].get("step"))
        ratios = {}
        with self._lock:
            for rank, sig in known.items():
                hist = self._baseline.setdefault(
                    rank, deque(maxlen=BASELINE_WINDOWS))
                base = _median(hist)
                if base and base > 0:
                    ratios[rank] = round(sig / base, 4)
                hist.append(sig)
        return {"stragglers": stragglers, "straggler_index": index,
                "baseline_ratio": ratios}
