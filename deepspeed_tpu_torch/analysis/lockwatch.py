"""Runtime lock sanitizer for the host-side serving control plane.

The static pass (``analysis/concurrency.py``) proves properties of the
lock-acquisition ORDER it can see in the source; this module watches the
orders that actually happen.  Control-plane classes create their locks
through :func:`named_lock` — a plain ``threading.Lock``/``RLock`` when
the watcher is disarmed (the default: zero overhead, zero behavior
change), an :class:`InstrumentedLock` when armed.  Armed locks record,
per acquisition:

* the **order edge** from every lock the acquiring thread already holds
  to the new lock — the observed lock-order graph, merged into the
  static graph by ``concurrency.merge_observed`` so a runtime-only
  inversion (an order the AST pass could not resolve) still fails the
  cycle check;
* **wait and held durations** — exported as ``lockwatch/…`` counters
  through :class:`~deepspeed_tpu_torch.observability.registry.
  MetricRegistry` (``register_metrics``) so ``/metrics`` answers "which
  lock is hot";
* **flight-recorder breadcrumbs** on long waits and long holds
  (``lock_wait`` / ``lock_held`` rows naming the lock, the waiter and
  the holder thread) — a watchdog hang dump names the contended lock,
  not just the stuck frame.

Arming: call :func:`instrument` before the locks are CREATED, or set
``DSTPU_LOCKWATCH=1`` in the environment.  Arming is a creation-time decision — locks built while disarmed
stay plain.

Everything here is stdlib-only and import-cycle-free: the flight
recorder is imported lazily on the first over-threshold event, and the
module imports no torch: it is safe from any module in the tree.

A copy of the JAX package's ``analysis/lockwatch.py``.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Dict, Optional, Set, Tuple

ENV_ARMED = "DSTPU_LOCKWATCH"

#: breadcrumb thresholds (ms): a wait/hold longer than this leaves a
#: flight-recorder row.  Deliberately above anything a healthy control
#: plane does (its critical sections are bookkeeping-only — the
#: blocking-under-lock lint is what keeps them that way).
DEFAULT_WAIT_WARN_MS = 50.0
DEFAULT_HOLD_WARN_MS = 100.0

_armed = False
_wait_warn_ms = DEFAULT_WAIT_WARN_MS
_hold_warn_ms = DEFAULT_HOLD_WARN_MS

#: module-global observation state, guarded by a PLAIN lock (the watcher
#: cannot watch itself)
_state_lock = threading.Lock()
_stats: Dict[str, "_LockStats"] = {}
_edges: Dict[Tuple[str, str], int] = {}
_tls = threading.local()


class _LockStats:
    __slots__ = ("acquisitions", "contentions", "wait_ms", "held_ms",
                 "max_wait_ms", "max_held_ms")

    def __init__(self):
        self.acquisitions = 0
        self.contentions = 0
        self.wait_ms = 0.0
        self.held_ms = 0.0
        self.max_wait_ms = 0.0
        self.max_held_ms = 0.0


def instrument(enable: bool = True) -> None:
    """Arm (or disarm) the watcher for locks created FROM NOW ON."""
    global _armed
    _armed = bool(enable)


def armed() -> bool:
    return _armed or os.environ.get(ENV_ARMED, "") not in ("", "0")


def configure(wait_warn_ms: Optional[float] = None,
              hold_warn_ms: Optional[float] = None) -> None:
    """Adjust the breadcrumb thresholds (tests lower them to force
    rows without real contention)."""
    global _wait_warn_ms, _hold_warn_ms
    if wait_warn_ms is not None:
        _wait_warn_ms = float(wait_warn_ms)
    if hold_warn_ms is not None:
        _hold_warn_ms = float(hold_warn_ms)


def reset() -> None:
    """Drop every recorded edge and counter (test isolation).  Locks
    already created stay instrumented and keep recording."""
    with _state_lock:
        _stats.clear()
        _edges.clear()


def named_lock(name: str, rlock: bool = False):
    """The control-plane lock factory: a plain ``threading.Lock`` /
    ``RLock`` when disarmed, an :class:`InstrumentedLock` when armed.
    ``name`` is the lock's identity in the order graph and the counters
    — by convention ``ClassName._attr``, matching the name the static
    pass derives, so observed and static edges merge by equality."""
    if not armed():
        return threading.RLock() if rlock else threading.Lock()
    return InstrumentedLock(name, rlock=rlock)


def _held_stack():
    st = getattr(_tls, "stack", None)
    if st is None:
        st = _tls.stack = []
    return st


def _breadcrumb(kind: str, **fields) -> None:
    try:
        from deepspeed_tpu_torch.observability.flightrec import RECORDER
        RECORDER.record(kind, **fields)
    except Exception:  # pragma: no cover - diagnostics must not throw
        pass


class InstrumentedLock:
    """A wrapped ``threading.Lock``/``RLock`` recording acquisition
    order, wait time and held duration.  Context-manager and
    ``acquire``/``release`` compatible; reentrant acquisitions of an
    RLock count once (no self-edges, no double timing)."""

    __slots__ = ("name", "_inner", "_rlock", "_holder", "_owner_ident",
                 "_depth", "_t_acquired")

    def __init__(self, name: str, rlock: bool = False):
        self.name = str(name)
        self._rlock = bool(rlock)
        self._inner = threading.RLock() if rlock else threading.Lock()
        self._holder = None          # holder thread NAME (diagnostics)
        self._owner_ident = None     # holder thread ident (reentrancy)
        self._depth = 0
        self._t_acquired = 0.0
        with _state_lock:
            _stats.setdefault(self.name, _LockStats())

    # ------------------------------------------------------------ acquire
    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        me = threading.current_thread()
        if self._rlock and self._owner_ident == me.ident:
            got = self._inner.acquire(blocking, timeout)
            if got:
                self._depth += 1
            return got
        holder_before = self._holder    # best-effort: who we waited on
        contended = self._owner_ident is not None
        t0 = time.monotonic()
        got = (self._inner.acquire(blocking, timeout) if timeout != -1
               or not blocking else self._inner.acquire())
        wait_ms = (time.monotonic() - t0) * 1e3
        if not got:
            return False
        self._holder = me.name
        self._owner_ident = me.ident
        self._depth = 1
        self._t_acquired = time.monotonic()
        stack = _held_stack()
        with _state_lock:
            st = _stats.setdefault(self.name, _LockStats())
            st.acquisitions += 1
            st.wait_ms += wait_ms
            st.max_wait_ms = max(st.max_wait_ms, wait_ms)
            if contended:
                st.contentions += 1
            for held in stack:
                edge = (held.name, self.name)
                _edges[edge] = _edges.get(edge, 0) + 1
        stack.append(self)
        if wait_ms >= _wait_warn_ms:
            _breadcrumb("lock_wait", lock=self.name, waiter=me.name,
                        holder=holder_before, wait_ms=round(wait_ms, 3))
        return True

    def release(self) -> None:
        me = threading.current_thread()
        if self._rlock and self._owner_ident == me.ident \
                and self._depth > 1:
            self._depth -= 1
            self._inner.release()
            return
        held_ms = (time.monotonic() - self._t_acquired) * 1e3
        holder = self._holder
        self._holder = None
        self._owner_ident = None
        self._depth = 0
        stack = getattr(_tls, "stack", None)
        if stack and self in stack:
            stack.remove(self)
        with _state_lock:
            st = _stats.setdefault(self.name, _LockStats())
            st.held_ms += held_ms
            st.max_held_ms = max(st.max_held_ms, held_ms)
        self._inner.release()
        if held_ms >= _hold_warn_ms:
            _breadcrumb("lock_held", lock=self.name, holder=holder,
                        held_ms=round(held_ms, 3))

    def locked(self) -> bool:
        return self._owner_ident is not None

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def __repr__(self):  # pragma: no cover - debugging nicety
        return (f"<InstrumentedLock {self.name!r} "
                f"holder={self._holder!r}>")


# ------------------------------------------------------------- exports

def observed_edges() -> Set[Tuple[str, str]]:
    """Distinct (held → acquired) lock-name pairs observed so far."""
    with _state_lock:
        return set(_edges)


def snapshot() -> Dict[str, dict]:
    """Per-lock stats: ``{name: {acquisitions, contentions, wait_ms,
    held_ms, max_wait_ms, max_held_ms}}``."""
    with _state_lock:
        return {name: {
            "acquisitions": st.acquisitions,
            "contentions": st.contentions,
            "wait_ms": round(st.wait_ms, 3),
            "held_ms": round(st.held_ms, 3),
            "max_wait_ms": round(st.max_wait_ms, 3),
            "max_held_ms": round(st.max_held_ms, 3),
        } for name, st in _stats.items()}


def counters() -> Dict[str, float]:
    """Flat ``{metric: number}`` dict — the MetricRegistry source shape.
    Lock names keep their dots (``lock_wait_ms.FleetRouter._lock``); the
    registry namespaces the group."""
    out: Dict[str, float] = {}
    for name, st in snapshot().items():
        out[f"lock_wait_ms.{name}"] = st["wait_ms"]
        out[f"lock_held_ms.{name}"] = st["held_ms"]
        out[f"lock_acquisitions.{name}"] = st["acquisitions"]
        out[f"lock_contentions.{name}"] = st["contentions"]
    return out


def register_metrics(registry) -> None:
    """Export the counters through a MetricRegistry: they appear as
    ``lockwatch/lock_wait_ms.<name>`` in every snapshot."""
    registry.register("lockwatch", counters)
