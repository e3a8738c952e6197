"""Flight recorder — a bounded host-side ring of recent engine events.

When a fleet diverges — one rank wedged in a collective, the rest blocked
behind it — the question a post-mortem must answer is *who was at which
step when*.  Stack dumps (resilience/watchdog.py) answer "where is this
thread NOW"; the flight recorder answers "what was this process doing for
the last N events": optimizer boundaries, program dispatches (the host-side
collective-sequence order), window drains, checkpoint IO, preemption
agreement, chaos injections.

Recording is deliberately cheap — a dict build and a deque append under a
lock, no device interaction, no fences — so it is always on.  The ring is
dumped to a named JSON file on:

* watchdog fire (``resilience/watchdog.py`` enriches its stack dump with
  the recorder tail AND writes a dump file),
* preemption drain and crash exit (``resilience/driver.py``),
* process exit when :data:`ENV_DUMP_AT_EXIT` is set (CI uses this so a
  healthy run still uploads artifacts).

One recorder per process (:data:`RECORDER`): the ring is a process-level
post-mortem artifact, not an engine-level one — the watchdog monitor
thread and the resilience driver reach it without an engine reference.
Importable without torch (the watchdog imports it; the launcher parent
imports the watchdog).
"""

from __future__ import annotations

import json
import logging
import os
import socket
import threading
import time
from collections import deque
from typing import Optional

logger = logging.getLogger(__name__)

#: dump-file schema stamp (the dump is itself a machine-readable artifact)
DUMP_SCHEMA_ID = "dstpu.flightrec"
DUMP_SCHEMA_VERSION = 1

#: set to "1" to dump the ring at interpreter exit (reason ``exit``) —
#: the CI observability job sets it so flight-recorder artifacts exist
#: even on green runs
ENV_DUMP_AT_EXIT = "DSTPU_FLIGHTREC_DUMP_AT_EXIT"

#: env fallback for the dump directory (config
#: ``observability.flight_recorder_dir`` beats it)
ENV_DUMP_DIR = "DSTPU_FLIGHTREC_DIR"

DEFAULT_CAPACITY = 256

_UNSET = object()


class FlightRecorder:
    """Thread-safe bounded event ring with named dump files."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY, rank: int = 0):
        self._lock = threading.Lock()
        self._ring = deque(maxlen=int(capacity) or 1)
        self.capacity = int(capacity)
        self.rank = int(rank)
        self.enabled = capacity > 0
        self.dump_dir: Optional[str] = None
        self._seq = 0
        self._dumped = {}       # reason -> path (idempotence per reason)

    def configure(self, capacity: int = None, rank: int = None,
                  dump_dir=_UNSET) -> None:
        """Re-point the process recorder (engine build: capacity/dir from
        config, rank from the initialized distributed runtime).  Existing
        entries are kept up to the new capacity; the per-reason dump
        idempotence resets — a fresh engine is a fresh post-mortem epoch.
        ``dump_dir`` is SET whenever passed, ``None`` included (falling
        back to :data:`ENV_DUMP_DIR`/cwd): a fresh engine must not keep
        dumping into the previous engine's directory."""
        with self._lock:
            self._dumped = {}
            if capacity is not None:
                self.capacity = int(capacity)
                self.enabled = capacity > 0
                self._ring = deque(self._ring if self.enabled else (),
                                   maxlen=int(capacity) or 1)
            if rank is not None:
                self.rank = int(rank)
            if dump_dir is not _UNSET:
                self.dump_dir = dump_dir

    # ------------------------------------------------------------ recording
    def record(self, kind: str, **fields) -> None:
        """Append one event (ts/seq stamped); drops silently when disabled.
        Called from the training thread (boundaries, dispatches), the
        runtime callback thread (window drains) and the watchdog monitor
        thread — hence the lock."""
        if not self.enabled:
            return
        entry = {"seq": None, "ts": time.time(), "kind": str(kind)}
        entry.update(fields)
        with self._lock:
            self._seq += 1
            entry["seq"] = self._seq
            self._ring.append(entry)

    def tail(self, n: int = None) -> list:
        with self._lock:
            entries = list(self._ring)
        return entries if n is None else entries[-int(n):]

    def format_tail(self, n: int = 16) -> str:
        """The last ``n`` entries as indented text — what the watchdog
        splices into its stack dump so the post-mortem names the stalled
        step/window without opening the dump file."""
        entries = self.tail(n)
        if not entries:
            return "  (empty)"
        now = time.time()
        lines = []
        for e in entries:
            extra = " ".join(f"{k}={e[k]}" for k in e
                             if k not in ("seq", "ts", "kind"))
            lines.append(f"  [-{now - e['ts']:8.3f}s] #{e['seq']} "
                         f"{e['kind']}" + (f" {extra}" if extra else ""))
        return "\n".join(lines)

    # --------------------------------------------------------------- dumping
    def resolve_dump_dir(self) -> str:
        return (self.dump_dir or os.environ.get(ENV_DUMP_DIR) or ".")

    def dump(self, reason: str, path: str = None) -> Optional[str]:
        """Write the ring to ``flightrec_rank<r>_<reason>.json`` (or an
        explicit ``path``) and return the path.  Idempotent per reason
        (a watchdog that fires twice must not truncate the first dump's
        evidence mid-read); best-effort — a dump failure must never mask
        the failure being dumped."""
        if not self.enabled:
            return None
        with self._lock:
            done = self._dumped.get(reason)
        if done is not None:
            return done
        if path is None:
            d = self.resolve_dump_dir()
            path = os.path.join(
                d, f"flightrec_rank{self.rank}_{reason}.json")
        try:
            os.makedirs(os.path.dirname(os.path.abspath(path)),
                        exist_ok=True)
            payload = {
                "schema": DUMP_SCHEMA_ID,
                "version": DUMP_SCHEMA_VERSION,
                "reason": reason,
                "rank": self.rank,
                "host": socket.gethostname(),
                "pid": os.getpid(),
                "ts": time.time(),
                "entries": self.tail(),
            }
            tmp = f"{path}.tmp.{os.getpid()}"
            with open(tmp, "w") as f:
                json.dump(payload, f)
            os.replace(tmp, path)       # atomic: never a half-written dump
        except OSError as e:  # pragma: no cover - defensive
            logger.warning("flight recorder dump (%s) failed: %s",
                           reason, e)
            return None
        with self._lock:
            self._dumped[reason] = path
        logger.warning("flight recorder: dumped %d entries -> %s "
                       "(reason: %s)", len(self.tail()), path, reason)
        return path


#: the process flight recorder (engine build re-configures capacity/rank/
#: dump dir; tests re-configure freely)
RECORDER = FlightRecorder()


def load_dump(path: str) -> dict:
    """Load + sanity-check a dump file (the post-mortem/test entry point);
    raises ValueError naming the problem on a foreign or damaged file."""
    with open(path) as f:
        payload = json.load(f)
    if payload.get("schema") != DUMP_SCHEMA_ID:
        raise ValueError(
            f"{path!r} is not a flight-recorder dump "
            f"(schema {payload.get('schema')!r})")
    if not isinstance(payload.get("entries"), list):
        raise ValueError(f"{path!r}: entries is not a list")
    return payload


_atexit_registered = False


def maybe_register_exit_dump() -> None:
    """Arm the at-exit dump when :data:`ENV_DUMP_AT_EXIT` is set (called
    at telemetry build; idempotent)."""
    global _atexit_registered
    if _atexit_registered or os.environ.get(ENV_DUMP_AT_EXIT) != "1":
        return
    _atexit_registered = True
    import atexit
    atexit.register(lambda: RECORDER.dump("exit"))
