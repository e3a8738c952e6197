"""Live health endpoints — one lightweight HTTP server per process.

The fleet view answers "who is slow?" in the event log; the health server
answers it LIVE, without ssh and without touching the training threads:

* ``GET /healthz``  — liveness: 200 + ``{"ok": true, ...}`` while the
  process trains, 503 once the watchdog has fired (a wedged run is alive
  but not healthy — exactly the case an orchestrator should replace).
* ``GET /status``   — JSON: rank/host/pid, engine step, the last drained
  window event, anomaly flags, the counter snapshot; rank 0 additionally
  carries the latest fleet event (the whole-fleet view from one curl).
* ``GET /metrics``  — Prometheus text format fed from the MetricRegistry
  snapshot + the last window/fleet events, so the standard scrape
  tooling works against a training job with zero adapters.

Served from a stdlib ``ThreadingHTTPServer`` on a daemon thread: requests
read host-side state under a lock — no fences, no device interaction, no
effect on the step path.  Opt-in: ``observability.health_port`` (or
``dst --health_port`` → :data:`ENV_HEALTH_PORT`); multi-process runs
offset the configured base port by the process rank so every
worker on a shared host gets a distinct endpoint.
"""

from __future__ import annotations

import json
import logging
import os
import re
import socket
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

logger = logging.getLogger(__name__)

#: env spelling of the BASE health port — how the launcher
#: (``dst --health_port``) hands it to every worker and relaunch
#: (config ``observability.health_port`` beats it)
ENV_HEALTH_PORT = "DSTPU_HEALTH_PORT"

#: env spelling of the replica generation: the launcher's restart loop
#: exports the attempt ordinal on every relaunch, so a restarted worker
#: is distinguishable from a live one by a MONOTONIC counter instead of
#: a guessed uptime comparison (the fleet router's restart detector —
#: of the serving stack)
ENV_REPLICA_GENERATION = "DSTPU_REPLICA_GENERATION"

#: interpreter start (module import is early enough for the uptime
#: gauge's purpose: a restarted replica's uptime visibly resets)
_PROCESS_START_TS = time.time()

_METRIC_NAME_RE = re.compile(r"[^a-zA-Z0-9_]")


def process_uptime_s() -> float:
    """Wall seconds this process has been alive — the ``/metrics``
    ``dstpu_process_uptime_s`` gauge.  A router comparing two scrapes of
    the same endpoint can tell "same replica, later" from "the replica
    restarted between scrapes" (uptime went DOWN)."""
    return time.time() - _PROCESS_START_TS


def replica_generation() -> int:
    """Monotonic restart ordinal for this worker: 0 on first launch,
    incremented by the launcher on every ``--max_restarts`` relaunch
    (:data:`ENV_REPLICA_GENERATION`).  The unambiguous restart signal —
    uptime alone cannot distinguish a fast restart from a scrape gap."""
    v = os.environ.get(ENV_REPLICA_GENERATION, "").strip()
    try:
        return int(v) if v else 0
    except ValueError:
        logger.warning("ignoring non-integer %s=%r",
                       ENV_REPLICA_GENERATION, v)
        return 0


def _process_rank() -> int:
    """This process's global rank: the started ``torch.distributed`` group's,
    else the launcher's ``DSTPU_PROCESS_ID``, else 0."""
    try:
        import torch.distributed as dist
        if dist.is_available() and dist.is_initialized():
            return dist.get_rank()
    except ImportError:  # pragma: no cover - torch is always there
        pass
    try:
        return int(os.environ.get("DSTPU_PROCESS_ID", "0") or 0)
    except ValueError:
        return 0


def resolve_health_port(cfg_port, rank: Optional[int] = None) -> Optional[int]:
    """Effective port for THIS process: config beats the env fallback;
    0/unset disables; a multi-process run offsets the base by the global
    rank (workers sharing a host must not fight over one port).  Returns
    None when disabled."""
    port = cfg_port
    if not port:
        env = os.environ.get(ENV_HEALTH_PORT, "").strip()
        if env:
            try:
                port = int(env)
            except ValueError:
                logger.warning("ignoring non-integer %s=%r",
                               ENV_HEALTH_PORT, env)
                return None
    if not port:
        return None
    return int(port) + (_process_rank() if rank is None else int(rank))


def sanitize_metric_name(name: str) -> str:
    return _METRIC_NAME_RE.sub("_", name)


def prometheus_text(metrics: dict, labels: dict = None) -> str:
    """Render ``{name: value}`` as Prometheus text exposition (gauges).
    Keys are sanitized and prefixed ``dstpu_``; ``labels`` ride every
    sample (``rank`` at minimum, so a fleet scrape stays per-host)."""
    label_str = ""
    if labels:
        inner = ",".join(f'{sanitize_metric_name(str(k))}="{v}"'
                         for k, v in sorted(labels.items()))
        label_str = "{" + inner + "}"
    lines = []
    for name in sorted(metrics):
        val = metrics[name]
        if val is None or isinstance(val, bool) \
                or not isinstance(val, (int, float)):
            continue
        metric = "dstpu_" + sanitize_metric_name(name)
        lines.append(f"# TYPE {metric} gauge")
        lines.append(f"{metric}{label_str} {float(val):g}")
    return "\n".join(lines) + "\n"


class HealthServer:
    """HTTP liveness/status/metrics endpoints over one telemetry object.

    ``telemetry`` duck-type contract (the Telemetry facade provides it):
    ``health_snapshot()`` → dict for /status, ``health_metrics()`` →
    flat ``{name: number}`` for /metrics, ``healthy()`` → bool.
    """

    def __init__(self, port: int, telemetry, rank: int = 0):
        self.rank = int(rank)
        self._telemetry = telemetry
        started = time.time()

        server = self

        class _Handler(BaseHTTPRequestHandler):
            # stdlib default logs every request to stderr — telemetry must
            # not spam the training console
            def log_message(self, fmt, *args):  # noqa: N802
                pass

            def _send(self, code: int, body: bytes, ctype: str):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):  # noqa: N802
                try:
                    path = self.path.split("?", 1)[0].rstrip("/") or "/"
                    if path in ("/", "/healthz"):
                        ok = server._healthy()
                        body = json.dumps({
                            "ok": ok,
                            "rank": server.rank,
                            "uptime_s": round(time.time() - started, 3),
                        }).encode()
                        self._send(200 if ok else 503, body,
                                   "application/json")
                    elif path == "/status":
                        body = json.dumps(server._status()).encode()
                        self._send(200, body, "application/json")
                    elif path == "/metrics":
                        body = prometheus_text(
                            server._metrics(),
                            labels={"rank": server.rank}).encode()
                        self._send(200, body,
                                   "text/plain; version=0.0.4")
                    else:
                        self._send(404, b"not found\n", "text/plain")
                except Exception as e:  # pragma: no cover - defensive
                    # an exploded handler must not kill the server thread
                    try:
                        self._send(500, f"error: {e}\n".encode(),
                                   "text/plain")
                    except OSError:
                        pass

        # port may be 0 (tests): the OS picks one; self.port is the truth
        self._httpd = ThreadingHTTPServer(("0.0.0.0", int(port)), _Handler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name=f"dstpu-health-r{self.rank}")
        self._thread.start()
        logger.info("telemetry: health endpoints on :%d "
                    "(/healthz /status /metrics)", self.port)

    # ----------------------------------------------------- telemetry bridge
    def _healthy(self) -> bool:
        try:
            return bool(self._telemetry.healthy())
        except Exception:  # pragma: no cover - defensive
            return False

    def _status(self) -> dict:
        base = {"rank": self.rank, "host": socket.gethostname(),
                "pid": os.getpid(), "ts": time.time()}
        try:
            base.update(self._telemetry.health_snapshot())
        except Exception as e:  # pragma: no cover - defensive
            base["error"] = str(e)
        return base

    def _metrics(self) -> dict:
        try:
            return dict(self._telemetry.health_metrics())
        except Exception:  # pragma: no cover - defensive
            return {}

    def close(self) -> None:
        try:
            self._httpd.shutdown()
            self._httpd.server_close()
        except Exception:  # pragma: no cover - defensive
            pass


def parse_prometheus_text(text: str) -> dict:
    """Minimal exposition-format parser: ``{metric_name: value}`` for the
    LAST sample of each name.  Raises ValueError on a malformed line —
    the CI smoke job parse-checks the /metrics payload with this, so a
    format regression fails loudly.  The value token is validated by
    ``float()`` itself (a hand-rolled char class rejected legitimate
    renderings like ``1e-05`` or ``inf``)."""
    out = {}
    for i, line in enumerate(text.splitlines(), 1):
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        m = re.match(r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{[^}]*\})?\s+(\S+)$",
                     line)
        if not m:
            raise ValueError(f"malformed metrics line {i}: {line!r}")
        try:
            out[m.group(1)] = float(m.group(3))
        except ValueError:
            raise ValueError(f"malformed metrics line {i}: {line!r}")
    return out
