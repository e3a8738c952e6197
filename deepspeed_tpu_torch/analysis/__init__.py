"""deepspeed_tpu_torch.analysis: the host-concurrency analysis.

The port of the pure-Python part of ``deepspeed_tpu/analysis/``:

* ``report``      - findings, reports, suppression, the lint error type;
* ``concurrency`` - the AST lint of the serving control plane's locks
  (lock order, blocking under a lock, thread-role contracts, guarded
  writes), run at ``FleetRouter`` build under config
  ``analysis.concurrency`` and from ``python -m
  deepspeed_tpu_torch.analysis --concurrency``;
* ``lockwatch``   - the runtime lock sanitizer behind ``named_lock``.

The JAX package's graph passes and planners (graph lint, the capacity,
dispatch and stability plans) are ROADMAP.md Queue 1 item 14; the engines
refuse ``graph_lint`` and ``analysis.mode`` until then.
"""

from __future__ import annotations

import logging
from typing import Optional

from deepspeed_tpu_torch.analysis import concurrency  # noqa: F401
from deepspeed_tpu_torch.analysis import lockwatch  # noqa: F401
from deepspeed_tpu_torch.analysis import report  # noqa: F401
from deepspeed_tpu_torch.analysis.concurrency import ConcurrencyLintError
from deepspeed_tpu_torch.analysis.report import (ERROR, INFO, WARNING,
                                                 Finding, GraphLintError,
                                                 Report)

logger = logging.getLogger(__name__)

MODES = ("off", "warn", "error")

__all__ = [
    "ERROR", "WARNING", "INFO", "Finding", "Report", "GraphLintError",
    "ConcurrencyLintError", "MODES", "dispatch_report", "concurrency",
    "lockwatch", "report",
]


def dispatch_report(rep: Report, mode: str, where: str = "",
                    log: Optional[logging.Logger] = None,
                    label: str = "concurrency lint",
                    info_hint: Optional[str] = None,
                    error_cls=None) -> Report:
    """Apply a ``warn``/``error`` gate: log warnings and errors in
    ``warn`` mode, raise ``error_cls`` (default :class:`GraphLintError`)
    on error findings in ``error`` mode."""
    log = log or logger
    if mode == "off" or not len(rep):
        return rep
    worst = rep.errors or rep.warnings
    if worst or rep.infos:
        hint = info_hint or "the report's format() shows them"
        body = (rep.format(min_severity=WARNING) if worst else
                f"{len(rep.infos)} info-severity finding(s); {hint}")
        log.log(logging.WARNING if worst else logging.INFO,
                "%s%s: %s\n%s", label,
                f" [{where}]" if where else "", rep.summary(), body)
    if mode == "error":
        rep.raise_on_error(where=where, error_cls=error_cls)
    return rep
