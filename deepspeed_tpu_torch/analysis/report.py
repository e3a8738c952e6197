"""Findings, reports and the lint error types.

A copy of the JAX package's ``analysis/report.py``, for the port's graph
lint, planners and host-concurrency lint.  A :class:`Finding` is one defect: a stable dotted
``code`` (which rule fired), a ``severity``, a message, a ``path`` (for
the concurrency lint, the lock or locks involved) and the ``source``
location ``file:line (function)``.

Severity contract (mirrors the ``analysis.concurrency`` config key):

* ``error``   - certain to deadlock or stall (a lock-order cycle, a
  blocking call under a lock); ``mode: "error"`` raises on these.
* ``warning`` - probably unintended, never fatal (an annotation the pass
  cannot attach, a lock it cannot resolve).
* ``info``    - worth knowing (a blocking call annotated as deliberate).

Suppression is by code prefix: ``"concurrency"`` silences the whole pass,
``"concurrency.lock-order"`` one rule; the config key
``analysis.concurrency.suppress`` and the CLI ``--suppress`` take these.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

ERROR = "error"
WARNING = "warning"
INFO = "info"

_SEV_ORDER = {ERROR: 0, WARNING: 1, INFO: 2}


class GraphLintError(Exception):
    """Raised in ``error`` mode when error-severity findings survive
    suppression.  Carries the full :class:`Report` as ``.report``."""

    def __init__(self, report: "Report", where: str = ""):
        self.report = report
        head = (f"graph lint found {len(report.errors)} error-severity "
                f"finding(s)" + (f" in {where}" if where else ""))
        super().__init__(head + ":\n" + report.format(min_severity=ERROR))


class MemoryPlanError(GraphLintError):
    """Raised in ``analysis.mode == "error"`` when an error-severity
    finding of the planners survives suppression (``memory.budget-
    exceeded``: the predicted per-device peak exceeds the budget).
    Subclasses :class:`GraphLintError`, so ``except GraphLintError`` keeps
    working; the findings carry the contributor table."""


class ShardSpecError(ValueError):
    """A partition spec cannot apply to the value it is paired with
    (unknown axis, rank overflow, or a non-divisible dim): raised before
    anything runs, naming the offending leaf, spec and axis."""


@dataclasses.dataclass
class Finding:
    code: str                    # dotted rule id, e.g. "concurrency.lock-order"
    severity: str                # ERROR | WARNING | INFO
    message: str                 # one-paragraph human description
    path: str = ""               # the lock(s), e.g. "FleetRouter._lock"
    source: str = ""             # "file:line (function)"
    pass_name: str = ""          # which pass produced it

    def location(self) -> str:
        bits = [b for b in (self.path, self.source) if b]
        return " @ ".join(bits) if bits else "<unlocated>"

    def format(self) -> str:
        loc = self.location()
        return (f"[{self.severity:7s}] {self.code}\n"
                f"          {self.message}\n"
                f"          at {loc}")


class Report:
    """An ordered collection of findings from one analysis run."""

    def __init__(self, findings: Optional[Sequence[Finding]] = None,
                 subject: str = ""):
        self.subject = subject
        self.findings: List[Finding] = list(findings or [])
        self.suppressed_count = 0

    def add(self, code: str, severity: str, message: str, *, path: str = "",
            source: str = "", pass_name: str = "") -> Finding:
        f = Finding(code=code, severity=severity, message=message, path=path,
                    source=source, pass_name=pass_name)
        self.findings.append(f)
        return f

    def extend(self, other: "Report") -> None:
        self.findings.extend(other.findings)
        self.suppressed_count += other.suppressed_count

    # ------------------------------------------------------------- filtering

    def filtered(self, suppress: Sequence[str]) -> "Report":
        """New report without findings whose code matches a suppression
        prefix (exact code or a dotted prefix like ``"concurrency"``)."""
        pats = [p.strip() for p in (suppress or []) if p and p.strip()]

        def keep(f: Finding) -> bool:
            # exact code or dotted-hierarchy prefix ONLY: "concurrency"
            # silences the pass, "concurrency.lock" must NOT also
            # silence the distinct rule "concurrency.lock-order"
            return not any(f.code == p or f.code.startswith(p + ".")
                           for p in pats)

        out = Report([f for f in self.findings if keep(f)],
                     subject=self.subject)
        out.suppressed_count = (self.suppressed_count
                                + len(self.findings) - len(out.findings))
        return out

    @property
    def errors(self) -> List[Finding]:
        return [f for f in self.findings if f.severity == ERROR]

    @property
    def warnings(self) -> List[Finding]:
        return [f for f in self.findings if f.severity == WARNING]

    @property
    def infos(self) -> List[Finding]:
        return [f for f in self.findings if f.severity == INFO]

    def __len__(self) -> int:
        return len(self.findings)

    def __iter__(self):
        return iter(self.findings)

    # ------------------------------------------------------------ rendering

    def sorted(self) -> List[Finding]:
        return sorted(self.findings,
                      key=lambda f: (_SEV_ORDER.get(f.severity, 9), f.code))

    def format(self, min_severity: str = INFO, max_per_code: int = 5) -> str:
        """Pretty multi-line report.  Findings of one code beyond
        ``max_per_code`` collapse into a "+N more" line so a single noisy
        rule cannot drown the report."""
        cut = _SEV_ORDER[min_severity]
        lines = []
        shown: dict = {}
        hidden: dict = {}
        for f in self.sorted():
            if _SEV_ORDER.get(f.severity, 9) > cut:
                continue
            n = shown.get(f.code, 0)
            if n >= max_per_code:
                hidden[f.code] = hidden.get(f.code, 0) + 1
                continue
            shown[f.code] = n + 1
            lines.append(f.format())
        for code, n in sorted(hidden.items()):
            lines.append(f"[...    ] {code}: +{n} more finding(s) elided")
        if not lines:
            lines.append("no findings")
        return "\n".join(lines)

    def summary(self) -> str:
        bits = [f"{len(self.errors)} error(s)",
                f"{len(self.warnings)} warning(s)",
                f"{len(self.infos)} info"]
        if self.suppressed_count:
            bits.append(f"{self.suppressed_count} suppressed")
        head = f"{self.subject}: " if self.subject else ""
        return head + ", ".join(bits)

    def raise_on_error(self, where: str = "", error_cls=None) -> None:
        """``error_cls`` must be :class:`GraphLintError` or a subclass, so
        every gate raises through one renderer and one except clause."""
        if self.errors:
            raise (error_cls or GraphLintError)(self, where=where)
