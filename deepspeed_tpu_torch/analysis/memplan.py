"""Capacity planner, memory half: the predicted per-device peak.

The port of ``deepspeed_tpu/analysis/memplan.py``.  The JAX planner
simulates XLA's buffer assignment over a jaxpr; eager PyTorch frees by
refcount, so the port simulates live bytes over a fake-mode trace of the
program (``graph.Recorder``): a storage allocates when an op first
returns it and frees when its last tensor dies, rounded to the caching
allocator's 512-byte blocks.  The program's state (parameters, masters,
moments, the KV pools) is alive throughout: the argument bytes.  The peak
is the arguments plus the largest live set of new storages.  A serving
engine that runs its programs as CUDA graphs also holds each graph's
static inputs and outputs (``graph.Program``) for its life, and the
capture stream's cuBLAS workspaces: ``CapacityPlan.peak_bytes`` adds them
to every program's peak but the graphs it captures itself;
``eager_peak_bytes`` is the peak without graphs.

Accuracy contract: ``chip_smoke.py``'s ``analysis_gpt2`` holds the plan
to ``torch.cuda.max_memory_allocated()`` over the same ``train_batch``,
and over a served trace eager and as graphs, on the card within +-10%,
whole and with the state taken off both sides; on the CPU ``tests/test_torch_analysis_plans.py``
holds the fake-mode peak to the same trace's live-bytes peak over a real
run.  ``zero3_prefetch_transient_bytes`` computes ZeRO-3's paired-gather
transient (two gathered layers) from the engine's dims, as in JAX.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from deepspeed_tpu_torch.analysis import graph as G
from deepspeed_tpu_torch.analysis import profiles as prof_mod
from deepspeed_tpu_torch.analysis import report as R

_TOP_K = 12


@dataclasses.dataclass
class Contributor:
    """One storage alive at the predicted peak."""

    bytes: int
    label: str
    shape: Tuple[int, ...]
    dtype: str
    path: str = ""
    source: str = ""

    def format(self) -> str:
        loc = self.source or self.path or ""
        where = f"  @ {loc}" if loc else ""
        return (f"{self.bytes / 2**20:8.2f} MiB  {self.label:24s} "
                f"{self.dtype}{list(self.shape)}{where}")


@dataclasses.dataclass
class ProgramPlan:
    """Predicted per-device memory envelope of one program."""

    subject: str
    argument_bytes: int
    peak_bytes: int
    contributors: List[Contributor]

    @property
    def transient_bytes(self) -> int:
        return max(0, self.peak_bytes - self.argument_bytes)

    def top_contributors(self, k: int = 5) -> List[Contributor]:
        return sorted(self.contributors, key=lambda c: -c.bytes)[:k]


def analyze_trace(trace: G.Trace, subject: str = "",
                  arg_labels: Optional[Dict[int, str]] = None
                  ) -> ProgramPlan:
    """The plan of one traced program."""
    producers = {}
    for op in trace.ops:
        for t in op.outputs:
            producers.setdefault(t.storage, (op, t))
    contribs = []
    for sid, (nbytes, _) in trace.peak_storages.items():
        op, t = producers.get(sid, (None, None))
        contribs.append(Contributor(
            bytes=nbytes, label=op.short if op is not None else "?",
            shape=tuple(t.shape) if t is not None else (),
            dtype=str(t.dtype).replace("torch.", "") if t is not None
            else "", path=trace.subject,
            source=op.source if op is not None else ""))
    contribs.sort(key=lambda c: -c.bytes)
    return ProgramPlan(subject=subject or trace.subject,
                       argument_bytes=trace.argument_bytes,
                       peak_bytes=trace.total_peak,
                       contributors=contribs[:_TOP_K])


@dataclasses.dataclass
class CapacityPlan:
    """Fit verdict of one engine and batch format against a profile."""

    programs: List[ProgramPlan]
    persistent: dict
    profile: Optional[prof_mod.BackendProfile]
    budget_bytes: Optional[int]
    zero3_prefetch_bytes: int = 0
    comm: Optional[object] = None
    boundary_comm: Optional[object] = None
    #: a serving engine's CUDA graphs: the static input and output bytes
    #: each graph holds for the engine's life (``graph.Program``), keyed
    #: by its ``_program`` key, and the keys each program's trace captures
    graph_static: Dict[object, int] = dataclasses.field(default_factory=dict)
    graph_keys: Dict[str, Sequence[object]] = dataclasses.field(
        default_factory=dict)
    #: the cuBLAS workspaces the captures' stream allocates and keeps
    #: (0 once an earlier capture in the process has them)
    graph_workspace_bytes: int = 0

    def _peak_of(self, p: ProgramPlan) -> int:
        """``p``'s peak with every graph it does not capture holding its
        static buffers (the order of the captures is unknown: the bound
        over orders)."""
        if not self.graph_static:
            return p.peak_bytes
        own = set(self.graph_keys.get(p.subject, ()))
        others = sum(b for k, b in self.graph_static.items()
                     if k not in own)
        return p.peak_bytes + others + self.graph_workspace_bytes

    @property
    def peak_bytes(self) -> int:
        return max((self._peak_of(p) for p in self.programs), default=0)

    @property
    def eager_peak_bytes(self) -> int:
        """The peak of the programs run eagerly (no graph holds memory)."""
        return max((p.peak_bytes for p in self.programs), default=0)

    @property
    def peak_program(self) -> Optional[ProgramPlan]:
        return max(self.programs, key=self._peak_of, default=None)

    def fits(self) -> Optional[bool]:
        if self.budget_bytes is None:
            return None
        return self.peak_bytes <= self.budget_bytes

    def headroom_bytes(self) -> Optional[int]:
        if self.budget_bytes is None:
            return None
        return self.budget_bytes - self.peak_bytes

    def to_report(self, subject: str = "capacity plan") -> R.Report:
        """Findings under ``memory.*`` and ``comm.wire``."""
        rep = R.Report(subject=subject)
        peak = self.peak_bytes
        prog = self.peak_program
        where = prog.subject if prog else "<no program>"
        if self.comm is not None:
            rep.add("comm.wire", R.INFO, self.comm.format_summary(),
                    path=self.comm.subject, pass_name="commplan")
        if self.budget_bytes is None:
            rep.add(
                "memory.no-budget", R.INFO,
                f"predicted per-device peak memory is {_fmt_bytes(peak)} "
                f"({where}); no memory budget configured - set "
                f"analysis.memory_budget_gb or a --profile to gate it",
                pass_name="memplan")
            return rep
        budget = self.budget_bytes
        if peak > budget:
            tops = "\n".join(
                "            " + c.format()
                for c in (prog.top_contributors(5) if prog else []))
            rep.add(
                "memory.budget-exceeded", R.ERROR,
                f"predicted per-device peak memory {_fmt_bytes(peak)} "
                f"exceeds the budget {_fmt_bytes(budget)}"
                + (f" (profile {self.profile.name})" if self.profile
                   else "")
                + f" in program '{where}'.  Top live-set contributors:\n"
                + tops,
                path=where, pass_name="memplan")
        elif peak > 0.9 * budget:
            rep.add(
                "memory.budget", R.WARNING,
                f"predicted per-device peak memory {_fmt_bytes(peak)} is "
                f"within 10% of the {_fmt_bytes(budget)} budget "
                f"({where}); one batch-size or remat change from OOM",
                path=where, pass_name="memplan")
        else:
            rep.add(
                "memory.fit", R.INFO,
                f"predicted per-device peak memory {_fmt_bytes(peak)} "
                f"fits the {_fmt_bytes(budget)} budget "
                f"(headroom {_fmt_bytes(self.headroom_bytes())})",
                path=where, pass_name="memplan")
        return rep

    def format_table(self) -> str:
        lines = []
        name = self.profile.name if self.profile else "<none>"
        budget = (f"{self.budget_bytes / 2**30:.3f} GiB"
                  if self.budget_bytes is not None else "unset")
        lines.append(f"profile {name}  budget {budget}")
        lines.append(f"{'program':<14} {'args':>12} {'transient':>12} "
                     f"{'peak':>12}  fit")
        for p in self.programs:
            fit = "-"
            if self.budget_bytes is not None:
                fit = "OK" if p.peak_bytes <= self.budget_bytes else "OVER"
            lines.append(
                f"{p.subject:<14} {p.argument_bytes / 2**20:>10.2f}Mi "
                f"{p.transient_bytes / 2**20:>10.2f}Mi "
                f"{p.peak_bytes / 2**20:>10.2f}Mi  {fit}")
        pers = self.persistent
        if pers:
            lines.append(
                "persistent: params "
                f"{pers['params_bytes'] / 2**20:.2f}Mi + optimizer "
                f"{pers['optimizer_state_bytes'] / 2**20:.2f}Mi + grad-acc "
                f"{pers['grad_accumulator_bytes'] / 2**20:.2f}Mi "
                f"(zero_stage={pers['zero_stage']})")
            if "kv_cache_bytes" in pers:
                lines.append(
                    f"kv cache: {pers['kv_cache_bytes'] / 2**20:.2f}Mi "
                    f"preallocated (page pool)")
            if "draft_params_bytes" in pers:
                lines.append(
                    f"draft: params "
                    f"{pers['draft_params_bytes'] / 2**20:.2f}Mi + "
                    f"kv cache "
                    f"{pers.get('draft_kv_cache_bytes', 0) / 2**20:.2f}Mi")
        if self.zero3_prefetch_bytes:
            lines.append(
                f"zero3 prefetch transient: "
                f"{self.zero3_prefetch_bytes / 2**20:.2f}Mi "
                f"(two gathered layers)")
        if self.comm is not None:
            lines.append(self.comm.format_summary())
        return "\n".join(lines)

    def to_json(self) -> dict:
        out = {
            "profile": self.profile.name if self.profile else None,
            "budget_bytes": self.budget_bytes,
            "peak_bytes": self.peak_bytes,
            "fits": self.fits(),
            "persistent": dict(self.persistent),
            "zero3_prefetch_bytes": self.zero3_prefetch_bytes,
            "eager_peak_bytes": self.eager_peak_bytes,
            "graph_static_bytes": sum(self.graph_static.values()),
            "graph_workspace_bytes": self.graph_workspace_bytes,
            "programs": [{
                "subject": p.subject,
                "argument_bytes": p.argument_bytes,
                "transient_bytes": p.transient_bytes,
                "peak_bytes": p.peak_bytes,
                "top_contributors": [{
                    "bytes": c.bytes, "label": c.label,
                    "shape": list(c.shape), "dtype": c.dtype,
                    "path": c.path, "source": c.source,
                } for c in p.top_contributors(5)],
            } for p in self.programs],
        }
        if self.comm is not None:
            out["comm"] = self.comm.to_json()
        if self.boundary_comm is not None:
            out["boundary_comm"] = self.boundary_comm.to_json()
        return out


def _fmt_bytes(n: int) -> str:
    if abs(n) >= int(0.01 * 2**30):
        return f"{n / 2**30:.3f} GiB"
    return f"{n / 2**20:.3f} MiB"


def zero3_prefetch_transient_bytes(engine) -> int:
    """ZeRO-3's paired-gather transient: two gathered layers' bytes in the
    compute dtype (0 without ``overlap_comm``, below stage 3, or at an odd
    or single-layer depth, the JAX condition)."""
    if not getattr(engine, "zero3", False) or \
            not getattr(engine, "overlap_comm", False):
        return 0
    dims = getattr(engine, "_zero3_dims", None) or {}
    itemsize = torch.finfo(engine.policy.compute_dtype).bits // 8
    layer, depth = 0, None
    for name, shape in engine._global_shapes.items():
        d = dims.get(name, -1)
        if d is not None and int(d) >= 1 and len(shape) >= 1 and shape[0]:
            if depth is None:
                depth = int(shape[0])
            n = 1
            for s in shape:
                n *= int(s)
            layer += (n // int(shape[0])) * itemsize
    if depth is None or depth < 2 or depth % 2:
        return 0
    return 2 * layer
