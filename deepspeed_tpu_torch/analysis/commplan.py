"""Capacity planner, wire half: bytes on the wire per step.

The port of ``deepspeed_tpu/analysis/commplan.py``.  Every collective of a
traced program carries its wire format (op, group ranks, operand shapes
and dtypes), the signature the collective pass compares; this pass prices
it with the JAX package's ring table, rolls the bytes up per axis of the
topology (``data``, ``model``, ``pipe``, ``seq``) and converts them to
time on a profile.

Cost model (b = per-rank operand bytes, n = group size):

=====================  =====================  ==========================
c10d op                bytes on wire per rank  JAX primitive
=====================  =====================  ==========================
allreduce_             2 b (n-1)/n            psum / pmax / pmin
_allgather_base_       b_in (n-1)             all_gather
_reduce_scatter_base_  b_in (n-1)/n           psum_scatter
alltoall_base_         b (n-1)/n              all_to_all
send                   b                      ppermute
broadcast_             b (n-1)/n              (none)
=====================  =====================  ==========================

A ``recv`` is priced on its sender (the JAX ppermute is one op on both
ends).  Predicted times are nominal-rate lower bounds.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from deepspeed_tpu_torch.analysis import graph as G
from deepspeed_tpu_torch.analysis import profiles as prof_mod

#: c10d op (short name) -> the JAX primitive class it is priced as
PRIMS = {
    "allreduce_": "psum", "allreduce_coalesced_": "psum",
    "_allgather_base_": "all_gather", "allgather_": "all_gather",
    "allgather_into_tensor_coalesced_": "all_gather",
    "_reduce_scatter_base_": "psum_scatter",
    "reduce_scatter_": "psum_scatter",
    "reduce_scatter_tensor_coalesced_": "psum_scatter",
    "alltoall_base_": "all_to_all", "alltoall_": "all_to_all",
    "send": "ppermute", "broadcast_": "broadcast",
}


def _wire_bytes(prim: str, b: int, n: int) -> int:
    if n <= 1:
        return 0
    if prim == "psum":
        return int(2 * b * (n - 1) / n)
    if prim == "all_gather":
        return int(b * (n - 1))
    if prim in ("psum_scatter", "all_to_all", "broadcast"):
        return int(b * (n - 1) / n)
    if prim == "ppermute":
        return int(b)
    return 0


def _operand_bytes(op: G.Op, prim: str) -> int:
    ins = op.inputs
    if prim in ("all_gather", "psum_scatter", "all_to_all") \
            and len(ins) >= 2:
        # (output, input): price the input, as the JAX eqn's operand
        ins = ins[1:]
    return sum(t.bytes for t in ins)


@dataclasses.dataclass
class CollectiveCost:
    """One collective site."""

    primitive: str
    axes: Tuple[str, ...]
    group_size: int
    executions: int
    bytes_per_execution: int
    path: str = ""
    source: str = ""
    op: str = ""

    @property
    def bytes_total(self) -> int:
        return self.executions * self.bytes_per_execution


@dataclasses.dataclass
class CommPlan:
    """Bytes-on-wire roll-up of one step program."""

    subject: str
    costs: List[CollectiveCost]
    mesh_shape: Dict[str, int]
    profile: Optional[prof_mod.BackendProfile] = None
    multi_host: bool = False

    @property
    def total_bytes(self) -> int:
        return sum(c.bytes_total for c in self.costs)

    def per_axis_bytes(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for c in self.costs:
            for a in c.axes:
                out[a] = out.get(a, 0) + c.bytes_total
        return out

    def predicted_time_ms(self, multi_host: Optional[bool] = None
                          ) -> Optional[float]:
        if self.profile is None:
            return None
        if multi_host is None:
            multi_host = self.multi_host
        total_s = 0.0
        for axis, nbytes in self.per_axis_bytes().items():
            gibps = self.profile.ici_gibps
            if multi_host and axis in prof_mod.DCN_AXES:
                gibps = self.profile.dcn_gibps
            if gibps > 0:
                total_s += nbytes / (gibps * (1 << 30))
        return total_s * 1e3

    def format_summary(self) -> str:
        per_axis = ", ".join(
            f"{a}={b / 2**20:.2f}Mi"
            for a, b in sorted(self.per_axis_bytes().items()))
        t = self.predicted_time_ms()
        t_s = f", predicted wire time {t:.3f} ms" if t is not None else ""
        return (f"wire/step: {self.total_bytes / 2**20:.2f}Mi "
                f"({per_axis or 'no collectives'}; "
                f"{len(self.costs)} collective site(s){t_s})")

    def to_json(self) -> dict:
        return {
            "subject": self.subject,
            "total_bytes": self.total_bytes,
            "per_axis_bytes": self.per_axis_bytes(),
            "predicted_time_ms": self.predicted_time_ms(),
            "multi_host": self.multi_host,
            "collectives": [{
                "primitive": c.primitive, "op": c.op,
                "axes": list(c.axes), "group_size": c.group_size,
                "executions": c.executions,
                "bytes_per_execution": c.bytes_per_execution,
                "bytes_total": c.bytes_total, "source": c.source,
            } for c in self.costs],
        }


def axis_of(group: Optional[Tuple[int, ...]],
            axes: Dict[str, Tuple[int, ...]]) -> Tuple[str, ...]:
    """The topology axis a group's ranks are (``axes``: name -> ranks; a
    data sub-group counts as ``data``)."""
    if group is None:
        return ()
    for name, ranks in axes.items():
        if ranks and tuple(ranks) == tuple(group):
            return (name.split(":")[0],)
    return ("?",)


def analyze_comm(trace: G.Trace, axes: Dict[str, Tuple[int, ...]],
                 profile: Optional[prof_mod.BackendProfile] = None,
                 subject: str = "", multi_host: bool = False) -> CommPlan:
    """Price every collective of ``trace``; ``axes`` maps each topology
    axis to this rank's group ranks of it."""
    costs: List[CollectiveCost] = []
    sizes: Dict[str, int] = {}
    for op in trace.collectives():
        prim = PRIMS.get(op.short)
        if prim is None:
            continue
        n = len(op.group) if op.group else 1
        ax = axis_of(op.group, axes)
        for a in ax:
            sizes[a] = n
        costs.append(CollectiveCost(
            primitive=prim, axes=ax, group_size=n, executions=1,
            bytes_per_execution=_wire_bytes(prim, _operand_bytes(op, prim),
                                            n),
            path=trace.subject, source=op.source, op=op.short))
    return CommPlan(subject=subject or trace.subject, costs=costs,
                    mesh_shape=sizes, profile=profile,
                    multi_host=multi_host)


def merge(subject: str, plans: List[CommPlan],
          profile: Optional[prof_mod.BackendProfile] = None) -> CommPlan:
    """One plan of several programs' collectives."""
    costs, sizes = [], {}
    for p in plans:
        costs.extend(p.costs)
        sizes.update(p.mesh_shape)
    return CommPlan(subject=subject, costs=costs, mesh_shape=sizes,
                    profile=profile,
                    multi_host=any(p.multi_host for p in plans))
