"""The four graph-lint passes over a dispatch-level trace.

The port of ``deepspeed_tpu/analysis/passes.py``, under its rule codes.
Each pass takes a :class:`~.graph.Trace` (or, for shard specs, spec and
value trees) and appends findings to a :class:`~.report.Report`.

1. ``collectives``: every rank of a group must issue the same ordered
   collectives on it.  One rank's trace cannot show SPMD branch divergence
   (it took one branch), so the ranks' ordered signatures (op, group
   ranks, reduce op, operand shapes and dtypes) are exchanged once, through
   ``dist.all_gather_object`` on the engine's control group, and compared
   group by group: the first difference is ``collective.divergent-order``
   with both ranks' sources.  Point-to-point sends pair with the peer's
   receives by shape and dtype (``collective.ppermute-malformed``); a group
   that is none of the topology's is ``collective.axis-unknown``.  The
   trace is fake, so nothing reached the wire: a divergence is reported
   before it could hang.
2. ``precision``: taint from an explicit bf16/fp16 -> fp32 copy; a down-cast
   clears it.  A tainted operand of an fp32 product (``mm``, ``bmm``,
   ``addmm``, ``baddbmm``, ``linear``, convolutions) on a CUDA device is
   ``precision.upcast-dot`` (ERROR): ask for fp32 accumulation of the
   low-precision operands instead (``torch.bmm(..., out_dtype=
   torch.float32)``).  On the CPU, which has no such product, it is INFO.
   Large upcasts (``precision.upcast``) and large low-precision sums
   (``precision.lowp-accum``) are INFO.
3. ``transfers``: a host read inside a traced step program that is neither
   a ``fences.py`` fence, the spool's drain nor a collective's host
   staging is ``transfer.host-callback``; a Python scalar among a CUDA
   graph program's inputs is ``transfer.weak-type`` (the graph bakes it
   in).
4. ``shard specs``: partition specs against the group sizes and the
   values' shapes (``shardspec.axis-unknown|rank|indivisible``); pure
   Python, the JAX pass's findings word for word.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from deepspeed_tpu_torch.analysis import graph as G
from deepspeed_tpu_torch.analysis import report as R

DOT_OPS = frozenset({"mm", "bmm", "addmm", "baddbmm", "addbmm", "matmul",
                     "linear", "convolution", "_convolution", "dot",
                     "mv", "einsum"})
REDUCE_OPS = frozenset({"sum", "cumsum", "mean", "logcumsumexp"})
COPY_OPS = frozenset({"_to_copy", "to", "copy_", "copy"})

LOW_PRECISION = (torch.bfloat16, torch.float16)

#: element-count thresholds, as in the JAX passes
UPCAST_INFO_MIN_SIZE = 1 << 16
LOWP_REDUCE_MIN_SIZE = 1 << 16

#: the port's own source a host read is deliberate in: the spool's drain
SPOOL_SOURCE = "deepspeed_tpu_torch/observability/spool.py"


def _is_lowp(dtype) -> bool:
    return dtype in LOW_PRECISION


def _is_f32(dtype) -> bool:
    return dtype == torch.float32


# ======================================================================
# Pass 1: collective consistency
# ======================================================================

def collective_signature(op: G.Op) -> Tuple:
    """(op, group ranks, reduce op, peer, operands): the wire format."""
    return (op.short, op.group, op.reduce_op, op.peer,
            tuple((tuple(t.shape), str(t.dtype).replace("torch.", ""))
                  for t in op.inputs))


def _fmt_sig(sig) -> str:
    name, group, red, peer, operands = sig
    s = f"{name}(group={list(group) if group is not None else '?'}"
    if red is not None:
        s += f", op={red}"
    if peer is not None:
        s += f", peer={peer}"
    for shape, dt in operands:
        s += f", operand={dt}{list(shape)}"
    return s + ")"


def _is_p2p(sig) -> bool:
    return sig[0] in ("send", "recv_", "recv_any_source_")


def signatures(trace: G.Trace) -> List[Tuple[Tuple, str]]:
    return [(collective_signature(o), o.source) for o in trace.collectives()]


def exchange(payload, group=None):
    """Every rank's ``payload`` (``dist.all_gather_object``), in rank
    order; ``[payload]`` without a started group of several ranks."""
    import torch.distributed as dist
    if not dist.is_initialized():
        return [payload]
    world = dist.get_world_size(group)
    if world <= 1:
        return [payload]
    out = [None] * world
    dist.all_gather_object(out, payload, group=group)
    return out


def check_collectives(traces: Dict[str, G.Trace], report: R.Report,
                      known_groups: Optional[Dict[str, Tuple[int, ...]]]
                      = None, control_group=None, rank: int = 0) -> None:
    """Pass 1 over the programs ``traces`` (subject -> trace) of every
    rank: one exchange for all of them, so every rank calls this exactly
    once per lint.  ``known_groups``: the topology's groups by axis name
    (None skips ``collective.axis-unknown``)."""
    mine = {k: signatures(t) for k, t in traces.items()}
    known = (None if known_groups is None
             else {tuple(g) for g in known_groups.values() if g})
    for subject, seq in mine.items():
        for sig, src in seq:
            grp = sig[1]
            if known is not None and grp is not None and grp not in known:
                report.add(
                    "collective.axis-unknown", R.ERROR,
                    f"{_fmt_sig(sig)} runs over ranks {list(grp)}, which is "
                    f"none of the engine topology's groups "
                    f"{sorted(known_groups)}; this program cannot run on "
                    f"the engine's layout",
                    path=subject, source=src, pass_name="collectives")
    everyone = exchange({"rank": rank, "programs": mine}, control_group)
    by_rank = {p["rank"]: p["programs"] for p in everyone}
    for subject, seq in mine.items():
        _compare_groups(subject, rank, seq, by_rank, report)
        _compare_p2p(subject, rank, seq, by_rank, report)


def _on_group(seq, grp):
    return [(s, src) for s, src in seq if s[1] == grp and not _is_p2p(s)]


def _compare_groups(subject, rank, seq, by_rank, report) -> None:
    groups = []
    for s, _ in seq:
        if s[1] is not None and not _is_p2p(s) and s[1] not in groups:
            groups.append(s[1])
    for grp in groups:
        # every member compares the group's lowest rank with the others,
        # on the same exchanged data: all of them report (and raise)
        low = min(grp)
        if low not in by_rank:
            continue
        ours = _on_group(by_rank[low].get(subject, []), grp)
        for other in grp:
            if other == low or other not in by_rank:
                continue
            theirs = _on_group(by_rank[other].get(subject, []), grp)
            detail = _first_divergence(ours, theirs, low, other)
            if detail is not None:
                report.add(
                    "collective.divergent-order", R.ERROR,
                    f"ranks {low} and {other} of group {list(grp)} issue "
                    f"DIFFERENT ordered collective sequences in program "
                    f"'{subject}': the ranks would block in mismatched "
                    f"collectives, a whole-group deadlock at run time.  "
                    f"First divergence: {detail}",
                    path=subject, source=detail.split(" @ ")[-1]
                    if " @ " in detail else "", pass_name="collectives")


def _first_divergence(a, b, ra, rb) -> Optional[str]:
    for i, ((x, sx), (y, sy)) in enumerate(zip(a, b)):
        if x != y:
            return (f"position {i}: rank {ra} {_fmt_sig(x)} at "
                    f"{sx or '<unlocated>'} vs rank {rb} {_fmt_sig(y)} at "
                    f"{sy or '<unlocated>'}")
    if len(a) != len(b):
        i = min(len(a), len(b))
        longer, who = (a, ra) if len(a) > len(b) else (b, rb)
        sig, src = longer[i]
        return (f"position {i}: rank {who} {_fmt_sig(sig)} at "
                f"{src or '<unlocated>'} vs <no collective> (sequence "
                f"lengths {len(a)} vs {len(b)})")
    return None


def _compare_p2p(subject, rank, seq, by_rank, report) -> None:
    """Each rank's sends to a peer against the peer's receives from it, in
    order, by shape and dtype; both ends of a mismatched pair report."""
    def p2p(r, kind):
        out: Dict[int, list] = {}
        for s, src in by_rank[r].get(subject, []):
            if s[0].startswith(kind) and s[1] is not None \
                    and s[3] is not None:
                out.setdefault(s[1][s[3]], []).append((s, src))
        return out
    for sender in sorted(by_rank):
        for peer, sent in p2p(sender, "send").items():
            if rank not in (sender, peer) or peer not in by_rank:
                continue
            recvs = p2p(peer, "recv").get(sender, [])
            problem = None
            for i, ((x, sx), (y, sy)) in enumerate(zip(sent, recvs)):
                if x[4] != y[4]:
                    problem = (f"send {i} {_fmt_sig(x)} at {sx} vs the "
                               f"peer's receive {_fmt_sig(y)} at {sy}")
                    break
            if problem is None and len(sent) != len(recvs):
                problem = (f"{len(sent)} send(s) to rank {peer} vs "
                           f"{len(recvs)} receive(s) from rank {sender} "
                           f"there")
            if problem is not None:
                report.add(
                    "collective.ppermute-malformed", R.ERROR,
                    f"rank {sender} -> rank {peer} in program "
                    f"'{subject}': {problem}: some rank will wait on a "
                    f"message that never arrives (deadlock)",
                    path=subject, source=sent[0][1],
                    pass_name="collectives")


# ======================================================================
# Pass 2: precision flow
# ======================================================================

def check_precision(trace: G.Trace, report: R.Report) -> None:
    """Upcast-then-dot, large upcasts and low-precision sums."""
    tainted: set = set()
    for op in trace.ops:
        if op.kind != "aten":
            continue
        name = op.short
        ins = [t for t in op.inputs]
        if name in COPY_OPS and ins and op.outputs:
            src = ins[-1] if name == "copy_" else ins[0]
            dst = op.outputs[0]
            if _is_f32(dst.dtype) and _is_lowp(src.dtype):
                tainted.add(dst.tid)
                if src.numel >= UPCAST_INFO_MIN_SIZE:
                    report.add(
                        "precision.upcast", R.INFO,
                        f"large fp32 upcast of a "
                        f"{str(src.dtype).replace('torch.', '')} value "
                        f"({src.numel} elements): fp32 copies double HBM "
                        f"traffic; intended for loss / norm islands, a "
                        f"mistake on the compute path",
                        path=trace.subject, source=op.source,
                        pass_name="precision")
                continue
            if _is_lowp(dst.dtype):
                tainted.discard(dst.tid)
                continue
        if name in DOT_OPS and op.outputs:
            out = op.outputs[0]
            if _is_f32(out.dtype) and any(t.tid in tainted for t in ins):
                on_card = out.device == "cuda"
                report.add(
                    "precision.upcast-dot", R.ERROR if on_card else R.INFO,
                    "fp32 matmul on operands explicitly upcast from "
                    "bf16/fp16: this runs the tensor cores at fp32 rates "
                    "and doubles operand HBM bytes.  Keep the operands "
                    "low-precision and ask for fp32 accumulation instead "
                    "(torch.bmm(..., out_dtype=torch.float32))"
                    + ("" if on_card else
                       " [cpu: no bf16/fp16 product with fp32 output on "
                       "this host, the upcast is the only route]"),
                    path=trace.subject, source=op.source,
                    pass_name="precision")
        if name in REDUCE_OPS and ins and _is_lowp(ins[0].dtype) and \
                ins[0].numel >= LOWP_REDUCE_MIN_SIZE:
            report.add(
                "precision.lowp-accum", R.INFO,
                f"{name} accumulates {ins[0].numel} elements in "
                f"{str(ins[0].dtype).replace('torch.', '')}: large sums lose "
                f"mantissa bits in bf16/fp16 - if this is forward-path "
                f"compute (not a bias-grad reduction), accumulate in fp32 "
                f"and down-cast the result",
                path=trace.subject, source=op.source, pass_name="precision")
        if any(t.tid in tainted for t in ins):
            for t in op.outputs:
                if not _is_lowp(t.dtype):
                    tainted.add(t.tid)



# ======================================================================
# Pass 3: transfers
# ======================================================================

def check_transfers(trace: G.Trace, report: R.Report) -> None:
    """Host reads inside a step program; Python scalars among a CUDA-graph
    program's call arguments (``trace.programs``)."""
    for prog in trace.programs:
        key = prog.key
        for i, t in enumerate(prog.types):
            if issubclass(t, (bool, int, float)):
                report.add(
                    "transfer.weak-type", R.WARNING,
                    f"program {key} input {i} is a Python {t.__name__}: a "
                    f"CUDA graph bakes it into the capture, so a later "
                    f"call with another value replays the old one.  Pass "
                    f"a tensor",
                    path=trace.subject, pass_name="transfers")
    for op in trace.ops:
        if op.kind != "read" and not (
                op.kind == "aten" and op.short == "_to_copy" and op.inputs
                and op.inputs[0].device != "cpu" and op.outputs
                and op.outputs[0].device == "cpu"):
            continue
        if op.fence:
            continue
        if op.staged:
            continue
        if op.source.startswith(SPOOL_SOURCE):
            report.add(
                "transfer.spool-drain", R.INFO,
                "the telemetry MetricSpool drain: an allowlisted host "
                "transfer batched once per report window",
                path=trace.subject, source=op.source, pass_name="transfers")
            continue
        what = ("host read of a device value" if op.kind == "read"
                else "device-to-host copy")
        report.add(
            "transfer.host-callback", R.ERROR,
            f"{what} inside the step program: the host waits for the "
            f"device at every execution - on several ranks every rank "
            f"stalls for the slowest.  Keep the value on the device, or "
            f"read it through observability.fences on purpose",
            path=trace.subject, source=op.source, pass_name="transfers")


# ======================================================================
# Pass 4: shard-spec validation (pure Python)
# ======================================================================

class PartitionSpec(tuple):
    """One spec entry per dim (None | axis name | tuple of axis names),
    printed as the JAX package prints its specs."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return "PartitionSpec" + tuple.__repr__(self)

    __str__ = __repr__


def _axes_of_entry(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    if isinstance(entry, (tuple, list)):
        return tuple(str(a) for a in entry)
    return (str(entry),)


def _keystr(path) -> str:
    return "".join(f"[{k!r}]" for k in path)


def _flatten(tree, is_leaf, path=()) -> List[Tuple[str, object]]:
    if is_leaf(tree):
        return [(_keystr(path), tree)]
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out.extend(_flatten(tree[k], is_leaf, path + (k,)))
        return out
    if isinstance(tree, (list, tuple)) and not isinstance(
            tree, PartitionSpec):
        out = []
        for i, v in enumerate(tree):
            out.extend(_flatten(v, is_leaf, path + (i,)))
        return out
    if tree is None:
        return []
    return [(_keystr(path), tree)]


def check_shard_specs(mesh_shape, specs, tree, report: R.Report,
                      where: str = "") -> None:
    """Validate a tree of :class:`PartitionSpec` against the axis sizes
    ``mesh_shape`` (``{axis: size}``) and the matching tree of values
    (anything with ``.shape``).  A spec may be a prefix of the value tree:
    it applies to every leaf under its path."""
    mesh_shape = dict(mesh_shape)
    flat_s = _flatten(specs, lambda x: isinstance(x, PartitionSpec))
    vals = _flatten(tree, lambda x: hasattr(x, "shape"))
    for key, spec in flat_s:
        if not isinstance(spec, PartitionSpec):
            continue
        entries = list(spec)
        spec_label = f"{where}{key}" if where else (key or "<root>")
        for axis in sorted({a for e in entries for a in _axes_of_entry(e)}):
            if axis not in mesh_shape:
                report.add(
                    "shardspec.axis-unknown", R.ERROR,
                    f"{spec_label}: spec {spec} names mesh axis {axis!r} "
                    f"but the engine mesh has axes "
                    f"{sorted(mesh_shape)}",
                    path=spec_label, pass_name="shard-specs")
        leaves = [(kv, v) for kv, v in vals
                  if kv == key or kv.startswith(key)]
        for leaf_key, leaf in leaves:
            shape = getattr(leaf, "shape", None)
            if shape is None:
                continue
            shape = tuple(int(d) for d in shape)
            label = f"{where}{leaf_key}" if where else (leaf_key or "<leaf>")
            if len(entries) > len(shape):
                report.add(
                    "shardspec.rank", R.ERROR,
                    f"{label}: spec {spec} has {len(entries)} entries but "
                    f"the value has rank {len(shape)} "
                    f"(shape {tuple(shape)})",
                    path=label, pass_name="shard-specs")
                continue
            for dim, entry in enumerate(entries):
                axes = [a for a in _axes_of_entry(entry) if a in mesh_shape]
                if not axes:
                    continue
                total = 1
                for a in axes:
                    total *= int(mesh_shape[a])
                if total > 0 and shape[dim] % total != 0:
                    report.add(
                        "shardspec.indivisible", R.ERROR,
                        f"{label}: dim {dim} of shape {tuple(shape)} is "
                        f"sharded over axis "
                        f"{entry!r} (size {total}) by spec {spec}, but "
                        f"{shape[dim]} % {total} != 0 — shard_map would "
                        f"fail or silently pad.  Fix the batch/param "
                        f"shape or the spec",
                        path=label, pass_name="shard-specs")


def dim_specs(dims, axis: str = "model"):
    """The port's ``partition_specs()`` (the cut dim of each leaf, None
    replicated) as :class:`PartitionSpec` trees over ``axis``."""
    if isinstance(dims, dict):
        return {k: dim_specs(v, axis) for k, v in dims.items()}
    if isinstance(dims, (list, tuple)):
        return type(dims)(dim_specs(v, axis) for v in dims)
    if dims is None:
        return PartitionSpec()
    return PartitionSpec(*([None] * int(dims) + [axis]))
