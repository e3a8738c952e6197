"""Compile-stability pass: pin which executables a run builds.

The port of ``deepspeed_tpu/analysis/stability.py``.  The port's
"executables" are not XLA's:

* the serving engine's CUDA graphs, one per ``(program, input shapes)``
  key of ``InferenceEngine._program``: counted as keys on the CPU (where
  the engine runs eagerly and ``_graphs`` is None) and as
  ``len(engine._graphs)`` on the card;
* the kernel libraries ``ops/_build.py`` builds, counted by
  ``COUNTERS.compile_cache_misses`` on a cold build directory: one per
  ``csrc/`` source the traced step launches a kernel of.

Rules: ``stability.unpinned-sharding`` (error) is a state leaf whose
device or dtype is not the engine's declared one, checked after build and
after ``load_checkpoint`` (the class of the JAX package's PR 5 resume
recompile); ``stability.shape-varying`` (error) is a serving program
whose call signature differs across prompt lengths or reuse offsets (a
new graph per length); ``stability.weak-input`` (warning) is a Python
scalar among a graphed program's call arguments.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from deepspeed_tpu_torch.analysis import report as R

#: kernel-op name prefix -> the csrc source (one library each)
KERNEL_LIBRARIES = {
    "lamb": "fused_optim", "adam": "fused_optim",
    "stream": "stream_attention", "block": "block_attention",
}


@dataclasses.dataclass(frozen=True)
class LeafSig:
    """Cache-key-relevant facts of one call argument."""

    path: str
    shape: Tuple[int, ...]
    dtype: str
    weak_type: bool
    device: str

    def key(self) -> Tuple:
        return (self.shape, self.dtype, self.weak_type, self.device)


@dataclasses.dataclass
class ProgramSignature:
    """A graphed program's key: its inputs' shapes, dtypes and devices."""

    kind: str
    leaves: Tuple[LeafSig, ...]

    def key(self) -> Tuple:
        return tuple(l.key() for l in self.leaves)

    def diff(self, other: "ProgramSignature") -> List[str]:
        out = []
        a = {l.path: l for l in self.leaves}
        b = {l.path: l for l in other.leaves}
        for path in list(a) + [p for p in b if p not in a]:
            la, lb = a.get(path), b.get(path)
            if la is None or lb is None:
                out.append(f"{path}: present in one signature only")
            elif la.key() != lb.key():
                out.append(f"{path}: {la.dtype}{list(la.shape)} vs "
                           f"{lb.dtype}{list(lb.shape)}")
        return out


def signature_of(args, kind: str = "",
                 arg_labels: Optional[Sequence[str]] = None
                 ) -> ProgramSignature:
    """The signature of calling a program with ``args``: tensors and
    numpy arrays by shape and dtype, Python scalars as weak leaves."""
    leaves = []
    for i, a in enumerate(args):
        path = (arg_labels[i] if arg_labels and i < len(arg_labels)
                else f"arg{i}")
        if isinstance(a, torch.Tensor):
            leaves.append(LeafSig(path, tuple(a.shape),
                                  str(a.dtype).replace("torch.", ""), False,
                                  a.device.type))
        elif isinstance(a, np.ndarray):
            leaves.append(LeafSig(path, tuple(a.shape), str(a.dtype), False,
                                  "host"))
        else:
            leaves.append(LeafSig(path, (), type(a).__name__,
                                  isinstance(a, (bool, int, float)),
                                  "host"))
    return ProgramSignature(kind=kind, leaves=tuple(leaves))


def check_single_executable(kind: str,
                            signatures: Sequence[ProgramSignature],
                            report: R.Report) -> None:
    if not signatures:
        return
    base = signatures[0]
    for sig in signatures[1:]:
        diff = base.diff(sig)
        if diff:
            report.add(
                "stability.shape-varying", R.ERROR,
                f"call sites of program '{kind}' produce DIFFERENT "
                f"signatures - each distinct one captures another CUDA "
                f"graph, so the one-graph-per-program promise is broken "
                f"and steady-state steps pay a capture.  Divergence: "
                + "; ".join(diff[:4]) + ("; ..." if len(diff) > 4 else ""),
                path=kind, pass_name="stability")
            return


def check_weak_inputs(args, report: R.Report, subject: str = "",
                      arg_labels: Optional[Sequence[str]] = None) -> None:
    for leaf in signature_of(args, kind=subject,
                             arg_labels=arg_labels).leaves:
        if leaf.weak_type:
            report.add(
                "stability.weak-input", R.WARNING,
                f"{subject or 'program'} argument {leaf.path} is a Python "
                f"{leaf.dtype}: a CUDA graph bakes it in at capture.  "
                f"Stage it as a tensor",
                path=leaf.path, pass_name="stability")


def check_tree_placement(tree, label: str, device: torch.device,
                         dtype_of, report: R.Report) -> None:
    """``stability.unpinned-sharding`` for every tensor of ``tree`` (a
    dict of tensors, possibly nested) that is not on ``device`` or not of
    ``dtype_of(path)`` (None: any dtype)."""
    def walk(t, path):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, f"{path}[{k!r}]")
            return
        if not isinstance(t, torch.Tensor):
            return
        bad = []
        if t.device.type != device.type or (
                device.index is not None and t.device.index is not None
                and t.device.index != device.index):
            bad.append(f"is on {t.device}, not {device}")
        want = dtype_of(path)
        if want is not None and t.dtype != want:
            bad.append(f"is {str(t.dtype).replace('torch.', '')}, not "
                       f"{str(want).replace('torch.', '')}")
        if bad:
            report.add(
                "stability.unpinned-sharding", R.ERROR,
                f"{label}{path} " + " and ".join(bad) + " - the engine's "
                f"programs were built for its declared placement; the next "
                f"step copies it (or captures another graph) every call.  "
                f"Load state onto the engine's device and dtype",
                path=f"{label}{path}", pass_name="stability")
    walk(tree, "")


@dataclasses.dataclass
class ExecutablePrediction:
    """What a run builds: programs (CUDA graphs) and kernel libraries."""

    subject: str
    programs: List[Tuple[str, str, int]]
    libraries: List[str] = dataclasses.field(default_factory=list)

    @property
    def total(self) -> int:
        return sum(n for _, _, n in self.programs)

    @property
    def graphs(self) -> int:
        return sum(n for k, _, n in self.programs if k != "library")

    def format_table(self) -> str:
        lines = [f"{'program':<14} {'format':<22} executables"]
        for kind, fmt, n in self.programs:
            lines.append(f"{kind:<14} {fmt:<22} {n}")
        lines.append(f"{'total':<14} {'':<22} {self.total}")
        return "\n".join(lines)

    def to_json(self) -> dict:
        return {"subject": self.subject, "total": self.total,
                "libraries": list(self.libraries),
                "programs": [{"kind": k, "format": f, "executables": n}
                             for k, f, n in self.programs]}


def libraries_of(traces) -> List[str]:
    """The kernel libraries the traced programs launch kernels of (on the
    CPU a wrapper runs its plain version: no library)."""
    out = []
    for tr in traces:
        for op in tr.ops:
            if op.kind != "kernel" or not any(t.device == "cuda"
                                              for t in op.inputs):
                continue
            name = op.name.split(".")[1]            # dstpu.<kernel>.default
            lib = KERNEL_LIBRARIES.get(name.split("_")[0])
            if lib is not None and lib not in out:
                out.append(lib)
    return out


def predict_executables(engine, batches: Sequence = (), train: bool = True,
                        fused: bool = True, traces=None
                        ) -> ExecutablePrediction:
    """The training engine builds no graph: its executables are the kernel
    libraries the step launches (``traces``: its traced programs; untraced,
    the engine's last gate's traces)."""
    if traces is None:
        traces = list(getattr(engine, "_analysis_traces", {}).values())
    libs = libraries_of(traces)
    return ExecutablePrediction(
        subject="train" if train else "eval",
        programs=[("library", lib, 1) for lib in libs], libraries=libs)


def serve_program_keys(engine) -> List[Tuple[str, Tuple]]:
    """The ``_program`` keys every serving program production can dispatch
    (the keys ``capture_programs`` captures): ``(kind, key)``."""
    slots, spec = engine.num_slots, engine.cache_spec
    out = [("prefill", (("extend", False), (1, engine.prefill_bucket)))]
    if engine.tail_bucket:
        out.append(("prefill_tail",
                    (("extend", False), (1, engine.tail_bucket))))
    out.append(("decode", (("decode", False), (slots,))))
    j = int(engine.spec_draft_tokens or 0)
    if j > 0:
        out.append(("draft_prefill",
                    (("extend", True), (1, engine.prefill_bucket))))
        out.append(("draft_decode", (("decode", True), (slots,))))
        out.append(("spec_verify", (("extend", False), (slots, j + 1))))
    return out


def predict_executables_serve(engine) -> ExecutablePrediction:
    """One CUDA graph per distinct ``_program`` key production dispatches:
    the extend at the prefill bucket (and the tail bucket with prefix
    reuse), the decode step (``decode_many`` replays it D times), and
    with a draft its prefill, its decode and the verify.  The KV handoff
    and ``copy_page`` run eagerly: no graph."""
    return ExecutablePrediction(
        subject="serve",
        programs=[(kind, "x".join(map(str, key[1])), 1)
                  for kind, key in serve_program_keys(engine)])


def check_engine(engine, batch=None, fused: bool = True,
                 train: bool = True) -> R.Report:
    """The training engine's placements: parameters in the compute dtype,
    masters and moments in fp32, all on the engine's device."""
    rep = R.Report(subject="stability")
    dev = engine.device
    cdt = engine.policy.compute_dtype
    check_tree_placement(dict(engine._params), "params", dev,
                         lambda p: cdt, rep)
    if not train:
        return rep
    if engine.zero_flat:
        check_tree_placement({"flat": engine.master_flat}, "master_flat",
                             dev, lambda p: torch.float32, rep)
    else:
        check_tree_placement(dict(engine.master), "master", dev,
                             lambda p: torch.float32, rep)
    st = engine.opt_state
    for name, tree in (("m", st.m), ("v", st.v)):
        if tree is not None:
            check_tree_placement(dict(tree), f"opt_state.{name}", dev,
                                 lambda p: torch.float32, rep)
    ls = engine.loss_scale_state
    check_tree_placement(
        {k: v for k, v in ls._asdict().items()
         if isinstance(v, torch.Tensor)}, "loss_scale_state", dev,
        lambda p: None, rep)
    return rep


def check_inference_engine(engine,
                           prompt_lengths: Sequence[int] = ()) -> R.Report:
    """The serving promise as an invariant: each admission bucket's call
    signature is the same for every prompt length and reuse offset (the
    host-side padding absorbs them), plus the weights' and pools'
    placements."""
    rep = R.Report(subject="serve-stability")
    dev = engine.device
    check_tree_placement(engine._cache, "kv_cache", dev, lambda p: None,
                         rep)
    if engine._draft_cache is not None:
        check_tree_placement(engine._draft_cache, "draft_kv_cache", dev,
                             lambda p: None, rep)
    flat = {}

    def walk(t, path):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, f"{path}[{k!r}]")
        elif isinstance(t, torch.Tensor):
            flat[path] = t
    walk(engine.params, "")
    check_tree_placement(flat, "params", dev, lambda p: None, rep)
    buckets = [("prefill", engine.prefill_bucket)]
    if engine.tail_bucket:
        buckets.append(("prefill_tail", engine.tail_bucket))
    cap = engine.cache_spec.capacity
    labels = ("tokens", "start", "n_new", "rows")
    for kind, bucket in buckets:
        lengths = list(prompt_lengths) or sorted(
            {1, max(1, bucket // 2), bucket})
        sigs = []
        for i, n in enumerate(lengths):
            padded, length = engine._pad_prompt(
                list(range(max(1, min(n, bucket)))), bucket)
            start = (i * 7) % max(1, cap - bucket + 1)
            args = (torch.as_tensor(padded, dtype=torch.int64),
                    torch.tensor([start], dtype=torch.int32),
                    torch.tensor([length], dtype=torch.int32),
                    torch.zeros((1, cap), dtype=torch.int32))
            sigs.append(signature_of(args, kind=kind, arg_labels=labels))
            check_weak_inputs(args, rep, subject=kind, arg_labels=labels)
        check_single_executable(kind, sigs, rep)
    return rep
