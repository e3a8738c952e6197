"""Host-concurrency lint over the port's serving control plane.

A copy of the JAX package's ``analysis/concurrency.py`` that reads the
port's own sources.  The control plane (FleetRouter, ContinuousScheduler,
PagePool, the observability and resilience drivers) is plain Python, so
its locking discipline is decidable from the AST:

* **Lock-order graph** (``concurrency.lock-order``) — every ``with
  <lock>:`` nested inside another (directly or through a resolved call)
  is an order edge; a cycle in the edge set is a potential deadlock and
  errors.  Re-acquiring a non-reentrant lock already held is the
  degenerate one-lock deadlock and errors under the same code.
* **Blocking-under-lock** (``concurrency.blocking-under-lock``) — HTTP
  probes, file IO (the ``io_retry``'d checkpoint paths included),
  ``queue.get``/``Thread.join``/``Event.wait``/``time.sleep``, and the
  device fences (``torch.cuda.synchronize``, ``.item()``, ``.cpu()``, the
  counted reads of ``observability/fences.py``) made while a lock is
  held stall every thread behind that lock (a 2 s socket timeout under
  the router lock freezes all completion callbacks).  Deliberate cases
  carry a ``# dstpu-lock: allow-blocking(reason)`` line annotation and
  downgrade to info.
* **Thread-role contracts** (``concurrency.thread-role``,
  ``concurrency.lock-contract``) — lightweight ``# dstpu-thread:``
  annotations on known entry points declare what the pass then checks:
  ``enqueue-only`` (a runtime-callback must not block or take locks —
  the FleetAggregator drain contract), ``owner-check=<attr>`` (a
  completion path must compare ownership before mutating — the router's
  zombie-replica rule), ``holds=<Lock>`` (a helper documented "call with
  the lock held" is analyzed under that lock — and every resolved caller
  is checked to actually hold it).
* **Guarded-attribute writes** (``concurrency.unlocked-guarded-write``)
  — in a class that owns a lock, an attribute ever written under that
  lock is a shared field; writing it elsewhere without the lock is a
  cross-thread unlocked mutation.  ``__init__`` (and functions flagged
  ``init`` — construction-time, single-threaded by contract) are exempt.

Annotation syntax:

* ``# dstpu-thread: <role> [enqueue-only] [owner-check=<attr>]
  [holds=<Class._lock>] [init]`` — on (or directly above) a ``def``.
* ``# dstpu-lock: <Class._attr>`` — on a ``with``/``acquire`` line whose
  lock the resolver cannot type (a foreign object's lock).
* ``# dstpu-lock: allow-blocking(<reason>)`` — on a blocking call line
  that is deliberate.

The pass is pure ``ast`` over source files — no import, no trace, no
device; it runs in milliseconds at FleetRouter build (config
``analysis.concurrency``) and from the CLI (``python -m
deepspeed_tpu_torch.analysis --concurrency``).  The runtime half
(``analysis/lockwatch.py``) feeds observed order edges back through
:func:`merge_observed`, so an order the AST could not resolve still fails
the cycle check when it happens.
"""

from __future__ import annotations

import ast
import dataclasses
import os
import re
from typing import Dict, List, Optional, Sequence, Set, Tuple

from deepspeed_tpu_torch.analysis import report as R

#: the serving control plane + the observability/resilience drivers it
#: leans on, relative to ``deepspeed_tpu_torch/`` — every module here uses
#: threading (or is mutated across threads, like kvcache's PagePool)
CONTROL_PLANE = (
    "inference/router.py",
    "inference/engine.py",
    "inference/scheduler.py",
    "inference/kvcache.py",
    "inference/observability.py",
    "observability/__init__.py",
    "observability/registry.py",
    "observability/fleet.py",
    "observability/flightrec.py",
    "observability/health.py",
    "observability/spool.py",
    "observability/tracing.py",
    "observability/detectors.py",
    "resilience/watchdog.py",
    "resilience/preempt.py",
    "resilience/chaos.py",
)

#: dotted call names (matched on the full name or any ``.``-suffix)
#: that block the calling thread — never legal under a control-plane
#: lock without an allow-blocking annotation
BLOCKING_CALLS = {
    "time.sleep": "sleeps",
    "urllib.request.urlopen": "makes an HTTP request (2 s socket "
                              "timeouts under a lock wedge every waiter)",
    "socket.create_connection": "opens a socket",
    "io_retry": "runs io_retry'd IO (retries with backoff sleeps)",
    "os.remove": "does file IO",
    "os.rename": "does file IO",
    "os.replace": "does file IO",
    "os.makedirs": "does file IO",
    "shutil.rmtree": "does file IO",
    "open": "does file IO",
    "write_kv_handoff": "writes a KV handoff artifact (io_retry'd IO)",
    "read_kv_handoff": "reads a KV handoff artifact (io_retry'd IO)",
    "synchronize": "waits for device work",
    "item": "reads a device scalar to the host (a fence)",
    "cpu": "copies a device tensor to the host (a fence)",
    "read_arrays": "reads device tensors to the host (a fence)",
    "read_scalar": "reads a device scalar to the host (a fence)",
    "fence_on": "waits for device work",
    "subprocess.run": "runs a subprocess",
}

#: method names that block depending on the RECEIVER's inferred type
#: (``self.X = queue.Queue()`` / ``threading.Event()`` /
#: ``threading.Thread(...)`` assignments type the attribute)
_TYPED_BLOCKING = {
    "queue": {"get": "blocks on a queue"},
    "event": {"wait": "waits on an event"},
    "thread": {"join": "joins a thread"},
}

#: names too generic to resolve a method call by uniqueness alone
_COMMON_METHODS = frozenset({
    "get", "put", "join", "wait", "set", "clear", "close", "append",
    "appendleft", "pop", "popleft", "popitem", "items", "values", "keys",
    "acquire", "release", "start", "run", "emit", "format", "read",
    "write", "flush", "send", "recv", "info", "debug", "warning",
    "error", "exception", "submit", "add", "remove", "update", "copy",
    "healthy", "load", "record", "step", "reset", "collect", "gauges",
})

_ANN_THREAD = re.compile(r"#\s*dstpu-thread:\s*(.+?)\s*$")
_ANN_LOCK = re.compile(r"#\s*dstpu-lock:\s*(.+?)\s*$")


class ConcurrencyLintError(R.GraphLintError):
    """Raised in ``analysis.concurrency.mode == "error"`` when
    error-severity ``concurrency.*`` findings survive suppression.
    Subclasses :class:`GraphLintError`, so one renderer and one
    except-clause contract cover every gate."""


# ===================================================================== model

@dataclasses.dataclass
class LockDef:
    name: str                    # canonical: "Class._attr" | "mod._name"
    file: str
    line: int
    reentrant: bool = False


@dataclasses.dataclass
class ThreadAnnotation:
    role: str
    enqueue_only: bool = False
    owner_check: Optional[str] = None
    holds: Tuple[str, ...] = ()
    init: bool = False


@dataclasses.dataclass
class FuncInfo:
    qual: str                    # "mod.Class.meth" | "mod.func"
    cls: Optional[str]
    file: str
    line: int
    annotation: Optional[ThreadAnnotation] = None
    # (lock, line) pairs acquired anywhere in the body
    acquires: List[Tuple[str, int]] = dataclasses.field(
        default_factory=list)
    # (held, acquired, line) direct order edges
    edges: List[Tuple[str, str, int]] = dataclasses.field(
        default_factory=list)
    # (call name, why, line, held locks) direct blocking calls under lock
    blocking_under: List[Tuple[str, str, int, Tuple[str, ...]]] = \
        dataclasses.field(default_factory=list)
    # (call name, why, line) blocking calls anywhere in the body
    blocking: List[Tuple[str, str, int]] = dataclasses.field(
        default_factory=list)
    # (callee qual, line, held locks at the call)
    calls: List[Tuple[str, int, Tuple[str, ...]]] = dataclasses.field(
        default_factory=list)
    # attr -> [(line, held locks)] direct self-attribute writes
    writes: Dict[str, List[Tuple[int, Tuple[str, ...]]]] = \
        dataclasses.field(default_factory=dict)
    has_owner_compare: Dict[str, bool] = dataclasses.field(
        default_factory=dict)


@dataclasses.dataclass
class ConcurrencyModel:
    """Everything the pass extracted: the lock set, the static order
    graph (with one representative site per edge), the per-function
    summaries and the declared thread roles — lockwatch's merge target
    reads from here."""
    locks: Dict[str, LockDef] = dataclasses.field(default_factory=dict)
    edges: Dict[Tuple[str, str], str] = dataclasses.field(
        default_factory=dict)            # (a, b) -> "file:line (func)"
    functions: Dict[str, FuncInfo] = dataclasses.field(
        default_factory=dict)
    roles: Dict[str, str] = dataclasses.field(default_factory=dict)

    def lock_order_edges(self) -> Set[Tuple[str, str]]:
        return set(self.edges)


# ===================================================================== parse

def _dotted(expr) -> Optional[str]:
    if isinstance(expr, ast.Name):
        return expr.id
    if isinstance(expr, ast.Attribute):
        base = _dotted(expr.value)
        return f"{base}.{expr.attr}" if base else None
    if isinstance(expr, ast.Call):
        return _dotted(expr.func)
    return None


def _is_lockish_name(name: str) -> bool:
    last = name.rsplit(".", 1)[-1].lower()
    return "lock" in last or "mutex" in last


class _ModuleSource:
    """One parsed file: tree, lines, per-line annotations."""

    def __init__(self, path: str, modname: str):
        self.path = path
        self.modname = modname
        with open(path) as f:
            self.text = f.read()
        self.tree = ast.parse(self.text, filename=path)
        self.lines = self.text.splitlines()
        self.thread_ann: Dict[int, str] = {}
        self.lock_ann: Dict[int, str] = {}
        for i, line in enumerate(self.lines, 1):
            m = _ANN_THREAD.search(line)
            if m:
                self.thread_ann[i] = m.group(1)
            m = _ANN_LOCK.search(line)
            if m:
                self.lock_ann[i] = m.group(1)
        self.consumed_thread_ann: Set[int] = set()

    def rel(self) -> str:
        return os.path.relpath(self.path, os.getcwd()) \
            if self.path.startswith(os.getcwd()) else self.path

    def annotation_for_def(self, node) -> Optional[str]:
        """The dstpu-thread annotation attached to a def: on the def
        line, or on a comment line directly above the def/decorators."""
        first = min([node.lineno]
                    + [d.lineno for d in node.decorator_list])
        for ln in (node.lineno, first - 1, first - 2):
            if ln in self.thread_ann and ln not in self.consumed_thread_ann:
                # a line above only counts if it is a pure comment
                if ln != node.lineno:
                    stripped = self.lines[ln - 1].strip() \
                        if 0 < ln <= len(self.lines) else ""
                    if not stripped.startswith("#"):
                        continue
                self.consumed_thread_ann.add(ln)
                return self.thread_ann[ln]
        return None


def _parse_thread_annotation(text: str, where: str,
                             rep: R.Report) -> ThreadAnnotation:
    toks = text.replace(",", " ").split()
    ann = ThreadAnnotation(role=toks[0] if toks else "")
    for tok in toks[1:]:
        if tok == "enqueue-only":
            ann.enqueue_only = True
        elif tok == "init":
            ann.init = True
        elif tok.startswith("owner-check="):
            ann.owner_check = tok.split("=", 1)[1]
        elif tok.startswith("holds="):
            ann.holds = tuple(tok.split("=", 1)[1].split("+"))
        else:
            rep.add("concurrency.annotation", R.WARNING,
                    f"unknown dstpu-thread clause {tok!r} (known: "
                    f"enqueue-only, init, owner-check=<attr>, "
                    f"holds=<Lock>)", source=where,
                    pass_name="concurrency")
    return ann


def _lock_ctor(value) -> Optional[Tuple[Optional[str], bool]]:
    """``(explicit name, reentrant)`` if ``value`` constructs a lock:
    ``threading.Lock()``, ``threading.RLock()``, or
    ``lockwatch.named_lock("Name", rlock=...)`` (whose string argument
    is the canonical name)."""
    if not isinstance(value, ast.Call):
        return None
    name = _dotted(value.func) or ""
    last = name.rsplit(".", 1)[-1]
    if last == "Lock":
        return (None, False)
    if last == "RLock":
        return (None, True)
    if last == "named_lock":
        explicit = None
        if value.args and isinstance(value.args[0], ast.Constant) \
                and isinstance(value.args[0].value, str):
            explicit = value.args[0].value
        rl = any(kw.arg == "rlock" and isinstance(kw.value, ast.Constant)
                 and bool(kw.value.value) for kw in value.keywords)
        return (explicit, rl)
    return None


def _attr_type(value) -> Optional[str]:
    """queue/event/thread type of an attribute from its constructor."""
    if not isinstance(value, ast.Call):
        return None
    name = _dotted(value.func) or ""
    last = name.rsplit(".", 1)[-1]
    return {"Queue": "queue", "Event": "event",
            "Thread": "thread"}.get(last)


# ================================================================= extraction

class _Extractor:
    """Walks every module twice: pass 1 collects lock definitions,
    attribute types and class/method inventories; pass 2 walks each
    function body with an explicit held-lock stack."""

    def __init__(self, sources: List[_ModuleSource], rep: R.Report):
        self.sources = sources
        self.rep = rep
        self.model = ConcurrencyModel()
        # class -> {attr -> lock canonical name}
        self.class_locks: Dict[str, Dict[str, str]] = {}
        # class -> {attr -> "queue"|"event"|"thread"|class name}
        self.class_attr_types: Dict[str, Dict[str, str]] = {}
        # lock attr name -> [canonical names] (fallback resolution)
        self.lock_attr_index: Dict[str, List[str]] = {}
        # method name -> [qual] across all analyzed classes
        self.method_index: Dict[str, List[str]] = {}
        self.known_classes: Set[str] = set()
        # module -> {func name -> qual}
        self.module_funcs: Dict[str, Dict[str, str]] = {}

    # ------------------------------------------------------------- pass 1
    def collect(self) -> None:
        for src in self.sources:
            mod = src.modname
            self.module_funcs.setdefault(mod, {})
            for node in src.tree.body:
                if isinstance(node, ast.Assign):
                    self._module_assign(src, node)
                elif isinstance(node, (ast.FunctionDef,
                                       ast.AsyncFunctionDef)):
                    self.module_funcs[mod][node.name] = \
                        f"{mod}.{node.name}"
                elif isinstance(node, ast.ClassDef):
                    self._collect_class(src, node)
        for cls, locks in self.class_locks.items():
            for attr, canon in locks.items():
                self.lock_attr_index.setdefault(attr, []).append(canon)

    def _module_assign(self, src, node) -> None:
        ctor = _lock_ctor(node.value)
        if ctor is None:
            return
        explicit, reentrant = ctor
        for tgt in node.targets:
            if isinstance(tgt, ast.Name):
                canon = explicit or f"{src.modname}.{tgt.id}"
                self.model.locks[canon] = LockDef(
                    canon, src.rel(), node.lineno, reentrant)
                self.lock_attr_index.setdefault(tgt.id, []).append(canon)

    def _collect_class(self, src, cnode) -> None:
        cls = cnode.name
        self.known_classes.add(cls)
        locks = self.class_locks.setdefault(cls, {})
        types = self.class_attr_types.setdefault(cls, {})
        for meth in cnode.body:
            if not isinstance(meth, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)):
                continue
            self.method_index.setdefault(meth.name, []).append(
                f"{src.modname}.{cls}.{meth.name}")
            for sub in ast.walk(meth):
                if not isinstance(sub, ast.Assign):
                    continue
                for tgt in sub.targets:
                    if isinstance(tgt, ast.Attribute) \
                            and isinstance(tgt.value, ast.Name) \
                            and tgt.value.id == "self":
                        ctor = _lock_ctor(sub.value)
                        if ctor is not None:
                            explicit, reentrant = ctor
                            canon = explicit or f"{cls}.{tgt.attr}"
                            locks[tgt.attr] = canon
                            self.model.locks[canon] = LockDef(
                                canon, src.rel(), sub.lineno, reentrant)
                            continue
                        t = _attr_type(sub.value)
                        if t is not None:
                            types[tgt.attr] = t
                        elif isinstance(sub.value, ast.Call):
                            nm = _dotted(sub.value.func) or ""
                            last = nm.rsplit(".", 1)[-1]
                            if last in self.known_classes \
                                    or last[:1].isupper():
                                types.setdefault(tgt.attr, last)

    # ------------------------------------------------------------- pass 2
    def analyze(self) -> None:
        # known_classes must be complete before method-call resolution,
        # so class collection ran fully in collect(); a second sweep
        # catches classes referenced before their definition
        for src in self.sources:
            for node in src.tree.body:
                if isinstance(node, ast.ClassDef):
                    for meth in node.body:
                        if isinstance(meth, (ast.FunctionDef,
                                             ast.AsyncFunctionDef)):
                            self._analyze_function(src, meth, node.name)
                elif isinstance(node, (ast.FunctionDef,
                                       ast.AsyncFunctionDef)):
                    self._analyze_function(src, node, None)
        # dangling annotations: a dstpu-thread comment nobody consumed
        # is a contract the pass is NOT checking — say so
        for src in self.sources:
            for ln in sorted(set(src.thread_ann)
                             - src.consumed_thread_ann):
                self.rep.add(
                    "concurrency.annotation", R.WARNING,
                    f"dstpu-thread annotation not attached to any "
                    f"function def — the declared contract is not being "
                    f"checked", source=f"{src.rel()}:{ln}",
                    pass_name="concurrency")

    # ------------------------------------------------------- lock resolve
    def _resolve_lock(self, src, cls, expr, line) -> Optional[str]:
        """Canonical lock name of a with/acquire target, or None."""
        ann = src.lock_ann.get(line)
        if ann and not ann.startswith("allow-"):
            return ann.strip()
        name = _dotted(expr)
        if name is None:
            return None
        if name.startswith("self."):
            attr = name.split(".", 1)[1]
            if "." not in attr and cls is not None:
                canon = self.class_locks.get(cls, {}).get(attr)
                if canon:
                    return canon
        parts = name.rsplit(".", 1)
        attr = parts[-1]
        if len(parts) == 1:
            # module-level lock of this module
            canon = f"{src.modname}.{attr}"
            if canon in self.model.locks:
                return canon
        cands = self.lock_attr_index.get(attr, [])
        if len(set(cands)) == 1:
            return cands[0]
        if _is_lockish_name(name):
            self.rep.add(
                "concurrency.unresolved-lock", R.WARNING,
                f"cannot resolve which lock {name!r} is "
                f"({len(set(cands))} candidates) — annotate the line "
                f"with `# dstpu-lock: <Class._attr>` so the order graph "
                f"stays sound", source=f"{src.rel()}:{line}",
                pass_name="concurrency")
        return None

    def _lock_reentrant(self, canon: str) -> bool:
        d = self.model.locks.get(canon)
        return d.reentrant if d is not None else False

    # ------------------------------------------------------ call resolve
    def _resolve_call(self, src, cls, node) -> Optional[str]:
        name = _dotted(node.func)
        if name is None:
            return None
        parts = name.split(".")
        meth = parts[-1]
        if parts[0] == "self" and len(parts) == 2 and cls is not None:
            quals = [q for q in self.method_index.get(meth, ())
                     if q.split(".")[-2] == cls]
            if len(quals) == 1:
                return quals[0]
        if parts[0] == "self" and len(parts) == 3 and cls is not None:
            # self.attr.meth(): type the attr if we can
            t = self.class_attr_types.get(cls, {}).get(parts[1])
            if t in self.known_classes:
                quals = [q for q in self.method_index.get(meth, ())
                         if q.split(".")[-2] == t]
                if len(quals) == 1:
                    return quals[0]
        if len(parts) == 1:
            qual = self.module_funcs.get(src.modname, {}).get(meth)
            if qual:
                return qual
        # last resort: a method name unique across the analyzed classes
        # (and not a generic stdlib name)
        if meth not in _COMMON_METHODS:
            quals = self.method_index.get(meth, ())
            if len(quals) == 1:
                return quals[0]
        return None

    # -------------------------------------------------- blocking catalog
    def _blocking_reason(self, src, cls, node) -> Optional[Tuple[str, str]]:
        name = _dotted(node.func)
        if name is None:
            return None
        for cat, why in BLOCKING_CALLS.items():
            if name == cat or name.endswith("." + cat):
                return (name, why)
        parts = name.split(".")
        meth = parts[-1]
        if len(parts) >= 2:
            recv_attr = parts[-2]
            # typed receiver: self.X.get() with X a Queue, etc.
            if parts[0] == "self" and len(parts) == 3 and cls is not None:
                t = self.class_attr_types.get(cls, {}).get(parts[1])
                why = _TYPED_BLOCKING.get(t or "", {}).get(meth)
                if why is not None:
                    if meth == "get" and _kw_false(node, "block"):
                        return None
                    return (name, why)
            # name-based fallback: *.thread.join(), *queue.get(),
            # *.stop.wait() are unambiguous enough to flag
            if meth == "join" and recv_attr.endswith("thread"):
                return (name, _TYPED_BLOCKING["thread"]["join"])
            if meth == "get" and ("queue" in recv_attr
                                  or recv_attr == "inbox") \
                    and not _kw_false(node, "block"):
                return (name, _TYPED_BLOCKING["queue"]["get"])
            # device dispatch under a control-plane lock: any engine/
            # scheduler dispatch entry point stalls every waiter for a
            # full device program
            if recv_attr in ("engine", "eng") and meth in (
                    "prefill", "decode", "decode_many", "extend",
                    "spec_step", "admit", "export_kv", "import_kv"):
                return (name, "dispatches a device program")
            if recv_attr == "sched" and meth == "step":
                return (name, "dispatches a device program")
        return None

    # --------------------------------------------------------- the walker
    def _analyze_function(self, src, fnode, cls: Optional[str]) -> None:
        qual = (f"{src.modname}.{cls}.{fnode.name}" if cls
                else f"{src.modname}.{fnode.name}")
        info = FuncInfo(qual=qual, cls=cls, file=src.rel(),
                        line=fnode.lineno)
        ann_text = src.annotation_for_def(fnode)
        if ann_text:
            info.annotation = _parse_thread_annotation(
                ann_text, f"{src.rel()}:{fnode.lineno}", self.rep)
            self.model.roles[qual] = info.annotation.role
        held: List[str] = list(info.annotation.holds) \
            if info.annotation else []

        def loc(line) -> str:
            return f"{src.rel()}:{line} ({qual.split('.', 1)[1]})"

        def note_acquire(canon: str, line: int) -> None:
            if canon in held and not self._lock_reentrant(canon):
                self.rep.add(
                    "concurrency.lock-order", R.ERROR,
                    f"re-acquiring non-reentrant lock {canon} already "
                    f"held on this path — self-deadlock",
                    path=canon, source=loc(line),
                    pass_name="concurrency")
            for h in held:
                if h != canon:
                    info.edges.append((h, canon, line))
            info.acquires.append((canon, line))

        def visit(node, held_now: List[str]) -> None:
            if isinstance(node, ast.With):
                extra = []
                for item in node.items:
                    canon = self._resolve_lock(
                        src, cls, item.context_expr, node.lineno)
                    if canon is not None:
                        held.extend([])  # no-op; clarity
                        for h in held_now + extra:
                            if h != canon:
                                info.edges.append(
                                    (h, canon, node.lineno))
                        if canon in held_now + extra \
                                and not self._lock_reentrant(canon):
                            self.rep.add(
                                "concurrency.lock-order", R.ERROR,
                                f"re-acquiring non-reentrant lock "
                                f"{canon} already held on this path — "
                                f"self-deadlock", path=canon,
                                source=loc(node.lineno),
                                pass_name="concurrency")
                        info.acquires.append((canon, node.lineno))
                        extra.append(canon)
                    else:
                        visit(item.context_expr, held_now)
                inner = held_now + extra
                for child in node.body:
                    visit(child, inner)
                return
            if isinstance(node, ast.Call):
                name = _dotted(node.func) or ""
                if name.endswith(".acquire"):
                    canon = self._resolve_lock(
                        src, cls, node.func.value, node.lineno)
                    if canon is not None:
                        note_acquire(canon, node.lineno)
                blk = self._blocking_reason(src, cls, node)
                if blk is not None:
                    cname, why = blk
                    info.blocking.append((cname, why, node.lineno))
                    if held_now:
                        info.blocking_under.append(
                            (cname, why, node.lineno, tuple(held_now)))
                callee = self._resolve_call(src, cls, node)
                if callee is not None:
                    info.calls.append(
                        (callee, node.lineno, tuple(held_now)))
                for child in ast.iter_child_nodes(node):
                    visit(child, held_now)
                return
            if isinstance(node, (ast.Assign, ast.AugAssign)):
                targets = (node.targets
                           if isinstance(node, ast.Assign)
                           else [node.target])
                for tgt in targets:
                    attr = _self_attr_of_target(tgt)
                    if attr is not None:
                        info.writes.setdefault(attr, []).append(
                            (node.lineno, tuple(held_now)))
                visit(node.value, held_now)
                return
            if isinstance(node, ast.Compare):
                for side in [node.left] + list(node.comparators):
                    if isinstance(side, ast.Attribute):
                        info.has_owner_compare[side.attr] = True
                for child in ast.iter_child_nodes(node):
                    visit(child, held_now)
                return
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)):
                # nested defs/lambdas run where they are CALLED; the
                # common pattern here is an inline helper invoked under
                # the same locks, so analyze under the current stack
                body = node.body if isinstance(node.body, list) \
                    else [node.body]
                for child in body:
                    visit(child, held_now)
                return
            for child in ast.iter_child_nodes(node):
                visit(child, held_now)

        for stmt in fnode.body:
            visit(stmt, held)
        self.model.functions[qual] = info


def _kw_false(node: ast.Call, kwname: str) -> bool:
    for kw in node.keywords:
        if kw.arg == kwname and isinstance(kw.value, ast.Constant) \
                and kw.value.value is False:
            return True
    return False


def _self_attr_of_target(tgt) -> Optional[str]:
    """``self.X = ...`` / ``self.X[i] = ...`` / ``self.X += ...`` →
    ``X``."""
    if isinstance(tgt, ast.Subscript):
        tgt = tgt.value
    if isinstance(tgt, ast.Attribute) and isinstance(tgt.value, ast.Name) \
            and tgt.value.id == "self":
        return tgt.attr
    if isinstance(tgt, ast.Tuple):
        for el in tgt.elts:
            a = _self_attr_of_target(el)
            if a is not None:
                return a
    return None


# ================================================================== analysis

def _propagate(model: ConcurrencyModel):
    """Transitive (acquires, blocking) summaries per function, memoized
    and cycle-safe — so a call made under a lock inherits everything its
    callee does."""
    acq_memo: Dict[str, Set[str]] = {}
    blk_memo: Dict[str, List[Tuple[str, str, str]]] = {}

    def acquires(qual: str, seen: Set[str]) -> Set[str]:
        if qual in acq_memo:
            return acq_memo[qual]
        if qual in seen:
            return set()
        seen = seen | {qual}
        info = model.functions.get(qual)
        if info is None:
            return set()
        out = {lock for lock, _ in info.acquires}
        for callee, _, _ in info.calls:
            out |= acquires(callee, seen)
        acq_memo[qual] = out
        return out

    def blocking(qual: str, seen: Set[str]) \
            -> List[Tuple[str, str, str]]:
        """[(call name, why, "file:line")] anywhere under ``qual``."""
        if qual in blk_memo:
            return blk_memo[qual]
        if qual in seen:
            return []
        seen = seen | {qual}
        info = model.functions.get(qual)
        if info is None:
            return []
        out = [(n, w, f"{info.file}:{ln}")
               for n, w, ln in info.blocking]
        for callee, _, _ in info.calls:
            for n, w, site in blocking(callee, seen):
                out.append((n, w, site))
        blk_memo[qual] = out[:8]      # summaries, not transcripts
        return blk_memo[qual]

    return acquires, blocking


def _find_cycles(edges: Dict[Tuple[str, str], str]) \
        -> List[List[str]]:
    graph: Dict[str, Set[str]] = {}
    for a, b in edges:
        graph.setdefault(a, set()).add(b)
        graph.setdefault(b, set())
    cycles, state = [], {}

    def dfs(n, path):
        state[n] = 1
        path.append(n)
        for m in sorted(graph.get(n, ())):
            if state.get(m, 0) == 1:
                cycles.append(path[path.index(m):] + [m])
            elif state.get(m, 0) == 0:
                dfs(m, path)
        path.pop()
        state[n] = 2

    for n in sorted(graph):
        if state.get(n, 0) == 0:
            dfs(n, [])
    # dedupe rotations
    seen, out = set(), []
    for cyc in cycles:
        key = frozenset(cyc)
        if key not in seen:
            seen.add(key)
            out.append(cyc)
    return out


def analyze_paths(paths: Sequence[str]) \
        -> Tuple[ConcurrencyModel, R.Report]:
    """Run the full pass over ``paths``; returns the model (lock set,
    order graph, roles) and the findings report."""
    rep = R.Report(subject="concurrency")
    sources = []
    for p in paths:
        modname = os.path.basename(p)[:-3] \
            if p.endswith(".py") else os.path.basename(p)
        if modname == "__init__":
            modname = os.path.basename(os.path.dirname(p))
        try:
            sources.append(_ModuleSource(p, modname))
        except (OSError, SyntaxError) as e:
            rep.add("concurrency.parse", R.ERROR,
                    f"cannot analyze {p}: {e}", source=p,
                    pass_name="concurrency")
    ex = _Extractor(sources, rep)
    ex.collect()
    ex.analyze()
    model = ex.model
    acquires, blocking = _propagate(model)

    src_by_rel = {s.rel(): s for s in sources}

    def allowed(file: str, line: int) -> bool:
        s = src_by_rel.get(file)
        ann = s.lock_ann.get(line) if s is not None else None
        return bool(ann and ann.startswith("allow-blocking"))

    # ---- blocking under lock (direct + through resolved calls)
    for qual, info in model.functions.items():
        for cname, why, line, locks in info.blocking_under:
            sev = R.INFO if allowed(info.file, line) else R.ERROR
            code = ("concurrency.allowed-blocking" if sev == R.INFO
                    else "concurrency.blocking-under-lock")
            rep.add(code, sev,
                    f"{cname}() {why} while holding "
                    f"{' + '.join(locks)} — every thread waiting on "
                    f"the lock stalls behind it",
                    path=" + ".join(locks),
                    source=f"{info.file}:{line} "
                           f"({qual.split('.', 1)[1]})",
                    pass_name="concurrency")
        for callee, line, locks in info.calls:
            if not locks:
                continue
            for cname, why, site in blocking(callee, set()):
                if allowed(info.file, line) or allowed(
                        *_split_site(site)):
                    continue
                rep.add(
                    "concurrency.blocking-under-lock", R.ERROR,
                    f"call to {callee.split('.', 1)[1]}() while "
                    f"holding {' + '.join(locks)} — it {why} via "
                    f"{cname}() at {site}",
                    path=" + ".join(locks),
                    source=f"{info.file}:{line} "
                           f"({qual.split('.', 1)[1]})",
                    pass_name="concurrency")

    # ---- order edges (direct + through resolved calls) + cycles
    for qual, info in model.functions.items():
        site = f"{info.file} ({qual.split('.', 1)[1]})"
        for a, b, line in info.edges:
            model.edges.setdefault((a, b), f"{info.file}:{line} "
                                           f"({qual.split('.', 1)[1]})")
        for callee, line, locks in info.calls:
            for acquired in acquires(callee, set()):
                for h in locks:
                    if h != acquired:
                        model.edges.setdefault(
                            (h, acquired),
                            f"{info.file}:{line} "
                            f"({qual.split('.', 1)[1]} -> "
                            f"{callee.split('.', 1)[1]})")
                    elif not model.locks.get(acquired, LockDef(
                            acquired, "", 0)).reentrant:
                        rep.add(
                            "concurrency.lock-order", R.ERROR,
                            f"call to {callee.split('.', 1)[1]}() "
                            f"re-acquires non-reentrant {acquired} "
                            f"already held — self-deadlock",
                            path=acquired,
                            source=f"{info.file}:{line} "
                                   f"({qual.split('.', 1)[1]})",
                            pass_name="concurrency")
    for cyc in _find_cycles(model.edges):
        sites = []
        for a, b in zip(cyc, cyc[1:]):
            sites.append(f"{a} -> {b} at "
                         f"{model.edges.get((a, b), '?')}")
        rep.add("concurrency.lock-order", R.ERROR,
                f"lock-order cycle {' -> '.join(cyc)} — two threads "
                f"taking the ends in opposite order deadlock:\n          "
                + "\n          ".join(sites),
                path=" -> ".join(cyc), pass_name="concurrency")

    # ---- contracts: holds= callers, enqueue-only, owner-check
    for qual, info in model.functions.items():
        for callee, line, locks in info.calls:
            cinfo = model.functions.get(callee)
            if cinfo is None or cinfo.annotation is None:
                continue
            for need in cinfo.annotation.holds:
                if need not in locks:
                    rep.add(
                        "concurrency.lock-contract", R.ERROR,
                        f"{callee.split('.', 1)[1]}() declares "
                        f"holds={need} but this call site does not "
                        f"hold it (held: "
                        f"{' + '.join(locks) or 'nothing'})",
                        path=need,
                        source=f"{info.file}:{line} "
                               f"({qual.split('.', 1)[1]})",
                        pass_name="concurrency")
        ann = info.annotation
        if ann is None:
            continue
        where = f"{info.file}:{info.line} ({qual.split('.', 1)[1]})"
        if ann.enqueue_only:
            for cname, why, line in info.blocking:
                rep.add("concurrency.thread-role", R.ERROR,
                        f"declared enqueue-only ({ann.role}) but "
                        f"{cname}() {why}",
                        source=f"{info.file}:{line} "
                               f"({qual.split('.', 1)[1]})",
                        pass_name="concurrency")
            for lock, line in info.acquires:
                rep.add("concurrency.thread-role", R.ERROR,
                        f"declared enqueue-only ({ann.role}) but "
                        f"acquires {lock} — a callback thread stuck "
                        f"on a lock stalls the runtime",
                        path=lock,
                        source=f"{info.file}:{line} "
                               f"({qual.split('.', 1)[1]})",
                        pass_name="concurrency")
            for callee, line, _ in info.calls:
                deep = blocking(callee, set())
                if deep:
                    cname, why, site = deep[0]
                    rep.add("concurrency.thread-role", R.ERROR,
                            f"declared enqueue-only ({ann.role}) but "
                            f"calls {callee.split('.', 1)[1]}() which "
                            f"{why} via {cname}() at {site}",
                            source=f"{info.file}:{line} "
                                   f"({qual.split('.', 1)[1]})",
                            pass_name="concurrency")
        if ann.owner_check and not info.has_owner_compare.get(
                ann.owner_check):
            rep.add("concurrency.thread-role", R.ERROR,
                    f"declared owner-check={ann.owner_check} but never "
                    f"compares .{ann.owner_check} — a completion from "
                    f"an evicted owner would be accepted",
                    source=where, pass_name="concurrency")

    # ---- guarded-attribute writes
    _check_guarded_writes(model, rep)
    return model, rep


def _split_site(site: str) -> Tuple[str, int]:
    file, _, line = site.rpartition(":")
    try:
        return file, int(line)
    except ValueError:
        return site, 0


def _check_guarded_writes(model: ConcurrencyModel,
                          rep: R.Report) -> None:
    # class -> lock canonical names owned by it
    class_locks: Dict[str, Set[str]] = {}
    for canon in model.locks:
        cls = canon.split(".", 1)[0]
        class_locks.setdefault(cls, set()).add(canon)
    # guarded attrs per class: written at least once under a class lock
    guarded: Dict[str, Set[str]] = {}
    for qual, info in model.functions.items():
        if info.cls is None:
            continue
        own = class_locks.get(info.cls, set())
        if not own:
            continue
        for attr, writes in info.writes.items():
            for _, locks in writes:
                if own & set(locks):
                    guarded.setdefault(info.cls, set()).add(attr)
    lock_attrs = {canon.split(".", 1)[1] for canon in model.locks
                  if "." in canon}
    for qual, info in model.functions.items():
        if info.cls is None or info.cls not in guarded:
            continue
        meth = qual.rsplit(".", 1)[-1]
        if meth == "__init__":
            continue
        if info.annotation is not None and info.annotation.init:
            continue
        own = class_locks.get(info.cls, set())
        for attr, writes in info.writes.items():
            if attr not in guarded[info.cls] or attr in lock_attrs:
                continue
            for line, locks in writes:
                if own & set(locks):
                    continue
                rep.add(
                    "concurrency.unlocked-guarded-write", R.ERROR,
                    f"self.{attr} is written under "
                    f"{'/'.join(sorted(own))} elsewhere in "
                    f"{info.cls} but written here with no lock held — "
                    f"a cross-thread unlocked mutation",
                    path=f"{info.cls}.{attr}",
                    source=f"{info.file}:{line} "
                           f"({qual.split('.', 1)[1]})",
                    pass_name="concurrency")


# ================================================================ entrypoints

def control_plane_paths() -> List[str]:
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return [os.path.join(root, p) for p in CONTROL_PLANE]


def check_paths(paths: Optional[Sequence[str]] = None,
                suppress: Sequence[str] = ()) -> R.Report:
    """The pass over ``paths`` (default: the shipped control plane),
    suppression applied."""
    _, rep = analyze_paths(paths or control_plane_paths())
    return rep.filtered(suppress)


_gate_memo: Dict[tuple, bool] = {}


def check_control_plane(mode: str = "warn",
                        suppress: Sequence[str] = (),
                        where: str = "control plane") -> None:
    """The build-time gate (FleetRouter rides it via config
    ``analysis.concurrency``): run once per process per (mode,
    suppress) — the source files do not change under a running process,
    so re-linting per router build would be pure overhead."""
    if mode == "off":
        return
    key = (mode, tuple(suppress))
    if key in _gate_memo:
        return
    from deepspeed_tpu_torch import analysis
    rep = check_paths(suppress=suppress)
    analysis.dispatch_report(
        rep, mode, where=where, label="concurrency lint",
        info_hint="analysis.concurrency.check_paths().format() shows "
                  "them", error_cls=ConcurrencyLintError)
    _gate_memo[key] = True


def merge_observed(model: ConcurrencyModel,
                   observed: Set[Tuple[str, str]]) -> R.Report:
    """Merge lockwatch's observed order edges into the static graph and
    re-run the cycle check: an inversion the AST could not see (an
    unresolved foreign lock, an order through unanalyzed code) still
    fails once it actually happens.  Clean runtime edges are also the
    consistency proof the tests assert: observed ⊆ acyclic(static ∪
    observed)."""
    rep = R.Report(subject="concurrency+observed")
    edges = dict(model.edges)
    for a, b in observed:
        edges.setdefault((a, b), "observed at runtime (lockwatch)")
    for cyc in _find_cycles(edges):
        sites = [f"{a} -> {b} at {edges.get((a, b), '?')}"
                 for a, b in zip(cyc, cyc[1:])]
        rep.add("concurrency.lock-order", R.ERROR,
                f"lock-order cycle {' -> '.join(cyc)} (static + "
                f"observed edges) — two threads taking the ends in "
                f"opposite order deadlock:\n          "
                + "\n          ".join(sites),
                path=" -> ".join(cyc), pass_name="lockwatch-merge")
    return rep
