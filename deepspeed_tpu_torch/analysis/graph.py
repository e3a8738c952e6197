"""The dispatch-level trace the lint passes and the planners walk.

The JAX package walks ``jax.make_jaxpr(fn)(*args)``.  The port has no
traced program: training runs eagerly, serving eagerly or as CUDA graphs,
and collectives are eager ``torch.distributed`` calls.  Its counterpart of
a jaxpr is the ordered list of operators one run of the program
dispatches, recorded by a ``TorchDispatchMode`` (:class:`Recorder`),
by default inside a ``FakeTensorMode`` so that nothing is allocated or
computed and no collective reaches the wire:

* every op carries its name, its input and output shapes, dtypes, devices
  and storages, and its source, the innermost ``deepspeed_tpu_torch``
  frame outside ``analysis/`` ("file:line (function)", the counterpart of
  ``source_of``);
* a collective (``c10d.*``) also carries its process group's ranks and,
  for a reduction, its reduce op (``dist.all_reduce`` is wrapped for the
  trace: the op reaches the dispatcher as an opaque object);
* a host read of a device scalar (``aten._local_scalar_dense``, which a
  fake tensor cannot answer) is recorded as op ``host.read`` and answered
  with 0; a read inside ``observability.fences`` is marked a fence;
* a hand-written kernel is one op, its wrapper's operator
  ``dstpu.<kernel>`` (``ops/_build.kernel_op``), of kind ``kernel``: on
  fake tensors its fake allocates the outputs and nothing else;
* a call of a graphable serving program (``InferenceEngine._program``)
  goes through :class:`TracedGraphs`, which stands in for the engine's
  CUDA graphs: it runs the program and records its key, its argument
  types and the bytes a capture would hold as static inputs and outputs;
* every storage allocates when an op first returns it and frees when its
  last tensor dies (a weakref finalizer: eager PyTorch frees by refcount),
  rounded to the caching allocator's 512-byte blocks.  The storages alive
  when the trace starts (the engine's state) are its arguments.

Autograd runs the backward of the traced program's loss inside the same
modes, so the backward's ops are in the trace; on the card autograd runs
it on a device thread, which the dispatch-mode state follows.
"""

from __future__ import annotations

import collections
import contextlib
import copy
import dataclasses
import os
import sys
import threading
import weakref
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import torch
import torch.utils.weak
from torch.utils._python_dispatch import TorchDispatchMode

#: the caching allocator's block size: every allocation rounds up to it
BLOCK = 512

#: host-memory ops a fake tensor cannot run (``FakeTensorMode`` has no
#: implementation): answered by the recorder
_HOST_MEMORY_OPS = (torch.ops.aten._pin_memory.default,
                    torch.ops.aten.is_pinned.default)

_PKG = os.sep + "deepspeed_tpu_torch" + os.sep
_SKIP = (os.sep + "analysis" + os.sep,)

_local = threading.local()


def round_block(n: int) -> int:
    return -(-int(n) // BLOCK) * BLOCK


def is_fake(t) -> bool:
    from torch._subclasses.fake_tensor import FakeTensor
    return isinstance(t, FakeTensor)


@dataclasses.dataclass(frozen=True)
class TensorInfo:
    """What the passes need of one tensor an op read or returned."""

    shape: Tuple[int, ...]
    dtype: torch.dtype
    device: str
    storage: int            # storage identity (aliasing and lifetime)
    nbytes: int             # the storage's bytes
    tid: int                # tensor identity within the trace

    @property
    def numel(self) -> int:
        n = 1
        for d in self.shape:
            n *= int(d)
        return n

    @property
    def bytes(self) -> int:
        return self.numel * _itemsize(self.dtype)


def _itemsize(dtype) -> int:
    try:
        return torch.empty((), dtype=dtype, device="meta").element_size()
    except Exception:  # noqa: BLE001 - odd dtypes count a byte
        return 1


@dataclasses.dataclass
class Op:
    """One dispatched operator."""

    index: int
    name: str                       # "aten.mm.default", "c10d.allreduce_..."
    kind: str                       # aten | collective | read | kernel
    inputs: Tuple[TensorInfo, ...]
    outputs: Tuple[TensorInfo, ...]
    source: str = ""
    group: Optional[Tuple[int, ...]] = None
    reduce_op: Optional[str] = None
    peer: Optional[int] = None      # send / recv
    fence: bool = False             # a deliberate read (fences.py)
    staged: bool = False            # inside parallel/comm.py

    @property
    def short(self) -> str:
        parts = self.name.split(".")
        return parts[1] if len(parts) > 2 else self.name


@dataclasses.dataclass
class Trace:
    """An ordered op list and the peak of its storages' live bytes."""

    subject: str
    ops: List[Op]
    argument_bytes: int             # storages alive at the start
    #: the most bytes of new storages alive at once
    peak_bytes: int = 0
    #: storages (id -> bytes, producing op) alive at the peak
    peak_storages: Dict[int, Tuple[int, int]] = dataclasses.field(
        default_factory=dict)
    device: str = "cpu"
    #: the CUDA graphs a graphable program (``InferenceEngine._program``)
    #: would capture: one :class:`Program` per call
    programs: List["Program"] = dataclasses.field(default_factory=list)

    def collectives(self) -> List[Op]:
        return [o for o in self.ops if o.kind == "collective"]

    def launches(self) -> int:
        """Device launches of an eager run: every aten op with a tensor
        output on a non-CPU device plus every kernel region (views and
        metadata ops included: an upper bound)."""
        return sum(1 for o in self.ops
                   if o.kind == "kernel" or (o.kind == "aten" and o.outputs))

    @property
    def total_peak(self) -> int:
        return self.argument_bytes + self.peak_bytes


_COMM = os.sep + os.path.join("parallel", "comm.py")


def _source() -> Tuple[str, bool]:
    """``(source, staged)``: the innermost port frame outside
    ``analysis/`` and ``parallel/comm.py`` (the collectives' plumbing: a
    collective is located at its caller), and whether the op ran inside
    ``parallel/comm.py`` (a collective's host staging)."""
    f = sys._getframe(2)
    staged = None
    while f is not None:
        fn = f.f_code.co_filename
        if _PKG in fn and not any(s in fn for s in _SKIP):
            if fn.endswith(_COMM):
                staged = True if staged is None else staged
            else:
                rel = fn[fn.rfind(_PKG) + 1:]
                return (f"{rel}:{f.f_lineno} ({f.f_code.co_name})",
                        bool(staged))
        f = f.f_back
    return "", bool(staged)


class _Storages:
    """Live storages of a trace: id -> (bytes, producing op, live tensors)."""

    def __init__(self):
        self.lock = threading.Lock()
        self.live: Dict[int, List[int]] = {}    # sid -> [bytes, op, refs]
        self.cur = 0
        self.tids = torch.utils.weak.WeakIdKeyDictionary()
        self.next_tid = 0

    def tid(self, t) -> int:
        with self.lock:
            got = self.tids.get(t)
            if got is None:
                got = self.next_tid
                self.next_tid += 1
                self.tids[t] = got
            return got

    def track(self, t, sid: int, nbytes: int, op_index: int) -> None:
        """Register ``t``, a tensor of storage ``sid``."""
        with self.lock:
            ent = self.live.get(sid)
            if ent is None:
                b = round_block(nbytes) if nbytes else 0
                ent = self.live[sid] = [b, op_index, 0]
                self.cur += b
            ent[2] += 1
        weakref.finalize(t, self._drop, sid)

    def _drop(self, sid: int) -> None:
        with self.lock:
            ent = self.live.get(sid)
            if ent is None:
                return
            ent[2] -= 1
            if ent[2] <= 0:
                self.cur -= ent[0]
                del self.live[sid]


class Recorder(TorchDispatchMode):
    """Records every dispatched op of the region it is entered around."""

    def __init__(self, subject: str = "", fake: bool = True):
        super().__init__()
        self.subject = subject
        self.fake = fake
        self.ops: List[Op] = []
        self.store = _Storages()
        self.peak = 0
        self.peak_storages: Dict[int, Tuple[int, int]] = {}
        self._lock = threading.Lock()
        self.argument_bytes = 0
        self.device = "cpu"
        self._seen_args: set = set()
        self.programs: List[Program] = []

    # --------------------------------------------------------- arguments
    def note_arguments(self, tensors) -> None:
        """The storages alive at the start (the program's state)."""
        total = 0
        for t in tensors:
            if not isinstance(t, torch.Tensor):
                continue
            try:
                st = t.untyped_storage()
                sid = st._cdata
                nb = st.nbytes()
            except Exception:  # noqa: BLE001 - sparse or odd layouts
                continue
            if sid in self._seen_args:
                continue
            self._seen_args.add(sid)
            total += round_block(nb)
            if t.device.type != "cpu":
                self.device = t.device.type
        self.argument_bytes += total

    # ------------------------------------------------------------- infos
    def _info(self, t, op_index: int, output: bool) -> TensorInfo:
        """``t``'s info; an output's new storage starts to count."""
        try:
            st = t.untyped_storage()
            sid, nb = st._cdata, st.nbytes()
        except Exception:  # noqa: BLE001
            sid, nb = 0, 0
        if output and sid and sid not in self._seen_args:
            self.store.track(t, sid, nb, op_index)
        info = TensorInfo(shape=tuple(int(d) for d in t.shape),
                          dtype=t.dtype, device=t.device.type, storage=sid,
                          nbytes=nb, tid=self.store.tid(t))
        if t.device.type != "cpu":
            self.device = t.device.type
        return info

    def _tensors(self, obj):
        if isinstance(obj, torch.Tensor):
            yield obj
        elif isinstance(obj, (list, tuple)):
            for x in obj:
                yield from self._tensors(x)
        elif isinstance(obj, dict):
            for x in obj.values():
                yield from self._tensors(x)

    def _record(self, name, kind, args, kwargs, out, **extra) -> Op:
        with self._lock:
            index = len(self.ops)
        ins = tuple(self._info(t, index, False)
                    for t in self._tensors((args, kwargs)))
        outs = tuple(self._info(t, index, True)
                     for t in self._tensors(out))
        source, staged = _source()
        op = Op(index=index, name=name, kind=kind, inputs=ins, outputs=outs,
                source=source, staged=staged, **extra)
        with self._lock:
            op.index = len(self.ops)
            self.ops.append(op)
            cur = self.store.cur
            if cur > self.peak:
                self.peak = cur
                self.peak_storages = {s: (e[0], e[1]) for s, e in
                                      self.store.live.items()}
        return op

    # ---------------------------------------------------------- dispatch
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = str(func)
        if func is torch.ops.aten._local_scalar_dense.default:
            t = args[0]
            if is_fake(t) or self.fake:
                val = (False if t.dtype == torch.bool else
                       0 if not t.dtype.is_floating_point else 0.0)
            else:
                val = func(*args, **kwargs)
            from deepspeed_tpu_torch.observability import fences
            self._record("host.read", "read", args, kwargs, None,
                         fence=fences.in_fence())
            return val
        if self.fake and func in _HOST_MEMORY_OPS:
            # a fake host tensor has no memory to pin: the staging it
            # prepares is the host -> device copy that follows
            return (args[0] if func is not torch.ops.aten.is_pinned.default
                    else False)
        out = func(*args, **kwargs)
        if name.startswith("prim."):
            return out                  # metadata queries, not ops
        if name.startswith("dstpu."):
            self._record(name, "kernel", args, kwargs, out)
            return out
        if name.startswith("c10d."):
            self._record(name, "collective", args, kwargs, out,
                         **_collective_meta(func, args))
            return out
        from deepspeed_tpu_torch.observability import fences
        self._record(name, "aten", args, kwargs, out, fence=fences.in_fence())
        return out

    # ------------------------------------------------------------ result
    def trace(self) -> Trace:
        return Trace(subject=self.subject, ops=list(self.ops),
                     argument_bytes=self.argument_bytes,
                     peak_bytes=self.peak,
                     peak_storages=dict(self.peak_storages),
                     device=self.device, programs=list(self.programs))


def _group_ranks(obj) -> Optional[Tuple[int, ...]]:
    import torch.distributed as dist
    try:
        pg = dist.ProcessGroup.unbox(obj)
        return tuple(int(r) for r in dist.get_process_group_ranks(pg))
    except Exception:  # noqa: BLE001 - not a group
        return None


def _collective_meta(func, args) -> dict:
    meta = {"group": None, "reduce_op": None, "peer": None}
    for a in args:
        if isinstance(a, torch.ScriptObject):
            ranks = _group_ranks(a)
            if ranks is not None and meta["group"] is None:
                meta["group"] = ranks
    name = str(func)
    if "allreduce" in name or "reduce_scatter" in name:
        meta["reduce_op"] = getattr(_local, "reduce_op", None) or "sum"
        _local.reduce_op = None
    if ".send" in name or ".recv" in name:
        ints = [a for a in args if isinstance(a, int)
                and not isinstance(a, bool)]
        if ints:
            meta["peer"] = int(ints[0])       # the group rank of the peer
    return meta


@contextlib.contextmanager
def _reduce_op_hints():
    """``dist.all_reduce`` / ``reduce_scatter`` wrapped so that the trace
    learns the reduce op (it reaches the dispatcher as an opaque object)."""
    import torch.distributed as dist
    saved = {}

    def wrap(name):
        fn = getattr(dist, name, None)
        if fn is None:
            return

        def wrapped(*a, op=dist.ReduceOp.SUM, **kw):
            _local.reduce_op = str(op).split(".")[-1].lower()
            return fn(*a, op=op, **kw)
        saved[name] = fn
        setattr(dist, name, wrapped)

    for name in ("all_reduce", "reduce_scatter_tensor",
                 "reduce_scatter_single"):
        wrap(name)
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(dist, name, fn)


#: the recorder of the trace in progress: process-wide, since autograd
#: runs a CUDA backward on its own device thread
_ACTIVE: List[Recorder] = []


def active() -> Optional[Recorder]:
    return _ACTIVE[-1] if _ACTIVE else None


#: a CUDA graph of a serving program, as a capture would hold it: its key,
#: its argument types and the bytes of its static inputs and outputs
Program = collections.namedtuple("Program", "key types static_bytes")


def static_bytes(tensors) -> int:
    """Bytes a CUDA graph holds for ``tensors`` (a clone of each input, or
    an output the capture keeps), in allocator blocks."""
    return sum(round_block(t.numel() * t.element_size())
               for t in tensors if isinstance(t, torch.Tensor))


class TracedGraphs(dict):
    """Stands in for ``InferenceEngine._graphs`` while the engine's programs
    are traced: each ``_program`` call runs the program eagerly and is
    recorded as the :class:`Program` its capture would be."""

    def __contains__(self, key) -> bool:
        return False

    def __getitem__(self, key):
        step = dict.__getitem__(self, key)

        def run(*inputs):
            out = step.fn(*inputs)
            rec = active()
            if rec is not None:
                outs = list(rec._tensors(out))
                rec.programs.append(Program(
                    key=key, types=tuple(type(x) for x in inputs),
                    static_bytes=static_bytes(list(inputs) + outs)))
            return out
        return run


@contextlib.contextmanager
def recording(subject: str = "", fake: bool = True, mode=None,
              arguments: Sequence = ()):
    """Enter a :class:`Recorder` (inside ``mode``, a ``FakeTensorMode``,
    when ``fake``); yields the recorder.  ``arguments``: the tensors alive
    at the start (the program's state).  A fake trace leaves the fence
    counter as it found it."""
    from deepspeed_tpu_torch.observability import fences
    rec = Recorder(subject=subject, fake=fake)
    rec.note_arguments(arguments)
    _ACTIVE.append(rec)
    fence0 = fences.FENCE_COUNT
    try:
        with contextlib.ExitStack() as stack:
            stack.enter_context(_reduce_op_hints())
            if fake and mode is not None:
                stack.enter_context(mode)
            stack.enter_context(rec)
            yield rec
    finally:
        _ACTIVE.remove(rec)
        if fake:
            # nothing waited on a device in a fake trace
            fences.FENCE_COUNT = fence0


def new_fake_mode():
    from torch._subclasses.fake_tensor import FakeTensorMode
    return FakeTensorMode(allow_non_fake_inputs=True)


# ------------------------------------------------------------ fake state

def fake_tree(obj, mode, memo: Optional[dict] = None):
    """A copy of ``obj`` with every tensor replaced by its fake (through
    ``mode``'s converter, so views stay views of one fake storage);
    containers are rebuilt, never mutated: dicts, lists, tuples, named
    tuples and dataclasses."""
    memo = {} if memo is None else memo
    if isinstance(obj, torch.Tensor):
        key = id(obj)
        if key not in memo:
            memo[key] = (obj, obj if is_fake(obj) else mode.from_tensor(obj))
        return memo[key][1]
    if isinstance(obj, dict):
        return {k: fake_tree(v, mode, memo) for k, v in obj.items()}
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(fake_tree(v, mode, memo) for v in obj))
    if isinstance(obj, (list, tuple)):
        return type(obj)(fake_tree(v, mode, memo) for v in obj)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        changes = {f.name: fake_tree(getattr(obj, f.name), mode, memo)
                   for f in dataclasses.fields(obj)
                   if _has_tensor(getattr(obj, f.name))}
        new = copy.copy(obj)
        for k, v in changes.items():
            object.__setattr__(new, k, v)
        return new
    return obj


def _has_tensor(obj, depth: int = 0) -> bool:
    if depth > 6:
        return False
    if isinstance(obj, torch.Tensor):
        return True
    if isinstance(obj, dict):
        return any(_has_tensor(v, depth + 1) for v in obj.values())
    if isinstance(obj, (list, tuple)):
        return any(_has_tensor(v, depth + 1) for v in obj)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return any(_has_tensor(getattr(obj, f.name), depth + 1)
                   for f in dataclasses.fields(obj))
    return False


def tree_tensors(obj, depth: int = 0) -> Iterator[torch.Tensor]:
    if depth > 6:
        return
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, dict):
        for v in obj.values():
            yield from tree_tensors(v, depth + 1)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            yield from tree_tensors(v, depth + 1)
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            yield from tree_tensors(getattr(obj, f.name), depth + 1)


@contextlib.contextmanager
def fake_modules(modules: Sequence[torch.nn.Module], mode, memo: dict):
    """Every parameter and buffer of ``modules`` replaced by its fake for
    the duration (restored after); yields the fakes' tensors."""
    saved = []
    fakes = []
    seen = set()
    for root in modules:
        if root is None:
            continue
        for mod in root.modules():
            if id(mod) in seen:
                continue
            seen.add(id(mod))
            for slot in ("_parameters", "_buffers"):
                d = getattr(mod, slot)
                for k, v in list(d.items()):
                    if v is None:
                        continue
                    saved.append((d, k, v))
                    f = fake_tree(v, mode, memo)
                    d[k] = f
                    fakes.append(f)
    try:
        yield fakes
    finally:
        for d, k, v in saved:
            d[k] = v


def fake_attrs(obj, names: Sequence[str], mode, memo: dict) -> List:
    """Rebind ``obj``'s attributes ``names`` to fake copies (the caller
    restores ``obj.__dict__``); returns the fakes' tensors."""
    out = []
    for n in names:
        v = obj.__dict__.get(n)
        if v is None or isinstance(v, torch.nn.Module) or not _has_tensor(v):
            continue
        f = fake_tree(v, mode, memo)
        obj.__dict__[n] = f
        out.extend(tree_tensors(f))
    return out
