"""Checkpoint save and load: ``deepspeed_tpu/checkpoint.py`` (data, tensor
and pipeline parallelism and ZeRO stages 1-3 included), in its layout and
container, so that a checkpoint crosses between the two packages either
way.

* layout   ``<dir>/<tag>/mp_rank_{MP:02d}_model_states.pt``, one per model
           rank, written by that model rank's first data rank with its
           LOCAL slices (``mp_rank``, ``mp_world_size``), and a ``latest``
           file naming the newest tag, published atomically by rank 0 once
           every rank's writes are done (a barrier before and after).
           Under pipeline parallelism one file per (stage, model rank),
           ``pp_stage_{PP:02d}_mp_rank_{MP:02d}_model_states.pt``, with
           that stage's slice (``pp_stage``, ``pp_world_size``).
           Under ZeRO 1-2 the model-state files hold no optimizer state:
           data rank ``r`` of the first partition group of (stage, model
           rank) row ``m = pp_stage * mp + mp_rank`` writes
           ``zero_pp_rank_{r}_mp_rank_{m:02d}optim_states.pt`` with its
           partition of that row's flat fp32 master and moments, the
           trailing padding dropped (``partition_id``, ``mp_rank`` (the
           row), ``dp_world_size``, ``partition_count``,
           ``mp_world_size``, ``pp_world_size``, ``unpadded_total``,
           ``step``, ``master``, ``m``, ``v``).  A restore re-pads for its
           own data-parallel size, so a save at any dp loads at any dp;
           model states (and the optimizer state of a save without ZeRO)
           load at any mp and pp, combined and re-cut by the model's
           ``partition_specs()`` and ``pipe_specs()``
           (``weights.combine_stage_trees``, ``weights.local_tree``); ZeRO
           partitions load at the saved mp and pp only.
           Under ZeRO-3 every rank writes ONLY its shards of the
           partitioned leaves (compute-dtype param, fp32 master, ``m``,
           ``v``) to ``zero3_dp_rank_{dp}_row_{row:02d}_states.pt`` (row
           = ``pp_stage * mp + mp_rank``), keyed by the leaf's index in the
           JAX
           flatten order (dict keys sorted); the model-state files carry
           the replicated leaves and a ``("__dstpu_zero3_part__", dim,
           dp)`` marker in place of each partitioned one.  A read
           rehydrates whole leaves from the shard files, so a ZeRO-3 save
           loads at any dp and at stage 0 (stage 1-2 take its weights
           only, as in the JAX package), and the two packages read each
           other's files.  Publishing a save removes stale model-state and
           ZeRO-3 shard files of an earlier save of the same tag (another
           mp, pp or stage).  Under sequence parallelism the ranks of a seq
           group are replicas: its first rank writes, and a save is the
           files of the same save at sp 1 (no file or field per seq
           rank), so it loads at any sp.
* content  the module (compute-dtype parameters), the fp32 masters, the
           optimizer moments and step, the loss-scale state, the LR
           scheduler, the live param groups, the engine counters and the
           caller's ``client_state``, under the JAX package's keys: trees
           are the JAX parameter trees (``weights.unflatten_tree`` of the
           port's dotted names).
* format   the ``DSTPUCK1`` container: magic, header offset, raw array
           payloads, then a pickled header in which each large array is a
           chunk reference ``("__dstpu_chunk__", offset, dtype, shape)``.
           The header loads through an unpickler that resolves numpy's
           array machinery and builtin containers only.
* bf16     written as its raw 16-bit payload under the dtype name
           ``"bfloat16"``, always as a chunk, so neither side needs
           ``ml_dtypes`` to read the port's files.  The JAX writer inlines
           arrays of up to 512 bytes as pickled numpy arrays; reading an
           inlined bf16 array needs ``ml_dtypes``, imported only then.
* faults   every file's write passes the chaos write point
           (``resilience.save_with_retry`` retries the whole save), every
           leaf read the chaos read point inside ``io_retry`` with the
           engine's ``resilience.io_retries``;
           ``find_latest_valid_tag(exclude=)`` skips the tags a resume
           could not load.

"""

from __future__ import annotations

import logging
import os
import pickle
import re
import threading
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist

from deepspeed_tpu_torch import precision as prec
from deepspeed_tpu_torch import weights as weights_mod
from deepspeed_tpu_torch import zero as zero_mod
from deepspeed_tpu_torch import zero3 as zero3_mod
from deepspeed_tpu_torch.resilience import chaos as _chaos
from deepspeed_tpu_torch.resilience.retry import io_retry

logger = logging.getLogger(__name__)

MODEL_FILE = "mp_rank_{mp:02d}_model_states.pt"
MODEL_FILE_PP = "pp_stage_{pp:02d}_mp_rank_{mp:02d}_model_states.pt"
ZERO_FILE = "zero_pp_rank_{dp}_mp_rank_{mp:02d}optim_states.pt"
ZERO3_FILE = "zero3_dp_rank_{dp}_row_{row:02d}_states.pt"
LATEST_FILE = "latest"

_MAGIC = b"DSTPUCK1"
_CHUNK_TAG = "__dstpu_chunk__"
#: wraps USER tuples whose first element collides with a tag, so that a
#: chunk reference is always the writer's own
_ESCAPE_TAG = "__dstpu_escape__"
_INLINE_MAX = 512          # smaller arrays stay pickled in the header
_HEADER_PREFIX = len(_MAGIC) + 8
_BF16 = "bfloat16"
_ML_DTYPES = {"bfloat16", "float8_e3m4", "float8_e4m3",
              "float8_e4m3b11fnuz", "float8_e4m3fn", "float8_e4m3fnuz",
              "float8_e5m2", "float8_e5m2fnuz", "float8_e8m0fnu",
              "float4_e2m1fn", "float6_e2m3fn", "float6_e3m2fn",
              "int2", "int4", "uint2", "uint4"}
#: the ZeRO-3 marker ``(tag, dim, dp)`` in place of a partitioned leaf
_Z3_TAG = "__dstpu_zero3_part__"


class CheckpointReadError(RuntimeError):
    """A restore reader failed: a truncated chunk, or storage errors that
    exhausted the per-reader ``io_retries`` budget.  Named, so that a dead
    reader surfaces as an exception on the restoring thread, never as a
    hang of the consumer."""


class Bf16Chunk:
    """A ``"bfloat16"`` chunk, read as its raw uint16 payload (``raw``, a
    read-only memmap)."""

    def __init__(self, raw: np.memmap):
        self.raw = raw
        self.shape = tuple(raw.shape)

    def __repr__(self):
        return f"Bf16Chunk(shape={self.shape})"


# ------------------------------------------------------------- writing

def _host_array(t: torch.Tensor):
    """(numpy array, dtype name) of a tensor; bf16 as its uint16 bits."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        return t.contiguous().view(torch.int16).cpu().numpy().view(
            np.uint16), _BF16
    a = t.contiguous().cpu().numpy()
    return a, a.dtype.name


class _ChunkedWriter:
    """Streams arrays into the payload region; ``finish(header)`` seals the
    file (written as ``<path>.tmp`` and renamed, so a reader never sees a
    torn file).  ``put(obj)`` walks dict/list/tuple containers and writes
    each tensor or large array as it reaches it, so one leaf's host copy is
    live at a time."""

    def __init__(self, path: str):
        self._path = path
        self._tmp = path + ".tmp"
        self._f = open(self._tmp, "wb")
        self._f.write(_MAGIC)
        self._f.write((0).to_bytes(8, "little"))
        self._refs = set()     # id()s of the references this writer issued
        self.nbytes = 0        # payload bytes written

    def _chunk(self, a: np.ndarray, dtype_name: str) -> tuple:
        a = np.ascontiguousarray(a)
        off = self._f.tell()
        a.tofile(self._f)
        self.nbytes += a.nbytes
        ref = (_CHUNK_TAG, off, dtype_name, tuple(a.shape))
        self._refs.add(id(ref))
        return ref

    def put(self, obj):
        if isinstance(obj, dict):
            return {k: self.put(v) for k, v in obj.items()}
        if isinstance(obj, tuple) and hasattr(obj, "_fields"):
            raise TypeError(
                f"checkpoint state contains a namedtuple "
                f"({type(obj).__name__}): convert it to a dict or a plain "
                f"tuple; the restricted loader cannot rebuild it")
        if isinstance(obj, (list, tuple)):
            t = [self.put(v) for v in obj]
            return t if isinstance(obj, list) else tuple(t)
        if isinstance(obj, torch.Tensor):
            a, name = _host_array(obj)
            if name == _BF16 or a.nbytes > _INLINE_MAX:
                return self._chunk(a, name)
            return a
        if isinstance(obj, np.ndarray) and obj.nbytes > _INLINE_MAX:
            return self._chunk(obj, obj.dtype.name)
        return obj

    def _escape(self, obj):
        """Wrap any header tuple that looks like a chunk reference but was
        not issued by this writer: it is user data."""
        if id(obj) in self._refs:
            return obj
        if isinstance(obj, dict):
            return {k: self._escape(v) for k, v in obj.items()}
        if isinstance(obj, list):
            return [self._escape(v) for v in obj]
        if isinstance(obj, tuple):
            t = tuple(self._escape(v) for v in obj)
            if t and isinstance(t[0], str) and t[0] in (_CHUNK_TAG,
                                                        _ESCAPE_TAG):
                return (_ESCAPE_TAG, t)
            return t
        return obj

    def finish(self, header: Any) -> None:
        _chaos.io_point("ckpt_write")   # the chaos tier's Nth-write failure
        header = self._escape(header)
        off = self._f.tell()
        pickle.dump(header, self._f, protocol=pickle.HIGHEST_PROTOCOL)
        self._f.seek(len(_MAGIC))
        self._f.write(off.to_bytes(8, "little"))
        self._f.flush()
        os.fsync(self._f.fileno())
        self._f.close()
        os.replace(self._tmp, self._path)

    def abort(self) -> None:
        self._f.close()
        if os.path.exists(self._tmp):
            os.remove(self._tmp)


def _write_file(path: str, state: Any) -> int:
    """Write ``state`` as one container file; returns the payload bytes."""
    w = _ChunkedWriter(path)
    try:
        w.finish(w.put(state))
    except BaseException:
        w.abort()
        raise
    return w.nbytes


# ------------------------------------------------------------- reading

def _resolve_chunks(obj, path: str, payload_end: Optional[int] = None):
    """Replace chunk references with read-only ``np.memmap`` views into
    ``path`` (``Bf16Chunk`` for bf16).  Each reference is checked against
    the payload region ``[_HEADER_PREFIX, payload_end)`` first: a corrupt
    or truncated one raises ``ValueError`` naming it."""
    if isinstance(obj, tuple) and len(obj) == 2 and obj[0] == _ESCAPE_TAG:
        return tuple(_resolve_chunks(v, path, payload_end) for v in obj[1])
    if isinstance(obj, tuple) and len(obj) == 4 and obj[0] == _CHUNK_TAG:
        _, off, dtype_name, shape = obj
        if not (isinstance(off, int) and isinstance(dtype_name, str)
                and isinstance(shape, (tuple, list))
                and all(isinstance(s, int) and s >= 0 for s in shape)):
            raise ValueError(
                f"corrupt checkpoint {path!r}: malformed chunk ref {obj!r}")
        if dtype_name == _BF16:
            dtype = np.dtype(np.uint16)
        elif dtype_name in _ML_DTYPES:
            raise ValueError(
                f"checkpoint {path!r}: chunk dtype {dtype_name!r} has no "
                f"counterpart in the port")
        else:
            try:
                dtype = np.dtype(dtype_name)
            except TypeError:
                raise ValueError(
                    f"corrupt checkpoint {path!r}: chunk ref names unknown "
                    f"dtype {dtype_name!r}") from None
        nbytes = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
        if off < _HEADER_PREFIX or (
                payload_end is not None and off + nbytes > payload_end):
            raise ValueError(
                f"corrupt checkpoint {path!r}: chunk ref offset={off} "
                f"size={nbytes} falls outside the payload region "
                f"[{_HEADER_PREFIX}, {payload_end})")
        raw = np.memmap(path, dtype=dtype, mode="r", offset=off,
                        shape=tuple(shape))
        return Bf16Chunk(raw) if dtype_name == _BF16 else raw
    if isinstance(obj, dict):
        return {k: _resolve_chunks(v, path, payload_end)
                for k, v in obj.items()}
    if isinstance(obj, list):
        return [_resolve_chunks(v, path, payload_end) for v in obj]
    if isinstance(obj, tuple):
        return tuple(_resolve_chunks(v, path, payload_end) for v in obj)
    return obj


class _RestrictedUnpickler(pickle.Unpickler):
    """Only numpy's array machinery and builtin containers resolve; any
    other global (os.system, a ``__reduce__`` payload) raises."""

    _SAFE = {
        "builtins": {"dict", "list", "tuple", "set", "frozenset", "complex",
                     "slice", "bytearray", "range"},
        "numpy": {"ndarray", "dtype", "bool_", "number", "generic"},
        "numpy.core.multiarray": {"_reconstruct", "scalar"},
        "numpy._core.multiarray": {"_reconstruct", "scalar"},
        "numpy.core.numeric": {"_frombuffer"},
        "numpy._core.numeric": {"_frombuffer"},
        "collections": {"OrderedDict"},
    }

    def find_class(self, module, name):
        if module in ("numpy.dtypes", "numpy.core.numerictypes",
                      "numpy._core.numerictypes"):
            return super().find_class(module, name)   # dtype classes only
        if module == "ml_dtypes" and name in _ML_DTYPES:
            # a small bf16 array the JAX writer inlined
            try:
                import ml_dtypes
            except ImportError:
                raise pickle.UnpicklingError(
                    f"checkpoint holds an inline {name} array (the JAX "
                    f"writer inlines arrays of up to {_INLINE_MAX} bytes): "
                    f"reading it needs the ml_dtypes package") from None
            return getattr(ml_dtypes, name)
        if name in self._SAFE.get(module, ()):
            return super().find_class(module, name)
        if module == "numpy" and not name.startswith("_"):
            attr = getattr(np, name, None)
            if isinstance(attr, type) and issubclass(attr, np.generic):
                return attr                            # numpy scalar types
        raise pickle.UnpicklingError(
            f"checkpoint contains forbidden global {module}.{name}")


def _load_obj(path: str) -> Any:
    with open(path, "rb") as f:
        head = f.read(len(_MAGIC))
        if head != _MAGIC:
            f.seek(0)         # a plain pickle (the JAX package's old format)
            return _RestrictedUnpickler(f).load()
        off = int.from_bytes(f.read(8), "little")
        f.seek(off)
        header = _RestrictedUnpickler(f).load()
    return _resolve_chunks(header, path, payload_end=off)


_TORCH_DTYPES = {np.dtype(k): v for k, v in (
    ("float32", torch.float32), ("float64", torch.float64),
    ("float16", torch.float16), ("int64", torch.int64),
    ("int32", torch.int32), ("int16", torch.int16), ("int8", torch.int8),
    ("uint8", torch.uint8), ("bool", torch.bool))}


#: retries of a chunk read (``io_retry``) where the caller has no engine;
#: ``load_checkpoint`` passes its engine's ``resilience.io_retries``
IO_RETRIES = 3

#: the largest read of one flat ZeRO partition region: a partition is cut
#: into reads of this size so that the reader pool shares it out
REGION_BYTES = 64 * 2 ** 20


# ------------------------------------------- parallel streaming restore
#
# The JAX package's restore pipeline (``deepspeed_tpu/checkpoint.py``
# "parallel streaming restore"), for tensors: a reader pool streams chunk
# reads from the container, each leaf is assembled as its chunks land, and
# the copy of leaf i to the card (from a pinned host buffer, non_blocking)
# overlaps the reads of every later leaf.  Readers use positioned
# ``readinto`` reads (which release the GIL, where a page fault on a memmap
# holds it), each read composed with ``io_retry``; the bytes of read
# results in flight are bounded by ``restore_readahead_mb``, so peak host
# memory is one readahead window plus the leaf being placed, not the whole
# state.  ``restore_threads <= 1`` runs the same plan inline; both paths
# run the same per-leaf assembly, so they are bitwise interchangeable
# (tests/test_torch_restore.py).

class _Region:
    """Elements ``[start, stop)`` of a flat chunk (a memmap or an inline
    array): one read of a ZeRO partition file."""

    def __init__(self, src, start: int, stop: int):
        self.src, self.start, self.stop = src, int(start), int(stop)
        self.shape = (self.stop - self.start,)
        self.nbytes = (self.stop - self.start) * src.dtype.itemsize


def _part_nbytes(part) -> int:
    if isinstance(part, Bf16Chunk):
        return part.raw.nbytes
    if isinstance(part, torch.Tensor):
        return part.numel() * part.element_size()
    return int(getattr(part, "nbytes", 0) or 0)


def _part_shape(part) -> tuple:
    return tuple(getattr(part, "shape", ()))


class LazyParts:
    """A leaf to assemble from chunk parts: ``parts`` are the raw sources
    (memmaps, ``Bf16Chunk``, inline arrays, tensors, regions) and
    ``assemble(tensors)`` (tensors in ``parts`` order) builds the leaf, of
    ``shape``.  The restore hands every part to the reader pool and
    assembles each leaf as its parts land (``_stream_leaves``);
    ``materialize()`` is the inline equivalent, bitwise the same (the JAX
    package's ``zero.LazyParts``)."""

    __slots__ = ("parts", "assemble", "shape")

    def __init__(self, parts, assemble, shape):
        self.parts = list(parts)
        self.assemble = assemble
        self.shape = tuple(shape)

    @property
    def nbytes(self) -> int:
        return sum(_part_nbytes(p) for p in self.parts)

    def materialize(self) -> torch.Tensor:
        return self.assemble([_read_part(p) for p in self.parts])

    def map(self, fn, shape) -> "LazyParts":
        """``fn`` applied to the assembled leaf (of ``shape``)."""
        sub = self.assemble
        return LazyParts(self.parts, lambda ts: fn(sub(ts)), shape)

    @classmethod
    def wrap(cls, value) -> "LazyParts":
        """Lift a plain source into a single-part LazyParts."""
        if isinstance(value, cls):
            return value
        return cls([value], lambda ts: ts[0], _part_shape(value))

    @classmethod
    def concat(cls, values, dim: int) -> "LazyParts":
        """``values`` (LazyParts or raw sources) concatenated along
        ``dim``, every underlying chunk kept an independent part."""
        lazies = [cls.wrap(v) for v in values]
        counts = [len(lz.parts) for lz in lazies]
        subs = [lz.assemble for lz in lazies]

        def assemble(ts):
            out, i = [], 0
            for n, sub in zip(counts, subs):
                out.append(sub(ts[i:i + n]))
                i += n
            return torch.cat(out, dim=dim)

        shape = list(lazies[0].shape)
        shape[dim] = sum(lz.shape[dim] for lz in lazies)
        return cls([p for lz in lazies for p in lz.parts], assemble, shape)


class _RestorePlan:
    """The restore knobs of one load: reader-pool width, readahead window,
    per-reader retry budget."""

    def __init__(self, threads: int = 1, readahead_mb: float = 256.0,
                 io_retries: int = IO_RETRIES):
        self.threads = int(threads)
        self.readahead_bytes = max(1, int(float(readahead_mb) * 2 ** 20))
        self.io_retries = int(io_retries)

    @classmethod
    def auto_threads(cls) -> int:
        # reads are memcpy-bound once the page cache is warm and IO-bound
        # when cold; a couple of readers per core covers both without
        # oversubscribing small hosts
        return max(2, min(8, 2 * (os.cpu_count() or 1)))

    @classmethod
    def from_engine(cls, engine) -> "_RestorePlan":
        """The engine's ``checkpoint.restore_threads`` (0: auto),
        ``restore_readahead_mb`` and ``resilience.io_retries``; the
        defaults without an engine."""
        cfg = getattr(engine, "config", None)
        threads = int(getattr(cfg, "checkpoint_restore_threads", 0))
        if threads == 0:
            threads = cls.auto_threads()
        return cls(
            threads=threads,
            readahead_mb=float(getattr(cfg, "checkpoint_restore_readahead_mb",
                                       256.0)),
            io_retries=int(getattr(cfg, "resilience_io_retries",
                                   IO_RETRIES)))


def _readinto(mm: np.memmap, out: np.ndarray, start: int = 0) -> None:
    """Fill ``out`` from the file region behind ``mm``, from its element
    ``start`` on, with one positioned read; a short read names the
    truncation."""
    if not out.nbytes:
        return
    offset = int(mm.offset) + start * mm.dtype.itemsize
    with open(mm.filename, "rb") as f:
        f.seek(offset)
        got = f.readinto(memoryview(out.reshape(-1).view(np.uint8)))
    if got != out.nbytes:
        raise CheckpointReadError(
            f"truncated checkpoint chunk in {mm.filename!r}: wanted "
            f"{out.nbytes} bytes at offset {offset}, file ended after {got}")


def _read_part(part, pin: bool = False) -> torch.Tensor:
    """One chunk source as a CPU tensor (pinned with ``pin``): a file chunk
    (or a region of one) through one positioned read into a fresh staging
    tensor, never through ``torch.from_numpy`` on a read-only view; an
    inline array copied; a tensor as it is.  Passes the chaos read point."""
    _chaos.read_point("ckpt_read")
    if isinstance(part, torch.Tensor):
        return part
    region = part if isinstance(part, _Region) else None
    src = region.src if region is not None else part
    bf16 = isinstance(src, Bf16Chunk)
    if bf16:
        src = src.raw
    elif not isinstance(src, np.memmap):
        src = np.asarray(src)
        if src.dtype.name == _BF16:             # an inline ml_dtypes array
            bf16, src = True, src.view(np.uint16)
    start = region.start if region is not None else 0
    shape = region.shape if region is not None else src.shape
    if bf16:
        dtype, staged_as = torch.bfloat16, torch.int16
    else:
        dtype = _TORCH_DTYPES.get(np.dtype(src.dtype))
        if dtype is None:
            raise TypeError(f"checkpoint leaf dtype {src.dtype} has no "
                            f"torch counterpart")
        staged_as = dtype
    stage = torch.empty(tuple(shape), dtype=staged_as, pin_memory=pin)
    view = stage.numpy()
    if bf16:
        view = view.view(np.uint16)
    if isinstance(src, np.memmap):
        _readinto(src, view, start)
    else:
        view[...] = src.reshape(-1)[start:start + view.size].reshape(
            view.shape)
    return stage.view(dtype) if bf16 else stage


def _part_desc(part) -> str:
    src = part.src if isinstance(part, _Region) else part
    src = src.raw if isinstance(src, Bf16Chunk) else src
    fn = getattr(src, "filename", None)
    if fn:
        return f"{fn}@{getattr(src, 'offset', '?')}"
    return type(part).__name__


def _stream_leaves(leaves, plan: _RestorePlan, pin: bool = False):
    """Yield a CPU tensor (pinned with ``pin``) for each of ``leaves`` in
    order, the reads pipelined.

    Every leaf expands into its chunk parts; with ``plan.threads > 1`` a
    reader pool fetches parts concurrently (submission runs ahead of
    consumption until ``readahead_bytes`` of results are in flight, so the
    window, not the pool, bounds host memory), and each leaf is assembled
    as its parts land.  ``threads <= 1`` runs the same plan inline: the
    same reads, the same assembly, bitwise the same leaves.  A read that
    fails after its own ``io_retries`` retries, or a short one, raises
    ``CheckpointReadError`` on this thread."""
    def read(part):
        # exhausted-retry storage errors surface as the SAME named error on
        # both the serial and the pooled path
        try:
            return io_retry(lambda: _read_part(part, pin),
                            retries=plan.io_retries,
                            what=f"checkpoint chunk read ({_part_desc(part)})")
        except CheckpointReadError:
            raise
        except Exception as e:
            raise CheckpointReadError(
                f"checkpoint restore reader failed on {_part_desc(part)}: "
                f"{e}") from e

    lazies = [LazyParts.wrap(x) for x in leaves]
    if plan.threads <= 1:
        for lz in lazies:
            yield lz.assemble([read(p) for p in lz.parts])
        return

    import collections
    from concurrent.futures import ThreadPoolExecutor
    flat = [(p, _part_nbytes(p)) for lz in lazies for p in lz.parts]
    ex = ThreadPoolExecutor(max_workers=plan.threads,
                            thread_name_prefix="dstpu-ckpt-reader")
    pending = collections.deque()   # (future, nbytes, part) in flat order
    state = {"si": 0, "inflight": 0}

    def pump():
        # keep at least one read in flight and the window full; consuming
        # a result frees window bytes, so the pool always drains forward
        # (no reader waits on the consumer: deadlock-free)
        while state["si"] < len(flat) and (
                not pending or state["inflight"] < plan.readahead_bytes):
            part, nb = flat[state["si"]]
            pending.append((ex.submit(read, part), nb, part))
            state["si"] += 1
            state["inflight"] += nb

    try:
        for lz in lazies:
            got = []
            for _ in lz.parts:
                pump()
                fut, nb, part = pending.popleft()
                got.append(fut.result())
                state["inflight"] -= nb
                pump()
            yield lz.assemble(got)
    finally:
        ex.shutdown(wait=False, cancel_futures=True)


def _place(pairs, plan: _RestorePlan) -> None:
    """Copy each ``(destination tensor, source leaf)`` of ``pairs`` into
    place through ONE streamed read plan: every shape is checked before
    any read, and the copy of leaf i (``non_blocking`` from a pinned host
    buffer, for a card) overlaps the reads of the later leaves."""
    for dst, src, name in pairs:
        shape = tuple(getattr(src, "shape", ()))
        if shape != tuple(dst.shape):
            raise ValueError(
                f"checkpoint restore: {name} has shape {shape}, the engine "
                f"expects {tuple(dst.shape)}")
    pin = any(dst.device.type == "cuda" for dst, _, _ in pairs)
    stream = _stream_leaves([src for _, src, _ in pairs], plan, pin=pin)
    try:
        with torch.no_grad():
            for (dst, _, _), host in zip(pairs, stream):
                dst.copy_(host, non_blocking=dst.device.type == "cuda")
    finally:
        stream.close()      # releases the reader pool on error paths too


def to_tensor(leaf, device=None, retries: int = IO_RETRIES) -> torch.Tensor:
    """A loaded leaf (memmap, ``Bf16Chunk``, numpy array, tensor,
    ``LazyParts``) as a tensor on ``device`` (default the CPU), read
    through a serial plan with ``retries`` retries per chunk; staged in a
    pinned host buffer for a CUDA device."""
    if isinstance(leaf, torch.Tensor):
        return leaf.to(device) if device is not None else leaf
    cuda = device is not None and torch.device(device).type == "cuda"
    host = next(_stream_leaves([leaf], _RestorePlan(1, io_retries=retries),
                               pin=cuda))
    return host.to(device, non_blocking=True) if cuda else host


# ------------------------------------------------------------ layout

def zero_file(ckpt_dir: str, tag: str, dp_rank: int,
              mp_rank: int = 0) -> str:
    return os.path.join(ckpt_dir, tag,
                        ZERO_FILE.format(dp=dp_rank, mp=mp_rank))


def zero3_file(ckpt_dir: str, tag: str, dp_rank: int, row: int) -> str:
    return os.path.join(ckpt_dir, tag, ZERO3_FILE.format(dp=dp_rank,
                                                         row=row))


def model_file(ckpt_dir: str, tag: str, mp_rank: int = 0,
               pp_stage: int = 0, pp_size: int = 1) -> str:
    if pp_size > 1:
        return os.path.join(ckpt_dir, tag,
                            MODEL_FILE_PP.format(pp=pp_stage, mp=mp_rank))
    return os.path.join(ckpt_dir, tag, MODEL_FILE.format(mp=mp_rank))


def _model_probe(load_dir: str, tag: str) -> Optional[str]:
    """The tag's canonical model-state file, or None."""
    for mfile in (model_file(load_dir, tag),
                  os.path.join(load_dir, tag,
                               MODEL_FILE_PP.format(pp=0, mp=0))):
        if os.path.exists(mfile):
            return mfile
    return None


def validate_tag(load_dir: str, tag: str) -> bool:
    """True when ``tag``'s model-state file exists and its header parses
    (chunk payloads stay unread)."""
    probe = _model_probe(load_dir, tag)
    if probe is None:
        return False
    try:
        _load_obj(probe)
    except (OSError, ValueError, EOFError, pickle.UnpicklingError):
        return False
    return True


def list_tags(load_dir: str) -> list:
    """Candidate tags under ``load_dir``: each tag directory, and
    ``emergency/<tag>`` ones."""
    out = []
    try:
        entries = sorted(os.listdir(load_dir))
    except OSError:
        return out
    for e in entries:
        p = os.path.join(load_dir, e)
        if not os.path.isdir(p):
            continue
        if e == "emergency":
            try:
                subs = sorted(os.listdir(p))
            except OSError:
                continue
            out.extend(f"emergency/{s}" for s in subs
                       if os.path.isdir(os.path.join(p, s)))
        else:
            out.append(e)
    return out


def _tag_step(tag: str) -> int:
    """Trailing step number of a tag (``global_step12`` -> 12, else -1)."""
    m = re.search(r"(\d+)$", tag)
    return int(m.group(1)) if m else -1


def find_latest_valid_tag(load_dir: str, exclude=()) -> Optional[str]:
    """The newest valid tag under ``load_dir``, by model-file mtime, then
    trailing step, then name, over regular and ``emergency/`` tags.  Tags
    in ``exclude`` are skipped: the resume driver passes those whose full
    load failed (a mid-save kill can leave a tag whose model header parses
    but whose ZeRO files are missing), so discovery falls back to the
    next-newest one (the JAX ``find_latest_valid_tag``)."""
    best = None
    excluded = set(exclude)
    for tag in list_tags(load_dir):
        if tag in excluded or not validate_tag(load_dir, tag):
            continue
        probe = _model_probe(load_dir, tag)
        key = (os.path.getmtime(probe), _tag_step(tag), tag)
        if best is None or key > best[0]:
            best = (key, tag)
    return None if best is None else best[1]


def _resolve_tag(load_dir: str, tag: Optional[str]) -> Optional[str]:
    """``tag``, or the one ``latest`` names, or (``latest`` missing, empty
    or naming an invalid tag) the newest valid tag; None if there is none."""
    if tag is not None:
        return tag
    latest = os.path.join(load_dir, LATEST_FILE)
    if os.path.exists(latest):
        with open(latest) as f:
            tag = f.read().strip() or None
    if tag is not None and validate_tag(load_dir, tag):
        return tag
    fallback = find_latest_valid_tag(load_dir)
    if tag is not None and fallback is not None:
        logger.warning("checkpoint `latest` names an invalid tag %r; "
                       "falling back to the newest valid tag %r",
                       tag, fallback)
    return fallback


def _is_z3_marker(obj) -> bool:
    return isinstance(obj, tuple) and len(obj) == 3 and obj[0] == _Z3_TAG


def _zero3_rehydrate(load_dir: str, tag: str, state: dict, row: int):
    """Replace the ZeRO-3 markers in model rank ``row``'s freshly read
    state with whole leaves, each a ``LazyParts`` concatenating its shard
    records along the recorded dim from the ``zero3_dp_rank_*_row_{row}``
    shard files (the JAX ``_zero3_rehydrate``): the restore plan reads the
    shards concurrently.  After it the state reads as a stage-0 file.  The
    shard record of a leaf is found by its index in the JAX flatten order
    (keystr-keyed records of older JAX files too)."""
    if not state.get("zero3_native"):
        return state
    cache = {}

    def shard_leaves(dp_rank):
        if dp_rank not in cache:
            f = zero3_file(load_dir, tag, dp_rank, row)
            if not os.path.exists(f):
                raise FileNotFoundError(
                    f"stage-3 checkpoint is missing shard file {f} "
                    f"(saved at dp={state.get('dp_world_size')})")
            cache[dp_rank] = _load_obj(f)["leaves"]
        return cache[dp_rank]

    def whole(index, name, marker, field):
        from deepspeed_tpu_torch.engine import _keystr
        _, dim, dp = marker
        chunks = []
        for d in range(int(dp)):
            leaves = shard_leaves(d)
            rec = leaves.get(index)
            if rec is None:
                rec = leaves[_keystr(name)]
            chunks.append(rec[field])
        return LazyParts.concat(chunks, int(dim))

    def fix(tree, field):
        if _is_z3_marker(tree):                  # a whole-tree marker
            return whole(0, "", tree, field)
        flat = weights_mod.flatten_tree(tree)
        order = {n: i for i, n in
                 enumerate(zero_mod.jax_leaf_order(flat))}
        return weights_mod.unflatten_tree({
            n: whole(order[n], n, v, field) if _is_z3_marker(v) else v
            for n, v in flat.items()})

    state["module"] = fix(state["module"], "param")
    opt = state.get("optimizer")
    if opt is not None:
        opt["master"] = fix(opt["master"], "master")
        for key in ("m", "v"):
            if opt["opt_state"][key] is not None:
                opt["opt_state"][key] = fix(opt["opt_state"][key], key)
    return state


def _read_state(load_dir: str, tag: str, row: int = 0, mp: int = 1,
                pp: int = 1):
    """The model-state file of (stage, model rank) ``row = stage * mp +
    mp_rank`` of a save at ``mp`` and ``pp``, ZeRO-3 leaves rehydrated."""
    state = _load_obj(model_file(load_dir, tag, row % mp, row // mp, pp))
    return _zero3_rehydrate(load_dir, tag, state, row)


def _read_model_state(load_dir: str, tag: Optional[str]):
    """``(tag, state)`` of the tag's model-state file of stage 0 and model
    rank 0, or None when there is no checkpoint."""
    tag = _resolve_tag(load_dir, tag)
    if tag is None:
        return None
    mfile = _model_probe(load_dir, tag)
    if mfile is None:
        return None
    return tag, _zero3_rehydrate(load_dir, tag, _load_obj(mfile), 0)


def _saved_mp(state) -> int:
    return int(state.get("mp_world_size", 1))


def _saved_pp(state) -> int:
    return int(state.get("pp_world_size", 1))


def _all_states(load_dir: str, tag: str, state0) -> list:
    """The model-state files of every saved (stage, model rank), in the
    order ``stage * mp + mp_rank`` (``state0``, already read, is the
    first)."""
    mp, pp = _saved_mp(state0), _saved_pp(state0)
    return [state0] + [_read_state(load_dir, tag, r, mp, pp)
                       for r in range(1, mp * pp)]


def _combined(trees, specs, pipe_specs, mp: int,
              plan: "_RestorePlan") -> dict:
    """The global tree of the saved (stage, model rank)s' local ``trees``
    at model-parallel size ``mp``, as CPU tensors (``specs``: the model's
    ``partition_specs()``, ``pipe_specs``: its ``pipe_specs()``), every
    leaf of every tree read through ``plan``."""
    if mp > 1 and specs is None:
        raise ValueError(
            f"checkpoint was saved at mp={mp}: combining its model-rank "
            f"files needs the saving model's partition_specs()")
    flats = [weights_mod.flatten_tree(t) for t in trees]
    stream = _stream_leaves([v for f in flats for v in f.values()], plan)
    try:
        read = [weights_mod.unflatten_tree({k: next(stream) for k in f})
                for f in flats]
    finally:
        stream.close()
    return weights_mod.combine_stage_trees(read, specs or {}, mp, pipe_specs)


# ------------------------------------------------------------ saving

class _AsyncSaver:
    """One background writer thread; saves run in submission order."""

    def __init__(self):
        self._queue = None
        self._thread = None
        self._errors = []
        self._lock = threading.Lock()

    def _run(self):
        while True:
            fn = self._queue.get()
            try:
                fn()
            except BaseException as e:        # surfaced at wait()
                self._errors.append(e)
            finally:
                self._queue.task_done()

    def submit(self, fn):
        import queue
        with self._lock:
            if self._thread is None or not self._thread.is_alive():
                self._queue = queue.Queue()
                self._thread = threading.Thread(
                    target=self._run, daemon=True, name="dstt-ckpt-writer")
                self._thread.start()
        self._queue.put(fn)

    def wait(self):
        """Block until every queued save is on disk; re-raise the first
        background failure."""
        if self._queue is not None:
            self._queue.join()
        if self._errors:
            e, self._errors = self._errors[0], []
            raise e


ASYNC_SAVER = _AsyncSaver()


def _reject_namedtuples(obj, where: str) -> None:
    """Refuse namedtuples in a user state tree at call time (the restricted
    loader cannot rebuild them; an async save would fail only later)."""
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        raise TypeError(
            f"save_checkpoint: {where} contains a namedtuple "
            f"({type(obj).__name__}): convert it to a dict or a plain tuple")
    if isinstance(obj, dict):
        for k, v in obj.items():
            _reject_namedtuples(v, f"{where}[{k!r}]")
    elif isinstance(obj, (list, tuple)):
        for i, v in enumerate(obj):
            _reject_namedtuples(v, f"{where}[{i}]")


def _tree(flat: dict) -> dict:
    return weights_mod.unflatten_tree(flat)


def _snapshot(obj):
    """A host copy of every tensor in ``obj`` (an async save's stall: the
    next step may update the live tensors in place)."""
    if isinstance(obj, dict):
        return {k: _snapshot(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        t = [_snapshot(v) for v in obj]
        return t if isinstance(obj, list) else tuple(t)
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    return obj


def _engine_state(engine, client_state=None) -> dict:
    """The model-state file's content for ``engine``'s model rank (its
    local slices), with live tensors (written one leaf at a time).  Under
    ZeRO 1-2 the optimizer state is in the partition files instead
    (``optimizer`` None); under ZeRO-3 a marker stands in for each
    partitioned leaf."""
    opt = engine.opt_state
    lr_sched = engine.lr_scheduler
    dims = engine._zero3_dims if engine.zero3 else {}

    def tree(flat):
        return _tree({k: (_Z3_TAG, dims[k], engine.dp_world_size)
                      if dims.get(k, -1) >= 0 else t
                      for k, t in flat.items()})

    optimizer = None if engine.zero_flat else {
        "master": tree(engine.master),
        "opt_state": {
            "step": np.asarray(opt.step, np.int32),
            "m": None if opt.m is None else tree(opt.m),
            "v": None if opt.v is None else tree(opt.v)},
    }
    extra = {"zero3_native": True} if engine.zero3 else {}
    return {
        **extra,
        "loss_scale_state": {k: v.detach().cpu().numpy()
                             for k, v in
                             engine.loss_scale_state._asdict().items()},
        "loss_scale_variant": engine._ls_variant,
        "lr_scheduler": (lr_sched.state_dict() if lr_sched is not None
                         and hasattr(lr_sched, "state_dict") else None),
        "param_groups": [dict(g) for g in engine.optimizer.param_groups],
        "global_steps": engine.global_steps,
        "skipped_steps": engine.skipped_steps,
        "micro_steps": engine.micro_steps,
        "zero_enabled": engine.zero_enabled,
        "zero_stage": engine.zero_stage,
        "mp_world_size": engine.mp_world_size,
        "pp_world_size": engine.pp_world_size,
        "client_state": dict(client_state or {}),
        "mp_rank": engine.mp_rank,
        "pp_stage": engine.pp_rank,
        "module": tree(dict(engine.module.named_parameters())),
        "optimizer": optimizer,
    }


def _row(engine) -> int:
    """This rank's (stage, model rank) row: ``pp_stage * mp + mp_rank``."""
    return engine.pp_rank * engine.mp_world_size + engine.mp_rank


def _zero_checkpoint_writes(engine, save_dir: str, tag: str) -> list:
    """``(path, state)`` of this rank's ZeRO partition file: data rank r of
    its (stage, model rank) row's first partition group writes partition r
    (the other groups hold copies), the trailing padding dropped so that a
    restore re-pads for its own topology (the JAX package's
    ``_zero_checkpoint_writes``)."""
    topo = engine.topology
    if topo.dp_rank >= engine.zero_pps or topo.sp_rank:
        return []
    meta = engine.flat_meta
    lo, part = engine._owned_range()
    count = int(np.clip(meta.total - lo, 0, part))
    opt = engine.opt_state
    state = {
        "partition_id": topo.partition_id,
        "mp_rank": _row(engine),
        "dp_world_size": engine.dp_world_size,
        "partition_count": engine.zero_pps,
        "mp_world_size": engine.mp_world_size,
        "pp_world_size": engine.pp_world_size,
        "unpadded_total": meta.total,
        "step": np.asarray(opt.step, np.int32),
        "master": engine.master_flat[:count],
        "m": opt.m["flat"][:count],
        "v": opt.v["flat"][:count],
    }
    return [(zero_file(save_dir, tag, topo.partition_id, _row(engine)),
             state)]


def _zero3_shard_writes(engine, save_dir: str, tag: str) -> list:
    """``(path, state)`` of this rank's ZeRO-3 shard file: its shards of
    the partitioned leaves (param, master, m, v), keyed by the leaf's
    index in the JAX flatten order (the JAX ``_zero3_shard_writes``)."""
    from deepspeed_tpu_torch.engine import _keystr
    if engine.topology.sp_rank:
        return []
    dims = engine._zero3_dims
    params = dict(engine.module.named_parameters())
    opt = engine.opt_state
    leaves = {}
    for i, name in enumerate(zero_mod.jax_leaf_order(params)):
        if dims[name] < 0:
            continue
        leaves[i] = {
            "keystr": _keystr(name), "dim": int(dims[name]),
            "param": params[name], "master": engine.master[name],
            "m": None if opt.m is None else opt.m[name],
            "v": None if opt.v is None else opt.v[name]}
    topo = engine.topology
    state = {"row": _row(engine), "dp_rank": topo.dp_rank,
             "dp_world_size": engine.dp_world_size,
             "mp_world_size": engine.mp_world_size,
             "pp_world_size": engine.pp_world_size,
             "step": np.asarray(opt.step, np.int32), "leaves": leaves}
    return [(zero3_file(save_dir, tag, topo.dp_rank, _row(engine)), state)]


def save_checkpoint(engine, save_dir: str, tag: Optional[str] = None,
                    client_state: Optional[dict] = None,
                    async_save: Optional[bool] = None) -> str:
    """Write ``engine``'s state under ``save_dir/tag`` (default tag
    ``global_step<N>``) and point ``latest`` at it; returns the tag's
    directory.  ``async_save`` (default: the ``checkpoint.async_save``
    config key) copies the state to the host now and writes it on a
    background thread: ``checkpoint_wait()`` blocks until it is on disk.
    ``engine.last_save_bytes`` is the payload the save wrote (0 until an
    async write completes)."""
    if async_save is None:
        async_save = bool(getattr(engine.config, "checkpoint_async_save",
                                  False))
    if async_save and _world(engine) > 1:
        logger.warning(
            "async_save requested in a multi-process run: falling back to "
            "synchronous saves (the publish barrier is a collective and "
            "cannot run on the writer thread)")
        async_save = False
    ASYNC_SAVER.wait()     # one save at a time
    _reject_namedtuples(client_state, "client_state")
    tag = tag or f"global_step{engine.global_steps}"
    path = os.path.join(save_dir, tag)
    writes = []
    if engine.topology.dp_rank == 0 and engine.topology.sp_rank == 0:
        state = _engine_state(engine, client_state)
        _reject_namedtuples(state["lr_scheduler"],
                            "lr_scheduler.state_dict()")
        writes.append((model_file(save_dir, tag, engine.mp_rank,
                                  engine.pp_rank, engine.pp_world_size),
                       state))
    if engine.zero_flat:
        writes.extend(_zero_checkpoint_writes(engine, save_dir, tag))
    if engine.zero3:
        writes.extend(_zero3_shard_writes(engine, save_dir, tag))
    os.makedirs(path, exist_ok=True)
    engine.last_save_bytes = 0

    def write(items):
        nbytes = 0
        for fname, st in items:
            nbytes += _write_file(fname, st)
        engine.last_save_bytes = nbytes
        _publish(engine, save_dir, tag)

    if async_save:
        snapped = [(fname, _snapshot(st)) for fname, st in writes]
        ASYNC_SAVER.submit(lambda: write(snapped))
    else:
        write(writes)
    return path


def _world(engine) -> int:
    return (engine.dp_world_size * engine.mp_world_size
            * engine.pp_world_size * engine.sp_world_size)


def _barrier(engine) -> None:
    if _world(engine) > 1:
        dist.barrier()


def _remove_stale(engine, path: str) -> None:
    """Drop the model-state and ZeRO-3 shard files that an earlier save of
    the same tag at another topology or stage left (the JAX
    ``_publish``): a reader following ``latest`` must never pick one up.
    The flat ZeRO partition files need not: a restore reads the
    partition count their header records."""
    mp, dp, pp = (engine.mp_world_size, engine.dp_world_size,
                  engine.pp_world_size)
    expected = {os.path.basename(model_file(path, "", m, s, pp))
                for s in range(pp) for m in range(mp)}
    if engine.zero3:
        expected |= {ZERO3_FILE.format(dp=d, row=row)
                     for d in range(dp) for row in range(mp * pp)}
    for f in os.listdir(path):
        if ((f.endswith("_model_states.pt") or f.startswith("zero3_dp_rank_"))
                and f not in expected):
            os.remove(os.path.join(path, f))


def _publish(engine, save_dir: str, tag: str) -> None:
    """Point ``latest`` at ``tag`` once every rank has written its files
    (rank 0: stale files of the tag removed, then a temporary file, made
    durable, renamed over the old pointer); no rank returns before the
    pointer is visible."""
    _barrier(engine)
    if engine.global_rank == 0:
        _remove_stale(engine, os.path.join(save_dir, tag))
        latest = os.path.join(save_dir, LATEST_FILE)
        tmp = latest + ".tmp"
        with open(tmp, "w") as f:
            f.write(tag)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, latest)
    _barrier(engine)


# ------------------------------------------------------------ loading

def _module_tree(load_dir: str, tag: Optional[str], specs, pipe_specs=None,
                 plan: Optional["_RestorePlan"] = None):
    """``(tag, global module tree of CPU tensors)``, or None."""
    ASYNC_SAVER.wait()
    read = _read_model_state(load_dir, tag)
    if read is None:
        return None
    tag, state = read
    return tag, _combined(
        [s["module"] for s in _all_states(load_dir, tag, state)], specs,
        pipe_specs, _saved_mp(state), plan or _RestorePlan.from_engine(None))


def load_module_tree(load_dir: str, tag: Optional[str] = None, specs=None,
                     pipe_specs=None):
    """The checkpoint's module (a global JAX-layout tree of CPU tensors)
    without an engine: the pretrain -> fine-tune transfer read.  A save at
    mp > 1 needs ``specs``, the saving model's ``partition_specs()``, and
    one at pp > 1 ``pipe_specs``, its ``pipe_specs()``.  None when there
    is no checkpoint under ``load_dir``."""
    read = _module_tree(load_dir, tag, specs, pipe_specs)
    return None if read is None else read[1]


def load_params_only(load_dir: str, tag: Optional[str] = None, dtype=None,
                     specs=None, pipe_specs=None, threads: int = 0,
                     readahead_mb: float = 256.0,
                     io_retries: int = IO_RETRIES):
    """``(tag, tree)``: the module only (global, as ``load_module_tree``),
    as CPU tensors, floating leaves cast to ``dtype`` when given, streamed
    through the parallel reader (``threads`` readers, 0: auto); the
    optimizer state and the ZeRO partition files stay unread.  None when
    there is no checkpoint."""
    plan = _RestorePlan(threads or _RestorePlan.auto_threads(),
                        readahead_mb, io_retries)
    read = _module_tree(load_dir, tag, specs, pipe_specs, plan)
    if read is None:
        return None

    def leaf(t):
        return t.to(dtype) if dtype is not None and t.is_floating_point() \
            else t
    return read[0], _map_leaves(read[1], leaf)


def _map_leaves(tree, fn):
    if isinstance(tree, dict):
        return {k: _map_leaves(v, fn) for k, v in tree.items()}
    return fn(tree)


@torch.no_grad()
def _copy_into(dst: torch.Tensor, src, name: str,
               retries: int = IO_RETRIES) -> None:
    if tuple(src.shape) != tuple(dst.shape):
        raise ValueError(
            f"checkpoint restore: {name} has shape {tuple(src.shape)}, the "
            f"engine expects {tuple(dst.shape)}")
    dst.copy_(to_tensor(src, dst.device, retries))


def _flat_pairs(dst: dict, tree, what: str) -> list:
    """``(tensor, source leaf, name)`` for each leaf of a loaded
    JAX-layout tree and its engine tensor in ``{dotted name: tensor}``."""
    flat = weights_mod.flatten_tree(tree)
    missing, extra = set(dst) - set(flat), set(flat) - set(dst)
    if missing or extra:
        raise KeyError(f"checkpoint {what} names differ from the engine's: "
                       f"missing {sorted(missing)}, unexpected "
                       f"{sorted(extra)}")
    return [(t, flat[name], f"{what}.{name}") for name, t in dst.items()]


@torch.no_grad()
def _rederive_masters(engine) -> None:
    """fp32 masters from the module's parameters (where they are not the
    same tensors, as in fp32); under ZeRO the owned partition of the flat
    parameters."""
    if engine.zero_flat:
        lo, part = engine._owned_range()
        engine.master_flat.copy_(engine._params_flat[lo:lo + part])
        return
    for name, p in engine.module.named_parameters():
        m = engine.master[name]
        if m.data_ptr() != p.data_ptr():
            m.copy_(p)


def _zero3_local(engine, tree):
    """Under ZeRO-3, this data rank's shards of a model-local ``tree``
    (CPU tensors; a memmap leaf reads only the shard); ``tree`` itself
    otherwise."""
    if tree is None or not engine.zero3:
        return tree
    dims, dp, r = engine._zero3_dims, engine.dp_world_size, \
        engine.topology.dp_rank

    def one(name, leaf):
        dim = dims.get(name, -1)
        if dim < 0:
            return leaf
        if isinstance(leaf, torch.Tensor):
            return zero3_mod.shard(leaf, dim, dp, r)
        lz = LazyParts.wrap(leaf)
        shape = list(lz.shape)
        shape[dim] //= dp
        return lz.map(lambda t: zero3_mod.shard(t, dim, dp, r).contiguous(),
                      shape)

    return weights_mod.unflatten_tree({
        k: one(k, v) for k, v in weights_mod.flatten_tree(tree).items()})


def _local(engine, tree):
    """The engine's (stage, model rank) cut of a global ``tree``."""
    return weights_mod.local_tree(
        tree, engine._param_specs, engine.mp_world_size, engine.mp_rank,
        engine._pipe_specs, engine.pp_world_size, engine.pp_rank)


def init_from_module_tree(engine, module) -> tuple:
    """Copy same-named, same-shaped leaves of ``module`` (a global tree)
    into the engine's parameters (the pretrain -> fine-tune start; a new
    task head keeps its init), cut to the engine's stage and model rank
    first, and re-derive the masters from them.  Returns ``(loaded,
    skipped)``: the engine's leaf paths in the JAX key form
    (``"['blocks']['qkv_w']"``)."""
    from deepspeed_tpu_torch.engine import _keystr
    module = _local(engine, module)
    src = weights_mod.flatten_tree(_zero3_local(engine, module))
    loaded, skipped = [], []
    for name, p in engine.module.named_parameters():
        new = src.get(name)
        if new is not None and tuple(new.shape) == tuple(p.shape):
            _copy_into(p.data, new, name)
            loaded.append(_keystr(name))
        else:
            skipped.append(_keystr(name))
    _rederive_masters(engine)
    return loaded, skipped


def load_checkpoint(engine, load_dir: str, tag: Optional[str] = None,
                    load_optimizer_states: bool = True,
                    load_lr_scheduler_states: bool = True):
    """Restore ``engine`` from ``load_dir`` (``tag``, default the one
    ``latest`` names).  Returns ``(path, client_state)``, or ``(None,
    None)`` when nothing is found.  With ``load_optimizer_states`` False
    (or a checkpoint without them) the masters are re-derived from the
    loaded module, so the next step cannot revert it.  Every leaf (the
    module, the masters and moments, or this rank's ZeRO partition
    regions) streams through ONE read plan (``_RestorePlan.from_engine``):
    ``checkpoint.restore_threads`` readers, ``restore_readahead_mb`` in
    flight, ``resilience.io_retries`` per read."""
    ASYNC_SAVER.wait()
    plan = _RestorePlan.from_engine(engine)
    read = _read_model_state(load_dir, tag)
    if read is None:
        return None, None
    tag, state = read
    saved_stage = int(state.get("zero_stage",
                                1 if state.get("zero_enabled") else 0))
    saved_mp, mp = _saved_mp(state), engine.mp_world_size
    saved_pp, pp = _saved_pp(state), engine.pp_world_size
    if load_optimizer_states:
        if engine.zero_flat and saved_stage in (1, 2) and (
                saved_mp != mp or saved_pp != pp):
            raise ValueError(
                f"zero checkpoint was saved with model_parallel_size="
                f"{saved_mp}, pipeline_parallel_size={saved_pp}; engine has "
                f"mp={mp}, pp={pp}: ZeRO flat partitions are per-stage/shard "
                f"and cannot be re-split (load with "
                f"load_optimizer_states=False for a weights-only restore)")
        if engine.zero_flat and saved_stage == 3:
            raise ValueError(
                "checkpoint was saved at ZeRO stage 3 (optimizer state "
                "inline, per-leaf) but this engine runs the stage-1/2 flat "
                "layout — set zero_optimization.stage=3 (or 0) to restore "
                "it, or pass load_optimizer_states=False")
        if not engine.zero_flat and saved_stage in (1, 2):
            raise ValueError(
                "checkpoint was saved with zero_optimization stage 1/2 (its "
                "optimizer state lives in zero_pp_rank_* shards) but this "
                "engine runs no flat ZeRO layout — match the stage, or pass "
                "load_optimizer_states=False for a weights-only load")

    engine.global_steps = int(state["global_steps"])
    engine.skipped_steps = int(state["skipped_steps"])
    engine.micro_steps = int(state["micro_steps"])
    old_ls = engine.loss_scale_state._asdict()
    engine.loss_scale_state = prec.LossScaleState(**{
        k: to_tensor(np.asarray(v), old_ls[k].device, plan.io_retries).to(
            old_ls[k].dtype)
        for k, v in state["loss_scale_state"].items()})
    for live, saved in zip(engine.optimizer.param_groups,
                           state.get("param_groups", [])):
        live.update(saved)
    if (load_lr_scheduler_states and engine.lr_scheduler is not None
            and state.get("lr_scheduler") is not None
            and hasattr(engine.lr_scheduler, "load_state_dict")):
        engine.lr_scheduler.load_state_dict(state["lr_scheduler"])

    if saved_mp == mp and saved_pp == pp:
        # this (stage, model rank)'s own file
        if _row(engine):
            state = _read_state(load_dir, tag, _row(engine), mp, pp)
        local = lambda get: _zero3_local(engine, get(state))
    else:
        # every saved (stage, model rank)'s file, combined and cut for
        # this rank
        states = _all_states(load_dir, tag, state)

        def local(get):
            if get(states[0]) is None:
                return None
            return _zero3_local(engine, _local(engine, _combined(
                [get(s) for s in states], engine._param_specs,
                engine._pipe_specs, saved_mp, plan)))

    pairs = _flat_pairs(dict(engine.module.named_parameters()),
                        local(lambda s: s["module"]), "module")
    opt = state.get("optimizer")
    step = None
    if load_optimizer_states and engine.zero_flat:
        zpairs, step = _zero_checkpoint_pairs(engine, load_dir, tag)
        pairs += zpairs
    elif load_optimizer_states and opt is not None:
        pairs += _flat_pairs(engine.master,
                             local(lambda s: s["optimizer"]["master"]),
                             "optimizer.master")
        saved = {key: local(lambda s, key=key:
                            s["optimizer"]["opt_state"][key])
                 for key in ("m", "v")}
        for key in ("m", "v"):
            live = getattr(engine.opt_state, key)
            if (live is None) != (saved[key] is None):
                raise ValueError(
                    f"checkpoint optimizer moment {key!r} is "
                    f"{'absent' if saved[key] is None else 'present'}, the "
                    f"engine's optimizer "
                    f"{'has' if live is not None else 'has none'}")
            if live is not None:
                pairs += _flat_pairs(live, saved[key],
                                     f"optimizer.opt_state.{key}")
        step = opt["opt_state"]["step"]
    _place(pairs, plan)
    if load_optimizer_states and engine.zero_flat:
        engine.opt_state.step = int(np.asarray(step))
        engine._params_from_master_flat()
    elif step is not None:
        engine.opt_state.step = int(np.asarray(step))
    else:
        _rederive_masters(engine)
    return os.path.join(load_dir, tag), state.get("client_state", {})


@torch.no_grad()
def _zero_checkpoint_pairs(engine, load_dir: str, tag: str):
    """``(pairs, step)``: this rank's partition of its model rank's flat
    fp32 master and moments, as ``(destination slice, region, name)``
    reads of at most ``REGION_BYTES`` from the partition files of a save
    at ANY data-parallel size, re-padded for the engine's layout (the
    padding zeroed here), and the saved step.  The caller places the
    pairs and re-derives the compute-dtype parameters (the JAX package's
    ``_load_zero_checkpoint``).  A save at another model or pipeline
    parallel size raises."""
    meta = engine.flat_meta
    mp, pp, row = engine.mp_world_size, engine.pp_world_size, _row(engine)
    first = zero_file(load_dir, tag, 0, row)
    if not os.path.exists(first):
        raise FileNotFoundError(
            f"no zero checkpoint shards under {load_dir}/{tag}")
    shard0 = _load_obj(first)
    saved_mp = int(shard0.get("mp_world_size", 1))
    saved_pp = int(shard0.get("pp_world_size", 1))
    if saved_mp != mp or saved_pp != pp:
        raise ValueError(
            f"zero checkpoint was saved with model_parallel_size="
            f"{saved_mp}, pipeline_parallel_size={saved_pp}; engine has "
            f"mp={mp}, pp={pp}: ZeRO flat partitions are per-stage/shard "
            f"and cannot be re-split (load with load_optimizer_states=False "
            f"for a weights-only restore)")
    # the recorded partition count, not the files present: a stale shard
    # of an earlier save of the same tag at a larger dp must be ignored
    saved_dp = int(shard0.get("partition_count", shard0["dp_world_size"]))
    total = int(shard0["unpadded_total"])
    if total != meta.total:
        raise ValueError(
            f"zero checkpoint has {total} elements, engine expects "
            f"{meta.total} (different model?)")
    shards = [shard0] + [_load_obj(zero_file(load_dir, tag, r, row))
                         for r in range(1, saved_dp)]
    starts = np.cumsum([0] + [len(sh["master"]) for sh in shards])
    if starts[-1] != total:
        raise ValueError(f"zero checkpoint partitions hold {starts[-1]} "
                         f"elements, their header says {total}")
    lo, part = engine._owned_range()
    hi = min(lo + part, total)
    live = {"master": engine.master_flat, "m": engine.opt_state.m["flat"],
            "v": engine.opt_state.v["flat"]}
    step_elems = max(1, REGION_BYTES // 4)
    pairs = []
    for key, dst in live.items():
        if hi - lo < part:
            dst[max(hi - lo, 0):].zero_()
        for r, (sh, s0) in enumerate(zip(shards, starts[:-1])):
            src = sh[key]
            s, e = max(lo, s0), min(hi, s0 + len(src))
            for a in range(s, e, step_elems):
                b = min(e, a + step_elems)
                pairs.append((dst[a - lo:b - lo],
                              _Region(src, a - s0, b - s0),
                              f"zero partition {r} {key}[{a - s0}:{b - s0}]"))
    return pairs, shard0["step"]
