"""Collectives with the reference's communication knobs.

The port of ``deepspeed_tpu/parallel/comm.py``.  Each function takes a
``torch.distributed`` process group where the JAX function takes a mesh
axis name; ``group=None`` means no process group (one process), where a
reduction is the identity and a gather returns its input.  The knob
semantics are the JAX package's, which are the reference's
``allreduce_bucket`` (deepspeed_light.py:819-849): ``fp32_allreduce``
upcasts before the sum, ``prescale_gradients`` divides by
``gradient_predivide_factor`` before and by ``world / predivide`` after,
and the default divides by the world size after.  ``scaled_reduce`` is the
one owner of that order.

Reductions work IN PLACE where they can: the tensor handed to
``scaled_reduce`` or ``allreduce_grads`` may be overwritten (the engine
hands over its own accumulators).  A division by 1 is skipped, since it
changes no bit.

Partition layout (ZeRO): a flat ``[padded]`` buffer is ``pps``
partitions of ``padded / pps`` elements, rank ``r`` of a partition group
owning partition ``r``; with ``partition_group_size`` (``pps``) below the
world size the ranks form ``dp / pps`` consecutive blocks
(``subgroup_index_groups``), each holding every partition once, and a
rank's ``subgroups`` are its ``(within, across)`` groups
(``topology.Topology``).

ZeRO-3: ``all_gather_dims`` and ``reduce_scatter_dims`` gather and
reduce-scatter leaves along an arbitrary dim, one flat collective per
dtype (``zero3.gather_leaves`` is their autograd pair).  A CUDA tensor on
a gloo group (two ranks on one card) stages through host memory.

Model axis (tensor parallelism): ``copy_to_model`` (identity forward,
all-reduce backward) and ``reduce_from_model`` (all-reduce forward,
identity backward) are Megatron's pair of autograd functions, which give
every leaf its true gradient on every model rank; ``model_max_`` and
``model_sum_`` are the gradient-free reductions of the vocab-parallel
cross-entropy and of the engine's norm and overflow agreement.
``torch.distributed.nn.functional.all_reduce`` is neither: its backward
all-reduces again.

Pipe axis (``parallel/pipeline.py``): ``pipe_isend`` and ``pipe_recv``
move one activation or gradient between two stages (the JAX ``ppermute``
over ``pipe``), the scatter of the finished micro-batches' row slices to
the stages and the gather of their gradients back being such sends too;
``sum_fp32_`` over the pipe group is the SUM of the stage-replicated
leaves' gradients (the JAX ``psum`` over ``pipe``), as one fp32
collective.  The
schedules call them in an order fixed by the schedule, not by autograd,
so they are plain functions and not an autograd pair.  A message's
``tag`` names its kind (activation, gradient, head slice, head gradient),
so that two kinds on one pair of stages never match each other.

Seq axis (context parallelism, ``models/ring_attention.py`` and
``models/ulysses.py``): ``seq_ring_shift`` (send to the next rank of the
ring, receive from the previous; the JAX ``ppermute`` with ``perm = [(j,
(j + 1) % sp)]``) and ``seq_all_to_all`` (the JAX ``all_to_all(...,
tiled=True)``) are autograd functions whose backward is the transpose of
the forward: the shift the other way, the inverse exchange.  Every rank of
a seq group runs the same graph, so each rank's backward meets its peers'
in the same order.  ``seq_all_gather`` (the padding mask) and ``seq_sum_``
(the loss's valid-token count) carry no gradient.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist


def _through_host(x: torch.Tensor, group) -> bool:
    """Whether a collective of ``x`` over ``group`` stages through host
    memory: a CUDA tensor on a gloo group (two ranks sharing one card,
    which NCCL refuses), whose backend may lack the CUDA form of the
    collective."""
    return x.is_cuda and dist.get_backend(group) == "gloo"


def _reduce_scatter(out: torch.Tensor, x: torch.Tensor, group) -> None:
    """Sum ``x`` over ``group``, keeping this rank's chunk in ``out``
    (``reduce_scatter_single`` where the installed torch has it)."""
    fn = getattr(dist, "reduce_scatter_single", None)
    if fn is None:
        fn = dist.reduce_scatter_tensor
    if _through_host(x, group):
        host = torch.empty(out.shape, dtype=out.dtype)
        fn(host, x.cpu(), group=group)
        out.copy_(host)
        return
    fn(out, x, group=group)


def _all_gather(out: torch.Tensor, x: torch.Tensor, group,
                async_op: bool = False):
    """Gather every rank's ``x`` of ``group`` into ``out``, in rank order
    (``all_gather_single`` where the installed torch has it).  With
    ``async_op`` returns a callable that waits and finishes the copy."""
    fn = getattr(dist, "all_gather_single", None)
    if fn is None:
        fn = dist.all_gather_into_tensor
    host = _through_host(x, group)
    dst = torch.empty(out.shape, dtype=out.dtype) if host else out
    src = x.cpu() if host else x
    work = fn(dst, src, group=group, async_op=async_op)

    def finish(_staged=src):              # the input lives until the wait
        if work is not None:
            work.wait()
        if host:
            out.copy_(dst)
    if async_op:
        return finish
    finish()
    return None


class PendingGather:
    """An issued ``all_gather_dims``: ``wait()`` returns the gathered
    leaves (once)."""

    def __init__(self, finish):
        self._finish, self._out = finish, None

    def wait(self) -> list:
        if self._out is None:
            self._out = self._finish()
        return self._out


def gathered_shape(shape, dim: int, world: int) -> tuple:
    shape = list(shape)
    shape[dim] *= world
    return tuple(shape)


def all_gather_dims(shards: Sequence[torch.Tensor], dims: Sequence[int],
                    group, async_op: bool = False) -> PendingGather:
    """All-gather each of ``shards`` along its dim ``dims[i]`` over
    ``group``, rank r's shard at block r of that dim (the JAX
    ``all_gather(..., axis=dim, tiled=True)``).  Leaves of one dtype go as
    ONE flat collective (a gather is exact, so coalescing changes no
    bit).  ``async_op`` issues it now and finishes it at ``wait()``."""
    world = dist.get_world_size(group)
    by_dtype = {}
    for i, s in enumerate(shards):
        by_dtype.setdefault(s.dtype, []).append(i)
    finishes = []
    for idx in by_dtype.values():
        flat = torch.cat([shards[i].reshape(-1) for i in idx])
        buf = torch.empty(world * flat.numel(), dtype=flat.dtype,
                          device=flat.device)
        finishes.append((idx, buf, _all_gather(buf, flat, group,
                                               async_op=True)))

    def finish():
        out = [None] * len(shards)
        for idx, buf, done in finishes:
            done()
            rows, off = buf.view(world, -1), 0
            for i in idx:
                s, d = shards[i], dims[i]
                n = s.numel()
                blocks = rows[:, off:off + n].unflatten(1, s.shape)
                out[i] = blocks.movedim(0, d).reshape(
                    gathered_shape(s.shape, d, world))
                off += n
        return out
    pending = PendingGather(finish)
    if not async_op:
        pending.wait()
    return pending


def reduce_scatter_dims(grads: Sequence[torch.Tensor], dims: Sequence[int],
                        group) -> list:
    """SUM each of ``grads`` over ``group`` and keep this rank's block
    along its dim ``dims[i]`` (the transpose of ``all_gather_dims``), in
    the gradients' dtype, with no division.  Leaves of one dtype go as
    one flat collective: the sums are elementwise."""
    world = dist.get_world_size(group)
    out = [None] * len(grads)
    by_dtype = {}
    for i, g in enumerate(grads):
        by_dtype.setdefault(g.dtype, []).append(i)
    for idx in by_dtype.values():
        shapes = []
        for i in idx:
            shape = list(grads[i].shape)
            shape[dims[i]] //= world
            shapes.append(shape)
        sizes = [math.prod(s) for s in shapes]
        g0 = grads[idx[0]]
        rows = torch.empty((world, sum(sizes)), dtype=g0.dtype,
                           device=g0.device)
        off = 0
        for i, shape, n in zip(idx, shapes, sizes):
            d = dims[i]
            blocks = grads[i].unflatten(d, (world, shape[d])).movedim(d, 0)
            rows[:, off:off + n].unflatten(1, shape).copy_(blocks)
            off += n
        mine = torch.empty(sum(sizes), dtype=g0.dtype, device=g0.device)
        _reduce_scatter(mine, rows.view(-1), group)
        off = 0
        for i, shape, n in zip(idx, shapes, sizes):
            out[i] = mine[off:off + n].view(shape)
            off += n
    return out


def _in_place(g: torch.Tensor, fp32_allreduce: bool) -> bool:
    """Whether ``scaled_reduce`` reduces ``g`` in place (no upcast)."""
    return not (fp32_allreduce and g.dtype != torch.float32)


def _sum_over(group):
    """In-place SUM all-reduce over ``group`` (identity without one)."""
    def reduce_fn(x):
        if group is not None:
            dist.all_reduce(x, group=group)
        return x
    return reduce_fn


def scaled_reduce(g: torch.Tensor, reduce_fn, world_size: int,
                  fp32_allreduce: bool = False,
                  prescale_gradients: bool = False,
                  gradient_predivide_factor: float = 1.0) -> torch.Tensor:
    """The reference's scaling envelope around any sum-reduction
    ``reduce_fn`` (which may return a new tensor, as a reduce-scatter
    does, or reduce in place):

    * ``fp32_allreduce``: upcast before the reduce, cast back after;
    * prescale: divide by ``gradient_predivide_factor`` before the reduce,
      then by ``world / predivide`` after;
    * postscale (default): reduce, then divide by the world size.

    ``g`` itself may be overwritten."""
    orig_dtype = g.dtype
    if fp32_allreduce and g.dtype != torch.float32:
        g = g.float()
    if prescale_gradients:
        if gradient_predivide_factor != 1.0:
            g.div_(gradient_predivide_factor)
        g = reduce_fn(g)
        if gradient_predivide_factor != world_size:
            g.div_(world_size / gradient_predivide_factor)
    else:
        g = reduce_fn(g)
        if world_size != 1:
            g.div_(world_size)
    if g.dtype != orig_dtype:
        g = g.to(orig_dtype)
    return g


def allreduce_grads(grads, group, world_size: int,
                    fp32_allreduce: bool = False,
                    prescale_gradients: bool = False,
                    gradient_predivide_factor: float = 1.0,
                    bucket_elems: Optional[int] = None):
    """Sum-reduce a ``{name: grad}`` dict over ``group`` and average
    (knobs as ``scaled_reduce``); returns the reduced dict, whose tensors
    may be the inputs, reduced in place.  ``None`` grads stay None.

    ``bucket_elems`` (overlap_comm): a leaf larger than this reduces as
    128-aligned chunks of its flat view (``bucket_bounds``), each its own
    collective.  Chunking keeps every element's addends and their order,
    so it is bit-exact with the whole-leaf reduce."""
    knobs = dict(fp32_allreduce=fp32_allreduce,
                 prescale_gradients=prescale_gradients,
                 gradient_predivide_factor=gradient_predivide_factor)
    reduce_fn = _sum_over(group)

    def reduce_one(g):
        if g is None:
            return None
        if bucket_elems is not None and g.numel() > bucket_elems:
            flat = g.view(-1)
            parts = [scaled_reduce(flat[s:e], reduce_fn, world_size, **knobs)
                     for s, e in bucket_bounds(flat.numel(), bucket_elems)]
            if _in_place(g, fp32_allreduce):
                return g
            return torch.cat(parts).view(g.shape)
        return scaled_reduce(g, reduce_fn, world_size, **knobs)

    return {k: reduce_one(g) for k, g in grads.items()}


def bucket_bounds(total: int, bucket_elems: int,
                  align: int = 128) -> Tuple[Tuple[int, int], ...]:
    """Contiguous ``(start, stop)`` slices covering ``[0, total)``, each
    of at most ``max(bucket_elems, align)`` elements, every boundary a
    multiple of ``align`` (the ZeRO partition is 128-padded, so a bucket
    of fp32 starts 512-byte aligned).  One bucket when ``bucket_elems >=
    total``."""
    if total <= 0:
        return ((0, total),)
    step = max(align, (int(bucket_elems) // align) * align)
    return tuple((s, min(s + step, total)) for s in range(0, total, step))


def subgroup_index_groups(world_size: int, group_size: int):
    """Rank lists of the ZeRO parameter-parallel sub-groups (reference
    deepspeed_light.py:63-77):

    * ``within``: consecutive blocks of ``group_size`` ranks, the partition
      owners (``[[0..g-1], [g..2g-1], ...]``);
    * ``across``: the ranks holding the same partition in different blocks
      (``[[p, p+g, p+2g, ...] for p in range(g)]``)."""
    repl = world_size // group_size
    within = [list(range(b * group_size, (b + 1) * group_size))
              for b in range(repl)]
    across = [[p + b * group_size for b in range(repl)]
              for p in range(group_size)]
    return within, across


def _partition_groups(group, world_size, partition_group_size, subgroups):
    """``(scatter group, its size, across group or None)``."""
    pps = world_size if partition_group_size is None else int(
        partition_group_size)
    if pps == world_size:
        return group, pps, None
    if subgroups is None:
        raise ValueError(f"partition_group_size={pps} < world size "
                         f"{world_size} needs this rank's (within, across) "
                         f"subgroups")
    return subgroups[0], pps, subgroups[1]


def _scatter_fn(scatter_group, pps, across, across_subgroups, out=None):
    """A reduce-scatter over ``scatter_group`` into ``out`` (a new tensor
    when None), then the sum across sub-groups when asked."""
    def reduce_fn(x):
        dst = out if out is not None else torch.empty(
            x.numel() // pps, dtype=x.dtype, device=x.device)
        if scatter_group is None:
            dst.copy_(x.reshape(-1))
        else:
            _reduce_scatter(dst, x.reshape(-1), scatter_group)
        if across is not None and across_subgroups:
            dist.all_reduce(dst, group=across)
        return dst
    return reduce_fn


def reduce_scatter_grads(flat_grad: torch.Tensor, group, world_size: int,
                         fp32_allreduce: bool = False,
                         prescale_gradients: bool = False,
                         gradient_predivide_factor: float = 1.0,
                         partition_group_size: Optional[int] = None,
                         across_subgroups: bool = True,
                         subgroups=None) -> torch.Tensor:
    """Reduce-scatter a flat ``[padded]`` gradient over ``group``,
    returning this rank's ``[padded / pps]`` partition (knobs as
    ``scaled_reduce``).  ``flat_grad`` may be overwritten (the prescale
    divides it in place).

    With ``partition_group_size`` g < world the scatter runs within this
    rank's block of g ranks and the partial sums then add up across the
    blocks, so every rank ends with the fully reduced gradient of its
    partition.  ``across_subgroups=False`` leaves that cross-block sum to
    one ``finish_subgroup_reduce`` at the boundary (ZeRO-2 accumulates
    several scatters first)."""
    scatter_group, pps, across = _partition_groups(
        group, world_size, partition_group_size, subgroups)
    return scaled_reduce(
        flat_grad, _scatter_fn(scatter_group, pps, across, across_subgroups),
        world_size, fp32_allreduce=fp32_allreduce,
        prescale_gradients=prescale_gradients,
        gradient_predivide_factor=gradient_predivide_factor)


def reduce_scatter_grads_bucketed(flat_grad: torch.Tensor, group,
                                  world_size: int,
                                  bounds: Sequence[Tuple[int, int]],
                                  fp32_allreduce: bool = False,
                                  prescale_gradients: bool = False,
                                  gradient_predivide_factor: float = 1.0,
                                  partition_group_size: Optional[int] = None,
                                  across_subgroups: bool = True,
                                  subgroups=None) -> torch.Tensor:
    """Bucketed ``reduce_scatter_grads`` (overlap_comm): the flat
    ``[padded]`` gradient is viewed as ``[pps, partition]`` (row r = the
    partition rank r owns) and each column bucket ``[pps, s:e]`` of
    ``bounds`` (slices of the partition) reduce-scatters as its own
    collective into ``partition[s:e]``.

    Bit-exact with the serial scatter: element ``(r, s + j)`` of the view
    is flat element ``r * partition + s + j``, so each bucket reduces the
    same addends onto the same owner as the whole scatter does, and the
    buckets' outputs, written in place, are the rank's contiguous
    partition."""
    scatter_group, pps, across = _partition_groups(
        group, world_size, partition_group_size, subgroups)
    part = flat_grad.numel() // pps
    flat2d = flat_grad.view(pps, part)
    direct = _in_place(flat_grad, fp32_allreduce)
    out = torch.empty(part, dtype=flat_grad.dtype, device=flat_grad.device)
    for s, e in bounds:
        # a [pps, w] column block is contiguous only for one row
        block = flat2d[:, s:e] if pps == 1 else flat2d[:, s:e].contiguous()
        res = scaled_reduce(
            block, _scatter_fn(scatter_group, pps, across, across_subgroups,
                               out[s:e] if direct else None),
            world_size, fp32_allreduce=fp32_allreduce,
            prescale_gradients=prescale_gradients,
            gradient_predivide_factor=gradient_predivide_factor)
        if res.data_ptr() != out[s:].data_ptr():
            out[s:e].copy_(res)
    return out


def allgather_partition_bucket(bucket: torch.Tensor, group,
                               world_size: Optional[int] = None,
                               partition_group_size: Optional[int] = None,
                               subgroups=None,
                               out: Optional[torch.Tensor] = None
                               ) -> torch.Tensor:
    """All-gather ONE updated bucket (a ``[w]`` slice of the owned
    partition) into its ``[pps, w]`` block: row r is rank r's slice, so
    block element ``(r, j)`` is flat element ``r * partition + s + j`` of
    the serial gather's layout.  Written into ``out`` when given."""
    gather_group, pps, _ = _partition_groups(
        group, world_size or 1, partition_group_size, subgroups)
    if out is None:
        out = torch.empty((pps, bucket.numel()), dtype=bucket.dtype,
                          device=bucket.device)
    if gather_group is None:
        out.view(-1).copy_(bucket)
    else:
        _all_gather(out.view(-1), bucket, gather_group)
    return out


def finish_subgroup_reduce(partition: torch.Tensor, world_size: int,
                           partition_group_size: int,
                           subgroups=None) -> torch.Tensor:
    """The deferred cross-sub-group sum of ``reduce_scatter_grads(...,
    across_subgroups=False)``, run once on the accumulated partition (in
    place)."""
    if partition_group_size == world_size:
        return partition
    dist.all_reduce(partition, group=subgroups[1])
    return partition


def allgather_params(partition: torch.Tensor, group,
                     world_size: Optional[int] = None,
                     partition_group_size: Optional[int] = None,
                     subgroups=None,
                     out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Gather the updated partitions of the partition group into one flat
    ``[pps * partition]`` buffer (the ZeRO weight all-gather, reference
    zero_optimizer.py:397-432); within this rank's block when
    ``partition_group_size`` < world.  Written into ``out`` when given."""
    gather_group, pps, _ = _partition_groups(
        group, world_size or 1, partition_group_size, subgroups)
    if out is None:
        out = torch.empty(pps * partition.numel(), dtype=partition.dtype,
                          device=partition.device)
    if gather_group is None:
        out.copy_(partition)
    else:
        _all_gather(out, partition, gather_group)
    return out


def overflow_any(local_overflow, group) -> torch.Tensor:
    """MAX all-reduce of the overflow flag so every rank agrees (reference
    deepspeed_utils.py:62-75); returns a bool tensor on the flag's device
    (no host read)."""
    f = torch.as_tensor(local_overflow).to(torch.float32).reshape(1)
    if group is not None:
        dist.all_reduce(f, op=dist.ReduceOp.MAX, group=group)
    return f[0] > 0


# -------------------------------------------------------------- pipe axis

class PendingSend:
    """An issued ``pipe_isend``: ``wait()`` blocks until the peer has the
    data.  It keeps the staged host copy alive until then."""

    def __init__(self, work, staged):
        self._work, self._staged = work, staged

    def wait(self) -> None:
        if self._work is not None:
            self._work.wait()
        self._work = self._staged = None


def pipe_isend(x: torch.Tensor, dst: int, group, tag: int) -> PendingSend:
    """Send ``x`` to global rank ``dst`` of ``group`` without blocking; a
    CUDA tensor on a gloo group goes through a host copy."""
    src = x.detach().contiguous()
    if _through_host(src, group):
        src = src.cpu()
    return PendingSend(dist.isend(src, dst, group=group, tag=tag), src)


def pipe_recv(shape, dtype, device, src: int, group,
              tag: int) -> torch.Tensor:
    """Receive a ``shape``/``dtype`` tensor from global rank ``src`` of
    ``group`` (blocking), on ``device``."""
    out = torch.empty(tuple(shape), dtype=dtype, device=device)
    host = _through_host(out, group)
    buf = torch.empty(out.shape, dtype=dtype) if host else out
    dist.recv(buf, src, group=group, tag=tag)
    if host:
        out.copy_(buf)
    return out


def sum_fp32_(tensors: Sequence[torch.Tensor], group) -> None:
    """In-place SUM of each of ``tensors`` over ``group`` (identity
    without one), as one fp32 collective: the leaves are laid end to end
    and each is written back in its own dtype (one fp32 tensor is reduced
    where it is)."""
    if group is None or not tensors:
        return
    if len(tensors) == 1 and tensors[0].dtype == torch.float32 \
            and tensors[0].is_contiguous():
        dist.all_reduce(tensors[0], group=group)
        return
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    dist.all_reduce(flat, group=group)
    off = 0
    for t in tensors:
        n = t.numel()
        t.copy_(flat[off:off + n].view(t.shape))
        off += n


# ------------------------------------------------------------- model axis

def model_sum_(x: torch.Tensor, group) -> torch.Tensor:
    """In-place SUM of ``x`` over the model group (identity without one);
    no gradient."""
    if group is not None:
        dist.all_reduce(x, group=group)
    return x


def model_max_(x: torch.Tensor, group) -> torch.Tensor:
    """In-place MAX of ``x`` over the model group (identity without one);
    no gradient."""
    if group is not None:
        dist.all_reduce(x, op=dist.ReduceOp.MAX, group=group)
    return x


class _CopyToModel(torch.autograd.Function):
    """Identity forward; the backward sums the input's gradient over the
    model group (each rank's branch saw only its shard)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return model_sum_(g.contiguous().clone(), ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    """SUM over the model group forward; identity backward (the sum's
    gradient reaches every rank's partial unchanged)."""

    @staticmethod
    def forward(ctx, x, group):
        return model_sum_(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` entering a model-sharded branch (a column-parallel input, the
    tied LM head); ``x`` itself without a group."""
    return x if group is None else _CopyToModel.apply(x, group)


def reduce_from_model(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of the ranks' partials ``x`` (a row-parallel product, a
    vocab-parallel lookup); ``x`` itself without a group."""
    return x if group is None else _ReduceFromModel.apply(x, group)


# --------------------------------------------------------------- seq axis

#: the tags of the ring's point-to-point messages (a forward shift, the
#: backward's shift the other way)
_SEQ_FWD, _SEQ_BWD = 16, 17


def _seq_peers(group):
    """``(rank in group, size, global ranks by group rank)``."""
    ranks = dist.get_process_group_ranks(group)
    return dist.get_rank(group), len(ranks), ranks


def _shift(x: torch.Tensor, group, step: int, tag: int) -> torch.Tensor:
    """Send ``x`` to the rank ``step`` places on in the ring and receive
    the tensor of the rank ``step`` places back (non-blocking send first,
    so every rank can send before it receives)."""
    me, size, ranks = _seq_peers(group)
    pending = pipe_isend(x, ranks[(me + step) % size], group, tag)
    out = pipe_recv(x.shape, x.dtype, x.device, ranks[(me - step) % size],
                    group, tag)
    pending.wait()
    return out


class _SeqRingShift(torch.autograd.Function):
    """Rank r's tensor to rank r + 1 of the seq group; the backward sends
    the gradient back to rank r - 1 (the transpose of the ppermute)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _shift(x, group, 1, _SEQ_FWD)

    @staticmethod
    def backward(ctx, g):
        return _shift(g.contiguous(), ctx.group, -1, _SEQ_BWD), None


def seq_ring_shift(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` of the previous rank of the seq group's ring (rank ``(r - 1)
    % sp``), this rank's ``x`` going to rank ``(r + 1) % sp``; ``x``
    itself without a group."""
    return x if group is None else _SeqRingShift.apply(x, group)


def _all_to_all(x: torch.Tensor, split_dim: int, concat_dim: int,
                group) -> torch.Tensor:
    """``x`` cut into ``sp`` blocks along ``split_dim``, block j sent to
    rank j, and the blocks received joined along ``concat_dim`` in rank
    order (``all_to_all_single`` splits dim 0 only, so the split dim goes
    first)."""
    size = dist.get_world_size(group)
    blocks = x.movedim(split_dim, 0)
    blocks = blocks.reshape(size, blocks.shape[0] // size,
                            *blocks.shape[1:]).contiguous()
    host = _through_host(blocks, group)
    send = blocks.cpu() if host else blocks
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    if host:
        recv = recv.to(x.device)
    # [sp, ...x with the split dim cut...], then the sp blocks joined
    got = recv.movedim(1, split_dim + 1)
    return got.movedim(0, concat_dim).flatten(concat_dim, concat_dim + 1)


class _SeqAllToAll(torch.autograd.Function):
    """The tiled all-to-all; the backward is the inverse exchange."""

    @staticmethod
    def forward(ctx, x, split_dim, concat_dim, group):
        ctx.dims, ctx.group = (split_dim, concat_dim), group
        return _all_to_all(x, split_dim, concat_dim, group)

    @staticmethod
    def backward(ctx, g):
        split_dim, concat_dim = ctx.dims
        return (_all_to_all(g, concat_dim, split_dim, ctx.group), None, None,
                None)


def seq_all_to_all(x: torch.Tensor, split_dim: int, concat_dim: int,
                   group) -> torch.Tensor:
    """The JAX ``all_to_all(x, axis, split_dim, concat_dim, tiled=True)``
    over the seq group: ``x``'s ``split_dim`` cut into ``sp`` blocks,
    block j to rank j, the received blocks joined along ``concat_dim`` in
    rank order.  Differentiable; ``x`` itself without a group."""
    if group is None:
        return x
    return _SeqAllToAll.apply(x, split_dim, concat_dim, group)


@torch.no_grad()
def seq_all_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The ranks' ``x`` joined along ``dim`` in rank order (the JAX
    ``all_gather(..., tiled=True)``), without a gradient; ``x`` itself
    without a group."""
    if group is None:
        return x
    size = dist.get_world_size(group)
    src = x.movedim(dim, 0).contiguous()
    out = torch.empty((size, *src.shape), dtype=src.dtype, device=src.device)
    _all_gather(out.view(-1), src.view(-1), group)
    return out.flatten(0, 1).movedim(0, dim)


def seq_sum_(x: torch.Tensor, group) -> torch.Tensor:
    """In-place SUM of ``x`` over the seq group (identity without one); no
    gradient."""
    if group is not None:
        dist.all_reduce(x, group=group)
    return x
