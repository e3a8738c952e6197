"""ZeRO stage 3: parameter partitioning over the data-parallel group.

The port of ``deepspeed_tpu/zero3.py``:

* **Persistent layout.**  Every large parameter leaf is cut along one dim
  (``choose_dims``) on top of its tensor-parallel cut, so the
  compute-dtype parameters, the fp32 masters and the optimizer moments all
  persist at ``1/dp`` per rank, one tensor per leaf (no flat buffer).
* **Gather on use.**  The model gathers each layer's weights right before
  it uses them (``gather_leaves`` inside the block body of
  ``models/transformer.stack_apply``; the rest at entry,
  ``transformer.zero3_enter``).  The gather sits inside the remat wrapper,
  so under remat it replays in the backward and no gathered layer is kept
  for it.
* **Reduce-scatter in the backward.**  The gather is one autograd
  function whose backward reduce-scatters (SUMs) the gradient along the
  same dim, in the compute dtype, before any ``1/world``: the JAX
  transpose of ``all_gather(tiled=True)``.  The engine divides by the
  world size at the boundary (``deepspeed_tpu/engine.py:2135-2155``).
* **Elementwise update.**  Adam-family and Lion updates run on the local
  shards of (master, moments, grad); the global grad norm is one SUM of
  local squared sums with the replicated leaves weighted down
  (``local_sqnorm_and_finite``).

Dims are ``{dotted name: int}`` with ``REPLICATED`` (-1) for a leaf that
stays whole; specs are the model's ``partition_specs()`` flattened, the
dim sharded over the model group or None.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import torch

from deepspeed_tpu_torch.parallel import comm

#: leaves smaller than this stay replicated: gathering a small LayerNorm
#: vector costs more in latency than its shard saves in memory
DEFAULT_MIN_PARTITION_SIZE = 2 ** 10

REPLICATED = -1


def choose_dim(shape, spec, mp: int, dp: int,
               min_size: int = DEFAULT_MIN_PARTITION_SIZE,
               min_dim: int = 0) -> int:
    """The dim of one leaf to partition over the data group (-1: keep it
    replicated).  Among the dims >= ``min_dim`` whose LOCAL size (divided
    by ``mp`` where ``spec``, the model-sharded dim, names it) is
    divisible by ``dp``, the one with the largest local size, ties to the
    lowest index.  Leaves of fewer than ``min_size`` elements stay
    replicated, and nothing partitions at ``dp <= 1``."""
    if dp <= 1 or math.prod(int(s) for s in shape) < min_size:
        return REPLICATED
    best, best_local = REPLICATED, 0
    for d, size in enumerate(shape):
        if d < min_dim:
            continue
        local = int(size) // (int(mp) if spec == d else 1)
        if local % dp == 0 and local > best_local:
            best, best_local = d, local
    return best


def choose_dims(shapes: Dict[str, Sequence[int]],
                specs: Optional[Dict[str, Optional[int]]], mp: int, dp: int,
                min_size: int = DEFAULT_MIN_PARTITION_SIZE,
                min_dims: Optional[Dict[str, int]] = None) -> Dict[str, int]:
    """``{name: dim}`` over the GLOBAL ``shapes``; ``min_dims`` pins the
    lowest partitionable dim per leaf (the model's ``zero3_min_dims``)."""
    specs, min_dims = specs or {}, min_dims or {}
    return {name: choose_dim(tuple(shape), specs.get(name), mp, dp,
                             min_size, int(min_dims.get(name, 0)))
            for name, shape in shapes.items()}


def augment_specs(specs: Optional[Dict[str, Optional[int]]],
                  dims: Dict[str, int]) -> Dict[str, Dict[str, int]]:
    """Each leaf's placement as ``{axis: dim}`` over the ``"model"`` and
    ``"data"`` axes (the JAX ``augment_specs`` appends the data axis to
    the chosen dim of the leaf's PartitionSpec; a replicated leaf keeps
    only its model cut)."""
    specs = specs or {}
    out = {}
    for name, dim in dims.items():
        axes = {}
        if specs.get(name) is not None:
            axes["model"] = int(specs[name])
        if dim >= 0:
            axes["data"] = int(dim)
        out[name] = axes
    return out


def shift_dims(dims: Dict[str, int], by: int = -1) -> Dict[str, int]:
    """Re-index dims after an axis is consumed (a block body sees one
    layer of the stacked ``[L, ...]`` leaves, so dim k becomes k + by)."""
    return {k: d if d < 0 else d + by for k, d in dims.items()}


def partitioned_any(dims: Optional[Dict[str, int]]) -> bool:
    return bool(dims) and any(d >= 0 for d in dims.values())


def local_sqnorm_and_finite(grads: Dict[str, Optional[torch.Tensor]],
                            dims: Dict[str, int],
                            specs: Optional[Dict[str, Optional[int]]],
                            dp: int, mp: int = 1,
                            pipe_specs: Optional[Dict[str, Optional[int]]]
                            = None, pp: int = 1):
    """(sum of squares, all finite) over this rank's UNIQUE gradient
    elements, as 0-d fp32 tensors.  Partitioned shards are disjoint over
    the data group (weight 1); replicated leaves are the same on every
    data rank (weight ``1/dp``); a leaf not sharded over the model group
    counts ``1/mp`` on top, and one every stage holds whole ``1/pp`` (the
    dedup of ``zero.norm_dedup_weights``).  The caller SUMs the result
    over the data, model and pipe groups, and over no other: the
    gradients are the same on every rank of a seq group."""
    specs, pipe_specs = specs or {}, pipe_specs or {}
    names = [k for k, g in grads.items() if g is not None]
    if not names:
        return (torch.zeros((), dtype=torch.float32),
                torch.ones((), dtype=torch.bool))
    device = grads[names[0]].device
    norms = torch.stack([torch.linalg.vector_norm(grads[k],
                                                  dtype=torch.float32)
                         for k in names])

    def weight(k):
        w = 1.0 if dims.get(k, REPLICATED) >= 0 else 1.0 / dp
        if mp > 1 and specs.get(k) is None:
            w /= mp
        if pp > 1 and pipe_specs.get(k) is None:
            w /= pp
        return w
    w = torch.tensor([weight(k) for k in names], dtype=torch.float32,
                     device=device)
    # a non-finite element makes its leaf's norm non-finite
    return torch.sum(w * norms * norms), torch.isfinite(norms).all()


def shard(x, dim: int, dp: int, dp_rank: int):
    """Data rank ``dp_rank``'s contiguous 1/dp slice of ``x`` (a tensor
    or a numpy array) along ``dim``, a view; ``x`` itself when
    replicated."""
    if dim < 0:
        return x
    size = x.shape[dim] // dp
    index = [slice(None)] * len(x.shape)
    index[dim] = slice(dp_rank * size, (dp_rank + 1) * size)
    return x[tuple(index)]


class _GatherLeaves(torch.autograd.Function):
    """All-gather shards along their dims in rank order (one collective
    per dtype); the backward reduce-scatters (SUMs) each gradient along
    the same dim, in its dtype, before any 1/world."""

    @staticmethod
    def forward(ctx, group, dims, pending, *shards):
        ctx.group, ctx.dims = group, dims
        if pending is None:
            pending = comm.all_gather_dims(shards, dims, group)
        out = tuple(pending.wait())
        ctx.like = [(t.shape, t.dtype, t.device) for t in out]
        return out

    @staticmethod
    def backward(ctx, *grads):
        grads = [torch.zeros(shape, dtype=dtype, device=device)
                 if g is None else g.contiguous()
                 for g, (shape, dtype, device) in zip(grads, ctx.like)]
        return (None, None, None,
                *comm.reduce_scatter_dims(grads, ctx.dims, ctx.group))


def _partitioned(dims: Sequence[int]) -> list:
    return [i for i, d in enumerate(dims) if d >= 0]


def start_gather(shards: Sequence[torch.Tensor], dims: Sequence[int],
                 group) -> Optional["comm.PendingGather"]:
    """Issue the all-gather of the partitioned ones of ``shards`` now (an
    async work handle); ``gather_leaves(..., pending=)`` of the same
    shards takes its result later."""
    idx = _partitioned(dims)
    if not idx or group is None:
        return None
    return comm.all_gather_dims([shards[i].detach() for i in idx],
                                [dims[i] for i in idx], group,
                                async_op=True)


def gather_leaves(shards: Sequence[torch.Tensor], dims: Sequence[int], group,
                  pending=None) -> list:
    """The whole (model-local) leaves of ``shards``: each partitioned one
    (``dims[i] >= 0``) gathered along its dim over ``group``, the
    replicated ones as they are.  Differentiable: the gradients arrive
    reduce-scattered onto the shards.  ``pending``: a ``start_gather``
    of the same shards, issued earlier."""
    idx = _partitioned(dims)
    out = list(shards)
    if not idx or group is None:
        return out
    got = _GatherLeaves.apply(group, tuple(dims[i] for i in idx), pending,
                              *(shards[i] for i in idx))
    for i, t in zip(idx, got):
        out[i] = t
    return out
