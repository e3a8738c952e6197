"""Row-sparse (CSR-style) gradients and their data-parallel reduction.

The port of ``deepspeed_tpu/sparse.py`` (the reference's
``deepspeed_csr_tensor.py`` and the sparse all-reduce of
``deepspeed_light.py:884-940``):

* ``CSRTensor``: the nonzero rows' ``indices`` and ``values`` of a dense
  tensor, ``to_dense`` by scatter-add, ``add`` by concatenation;
* ``sparse_psum``: the engine's reduction of a gradient whose rows are
  mostly zero (an embedding table's, marked by the model's
  ``sparse_grad_specs`` under ``sparse_gradients``): each rank gathers
  at most ``max_rows`` touched rows as (indices, values) from every rank
  and scatter-adds them, moving ``world * max_rows`` rows instead of the
  table; when any rank touches more rows (agreed by a MAX, so every rank
  takes the same branch) it is the dense sum, and it is statically the
  dense sum when ``world * max_rows >= rows``.  Exact either way; the
  knobs are ``comm.scaled_reduce``'s;
* ``csr_allreduce``: the reference's host-side averaging of gathered
  ``CSRTensor`` shards.
"""

from __future__ import annotations

import math
from typing import List, Optional

import torch
import torch.distributed as dist

from deepspeed_tpu_torch.parallel import comm


class CSRTensor:
    """Row-sparse tensor: ``indices`` (the nonzero rows' ids) and
    ``values`` (those rows).  Reference: deepspeed_csr_tensor.py:11-59."""

    def __init__(self, dense: Optional[torch.Tensor] = None):
        self.orig_dense_size = None
        self.indices = None
        self.values = None
        if dense is not None:
            dense = torch.as_tensor(dense)
            self.orig_dense_size = tuple(dense.shape)
            self.indices = torch.nonzero(_touched(dense))[:, 0]
            self.values = dense[self.indices]

    @classmethod
    def type(cls):
        return "deepspeed_tpu_torch.sparse.CSRTensor"

    @classmethod
    def from_parts(cls, indices, values, dense_size) -> "CSRTensor":
        t = cls()
        t.indices = torch.as_tensor(indices)
        t.values = torch.as_tensor(values)
        t.orig_dense_size = tuple(dense_size)
        return t

    @property
    def dense_size(self):
        return self.orig_dense_size

    def add(self, other: "CSRTensor") -> None:
        """Sparse accumulate by concatenation (a row present twice adds up
        in ``to_dense``).  Reference :45-57."""
        assert self.orig_dense_size == other.orig_dense_size, (
            "Cannot add tensors of different dense sizes")
        self.indices = torch.cat([self.indices, other.indices])
        self.values = torch.cat([self.values, other.values])

    def scale(self, factor) -> "CSRTensor":
        return CSRTensor.from_parts(self.indices, self.values * factor,
                                    self.orig_dense_size)

    def to_dense(self) -> torch.Tensor:
        """Scatter-add back to dense (reference :29-43)."""
        dtype = self.values.dtype if self.values is not None \
            else torch.float32
        device = self.values.device if self.values is not None else None
        out = torch.zeros(self.orig_dense_size, dtype=dtype, device=device)
        if self.indices is None or self.indices.numel() == 0:
            return out
        return out.index_add_(0, self.indices.long(), self.values)

    def sparse_size(self):
        return (self.indices.numel() * math.prod(self.values.shape[1:]),
                math.prod(self.orig_dense_size))


def _touched(g: torch.Tensor) -> torch.Tensor:
    """Per row of ``g``, whether any element is nonzero."""
    return (g != 0).reshape(g.shape[0], -1).any(dim=1)


def sparse_psum(g: torch.Tensor, group, world_size: int, max_rows: int,
                fp32_allreduce: bool = False,
                prescale_gradients: bool = False,
                gradient_predivide_factor: float = 1.0) -> torch.Tensor:
    """The row-sparse data-parallel average of a dense local gradient
    ``g`` over ``group`` (see the module docstring).  ``g`` may be
    overwritten.  The branch is decided on the host, after one MAX of the
    touched-row counts."""
    rows = g.shape[0]
    max_rows = int(min(max_rows, rows))
    knobs = dict(fp32_allreduce=fp32_allreduce,
                 prescale_gradients=prescale_gradients,
                 gradient_predivide_factor=gradient_predivide_factor)
    dense = comm._sum_over(group)
    if group is None or world_size * max_rows >= rows:
        # the gather would move at least as much as the dense all-reduce
        return comm.scaled_reduce(g, dense, world_size, **knobs)

    def reduce_fn(x):
        mask = _touched(x)
        nnz = mask.sum().to(torch.int32).reshape(1)
        dist.all_reduce(nnz, op=dist.ReduceOp.MAX, group=group)
        if int(nnz[0]) > max_rows:
            return dense(x)
        # the touched rows first, in index order (jax.lax.top_k of the
        # 0/1 mask is stable: a stable sort is the same order)
        _, idx = torch.sort(mask.to(torch.int32), descending=True,
                            stable=True)
        idx = idx[:max_rows]
        valid = mask[idx]
        bshape = (-1,) + (1,) * (x.dim() - 1)
        vals = torch.where(valid.reshape(bshape), x[idx],
                           torch.zeros((), dtype=x.dtype, device=x.device))
        idx = torch.where(valid, idx, torch.zeros_like(idx))  # pads add 0
        gathered = comm.all_gather_dims([idx, vals], [0, 0], group).wait()
        return torch.zeros_like(x).index_add_(0, gathered[0], gathered[1])

    return comm.scaled_reduce(g, reduce_fn, world_size, **knobs)


def csr_allreduce(shards: List[CSRTensor],
                  world_size: Optional[int] = None) -> torch.Tensor:
    """The reference's csr_allreduce (deepspeed_light.py:884-940): each
    rank's (indices, values) divided by the world size, concatenated and
    densified.  ``shards`` is the gathered list; returns the averaged
    dense gradient."""
    world = world_size if world_size is not None else len(shards)
    total = shards[0].scale(1.0 / world)
    for s in shards[1:]:
        total.add(s.scale(1.0 / world))
    return total.to_dense()
