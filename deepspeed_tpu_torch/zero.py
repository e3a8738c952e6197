"""ZeRO stages 1 and 2: the flat, partitioned layout of the optimizer state.

The port of ``deepspeed_tpu/zero.py`` (reference
``FP16_DeepSpeedZeroOptimizer``, deepspeed_zero_optimizer.py): every
parameter leaf is laid end to end in ONE flat buffer, padded so that it
splits into ``pps`` equal partitions whose boundaries fall on multiples of
``align`` (128) elements, and data-parallel rank ``r`` of a partition
group keeps the fp32 master and the Adam moments of partition ``r`` only.
Gradients reduce-scatter onto the owned partition, the update runs there,
and the updated weights all-gather back into every rank's parameters
(``engine.py``, ``parallel/comm.py``).

Under tensor parallelism each model rank lays out its LOCAL slices (the
engine's parameters after narrowing), partitioned over its own data group:
``make_flat_meta`` of the local parameters is the JAX
``make_local_flat_meta``; under pipeline parallelism each (stage, model
rank) lays out its own leaves the same way.  ``norm_dedup_weights`` weighs
the leaves so that a model- and pipe-group sum of the weighted squared
norms counts every parameter once.

The leaves are laid out in the JAX package's order, that of
``jax.tree_util.tree_flatten`` over the nested parameter dict (keys sorted
at every level), so a flat partition means the same elements in both
packages and their ZeRO checkpoint files read each other.

``unflatten_tree`` returns VIEWS of the flat buffer: the engine's
per-leaf accumulators, masters and compute-dtype parameters alias one
flat tensor, so the boundary needs no concatenation and every bucket is a
128-aligned slice.
"""

from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch


class FlatMeta(NamedTuple):
    """The flatten layout: leaf names in flat order, their shapes, sizes
    and offsets, and the partition arithmetic."""
    names: Tuple[str, ...]
    shapes: Tuple[Tuple[int, ...], ...]
    sizes: Tuple[int, ...]
    offsets: Tuple[int, ...]
    total: int            # unpadded element count
    padded: int           # total padded to a multiple of (dp * align)
    partition: int        # padded // dp

    def segments(self, lo: int, hi: int) -> List[Tuple[int, int,
                                                        Optional[str]]]:
        """The leaf pieces of the flat range ``[lo, hi)`` as ``(start,
        stop, name)`` relative to ``lo``.  The trailing padding joins the
        last leaf's piece (its elements are zero and stay zero under any
        Adam hypers); a range of padding alone is one piece named None."""
        out = []
        for name, off, size in zip(self.names, self.offsets, self.sizes):
            s, e = max(off, lo), min(off + size, hi)
            if s < e:
                out.append([s - lo, e - lo, name])
        if hi > self.total:
            if out and out[-1][1] == self.total - lo:
                out[-1][1] = hi - lo
            elif not out:
                out.append([0, hi - lo, None])
        return [tuple(x) for x in out]


def _path(name: str) -> Tuple[str, ...]:
    return tuple(name.split("."))


def jax_leaf_order(names) -> list:
    """``names`` (dotted) in the JAX pytree's flatten order: dict keys
    sorted at every level."""
    return sorted(names, key=_path)


def make_flat_meta(params: Dict[str, torch.Tensor], dp_size: int,
                   align: int = 128) -> FlatMeta:
    """The flatten layout of ``{dotted name: tensor}`` over ``dp_size``
    partitions.  ``align=128`` puts every partition (and every bucket of
    ``comm.bucket_bounds``) on a multiple of 128 elements."""
    names = tuple(sorted(params, key=_path))
    shapes = tuple(tuple(params[k].shape) for k in names)
    sizes = tuple(math.prod(s) for s in shapes)
    offsets = tuple(sum(sizes[:i]) for i in range(len(sizes)))
    total = int(sum(sizes))
    chunk = dp_size * align
    padded = ((total + chunk - 1) // chunk) * chunk
    return FlatMeta(names=names, shapes=shapes, sizes=sizes, offsets=offsets,
                    total=total, padded=padded, partition=padded // dp_size)


def flatten_tree(tree: Dict[str, torch.Tensor], meta: FlatMeta,
                 dtype=torch.float32, out: Optional[torch.Tensor] = None
                 ) -> torch.Tensor:
    """Every leaf of ``tree`` copied (cast to ``dtype``) into one flat
    ``[padded]`` buffer, zero padding at the end: the port of the JAX
    ``flatten_tree`` (reference ``flatten_dense_tensors_aligned``,
    zero_optimizer.py:20-41).  Written into ``out`` when given."""
    if out is None:
        first = tree[meta.names[0]]
        out = torch.empty(meta.padded, dtype=dtype, device=first.device)
    for name, view in unflatten_tree(out, meta).items():
        view.copy_(tree[name])
    out[meta.total:].zero_()
    return out


def unflatten_tree(flat: torch.Tensor, meta: FlatMeta
                   ) -> Dict[str, torch.Tensor]:
    """``{name: view}``: each leaf as a view of ``flat`` (``[padded]`` or
    at least ``[total]``) in its shape; writing a view writes the
    buffer."""
    return {name: flat[off:off + size].view(shape)
            for name, shape, size, off in zip(meta.names, meta.shapes,
                                              meta.sizes, meta.offsets)}


def norm_dedup_weights(meta: FlatMeta, specs: Optional[Dict[str, object]],
                       mp: int, pipe_specs: Optional[Dict[str, object]] = None,
                       pp: int = 1) -> Tuple[float, ...]:
    """Per leaf of ``meta`` (in its order), the weight of its squared norm
    in the model- and pipe-group sum: a leaf sharded over the model group
    (``specs``: dotted name -> sharded dim or None) weighs 1 there, one
    every model rank holds whole ``1 / mp``; likewise over the ``pp``
    stages by ``pipe_specs``; the factors multiply, so the sum counts
    every parameter once (the per-leaf form of the JAX per-element
    ``norm_dedup_weights``, ``zero.py:161-183``; reference
    deepspeed_utils.py:100-158)."""
    specs, pipe_specs = specs or {}, pipe_specs or {}
    return tuple((1.0 if specs.get(name) is not None else 1.0 / mp)
                 * (1.0 if pipe_specs.get(name) is not None else 1.0 / pp)
                 for name in meta.names)
