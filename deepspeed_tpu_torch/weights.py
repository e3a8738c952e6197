"""Carry weights between the JAX package and the port.

The JAX package keeps parameters as a nested dict of arrays (``{"wte": ...,
"blocks": {"qkv_w": ...}}``); the port's modules register the same leaves
under dotted names (``wte``, ``blocks.qkv_w``) with the same shapes and
layouts.  So the copy is name for name, with no transposes.

Under tensor parallelism each model rank holds a LOCAL tree: a leaf that
the model's ``partition_specs()`` shards (an int, the sharded dim; None
is replicated) keeps the rank's contiguous 1/mp slice along that dim.
``shard_tree`` cuts a global tree into one rank's local tree and
``combine_local_trees`` joins the ranks' local trees back (the port's copy
of ``deepspeed_tpu/zero.py:186-240``), so a JAX tree loads into any mp of
the port, and back.  Under pipeline parallelism a stage holds its slice
of the block stack's layer dim (the model's ``pipe_specs()``) as well:
``local_tree`` makes the tree of a (stage, model rank) and
``combine_stage_trees`` joins those of every (stage, model rank), stage
major (the JAX ``combine_composite_trees``).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn


def flatten_tree(tree: dict, prefix: str = "") -> Dict[str, object]:
    """``{"a": {"b": x}}`` -> ``{"a.b": x}``."""
    out = {}
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(flatten_tree(v, name + "."))
        else:
            out[name] = v
    return out


def unflatten_tree(flat: Dict[str, object]) -> dict:
    """``{"a.b": x}`` -> ``{"a": {"b": x}}``."""
    tree: dict = {}
    for name, v in flat.items():
        *path, leaf = name.split(".")
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = v
    return tree


@torch.no_grad()
def params_from_numpy(model: nn.Module, tree: dict) -> None:
    """Load a JAX-layout parameter tree (numpy or array-like leaves) into
    ``model`` in place, casting to each parameter's dtype.  The two must
    hold the same names and shapes."""
    flat = flatten_tree(tree)
    params = dict(model.named_parameters())
    missing, extra = set(params) - set(flat), set(flat) - set(params)
    if missing or extra:
        raise KeyError(f"parameter names differ: missing {sorted(missing)}, "
                       f"unexpected {sorted(extra)}")
    for name, p in params.items():
        src = np.asarray(flat[name], dtype=np.float32)
        if tuple(src.shape) != tuple(p.shape):
            raise ValueError(f"{name}: shape {src.shape} != {tuple(p.shape)}")
        p.copy_(torch.tensor(src))


@torch.no_grad()
def params_to_numpy(model: nn.Module) -> dict:
    """The model's parameters as a JAX-layout tree of fp32 numpy arrays."""
    return unflatten_tree({name: p.detach().float().cpu().numpy()
                           for name, p in model.named_parameters()})


def _slice(x, dim: int, mp: int, mp_rank: int):
    n = x.shape[dim]
    if n % mp:
        raise ValueError(f"dim {dim} of shape {tuple(x.shape)} is not "
                         f"divisible by the parallel size {mp}")
    size = n // mp
    index = [slice(None)] * len(x.shape)
    index[dim] = slice(mp_rank * size, (mp_rank + 1) * size)
    return x[tuple(index)]


def shard_tree(tree: dict, specs: dict, mp: int, mp_rank: int) -> dict:
    """Model rank ``mp_rank``'s local tree of the global ``tree`` (numpy
    or tensor leaves; the slices are views): each leaf sharded by
    ``specs`` keeps its ``mp_rank``-th of ``mp`` contiguous blocks along
    its sharded dim, a replicated leaf stays whole."""
    flat, dims = flatten_tree(tree), flatten_tree(specs)
    return unflatten_tree({
        name: x if dims.get(name) is None or mp == 1
        else _slice(x, dims[name], mp, mp_rank)
        for name, x in flat.items()})


def combine_local_trees(local_trees, specs: dict) -> dict:
    """The global tree of the model ranks' local trees (in rank order):
    sharded leaves concatenate along their sharded dim, replicated leaves
    come from rank 0.  Numpy leaves give numpy, tensors give tensors."""
    flats = [flatten_tree(t) for t in local_trees]
    dims = flatten_tree(specs)
    out = {}
    for name, x in flats[0].items():
        dim = dims.get(name)
        if dim is None or len(flats) == 1:
            out[name] = x
        elif isinstance(x, torch.Tensor):
            out[name] = torch.cat([f[name] for f in flats], dim=dim)
        else:
            out[name] = np.concatenate([np.asarray(f[name]) for f in flats],
                                       axis=dim)
    return unflatten_tree(out)


def local_tree(tree: dict, model_specs, mp: int, mp_rank: int,
               pipe_specs=None, pp: int = 1, pp_rank: int = 0) -> dict:
    """The tree of model rank ``mp_rank`` at stage ``pp_rank`` of a global
    ``tree``: cut by ``pipe_specs`` over ``pp`` stages, then by
    ``model_specs`` over ``mp`` ranks."""
    if pp > 1:
        tree = shard_tree(tree, pipe_specs, pp, pp_rank)
    return shard_tree(tree, model_specs or {}, mp, mp_rank)


def combine_stage_trees(local_trees, model_specs, mp: int,
                        pipe_specs=None) -> dict:
    """The global tree of every (stage, model rank)'s local tree, in the
    order ``stage * mp + mp_rank``: each stage's model ranks joined, then
    the stages."""
    pp = len(local_trees) // mp
    stages = [combine_local_trees(local_trees[s * mp:(s + 1) * mp],
                                  model_specs or {}) for s in range(pp)]
    if pp == 1:
        return stages[0]
    if pipe_specs is None:
        raise ValueError(
            f"joining {pp} pipeline stages needs the model's pipe_specs() "
            f"(the dim each leaf is cut along over the stages)")
    return combine_local_trees(stages, pipe_specs)


@torch.no_grad()
def shard_module_(model: nn.Module, specs: dict, mp: int,
                  mp_rank: int) -> None:
    """Narrow ``model``'s parameters, in place, to model rank
    ``mp_rank``'s slices (a copy each, so the global tensors are freed)."""
    params = dict(model.named_parameters())
    local = flatten_tree(shard_tree(
        unflatten_tree({k: p.data for k, p in params.items()}), specs, mp,
        mp_rank))
    for name, p in params.items():
        if local[name].shape != p.shape:
            p.data = local[name].clone()
