"""Carry weights between the JAX package and the port.

The JAX package keeps parameters as a nested dict of arrays (``{"wte": ...,
"blocks": {"qkv_w": ...}}``); the port's modules register the same leaves
under dotted names (``wte``, ``blocks.qkv_w``) with the same shapes and
layouts.  So the copy is name for name, with no transposes.
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
