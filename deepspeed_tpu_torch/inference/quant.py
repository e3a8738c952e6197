"""int8 weight-only quantization at load (serving).

The port of ``deepspeed_tpu/inference/quant.py``.  Weights quantize on
the host, on the global tree, before they go to the device: symmetric
per-output-channel int8 (``q = round(w / s)``, ``s = max|w| / 127`` over
the contraction axis), so every output channel's scale is the same on
every tensor-parallel rank and a row-parallel product can dequantize per
shard before its sum (``models/layers.py``, ``row_parallel_linear``).

A quantized leaf becomes a ``{"q": int8, "s": compute-dtype keepdims
scale}`` subtree, which the model's linear functions recognise
(``layers.is_quantized``) and take through the matmul-dequant plan
(``layers.quant_matmul_plan``, env ``DSTPU_QUANT_MATMUL``).  int8 serving
is not bit-exact: its logits stay within a relative 0.05 of the same
engine unquantized, and the "scaled" and "dequant" forms agree within
float rounding.

What quantizes (the GPT-2 family): the four block matrices (``qkv_w``,
``proj_w``, ``fc_w``, ``fc2_w``; per-layer per-output-channel scales on the
stacked [L, ...] leaves) and the tied embedding / LM head ``wte`` (per-row
scales).  LayerNorms, biases and ``wpe`` stay in the compute dtype.
"""

from __future__ import annotations

import torch

from deepspeed_tpu_torch.models import layers as L

#: leaf name -> the contraction axis its scale reduces (the other axis of
#: size > 1 is the output channel); the stacked block leaves keep their
#: leading layer axis in the scale
GPT2_QUANT_PLAN = {
    "qkv_w": 1,      # [L, in, out] -> scale [L, 1, out]
    "proj_w": 1,
    "fc_w": 1,
    "fc2_w": 1,
    "wte": 1,        # [vocab, hid] -> scale [vocab, 1] (per row)
}


def quantize_leaf(w, reduce_axis: int, compute_dtype):
    """Symmetric per-channel int8 of ``w`` (a tensor or array, on the
    host): ``{"q", "s"}`` with the scale keepdims-shaped in the compute
    dtype, so the dequantized weight lands in the serving dtype."""
    w32 = torch.as_tensor(w).detach().to("cpu", torch.float32)
    amax = torch.amax(torch.abs(w32), dim=reduce_axis, keepdim=True)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(w32 / scale), -127, 127).to(torch.int8)
    return {"q": q, "s": scale.to(compute_dtype)}


def quantize_tree(params, compute_dtype, plan=None):
    """Quantize every leaf whose name is in ``plan`` (host trees only);
    returns the mixed tree of quantized subtrees and untouched leaves."""
    plan = GPT2_QUANT_PLAN if plan is None else plan

    def walk(node):
        out = {}
        for name, sub in node.items():
            if isinstance(sub, dict):
                out[name] = walk(sub)
            elif name in plan:
                out[name] = quantize_leaf(sub, plan[name], compute_dtype)
            else:
                out[name] = sub
        return out

    if not isinstance(params, dict):
        raise ValueError(
            "int8 quantization expects a dict-shaped param tree (the "
            "engine-protocol model family)")
    return walk(params)


def quantize_specs(specs, plan=None):
    """The model-parallel specs (the sharded dim of each leaf, None:
    replicated) of :func:`quantize_tree`'s output: the int8 payload keeps
    the weight's dim; the keepdims scale is replicated along the reduced
    axis (its size is 1)."""
    plan = GPT2_QUANT_PLAN if plan is None else plan

    def walk(node):
        out = {}
        for name, sub in node.items():
            if isinstance(sub, dict):
                out[name] = walk(sub)
            elif name in plan:
                out[name] = {"q": sub,
                             "s": None if sub == plan[name] else sub}
            else:
                out[name] = sub
        return out

    return walk(specs)


# the dispatch-table surface next to the quantizer
is_quantized = L.is_quantized
quant_matmul_plan = L.quant_matmul_plan
