"""ZeRO stage 3 of the port against the JAX engine's stage 3: trajectories.

The port trains on gloo CPU ranks (``tests/torch_rank_worker.py``); the
JAX engine on its virtual CPU mesh of the same dp.  Both start from the
same numpy weights of the tiny fp32-computing GPT-2 of
``tests/test_torch_zero.py`` (2 layers, hidden 32, vocab 64, seq 16) and
take the same global batches.  The engines still cast the masters to
bf16/fp16, gather the shards, reduce-scatter the gradients (in fp32 here,
the compute dtype of the upcast weights) before rounding them to the
parameters' dtype, divide by the world size at the boundary, clip, skip
on an fp16 overflow and update the shards.  At dp 2 five leaves of the
tiny model partition (``wte`` and the four block weights); ``wpe`` (512
elements) and the LayerNorm and bias stacks stay below ``min_size`` 1024
and replicated, so both kinds of leaf are held (``z3dim`` below equals
the JAX engine's ``_zero3_dims``).  Clipping, the fp16 skip and Lion are
in ``tests/test_torch_zero3_knobs.py``.  Lion updates each element by
the SIGN of its interpolated moment, and the key third of ``qkv_b`` has
a gradient that is zero in exact arithmetic (softmax is invariant to a
shift shared by every key), so its sign is rounding noise in either
framework: those elements are held to ``2 * lr`` per step, every other
element to the tolerances above.

K = 3 steps.  Losses (the port's mean over ranks against the JAX
engine's) agree within ``rtol=1e-5``; each rank's shard of every master
and moment equals the JAX leaf's block within ``LOW_PRECISION`` of
``tests/test_torch_zero.py`` (the bf16 rounding of a gradient a midpoint
apart; its docstring has the measurements).  dp 2 x mp 2 holds against the JAX engine at dp 2 and mp 1, as the
ZeRO-1/2 x MP tests do (``tests/test_torch_tp_zero.py``: the JAX engine
at mp 2 rounds each model rank's partial gradient of a replicated leaf
before its sum and leaves its own mp 1 trajectory).
"""

import jax
import numpy as np
import pytest

from deepspeed_tpu_torch import weights, zero3
from deepspeed_tpu_torch.models import GPT2
from test_torch_zero import (LOW_PRECISION, MICRO, RTOL, STEPS, TINY, config,
                             init_params, jax_engine, lm_data, rank_inputs)
from torch_ranks import run_ranks

#: name: (dp, mp, gas, precision, extra config, optimizer section)
CASES = {
    "dp2-gas1": (2, 1, 1, "bf16", {}, None),
    "dp2-gas2": (2, 1, 2, "bf16", {}, None),
    "dp4": (4, 1, 1, "bf16", {}, None),
    "dp2xmp2": (2, 2, 1, "bf16", {}, None),
}


def jax_leaves(engine):
    """{"master"|"m"|"v": {dotted name: global numpy leaf}}."""
    out = {"master": engine.master}
    for key in ("m", "v"):
        tree = getattr(engine.opt_state, key)
        if tree is not None:
            out[key] = tree
    return {k: weights.flatten_tree(jax.tree_util.tree_map(np.asarray, t))
            for k, t in out.items()}


def local_block(x, name, specs, dims, mp, mp_rank, dp, dp_rank):
    """The block of global leaf ``x`` a port rank holds: its model-rank
    slice, then its data-rank shard."""
    if mp > 1 and specs.get(name) is not None:
        x = np.split(x, mp, axis=specs[name])[mp_rank]
    return zero3.shard(x, dims[name], dp, dp_rank)


def key_bias(name, shape, heads=TINY["num_heads"]):
    """Mask of the key-bias elements of a (model-local) ``qkv_b`` block:
    the middle d of each head's packed (q, k, v) columns."""
    mask = np.zeros(shape, bool)
    if name == "blocks.qkv_b":
        d = TINY["hidden_size"] // heads
        cols = mask.reshape(-1, shape[-1] // (3 * d), 3, d)
        cols[:, :, 1, :] = True
    return mask


def run_case(case, tmp_path):
    """One case against the JAX engine (see the module docstring)."""
    dp, mp, gas, prec, extra, opt = case
    cfg = config(dp, gas, prec, {"stage": 3, "overlap_comm": False},
                 **extra)
    if opt is not None:
        cfg["optimizer"] = opt
    params = init_params()
    toks, labels = lm_data(STEPS, dp * gas * MICRO)
    jeng = jax_engine(cfg, dp, params)
    jl = [float(jeng.train_batch((toks[i], labels[i])))
          for i in range(STEPS)]
    outs = run_ranks(tmp_path, dp * mp, {
        "scenario": "train", "config": cfg, "steps": STEPS,
        "fp32_compute": True, "mp": mp},
        rank_inputs(params, toks, labels))
    np.testing.assert_allclose(np.mean([o["losses"] for o in outs], axis=0),
                               jl, rtol=RTOL)
    want = jax_leaves(jeng)
    specs = weights.flatten_tree(GPT2.from_size("tiny",
                                                **TINY).partition_specs())
    if mp == 1:
        jdims = weights.flatten_tree(jeng._zero3_dims)
    for r, o in enumerate(outs):
        dp_rank, mp_rank = divmod(r, mp)
        dims = {k[len("z3dim/"):]: int(v) for k, v in o.items()
                if k.startswith("z3dim/")}
        if mp == 1:
            assert dims == jdims
        assert int(o["skipped"]) == jeng.skipped_steps
        assert int(o["global_steps"]) == STEPS
        for key, leaves in want.items():
            rtol, atol = LOW_PRECISION[key]
            for name, x in leaves.items():
                got = o[f"{key}/{name}"]
                x = local_block(x, name, specs, dims, mp, mp_rank, dp,
                                dp_rank)
                if opt is not None and opt["type"] == "Lion":
                    noise = key_bias(name, got.shape)
                    if key == "master":
                        lr = opt["params"]["lr"]
                        assert np.all(np.abs(got - x)[noise]
                                      <= 2 * lr * STEPS * 1.001)
                    got, x = got[~noise], x[~noise]
                np.testing.assert_allclose(
                    got, x, rtol=rtol, atol=atol,
                    err_msg=f"rank {r} {key} {name}")
    assert sum(d >= 0 for d in dims.values()) == 5
    return jeng


@pytest.mark.parametrize("case", list(CASES))
def test_stage3_trajectory_matches_jax(case, tmp_path):
    run_case(CASES[case], tmp_path)
