"""Sequence parallelism of the port composed with tensor parallelism and
ZeRO (the JAX ``tests/test_sp_matrix.py`` and ``test_zero3.py:150-170``).

One launch of four gloo CPU ranks (``tests/torch_rank_worker.py``) runs,
from the tiny GPT-2 of ``tests/test_torch_sp_train.py`` (the same weights
and batches, 3 steps, gas 2):

* sp 2 x mp 2, fp32, ring: against the JAX engine at sp 1, mp 1 (the
  JAX ``test_sp_with_tensor_parallel``), ``rtol=2e-4, atol=2e-5``;
* dp 2 x sp 2 with a bf16 policy and gradient clipping at 0.05, ZeRO
  stage 0 and stage 3: the models compute in fp32 (``Fp32GPT2``; the JAX
  side ``Fp32JGPT2``, as ``tests/test_torch_zero.py`` explains), but each
  seq rank's gradient is rounded to bf16 before the seq sum where the sp 1
  run rounds the whole one, and the masters are bf16 in the forward.  So
  both hold to the JAX engine's dp 2, sp 1 stage-0 losses within
  ``rtol=5e-3, atol=5e-3`` and its global grad norms within ``rtol=1e-2``
  (the JAX ``test_zero3_sp_grad_norm_not_deduped_over_seq``'s
  tolerances): the norm is neither counted once per seq rank nor shrunk
  by sqrt(sp), which would move it by 41% or 29%; stage 3 partitions
  every large leaf over the data group only, and its
  ``memory_estimate()`` equals the JAX engine's at the same mesh;
* dp 2 x sp 2, ZeRO-2 with overlap_comm, fp16 (fp32 compute): against the
  JAX engine's dp 2, sp 1 ZeRO-2 within ``rtol=2e-3, atol=1e-3`` (the JAX
  ``test_sp_with_zero``);
* sp 4 with Ulysses and 2 heads: the head guard's error.
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import deepspeed_tpu
from deepspeed_tpu.models import GPT2 as JGPT2
from deepspeed_tpu.parallel.topology import make_mesh
from deepspeed_tpu_torch import weights
from test_torch_sp_train import (ATOL, GAS, MEM_KEYS, MICRO, RTOL, STEPS,
                                 config, data, gpt2_params, jax_run)
from torch_rank_worker import TINY
from torch_ranks import run_ranks

WORLD, CLIP = 4, 0.05


class Fp32JGPT2(JGPT2):
    """The JAX GPT-2 computing in fp32 whatever its weights' dtype."""

    def apply(self, params, *batch):
        return super().apply(jax.tree_util.tree_map(
            lambda x: x.astype(jnp.float32), params), *batch)


def dp_config(dp, prec, zero_cfg=None, **extra):
    cfg = config(**extra)
    cfg["train_batch_size"] = MICRO * GAS * dp
    cfg[prec] = ({"enabled": True, "initial_scale_power": 8}
                 if prec == "fp16" else {"enabled": True})
    if zero_cfg is not None:
        cfg["zero_optimization"] = zero_cfg
    return cfg


def dp_data(dp):
    """``data()``'s LM batches, ``dp`` copies of each step's rows with the
    tokens shifted per copy (each data rank its own rows)."""
    d = data()
    toks = np.concatenate([(d["tokens"] + 7 * r) % TINY["vocab_size"]
                           for r in range(dp)], axis=1)
    labels = np.roll(toks, -1, axis=2)
    labels[..., -1] = -1
    return {"tokens": toks, "labels": labels}


Z0 = dp_config(2, "bf16", gradient_clipping=CLIP)
Z3 = dp_config(2, "bf16", {"stage": 3}, gradient_clipping=CLIP)
Z2 = dp_config(2, "fp16", {"stage": 2, "overlap_comm": True,
                           "comm_bucket_mb": 0.004})
RUNS = {
    "sp2_mp2": dict(config=config(), mp=2, mesh=True),
    "z0": dict(config=Z0, fp32_compute=True),
    "z3": dict(config=Z3, fp32_compute=True),
    "z2": dict(config=Z2, fp32_compute=True),
    "head_guard": dict(config=config(sequence_parallel_impl="ulysses"),
                       sp=4, model_kw={"num_heads": 2}, expect="init"),
}


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    inputs = {f"w/{k}": v for k, v in
              weights.flatten_tree(gpt2_params()).items()}
    # at dp 1 (sp2_mp2) a rank takes each step's first rows: data()'s
    inputs.update(dp_data(2))
    runs = [dict({"sp": 2}, **run, steps=0 if "expect" in run else STEPS)
            for run in RUNS.values()]
    outs = run_ranks(tmp_path_factory.mktemp("sp_matrix"), WORLD,
                     {"scenario": "train", "runs": runs}, inputs)
    return {name: [{k.split("/", 1)[1]: v for k, v in o.items()
                    if k.startswith(f"{i}/")} for o in outs]
            for i, name in enumerate(RUNS)}


def jax_dp2(cfg):
    """The JAX engine's losses and grad norms at dp 2, sp 1 (fp32
    compute), computed once per module and config."""
    return _jax_dp2(json.dumps(cfg, sort_keys=True))


@functools.lru_cache(maxsize=None)
def _jax_dp2(cfg):
    cfg = json.loads(cfg)
    engine, _, _, _ = deepspeed_tpu.initialize(
        config=cfg, model=Fp32JGPT2.from_size("tiny", **TINY),
        model_parameters=gpt2_params(),
        mesh=make_mesh(devices=jax.devices()[:2]))
    d = dp_data(2)
    losses, norms = [], []
    for i in range(STEPS):
        losses.append(float(engine.train_batch((d["tokens"][i],
                                                d["labels"][i]))))
        norms.append(float(engine._last_grad_norm))
    return losses, norms


def test_sp2_mp2_matches_jax_sp1(port):
    outs = port["sp2_mp2"]
    # rank = sp_rank * mp + mp_rank at dp 1
    assert [list(o["topo/coords"]) for o in outs] == [
        [0, 0, r % 2, r // 2] for r in range(WORLD)]
    assert [list(o["topo/seq"]) for o in outs] == [[0, 2], [1, 3]] * 2
    assert [list(o["topo/model"]) for o in outs] == [[0, 1]] * 2 + [
        [2, 3]] * 2
    want = jax_run(1, config())
    for o in outs[1:]:
        np.testing.assert_array_equal(o["losses"], outs[0]["losses"])
        np.testing.assert_array_equal(o["grad_norms"],
                                      outs[0]["grad_norms"])
    np.testing.assert_allclose(outs[0]["losses"], want["losses"], rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(outs[0]["grad_norms"], want["grad_norms"],
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", ["z0", "z3"])
def test_dp2_sp2_zero3_norm_and_clip_match_jax(port, name):
    outs = port[name]
    jl, jn = jax_dp2(Z0)
    for d in range(2):                # the seq ranks of each data rank agree
        a, b = outs[2 * d], outs[2 * d + 1]
        np.testing.assert_array_equal(a["losses"], b["losses"])
        np.testing.assert_array_equal(a["grad_norms"], b["grad_norms"])
    np.testing.assert_allclose(np.mean([o["losses"] for o in outs], axis=0),
                               jl, rtol=5e-3, atol=5e-3)
    for o in outs:
        assert min(o["grad_norms"]) > 2 * CLIP          # the clip engages
        np.testing.assert_allclose(o["grad_norms"], jn, rtol=1e-2)
    if name == "z3":
        dims = {k[len("z3dim/"):]: int(v) for k, v in outs[0].items()
                if k.startswith("z3dim/")}
        assert sum(d >= 0 for d in dims.values()) >= 4
        # ZeRO partitions over the data group only: the ranks of one seq
        # rank, [r, r + 2]
        assert [list(o["topo/data"]) for o in outs] == [[0, 2], [1, 3]] * 2
        engine, _, _, _ = deepspeed_tpu.initialize(
            config=Z3, model=JGPT2.from_size("tiny", **TINY),
            model_parameters=gpt2_params(),
            mesh=make_mesh(context_parallel_size=2,
                           devices=jax.devices()[:WORLD]))
        want = engine.memory_estimate()
        for o in outs:
            assert {k: int(o[f"mem/{k}"]) for k in MEM_KEYS} == {
                k: int(want[k]) for k in MEM_KEYS}


def test_dp2_sp2_zero2_fp16_matches_jax(port):
    outs = port["z2"]
    jl, _ = jax_dp2(Z2)
    np.testing.assert_allclose(np.mean([o["losses"] for o in outs], axis=0),
                               jl, rtol=2e-3, atol=1e-3)


def test_ulysses_head_guard(port):
    for o in port["head_guard"]:
        assert str(o["error"]).startswith(
            "DeepSpeedConfigError: sequence_parallel_impl='ulysses' needs "
            "local heads (2/1 = 2) divisible by context_parallel_size (4)")
