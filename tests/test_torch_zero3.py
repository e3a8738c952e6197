"""ZeRO stage 3 of the port: the partition rule against the JAX package's,
the port's bitwise agreements on gloo CPU ranks, and the guards.

* ``choose_dim`` equals the JAX ``zero3.choose_dim`` over shapes, model
  specs, dp, ``min_dim`` and ``min_size``; the engine's dims for tiny
  GPT-2 and BERT equal the JAX engine's ``_zero3_dims`` at dp 2 and 4.
* One launch of two ranks trains, each from the same weights: GPT-2 (the
  fp32-computing tiny model of ``tests/test_torch_zero.py``) at stage 3
  with on-demand gathers, with the prefetch (``overlap_comm``), with
  ``"full"`` and with ``"selective"`` remat, and BERT (NSP, dense labels)
  on-demand and with prefetch and selective remat.  Gathers are exact and
  the block bodies run the same ops at the same shapes, so losses and
  every rank's master, m and v shards are BITWISE equal across them.  The
  same launch runs Lion at stage 0 and stage 3: the losses within
  ``2e-2`` (the JAX package's ``test_zero3_lion_matches_stage0``: the
  stage-0 sum of bf16-rounded rank gradients and the stage-3 rounding of
  their sum flip the sign of gradients near zero).
* The guards raise the JAX engine's messages.
"""

import logging

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu import zero3 as jzero3
from deepspeed_tpu.config import DeepSpeedConfigError as JaxConfigError
from deepspeed_tpu.models import BertForPreTraining as JBert
from deepspeed_tpu.parallel.topology import make_mesh
from deepspeed_tpu_torch import weights, zero3
from deepspeed_tpu_torch.config import DeepSpeedConfigError
from deepspeed_tpu_torch.models import GPT2, BertForPreTraining
from test_torch_zero import (MICRO, STEPS, TINY, config, init_params,
                             jax_engine, lm_data, rank_inputs)
from torch_rank_worker import TINY_BERT
from torch_ranks import run_ranks

SHAPES = [(64, 128), (13, 64), (4, 4), (13, 17), (64, 32), (2, 32, 96),
          (50304, 1024), (24, 1024, 4096), (24, 1024)]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dp", [1, 2, 4, 8])
@pytest.mark.parametrize("model_dim,mp", [(None, 1), (0, 2), (1, 2),
                                          (1, 4)])
@pytest.mark.parametrize("min_dim,min_size", [(0, 1024), (1, 1024),
                                              (0, 1)])
def test_choose_dim_matches_jax(shape, dp, model_dim, mp, min_dim,
                                min_size):
    if model_dim is not None and model_dim >= len(shape):
        pytest.skip("the shape has no such dim")
    spec = P(*[("model" if d == model_dim else None)
               for d in range(len(shape))])
    want = jzero3.choose_dim(shape, spec, {"data": dp, "model": mp}, dp,
                             min_size=min_size, min_dim=min_dim)
    got = zero3.choose_dim(shape, model_dim, mp, dp, min_size=min_size,
                           min_dim=min_dim)
    assert got == want


def test_dims_helpers_match_jax():
    specs = {"w": 1, "b": None, "v": 0}
    dims = {"w": 1, "b": -1, "v": -1}
    jspecs = {"w": P(None, "model"), "b": P(), "v": P("model")}
    jout = jzero3.augment_specs(jspecs, dims)
    out = zero3.augment_specs(specs, dims)
    for name, axes in out.items():
        entries = list(jout[name]) + [None] * 3
        for axis, dim in axes.items():
            assert axis in jzero3._spec_axes(entries[dim])
        assert sum(len(jzero3._spec_axes(e)) for e in entries) == len(axes)
    assert zero3.shift_dims({"a": 2, "b": -1, "c": 1}) == \
        jzero3.shift_dims({"a": 2, "b": -1, "c": 1})
    assert zero3.partitioned_any({"a": -1, "b": 0})
    assert not zero3.partitioned_any({"a": -1})


def test_norm_weights_match_jax():
    """``local_sqnorm_and_finite`` weighs leaves as the JAX function:
    partitioned 1, replicated 1/dp, not model-sharded 1/mp on top."""
    rng = np.random.default_rng(0)
    grads = {k: rng.normal(size=(4, 6)).astype(np.float32)
             for k in ("a", "b", "c", "d")}
    dims = {"a": 0, "b": -1, "c": 1, "d": -1}
    specs = {"a": None, "b": 1, "c": 0, "d": None}
    jspecs = {"a": P(), "b": P(None, "model"), "c": P("model"), "d": P()}
    want, wfin = jzero3.local_sqnorm_and_finite(
        grads, dims, jspecs, 4, [("model", 2), ("data", 4)])
    got, fin = zero3.local_sqnorm_and_finite(
        {k: torch.tensor(v) for k, v in grads.items()}, dims, specs, 4, 2)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    assert bool(fin) and bool(wfin)
    grads["c"][1, 2] = np.inf
    _, fin = zero3.local_sqnorm_and_finite(
        {k: torch.tensor(v) for k, v in grads.items()}, dims, specs, 4, 2)
    assert not bool(fin)


def bert_params():
    jm = JBert.from_size("tiny", use_nsp=True, **TINY_BERT)
    return jax.tree_util.tree_map(np.asarray,
                                  jm.init_params(jax.random.PRNGKey(5)))


def bert_inputs(rows, seed=3):
    rng = np.random.default_rng(seed)
    seq, vocab = TINY_BERT["max_seq_len"], TINY_BERT["vocab_size"]
    ids = rng.integers(0, vocab, (STEPS, rows, seq)).astype(np.int32)
    mask = np.ones_like(ids)
    mask[:, ::3, seq - 4:] = 0
    labels = np.where(rng.random(ids.shape) < 0.2, ids, -1).astype(np.int32)
    return {"ids": ids, "mask": mask, "tt": np.zeros_like(ids),
            "mlm": labels,
            "nsp": rng.integers(0, 2, (STEPS, rows)).astype(np.int32)}


BERT_KEYS = ["ids", "mask", "tt", "mlm", "nsp"]


@pytest.mark.parametrize("dp", [2, 4])
@pytest.mark.parametrize("model", ["gpt2", "bert"])
def test_engine_dims_match_jax(model, dp):
    """The port's choice, from its model's specs, shapes and
    ``zero3_min_dims``, against the JAX engine's at stage 3."""
    cfg = config(dp, 1, "bf16", {"stage": 3})
    if model == "gpt2":
        jeng = jax_engine(cfg, dp, init_params())
        tm = GPT2.from_size("tiny", **TINY)
    else:
        jm = JBert.from_size("tiny", use_nsp=True, **TINY_BERT)
        jeng = deepspeed_tpu.initialize(
            config=cfg, model=jm, model_parameters=bert_params(),
            mesh=make_mesh(devices=jax.devices()[:dp]))[0]
        tm = BertForPreTraining.from_size("tiny", use_nsp=True, **TINY_BERT)
    params = dict(tm.named_parameters())
    got = zero3.choose_dims({k: p.shape for k, p in params.items()},
                            weights.flatten_tree(tm.partition_specs()), 1,
                            dp, min_dims=tm.zero3_min_dims())
    assert got == weights.flatten_tree(jeng._zero3_dims)


def _runs(o, n):
    return [{k.split("/", 1)[1]: v for k, v in o.items()
             if k.startswith(f"{i}/")} for i in range(n)]


def _bitwise(a, b):
    keys = [k for k in a if k.split("/")[0] in ("losses", "master", "m", "v")]
    assert set(keys) == {k for k in b
                         if k.split("/")[0] in ("losses", "master", "m", "v")}
    return {k: bool(np.array_equal(a[k], b[k])) for k in keys}


def test_prefetch_and_remat_are_bitwise_on_demand(tmp_path):
    dp, gas = 2, 2
    params = init_params()
    toks, labels = lm_data(STEPS, dp * gas * MICRO)
    inputs = rank_inputs(params, toks, labels)
    inputs.update({f"b/{k}": v for k, v in
                   weights.flatten_tree(bert_params()).items()})
    inputs.update(bert_inputs(dp * gas * MICRO))

    def z3(overlap, remat=None, opt=None, stage=3):
        extra = {}
        if remat is not None:
            extra["activation_checkpointing"] = {"enabled": True,
                                                 "policy": remat}
        cfg = config(dp, gas, "bf16", {"stage": stage,
                                       "overlap_comm": overlap}, **extra)
        if opt is not None:
            cfg["optimizer"] = opt
        return cfg

    lion = {"type": "Lion", "params": {"lr": 3e-4, "weight_decay": 0.01}}
    gpt2 = [z3(False), z3(True), z3(False, "full"), z3(False, "selective"),
            z3(True, "full")]
    bert = [z3(False), z3(True, "selective")]
    runs = ([{"config": c, "steps": STEPS, "fp32_compute": True}
             for c in gpt2]
            + [{"config": c, "steps": STEPS, "model": "bert_fp32",
                "weights": "b", "batch_keys": BERT_KEYS} for c in bert]
            + [{"config": z3(False, opt=lion, stage=s), "steps": STEPS,
                "fp32_compute": True} for s in (0, 3)])
    outs = run_ranks(tmp_path, dp, {"scenario": "train", "runs": runs},
                     inputs)
    n = len(runs)
    jdims = {
        "gpt2": jax_engine(config(dp, 1, "bf16", {"stage": 3}), dp,
                           params)._zero3_dims,
        "bert": deepspeed_tpu.initialize(
            config=config(dp, 1, "bf16", {"stage": 3}),
            model=JBert.from_size("tiny", use_nsp=True, **TINY_BERT),
            model_parameters=bert_params(),
            mesh=make_mesh(devices=jax.devices()[:dp]))[0]._zero3_dims}
    for o in outs:
        run = _runs(o, n)
        for i in range(1, len(gpt2)):
            assert all(_bitwise(run[0], run[i]).values()), i
        assert all(_bitwise(run[5], run[6]).values())
        for i, r in enumerate(run[:7]):
            assert np.isfinite(r["losses"]).all()
            dims = {k[len("z3dim/"):]: int(v) for k, v in r.items()
                    if k.startswith("z3dim/")}
            assert dims == weights.flatten_tree(
                jdims["gpt2" if i < len(gpt2) else "bert"])
        np.testing.assert_allclose(run[8]["losses"], run[7]["losses"],
                                   rtol=2e-2)
        # Lion's state is m only, at stage 3 as at stage 0
        assert not any(k.startswith("v/") for k in list(run[7]) + list(run[8]))
    # the ranks hold the same replicated leaves and different shards
    assert np.array_equal(outs[0]["0/master/blocks.ln1_s"],
                          outs[1]["0/master/blocks.ln1_s"])
    assert not np.array_equal(outs[0]["0/master/blocks.fc_w"],
                              outs[1]["0/master/blocks.fc_w"])


def _engine(cfg, model=None):
    return deepspeed_tpu_torch.initialize(
        config=cfg, model=model or GPT2.from_size("tiny", **TINY),
        device="cpu")[0]


def test_guards_raise_the_jax_messages(caplog):
    cfg = config(1, 1, "bf16", {"stage": 3})

    class Opaque(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.w = torch.nn.Parameter(torch.zeros(64, 64))

        def forward(self, x):
            return self.w.sum() * 0 + x.float().mean()

    with pytest.raises(DeepSpeedConfigError, match="zero3_dims"):
        _engine(cfg, Opaque())
    pps = dict(cfg, zero_optimization={"stage": 3,
                                       "parameter_parallel_size": 2})
    with pytest.raises(DeepSpeedConfigError,
                       match="parameter_parallel_size=2 must divide"):
        _engine(pps)
    for opt in ("Lamb", "RMSprop", "Adagrad"):
        bad = dict(cfg, optimizer={"type": opt, "params": {"lr": 1e-3}})
        with pytest.raises(JaxConfigError) as theirs:
            jax_engine(bad, 1, init_params())
        with pytest.raises(DeepSpeedConfigError) as ours:
            _engine(bad)
        assert str(ours.value) == str(theirs.value)
    with caplog.at_level(logging.WARNING):
        engine = _engine(dict(cfg, fp32_allreduce=True,
                              gradient_predivide_factor=2.0))
    assert engine.zero3
    text = " ".join(r.getMessage() for r in caplog.records)
    assert "fp32_allreduce, gradient_predivide_factor only affect" in text
    assert "no parameter leaf is partitionable at dp=1" in text


def test_pps_guard_at_dp2(tmp_path):
    cfg = config(2, 1, "bf16", {"stage": 3, "parameter_parallel_size": 1})
    with pytest.raises(JaxConfigError) as theirs:
        jax_engine(cfg, 2, init_params())
    toks, labels = lm_data(1, 2 * MICRO)
    with pytest.raises(AssertionError, match="stage-1/2 flat-layout knob"):
        run_ranks(tmp_path, 2, {"scenario": "train", "config": cfg,
                                "steps": 1},
                  rank_inputs(init_params(), toks, labels))
    assert "stage-1/2 flat-layout knob" in str(theirs.value)
