"""ZeRO-1/2 checkpoints between the port and the JAX package, across dp.

The layout is the JAX package's: ``mp_rank_00_model_states.pt`` (rank 0,
no optimizer state) and one ``zero_pp_rank_{r}_mp_rank_00optim_states.pt``
per partition, each holding its slice of the flat fp32 master, ``m`` and
``v`` with the trailing padding dropped.  A restore re-pads for its own
data-parallel size.  Held here:

* a JAX ZeRO-2 save at dp 2 loads in the port at dp 2 (gloo ranks) and at
  dp 1 (one process): the restored partitions, step and parameters equal
  the JAX engine's bit for bit, and the next steps follow the JAX engine's
  (the tolerances of ``tests/test_torch_zero.py``);
* a port save at dp 2 loads in the JAX engine at dp 2 and at dp 1, bit for
  bit;
* a port run resumed at dp 2 from another init equals one that was not
  resumed, bit for bit: losses, masters, moments, step, loss scale.
"""

import os

import jax
import numpy as np
import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu_torch.models import GPT2
from test_torch_zero import (LOW_PRECISION, MICRO, RTOL, TINY, config,
                             init_params, jax_engine, lm_data, rank_inputs)
from torch_rank_worker import Fp32GPT2
from torch_ranks import run_ranks

GAS = 2
ZERO2 = {"stage": 2, "comm_bucket_mb": 0.004}


def jax_state(engine):
    st = engine.opt_state
    return {"master": np.asarray(engine.master_flat),
            "m": np.asarray(st.m["flat"]), "v": np.asarray(st.v["flat"]),
            "step": int(st.step),
            "cur_scale": float(engine.loss_scale_state.cur_scale)}


def assert_partitions_equal(outs, want, prefix=""):
    """Each rank's partition equals its slice of the JAX flat state
    (unpadded elements bitwise; the padding is zero)."""
    total = None
    for r, o in enumerate(outs):
        for key in ("master", "m", "v"):
            got = o[f"{prefix}{key}"]
            part = got.size
            w = want[key][r * part:(r + 1) * part]
            n = min(part, w.size)
            assert np.array_equal(got[:n], w[:n]), (r, key)
            assert not got[n:].any()
        assert int(o[f"{prefix}step"]) == want["step"]
        total = total or part
    return total


@pytest.mark.parametrize("dp", [2, 1])
def test_jax_zero2_save_loads_in_the_port(dp, tmp_path):
    d = str(tmp_path / "ck")
    params = init_params()
    toks, labels = lm_data(4, 2 * GAS * MICRO)
    cfg = config(2, GAS, "bf16", ZERO2)
    jeng = jax_engine(cfg, 2, params)
    for i in range(2):
        jeng.train_batch((toks[i], labels[i]))
    jeng.save_checkpoint(d)
    want = jax_state(jeng)
    jparams = {k: np.asarray(v.astype(np.float32)) for k, v in
               deepspeed_tpu_torch.weights.flatten_tree(
                   jax.tree_util.tree_map(np.asarray, jeng.params)).items()}
    jnext = [float(jeng.train_batch((toks[i], labels[i])))
             for i in (2, 3)]
    cont = jax_state(jeng)
    port_cfg = config(dp, GAS * 2 // dp, "bf16", ZERO2)
    if dp == 2:
        outs = run_ranks(tmp_path / "ranks", 2, {"scenario": "train",
                                                 "runs": [
            {"config": port_cfg, "steps": 0, "load": d, "weights": "w2",
             "fp32_compute": True},
            {"config": port_cfg, "steps": 2, "load": d, "weights": "w2",
             "fp32_compute": True, "first_batch": 2}]},
            rank_inputs(params, toks, labels, alt=init_params(8)))
        assert_partitions_equal(outs, want, "0/")
        losses = np.mean([o["1/losses"] for o in outs], axis=0)
        got = {k: np.concatenate([o[f"1/{k}"] for o in outs])
               for k in ("master", "m", "v")}
    else:
        # dp 1 takes the whole global batch as its gas 4 micro-batches: the
        # same sum of the same grads, in another order
        engine = deepspeed_tpu_torch.initialize(
            config=port_cfg, model=Fp32GPT2.from_size("tiny", **TINY),
            model_parameters=init_params(8), device="cpu")[0]
        engine.load_checkpoint(d)
        meta = engine.flat_meta
        for key, t in (("master", engine.master_flat),
                       ("m", engine.opt_state.m["flat"]),
                       ("v", engine.opt_state.v["flat"])):
            assert np.array_equal(t.numpy()[:meta.total],
                                  want[key][:meta.total]), key
        assert engine.opt_state.step == want["step"]
        for name, p in engine.module.named_parameters():
            assert p.dtype == torch.bfloat16
            assert np.array_equal(p.detach().float().numpy(),
                                  jparams[name]), name
        losses = [float(engine.train_batch((toks[i], labels[i])))
                  for i in (2, 3)]
        got = {k: t.numpy()[:meta.total] for k, t in (
            ("master", engine.master_flat),
            ("m", engine.opt_state.m["flat"]),
            ("v", engine.opt_state.v["flat"]))}
    # dp 1 reports the last of its 4 micro-batches, dp 2 and the JAX
    # engine the mean of the ranks' last: compare the state only there
    if dp == 2:
        np.testing.assert_allclose(losses, jnext, rtol=RTOL)
    for key, (rtol, atol) in LOW_PRECISION.items():
        n = got[key].size
        np.testing.assert_allclose(got[key], cont[key][:n], rtol=rtol,
                                   atol=atol, err_msg=key)


@pytest.fixture(scope="module")
def port_save(tmp_path_factory):
    """A port ZeRO-2 run at dp 2 (fp16, dynamic loss scale) saved after 2
    steps, and each rank's state at that point."""
    work = tmp_path_factory.mktemp("port_save")
    d = str(work / "ck")
    params = init_params()
    toks, labels = lm_data(2, 2 * GAS * MICRO)
    outs = run_ranks(work / "ranks", 2, {
        "scenario": "train", "config": config(2, GAS, "fp16", ZERO2),
        "steps": 2, "save_after": 2, "save_dir": d, "fp32_compute": True},
        rank_inputs(params, toks, labels))
    return d, outs


@pytest.mark.parametrize("dp", [2, 1])
def test_port_zero2_save_loads_in_jax(port_save, dp):
    d, outs = port_save
    tag = open(os.path.join(d, "latest")).read().strip()
    assert sorted(os.listdir(os.path.join(d, tag))) == [
        "mp_rank_00_model_states.pt",
        "zero_pp_rank_0_mp_rank_00optim_states.pt",
        "zero_pp_rank_1_mp_rank_00optim_states.pt"]
    jeng = jax_engine(config(dp, GAS * 2 // dp, "fp16", ZERO2), dp,
                      init_params(8))
    jeng.load_checkpoint(d)
    got = jax_state(jeng)
    total = jeng.flat_meta.total
    for key in ("master", "m", "v"):
        port = np.concatenate([o[key] for o in outs])[:total]
        assert np.array_equal(got[key][:total], port), key
    assert got["step"] == int(outs[0]["step"]) == 2
    assert got["cur_scale"] == float(outs[0]["cur_scale"])
    assert jeng.global_steps == 2


@pytest.mark.parametrize("stage", [1, 2])
def test_port_resume_at_dp2_is_bitwise(stage, tmp_path):
    """Run A: 4 steps, a save after step 2.  Run B: a fresh engine from
    other weights loads it and takes steps 3-4 on the same batches."""
    d = str(tmp_path / "ck")
    params = init_params()
    toks, labels = lm_data(4, 2 * GAS * MICRO)
    cfg = config(2, GAS, "fp16", {"stage": stage, "comm_bucket_mb": 0.004})
    outs = run_ranks(tmp_path / "ranks", 2, {"scenario": "train", "runs": [
        {"config": cfg, "steps": 4, "save_after": 2, "save_dir": d},
        {"config": cfg, "steps": 2, "load": d, "weights": "w2",
         "first_batch": 2}]},
        rank_inputs(params, toks, labels, alt=init_params(8)))
    for o in outs:
        assert np.array_equal(o["0/losses"][2:], o["1/losses"])
        for key in ("master", "m", "v", "step", "cur_scale",
                    "cur_hysteresis", "global_steps", "skipped"):
            assert np.array_equal(o[f"0/{key}"], o[f"1/{key}"]), key


def test_weights_only_load_rederives_the_partition(tmp_path):
    """load_optimizer_states=False under ZeRO: the partition of the
    masters comes from the loaded weights, the moments stay zero."""
    d = str(tmp_path / "ck")
    cfg = config(1, 1, "bf16", {"stage": 1})
    toks, labels = lm_data(1, MICRO)

    def make(seed):
        return deepspeed_tpu_torch.initialize(
            config=cfg, model=GPT2.from_size("tiny", **TINY),
            model_parameters=init_params(seed), device="cpu")[0]

    src = make(7)
    src.train_batch((toks[0], labels[0]))
    src.save_checkpoint(d)
    dst = make(8)
    dst.load_checkpoint(d, load_optimizer_states=False)
    total = dst.flat_meta.total
    assert torch.equal(dst._params_flat, src._params_flat)
    assert torch.equal(dst.master_flat[:total],
                       src._params_flat[:total].float())
    assert not dst.opt_state.m["flat"].any()
    assert dst.opt_state.step == 0
