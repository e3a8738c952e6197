"""``deepspeed_tpu_torch.initialize`` against ``deepspeed_tpu.initialize``.

Tiny BERT, shared initial weights, the same numpy batches: three
``train_batch`` steps with gradient accumulation 2 must give the same losses
and the same fp32 masters.  In that comparison the JAX side runs LAMB
through its Pallas kernel in interpret mode (``use_pallas: true``); on the
port's side the CPU tensors take the CUDA kernels' plain versions.

Tolerances: fp32 masters ``rtol=1e-4, atol=1e-6`` and losses ``rtol=1e-5``.
The optimizers run with ``eps=1e-6``: with 1e-8, an element whose gradient
sum cancels to ~1e-7 moves by about ``sign(g) * lr``, and the order of the
float sums, which differs between the frameworks, decides that sign.  In
bf16 and fp16 the losses agree to ``rtol=2e-2``; the grads are rounded to 8
(11) bits at different places in the two frameworks, so the first steps,
which move every element by about ``lr * sign(m)``, flip the move of
near-zero-gradient elements.  There each leaf's update (master minus initial
value) is compared by its relative L2 distance, which must stay below 0.25.
"""

import jax
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models import BertForPreTraining as JBert
from deepspeed_tpu.parallel.topology import make_mesh
from deepspeed_tpu_torch import weights
from deepspeed_tpu_torch.models import BertForPreTraining as TBert

VOCAB, SEQ, MICRO, GAS, NPRED, STEPS = 512, 64, 2, 2, 8, 3
TINY = dict(max_seq_len=SEQ, vocab_size=VOCAB, num_layers=2,
            hidden_size=128, num_heads=4)


def config(opt, dtype, pallas=False, **extra):
    params = {"lr": 1e-3, "weight_decay": 0.01, "eps": 1e-6}
    if opt == "Lamb":
        # use_pallas: the JAX side runs its Pallas LAMB kernel (interpret
        # mode on the CPU); the port accepts and ignores the key
        params.update(max_coeff=0.5, min_coeff=0.08, use_pallas=pallas)
    cfg = {"train_batch_size": MICRO * GAS,
           "gradient_accumulation_steps": GAS,
           "optimizer": {"type": opt, "params": params},
           "steps_per_print": 10 ** 9}
    if dtype == "bf16":
        cfg["bf16"] = {"enabled": True}
    elif dtype == "fp16":
        cfg["fp16"] = {"enabled": True, "initial_scale_power": 32}
    cfg.update(extra)
    return cfg


def assert_updates_close(got, want, init, rel=0.25):
    """Low-precision runs: each leaf's update agrees in relative L2."""
    assert got.keys() == want.keys()
    for k in want:
        dw, dg = want[k] - init[k], got[k] - init[k]
        err = np.linalg.norm(dg - dw) / np.linalg.norm(dw)
        assert err < rel, (k, err)


def batches(n=STEPS, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        rows = MICRO * GAS
        ids = rng.integers(0, VOCAB, size=(rows, SEQ)).astype(np.int32)
        mask = np.ones((rows, SEQ), np.int32)
        mask[0, SEQ - 9:] = 0
        tt = np.zeros((rows, SEQ), np.int32)
        pos = np.stack([rng.choice(SEQ, size=NPRED, replace=False)
                        for _ in range(rows)]).astype(np.int32)
        mlm_ids = np.take_along_axis(ids, pos, axis=1)
        w = np.ones((rows, NPRED), np.float32)
        out.append((ids, mask, tt, pos, mlm_ids, w))
    return out


def init_params():
    jm = JBert.from_size("tiny", **TINY)
    return jax.tree_util.tree_map(
        np.asarray, jm.init_params(jax.random.PRNGKey(0)))


def run_jax(cfg, params, data):
    engine, _, _, _ = deepspeed_tpu.initialize(
        config=cfg, model=JBert.from_size("tiny", **TINY),
        model_parameters=params, mesh=make_mesh(devices=jax.devices()[:1]))
    losses = [float(engine.train_batch(b)) for b in data]
    master = weights.flatten_tree(
        jax.tree_util.tree_map(np.asarray, engine.master))
    return engine, losses, master


def make_torch(cfg, params):
    engine, opt, loader, sched = deepspeed_tpu_torch.initialize(
        config=cfg, model=TBert.from_size("tiny", **TINY),
        model_parameters=params, device="cpu")
    assert opt is engine.optimizer and loader is None
    assert sched is engine.lr_scheduler
    return engine


def run_torch(cfg, params, data):
    engine = make_torch(cfg, params)
    losses = [float(engine.train_batch(b)) for b in data]
    return engine, losses, {k: v.numpy() for k, v in engine.master.items()}


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("opt", ["Lamb", "AdamW"])
def test_train_batch_matches_jax(opt, dtype):
    params, data = init_params(), batches()
    cfg = config(opt, dtype, pallas=True)
    _, jl, jmaster = run_jax(cfg, params, data)
    eng, tl, tmaster = run_torch(cfg, params, data)
    assert eng.global_steps == STEPS and eng.micro_steps == STEPS * GAS
    assert eng.opt_state.step == STEPS
    init = weights.flatten_tree(params)
    # every leaf moved: the optimizer saw every gradient
    assert all(not np.array_equal(tmaster[k], init[k]) for k in init)
    if dtype == "bf16":
        np.testing.assert_allclose(tl, jl, rtol=2e-2)
        assert_updates_close(tmaster, jmaster, init)
        return
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert tmaster.keys() == jmaster.keys()
    for k in jmaster:
        np.testing.assert_allclose(tmaster[k], jmaster[k], rtol=1e-4,
                                   atol=1e-6, err_msg=k)


def test_split_api_matches_train_batch():
    params, data = init_params(), batches(2)
    cfg = config("Lamb", "bf16")
    fused = make_torch(cfg, params)
    split = make_torch(cfg, params)
    for b in data:
        want = fused.train_batch(b)
        for i in range(GAS):
            micro = tuple(x[i * MICRO:(i + 1) * MICRO] for x in b)
            loss = split(*micro)
            assert split.backward(loss) is not None
            split.step()
        assert float(loss.detach()) == float(want)
    assert split.global_steps == fused.global_steps == 2
    for k in fused.master:
        torch.testing.assert_close(split.master[k], fused.master[k],
                                   rtol=0, atol=0)
    # the module holds the compute-dtype copy of the masters
    for k, p in split.module.named_parameters():
        assert p.dtype == torch.bfloat16
        torch.testing.assert_close(p, split.master[k].bfloat16(), rtol=0,
                                   atol=0)


def test_fp16_overflow_step_is_skipped_on_both_sides():
    params, data = init_params(), batches(2)
    cfg = config("Lamb", "fp16")
    jeng, _, jmaster = run_jax(cfg, params, data)
    teng, _, tmaster = run_torch(cfg, params, data)
    assert jeng.skipped_steps == teng.skipped_steps == 2
    assert teng.overflow and jeng.overflow
    assert teng.optimizer.cur_scale == jeng.optimizer.cur_scale == 2.0 ** 30
    assert teng.opt_state.step == 0
    init = weights.flatten_tree(params)
    for k in jmaster:
        np.testing.assert_array_equal(tmaster[k], init[k])
        np.testing.assert_array_equal(jmaster[k], init[k])


def test_fp16_clean_steps_match_jax():
    params, data = init_params(), batches(2)
    cfg = config("AdamW", "fp16", gradient_clipping=1.0)
    cfg["fp16"]["initial_scale_power"] = 8
    jeng, jl, jmaster = run_jax(cfg, params, data)
    teng, tl, tmaster = run_torch(cfg, params, data)
    assert jeng.skipped_steps == teng.skipped_steps == 0
    np.testing.assert_allclose(tl, jl, rtol=2e-2)
    assert_updates_close(tmaster, jmaster, weights.flatten_tree(params))


def test_lr_scheduler_and_param_groups_follow_the_jax_engine():
    params, data = init_params(), batches()
    cfg = config("Lamb", "fp32", scheduler={
        "type": "WarmupLR",
        "params": {"warmup_min_lr": 0.0, "warmup_max_lr": 1e-3,
                   "warmup_num_steps": 4}})
    cfg["optimizer"]["param_groups"] = [
        {"params": r"ln|_b'\]$|mlm_bias", "weight_decay": 0.0}]
    jeng, jl, jmaster = run_jax(cfg, params, data)
    teng, tl, tmaster = run_torch(cfg, params, data)
    assert teng.optimizer.param_groups == jeng.optimizer.param_groups
    assert teng._group_ids["blocks.ln1_s"] == 1
    assert teng._group_ids["blocks.qkv_w"] == 0
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    for k in jmaster:
        np.testing.assert_allclose(tmaster[k], jmaster[k], rtol=1e-4,
                                   atol=1e-6, err_msg=k)


def test_initialize_without_device_needs_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: initialize() picks it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        deepspeed_tpu_torch.initialize(
            config=config("Lamb", "bf16"),
            model=TBert.from_size("tiny", **TINY))


@pytest.mark.parametrize("extra,match", [
    ({"zero_optimization": {"stage": 1}}, "Adam-family"),
    ({"model_parallel_size": 2}, "ROADMAP"),
    ({"train_steps_per_dispatch": 4}, "ROADMAP"),
])
def test_unported_configs_raise(extra, match):
    with pytest.raises((NotImplementedError,
                        deepspeed_tpu_torch.config.DeepSpeedConfigError),
                       match=match):
        make_torch(config("Lamb", "bf16", **extra), init_params())
    cfg = config("AdamW", "bf16", zero_optimization={"stage": 1})
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        make_torch(cfg, init_params())


def test_args_config_file_and_wall_clock_breakdown(tmp_path):
    """The CLI spelling (--deepspeed_config) and the timer spans."""
    import argparse
    import json

    path = tmp_path / "ds.json"
    path.write_text(json.dumps(config("AdamW", "fp32",
                                      wall_clock_breakdown=True)))
    parser = deepspeed_tpu_torch.add_config_arguments(
        argparse.ArgumentParser())
    args = parser.parse_args(["--deepspeed_config", str(path)])
    engine, _, _, _ = deepspeed_tpu_torch.initialize(
        args=args, model=TBert.from_size("tiny", **TINY),
        model_parameters=init_params(), device="cpu")
    b = batches(1)[0]
    for i in range(GAS):
        loss = engine(*(x[i * MICRO:(i + 1) * MICRO] for x in b))
        engine.backward()
        engine.step()
    assert engine.global_steps == 1 and np.isfinite(float(loss.detach()))
    assert {"forward", "backward", "step"} <= set(engine.timers.timers)
    engine.eval()
    eval_loss = engine(*(x[:MICRO] for x in b))
    assert not eval_loss.requires_grad
