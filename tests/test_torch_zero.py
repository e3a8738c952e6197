"""Data parallelism and ZeRO-1/2 of the port against the JAX engine.

The port trains on gloo CPU ranks (``tests/torch_rank_worker.py``, one
process per rank); the JAX engine on its virtual CPU mesh of the same dp
(``make_mesh(devices=jax.devices()[:dp])``).  Both start from the same
numpy weights of a tiny GPT-2 (2 layers, hidden 32, 4 heads, vocab 64, seq
16) and take the same global batches, rank r's block being rows [r * gas *
micro, (r + 1) * gas * micro) as the JAX engine's shard.

ZeRO needs a bf16 or fp16 policy, and the two frameworks round a bf16
forward differently (``tests/test_torch_engine.py``: losses within 2e-2).
So the models here compute in fp32 whatever their weights' dtype: the
engines still cast the masters to bf16/fp16, scale the fp16 loss, round
the grads to the compute dtype, reduce-scatter, clip, update and gather.
K = 3 steps; Adam's ``eps`` is 1e-6, as in ``tests/test_torch_engine.py``.
Losses (the port's mean over ranks against the JAX engine's data-axis
mean) agree within ``rtol=1e-5``; every rank's flat master and moments
within ``rtol=1e-5, atol=1e-6`` under an fp32 policy.  Under bf16 and
fp16 the fp32 backward still differs by ~1e-7 relative between the
frameworks, so a gradient within that of a midpoint of the compute dtype
rounds to neighbours one ulp apart (bf16: 2^-8 = 3.9e-3 relative).  Its
first moment then differs by up to ``(1 - beta1)`` ulp of the gradient,
absolute where the moment has cancelled to near zero (allowed ``rtol=4e-3,
atol=1e-5``; measured 6.1e-6), its second moment by up to two ulps
relative (``rtol=8e-3, atol=1e-6``), and, where ``sqrt(v)`` is near
``eps``, its master by up to lr / 2^8 a step (``rtol=1e-5, atol=1e-5``;
measured 6.7e-6).  Each of these struck 1-3 of the 14,080 elements of a
rank's partition; a fault of the partitioning, the scaling or the clipping
moves whole partitions by far more.

Within the port: stage 1 = stage 2 and overlap on = off bitwise at dp 2,
an overflow on one rank skips the step on both, the stage-2 accumulator
is one partition, and LAMB under ZeRO raises the JAX engine's message.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu import zero as jzero
from deepspeed_tpu.config import DeepSpeedConfigError as JaxConfigError
from deepspeed_tpu.models import GPT2 as JGPT2
from deepspeed_tpu.parallel.topology import make_mesh
from deepspeed_tpu_torch import weights, zero
from deepspeed_tpu_torch.config import DeepSpeedConfigError
from deepspeed_tpu_torch.models import GPT2
from torch_ranks import run_ranks

VOCAB, SEQ, MICRO, STEPS = 64, 16, 4, 3
TINY = dict(vocab_size=VOCAB, max_seq_len=SEQ, num_layers=2, hidden_size=32,
            num_heads=4, remat=False)
RTOL, ATOL = 1e-5, 1e-6
#: (rtol, atol) of the master and of the moments under a bf16/fp16 policy
LOW_PRECISION = {"master": (RTOL, 1e-5), "m": (4e-3, 1e-5),
                 "v": (8e-3, ATOL)}


class Fp32JGPT2(JGPT2):
    """The JAX GPT-2 computing in fp32 whatever its weights' dtype (the
    counterpart of the worker's ``Fp32GPT2``)."""

    def apply(self, params, *batch):
        return super().apply(jax.tree_util.tree_map(
            lambda x: x.astype(jnp.float32), params), *batch)


def config(dp, gas=2, prec="bf16", zero_cfg=None, **extra):
    cfg = {"train_batch_size": MICRO * gas * dp,
           "gradient_accumulation_steps": gas,
           "steps_per_print": 10 ** 9,
           "optimizer": {"type": "Adam",
                         "params": {"lr": 1e-3, "eps": 1e-6}}}
    if prec == "bf16":
        cfg["bf16"] = {"enabled": True}
    elif prec == "fp16":
        cfg["fp16"] = {"enabled": True, "initial_scale_power": 8}
    if zero_cfg is not None:
        cfg["zero_optimization"] = zero_cfg
    cfg.update(extra)
    return cfg


def init_params(key=7):
    jm = JGPT2.from_size("tiny", **TINY)
    return jax.tree_util.tree_map(np.asarray,
                                  jm.init_params(jax.random.PRNGKey(key)))


def lm_data(steps, rows, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, VOCAB, (steps, rows, SEQ)).astype(np.int32)
    labels = np.roll(toks, -1, axis=2)
    labels[..., -1] = -1
    return toks, labels


def rank_inputs(params, toks, labels, alt=None):
    out = {f"w/{k}": v for k, v in weights.flatten_tree(params).items()}
    if alt is not None:
        out.update({f"w2/{k}": v
                    for k, v in weights.flatten_tree(alt).items()})
    out.update(tokens=toks, labels=labels)
    return out


def jax_engine(cfg, dp, params, fp32_compute=True, param_groups=None):
    model = (Fp32JGPT2 if fp32_compute else JGPT2).from_size("tiny", **TINY)
    engine, _, _, _ = deepspeed_tpu.initialize(
        config=cfg, model=model, model_parameters=params,
        param_groups=param_groups,
        mesh=make_mesh(devices=jax.devices()[:dp]))
    return engine


def jax_flat_state(engine):
    """(master, m, v) as numpy: the flat [repl * padded] buffers under
    ZeRO, the leaves in flat order (unpadded) otherwise."""
    st = engine.opt_state
    if engine.zero_flat:
        return [np.asarray(x) for x in (engine.master_flat, st.m["flat"],
                                        st.v["flat"])]
    return [np.concatenate([np.asarray(x).reshape(-1) for x in
                            jax.tree_util.tree_leaves(t)])
            for t in (engine.master, st.m, st.v)]


CASES = {
    # name: (dp, gas, precision, zero section, extra config, param groups)
    "dp2-stage0-prescale-predivide": (
        2, 2, "fp32", None,
        dict(prescale_gradients=True, gradient_predivide_factor=4.0), None),
    "dp2-stage1-fp16-clip": (
        2, 2, "fp16", {"stage": 1, "overlap_comm": False},
        dict(gradient_clipping=0.5), None),
    "dp2-stage2-bf16-overlap": (
        2, 2, "bf16", {"stage": 2, "overlap_comm": True,
                       "comm_bucket_mb": 0.004}, {}, None),
    "dp4-stage1-pps2": (
        4, 1, "bf16", {"stage": 1, "parameter_parallel_size": 2}, {}, None),
    "dp2-stage1-param-groups": (
        2, 2, "bf16", {"stage": 1, "comm_bucket_mb": 0.004}, {},
        [{"params": "ln", "lr": 3e-3, "weight_decay": 0.1},
         {"params": "wpe", "betas": [0.8, 0.99]}]),
}


@pytest.mark.parametrize("case", list(CASES))
def test_trajectory_matches_jax(case, tmp_path):
    dp, gas, prec, zero_cfg, extra, groups = CASES[case]
    cfg = config(dp, gas, prec, zero_cfg, **extra)
    params = init_params()
    toks, labels = lm_data(STEPS, dp * gas * MICRO)
    jeng = jax_engine(cfg, dp, params, param_groups=groups)
    jl = [float(jeng.train_batch((toks[i], labels[i])))
          for i in range(STEPS)]
    outs = run_ranks(tmp_path, dp, {
        "scenario": "train", "config": cfg, "steps": STEPS,
        "fp32_compute": True, "param_groups": groups},
        rank_inputs(params, toks, labels))
    tl = np.mean([o["losses"] for o in outs], axis=0)
    np.testing.assert_allclose(tl, jl, rtol=RTOL)
    want = jax_flat_state(jeng)
    zero_on = zero_cfg is not None
    for r, o in enumerate(outs):
        assert int(o["step"]) == STEPS and int(o["skipped"]) == 0
        for key, w in zip(("master", "m", "v"), want):
            got = o[key]
            if zero_on:
                part = got.size
                w = w[r * part:(r + 1) * part]
            rtol, atol = (RTOL, ATOL) if prec == "fp32" else \
                LOW_PRECISION[key]
            np.testing.assert_allclose(got, w, rtol=rtol, atol=atol,
                                       err_msg=f"rank {r} {key}")
    if zero_on:
        assert int(outs[0]["partition"]) == jeng.flat_meta.partition
        assert int(outs[0]["padded"]) == jeng.flat_meta.padded
    else:
        for o in outs[1:]:      # every rank updated every leaf alike
            assert np.array_equal(o["master"], outs[0]["master"])


def _same(a, b, keys=("losses", "master", "m", "v")):
    return {k: bool(np.array_equal(a[k], b[k])) for k in keys}


def test_stage1_equals_stage2_and_overlap_on_equals_off(tmp_path):
    """Bitwise at dp 2.  Stage 1 against 2 at gas 1: with gas 2 the two
    sum the same four addends in another order (stage 1 adds each rank's
    micro-steps, then the ranks; stage 2 the reverse), as in the JAX
    package.  Overlap on against off at gas 2 for both stages: the buckets
    re-tile the same sums."""
    params = init_params()
    toks, labels = lm_data(STEPS, 2 * 2 * MICRO)
    bucket = {"comm_bucket_mb": 0.004}
    runs = [
        config(2, 1, "bf16", {"stage": 1, "overlap_comm": False}),
        config(2, 1, "bf16", {"stage": 2, "overlap_comm": False}),
        config(2, 2, "bf16", {"stage": 1, "overlap_comm": False}),
        config(2, 2, "bf16", {"stage": 1, "overlap_comm": True, **bucket}),
        config(2, 2, "bf16", {"stage": 2, "overlap_comm": False}),
        config(2, 2, "bf16", {"stage": 2, "overlap_comm": True, **bucket}),
    ]
    outs = run_ranks(tmp_path, 2, {"scenario": "train", "runs": [
        {"config": c, "steps": STEPS} for c in runs]},
        rank_inputs(params, toks, labels))
    for o in outs:
        run = [{k.split("/", 1)[1]: v for k, v in o.items()
                if k.startswith(f"{i}/")} for i in range(len(runs))]
        assert all(_same(run[0], run[1]).values())
        assert all(_same(run[2], run[3]).values())
        assert all(_same(run[4], run[5]).values())
        assert all(np.isfinite(r["losses"]).all() for r in run)


def test_overflow_on_one_rank_skips_the_step_on_every_rank(tmp_path):
    """fp16 ZeRO-2, split API: an inf in rank 1's partition of the grads
    (rank 0's is finite) makes both ranks skip step 2, and the state stays
    that of step 1.  The loss scale runs the MEGATRON FSM under ZeRO: with
    the default hysteresis of 2 the first overflow spends one unit of
    hysteresis and keeps the scale (the INLINE FSM would halve it).  The
    stage-2 accumulator holds one partition: half the padded layout at
    dp 2."""
    params = init_params()
    toks, labels = lm_data(2, 2 * 2 * MICRO)
    cfg = config(2, 2, "fp16", {"stage": 2, "overlap_comm": False})
    outs = run_ranks(tmp_path, 2, {"scenario": "train", "runs": [
        {"config": cfg, "steps": 1, "split": True},
        {"config": cfg, "steps": 2, "split": True,
         "inject_inf": {"rank": 1, "step": 1, "index": 0}}]},
        rank_inputs(params, toks, labels))
    for o in outs:
        assert int(o["0/skipped"]) == 0 and int(o["1/skipped"]) == 1
        assert int(o["1/global_steps"]) == 2 and int(o["1/step"]) == 1
        assert float(o["1/cur_scale"]) == float(o["0/cur_scale"]) == 256
        assert int(o["0/cur_hysteresis"]) == 2
        assert int(o["1/cur_hysteresis"]) == 1
        for key in ("master", "m", "v"):
            assert np.array_equal(o[f"0/{key}"], o[f"1/{key}"]), key
        assert int(o["1/acc_numel"]) == int(o["1/partition"])
        assert 2 * int(o["1/partition"]) == int(o["1/padded"])


@pytest.mark.parametrize("dp", [1, 2, 3, 4])
def test_flat_meta_matches_jax(dp):
    params = init_params()
    jmeta = jzero.make_flat_meta(params, dp)
    tmodel = GPT2.from_size("tiny", **TINY)
    tmeta = zero.make_flat_meta(dict(tmodel.named_parameters()), dp)
    assert (tmeta.total, tmeta.padded, tmeta.partition) == (
        jmeta.total, jmeta.padded, jmeta.partition)
    assert tmeta.shapes == jmeta.shapes and tmeta.sizes == jmeta.sizes
    assert tmeta.padded % (128 * dp) == 0
    # the same leaf order: the JAX tree's, keys sorted at every level
    jnames = [".".join(str(k.key) for k in path) for path, _ in
              jax.tree_util.tree_flatten_with_path(params)[0]]
    assert list(tmeta.names) == jnames
    flat_params = weights.flatten_tree(params)
    tree = {k: torch.tensor(v) for k, v in flat_params.items()}
    tflat = zero.flatten_tree(tree, tmeta)
    jflat = np.asarray(jzero.flatten_tree(params, jmeta))
    assert np.array_equal(tflat.numpy(), jflat)
    views = zero.unflatten_tree(tflat, tmeta)
    jtree = weights.flatten_tree(jax.tree_util.tree_map(
        np.asarray, jzero.unflatten_tree(jnp.asarray(jflat), jmeta)))
    for name, view in views.items():
        assert np.array_equal(view.numpy(), jtree[name])
        # a view of the buffer, not a copy
        assert view.untyped_storage().data_ptr() == \
            tflat.untyped_storage().data_ptr()
    views[tmeta.names[-1]].view(-1)[0] = 1234.5
    assert float(tflat[tmeta.offsets[-1]]) == 1234.5


def test_flat_meta_segments_cut_at_leaves():
    tmodel = GPT2.from_size("tiny", **TINY)
    meta = zero.make_flat_meta(dict(tmodel.named_parameters()), 3)
    for r in range(3):
        lo = r * meta.partition
        segs = meta.segments(lo, lo + meta.partition)
        assert segs[0][0] == 0 and segs[-1][1] == meta.partition
        assert all(a[1] == b[0] for a, b in zip(segs, segs[1:]))
        for s, e, name in segs:
            i = meta.names.index(name)
            last = i == len(meta.names) - 1   # the padding joins it
            end = meta.padded if last else meta.offsets[i] + meta.sizes[i]
            assert meta.offsets[i] <= lo + s < lo + e <= end


def _tiny_engine(cfg):
    return deepspeed_tpu_torch.initialize(
        config=cfg, model=GPT2.from_size("tiny", **TINY),
        model_parameters=init_params(), device="cpu")[0]


def test_lamb_under_zero_raises_the_jax_message():
    cfg = config(1, 1, "bf16", {"stage": 1})
    cfg["optimizer"] = {"type": "Lamb", "params": {"lr": 1e-3}}
    with pytest.raises(JaxConfigError) as theirs:
        jax_engine(cfg, 1, init_params())
    with pytest.raises(DeepSpeedConfigError) as ours:
        _tiny_engine(cfg)
    assert str(ours.value) == str(theirs.value)
    # stage 3 is ported (tests/test_torch_zero3.py); LAMB stays refused
    # there with the same message
    cfg3 = dict(cfg, zero_optimization={"stage": 3})
    with pytest.raises(JaxConfigError) as theirs:
        jax_engine(cfg3, 1, init_params())
    with pytest.raises(DeepSpeedConfigError) as ours:
        _tiny_engine(cfg3)
    assert str(ours.value) == str(theirs.value)
    with pytest.raises(DeepSpeedConfigError,
                       match="parameter_parallel_size=2 must divide"):
        _tiny_engine(config(1, 1, "bf16", {
            "stage": 1, "parameter_parallel_size": 2}))


def test_one_process_zero_matches_zero_off_bitwise():
    """dp 1 without a process group: stage 1 and 2, overlap on and off,
    give the ZeRO-off engine's losses, masters and moments bit for bit
    (the card's ``zero_gpt2`` phase holds the same with a one-rank NCCL
    group); the masters are one flat partition, the module's parameters
    views of one flat bf16 buffer."""
    toks, labels = lm_data(STEPS, 2 * MICRO)

    def run(zero_cfg):
        engine = _tiny_engine(config(1, 2, "bf16", zero_cfg))
        losses = [float(engine.train_batch((toks[i], labels[i])))
                  for i in range(STEPS)]
        if engine.zero_flat:
            meta = engine.flat_meta
            assert engine.master is None
            assert engine.master_flat.numel() == meta.padded
            for p in engine.module.parameters():
                assert p.untyped_storage().data_ptr() == \
                    engine._params_flat.untyped_storage().data_ptr()
            state = [t[:meta.total] for t in (
                engine.master_flat, engine.opt_state.m["flat"],
                engine.opt_state.v["flat"])]
        else:
            meta = zero.make_flat_meta(engine.master, 1)
            state = [zero.flatten_tree(d, meta)[:meta.total] for d in (
                engine.master, engine.opt_state.m, engine.opt_state.v)]
        return losses, state

    ref_losses, ref = run(None)
    bucket = {"comm_bucket_mb": 0.004}
    for zero_cfg in ({"stage": 1, "overlap_comm": False},
                     {"stage": 1, **bucket}, {"stage": 2, **bucket},
                     {"stage": 2, "overlap_comm": False}):
        losses, state = run(zero_cfg)
        assert losses == ref_losses, zero_cfg
        assert all(torch.equal(a, b) for a, b in zip(state, ref)), zero_cfg


def test_overlap_env_and_bucket_elems(monkeypatch):
    engine = _tiny_engine(config(1, 1, "bf16", {"stage": 1}))
    assert engine.overlap_comm and engine.comm_bucket_elems == 8388608
    assert engine.zero_optimization() and engine.zero_stage == 1
    assert engine.flat_meta.partition == engine.flat_meta.padded
    monkeypatch.setenv("DSTPU_OVERLAP", "off")
    assert not _tiny_engine(config(1, 1, "bf16", {"stage": 1})).overlap_comm
    monkeypatch.setenv("DSTPU_OVERLAP", "sometimes")
    with pytest.raises(DeepSpeedConfigError, match="DSTPU_OVERLAP"):
        _tiny_engine(config(1, 1, "bf16", {"stage": 1}))
