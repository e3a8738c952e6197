"""Pipeline parallelism of the port against the JAX package.

The port's stages are gloo CPU ranks (``tests/torch_rank_worker.py``, one
process per rank); the oracles are the JAX package's.  Two launches:

* two ranks at pp 2 (dp 1): GPipe with the sharded (scatter-collect)
  head, 1F1B through the ``pipeline_schedule`` override (and its eval
  loss), both schedules at micro-batch size 1 (the head on the last stage
  alone, warning once), fp16 with clipping, SGD under both schedules (the
  gradient scale), and the fused ``train_batch`` against the split API;
* four ranks: the raw schedules at pp 4 against the blocks' plain
  ``stack_apply`` (with 1F1B's held stage inputs counted), GPipe and 1F1B
  at pp 4, GPipe at pp 2 x mp 2 (from a ``MeshConfig``), ZeRO-1 and
  ZeRO-2 at dp 2 x pp 2 and the topology of these, and ZeRO-1 at pp 2 x
  mp 2 saved after step 1 and resumed by fresh ranks (its files).

The model is the tiny 4-layer GPT-2 of the JAX pipeline tests (vocab 64,
seq 16, hidden 32, 4 heads), batch 8, 3 steps.  The JAX tests pin the
pipelined GPT-2 to the plain one (``tests/test_pipeline.py``), so the
oracle is the plain JAX GPT-2 on the same global batch: each JAX run is
computed once per module.  Tolerances are the JAX tests' own: losses
``rtol=2e-4, atol=2e-5`` (fp32), the raw schedules ``rtol=2e-5,
atol=2e-5``, fp16 with clipping ``rtol=2e-3, atol=1e-3``, SGD losses
``rtol=2e-5, atol=2e-6`` and masters ``rtol=2e-4, atol=2e-5``.  The fp32
masters and moments of the Adam runs, and every run's global grad norm
(the engines' ``_last_grad_norm``: Adam hides a wrong clip factor, the
norm does not), are held to the loss tolerance.
ZeRO at dp 2 x pp 2 computes in fp32 on bf16 weights (as
``tests/test_torch_zero.py``, whose ``LOW_PRECISION`` bounds it takes);
the port sums the stages' partial gradients of the leaves every stage
holds in fp32 before they are rounded, so it stays on the JAX engine's
pp 1 trajectory, which it is held to.  Within ``LOW_PRECISION`` of the
port's own dp 2 run at pp 1 (the pipeline's part: the stages' partial
sums add in another order, and a gradient within that of a bf16 midpoint
rounds one ulp apart; measured: master 2.8e-6, m 1.5e-6).  Against the
JAX engine the port at pp 1, without any pipeline code, already leaves
``LOW_PRECISION``'s master atol on this 4-layer model (1.13e-5 in
``fc_w``, 1.37e-5 in ``qkv_w``, one element each, the same digits at pp 2:
one bf16 ulp of a gradient where ``sqrt(v)`` is near ``eps``), so the
masters there are held to ``ZERO_MASTER_ATOL``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu import zero as jzero
from deepspeed_tpu.models import GPT2 as JGPT2
from deepspeed_tpu.models import transformer as JT
from deepspeed_tpu.parallel.topology import make_mesh
from deepspeed_tpu_torch import weights
from deepspeed_tpu_torch.models import GPT2, GPT2Pipelined
from test_torch_zero import LOW_PRECISION, Fp32JGPT2
from torch_rank_worker import TINY
from torch_ranks import run_ranks

TINY4 = dict(TINY, num_layers=4)
VOCAB, SEQ, HIDDEN = TINY["vocab_size"], TINY["max_seq_len"], \
    TINY["hidden_size"]
B, STEPS = 8, 3
RTOL, ATOL = 2e-4, 2e-5                  # the JAX pipeline tests' own
RAW_RTOL, RAW_ATOL = 2e-5, 2e-5
FP16_RTOL, FP16_ATOL = 2e-3, 1e-3
SGD_LOSS = (2e-5, 2e-6)
SGD_MASTER = (2e-4, 2e-5)
LR = 1e-3
ZERO_MASTER_ATOL = 2e-5
ZERO_TOL = dict(LOW_PRECISION,
                master=(LOW_PRECISION["master"][0], ZERO_MASTER_ATOL))
RAW_CONFIG = dict(vocab_size=VOCAB, max_seq_len=SEQ, hidden_size=HIDDEN,
                  num_layers=4, num_heads=4, causal=True, remat=False)
MODEL_SPECS = weights.flatten_tree(
    GPT2.from_size("tiny", **TINY4).partition_specs())
PIPE_SPECS = weights.flatten_tree(
    GPT2Pipelined.from_size("tiny", **TINY4).pipe_specs())


def config(opt="Adam", lr=LR, prec="fp32", gas=1, **extra):
    cfg = {"train_batch_size": B, "gradient_accumulation_steps": gas,
           "steps_per_print": 10 ** 9,
           "optimizer": {"type": opt, "params": {"lr": lr}}}
    if opt == "Adam":
        cfg["optimizer"]["params"]["eps"] = 1e-6
    if prec == "bf16":
        cfg["bf16"] = {"enabled": True}
    elif prec == "fp16":
        cfg["fp16"] = {"enabled": True, "initial_scale_power": 8}
    cfg.update(extra)
    return cfg


def init_params(key=7):
    jm = JGPT2.from_size("tiny", **TINY4)
    return jax.tree_util.tree_map(np.asarray,
                                  jm.init_params(jax.random.PRNGKey(key)))


def lm_data(seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, VOCAB, (STEPS, B, SEQ)).astype(np.int32)
    labels = np.roll(toks, -1, axis=2)
    labels[..., -1] = -1
    return toks, labels


def raw_inputs():
    """The raw cases' blocks (global), micro-batches and head weights."""
    blocks = JT.init_block_params(JT.TransformerConfig(**RAW_CONFIG),
                                  jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)
    out = {f"blk/{k}": np.asarray(v) for k, v in blocks.items()}
    for name, (m, mb) in RAW_CASES.items():
        out[f"rx/{name}"] = rng.normal(size=(m, mb, SEQ, HIDDEN)).astype(
            np.float32)
        out[f"rw/{name}"] = rng.normal(size=(m, mb, SEQ, HIDDEN)).astype(
            np.float32)
    return out


#: raw cases at pp 4: (micro-batches, micro-batch size)
RAW_CASES = {"sharded": (2, 4), "long": (8, 4)}


def pipe_run(name, m=2, schedule="gpipe", pp=2, fp32=False, **kw):
    return {"name": name, "model": "pipe", "layers": 4, "pp": pp,
            "micro_batches": m, "schedule": schedule, "steps": STEPS,
            "fp32_compute": fp32, **kw}


PP2_RUNS = [
    pipe_run("gpipe", config=config()),
    pipe_run("1f1b", config=config(pipeline_schedule="1f1b"), eval=True),
    pipe_run("gpipe_fallback", m=8, config=config()),
    pipe_run("1f1b_fallback", m=8, schedule="1f1b", config=config()),
    pipe_run("fp16_clip", fp32=True,
             config=config(prec="fp16", gradient_clipping=0.1)),
    pipe_run("sgd_gpipe", steps=2, config=config("SGD", 0.5)),
    pipe_run("sgd_1f1b", steps=2, schedule="1f1b", config=config("SGD", 0.5)),
    pipe_run("fused", config=config(gas=2)),
    pipe_run("split", split=True, config=config(gas=2)),
    # dp 2 at pp 1: the plain GPT-2 the ZeRO x PP runs are held to
    {"name": "dp2_zero1_pp1", "layers": 4, "steps": STEPS,
     "fp32_compute": True, "leaves": True,
     "config": config(prec="bf16", zero_optimization={"stage": 1})},
]
ZERO1_BF16 = config(prec="bf16", zero_optimization={"stage": 1})


def pp4_runs(ckpt):
    """The four-rank runs; ``mp_a`` saves after step 1 into ``ckpt``,
    ``mp_b`` (other weights) resumes it."""
    return [
        {"name": f"raw_{case}", "scenario": "pipe_raw", "config": RAW_CONFIG,
         "schedules": ["gpipe", "1f1b"], "x": f"rx/{case}",
         "w": f"rw/{case}"} for case in RAW_CASES] + [
        pipe_run("pp4_gpipe", pp=4, config=config()),
        pipe_run("pp4_1f1b", pp=4, schedule="1f1b", config=config()),
        pipe_run("pp2_mp2", mp=2, mesh=True, config=config()),
        pipe_run("dp2_pp2_zero1", fp32=True, leaves=True, config=ZERO1_BF16),
        pipe_run("dp2_pp2_zero2", fp32=True, leaves=True,
                 config=config(prec="bf16", zero_optimization={"stage": 2})),
        pipe_run("mp_a", mp=2, fp32=True, leaves=True, config=ZERO1_BF16,
                 save_after=1, save_dir=ckpt),
        pipe_run("mp_b", mp=2, fp32=True, leaves=True, config=ZERO1_BF16,
                 steps=STEPS - 1, first_batch=1, load=ckpt, weights="w2")]


def _by_run(outs, runs):
    return {run["name"]: [{k.split("/", 1)[1]: v for k, v in o.items()
                           if k.startswith(f"{i}/")} for o in outs]
            for i, run in enumerate(runs)}


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    toks, labels = lm_data()
    inputs = {f"w/{k}": v for k, v in
              weights.flatten_tree(init_params()).items()}
    inputs.update({f"w2/{k}": v for k, v in
                   weights.flatten_tree(init_params(8)).items()})
    inputs.update(tokens=toks, labels=labels, **raw_inputs())
    work = tmp_path_factory.mktemp("pipeline")
    out = {}
    for world, runs in ((2, PP2_RUNS), (4, pp4_runs(str(work / "ckpt")))):
        outs = run_ranks(work / f"w{world}", world,
                         {"scenario": "train", "runs": runs}, inputs)
        out.update(_by_run(outs, runs))
    return out


def _np_tree(tree):
    return weights.flatten_tree(jax.tree_util.tree_map(
        lambda x: np.asarray(x, np.float32), tree))


def jax_run(cfg, steps=STEPS, dp=1, fp32_compute=False):
    """The plain JAX GPT-2's losses and per-leaf master, m and v."""
    model = (Fp32JGPT2 if fp32_compute else JGPT2).from_size("tiny",
                                                             **TINY4)
    engine, _, _, _ = deepspeed_tpu.initialize(
        config=cfg, model=model, model_parameters=init_params(),
        mesh=make_mesh(devices=jax.devices()[:dp]))
    toks, labels = lm_data()
    losses, norms = [], []
    for i in range(steps):
        losses.append(float(engine.train_batch((toks[i], labels[i]))))
        norms.append(float(engine._last_grad_norm))
    st = engine.opt_state
    if engine.zero_flat:
        state = {k: _np_tree(jzero.unflatten_tree(
            jnp.asarray(flat)[:engine.flat_meta.padded], engine.flat_meta))
            for k, flat in (("master", engine.master_flat),
                            ("m", st.m["flat"]), ("v", st.v["flat"]))}
    else:
        state = {"master": _np_tree(engine.master)}
        state.update({k: _np_tree(t) for k, t in (("m", st.m), ("v", st.v))
                      if t is not None})
    ls = engine.loss_scale_state
    return {"losses": losses, "grad_norms": norms, "state": state,
            "cur_scale": float(ls.cur_scale),
            "skipped": int(engine.skipped_steps)}


@pytest.fixture(scope="module")
def oracle():
    return {"adam": jax_run(config()),
            "fp16_clip": jax_run(config(prec="fp16", gradient_clipping=0.1),
                                 fp32_compute=True),
            "sgd": jax_run(config("SGD", 0.5), steps=2),
            "zero": jax_run(config(prec="bf16",
                                   zero_optimization={"stage": 1}),
                            dp=2, fp32_compute=True)}


def global_state(outs, key="master"):
    """``key``'s global flat tree: data rank 0's (stage, model rank)
    local leaves joined."""
    mp = max(int(o["topo/coords"][2]) for o in outs) + 1
    rows = sorted((tuple(o["topo/coords"][1:]), o) for o in outs
                  if int(o["topo/coords"][0]) == 0)
    local = [{k.split("/", 1)[1]: v for k, v in o.items()
              if k.startswith(key + "/")} for _, o in rows]
    return weights.flatten_tree(weights.combine_stage_trees(
        local, MODEL_SPECS, mp, PIPE_SPECS))


def assert_state(outs, want, tol, keys=("master", "m", "v")):
    for key in keys:
        got = global_state(outs, key)
        assert got.keys() == want[key].keys()
        rtol, atol = tol[key] if isinstance(tol, dict) else tol
        for name, w in want[key].items():
            np.testing.assert_allclose(got[name], w, rtol=rtol, atol=atol,
                                       err_msg=f"{key} {name}")


def assert_losses(outs, want, rtol, atol):
    """Every rank's losses and global grad norms equal rank 0's, and
    within ``rtol``/``atol`` of the JAX run ``want``'s."""
    for o in outs:
        np.testing.assert_array_equal(o["losses"], outs[0]["losses"])
        np.testing.assert_array_equal(o["grad_norms"],
                                      outs[0]["grad_norms"])
    np.testing.assert_allclose(outs[0]["losses"], want["losses"], rtol=rtol,
                               atol=atol)
    np.testing.assert_allclose(outs[0]["grad_norms"], want["grad_norms"],
                               rtol=rtol, atol=atol)


@pytest.fixture(scope="module")
def raw_oracle():
    """Per raw case, the plain JAX ``stack_apply``'s loss ``sum(y * w)``
    and its gradients (blocks, x)."""
    inputs = raw_inputs()
    cfg = JT.TransformerConfig(**RAW_CONFIG)
    blocks = {k[4:]: v for k, v in inputs.items() if k.startswith("blk/")}
    mesh = make_mesh(devices=jax.devices()[:1])

    def loss(p, xx, w):
        y = JT.stack_apply(xx.reshape((-1,) + xx.shape[2:]), p, cfg)
        return jnp.sum(y * w.reshape(y.shape))

    fn = jax.jit(jax.shard_map(
        jax.value_and_grad(loss, argnums=(0, 1)), mesh=mesh,
        in_specs=(jax.tree_util.tree_map(lambda _: P(), blocks), P(), P()),
        out_specs=(P(), (jax.tree_util.tree_map(lambda _: P(), blocks),
                         P())), check_vma=False))
    return {case: fn(blocks, inputs[f"rx/{case}"], inputs[f"rw/{case}"])
            for case in RAW_CASES}


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
@pytest.mark.parametrize("case", list(RAW_CASES))
def test_raw_schedules_match_stack_apply(port, raw_oracle, case, schedule):
    """pp 4, one layer per stage: the loss ``sum(y * w)``, dx and every
    stage's block gradients equal the plain JAX ``stack_apply``'s."""
    outs = port[f"raw_{case}"]
    want, (gblocks, gx) = raw_oracle[case]
    for r, o in enumerate(outs):
        np.testing.assert_allclose(o[f"{schedule}/loss"], want,
                                   rtol=RAW_RTOL, atol=RAW_ATOL)
        np.testing.assert_allclose(o[f"{schedule}/dx"], gx, rtol=RAW_RTOL,
                                   atol=RAW_ATOL)
        for k, g in gblocks.items():
            np.testing.assert_allclose(
                o[f"{schedule}/g/{k}"], np.asarray(g)[r:r + 1],
                rtol=RAW_RTOL, atol=RAW_ATOL, err_msg=k)


@pytest.mark.parametrize("case", list(RAW_CASES))
def test_1f1b_holds_at_most_min_m_2pp_minus_1_inputs(port, case):
    """Stage s holds the inputs of the micro-batches between its forward
    and its backward: 2 (pp - 1 - s) + 1 of them at most, and at most m;
    the last stage none (its backward runs in the tick of its forward)."""
    m, pp = RAW_CASES[case][0], 4
    held = [int(o["1f1b/held"]) for o in port[f"raw_{case}"]]
    assert held == [min(m, 2 * (pp - 1 - s) + 1) for s in range(pp - 1)] \
        + [0]
    assert max(held) <= min(m, 2 * pp - 1)


@pytest.mark.parametrize("name", ["gpipe", "1f1b", "gpipe_fallback",
                                  "1f1b_fallback", "pp4_gpipe", "pp4_1f1b",
                                  "pp2_mp2"])
def test_fp32_trajectory_matches_jax(port, oracle, name):
    """GPipe and 1F1B at pp 2 and 4, and GPipe at pp 2 x mp 2: the losses,
    masters and Adam moments of the JAX GPT-2 on the same batches."""
    outs, want = port[name], oracle["adam"]
    assert_losses(outs, want, RTOL, ATOL)
    assert_state(outs, want["state"], (RTOL, ATOL))


def test_1f1b_override_and_eval(port):
    """``pipeline_schedule`` beats the model's ``schedule``; the eval
    (forward-only) loss equals the 1F1B schedule's loss."""
    for o in port["1f1b"]:
        assert str(o["schedule"]) == "1f1b"
        assert float(o["eval_loss"]) == pytest.approx(float(o["train_loss"]),
                                                      rel=1e-6)
    assert [str(o["schedule"]) for o in port["gpipe"]] == ["gpipe"] * 2


@pytest.mark.parametrize("name,key", [("gpipe_fallback", "GPipe"),
                                      ("1f1b_fallback", "1F1B")])
def test_unsharded_head_warns_once(port, name, key):
    """Micro-batch size 1 at pp 2: the head runs on the last stage alone,
    and each stage warns once however many steps run."""
    for o in port[name]:
        lines = [ln for ln in str(o["warnings"]).splitlines()
                 if ln.startswith(key + ":")]
        assert len(lines) == 1 and "not divisible by pp=2" in lines[0]


def test_fp16_clipping_matches_jax(port, oracle):
    """fp16 with the dynamic loss scale and clipping at 0.1: the norm over
    the stages (block leaves summed, the others once) and the overflow
    agreement keep the JAX trajectory, norms, skips and loss scale."""
    outs, want = port["fp16_clip"], oracle["fp16_clip"]
    assert_losses(outs, want, FP16_RTOL, FP16_ATOL)
    for o in outs:
        assert int(o["skipped"]) == want["skipped"]
        assert float(o["cur_scale"]) == want["cur_scale"]


@pytest.mark.parametrize("name", ["sgd_gpipe", "sgd_1f1b"])
def test_sgd_scale_and_masters(port, oracle, name):
    """SGD is not invariant to the gradient's scale: a stray factor of pp
    (the JAX engine's psum transpose, which the port does not have) would
    move every master."""
    outs, want = port[name], oracle["sgd"]
    assert_losses(outs, want, *SGD_LOSS)
    assert_state(outs, want["state"], SGD_MASTER, keys=("master",))


def test_fused_train_batch_equals_split(port):
    """gas 2 x 2 pipeline micro-batches: ``train_batch`` and the split
    API take the same steps bitwise."""
    fused, split = port["fused"], port["split"]
    for f, s in zip(fused, split):
        np.testing.assert_array_equal(f["losses"], s["losses"])
        for k in f:
            if k.startswith(("master/", "m/", "v/")):
                np.testing.assert_array_equal(f[k], s[k], err_msg=k)


@pytest.mark.parametrize("name", ["dp2_pp2_zero1", "dp2_pp2_zero2"])
def test_zero_dp2_pp2_matches_jax(port, oracle, name):
    """ZeRO-1 and ZeRO-2 at dp 2 x pp 2 (each (stage, data rank) keeps
    its partition of its stage's flat layout) against the JAX engine's
    ZeRO-1 at dp 2 on the same batches, and against the port at pp 1."""
    outs, want = port[name], oracle["zero"]
    np.testing.assert_allclose(
        np.mean([o["losses"] for o in outs if o["topo/coords"][1] == 0],
                axis=0), want["losses"], rtol=1e-5)
    for o in outs:
        np.testing.assert_allclose(o["grad_norms"], want["grad_norms"],
                                   rtol=1e-5)
    assert_state(outs, want["state"], ZERO_TOL)
    pp1 = port["dp2_zero1_pp1"]
    assert_state(outs, {k: global_state(pp1, k) for k in ("master", "m",
                                                          "v")},
                 LOW_PRECISION)


def test_pp2_mp2_zero1_files_and_resume(port):
    """ZeRO-1 at pp 2 x mp 2: one model file per (stage, model rank), ZeRO
    files keyed by the row ``pp_stage * mp + mp_rank``, and fresh ranks
    from other weights that load the save after step 1 take steps 2-3
    bitwise as the unbroken run (losses, masters, moments, weights)."""
    for o in port["mp_a"]:
        assert str(o["files"]).split("\n") == [
            f"pp_stage_{s:02d}_mp_rank_{m:02d}_model_states.pt"
            for s in range(2) for m in range(2)] + [
            f"zero_pp_rank_0_mp_rank_{row:02d}optim_states.pt"
            for row in range(4)]
    for a, b in zip(port["mp_a"], port["mp_b"]):
        np.testing.assert_array_equal(b["losses"], a["losses"][1:])
        keys = [k for k in a if k.startswith(("master/", "m/", "v/",
                                              "param/"))]
        assert keys
        for k in keys:
            np.testing.assert_array_equal(b[k], a[k], err_msg=k)


@pytest.mark.parametrize("name,dp,pp,mp", [("dp2_pp2_zero1", 2, 2, 1),
                                          ("pp2_mp2", 1, 2, 2)])
def test_topology_ranks_and_groups(port, name, dp, pp, mp):
    """rank = (dp_rank * pp + pp_rank) * mp + mp_rank, and each group the
    ranks that differ from this one on its axis alone."""
    for rank, o in enumerate(port[name]):
        d, s, m = (int(x) for x in o["topo/coords"])
        assert rank == (d * pp + s) * mp + m
        at = lambda dd, ss, mm: (dd * pp + ss) * mp + mm
        assert list(o["topo/model"]) == [at(d, s, k) for k in range(mp)]
        assert list(o["topo/pipe"]) == [at(d, k, m) for k in range(pp)]
        assert list(o["topo/data"]) == [at(k, s, m) for k in range(dp)]


def test_schedule_refusals_and_override_warning(caplog):
    """An unknown schedule raises at the forward (the JAX message); a
    ``pipeline_schedule`` for a model without a schedule field warns; the
    override reaches a one-process GPT2Pipelined."""
    import logging
    import torch
    toks, labels = (torch.from_numpy(x[0]) for x in lm_data())
    model = GPT2Pipelined.from_size("tiny", **TINY4)
    model.schedule = "zigzag"
    engine = deepspeed_tpu_torch.initialize(
        config=config(), model=model, model_parameters=init_params(),
        device="cpu")[0]
    with pytest.raises(ValueError, match="unknown pipeline schedule"):
        engine(toks, labels)
    engine = deepspeed_tpu_torch.initialize(
        config=config(pipeline_schedule="1f1b"),
        model=GPT2Pipelined.from_size("tiny", **TINY4),
        model_parameters=init_params(), device="cpu")[0]
    assert engine.module.schedule == "1f1b"
    with caplog.at_level(logging.WARNING):
        deepspeed_tpu_torch.initialize(
            config=config(pipeline_schedule="1f1b"),
            model=GPT2.from_size("tiny", **TINY4),
            model_parameters=init_params(), device="cpu")
    assert any("no schedule field" in r.getMessage() for r in caplog.records)
