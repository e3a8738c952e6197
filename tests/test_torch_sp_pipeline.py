"""ZeRO-3 and sequence parallelism under the pipe axis, against the JAX
engine at the same meshes.

One launch of four gloo CPU ranks (``tests/torch_rank_worker.py``) trains
the tiny 4-layer GPT-2 of ``tests/test_torch_pipeline.py`` (batch 8, 2
pipeline micro-batches, 3 steps; the labels' last position ignored):

* ZeRO-3 at dp 2 x pp 2, bf16 weights computing in fp32, GPipe (saved
  after step 2) and 1F1B, against ZeRO off at the same mesh within the
  JAX ``test_zero3_with_pipeline`` tolerance (``rtol=5e-3, atol=5e-3``)
  and against the JAX engine's ZeRO-3 at dp 2 x pp 2 within ``rtol=1e-3``
  (the two frameworks round the bf16 gradients' sums in other orders).
  Each rank holds 1/2 of its stage's partitioned leaves (1/4 of the
  model's), and its shard file's row is ``pp_stage * mp + mp_rank``.  A
  fresh engine resumes the port's save bitwise; the port loads the JAX
  engine's ZeRO-3 x PP save and the JAX engine loads the port's, each
  continuing with the saver's next loss (``rtol=1e-5``: the same state
  and step, fp32 compute).
* pp 2 x sp 2 (dp 1), fp32, ring attention inside the stage body, GPipe
  and 1F1B, against the JAX ``GPT2Pipelined`` with GPipe at pp 2 x sp 2
  (the JAX ``test_pipelined_with_context_parallel``'s ``rtol=2e-4,
  atol=2e-5``; the JAX 1F1B at this mesh aborts in XLA's CPU collective
  permute, a rendezvous check, so it cannot serve, and the two schedules
  compute the same loss).
  Under pp > 1 the JAX head counts the valid tokens per sequence block, so
  its loss is the mean of the blocks' means, not the global token mean
  that the plain model (and the port at pp 1) computes.  These runs ignore
  the last 6 labels of every row (``sp_labels``), so the second block
  holds 2 valid tokens a row to the first's 8, and the two means differ
  by far more than the tolerance: the port computes what the JAX engine
  computes (ROADMAP Queue 3, the pp x sp loss).
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import deepspeed_tpu
from deepspeed_tpu.models import GPT2 as JGPT2
from deepspeed_tpu.models import GPT2Pipelined as JGPT2Pipelined
from deepspeed_tpu.parallel.topology import make_mesh
from deepspeed_tpu_torch import weights
from test_torch_pipeline import (ATOL, RTOL, STEPS, TINY4, config,
                                 init_params, lm_data)
from torch_ranks import run_ranks

WORLD, SAVE_AT, M = 4, 2, 2
TAG = f"global_step{SAVE_AT}"
Z3_TOL = dict(rtol=5e-3, atol=5e-3)
Z3_JAX_RTOL = 1e-3
LOAD_RTOL = 1e-5


class Fp32JGPT2Pipelined(JGPT2Pipelined):
    """The JAX pipelined GPT-2 computing in fp32 whatever its weights'
    dtype (the worker's ``Fp32GPT2Pipelined``)."""

    def apply(self, params, *batch):
        return super().apply(jax.tree_util.tree_map(
            lambda x: x.astype(jnp.float32), params), *batch)


def zero_cfg(stage, **extra):
    return config(prec="bf16", zero_optimization={"stage": stage}, **extra)


def pipe_run(**kw):
    return dict({"model": "pipe", "layers": 4, "pp": 2, "micro_batches": M,
                 "steps": STEPS, "leaves": True}, **kw)


def jax_engine(cfg, sp=1, schedule="gpipe", fp32_compute=False, key=7):
    cls = Fp32JGPT2Pipelined if fp32_compute else JGPT2Pipelined
    model = cls.from_size("tiny", num_micro_batches=M, schedule=schedule,
                          **TINY4)
    engine, _, _, _ = deepspeed_tpu.initialize(
        config=cfg, model=model, model_parameters=init_params(key),
        mesh=make_mesh(pipeline_parallel_size=2, context_parallel_size=sp,
                       devices=jax.devices()[:WORLD]))
    return engine


def sp_labels():
    """``lm_data()``'s labels with the last 6 positions ignored."""
    labels = lm_data()[1].copy()
    labels[..., -6:] = -1
    return labels


def jax_steps(engine, steps, first=0, norms=None, labels=None):
    """The engine's losses on batches ``first ..``; its global grad norms
    appended to ``norms`` when given."""
    toks, lm_labels = lm_data()
    labels = lm_labels if labels is None else labels
    out = []
    for i in range(first, first + steps):
        out.append(float(engine.train_batch((toks[i], labels[i]))))
        if norms is not None:
            norms.append(float(engine._last_grad_norm))
    return out


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    work = tmp_path_factory.mktemp("sp_pipeline")
    d = {k: str(work / k) for k in ("port", "jax")}
    # the JAX ZeRO-3 x PP run, saved after SAVE_AT steps
    jeng, jn = jax_engine(zero_cfg(3), fp32_compute=True), []
    jl = jax_steps(jeng, SAVE_AT, norms=jn)
    jeng.save_checkpoint(d["jax"])
    jl += jax_steps(jeng, STEPS - SAVE_AT, first=SAVE_AT, norms=jn)
    del jeng
    toks, labels = lm_data()
    inputs = {f"w/{k}": v for k, v in
              weights.flatten_tree(init_params()).items()}
    inputs.update({f"w2/{k}": v for k, v in
                   weights.flatten_tree(init_params(8)).items()})
    inputs.update(tokens=toks, labels=labels, sp_labels=sp_labels())
    runs = {
        "z3_gpipe": pipe_run(config=zero_cfg(3), fp32_compute=True,
                             save_after=SAVE_AT, save_dir=d["port"]),
        "z3_1f1b": pipe_run(config=zero_cfg(3, pipeline_schedule="1f1b"),
                            fp32_compute=True),
        "z0": pipe_run(config=zero_cfg(0), fp32_compute=True),
        "z3_resume": pipe_run(config=zero_cfg(3), fp32_compute=True,
                              weights="w2", load=d["port"],
                              first_batch=SAVE_AT, steps=STEPS - SAVE_AT),
        "z3_load_jax": pipe_run(config=zero_cfg(3), fp32_compute=True,
                                weights="w2", load=d["jax"],
                                first_batch=SAVE_AT, steps=1),
        "sp_gpipe": pipe_run(config=config(), sp=2,
                             batch_keys=["tokens", "sp_labels"]),
        "sp_1f1b": pipe_run(config=config(pipeline_schedule="1f1b"), sp=2,
                            batch_keys=["tokens", "sp_labels"]),
    }
    outs = run_ranks(work / "ranks", WORLD,
                     {"scenario": "train", "runs": list(runs.values())},
                     inputs)
    per = {name: [{k.split("/", 1)[1]: v for k, v in o.items()
                   if k.startswith(f"{i}/")} for o in outs]
           for i, name in enumerate(runs)}
    return {"runs": per, "dirs": d, "jax": jl, "jax_norms": jn}


def _same_on_every_rank(outs):
    for o in outs[1:]:
        np.testing.assert_array_equal(o["losses"], outs[0]["losses"])
        np.testing.assert_array_equal(o["grad_norms"], outs[0]["grad_norms"])


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
def test_zero3_pp2_matches_stage0_and_jax(port, schedule):
    runs = port["runs"]
    z3 = runs[f"z3_{schedule}"]
    # dp 2 x pp 2: every rank's mean over its data group
    mean = lambda outs: np.mean([o["losses"] for o in outs
                                 if o["topo/coords"][1] == 0], axis=0)
    for o in z3:
        assert str(o["schedule"]) == schedule
    np.testing.assert_allclose(mean(z3), mean(runs["z0"]), **Z3_TOL)
    np.testing.assert_allclose(mean(z3), port["jax"], rtol=Z3_JAX_RTOL)
    # every stage of a data rank reports its loss; the norm is global
    for dpr in range(2):
        _same_on_every_rank([o for o in z3 if o["topo/coords"][0] == dpr])
    for o in z3:
        np.testing.assert_allclose(o["grad_norms"], port["jax_norms"],
                                   rtol=Z3_JAX_RTOL)


def test_zero3_pp2_partitions_each_stage_over_the_data_group(port):
    glob = weights.flatten_tree(init_params())
    for o in port["runs"]["z3_gpipe"]:
        dims = {k[len("z3dim/"):]: int(v) for k, v in o.items()
                if k.startswith("z3dim/")}
        assert dims["blocks.qkv_w"] >= 1 and dims["wte"] >= 0
        # 1/2 of the stage's [L / 2, ...] stack, 1/4 of the model's
        assert o["master/blocks.qkv_w"].size * 4 == glob[
            "blocks.qkv_w"].size
        assert o["master/wte"].size * 2 == glob["wte"].size
        assert o["param/blocks.qkv_w"].shape[0] == 2
    files = sorted(os.listdir(os.path.join(port["dirs"]["port"], TAG)))
    assert files == sorted(
        [f"pp_stage_{s:02d}_mp_rank_00_model_states.pt" for s in range(2)]
        + [f"zero3_dp_rank_{d}_row_{s:02d}_states.pt" for d in range(2)
           for s in range(2)])


def test_zero3_pp2_checkpoints_resume_and_cross_the_packages(port):
    runs = port["runs"]
    base = runs["z3_gpipe"]
    for a, b in zip(base, runs["z3_resume"]):
        np.testing.assert_array_equal(b["losses"], a["losses"][SAVE_AT:])
        for k in a:
            if k.startswith(("master/", "m/", "v/")):
                np.testing.assert_array_equal(b[k], a[k], err_msg=k)
    # the JAX save into the port
    got = np.mean([o["losses"][0] for o in runs["z3_load_jax"]
                   if o["topo/coords"][1] == 0])
    np.testing.assert_allclose(got, port["jax"][SAVE_AT], rtol=LOAD_RTOL)
    # the port's save into the JAX engine (fresh, from other weights)
    jeng = jax_engine(zero_cfg(3), fp32_compute=True, key=8)
    jeng.load_checkpoint(port["dirs"]["port"], tag=TAG)
    want = np.mean([o["losses"][SAVE_AT] for o in base
                    if o["topo/coords"][1] == 0])
    np.testing.assert_allclose(jax_steps(jeng, 1, first=SAVE_AT)[0], want,
                               rtol=LOAD_RTOL)


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
def test_pp2_sp2_matches_jax_at_the_same_mesh(port, schedule):
    outs = port["runs"][f"sp_{schedule}"]
    # rank = pp_rank * sp + sp_rank at dp 1
    assert [list(o["topo/coords"]) for o in outs] == [
        [0, r // 2, 0, r % 2] for r in range(WORLD)]
    _same_on_every_rank(outs)
    want, norms, first = jax_pp2_sp2()
    np.testing.assert_allclose(outs[0]["losses"], want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(outs[0]["grad_norms"], norms, rtol=RTOL,
                               atol=ATOL)
    # the mean of the blocks' means is not the plain model's global mean
    assert abs(outs[0]["losses"][0] - first) > RTOL * abs(first) + ATOL


@functools.lru_cache(maxsize=None)
def jax_pp2_sp2():
    """The JAX GPipe at pp 2 x sp 2 on ``sp_labels()``: its losses and
    grad norms, and the plain model's first loss on the same batch."""
    norms = []
    want = jax_steps(jax_engine(config(), sp=2), STEPS, norms=norms,
                     labels=sp_labels())
    plain, _, _, _ = deepspeed_tpu.initialize(
        config=config(), model=JGPT2.from_size("tiny", **TINY4),
        model_parameters=init_params(),
        mesh=make_mesh(devices=jax.devices()[:1]))
    return want, norms, jax_steps(plain, 1, labels=sp_labels())[0]
