"""Checkpoints and ZeRO under pipeline parallelism, and the two packages
reading each other's per-stage files.

One launch of two gloo CPU ranks at pp 2 (``tests/torch_rank_worker.py``)
trains the tiny 4-layer GPT-2 of ``tests/test_torch_pipeline.py`` in bf16
(computing in fp32) with Adam: run A of 4 steps saved after step 2 and
run B, a fresh engine from other weights that loads it and takes steps
3-4, with ZeRO off and with ZeRO-1; a load of a JAX pp 2 save; a save of
one step re-saved under the same tag at pp 1 (dp 2); and a ZeRO-1 engine
at pp 1 loading the pp 2 ZeRO-1 save, which must raise the JAX engine's
error before its weights-only load.  (The resume at pp 2 x mp 2 runs in
``tests/test_torch_pipeline.py``'s four-rank launch.)

Files: one model-state file per (stage, model rank),
``pp_stage_{pp:02d}_mp_rank_{mp:02d}_model_states.pt``, and the ZeRO
partition files keyed by the row ``pp_stage * mp + mp_rank``.  A resume
equals the unbroken run bitwise; ZeRO-1 at pp 2 equals ZeRO off at pp 2
bitwise (dp 1: the flat partition is the whole layout, the update the
same kernel arithmetic per element).  The JAX ``GPT2Pipelined`` engine at
pp 2 loads the port's files and the port loads the JAX engine's, with
equal weights (and, port to JAX, equal masters and moments).
"""

import os

import jax
import numpy as np
import pytest

import deepspeed_tpu
from deepspeed_tpu.models import GPT2Pipelined as JGPT2Pipelined
from deepspeed_tpu.parallel.topology import make_mesh
from deepspeed_tpu_torch import checkpoint as ck
from deepspeed_tpu_torch import weights
from test_torch_pipeline import (B, MODEL_SPECS, PIPE_SPECS, SEQ, TINY4,
                                 VOCAB, config, global_state, init_params)
from torch_ranks import run_ranks

STEPS, SAVE_AT = 4, 2
ZERO1 = {"stage": 1}
TAG = f"global_step{SAVE_AT}"


def cfg(zero=None, prec="bf16"):
    extra = {} if zero is None else {"zero_optimization": zero}
    return config(prec=prec, **extra)


def run(name, pp=2, **kw):
    return {"name": name, "model": "pipe", "layers": 4, "pp": pp,
            "micro_batches": 2, "fp32_compute": True, "leaves": True, **kw}


def _by_run(outs, runs):
    return {r["name"]: [{k.split("/", 1)[1]: v for k, v in o.items()
                         if k.startswith(f"{i}/")} for o in outs]
            for i, r in enumerate(runs)}


def jax_engine(zero=None, prec="bf16", key=7):
    model = JGPT2Pipelined.from_size("tiny", num_micro_batches=2, **TINY4)
    engine, _, _, _ = deepspeed_tpu.initialize(
        config=cfg(zero, prec), model=model,
        model_parameters=init_params(key),
        mesh=make_mesh(pipeline_parallel_size=2,
                       devices=jax.devices()[:2]))
    return engine


def _np(tree):
    return weights.flatten_tree(jax.tree_util.tree_map(
        lambda x: np.asarray(x).astype(np.float32), tree))


@pytest.fixture(scope="module")
def saves(tmp_path_factory):
    work = tmp_path_factory.mktemp("pipe_ckpt")
    d = {k: str(work / k) for k in ("off", "zero", "jax", "resave")}
    # a JAX save at pp 2 (fp32, its init weights)
    jeng = jax_engine(prec="fp32", key=9)
    jeng.save_checkpoint(d["jax"])
    jparams = _np(jeng.params)
    del jeng
    rng = np.random.default_rng(3)
    toks = rng.integers(0, VOCAB, (STEPS, B, SEQ)).astype(np.int32)
    labels = np.roll(toks, -1, axis=2)
    labels[..., -1] = -1
    inputs = {f"w/{k}": v for k, v in
              weights.flatten_tree(init_params()).items()}
    inputs.update({f"w2/{k}": v for k, v in
                   weights.flatten_tree(init_params(8)).items()})
    inputs.update(tokens=toks, labels=labels)
    runs2 = []
    for name, zero in (("off", None), ("zero", ZERO1)):
        runs2 += [run(f"{name}_a", config=cfg(zero), steps=STEPS,
                      save_after=SAVE_AT, save_dir=d[name]),
                  run(f"{name}_b", config=cfg(zero), steps=STEPS - SAVE_AT,
                      load=d[name], weights="w2", first_batch=SAVE_AT)]
    runs2 += [
        run("jax_load", config=cfg(prec="fp32"), steps=0, load=d["jax"],
            weights="w2"),
        run("resave_pp2", config=cfg(), steps=1, save_after=1,
            save_dir=d["resave"], save_tag="t"),
        run("resave_pp1", pp=1, config=cfg(), steps=1, save_after=1,
            save_dir=d["resave"], save_tag="t", load=d["resave"],
            weights="w2", first_batch=1),
        run("cross_pp_zero", pp=1, config=cfg(ZERO1), steps=0,
            load=d["zero"], load_error=True, weights="w2"),
    ]
    outs = run_ranks(work / "ranks", 2, {"scenario": "train", "runs": runs2},
                     inputs)
    return {"dirs": d, "jax_params": jparams, **_by_run(outs, runs2)}


def test_per_stage_files(saves):
    d = saves["dirs"]
    stages = [f"pp_stage_{s:02d}_mp_rank_{m:02d}_model_states.pt"
              for s in range(2) for m in range(1)]
    assert sorted(os.listdir(os.path.join(d["off"], TAG))) == stages
    assert sorted(os.listdir(os.path.join(d["zero"], TAG))) == stages + [
        f"zero_pp_rank_0_mp_rank_{row:02d}optim_states.pt"
        for row in range(2)]
    for s in range(2):
        state = ck._load_obj(ck.model_file(d["off"], TAG, 0, s, 2))
        assert (state["pp_stage"], state["pp_world_size"]) == (s, 2)
        # the stage's two of the four layers
        assert ck.to_tensor(state["module"]["blocks"]["qkv_w"]).shape[0] == 2
        zstate = ck._load_obj(ck.zero_file(d["zero"], TAG, 0, s))
        assert (zstate["mp_rank"], zstate["pp_world_size"]) == (s, 2)


@pytest.mark.parametrize("name", ["off", "zero"])
def test_resume_equals_unbroken_run(saves, name):
    """Steps 3-4 of the resumed run equal the unbroken run's bitwise, and
    so do every rank's masters and moments after them."""
    for a, b in zip(saves[f"{name}_a"], saves[f"{name}_b"]):
        np.testing.assert_array_equal(b["losses"], a["losses"][SAVE_AT:])
        keys = [k for k in a if k.startswith(("master/", "m/", "v/",
                                              "param/"))]
        assert keys
        for k in keys:
            np.testing.assert_array_equal(b[k], a[k], err_msg=k)


def test_zero1_equals_zero_off_at_pp2(saves):
    for z, o in zip(saves["zero_a"], saves["off_a"]):
        np.testing.assert_array_equal(z["losses"], o["losses"])
        for k in o:
            if k.startswith(("master/", "m/", "v/")):
                np.testing.assert_array_equal(z[k], o[k], err_msg=k)


def test_jax_pp2_checkpoint_loads_into_the_port(saves):
    got = global_state(saves["jax_load"], "param")
    assert got.keys() == saves["jax_params"].keys()
    for k, want in saves["jax_params"].items():
        np.testing.assert_array_equal(got[k], want, err_msg=k)


def test_port_pp2_checkpoint_loads_into_jax(saves):
    """The JAX GPT2Pipelined engine at pp 2 loads the port's ZeRO-off save:
    its weights, masters and moments equal the port's files, joined."""
    d = saves["dirs"]
    engine = jax_engine(key=11)
    engine.load_checkpoint(d["off"], tag=TAG)
    files = [ck._load_obj(ck.model_file(d["off"], TAG, 0, s, 2))
             for s in range(2)]

    def joined(get):
        trees = [{k: ck.to_tensor(v).float().numpy() for k, v in
                  weights.flatten_tree(get(f)).items()} for f in files]
        return weights.flatten_tree(weights.combine_stage_trees(
            trees, MODEL_SPECS, 1, PIPE_SPECS))

    st = engine.opt_state
    for live, get in (
            (engine.params, lambda f: f["module"]),
            (engine.master, lambda f: f["optimizer"]["master"]),
            (st.m, lambda f: f["optimizer"]["opt_state"]["m"]),
            (st.v, lambda f: f["optimizer"]["opt_state"]["v"])):
        want, got = joined(get), _np(live)
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert int(np.asarray(st.step)) == SAVE_AT


def test_resave_at_another_pp_leaves_no_stale_files(saves):
    """The pp 2 save of tag ``t`` re-saved at pp 1: only the pp 1 file is
    left, and the pp 1 run (dp 2) loaded the pp 2 save (weights and
    optimizer state re-cut) before its step: its two data ranks' mean loss
    is the unbroken pp 2 run's second (every row has 15 labels)."""
    for o in saves["resave_pp1"]:
        assert str(o["files"]).split("\n") == ["mp_rank_00_model_states.pt"]
    assert str(saves["resave_pp2"][0]["files"]).count("pp_stage_") == 2
    np.testing.assert_allclose(
        np.mean([o["losses"][0] for o in saves["resave_pp1"]]),
        saves["off_a"][0]["losses"][1], rtol=1e-6)


def test_cross_pp_zero_restore_raises(saves):
    for o in saves["cross_pp_zero"]:
        assert "pipeline_parallel_size=2" in str(o["load_error"])
        assert "pp=1" in str(o["load_error"])
