"""Checkpoints under tensor parallelism: one model-state file per model
rank, ZeRO partition files keyed by (dp, mp), round trips, restores across
mp, and the two packages reading each other's mp 2 files.

One launch of two gloo CPU ranks at mp 2 (``tests/torch_rank_worker.py``)
runs tiny GPT-2 in bf16 with Adam: a run A that saves after step 2 of 4,
with ZeRO off and with ZeRO-1, and a run B of each from other weights that
loads it and takes steps 3-4; a load of a JAX mp 2 save; a load of a port
mp 1 save; and a ZeRO load of a port mp 1 ZeRO save, which must raise the
JAX engine's error before the weights-only load.  Model states (and the
optimizer state of a save without ZeRO) load at any mp, combined and cut
by the model's ``partition_specs()``; ZeRO partitions load at the saved mp
only, as in the JAX package (``tests/test_checkpoint_mp.py``).
"""

import os

import jax
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models import GPT2 as JGPT2
from deepspeed_tpu.parallel.topology import make_mesh
from deepspeed_tpu_torch import checkpoint as ck
from deepspeed_tpu_torch import weights
from deepspeed_tpu_torch.models import GPT2
from test_torch_zero import TINY, config, init_params, lm_data, rank_inputs
from torch_ranks import run_ranks

MP, GAS, MICRO = 2, 2, 4
ZERO1 = {"stage": 1, "comm_bucket_mb": 0.004}
SPECS = weights.flatten_tree(GPT2.from_size("tiny", **TINY)
                             .partition_specs())


def cfg(zero=None):
    return config(1, GAS, "bf16", zero)


def _run(outs, i):
    return [{k.split("/", 1)[1]: v for k, v in o.items()
             if k.startswith(f"{i}/")} for o in outs]


def _tensor_tree(tree):
    return {k: ck.to_tensor(v) for k, v in weights.flatten_tree(tree).items()}


def file_trees(d, tag, key="module"):
    """Each model rank's file's ``key`` tree (flat, as CPU tensors)."""
    out = []
    for m in range(MP):
        state = ck._load_obj(ck.model_file(d, tag, m))
        if key == "module":
            tree = state["module"]
        elif key == "master":
            tree = state["optimizer"]["master"]
        else:
            tree = state["optimizer"]["opt_state"][key]
        out.append(_tensor_tree(tree))
    return out


def joined(d, tag, key="module"):
    """The model ranks' ``key`` trees joined into one flat global tree."""
    return weights.flatten_tree(weights.combine_local_trees(
        file_trees(d, tag, key), SPECS))


def port_engine(zero=None, seed=8):
    return deepspeed_tpu_torch.initialize(
        config=cfg(zero), model=GPT2.from_size("tiny", **TINY),
        model_parameters=init_params(seed), device="cpu")[0]


def jax_engine(zero=None, seed=8):
    engine, _, _, _ = deepspeed_tpu.initialize(
        config=cfg(zero), model=JGPT2.from_size("tiny", **TINY),
        model_parameters=init_params(seed),
        mesh=make_mesh(model_parallel_size=MP, devices=jax.devices()[:MP]))
    return engine


def _np(tree):
    return weights.flatten_tree(jax.tree_util.tree_map(
        lambda x: np.asarray(x).astype(np.float32), tree))


@pytest.fixture(scope="module")
def saves(tmp_path_factory):
    work = tmp_path_factory.mktemp("tp_ckpt")
    d = {k: str(work / k) for k in ("off", "zero", "jax", "mp1", "mp1z")}
    toks, labels = lm_data(4, GAS * MICRO)
    # a JAX save at mp 2, and port saves at mp 1 (ZeRO off and on)
    jeng = jax_engine(seed=7)
    for i in range(2):
        jeng.train_batch((toks[i], labels[i]))
    jeng.save_checkpoint(d["jax"])
    jstate = {"master": _np(jeng.master), "m": _np(jeng.opt_state.m),
              "v": _np(jeng.opt_state.v), "param": _np(jeng.params)}
    mp1 = {}
    for name, zero in (("mp1", None), ("mp1z", ZERO1)):
        engine = port_engine(zero, seed=7)
        for i in range(2):
            engine.train_batch((toks[i], labels[i]))
        engine.save_checkpoint(d[name])
        mp1[name] = {k: p.detach().float().numpy().copy()
                     for k, p in engine.module.named_parameters()}
        if zero is None:
            mp1["state"] = {key: {k: t.numpy().copy() for k, t in
                                  tree.items()} for key, tree in (
                ("master", engine.master), ("m", engine.opt_state.m),
                ("v", engine.opt_state.v))}
    runs = []
    for name, zero in (("off", None), ("zero", ZERO1)):
        runs += [{"config": cfg(zero), "mp": MP, "steps": 4, "save_after": 2,
                  "save_dir": d[name]},
                 {"config": cfg(zero), "mp": MP, "steps": 2, "load": d[name],
                  "weights": "w2", "first_batch": 2}]
    runs += [{"config": cfg(), "mp": MP, "steps": 0, "load": d["jax"],
              "weights": "w2"},
             {"config": cfg(), "mp": MP, "steps": 0, "load": d["mp1"],
              "weights": "w2"},
             {"config": cfg(ZERO1), "mp": MP, "steps": 0, "load": d["mp1z"],
              "weights": "w2", "load_error": True}]
    outs = run_ranks(work / "ranks", MP, {"scenario": "train", "runs": runs},
                     rank_inputs(init_params(7), toks, labels,
                                 alt=init_params(8)))
    return {"dirs": d, "runs": [_run(outs, i) for i in range(len(runs))],
            "jax": jstate, "mp1": mp1}


def _shard(flat, r):
    return weights.flatten_tree(weights.shard_tree(flat, SPECS, MP, r))


def test_one_model_file_per_mp_rank(saves):
    d = saves["dirs"]
    assert sorted(os.listdir(os.path.join(d["off"], "global_step2"))) == [
        "mp_rank_00_model_states.pt", "mp_rank_01_model_states.pt"]
    assert sorted(os.listdir(os.path.join(d["zero"], "global_step2"))) == [
        "mp_rank_00_model_states.pt", "mp_rank_01_model_states.pt",
        "zero_pp_rank_0_mp_rank_00optim_states.pt",
        "zero_pp_rank_0_mp_rank_01optim_states.pt"]
    full = weights.flatten_tree(init_params())
    states = [ck._load_obj(ck.model_file(d["off"], "global_step2", m))
              for m in range(MP)]
    trees = [_tensor_tree(s["module"]) for s in states]
    for m, s in enumerate(states):
        assert (s["mp_rank"], s["mp_world_size"]) == (m, MP)
        for name, t in trees[m].items():
            want = full[name].shape
            if SPECS[name] is None:
                assert tuple(t.shape) == want
            else:
                assert t.numel() * MP == np.prod(want), name
    # the split is real: rank 1's slices are not rank 0's
    assert not torch.equal(trees[0]["wte"], trees[1]["wte"])
    for m in range(MP):
        z = ck._load_obj(ck.zero_file(d["zero"], "global_step2", 0, m))
        assert (z["mp_rank"], z["mp_world_size"], z["partition_id"]) == (
            m, MP, 0)


@pytest.mark.parametrize("zero", [False, True])
def test_mp2_round_trip_is_bitwise(saves, zero):
    a, b = saves["runs"][2 * zero], saves["runs"][2 * zero + 1]
    for oa, ob in zip(a, b):
        assert np.array_equal(oa["losses"][2:], ob["losses"])
        for key in oa:
            if key.split("/")[0] in ("master", "m", "v", "param", "step",
                                     "cur_scale", "global_steps"):
                assert np.array_equal(oa[key], ob[key]), key


def test_cross_mp_restore_2_to_1(saves):
    """The mp 2 save loads into an mp 1 engine: its parameters and (ZeRO
    off) masters and moments are the model ranks' slices joined; a ZeRO
    save gives the weights only."""
    d = saves["dirs"]
    module = joined(d["off"], "global_step2")
    engine = port_engine()
    engine.load_checkpoint(d["off"])
    for name, p in engine.module.named_parameters():
        assert torch.equal(p, module[name]), name
    for key in ("master", "m", "v"):
        want = joined(d["off"], "global_step2", key)
        live = engine.master if key == "master" else getattr(
            engine.opt_state, key)
        for name, t in live.items():
            assert torch.equal(t, want[name]), (key, name)
    assert engine.opt_state.step == 2 and engine.global_steps == 2
    toks, labels = lm_data(2, GAS * MICRO, seed=5)
    losses = [float(engine.train_batch((toks[i], labels[i])))
              for i in range(2)]
    assert np.isfinite(losses).all()

    engine = port_engine(ZERO1)
    with pytest.raises(ValueError, match="model_parallel_size=2"):
        engine.load_checkpoint(d["zero"])
    engine = port_engine(ZERO1)
    engine.load_checkpoint(d["zero"], load_optimizer_states=False)
    module = joined(d["zero"], "global_step2")
    for name, p in engine.module.named_parameters():
        assert torch.equal(p, module[name]), name


def test_cross_mp_restore_1_to_2(saves):
    """An mp 1 save loads into mp 2 ranks: each holds its slices of the
    parameters, masters and moments."""
    outs = saves["runs"][5]
    mp1 = saves["mp1"]
    for r, o in enumerate(outs):
        for name, x in _shard(mp1["mp1"], r).items():
            assert np.array_equal(o[f"param/{name}"], x), name
        for key, tree in mp1["state"].items():
            for name, x in _shard(tree, r).items():
                assert np.array_equal(o[f"{key}/{name}"], x), (key, name)
        assert int(o["step"]) == 2


def test_zero_mp_mismatch_errors(saves):
    """A ZeRO save at mp 1 under a ZeRO engine at mp 2 raises the JAX
    engine's error; the weights-only load then takes the weights."""
    for r, o in enumerate(saves["runs"][6]):
        assert "model_parallel_size=1" in str(o["load_error"])
        assert "load_optimizer_states=False" in str(o["load_error"])
        for name, x in _shard(saves["mp1"]["mp1z"], r).items():
            assert np.array_equal(o[f"param/{name}"], x), name
        assert int(o["step"]) == 0


def test_port_reads_a_jax_mp2_checkpoint(saves):
    want = saves["jax"]
    for r, o in enumerate(saves["runs"][4]):
        for key in ("master", "m", "v", "param"):
            for name, x in _shard(want[key], r).items():
                assert np.array_equal(o[f"{key}/{name}"], x), (key, name)
        assert int(o["step"]) == 2 and int(o["global_steps"]) == 2


@pytest.mark.parametrize("zero", [False, True])
def test_jax_reads_a_port_mp2_checkpoint(saves, zero):
    d = saves["dirs"]["zero" if zero else "off"]
    jeng = jax_engine(ZERO1 if zero else None, seed=9)
    jeng.load_checkpoint(d, tag="global_step2")
    module = joined(d, "global_step2")
    for name, x in _np(jeng.params).items():
        assert np.array_equal(x, module[name].float().numpy()), name
    if zero:
        flat = np.asarray(jeng.master_flat)
        for m in range(MP):
            z = ck._load_obj(ck.zero_file(d, "global_step2", 0, m))
            n = len(z["master"])
            assert np.array_equal(flat[m][:n], np.asarray(z["master"])), m
            assert not flat[m][n:].any()
    else:
        master = joined(d, "global_step2", "master")
        for name, x in _np(jeng.master).items():
            assert np.array_equal(x, master[name].numpy()), name
    assert int(jeng.opt_state.step) == 2
