"""Lion, RMSprop, Adagrad and ``register_optimizer`` of the port against
the JAX package's.

* Trajectories: the same numpy params and a fresh gradient per step
  through ``deepspeed_tpu.ops.optim`` and ``deepspeed_tpu_torch.ops.optim``
  (plain tensor ops on every device: the JAX package has no kernel for
  these three), K = 4 steps, with and without weight decay, per-leaf
  hypers (the engine's param groups) and an fp16 ``combined_scale``.
  fp32, ``rtol=1e-5, atol=1e-7``: the same elementwise formulas,
  evaluated in another order by the two frameworks' compilers.
* ``from_config``: the JAX spellings and refusals.
* The optimizer state: ``m`` None for RMSprop and Adagrad, ``v`` None for
  Lion, in the state and in the checkpoint files, which cross between the
  packages both ways.
* A factory registered with ``register_optimizer`` is what
  ``initialize`` builds for its config name.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu.ops import optim as jopt
from deepspeed_tpu_torch import weights
from deepspeed_tpu_torch.models import GPT2
from deepspeed_tpu_torch.ops import optim as topt
from test_torch_zero import TINY, config, init_params, jax_engine, lm_data

RTOL, ATOL = 1e-5, 1e-7
K = 4
SHAPES = {"blocks.qkv_w": (3, 16, 16), "one": (1,), "odd": (1000,)}
OPTS = {"lion": ("Lion", dict(lr=3e-3, beta1=0.9, beta2=0.99)),
        "rmsprop": ("RMSprop", dict(lr=1e-3, alpha=0.9, eps=1e-6)),
        "adagrad": ("Adagrad", dict(lr=1e-2, eps=1e-8))}
VARIANTS = {"plain": {}, "decay": {"weight_decay": 0.01},
            "fp16-scale": {"combined_scale": 256.0},
            "groups": {"lr": {"blocks.qkv_w": 2e-3, "one": None,
                              "odd": 5e-4},
                       "weight_decay": {"blocks.qkv_w": 0.1, "one": 0.0,
                                        "odd": None}}}


def rand(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("name", list(OPTS))
def test_trajectory_matches_jax(name, variant):
    cls, fields = OPTS[name]
    jo = getattr(jopt, cls)(**fields)
    to = getattr(topt, cls)(**fields)
    hy = dict(VARIANTS[variant])
    scale = hy.pop("combined_scale", 1.0)
    params = {k: rand(s, i) for i, (k, s) in enumerate(SHAPES.items())}
    jp = {k: jnp.asarray(x) for k, x in params.items()}
    tp = {k: torch.tensor(x) for k, x in params.items()}
    jst, tst = jo.init(jp), to.init(tp)
    assert (jst.m is None) == (tst.m is None)
    assert (jst.v is None) == (tst.v is None)
    for step in range(K):
        grads = {k: rand(s, 100 + 10 * step + i) * scale
                 for i, (k, s) in enumerate(SHAPES.items())}
        jp, jst = jo.update(jp, {k: jnp.asarray(g) for k, g in grads.items()},
                            jst, combined_scale=scale, **hy)
        to.update(tp, {k: torch.tensor(g) for k, g in grads.items()}, tst,
                  combined_scale=scale, **hy)
        assert tst.step == int(jst.step) == step + 1
        for k in SHAPES:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       rtol=RTOL, atol=ATOL, err_msg=k)
            for key in ("m", "v"):
                if getattr(jst, key) is not None:
                    np.testing.assert_allclose(
                        getattr(tst, key)[k].numpy(),
                        np.asarray(getattr(jst, key)[k]), rtol=RTOL,
                        atol=ATOL, err_msg=f"{key} {k}")


@pytest.mark.parametrize("name,params", [
    ("Lion", {"lr": 3e-4, "betas": [0.9, 0.98], "eps": 1e-6,
              "weight_decay": 0.1}),
    ("RMSprop", {"lr": 1e-3, "alpha": 0.95, "eps": 1e-7,
                 "weight_decay": 0.01, "momentum": 0, "centered": False}),
    ("Adagrad", {"lr": 1e-2, "eps": 1e-9, "lr_decay": 0}),
    ("rmsprop", {}), ("ADAGRAD", {}), ("lion", {})])
def test_from_config_matches_jax(name, params):
    j, t = jopt.from_config(name, params), topt.from_config(name, params)
    assert t.name == j.name
    for f in dataclasses.fields(j):
        if hasattr(t, f.name) and f.name != "use_pallas":
            assert getattr(t, f.name) == getattr(j, f.name), f.name
    assert t.uses_betas == j.uses_betas


@pytest.mark.parametrize("name,params", [
    ("RMSprop", {"momentum": 0.9}), ("RMSprop", {"centered": True}),
    ("Adagrad", {"lr_decay": 0.1}), ("Nope", {})])
def test_from_config_refusals_match_jax(name, params):
    with pytest.raises(ValueError) as theirs:
        jopt.from_config(name, params)
    with pytest.raises(ValueError) as ours:
        topt.from_config(name, params)
    assert str(ours.value) == str(theirs.value)


def test_registered_factory_is_built_by_initialize():
    made = []

    def factory(**params):
        made.append(params)
        return topt.AdamW(lr=float(params["lr"]), weight_decay=0.5)

    topt.register_optimizer("MyAdamW", factory)
    try:
        cfg = config(1, 1, "fp32")
        cfg["optimizer"] = {"type": "myadamw", "params": {"lr": 2e-3}}
        engine = deepspeed_tpu_torch.initialize(
            config=cfg, model=GPT2.from_size("tiny", **TINY),
            model_parameters=init_params(), device="cpu")[0]
        assert made == [{"lr": 2e-3}]
        assert isinstance(engine.base_optimizer, topt.AdamW)
        assert engine.base_optimizer.weight_decay == 0.5
        assert isinstance(topt.from_config("MYADAMW", {"lr": 1}), topt.AdamW)
        # a built-in name is not shadowed by the registry
        topt.register_optimizer("adam", factory)
        assert type(topt.from_config("Adam", {"lr": 1})) is topt.Adam
    finally:
        topt._REGISTRY.pop("myadamw", None)
        topt._REGISTRY.pop("adam", None)


def _leaves(tree):
    return {k: np.asarray(v) for k, v in weights.flatten_tree(
        jax.tree_util.tree_map(np.asarray, tree)).items()}


@pytest.mark.parametrize("name", list(OPTS))
def test_checkpoints_cross_both_ways(name, tmp_path):
    """fp32, ZeRO off, one process: 2 steps, a save, the other package's
    load; the masters and the moment it has equal bitwise, the one it has
    not absent on both sides."""
    cls, fields = OPTS[name]
    cfg = config(1, 1, "fp32")
    cfg["optimizer"] = {"type": cls, "params": {"lr": fields["lr"]}}
    toks, labels = lm_data(2, 4)
    params = init_params()
    teng = deepspeed_tpu_torch.initialize(
        config=cfg, model=GPT2.from_size("tiny", **TINY),
        model_parameters=params, device="cpu")[0]
    jeng = jax_engine(cfg, 1, params, fp32_compute=False)
    for i in range(2):
        teng.train_batch((toks[i], labels[i]))
        jeng.train_batch((toks[i], labels[i]))
    teng.save_checkpoint(str(tmp_path / "port"), tag="p")
    jeng.save_checkpoint(str(tmp_path / "jax"), tag="j")

    jload = jax_engine(cfg, 1, init_params(3), fp32_compute=False)
    jload.load_checkpoint(str(tmp_path / "port"), tag="p")
    tload = deepspeed_tpu_torch.initialize(
        config=cfg, model=GPT2.from_size("tiny", **TINY), device="cpu")[0]
    tload.load_checkpoint(str(tmp_path / "jax"), tag="j")
    for src, dst_j in ((teng, jload),):
        assert int(dst_j.opt_state.step) == src.opt_state.step == 2
        for key in ("master", "m", "v"):
            live = (src.master if key == "master"
                    else getattr(src.opt_state, key))
            theirs = (dst_j.master if key == "master"
                      else getattr(dst_j.opt_state, key))
            assert (live is None) == (theirs is None), key
            if live is not None:
                got = _leaves(theirs)
                for k, t in live.items():
                    assert np.array_equal(got[k], t.numpy()), (key, k)
    assert tload.opt_state.step == int(jeng.opt_state.step) == 2
    for key in ("master", "m", "v"):
        live = (tload.master if key == "master"
                else getattr(tload.opt_state, key))
        theirs = (jeng.master if key == "master"
                  else getattr(jeng.opt_state, key))
        assert (live is None) == (theirs is None), key
        if live is not None:
            want = _leaves(theirs)
            for k, t in live.items():
                assert np.array_equal(t.numpy(), want[k]), (key, k)
