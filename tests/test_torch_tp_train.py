"""Tensor-parallel training of the port against the JAX engine at mp 2.

The port trains on two gloo CPU ranks, one model group
(``tests/torch_rank_worker.py``); the JAX engine on its virtual CPU mesh
(``make_mesh(model_parallel_size=2, devices=jax.devices()[:2])``).  Both
start from the same numpy weights (the global tree: the port's engine cuts
each rank's slices) and take the same batches, 3 steps, gas 2, fp32:

* tiny GPT-2 with Adam and gradient clipping at 0.5 (the global grad norm
  is 1.6-1.8 at these steps, so the clip engages, and a norm counted on
  one shard only, or twice, moves the moments);
* tiny BERT with NSP, LAMB and the same clipping (grad norm 2.7-2.8;
  LAMB's trust ratio per local shard on both sides).

Losses agree within ``rtol=1e-5``; the masters and moments, every rank's
local slices joined by ``weights.combine_local_trees``, within ``rtol=1e-5,
atol=1e-6``, and the replicated leaves are bitwise equal across the ranks.
The JAX engine psums the replicated leaves' gradients and divides every
leaf by mp; the port's autograd gives the true gradient directly, so the
moments (which carry the gradients' scale, where Adam's update hides it)
hold the two rules equal.  GPT-2 at mp 2 also matches the port at mp 1
(one process, same tolerances); BERT does not have to, since LAMB's trust
ratio is per shard.  Then fp16: an inf in model rank 1's slice of a
column-parallel gradient skips the step on both ranks, with the same loss
scale (the JAX ``test_tp_overflow_in_one_shard_skips_all_shards``).
"""

import jax
import numpy as np
import pytest

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models import BertForPreTraining as JBert
from deepspeed_tpu.models import GPT2 as JGPT2
from deepspeed_tpu.parallel.topology import make_mesh
from deepspeed_tpu_torch import weights
from deepspeed_tpu_torch.models import GPT2, BertForPreTraining
from torch_rank_worker import TINY, TINY_BERT
from torch_ranks import run_ranks

MP, MICRO, GAS, STEPS, NPRED = 2, 2, 2, 3, 4
VOCAB, SEQ = TINY["vocab_size"], TINY["max_seq_len"]
RTOL, ATOL = 1e-5, 1e-6
CLIP = 0.5
BERT_KEYS = ["ids", "mask", "tt", "pos", "mlm_ids", "mlm_w", "nsp"]


def config(opt, prec="fp32", **extra):
    params = {"lr": 1e-3, "eps": 1e-6}
    if opt == "Lamb":
        params.update(weight_decay=0.01, max_coeff=0.5, min_coeff=0.08,
                      use_pallas=False)
    cfg = {"train_batch_size": MICRO * GAS,
           "gradient_accumulation_steps": GAS,
           "steps_per_print": 10 ** 9, "gradient_clipping": CLIP,
           "optimizer": {"type": opt, "params": params}}
    if prec == "fp16":
        cfg["fp16"] = {"enabled": True, "initial_scale_power": 8}
    cfg.update(extra)
    return cfg


def gpt2_params():
    jm = JGPT2.from_size("tiny", **TINY)
    return jax.tree_util.tree_map(np.asarray,
                                  jm.init_params(jax.random.PRNGKey(7)))


def bert_params():
    jm = JBert.from_size("tiny", use_nsp=True, **TINY_BERT)
    params = jax.tree_util.tree_map(np.asarray,
                                    jm.init_params(jax.random.PRNGKey(5)))
    # nsp_w starts at zero; give it values so its grads are non-trivial
    params["nsp_w"] = np.random.default_rng(9).normal(
        size=params["nsp_w"].shape).astype(np.float32) * 0.02
    return params


def gpt2_data(seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, VOCAB, (STEPS, MICRO * GAS, SEQ)).astype(np.int32)
    labels = np.roll(toks, -1, axis=2)
    labels[..., -1] = -1
    return {"tokens": toks, "labels": labels}


def bert_data(seed=1):
    rng = np.random.default_rng(seed)
    rows = MICRO * GAS
    ids = rng.integers(0, VOCAB, (STEPS, rows, SEQ)).astype(np.int32)
    mask = np.ones_like(ids)
    mask[:, 0, SEQ - 5:] = 0
    pos = np.stack([np.stack([rng.choice(SEQ - 5, NPRED, replace=False)
                              for _ in range(rows)]) for _ in range(STEPS)])
    return {"ids": ids, "mask": mask, "tt": np.zeros_like(ids),
            "pos": pos.astype(np.int32),
            "mlm_ids": np.take_along_axis(ids, pos, axis=2),
            "mlm_w": np.ones((STEPS, rows, NPRED), np.float32),
            "nsp": rng.integers(0, 2, (STEPS, rows)).astype(np.int32)}


def jax_run(model, cfg, params, data, keys):
    engine, _, _, _ = deepspeed_tpu.initialize(
        config=cfg, model=model, model_parameters=params,
        mesh=make_mesh(model_parallel_size=MP, devices=jax.devices()[:MP]))
    losses = [float(engine.train_batch(tuple(data[k][i] for k in keys)))
              for i in range(STEPS)]
    state = {key: weights.flatten_tree(jax.tree_util.tree_map(
        np.asarray, tree)) for key, tree in (
        ("master", engine.master), ("m", engine.opt_state.m),
        ("v", engine.opt_state.v))}
    return losses, state


def port_state(outs, specs):
    """Each of master, m, v as ONE global flat tree: the ranks' local
    slices joined; replicated leaves must be bitwise equal across ranks."""
    dims = weights.flatten_tree(specs)
    state = {}
    for key in ("master", "m", "v"):
        local = [{k.split("/", 1)[1]: v for k, v in o.items()
                  if k.startswith(key + "/")} for o in outs]
        for name, d in dims.items():
            if d is None:
                for tree in local[1:]:
                    assert np.array_equal(tree[name], local[0][name]), (
                        key, name)
        state[key] = weights.flatten_tree(
            weights.combine_local_trees(local, dims))
    return state


def assert_state_close(got, want, what):
    for key in ("master", "m", "v"):
        assert got[key].keys() == want[key].keys()
        for name, w in want[key].items():
            np.testing.assert_allclose(got[key][name], w, rtol=RTOL,
                                       atol=ATOL,
                                       err_msg=f"{what} {key} {name}")


def _run(outs, i):
    return [{k.split("/", 1)[1]: v for k, v in o.items()
             if k.startswith(f"{i}/")} for o in outs]


@pytest.fixture(scope="module")
def port_mp2(tmp_path_factory):
    """One launch of two ranks: GPT-2 (mp from the config), BERT (mp from a
    MeshConfig), and the fp16 overflow run."""
    inputs = {f"g/{k}": v for k, v in
              weights.flatten_tree(gpt2_params()).items()}
    inputs.update({f"b/{k}": v for k, v in
                   weights.flatten_tree(bert_params()).items()})
    inputs.update(gpt2_data())
    inputs.update(bert_data())
    runs = [
        {"config": config("Adam"), "weights": "g", "mp": MP,
         "steps": STEPS},
        {"config": config("Lamb"), "weights": "b", "mp": MP, "mesh": True,
         "model": "bert", "batch_keys": BERT_KEYS, "steps": STEPS},
        {"config": config("Adam", "fp16"), "weights": "g", "mp": MP,
         "steps": 1, "split": True,
         "inject_inf": {"rank": 1, "step": 0, "leaf": "blocks.qkv_w"}},
    ]
    outs = run_ranks(tmp_path_factory.mktemp("tp_train"), MP,
                     {"scenario": "train", "runs": runs}, inputs)
    return [_run(outs, i) for i in range(len(runs))]


def test_gpt2_adam_clip_matches_jax_and_mp1(port_mp2):
    outs = port_mp2[0]
    params, data = gpt2_params(), gpt2_data()
    jl, jstate = jax_run(JGPT2.from_size("tiny", **TINY), config("Adam"),
                         params, data, ["tokens", "labels"])
    specs = GPT2.from_size("tiny", **TINY).partition_specs()
    assert np.array_equal(outs[0]["losses"], outs[1]["losses"])
    np.testing.assert_allclose(outs[0]["losses"], jl, rtol=RTOL)
    got = port_state(outs, specs)
    assert_state_close(got, jstate, "port mp 2 vs JAX mp 2")

    # the port at mp 1, one process: the same trajectory
    engine = deepspeed_tpu_torch.initialize(
        config=config("Adam"), model=GPT2.from_size("tiny", **TINY),
        model_parameters=params, device="cpu")[0]
    losses = [float(engine.train_batch((data["tokens"][i],
                                        data["labels"][i])))
              for i in range(STEPS)]
    np.testing.assert_allclose(outs[0]["losses"], losses, rtol=RTOL)
    mp1 = {key: {k: t.numpy() for k, t in tree.items()} for key, tree in (
        ("master", engine.master), ("m", engine.opt_state.m),
        ("v", engine.opt_state.v))}
    assert_state_close(got, mp1, "port mp 2 vs port mp 1")


def test_bert_lamb_nsp_clip_matches_jax(port_mp2):
    outs = port_mp2[1]
    jm = JBert.from_size("tiny", use_nsp=True, **TINY_BERT)
    jl, jstate = jax_run(jm, config("Lamb"), bert_params(), bert_data(),
                         BERT_KEYS)
    assert np.array_equal(outs[0]["losses"], outs[1]["losses"])
    np.testing.assert_allclose(outs[0]["losses"], jl, rtol=RTOL)
    specs = BertForPreTraining.from_size("tiny", use_nsp=True,
                                         **TINY_BERT).partition_specs()
    assert_state_close(port_state(outs, specs), jstate,
                       "port mp 2 vs JAX mp 2 (BERT, LAMB)")


def test_fp16_overflow_in_one_shard_skips_every_rank(port_mp2):
    """Rank 1's slice of ``qkv_w``'s gradient holds an inf, rank 0's is
    finite: both skip, keep their masters and moments, and halve the
    scale (the INLINE loss-scale FSM without ZeRO)."""
    outs = port_mp2[2]
    specs = GPT2.from_size("tiny", **TINY).partition_specs()
    for r, o in enumerate(outs):
        assert int(o["skipped"]) == 1 and int(o["global_steps"]) == 1
        assert float(o["cur_scale"]) == 2.0 ** 8 / 2
        local = weights.flatten_tree(weights.shard_tree(gpt2_params(), specs,
                                                        MP, r))
        for name, x in local.items():
            assert np.array_equal(o[f"master/{name}"], x), name
            assert not o[f"m/{name}"].any()
    assert np.array_equal(outs[0]["losses"], outs[1]["losses"])


def test_model_parallel_refusals():
    """mp > 1 (and pp > 1, and sp > 1) needs that many processes in a
    started group."""
    with pytest.raises(ValueError, match="needs 2 processes"):
        deepspeed_tpu_torch.initialize(
            config=config("Adam"), model=GPT2.from_size("tiny", **TINY),
            device="cpu",
            mesh=deepspeed_tpu_torch.MeshConfig(model_parallel_size=2))
    for key, error, match in (
            ("pipeline_parallel_size", ValueError, "needs 2 processes"),
            ("context_parallel_size", ValueError, "needs 2 processes")):
        with pytest.raises(error, match=match):
            deepspeed_tpu_torch.initialize(
                config=config("Adam", **{key: 2}),
                model=GPT2.from_size("tiny", **TINY), device="cpu")
    # ZeRO-3 is ported (tests/test_torch_zero3.py): at one process it
    # partitions nothing and trains replicated
    engine = deepspeed_tpu_torch.initialize(
        config=config("Adam", zero_optimization={"stage": 3},
                      bf16={"enabled": True}),
        model=GPT2.from_size("tiny", **TINY), device="cpu")[0]
    assert engine.zero3 and not any(
        d >= 0 for d in engine._zero3_dims.values())
