"""ZeRO-1/2 x tensor parallelism, mp 4, and the data rank of each model
rank, on four gloo CPU ranks against the JAX engine.

One launch of four ranks (``tests/torch_rank_worker.py``) runs, each on a
fresh engine:

* dp 2 x mp 2 (rank = dp_rank * 2 + mp_rank) with ZeRO stage 1 and stage
  1 with ``parameter_parallel_size`` 1 in bf16, and stage 2 with
  overlap_comm buckets in fp16: each model rank partitions its LOCAL flat
  layout (the JAX ``make_local_flat_meta``) over its data group.  With the
  fp32-computing GPT-2 of ``tests/test_torch_zero.py``, gradient clipping
  at 0.5 and its ``LOW_PRECISION`` tolerances, the ranks' partitions,
  joined and combined over the model ranks, hold against the JAX engine's
  ZeRO-1 at dp 2 and mp 1, leaf by leaf.  Not against the JAX engine at
  mp 2: it leaves its own mp 1 trajectory (after 3 steps 303 master
  elements beyond ``LOW_PRECISION`` in bf16, 4 in fp16, all in or after
  the replicated leaves), since it rounds each model rank's partial
  gradient of a replicated leaf to the compute dtype before its psum
  (``_psum_model_replicated``), where the port sums the fp32 partials
  inside autograd and rounds once;
* the data loader at dp 2 x mp 2: both model ranks of a data rank collate
  that data rank's rows (the JAX mesh's batch spec, where the data axis
  alone shards the batch);
* mp 4 (dp 1): tiny GPT-2 (Adam) and tiny BERT (LAMB, NSP), fp32, against
  the JAX engine at mp 4 (``tests/test_torch_tp_train.py``'s tolerances).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
from deepspeed_tpu import zero as jzero
from deepspeed_tpu.models import BertForPreTraining as JBert
from deepspeed_tpu.models import GPT2 as JGPT2
from deepspeed_tpu.parallel.topology import make_mesh
from deepspeed_tpu_torch import data as data_mod
from deepspeed_tpu_torch import weights, zero
from deepspeed_tpu_torch.models import GPT2, BertForPreTraining
from test_torch_tp_train import (BERT_KEYS, STEPS, TINY, TINY_BERT,
                                 assert_state_close, bert_data, bert_params,
                                 port_state)
from test_torch_tp_train import config as tp_config
from test_torch_zero import (LOW_PRECISION, Fp32JGPT2, config, init_params,
                             jax_flat_state, lm_data, rank_inputs)
from torch_ranks import run_ranks

DP, MP, GAS = 2, 2, 2
#: name: (precision, zero_optimization section)
ZERO_RUNS = {"stage1": ("bf16", {"stage": 1, "overlap_comm": False}),
             "stage1_pps1": ("bf16", {"stage": 1,
                                      "parameter_parallel_size": 1}),
             "stage2_overlap": ("fp16", {"stage": 2, "overlap_comm": True,
                                         "comm_bucket_mb": 0.004})}


def zero_config(prec, zero_cfg):
    return config(DP, GAS, prec, zero_cfg, gradient_clipping=0.5)


def _run(outs, i):
    return [{k.split("/", 1)[1]: v for k, v in o.items()
             if k.startswith(f"{i}/")} for o in outs]


@pytest.fixture(scope="module")
def port_runs(tmp_path_factory):
    toks, labels = lm_data(STEPS, DP * GAS * 4)
    inputs = rank_inputs(init_params(), toks, labels)
    inputs.update({f"b/{k}": v for k, v in
                   weights.flatten_tree(bert_params()).items()})
    inputs.update(bert_data())
    runs = [{"config": zero_config(*z), "mp": MP, "steps": STEPS,
             "fp32_compute": True} for z in ZERO_RUNS.values()]
    runs.append({"config": config(DP, GAS, "bf16"), "mp": MP, "steps": 0,
                 "loader": True})
    runs.append({"config": tp_config("Adam"), "mp": 4, "steps": STEPS})
    runs.append({"config": tp_config("Lamb"), "mp": 4, "mesh": True,
                 "steps": STEPS, "weights": "b", "model": "bert",
                 "batch_keys": BERT_KEYS})
    outs = run_ranks(tmp_path_factory.mktemp("tp_zero"), 4,
                     {"scenario": "train", "runs": runs}, inputs)
    return {"inputs": inputs, "runs": [_run(outs, i)
                                       for i in range(len(runs))]}


@pytest.fixture(scope="module")
def jax_zero():
    """{precision: (losses, {key: global flat tree})} of the JAX engine's
    ZeRO-1 at dp 2, mp 1."""
    toks, labels = lm_data(STEPS, DP * GAS * 4)
    out = {}
    for prec in ("bf16", "fp16"):
        engine, _, _, _ = deepspeed_tpu.initialize(
            config=zero_config(prec, {"stage": 1}),
            model=Fp32JGPT2.from_size("tiny", **TINY),
            model_parameters=init_params(),
            mesh=make_mesh(devices=jax.devices()[:DP]))
        losses = [float(engine.train_batch((toks[i], labels[i])))
                  for i in range(STEPS)]
        state = {key: weights.flatten_tree(jax.tree_util.tree_map(
            np.asarray, jzero.unflatten_tree(jnp.asarray(flat),
                                             engine.flat_meta)))
            for key, flat in zip(("master", "m", "v"),
                                 jax_flat_state(engine))}
        out[prec] = (losses, state)
    return out


def _local_meta():
    model = GPT2.from_size("tiny", **TINY)
    specs = model.partition_specs()
    local = weights.shard_tree(dict(model.named_parameters()), specs, MP, 0)
    return zero.make_flat_meta(weights.flatten_tree(local), DP), specs


def test_local_layout_is_the_jax_zero_x_mp_layout():
    meta, _ = _local_meta()
    jm = JGPT2.from_size("tiny", **TINY)
    jmeta = jzero.make_local_flat_meta(init_params(), jm.partition_specs(),
                                       {"model": MP}, DP)
    assert (meta.total, meta.padded, meta.partition, meta.shapes) == (
        jmeta.total, jmeta.padded, jmeta.partition, jmeta.shapes)


@pytest.mark.parametrize("run", list(ZERO_RUNS))
def test_zero_x_mp_matches_jax(run, port_runs, jax_zero):
    outs = port_runs["runs"][list(ZERO_RUNS).index(run)]
    prec = ZERO_RUNS[run][0]
    jl, want = jax_zero[prec]
    meta, specs = _local_meta()
    # each data rank's loss is the same on both of its model ranks; the
    # JAX loss is the data-axis mean
    for d in range(DP):
        assert np.array_equal(outs[d * MP]["losses"],
                              outs[d * MP + 1]["losses"])
    np.testing.assert_allclose(np.mean([o["losses"] for o in outs], axis=0),
                               jl, rtol=LOW_PRECISION["master"][0])
    for o in outs:
        assert int(o["step"]) == STEPS and int(o["skipped"]) == 0
        assert int(o["padded"]) == meta.padded
        # the partition group: the data group, or each rank alone at pps 1
        assert int(o["partition"]) == meta.padded // (
            1 if run == "stage1_pps1" else DP)
    for key in ("master", "m", "v"):
        local = []
        for m in range(MP):
            parts = [outs[d * MP + m][key] for d in range(DP)]
            flat = parts[0] if parts[0].size == meta.padded else \
                np.concatenate(parts)
            assert not flat[meta.total:].any()
            local.append(weights.unflatten_tree(
                {k: v.numpy() for k, v in zero.unflatten_tree(
                    torch.from_numpy(flat), meta).items()}))
        got = weights.flatten_tree(weights.combine_local_trees(local, specs))
        rtol, atol = LOW_PRECISION[key]
        for name, w in want[key].items():
            np.testing.assert_allclose(got[name], w, rtol=rtol, atol=atol,
                                       err_msg=f"{run} {key} {name}")


def test_model_ranks_of_a_data_rank_read_the_same_rows(port_runs):
    """The loader's rows per (dp_rank, mp_rank) at dp 2 x mp 2: the rows of
    data rank ``rank // mp``, as a dp 2 loader of the same data gives
    them."""
    outs = port_runs["runs"][len(ZERO_RUNS)]
    inp = port_runs["inputs"]
    rows = list(zip(inp["tokens"][0], inp["labels"][0]))
    for r, o in enumerate(outs):
        d = r // MP
        want = next(iter(data_mod.DeepSpeedDataLoader(
            rows, batch_size=4 * DP, seed=0, dp_rank=d, dp_size=DP)))
        for i, w in enumerate(want):
            assert np.array_equal(o[f"loader/{i}"], np.asarray(w)), (r, i)
    assert not np.array_equal(outs[0]["loader/0"], outs[2]["loader/0"])


@pytest.mark.parametrize("model", ["gpt2", "bert"])
def test_mp4_matches_jax(model, port_runs):
    i = len(ZERO_RUNS) + (1 if model == "gpt2" else 2)
    outs = port_runs["runs"][i]
    if model == "gpt2":
        jm, tm = (JGPT2.from_size("tiny", **TINY),
                  GPT2.from_size("tiny", **TINY))
        cfg, params = tp_config("Adam"), init_params()
        inp = port_runs["inputs"]
        batches = [(inp["tokens"][s][:4], inp["labels"][s][:4])
                   for s in range(STEPS)]
    else:
        jm = JBert.from_size("tiny", use_nsp=True, **TINY_BERT)
        tm = BertForPreTraining.from_size("tiny", use_nsp=True, **TINY_BERT)
        cfg, params, data = tp_config("Lamb"), bert_params(), bert_data()
        batches = [tuple(data[k][s] for k in BERT_KEYS)
                   for s in range(STEPS)]
    engine, _, _, _ = deepspeed_tpu.initialize(
        config=cfg, model=jm, model_parameters=params,
        mesh=make_mesh(model_parallel_size=4, devices=jax.devices()[:4]))
    jl = [float(engine.train_batch(b)) for b in batches]
    want = {key: weights.flatten_tree(jax.tree_util.tree_map(
        np.asarray, tree)) for key, tree in (
        ("master", engine.master), ("m", engine.opt_state.m),
        ("v", engine.opt_state.v))}
    for o in outs[1:]:
        assert np.array_equal(o["losses"], outs[0]["losses"])
    np.testing.assert_allclose(outs[0]["losses"], jl, rtol=1e-5)
    assert_state_close(port_state(outs, tm.partition_specs()), want,
                       f"{model} port mp 4 vs JAX mp 4")
