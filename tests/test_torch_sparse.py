"""The row-sparse gradient reduction of the port against the JAX package's.

* ``sparse_psum`` on gloo CPU ranks against the JAX ``sparse_psum`` under
  ``shard_map`` on the same per-rank gradients at dp 2 and 4: the gather
  branch, the static degrade to the dense sum (``world * max_rows >=
  rows``), the dense fallback (one rank touches more than ``max_rows``
  rows), and the knobs (``fp32_allreduce`` on a bf16 gradient, prescale
  with a predivide factor).  fp32 within ``rtol=1e-6, atol=1e-7`` (the
  scatter-add and the all-reduce add the same rank terms, maybe in
  another order); bf16 within one bf16 ulp (``rtol=8e-3``).
* An engine trajectory: the JAX tests' ``EmbeddingClassifier`` (a 512-row
  table, of which a step touches at most 64 rows) with ``sparse_gradients``
  and ``sparse_gradients_max_rows`` 32 at dp 2, Adam, fp32, 4 steps,
  against the JAX engine on the same weights and batches: losses within
  ``rtol=1e-6``, masters and moments within ``rtol=1e-5, atol=1e-7``;
  the same launch runs it dense, within ``atol=1e-7`` of the sparse run.
* The flag warns and stays dense under ZeRO, without the model's hook,
  and when the hook marks nothing; ``CSRTensor`` and ``csr_allreduce``
  equal the JAX ones.
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu import sparse as jsparse
from deepspeed_tpu.parallel.topology import make_mesh
from deepspeed_tpu_torch import sparse, weights
from deepspeed_tpu_torch.models import GPT2
from test_sparse_grads import EmbeddingClassifier, batch
from test_torch_zero import TINY
from torch_rank_worker import EmbeddingClassifier as TEmbeddingClassifier
from torch_ranks import run_ranks

ROWS, WIDTH = 512, 4
KNOBS = dict(fp32_allreduce=True, prescale_gradients=True,
             gradient_predivide_factor=2.0)
#: name: (max_rows, rows touched per rank, knobs, bf16)
CASES = {"gather": (8, 5, {}, False),
         "static-dense": (512, 5, {}, False),
         "fallback": (8, 20, {}, False),
         "knobs": (8, 5, KNOBS, False),
         "bf16-fp32-allreduce": (8, 5, {"fp32_allreduce": True}, True)}


def rank_grads(dp, touched, seed=3):
    rng = np.random.default_rng(seed)
    g = np.zeros((dp, ROWS, WIDTH), np.float32)
    for d in range(dp):
        rows = rng.choice(64, size=touched, replace=False)   # overlap
        g[d, rows] = rng.normal(size=(touched, WIDTH))
    return g


def jax_sparse_psum(g, dp, max_rows, knobs, bf16):
    mesh = make_mesh(devices=jax.devices()[:dp])

    def local(x):
        return jsparse.sparse_psum(x[0], "data", dp, max_rows=max_rows,
                                   **knobs)[None]

    fn = jax.jit(jax.shard_map(local, mesh=mesh, in_specs=P("data"),
                               out_specs=P("data"), check_vma=False))
    x = jnp.asarray(g, jnp.bfloat16 if bf16 else jnp.float32)
    return np.asarray(fn(x).astype(jnp.float32))


@pytest.mark.parametrize("dp", [2, 4])
def test_sparse_psum_matches_jax(dp, tmp_path):
    inputs, cases = {}, []
    for name, (max_rows, touched, knobs, bf16) in CASES.items():
        g = rank_grads(dp, touched)
        if bf16:
            g = np.asarray(jnp.asarray(g, jnp.bfloat16).astype(jnp.float32))
        inputs[name] = g
        cases.append({"name": name, "input": name, "max_rows": max_rows,
                      "kw": knobs, "bf16": bf16})
    outs = run_ranks(tmp_path, dp, {"scenario": "sparse", "cases": cases},
                     inputs)
    for name, (max_rows, touched, knobs, bf16) in CASES.items():
        want = jax_sparse_psum(inputs[name], dp, max_rows, knobs, bf16)
        tol = dict(rtol=8e-3, atol=1e-3) if bf16 else dict(rtol=1e-6,
                                                           atol=1e-7)
        for r, o in enumerate(outs):
            np.testing.assert_allclose(o[name], want[r], **tol,
                                       err_msg=f"{name} rank {r}")
        # and both are the dense average
        np.testing.assert_allclose(outs[0][name],
                                   inputs[name].sum(0) / dp, **tol)


def test_engine_trajectory_matches_jax(tmp_path):
    dp, steps = 2, 4
    model = EmbeddingClassifier()
    params = jax.tree_util.tree_map(
        np.asarray, model.init_params(jax.random.PRNGKey(0)))
    toks = np.stack([batch(bs=8, seed=i)[0] for i in range(steps)])
    labels = np.stack([batch(bs=8, seed=i)[1] for i in range(steps)])
    cfg = {"train_batch_size": 8, "steps_per_print": 10 ** 6,
           "optimizer": {"type": "Adam", "params": {"lr": 1e-2}},
           "sparse_gradients": True, "sparse_gradients_max_rows": 32}
    jeng = deepspeed_tpu.initialize(
        config=cfg, model=model, model_parameters=params,
        mesh=make_mesh(devices=jax.devices()[:dp]))[0]
    assert jeng._sparse_flags is not None
    jl = [float(jeng.train_batch((toks[i], labels[i])))
          for i in range(steps)]
    dense = dict(cfg, sparse_gradients=False)
    inputs = {f"w/{k}": v for k, v in weights.flatten_tree(params).items()}
    inputs.update(tokens=toks, labels=labels)
    outs = run_ranks(tmp_path, dp, {"scenario": "train", "runs": [
        {"config": c, "steps": steps, "model": "embedding"}
        for c in (cfg, dense)]}, inputs)
    np.testing.assert_allclose(np.mean([o["0/losses"] for o in outs], 0),
                               jl, rtol=1e-6)
    st = jeng.opt_state
    for key, tree in (("master", jeng.master), ("m", st.m), ("v", st.v)):
        want = weights.flatten_tree(jax.tree_util.tree_map(np.asarray, tree))
        for o in outs:
            for name, x in want.items():
                np.testing.assert_allclose(o[f"0/{key}/{name}"], x,
                                           rtol=1e-5, atol=1e-7,
                                           err_msg=f"{key} {name}")
                np.testing.assert_allclose(o[f"1/{key}/{name}"],
                                           o[f"0/{key}/{name}"], rtol=0,
                                           atol=1e-7)


def _engine(cfg, model):
    return deepspeed_tpu_torch.initialize(config=cfg, model=model,
                                          device="cpu")[0]


def test_flag_warns_where_it_cannot_apply(caplog):
    cfg = {"train_batch_size": 8, "sparse_gradients": True,
           "optimizer": {"type": "Adam", "params": {"lr": 1e-2}}}
    with caplog.at_level(logging.WARNING):
        engine = _engine(dict(cfg, zero_optimization={"stage": 1},
                              bf16={"enabled": True}),
                         TEmbeddingClassifier())
    assert engine._sparse_flags is None
    assert any("sparse_gradients is ignored under ZeRO" in r.getMessage()
               for r in caplog.records)
    caplog.clear()
    with caplog.at_level(logging.WARNING):
        engine = _engine(cfg, GPT2.from_size("tiny", **TINY))
    assert engine._sparse_flags is None
    assert any("sparse_grad_specs" in r.getMessage()
               for r in caplog.records)

    class Unmarked(TEmbeddingClassifier):
        def sparse_grad_specs(self, params=None):
            return {"emb": False, "w": False}

    caplog.clear()
    with caplog.at_level(logging.WARNING):
        engine = _engine(cfg, Unmarked())
    assert engine._sparse_flags is None
    assert any("marked no leaves" in r.getMessage() for r in caplog.records)
    assert _engine(cfg, TEmbeddingClassifier())._sparse_flags == {
        "emb": True}


def test_csr_tensor_matches_jax():
    g = rank_grads(3, 6)
    tj = [jsparse.CSRTensor(jnp.asarray(x)) for x in g]
    tt = [sparse.CSRTensor(torch.tensor(x)) for x in g]
    for a, b in zip(tj, tt):
        assert np.array_equal(np.asarray(a.indices), b.indices.numpy())
        assert np.array_equal(np.asarray(a.values), b.values.numpy())
        assert a.sparse_size() == b.sparse_size()
        assert np.array_equal(np.asarray(a.to_dense()), b.to_dense().numpy())
    np.testing.assert_allclose(sparse.csr_allreduce(tt).numpy(),
                               np.asarray(jsparse.csr_allreduce(tj)),
                               rtol=1e-6, atol=1e-7)
    acc = sparse.CSRTensor(torch.tensor(g[0]))
    acc.add(sparse.CSRTensor(torch.tensor(g[1])))
    np.testing.assert_allclose(acc.to_dense().numpy(), g[0] + g[1],
                               rtol=1e-6)
    assert sparse.CSRTensor.type() == "deepspeed_tpu_torch.sparse.CSRTensor"
