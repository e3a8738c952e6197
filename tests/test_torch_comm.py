"""The port's collectives (``parallel/comm.py``) against the JAX package's.

Each function runs on gloo CPU ranks (one process per rank,
``tests/torch_rank_worker.py``) at dp 2 and 4, and its JAX counterpart
inside ``jax.shard_map`` over a virtual CPU mesh of the same size, on the
same per-rank inputs; every rank's output must agree within ``rtol=1e-6``
(``atol=1e-7`` for sums that cancel to near zero).  The knobs go through
every combination of ``fp32_allreduce``, ``prescale_gradients`` and
``gradient_predivide_factor`` for the all-reduce, the reduce-scatter and
the bucketed reduce-scatter; with ``fp32_allreduce`` the inputs are bf16,
so the upcast and the cast back are exercised.  At dp 4 the
``parameter_parallel_size`` 2 sub-groups run too (scatter within, sum
across or deferred to ``finish_subgroup_reduce``, gather within).  The
pure helpers (``bucket_bounds``, ``subgroup_index_groups``) run in
process.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from deepspeed_tpu.parallel import comm as jcomm
from deepspeed_tpu.parallel.topology import make_mesh
from deepspeed_tpu_torch.parallel import comm
from torch_ranks import run_ranks

N = 1536            # elements per rank; n / 3 and 2n / 3 are the two leaves
PART = 384          # elements per rank of the gathers
BUCKET = 256
KNOBS = [dict(fp32_allreduce=f, prescale_gradients=p,
              gradient_predivide_factor=d)
         for f, p, d in itertools.product((False, True), (False, True),
                                          (1.0, 2.0))]


def _knob_name(kw):
    return "fp32{}-pre{}-div{}".format(int(kw["fp32_allreduce"]),
                                      int(kw["prescale_gradients"]),
                                      kw["gradient_predivide_factor"])


def cases(dp):
    out = []
    for kw in KNOBS:
        dtype = "bf16" if kw["fp32_allreduce"] else "fp32"
        k = _knob_name(kw)
        out += [
            dict(name=f"allreduce-{k}", fn="allreduce_grads", input="x",
                 dtype=dtype, kw=kw),
            dict(name=f"allreduce-bucketed-{k}", fn="allreduce_grads",
                 input="x", dtype=dtype, kw=dict(kw, bucket_elems=BUCKET)),
            dict(name=f"scatter-{k}", fn="reduce_scatter_grads", input="x",
                 dtype=dtype, kw=kw),
            dict(name=f"scatter-bucketed-{k}",
                 fn="reduce_scatter_grads_bucketed", input="x",
                 dtype=dtype, kw=kw, bucket=BUCKET),
        ]
    out += [
        dict(name="gather-bucket", fn="allgather_partition_bucket",
             input="part"),
        dict(name="gather-params", fn="allgather_params", input="part"),
        dict(name="overflow-one-rank", fn="overflow_any", input="flag_one"),
        dict(name="overflow-none", fn="overflow_any", input="flag_none"),
    ]
    if dp == 4:
        post = KNOBS[0]
        pre = dict(KNOBS[3], fp32_allreduce=False)
        for across in (True, False):
            for kw in (post, pre):
                k = f"pps2-across{int(across)}-{_knob_name(kw)}"
                kw = dict(kw, across_subgroups=across)
                out += [
                    dict(name=f"scatter-{k}", fn="reduce_scatter_grads",
                         input="x", pps=2, kw=kw),
                    dict(name=f"scatter-bucketed-{k}",
                         fn="reduce_scatter_grads_bucketed", input="x",
                         pps=2, kw=kw, bucket=BUCKET),
                ]
        out += [
            dict(name="finish-pps2", fn="finish_subgroup_reduce",
                 input="part", pps=2),
            dict(name="gather-bucket-pps2", fn="allgather_partition_bucket",
                 input="part", pps=2),
            dict(name="gather-params-pps2", fn="allgather_params",
                 input="part", pps=2),
        ]
    return out


def inputs(dp):
    rng = np.random.default_rng(dp)
    flag_one = np.zeros((dp, 1), np.float32)
    flag_one[dp - 1] = 1.0
    return {"x": rng.standard_normal((dp, N)).astype(np.float32),
            "part": rng.standard_normal((dp, PART)).astype(np.float32),
            "flag_one": flag_one,
            "flag_none": np.zeros((dp, 1), np.float32)}


def jax_outputs(dp, case, data):
    """Every rank's output of the JAX function, [dp, ...]."""
    mesh = make_mesh(devices=jax.devices()[:dp])
    x = jnp.asarray(data[case["input"]].reshape(-1))
    if case.get("dtype") == "bf16":
        x = x.astype(jnp.bfloat16)
    kw = dict(case.get("kw", {}))
    pps = case.get("pps")
    fn_name = case["fn"]

    def local(v):
        if fn_name == "allreduce_grads":
            n = v.shape[0] // 3
            res = jcomm.allreduce_grads({"a": v[:n], "b": v[n:]}, "data", dp,
                                        **kw)
            return jnp.concatenate([res["a"], res["b"]])
        if fn_name == "reduce_scatter_grads":
            return jcomm.reduce_scatter_grads(
                v, "data", dp, partition_group_size=pps, **kw)
        if fn_name == "reduce_scatter_grads_bucketed":
            bounds = jcomm.bucket_bounds(v.shape[0] // (pps or dp),
                                         case["bucket"])
            return jcomm.reduce_scatter_grads_bucketed(
                v, "data", dp, bounds, partition_group_size=pps, **kw)
        if fn_name == "allgather_partition_bucket":
            return jcomm.allgather_partition_bucket(
                v, "data", world_size=dp,
                partition_group_size=pps).reshape(-1)
        if fn_name == "allgather_params":
            return jcomm.allgather_params(v, "data", world_size=dp,
                                          partition_group_size=pps)
        if fn_name == "finish_subgroup_reduce":
            return jcomm.finish_subgroup_reduce(v, "data", dp, pps)
        if fn_name == "overflow_any":
            return jcomm.overflow_any(v[0] > 0, "data").astype(
                jnp.float32).reshape(1)
        raise ValueError(fn_name)

    out = jax.jit(jax.shard_map(local, mesh=mesh, in_specs=P("data"),
                                out_specs=P("data"), check_vma=False))(x)
    return np.asarray(out.astype(jnp.float32)).reshape(dp, -1)


@pytest.fixture(scope="module")
def port_outputs(tmp_path_factory):
    """One launch of dp ranks per dp, running every case."""
    cache = {}

    def get(dp):
        if dp not in cache:
            outs = run_ranks(tmp_path_factory.mktemp(f"comm{dp}"), dp,
                             {"scenario": "comm", "cases": cases(dp)},
                             inputs(dp))
            cache[dp] = outs
        return cache[dp]
    return get


@pytest.mark.parametrize("dp,name", [(dp, c["name"]) for dp in (2, 4)
                                     for c in cases(dp)])
def test_collective_matches_jax(port_outputs, dp, name):
    case = next(c for c in cases(dp) if c["name"] == name)
    want = jax_outputs(dp, case, inputs(dp))
    outs = port_outputs(dp)
    got = np.stack([o[name].reshape(-1) for o in outs])
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("total,bucket", [(0, 128), (100, 128), (128, 128),
                                          (1000, 256), (1024, 300),
                                          (5000, 1 << 20), (384, 1)])
def test_bucket_bounds_match_jax(total, bucket):
    assert comm.bucket_bounds(total, bucket) == jcomm.bucket_bounds(total,
                                                                    bucket)
    if total:
        bounds = comm.bucket_bounds(total, bucket)
        assert bounds[0][0] == 0 and bounds[-1][1] == total
        assert all(s % 128 == 0 for s, _ in bounds)


@pytest.mark.parametrize("world,group", [(1, 1), (2, 1), (2, 2), (4, 2),
                                         (8, 4), (8, 2)])
def test_subgroup_index_groups_match_jax(world, group):
    assert comm.subgroup_index_groups(world, group) == \
        jcomm.subgroup_index_groups(world, group)
