"""Tensor parallelism of the port: the Megatron layers, the partition specs,
the sharding of trees and the model axis of the topology.

The layers run on gloo CPU ranks (``tests/torch_rank_worker.py``,
scenario ``tp_layers``: the world is one model group of mp ranks, each
holding its slices); the JAX layers under ``shard_map`` on the virtual
CPU mesh of the same mp (``make_mesh(model_parallel_size=mp)``), their
gradients taken through the ``shard_map`` from outside.  Both take the
same numpy inputs and the same upstream gradient ``dy``; the port's
backward of ``sum(y * dy)`` on every rank gives every input its true
gradient.  fp32, ``rtol=1e-5, atol=1e-6``, with ``dy`` scaled (``DY``) so
that the gradients are O(1), as the outputs are.  The JAX attention runs its
einsum path (``DSTPU_FUSED_ATTN=0``) while the port's takes its plan at the
local head count: the einsum path at seq 16, the whole-tile kernels' plain
versions at seq 64 (causal) and the streaming kernels' at seq 256.
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from deepspeed_tpu import zero as jzero
from deepspeed_tpu.models import BertForPreTraining as JBert
from deepspeed_tpu.models import GPT2 as JGPT2
from deepspeed_tpu.models import layers as JL
from deepspeed_tpu.parallel.topology import make_mesh
from deepspeed_tpu_torch import weights, zero
from deepspeed_tpu_torch.models import GPT2, BertForPreTraining
from deepspeed_tpu_torch.parallel import topology
from torch_ranks import run_ranks

RTOL, ATOL = 1e-5, 1e-6
#: the upstream gradient's scale: the inputs are O(1), the gradients then
#: O(1) too, and fp32 sums in another order differ by ~1e-7 of them
DY = 0.1
B, T, H, N, V = 2, 16, 32, 4, 64
M = P("model")
TINY = dict(vocab_size=V, max_seq_len=T, num_layers=2, hidden_size=H,
            num_heads=N, remat=False)


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def layer_cases(mp, seed=0):
    """``(inputs, cases)``: each case names the port's layer, its argument
    keys with the dim each is sharded on (None: replicated), the output's
    sharded dim, and the JAX function with its ``shard_map`` specs."""
    rng = np.random.default_rng(seed)
    inp = {"x": _rand(rng, B, T, H), "w_col": _rand(rng, H, 2 * H, scale=.2),
           "b_col": _rand(rng, 2 * H), "x_row": _rand(rng, B, T, 2 * H),
           "w_row": _rand(rng, 2 * H, H, scale=.2), "b_row": _rand(rng, H),
           "wte": _rand(rng, V, H), "logits": _rand(rng, B, T, V, scale=3.),
           "dy_col": _rand(rng, B, T, 2 * H, scale=DY),
           "dy_h": _rand(rng, B, T, H, scale=DY),
           "dy_v": _rand(rng, B, T, V, scale=DY),
           "dy_tok": _rand(rng, B, T, scale=DY)}
    # token ids and labels on every shard's rows; labels < 0 ignored
    inp["tokens"] = rng.integers(0, V, (B, T)).astype(np.int32)
    labels = rng.integers(-1, V, (B, T)).astype(np.int32)
    labels[0, :4] = -1
    inp["labels"] = labels
    cases = [
        dict(name="column", fn="column", args=["x", "w_col", "b_col"],
             dims=[None, 1, 0], out_dim=2, dy="dy_col",
             jax=(lambda x, w, b: JL.column_parallel_linear(x, w, b),
                  (P(), P(None, "model"), M), P(None, None, "model"))),
        dict(name="row", fn="row", args=["x_row", "w_row", "b_row"],
             dims=[2, 0, None], out_dim=None, dy="dy_h",
             jax=(lambda x, w, b: JL.row_parallel_linear(x, w, b),
                  (P(None, None, "model"), M, P()), P())),
        dict(name="embedding", fn="embedding", args=["tokens", "wte"],
             dims=[None, 0], out_dim=None, dy="dy_h",
             jax=(JL.vocab_parallel_embedding, (P(), M), P())),
        dict(name="logits", fn="logits", args=["x", "wte"],
             dims=[None, 0], out_dim=2, dy="dy_v",
             jax=(JL.vocab_parallel_logits, (P(), M),
                  P(None, None, "model"))),
        dict(name="ce", fn="ce", args=["logits", "labels"],
             dims=[2, None], out_dim=None, dy="dy_tok",
             jax=(JL.vocab_parallel_cross_entropy,
                  (P(None, None, "model"), P()), P())),
    ]
    seqs = [(T, True, False)] + ([(64, True, False), (256, False, True)]
                                 if mp == 2 else [])
    for t, causal, padded in seqs:
        name = f"attention-T{t}"
        inp.update({f"{name}/x": _rand(rng, B, t, H),
                    f"{name}/qkv_w": _rand(rng, H, 3 * H, scale=.2),
                    f"{name}/qkv_b": _rand(rng, 3 * H, scale=.1),
                    f"{name}/proj_w": _rand(rng, H, H, scale=.2),
                    f"{name}/proj_b": _rand(rng, H, scale=.1),
                    f"{name}/dy": _rand(rng, B, t, H, scale=DY)})
        mask = np.ones((B, t), np.int32)
        if padded:
            mask[1, t - 40:] = 0
        inp[f"{name}/mask"] = mask
        kw = dict(n_heads=N, causal=causal)

        def jattn(x, qw, qb, pw, pb, mask, causal=causal):
            return JL.multihead_attention(x, qw, qb, pw, pb, n_heads_global=N,
                                          causal=causal, attn_mask=mask)
        cases.append(dict(
            name=name, fn="attention",
            args=[f"{name}/{k}" for k in ("x", "qkv_w", "qkv_b", "proj_w",
                                         "proj_b", "mask")],
            dims=[None, 1, 0, 0, None, None], out_dim=None, dy=f"{name}/dy",
            kw=kw, jax=(jattn, (P(), P(None, "model"), M, M, P(), P()),
                        P())))
    return inp, cases


def jax_layer(case, inp, mp):
    """The JAX layer under ``shard_map``: its global output, and the
    gradient of ``sum(y * dy)`` with respect to each float argument."""
    fn, in_specs, out_spec = case["jax"]
    mesh = make_mesh(model_parallel_size=mp, devices=jax.devices()[:mp])
    f = jax.shard_map(fn, mesh=mesh, in_specs=in_specs, out_specs=out_spec)
    args = [jnp.asarray(inp[k]) for k in case["args"]]
    floats = [i for i, a in enumerate(args)
              if jnp.issubdtype(a.dtype, jnp.floating)]
    dy = jnp.asarray(inp[case["dy"]])

    def loss(*fl):
        full = list(args)
        for i, v in zip(floats, fl):
            full[i] = v
        return jnp.sum(f(*full) * dy)
    # the einsum path, pinned without writing the process environment: a
    # setenv while XLA's threads read it can crash the process
    with mock.patch.object(JL, "_attn_mode", lambda: "0"):
        y = jax.jit(f)(*args)
        grads = jax.jit(jax.grad(loss, argnums=tuple(range(len(floats)))))(
            *[args[i] for i in floats])
    return np.asarray(y), {i: np.asarray(g) for i, g in zip(floats, grads)}


def _joined(outs, key, dim):
    """The ranks' local arrays joined along ``dim`` (None: each rank's
    copy must be the same; rank 0's is returned)."""
    if dim is None:
        for o in outs[1:]:
            np.testing.assert_allclose(o[key], outs[0][key], rtol=RTOL,
                                       atol=ATOL, err_msg=key)
        return outs[0][key]
    return np.concatenate([o[key] for o in outs], axis=dim)


@pytest.mark.parametrize("mp", [2, 4])
def test_layers_match_jax_shard_map(mp, tmp_path):
    inp, cases = layer_cases(mp)
    outs = run_ranks(tmp_path, mp, {"scenario": "tp_layers", "cases": [
        {k: v for k, v in c.items() if k != "jax"} for c in cases]}, inp)
    for case in cases:
        y, grads = jax_layer(case, inp, mp)
        name = case["name"]
        np.testing.assert_allclose(_joined(outs, f"{name}/y",
                                           case["out_dim"]), y, rtol=RTOL,
                                   atol=ATOL, err_msg=f"{name} forward")
        for i, g in grads.items():
            np.testing.assert_allclose(
                _joined(outs, f"{name}/g{i}", case["dims"][i]), g,
                rtol=RTOL, atol=ATOL, err_msg=f"{name} grad {i}")


def _dims(jspecs):
    """A JAX PartitionSpec tree as the port's data: the dim sharded over
    ``model``, or None."""
    def dim(spec):
        for i, entry in enumerate(spec):
            if entry == "model" or (isinstance(entry, tuple)
                                    and "model" in entry):
                return i
        return None
    return jax.tree_util.tree_map(dim, jspecs,
                                  is_leaf=lambda x: isinstance(x, P))


def _models():
    jg, tg = JGPT2.from_size("tiny", **TINY), GPT2.from_size("tiny", **TINY)
    jb = JBert.from_size("tiny", use_nsp=True, **TINY)
    tb = BertForPreTraining.from_size("tiny", use_nsp=True, **TINY)
    return [(jg, tg), (jb, tb)]


def test_partition_specs_are_the_jax_specs():
    for jm, tm in _models():
        want = weights.flatten_tree(_dims(jm.partition_specs()))
        got = weights.flatten_tree(tm.partition_specs())
        assert got == want
        assert set(got) == {k for k, _ in tm.named_parameters()}
    # the replicated leaves of GPT-2: wpe, ln1_*, ln2_*, proj_b, fc2_b,
    # lnf_*
    got = weights.flatten_tree(GPT2.from_size("tiny", **TINY)
                               .partition_specs())
    assert sorted(k for k, d in got.items() if d is None) == [
        "blocks.fc2_b", "blocks.ln1_b", "blocks.ln1_s", "blocks.ln2_b",
        "blocks.ln2_s", "blocks.proj_b", "lnf_b", "lnf_s", "wpe"]


@pytest.mark.parametrize("mp", [2, 4])
def test_shard_and_combine_trees_match_jax(mp):
    jm = JBert.from_size("tiny", use_nsp=True, **TINY)
    params = jax.tree_util.tree_map(np.asarray,
                                    jm.init_params(jax.random.PRNGKey(3)))
    specs = _dims(jm.partition_specs())
    local = [weights.shard_tree(params, specs, mp, r) for r in range(mp)]
    # every rank's local tree is that device's block of the JAX sharding
    mesh = make_mesh(model_parallel_size=mp, devices=jax.devices()[:mp])
    rank_of = {d: r for r, d in enumerate(mesh.devices.flat)}
    jspecs = weights.flatten_tree(jm.partition_specs())
    for name, x in weights.flatten_tree(params).items():
        arr = jax.device_put(x, NamedSharding(mesh, jspecs[name]))
        for sh in arr.addressable_shards:
            got = weights.flatten_tree(local[rank_of[sh.device]])[name]
            assert np.array_equal(got, np.asarray(sh.data)), name
    back = weights.combine_local_trees(local, specs)
    jback = jzero.combine_local_trees(local, jm.partition_specs(), "model")
    for name, x in weights.flatten_tree(back).items():
        assert np.array_equal(x, weights.flatten_tree(params)[name])
        assert np.array_equal(x, weights.flatten_tree(jback)[name])
    # tensors too, and the qkv slice is whole heads: (n / mp, 3, d)
    qkv = torch.arange(2 * H * 3 * H, dtype=torch.float32).reshape(
        2, H, 3 * H)
    part = weights.shard_tree({"qkv_w": qkv}, {"qkv_w": 2}, mp, 1)["qkv_w"]
    d = H // N
    heads = qkv.reshape(2, H, N, 3, d)[:, :, N // mp:2 * N // mp]
    assert torch.equal(part.reshape(heads.shape), heads)


@pytest.mark.parametrize("mp", [1, 2, 4])
def test_local_flat_meta_and_norm_weights_match_jax(mp):
    jm = JGPT2.from_size("tiny", **TINY)
    params = jax.tree_util.tree_map(np.asarray,
                                    jm.init_params(jax.random.PRNGKey(3)))
    specs = _dims(jm.partition_specs())
    jmeta = jzero.make_local_flat_meta(params, jm.partition_specs(),
                                       {"model": mp}, 2)
    local = weights.flatten_tree(weights.shard_tree(params, specs, mp, 0))
    meta = zero.make_flat_meta({k: torch.from_numpy(np.array(v))
                                for k, v in local.items()}, 2)
    assert (meta.total, meta.padded, meta.partition, meta.shapes) == (
        jmeta.total, jmeta.padded, jmeta.partition, jmeta.shapes)
    w = zero.norm_dedup_weights(meta, weights.flatten_tree(specs), mp)
    jw = jzero.norm_dedup_weights(jmeta, jm.partition_specs(),
                                  [("model", mp)] if mp > 1 else [])
    got = np.concatenate([np.full(n, x, np.float32)
                          for x, n in zip(w, meta.sizes)])
    assert np.array_equal(got, jw[:meta.total])


def test_validate_refuses_what_jax_refuses():
    for over in (dict(num_heads=2), dict(vocab_size=62), {}):
        kw = dict(TINY, **over)
        jcfg = JGPT2.from_size("tiny", **kw).config
        model = GPT2.from_size("tiny", **kw)
        for mp in (2, 4):
            try:
                jcfg.validate(mp)
            except ValueError as e:
                with pytest.raises(ValueError) as ours:
                    model.validate(mp)
                assert str(ours.value) == str(e)
            else:
                model.validate(mp)


def test_partition_id_is_the_data_rank_within_its_group():
    """rank = dp_rank * mp + mp_rank: at dp 2 x mp 2, ranks 0 and 1 are
    data rank 0 (model ranks 0 and 1), ranks 2 and 3 data rank 1, and
    with pps = dp each owns partition dp_rank."""
    cpu = torch.device("cpu")
    got = [topology.Topology(device=cpu, rank=r, dp=2, mp=2, pps=2)
           for r in range(4)]
    assert [(t.dp_rank, t.mp_rank, t.partition_id) for t in got] == [
        (0, 0, 0), (0, 1, 0), (1, 0, 1), (1, 1, 1)]
    assert [topology.Topology(device=cpu, rank=r, dp=1, mp=2,
                              pps=1).partition_id for r in range(2)] == [0, 0]
    assert got[1].data_ranks(1) == [1, 3]


def test_topology_sizes_and_refusals():
    assert topology.make_topology({}, "cpu").mp == 1
    with pytest.raises(ValueError, match="needs 2 processes"):
        topology.make_topology({"model_parallel_size": 2}, "cpu")
    # pipeline and sequence parallelism are ported
    # (tests/test_torch_pipeline.py, test_torch_sp_*.py), and need their
    # processes
    for key, error, match in (
            ("context_parallel_size", ValueError, "needs 2 processes"),
            ("pipeline_parallel_size", ValueError, "needs 2 processes")):
        with pytest.raises(error, match=match):
            topology.make_topology({key: 2}, "cpu")
        with pytest.raises(error, match=match):
            topology.make_topology({}, "cpu", mesh=topology.MeshConfig(
                **{key: 2}))
    # the mesh beats the config
    with pytest.raises(ValueError, match="model_parallel_size=2"):
        topology.make_topology({"model_parallel_size": 1}, "cpu",
                               mesh=topology.MeshConfig(2))


def test_gloo_on_a_card_needs_the_explicit_backend(monkeypatch):
    """A CUDA device with a gloo group raises unless ``init_distributed``
    was given ``backend="gloo"`` (which it records); the card check is
    mocked."""
    import torch.distributed as dist
    cuda = torch.device("cuda", 0)
    monkeypatch.setattr(topology, "resolve_device", lambda device: cuda)
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_backend", lambda group=None: "gloo")
    monkeypatch.setattr(dist, "get_world_size", lambda group=None: 1)
    monkeypatch.setattr(dist, "get_rank", lambda group=None: 0)
    monkeypatch.setattr(topology, "_EXPLICIT_BACKEND", None)
    with pytest.raises(RuntimeError, match="a CUDA run needs NCCL"):
        topology.make_topology({}, cuda)
    # init_distributed(..., backend="gloo") records the caller's choice
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    monkeypatch.setattr(dist, "init_process_group", lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "set_device", lambda device: None)
    topology.init_distributed("tcp://127.0.0.1:1", 2, 0, device=cuda,
                              backend="gloo")
    assert topology._EXPLICIT_BACKEND == "gloo"
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    assert topology.make_topology({}, cuda).device == cuda
    # an NCCL group on a card needs nothing named
    monkeypatch.setattr(topology, "_EXPLICIT_BACKEND", None)
    monkeypatch.setattr(dist, "get_backend", lambda group=None: "nccl")
    assert topology.make_topology({}, cuda).dp == 1
