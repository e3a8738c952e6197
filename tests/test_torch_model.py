"""The port's BERT and layers against the JAX package's, with shared weights.

A tiny BERT (2 layers, hidden 128, 4 heads, vocab 512, seq 64) is built in
both packages; the JAX parameters are carried into the port with
``weights.params_from_numpy`` and the same numpy batches go through both.
The loss and EVERY gradient must agree.  Tolerances: fp32 loss
``rtol=1e-5``, fp32 grads ``rtol=1e-4, atol=1e-5``; bf16 loss ``rtol=2e-2``
(the two frameworks round bf16 at different places).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from deepspeed_tpu.models import BertForPreTraining as JBert
from deepspeed_tpu.models import layers as JL
from deepspeed_tpu.parallel.topology import make_mesh
from deepspeed_tpu_torch import weights
from deepspeed_tpu_torch.models import BertForPreTraining as TBert
from deepspeed_tpu_torch.models import layers as TL

VOCAB, SEQ, B, NPRED = 512, 64, 4, 10
TINY = dict(max_seq_len=SEQ, vocab_size=VOCAB, num_layers=2,
            hidden_size=128, num_heads=4)


def bert_pair(use_nsp=False, budget=None):
    jm = JBert.from_size("tiny", use_nsp=use_nsp, mlm_gather_budget=budget,
                         **TINY)
    params = jax.tree_util.tree_map(np.asarray,
                                    jm.init_params(jax.random.PRNGKey(0)))
    if use_nsp:
        # nsp_w starts at zero; give it values so its grads are non-trivial
        params["nsp_w"] = np.random.default_rng(9).normal(
            size=params["nsp_w"].shape).astype(np.float32) * 0.02
    tm = TBert.from_size("tiny", use_nsp=use_nsp, mlm_gather_budget=budget,
                         **TINY)
    weights.params_from_numpy(tm, params)
    return jm, tm, params


def make_batch(fmt, nsp=False, padded=False, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, VOCAB, size=(B, SEQ)).astype(np.int32)
    mask = np.ones((B, SEQ), np.int32)
    if padded:
        mask[0, SEQ - 7:] = 0
        mask[2, SEQ // 2:] = 0
    tt = np.zeros((B, SEQ), np.int32)
    tt[:, SEQ // 2:] = 1
    if fmt == "dense":
        labels = np.full((B, SEQ), -1, np.int32)
        for b in range(B):
            pos = rng.choice(SEQ, size=NPRED, replace=False)
            labels[b, pos] = rng.integers(0, VOCAB, size=NPRED)
        rest = (labels,)
    else:
        pos = np.stack([rng.choice(SEQ, size=NPRED, replace=False)
                        for _ in range(B)]).astype(np.int32)
        mlm_ids = rng.integers(0, VOCAB, size=(B, NPRED)).astype(np.int32)
        w = np.ones((B, NPRED), np.float32)
        w[1, NPRED - 3:] = 0.0
        rest = (pos, mlm_ids, w)
    if nsp:
        rest = rest + (rng.integers(0, 2, size=(B,)).astype(np.int32),)
    return (ids, mask, tt) + rest


def jax_loss_and_grads(model, params, batch, dtype=jnp.float32):
    mesh = make_mesh(devices=jax.devices()[:1])
    specs = model.partition_specs(params)

    def local(p, *b):
        pc = jax.tree_util.tree_map(lambda x: x.astype(dtype), p)
        return jax.value_and_grad(lambda q: model.apply(q, *b))(pc)

    fn = jax.jit(jax.shard_map(
        local, mesh=mesh, in_specs=(specs,) + tuple(P() for _ in batch),
        out_specs=(P(), specs), check_vma=False))
    loss, grads = fn(params, *batch)
    return float(loss), weights.flatten_tree(
        jax.tree_util.tree_map(lambda g: np.asarray(g, np.float32), grads))


def torch_loss_and_grads(model, batch, dtype=torch.float32):
    model = model.to(dtype)
    model.zero_grad(set_to_none=True)
    loss = model(*(torch.from_numpy(x) for x in batch))
    loss.backward()
    return float(loss.detach()), {k: p.grad.float().numpy()
                                  for k, p in model.named_parameters()}


CASES = [
    ("dense", False, False, None),
    ("dense", True, True, None),
    ("dense", False, True, 16),       # mlm_gather_budget sparse head
    ("positions", False, False, None),
    ("positions", True, True, None),
]


@pytest.mark.parametrize("fmt,nsp,padded,budget", CASES,
                         ids=[f"{c[0]}-nsp{int(c[1])}-pad{int(c[2])}-"
                              f"budget{c[3]}" for c in CASES])
def test_bert_fp32_loss_and_every_grad_match_jax(fmt, nsp, padded, budget):
    jm, tm, params = bert_pair(use_nsp=nsp, budget=budget)
    batch = make_batch(fmt, nsp=nsp, padded=padded)
    jl, jg = jax_loss_and_grads(jm, params, batch)
    tl, tg = torch_loss_and_grads(tm, batch)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert tg.keys() == jg.keys()
    for k in jg:
        np.testing.assert_allclose(tg[k], jg[k], rtol=1e-4, atol=1e-5,
                                   err_msg=k)


@pytest.mark.parametrize("fmt", ["dense", "positions"])
def test_bert_bf16_loss_matches_jax(fmt):
    jm, tm, params = bert_pair(use_nsp=True)
    batch = make_batch(fmt, nsp=True, padded=True, seed=1)
    jl, _ = jax_loss_and_grads(jm, params, batch, dtype=jnp.bfloat16)
    tl, tg = torch_loss_and_grads(tm, batch, dtype=torch.bfloat16)
    np.testing.assert_allclose(tl, jl, rtol=2e-2)
    assert all(np.isfinite(g).all() for g in tg.values())


def test_remat_full_and_dots_give_the_same_grads():
    _, tm, params = bert_pair()
    batch = make_batch("positions")
    ref_l, ref_g = torch_loss_and_grads(tm, batch)
    for remat, policy in ((False, "full"), (True, "dots"),
                          (True, "selective")):
        tm.with_config(remat=remat, remat_policy=policy)
        loss, grads = torch_loss_and_grads(tm, batch)
        assert loss == ref_l
        for k in ref_g:
            np.testing.assert_allclose(grads[k], ref_g[k], rtol=1e-6,
                                       atol=1e-7, err_msg=k)


# ------------------------------------------------------------------ layers

def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape)
            * scale).astype(np.float32)


def test_layer_norm_and_gelu_match_jax():
    x, s, b = _rand((3, 5, 32), 0, 3.0), _rand((32,), 1), _rand((32,), 2)
    np.testing.assert_allclose(
        TL.layer_norm(torch.tensor(x), torch.tensor(s),
                      torch.tensor(b)).numpy(),
        np.asarray(JL.layer_norm(jnp.asarray(x), jnp.asarray(s),
                                 jnp.asarray(b))), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        TL.gelu(torch.tensor(x)).numpy(),
        np.asarray(JL.gelu(jnp.asarray(x))), rtol=1e-5, atol=1e-6)
    xb = torch.tensor(x).bfloat16()
    assert TL.layer_norm(xb, torch.tensor(s), torch.tensor(b)).dtype == \
        torch.bfloat16
    assert TL.gelu(xb).dtype == torch.bfloat16


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_core_attention_fwd_and_grads_match_jax(causal, dtype):
    q, k, v = (_rand((2, 16, 4, 8), s) for s in range(3))
    do = _rand((2, 16, 4, 8), 3)
    mask = np.ones((2, 16), np.float32)
    mask[1, 11:] = 0.0
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)

    def jf(q_, k_, v_):
        out = JL.core_attention(q_, k_, v_, causal=causal,
                                attn_mask=jnp.asarray(mask))
        return jnp.sum(out.astype(jnp.float32) * do), out

    jargs = [jnp.asarray(x, jdt) for x in (q, k, v)]
    (_, jout), jgrads = jax.value_and_grad(jf, argnums=(0, 1, 2),
                                           has_aux=True)(*jargs)
    targs = [torch.tensor(x).to(tdt).requires_grad_() for x in (q, k, v)]
    tout = TL.core_attention(*targs, causal=causal,
                             attn_mask=torch.tensor(mask))
    (tout.float() * torch.tensor(do)).sum().backward()
    assert tout.dtype == tdt
    tol = (dict(rtol=1e-5, atol=1e-6) if dtype == "float32"
           else dict(rtol=2e-2, atol=2e-2))
    np.testing.assert_allclose(tout.float().detach().numpy(),
                               np.asarray(jout, np.float32), **tol)
    for t, j in zip(targs, jgrads):
        assert t.grad.dtype == tdt
        np.testing.assert_allclose(t.grad.float().numpy(),
                                   np.asarray(j, np.float32), **(
                                       dict(rtol=1e-4, atol=1e-5)
                                       if dtype == "float32" else tol))


def test_weights_round_trip_and_shapes():
    jm, tm, params = bert_pair(use_nsp=True)
    back = weights.params_to_numpy(tm)
    flat_in, flat_out = (weights.flatten_tree(params),
                         weights.flatten_tree(back))
    assert flat_in.keys() == flat_out.keys()
    for k in flat_in:
        np.testing.assert_array_equal(flat_out[k], flat_in[k])
    with pytest.raises(KeyError, match="missing"):
        weights.params_from_numpy(tm, {"wte": params["wte"]})
    bad = dict(params, wpe=np.zeros((3, 3), np.float32))
    with pytest.raises(ValueError, match="wpe"):
        weights.params_from_numpy(tm, bad)


def test_bert_large_has_the_jax_leaves():
    jm = JBert.from_size("large", max_seq_len=128)
    shapes = jax.eval_shape(jm.init_params, jax.random.PRNGKey(0))
    want = {k: tuple(v.shape) for k, v in
            weights.flatten_tree(shapes).items()}
    tm = TBert.from_size("large", max_seq_len=128, device="meta")
    got = {k: tuple(p.shape) for k, p in tm.named_parameters()}
    assert got == want
    assert len(got) == 22
    assert sum(int(np.prod(s)) for s in got.values()) == 334_787_392
