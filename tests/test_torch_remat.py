"""The ``"selective"`` remat policy: save the named ``qkv`` and ``ffn1``
activations, recompute the rest.

A tiny BERT (2 layers, hidden 64, 4 heads, vocab 512, seq 64) with the JAX
package's weights (``weights.params_from_numpy``) and the same numpy batch
goes through both packages under ``"selective"``: the loss within ``rtol
1e-5`` and every gradient within ``rtol 1e-5, atol 1e-7`` (fp32) of the
JAX model's.  The port's selective gradients are bitwise equal to its own
gradients with remat off, and a ``TorchDispatchMode`` over the backward
sees no replay of the qkv or fc1 product.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P
from torch.utils._python_dispatch import TorchDispatchMode

import deepspeed_tpu_torch
from deepspeed_tpu.models import BertForPreTraining as JBert
from deepspeed_tpu.parallel.topology import make_mesh
from deepspeed_tpu_torch import weights
from deepspeed_tpu_torch.models import GPT2, BertForPreTraining as TBert
from deepspeed_tpu_torch.models import layers as TL

VOCAB, SEQ, B, NPRED, H = 512, 64, 4, 10, 64
TINY = dict(max_seq_len=SEQ, vocab_size=VOCAB, num_layers=2, hidden_size=H,
            num_heads=4)
SELECTIVE = dict(remat=True, remat_policy="selective")


def jax_params():
    jm = JBert.from_size("tiny", use_nsp=True, **TINY)
    return jax.tree_util.tree_map(np.asarray,
                                  jm.init_params(jax.random.PRNGKey(0)))


def batch(seed=0, seq=SEQ):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, VOCAB, size=(B, seq)).astype(np.int32)
    mask = np.ones((B, seq), np.int32)
    mask[1, seq - 9:] = 0
    tt = np.zeros((B, seq), np.int32)
    tt[:, seq // 2:] = 1
    pos = np.stack([rng.choice(seq, size=NPRED, replace=False)
                    for _ in range(B)]).astype(np.int32)
    mlm_ids = rng.integers(0, VOCAB, size=(B, NPRED)).astype(np.int32)
    nsp = rng.integers(0, 2, size=(B,)).astype(np.int32)
    return ids, mask, tt, pos, mlm_ids, np.ones((B, NPRED), np.float32), nsp


def jax_loss_and_grads(params, b):
    jm = JBert.from_size("tiny", use_nsp=True, **TINY, **SELECTIVE)
    specs = jm.partition_specs(params)
    fn = jax.jit(jax.shard_map(
        lambda p, *x: jax.value_and_grad(lambda q: jm.apply(q, *x))(p),
        mesh=make_mesh(devices=jax.devices()[:1]),
        in_specs=(specs,) + tuple(P() for _ in b), out_specs=(P(), specs),
        check_vma=False))
    loss, grads = fn(params, *b)
    return float(loss), weights.flatten_tree(
        jax.tree_util.tree_map(np.asarray, grads))


def torch_model(params, **cfg):
    tm = TBert.from_size("tiny", use_nsp=True, **TINY, **cfg)
    weights.params_from_numpy(tm, params)
    return tm


def torch_loss_and_grads(model, b, mode=None):
    model.zero_grad(set_to_none=True)
    loss = model(*(torch.from_numpy(x) for x in b))
    if mode is None:
        loss.backward()
    else:
        with mode:
            loss.backward()
    return loss.detach(), {k: p.grad.clone()
                           for k, p in model.named_parameters()}


class ProductCount(TorchDispatchMode):
    """Counts forward replays of the qkv and fc1 products: products whose
    right operand is the (untransposed) qkv or fc1 weight.  The backward's
    own products use these weights transposed, or no weight at all."""

    _MM = {torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
           torch.ops.aten.bmm.default, torch.ops.aten.baddbmm.default,
           torch.ops.aten.matmul.default}

    def __init__(self, model):
        super().__init__()
        self.weights = {model.blocks.qkv_w.untyped_storage().data_ptr(),
                        model.blocks.fc_w.untyped_storage().data_ptr()}
        self.widths = {model.blocks.qkv_w.shape[-1],
                       model.blocks.fc_w.shape[-1]}
        self.replays = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func in self._MM:
            right = args[-1]
            if (right.untyped_storage().data_ptr() in self.weights
                    and right.shape[-1] in self.widths):
                self.replays += 1
        return out


def test_selective_loss_and_every_grad_match_jax():
    params, b = jax_params(), batch()
    jl, jg = jax_loss_and_grads(params, b)
    tl, tg = torch_loss_and_grads(torch_model(params, **SELECTIVE), b)
    np.testing.assert_allclose(float(tl), jl, rtol=1e-5)
    assert tg.keys() == jg.keys()
    for k in jg:
        np.testing.assert_allclose(tg[k].numpy(), jg[k], rtol=1e-5,
                                   atol=1e-7, err_msg=k)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_selective_is_bitwise_remat_off(dtype):
    params, b = jax_params(), batch(1)
    off = torch_model(params, remat=False).to(dtype)
    sel = torch_model(params, **SELECTIVE).to(dtype)
    l0, g0 = torch_loss_and_grads(off, b)
    l1, g1 = torch_loss_and_grads(sel, b)
    assert torch.equal(l0, l1)
    for k in g0:
        assert torch.equal(g0[k], g1[k]), k


@pytest.mark.parametrize("remat,policy,replays", [
    (True, "selective", 0), (False, "full", 0), (True, "full", 4)])
def test_backward_replays_no_qkv_or_fc1_product(remat, policy, replays):
    """Under "selective" the backward's recompute finds both named
    products saved, as with remat off; "full" replays both in each of the
    2 layers (the count sees a replay where there is one)."""
    params, b = jax_params(), batch(2)
    model = torch_model(params, remat=remat, remat_policy=policy)
    mode = ProductCount(model)
    torch_loss_and_grads(model, b, mode)
    assert mode.replays == replays


def test_gpt2_selective_is_bitwise_remat_off():
    rng = np.random.default_rng(4)
    toks = torch.from_numpy(rng.integers(0, 512, size=(2, 128)))
    labels = torch.roll(toks, -1, 1)
    grads = []
    for cfg in (dict(remat=False), SELECTIVE):
        gen = torch.Generator().manual_seed(0)
        m = GPT2.from_size("tiny", generator=gen, hidden_size=H, **cfg)
        m(toks, labels).backward()
        grads.append({k: p.grad for k, p in m.named_parameters()})
    for k in grads[0]:
        assert torch.equal(grads[0][k], grads[1][k]), k


def test_streaming_path_selective_is_bitwise_remat_off():
    """At seq 256 the attention takes the streaming kernels' plain versions;
    their forward is recomputed in the backward under "selective"."""
    params = jax_params()
    params["wpe"] = np.random.default_rng(5).normal(
        size=(256, H)).astype(np.float32) * 0.02
    b = batch(3, seq=256)
    grads = []
    for cfg in (dict(remat=False), SELECTIVE):
        tm = TBert.from_size("tiny", use_nsp=True,
                             **dict(TINY, max_seq_len=256), **cfg)
        weights.params_from_numpy(tm, params)
        grads.append(torch_loss_and_grads(tm, b)[1])
    for k in grads[0]:
        assert torch.equal(grads[0][k], grads[1][k]), k


def test_engine_selective_config_trains_bitwise_as_remat_off():
    params = jax_params()
    data = [batch(s) for s in range(2)]
    masters = []
    for ac in (False, {"enabled": True, "policy": "selective"}):
        cfg = {"train_batch_size": 2, "gradient_accumulation_steps": 2,
               "optimizer": {"type": "Lamb", "params": {"lr": 1e-3}},
               "bf16": {"enabled": True}, "activation_checkpointing": ac,
               "steps_per_print": 10 ** 9}
        engine, _, _, _ = deepspeed_tpu_torch.initialize(
            config=cfg, model=TBert.from_size("tiny", use_nsp=True, **TINY),
            model_parameters=params, device="cpu")
        assert engine.module.config.remat is bool(ac)
        losses = [engine.train_batch(x) for x in data]
        masters.append((losses, engine.master))
    (l0, m0), (l1, m1) = masters
    assert all(torch.equal(a, b) for a, b in zip(l0, l1))
    for k in m0:
        assert torch.equal(m0[k], m1[k]), k


def test_named_linear_grads_match_the_plain_product():
    rng = np.random.default_rng(6)
    x, w, b = (torch.tensor(rng.normal(size=s).astype(np.float32),
                            requires_grad=True)
               for s in ((2, 5, 8), (8, 12), (12,)))
    g = torch.tensor(rng.normal(size=(2, 5, 12)).astype(np.float32))
    named = TL.column_parallel_linear(x, w, b, name="qkv")
    plain = TL.column_parallel_linear(x, w, b)
    assert torch.equal(named, plain)
    want = torch.autograd.grad(plain, (x, w, b), g)
    got = torch.autograd.grad(named, (x, w, b), g)
    for a, c in zip(got, want):
        torch.testing.assert_close(a, c, rtol=1e-6, atol=1e-6)
