"""The port's GPT-2 against the JAX package's, with shared weights.

A tiny GPT-2 (2 layers, hidden 128, 4 heads of 32, vocab 512, seq 128,
causal, pre-LN) is built in both packages; the JAX parameters are carried
into the port with ``weights.params_from_numpy`` and the same numpy batch
goes through both.  At causal seq 128 the port's plan takes the whole-tile
attention (plain versions on the CPU), while the JAX plan off the TPU takes
the einsum path: the same function, rounded differently.  The loss and
EVERY gradient must agree: fp32 loss ``rtol=1e-5``, grads ``rtol=1e-4,
atol=1e-5`` (``tests/test_torch_model.py``'s); bf16 loss ``rtol=2e-2``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import deepspeed_tpu_torch
from deepspeed_tpu.models import GPT2 as JGPT2
from deepspeed_tpu.parallel.topology import make_mesh
from deepspeed_tpu_torch import weights
from deepspeed_tpu_torch.models import GPT2, GPT2MoE
from deepspeed_tpu_torch.ops import block_attention as BA
from deepspeed_tpu_torch.ops import cuda_optim

B, SEQ, VOCAB = 2, 128, 512


def lm_batch(rows=B, seed=0):
    """Tokens and next-token labels (last column and a few more -1)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, VOCAB, size=(rows, SEQ)).astype(np.int32)
    labels = np.roll(toks, -1, axis=1)
    labels[:, -1] = -1
    labels[0, :7] = -1
    return toks, labels


def gpt2_pair():
    jm = JGPT2.from_size("tiny", remat=False)
    params = jax.tree_util.tree_map(np.asarray,
                                    jm.init_params(jax.random.PRNGKey(0)))
    tm = GPT2.from_size("tiny", remat=False)
    weights.params_from_numpy(tm, params)
    return jm, tm, params


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


@pytest.fixture
def block_spy(monkeypatch):
    """Counts of the whole-tile plain versions (auto dispatch)."""
    for name in ("DSTPU_FUSED_ATTN", "DSTPU_BLOCK_ATTN_MIN_CAUSAL"):
        monkeypatch.delenv(name, raising=False)
    counts = {"fwd": 0, "bwd": 0}

    def spy(key, fn):
        def wrapped(*a):
            counts[key] += 1
            return fn(*a)
        return wrapped

    monkeypatch.setattr(BA, "block_fwd_plain",
                        spy("fwd", BA.block_fwd_plain))
    monkeypatch.setattr(BA, "block_bwd_plain",
                        spy("bwd", BA.block_bwd_plain))
    return counts


def test_gpt2_fp32_loss_and_every_grad_match_jax(block_spy):
    jm, tm, params = gpt2_pair()
    batch = lm_batch()
    jl, jg = jax_loss_and_grads(jm, params, batch)
    loss = tm(*(torch.from_numpy(x) for x in batch))
    loss.backward()
    # the whole-tile path ran, once per layer in each direction
    assert block_spy == {"fwd": 2, "bwd": 2}
    np.testing.assert_allclose(float(loss.detach()), jl, rtol=1e-5)
    tg = {k: p.grad.numpy() for k, p in tm.named_parameters()}
    assert tg.keys() == jg.keys() and len(tg) == 16
    for k in jg:
        np.testing.assert_allclose(tg[k], jg[k], rtol=1e-4, atol=1e-5,
                                   err_msg=k)


def test_gpt2_bf16_loss_matches_jax(block_spy):
    jm, tm, params = gpt2_pair()
    batch = lm_batch(seed=1)
    jl, _ = jax_loss_and_grads(jm, params, batch, dtype=jnp.bfloat16)
    tm = tm.to(torch.bfloat16)
    loss = tm(*(torch.from_numpy(x) for x in batch))
    loss.backward()
    assert block_spy == {"fwd": 2, "bwd": 2}
    np.testing.assert_allclose(float(loss.detach()), jl, rtol=2e-2)
    assert all(torch.isfinite(p.grad).all() for p in tm.parameters())


def test_train_batch_runs_the_block_path_on_the_cpu(block_spy):
    """Two ``train_batch`` steps (gas 2, Adam) of the port on the CPU: the
    whole-tile path runs once per layer per micro-batch in each direction,
    through the plain versions, and no kernel launches."""
    BA.reset_launch_counts()
    cuda_optim.reset_launch_counts()
    gas, steps = 2, 2
    cfg = {"train_batch_size": B * gas, "gradient_accumulation_steps": gas,
           "optimizer": {"type": "Adam", "params": {"lr": 1e-3}},
           "activation_checkpointing": False, "steps_per_print": 10 ** 9}
    model = GPT2.from_size("tiny", generator=torch.Generator().manual_seed(0))
    engine, _, _, _ = deepspeed_tpu_torch.initialize(
        config=cfg, model=model, device="cpu")
    losses = [float(engine.train_batch(lm_batch(B * gas, seed=s)))
              for s in range(steps)]
    want = model.config.num_layers * gas * steps
    assert block_spy == {"fwd": want, "bwd": want}
    assert BA.LAUNCHES == dict.fromkeys(BA.LAUNCHES, 0)
    assert cuda_optim.LAUNCHES == dict.fromkeys(cuda_optim.LAUNCHES, 0)
    assert np.isfinite(losses).all() and losses[1] < losses[0]


def test_gpt2_medium_has_the_jax_leaves():
    jm = JGPT2.from_size("medium")
    shapes = jax.eval_shape(jm.init_params, jax.random.PRNGKey(0))
    want = {k: tuple(v.shape) for k, v in
            weights.flatten_tree(shapes).items()}
    tm = GPT2.from_size("medium", device="meta")
    got = {k: tuple(p.shape) for k, p in tm.named_parameters()}
    assert got == want
    assert len(got) == 16
    assert sum(int(np.prod(s)) for s in got.values()) == 354_871_296
    cfg = tm.config
    assert (cfg.num_layers, cfg.hidden_size, cfg.num_heads, cfg.vocab_size,
            cfg.max_seq_len, cfg.pre_ln, cfg.causal) == (
                24, 1024, 16, 50304, 1024, True, True)


def test_gpt2_init_distributions():
    tm = GPT2.from_size("small", generator=torch.Generator().manual_seed(0),
                        device="cpu")
    std = tm.config.init_std
    np.testing.assert_allclose(float(tm.wte.std()), std, rtol=0.02)
    np.testing.assert_allclose(float(tm.wpe.std()), std * 0.5, rtol=0.02)
    assert torch.equal(tm.lnf_s, torch.ones_like(tm.lnf_s))
    assert torch.equal(tm.lnf_b, torch.zeros_like(tm.lnf_b))


def test_unported_gpt2_paths_raise():
    tm = GPT2.from_size("tiny", device="meta")
    # tensor parallelism is ported: mp 2 passes, an mp that does not
    # divide the heads raises the JAX check's error
    tm.validate(2)
    with pytest.raises(ValueError, match="not divisible by mp 3"):
        tm.validate(3)
    # serving is ported (tests/test_torch_inference.py): the KV dims are
    # the JAX model's at mp 1 and 2
    jtiny = JGPT2.from_size("tiny")
    for mp in (1, 2):
        assert tm.kv_cache_dims(mp) == jtiny.kv_cache_dims(mp)
    # ZeRO-3 is ported (tests/test_torch_zero3.py): the fields exist, and
    # the block leaves pin their layer axis as the JAX hook does
    assert tm.zero3_dims is None and tm.zero3_prefetch is False
    jm = JGPT2.from_size("tiny")
    jmin = jm.zero3_min_dims(jm.init_params(jax.random.PRNGKey(0)))
    assert tm.zero3_min_dims() == weights.flatten_tree(jmin)
    # the MoE GPT-2 is ported (tests/test_torch_moe.py): it builds, with
    # the JAX model's leaf names and shapes
    from deepspeed_tpu.models import GPT2MoE as JGPT2MoE
    tmoe = GPT2MoE.from_size("tiny", device="meta")
    jmoe = JGPT2MoE.from_size("tiny")
    jshapes = weights.flatten_tree(jax.tree_util.tree_map(
        lambda x: tuple(x.shape),
        jax.eval_shape(jmoe.init_params, jax.random.PRNGKey(0))))
    assert {k: tuple(p.shape) for k, p in tmoe.named_parameters()} == \
        jshapes
