"""The whole-tile attention at every shape the JAX whole-tile gate takes up
to head dim 128, on the CPU.

On CPU tensors the kernel wrappers run their plain versions, so these tests
hold the plain versions, the port's gate and a model on that path against
the JAX package:

* ``FusedAttention`` (``block_fwd_plain``/``block_bwd_plain``) against
  ``pallas_attention.fused_attention`` in Pallas interpret mode, forward and
  ``jax.vjp``, at the shapes of the wide route (T 72-264, not a multiple of
  16 or past 128; head dims 64, 96, 128), with the tolerances of
  ``test_torch_block_attention.py`` (``tol``);
* the port's whole-tile gate (``supported`` and ``kernel_supported``)
  equal to the JAX ``supported`` over T 8-520, nine head counts and every
  head dim up to 128, and refusing past 128;
* a 2-layer GPT-2 with head dim 96 (hidden 384, 4 heads) at seq 136 from
  the same numpy weights (``weights.py``): two fp32 Adam steps (gas 2) of
  the port's engine, on the whole-tile path in both directions, against
  the JAX engine.  Losses ``rtol=1e-5``, masters ``rtol=1e-4, atol=1e-6``
  (``tests/test_torch_engine.py``'s fp32 tolerances; Adam runs with
  ``eps=1e-6`` for the reason given there).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models import GPT2 as JGPT2
from deepspeed_tpu.ops import pallas_attention as PA
from deepspeed_tpu.parallel.topology import make_mesh
from deepspeed_tpu_torch import weights
from deepspeed_tpu_torch.models import GPT2
from deepspeed_tpu_torch.models import layers as TL
from deepspeed_tpu_torch.ops import block_attention as BA
from test_torch_block_attention import (assert_match, inputs,
                                        jax_out_and_grads,
                                        port_out_and_grads)

# ------------------------------------------------------------ kernel parity

WIDE_CASES = [  # B, T, n, d, causal
    (1, 136, 8, 64, True),
    (1, 128, 4, 96, True),
    (1, 176, 8, 128, True),
    (1, 72, 4, 96, True),
    (1, 264, 2, 40, True),
    (1, 136, 4, 96, False),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,T,n,d,causal", WIDE_CASES)
def test_wide_shapes_match_jax_interpret(B, T, n, d, causal, dtype):
    """Padded keys (the tail of row 0), causal and not.  Every case is a
    wide-route shape in fp32; in bf16 (128, 96) is route 0's."""
    assert PA.supported(T, n, d) and BA.wide_route(T, d, torch.float32)
    q, k, v, do, mask = inputs(B, T, n, d, seed=T + d)
    want = jax_out_and_grads(lambda a, b, c: PA.fused_attention(
        a, b, c, jnp.asarray(mask), causal, True), q, k, v, do, dtype)
    tmask = torch.tensor(mask)
    got = port_out_and_grads(lambda a, b, c: BA.fused_attention(
        a, b, c, tmask, causal), q, k, v, do, dtype)
    assert_match(got, want, dtype)
    tdt = getattr(torch, dtype)
    tq, tk, tv = (torch.tensor(x).to(tdt) for x in (q, k, v))
    np.testing.assert_array_equal(
        BA.block_fwd_plain(tq, tk, tv, tmask, causal).float().numpy(),
        got[0])
    assert BA.LAUNCHES == dict.fromkeys(BA.LAUNCHES, 0)


# --------------------------------------------------------------------- gate

HEADS = (1, 2, 3, 4, 8, 12, 16, 24, 25)


@pytest.mark.parametrize("n", HEADS)
def test_gate_equals_the_jax_gate_up_to_head_dim_128(n):
    longest = 0
    for T in range(8, 521, 8):
        for d in range(8, 129, 8):
            port = BA.supported(T, n, d) and BA.kernel_supported(T, d)
            assert port == PA.supported(T, n, d), (T, n, d)
            longest = max(longest, T * port)
        # past head dim 128 the port still refuses what the JAX gate takes
        for d in (136, 256):
            assert not BA.kernel_supported(T, d)
    # the score-tile budget (heads in blocks of 8 where n % 8 == 0)
    assert longest == {1: 512, 2: 360, 3: 288, 4: 256, 8: 176, 12: 144,
                       16: 176, 24: 176, 25: 96}[n]


def test_gate_past_head_dim_128_and_the_routes():
    assert PA.supported(128, 4, 136) and not BA.kernel_supported(128, 136)
    assert PA.supported(64, 1, 256) and not BA.kernel_supported(64, 256)
    # route 0 takes T a multiple of 16 up to 128 with d up to 128 in bf16
    # and fp16 (the wgmma kernels) and up to 64 in fp32 (the FMA kernels);
    # the wide route takes the rest
    widest = {torch.float32: 64, torch.bfloat16: 128, torch.float16: 128}
    for dtype, dmax in widest.items():
        for T in range(8, 521, 8):
            for d in range(8, 129, 8):
                assert BA.wide_route(T, d, dtype) == (
                    not (T % 16 == 0 and T <= 128 and d <= dmax)), (
                        dtype, T, d)


@pytest.mark.parametrize("size,n,d", [("large", 16, 96), ("8b", 24, 128)])
def test_gpt2_large_and_8b_heads_take_route_0_at_seq_128(size, n, d,
                                                          monkeypatch):
    """GPT-2 large's attention at seq 128 (16 heads of 96) and the 8b
    preset's heads (24 of 128) take the whole-tile kernels in both
    directions, on route 0 in bf16 and fp16 and on the wide route in
    fp32.  Both routes run behind the same ``dstpu::block_fwd`` /
    ``block_bwd`` operators, so the route is read from the gate."""
    for name in ("DSTPU_FUSED_ATTN", "DSTPU_BLOCK_ATTN_MIN_CAUSAL"):
        monkeypatch.delenv(name, raising=False)
    cfg = GPT2.from_size(size, device="meta").config
    assert (cfg.num_heads, cfg.hidden_size // cfg.num_heads) == (n, d)
    assert TL.attention_plan(128, n, d, True) == ("block", "block")
    assert BA.supported(128, n, d) and BA.kernel_supported(128, d)
    assert not BA.wide_route(128, d, torch.bfloat16)
    assert not BA.wide_route(128, d, torch.float16)
    assert BA.wide_route(128, d, torch.float32)


# ---------------------------------------------------------------- the model

SEQ, VOCAB, MICRO, GAS, STEPS = 136, 512, 2, 2, 2
HD96 = dict(num_layers=2, hidden_size=384, num_heads=4, max_seq_len=SEQ,
            vocab_size=VOCAB, remat=False)


def lm_batches():
    rng = np.random.default_rng(3)
    out = []
    for _ in range(STEPS):
        toks = rng.integers(0, VOCAB, size=(MICRO * GAS, SEQ)).astype(
            np.int32)
        labels = np.roll(toks, -1, axis=1)
        labels[:, -1] = -1
        labels[0, :5] = -1
        out.append((toks, labels))
    return out


def test_gpt2_head_dim_96_seq_136_trains_as_the_jax_engine(monkeypatch):
    for name in ("DSTPU_FUSED_ATTN", "DSTPU_BLOCK_ATTN_MIN_CAUSAL"):
        monkeypatch.delenv(name, raising=False)
    assert TL.attention_plan(SEQ, 4, 96, True) == ("block", "block")
    counts = {"fwd": 0, "bwd": 0}
    for key, name in (("fwd", "block_fwd_plain"),
                      ("bwd", "block_bwd_plain")):
        real = getattr(BA, name)
        monkeypatch.setattr(BA, name, lambda *a, _r=real, _k=key: (
            counts.__setitem__(_k, counts[_k] + 1), _r(*a))[1])
    jm = JGPT2.from_size("tiny", **HD96)
    params = jax.tree_util.tree_map(
        np.asarray, jm.init_params(jax.random.PRNGKey(0)))
    cfg = {"train_batch_size": MICRO * GAS,
           "gradient_accumulation_steps": GAS,
           "optimizer": {"type": "Adam",
                         "params": {"lr": 1e-3, "eps": 1e-6}},
           "steps_per_print": 10 ** 9}
    data = lm_batches()
    jeng = deepspeed_tpu.initialize(
        config=cfg, model=jm, model_parameters=params,
        mesh=make_mesh(devices=jax.devices()[:1]))[0]
    jl = [float(jeng.train_batch(b)) for b in data]
    jmaster = weights.flatten_tree(
        jax.tree_util.tree_map(np.asarray, jeng.master))
    teng = deepspeed_tpu_torch.initialize(
        config=cfg, model=GPT2.from_size("tiny", **HD96),
        model_parameters=params, device="cpu")[0]
    tl = [float(teng.train_batch(b)) for b in data]
    # the whole-tile path, once per layer and micro-batch each way
    assert counts == {"fwd": 2 * GAS * STEPS, "bwd": 2 * GAS * STEPS}
    assert BA.LAUNCHES == dict.fromkeys(BA.LAUNCHES, 0)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    init = weights.flatten_tree(params)
    assert teng.master.keys() == jmaster.keys()
    for k in jmaster:
        got = teng.master[k].numpy()
        assert not np.array_equal(got, init[k]), k
        np.testing.assert_allclose(got, jmaster[k], rtol=1e-4, atol=1e-6,
                                   err_msg=k)
