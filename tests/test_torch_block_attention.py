"""The port's whole-tile attention and attention dispatch against the JAX
package's, on the CPU.

On CPU tensors the kernel wrappers run their plain versions, so these tests
hold the plain versions (and the autograd functions and the plan around
them) against ``deepspeed_tpu.ops.pallas_attention`` and
``deepspeed_tpu.models.layers``:

* ``FusedAttention`` (``block_fwd_plain``/``block_bwd_plain``) against
  ``fused_attention`` in Pallas interpret mode, forward and ``jax.vjp``,
  with padded keys and a fully padded row;
* every legal (forward, backward) pair of ``dispatch_attention`` against
  the JAX ``dispatch_attention`` in interpret mode (the streaming pairs
  under ``DSTPU_STREAM_BWD=split``: the JAX fused stream backward needs
  ``pl.load``/``pl.store``, which this jax lacks), and both rejections;
* the port's ``attention_plan`` against the JAX plan with the backend
  reported as a TPU and every threshold pinned by env, and the env-pin
  validation.

Tolerances: fp32 outputs ``rtol=1e-5, atol=1e-5``, fp32 grads
``rtol=2e-4, atol=2e-5`` (``test_dispatch_block_combos_parity``'s); bf16
``rtol=atol=2e-2`` relative to the largest value, because the two
frameworks round the bf16 products and casts at different places.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.models import layers as JL
from deepspeed_tpu.ops import pallas_attention as PA
from deepspeed_tpu_torch.models import layers as TL
from deepspeed_tpu_torch.ops import block_attention as BA
from deepspeed_tpu_torch.ops import dispatch_attention as DA
from deepspeed_tpu_torch.ops import stream_attention as SA


def inputs(B, T, n, d, seed=0, pad=True):
    """q, k, v, do [B, T, n, d] and a [B, T] mask: the tail of row 0's
    keys masked, and every key of row 1 (a uniform row)."""
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.normal(size=(B, T, n, d)).astype(np.float32)
                   for _ in range(4))
    mask = np.ones((B, T), np.float32)
    if pad:
        mask[0, T - T // 4 - 5:] = 0.0
        if B > 1:
            mask[1] = 0.0
    return q, k, v, do, mask


def tol(dtype, want, grad=False):
    if dtype == "float32":
        return (dict(rtol=2e-4, atol=2e-5) if grad
                else dict(rtol=1e-5, atol=1e-5))
    return dict(rtol=2e-2, atol=2e-2 * float(np.abs(want).max()))


def jax_out_and_grads(fn, q, k, v, do, dtype):
    """fn's output and the vjp of ``sum(out.astype(f32) * do)``."""
    jdt = jnp.dtype(dtype)
    out, pull = jax.vjp(lambda a, b, c: fn(a, b, c).astype(jnp.float32),
                        *(jnp.asarray(x, jdt) for x in (q, k, v)))
    return [np.asarray(x, np.float32)
            for x in (out, *pull(jnp.asarray(do)))]


def port_out_and_grads(fn, q, k, v, do, dtype):
    tdt = getattr(torch, dtype)
    tq = [torch.tensor(x).to(tdt).requires_grad_() for x in (q, k, v)]
    out = fn(*tq)
    (out.float() * torch.tensor(do)).sum().backward()
    assert out.dtype == tdt and all(t.grad.dtype == tdt for t in tq)
    return [t.detach().float().numpy() for t in [out] + [t.grad for t in tq]]


def assert_match(got, want, dtype):
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g, w, err_msg="o dq dk dv".split()[i],
                                   **tol(dtype, w, grad=i > 0))


# ----------------------------------------------------- the whole-tile kernel

BLOCK_CASES = [  # B, T, n, d, causal, pad, dtype
    (2, 128, 4, 32, True, True, "float32"),
    (1, 64, 12, 16, False, True, "float32"),
    (2, 64, 4, 32, False, False, "float32"),
    (2, 64, 4, 16, True, True, "bfloat16"),
]


@pytest.mark.parametrize("B,T,n,d,causal,pad,dtype", BLOCK_CASES)
def test_fused_attention_matches_jax_interpret(B, T, n, d, causal, pad,
                                               dtype):
    q, k, v, do, mask = inputs(B, T, n, d, seed=T + n, pad=pad)
    want = jax_out_and_grads(lambda a, b, c: PA.fused_attention(
        a, b, c, jnp.asarray(mask), causal, True), q, k, v, do, dtype)
    tmask = torch.tensor(mask)
    got = port_out_and_grads(lambda a, b, c: BA.fused_attention(
        a, b, c, tmask, causal), q, k, v, do, dtype)
    assert_match(got, want, dtype)
    # the autograd function runs the plain versions, as they are
    tdt = getattr(torch, dtype)
    tq, tk, tv, tdo = (torch.tensor(x).to(tdt) for x in (q, k, v, do))
    np.testing.assert_array_equal(
        BA.block_fwd_plain(tq, tk, tv, tmask, causal).float().numpy(),
        got[0])
    if dtype == "float32":
        for g, w in zip(BA.block_bwd_plain(tq, tk, tv, tmask, tdo, causal),
                        got[1:]):
            np.testing.assert_array_equal(g.numpy(), w)
    assert BA.LAUNCHES == dict.fromkeys(BA.LAUNCHES, 0)


def test_fully_masked_rows_are_uniform():
    """A row whose keys are all masked attends uniformly over all T keys,
    under causal too (so a causal tile skip must not touch such a row)."""
    q, k, v, _, mask = inputs(2, 64, 2, 16, seed=5)
    o = BA.block_fwd_plain(*(torch.tensor(x) for x in (q, k, v)),
                           torch.tensor(mask), True)
    mean_v = v[1].mean(axis=0)
    np.testing.assert_allclose(o[1].numpy(),
                               np.broadcast_to(mean_v, o[1].shape),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16], ids=str)
def test_causal_probs_after_the_query_are_exact_zeros(dtype):
    """The premise of the CUDA kernels' causal skip: a row with an
    unmasked key at or before it gives p exactly 0.0 on every later key,
    so the products over those keys add exact zeros."""
    B, T = 3, 128
    q, k, _, _, _ = inputs(B, T, 2, 16, seed=3)
    mask = np.ones((B, T), np.float32)
    mask[1, :5] = 0.0      # rows 0-4 have no unmasked key up to them
    mask[2, 70:] = 0.0     # a padded tail
    p = BA._probs(torch.tensor(q).to(dtype), torch.tensor(k).to(dtype),
                  torch.tensor(mask), True)
    first = np.argmax(mask != 0, axis=1)
    for b in range(B):
        for qi in range(first[b], T):
            assert torch.equal(p[b, :, qi, qi + 1:],
                               torch.zeros_like(p[b, :, qi, qi + 1:]))
        # rows before the first unmasked key stay uniform over all T keys
        torch.testing.assert_close(
            p[b, :, :first[b]], torch.full_like(p[b, :, :first[b]], 1 / T))


def test_block_gates():
    for T in (8, 16, 48, 64, 120, 128, 136, 256, 512):
        for n in (4, 12, 16, 25):
            for d in (8, 16, 32, 64, 72):
                assert BA.supported(T, n, d) == PA.supported(T, n, d)
                assert BA.kernel_supported(T, d) == (
                    T % 8 == 0 and 8 <= T <= 512 and d % 8 == 0
                    and d <= 128)
    assert BA.SCORE_TILE_BUDGET == PA.SCORE_TILE_BUDGET
    # the shapes the JAX gate admits past the route-0 kernels are the
    # kernels' too (the wide route); past head dim 128 they are not
    assert PA.supported(136, 4, 32) and BA.kernel_supported(136, 32)
    assert PA.supported(256, 4, 32) and BA.kernel_supported(256, 32)
    assert PA.supported(128, 4, 136) and not BA.kernel_supported(128, 136)


# ----------------------------------------------------------------- dispatch

def _pairs(impls):
    return [p for p in itertools.product(impls, impls)
            if p != ("block", "stream")]


DISPATCH_CASES = (
    [(128, True, f, b) for f, b in _pairs(("xla", "block"))]
    + [(256, False, f, b) for f, b in _pairs(("xla", "stream"))]
    # the JAX gates admit both kernels at seq 256 with 4 heads
    + [(256, True, "stream", "block")])


@pytest.mark.parametrize("T,causal,fwd_impl,bwd_impl", DISPATCH_CASES)
def test_dispatch_pairs_match_jax_interpret(monkeypatch, T, causal,
                                            fwd_impl, bwd_impl):
    monkeypatch.setenv("DSTPU_STREAM_BWD", "split")
    q, k, v, do, mask = inputs(2, T, 4, 16, seed=T + causal)
    want = jax_out_and_grads(lambda a, b, c: PA.dispatch_attention(
        a, b, c, jnp.asarray(mask), causal, fwd_impl, bwd_impl, True),
        q, k, v, do, "float32")
    tmask = torch.tensor(mask)
    SA.reset_launch_counts()
    got = port_out_and_grads(lambda a, b, c: DA.dispatch_attention(
        a, b, c, tmask, causal, fwd_impl, bwd_impl), q, k, v, do, "float32")
    assert_match(got, want, "float32")
    assert SA.LAUNCHES == dict.fromkeys(SA.LAUNCHES, 0)


def test_dispatch_rejections_match_jax():
    q = torch.zeros((1, 16, 2, 8))
    mask = torch.ones((1, 16))
    jq = jnp.zeros((1, 16, 2, 8))
    jmask = jnp.ones((1, 16))
    for impls, match in ((("block", "stream"), "logsumexp"),
                         (("nope", "xla"), "impls must be one of")):
        with pytest.raises(ValueError, match=match) as port_err:
            DA.dispatch_attention(q, q, q, mask, False, *impls)
        with pytest.raises(ValueError, match=match) as jax_err:
            PA.dispatch_attention(jq, jq, jq, jmask, False, *impls, True)
        assert str(port_err.value) == str(jax_err.value)


@pytest.mark.parametrize("causal", [False, True])
def test_xla_attention_lse_matches_jax(causal):
    q, k, v, _, mask = inputs(2, 32, 3, 8, seed=9)
    jo, jlse = PA.xla_attention(*(jnp.asarray(x) for x in (q, k, v)),
                                jnp.asarray(mask), causal, with_lse=True)
    to, tlse = DA.xla_attention(*(torch.tensor(x) for x in (q, k, v)),
                                torch.tensor(mask), causal, with_lse=True)
    assert tlse.shape == (2 * 3, 1, 32)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(tlse.numpy(), np.asarray(jlse), rtol=1e-5,
                               atol=1e-5)
    # layers keeps the einsum path under its name
    assert TL.xla_attention is DA.xla_attention


# --------------------------------------------------------------------- plan

PINS = (  # each sets every threshold pin
    {"DSTPU_STREAM_ATTN_MIN_CAUSAL_FWD": "512",
     "DSTPU_STREAM_ATTN_MIN_CAUSAL_BWD": "256",
     "DSTPU_STREAM_ATTN_MIN_CAUSAL": "1024",
     "DSTPU_STREAM_ATTN_MIN_FWD": "256",
     "DSTPU_STREAM_ATTN_MIN_BWD": "512",
     "DSTPU_STREAM_ATTN_MIN": "1024",
     "DSTPU_BLOCK_ATTN_MIN_CAUSAL": "128"},
    {"DSTPU_STREAM_ATTN_MIN_CAUSAL_FWD": "256",
     "DSTPU_STREAM_ATTN_MIN_CAUSAL_BWD": "256",
     "DSTPU_STREAM_ATTN_MIN_CAUSAL": "256",
     "DSTPU_STREAM_ATTN_MIN_FWD": "1024",
     "DSTPU_STREAM_ATTN_MIN_BWD": "1024",
     "DSTPU_STREAM_ATTN_MIN": "1024",
     "DSTPU_BLOCK_ATTN_MIN_CAUSAL": "64"},
)
GRID = list(itertools.product((64, 128, 136, 176, 256, 512), (4, 12, 16),
                              (32, 64, 96, 128), (False, True)))


@pytest.fixture
def tpu_plan(monkeypatch):
    """The JAX plan as it resolves on a TPU (every threshold pinned, so its
    per-kind table is never read)."""
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    return monkeypatch


@pytest.mark.parametrize("pins", range(len(PINS)))
def test_attention_plan_matches_jax(tpu_plan, pins):
    for name, value in PINS[pins].items():
        tpu_plan.setenv(name, value)
    # the JAX plan with its gates narrowed to what the CUDA kernels take
    jax_stream, jax_block = PA.stream_supported, PA.supported
    narrowed = {
        "stream_supported": lambda T, d: (jax_stream(T, d)
                                          and SA.stream_supported(T, d)),
        "supported": lambda T, n, d: (jax_block(T, n, d)
                                      and BA.kernel_supported(T, d))}
    seen = set()
    for mode in ("auto", "1", "0"):
        tpu_plan.setenv("DSTPU_FUSED_ATTN", mode)
        for T, n, d, causal in GRID:
            port = TL.attention_plan(T, n, d, causal)
            if mode == "auto":
                with pytest.MonkeyPatch.context() as mp:
                    for name, fn in narrowed.items():
                        mp.setattr(PA, name, fn)
                    want = JL.attention_plan(T, n, d, causal)
            else:
                want = JL.attention_plan(T, n, d, causal)
            assert port == want, (mode, T, n, d, causal)
            seen.add(port)
    assert {("block", "block"), ("stream", "stream"), ("xla", "xla")} <= seen
    # the whole-tile kernels take these (the wide route): the JAX plan's
    # pair under both modes
    for T, d in ((136, 32), (128, 72)):
        for mode in ("1", "auto"):
            tpu_plan.setenv("DSTPU_FUSED_ATTN", mode)
            assert JL.attention_plan(T, 4, d, True) == ("block", "block")
            assert TL.attention_plan(T, 4, d, True) == ("block", "block")
    # past head dim 128 the JAX gate admits what the CUDA kernels' gate
    # does not: auto takes the einsum path, "1" raises naming the gate
    tpu_plan.setenv("DSTPU_FUSED_ATTN", "1")
    assert JL.attention_plan(128, 4, 136, True) == ("block", "block")
    with pytest.raises(NotImplementedError, match="kernel_supported"):
        TL.attention_plan(128, 4, 136, True)
    tpu_plan.setenv("DSTPU_FUSED_ATTN", "auto")
    assert TL.attention_plan(128, 4, 136, True) == ("xla", "xla")


def test_attention_plan_directions_match_jax(tpu_plan):
    """The mixed pairs: per-direction stream thresholds, and a streaming
    backward after a whole-tile forward becoming a whole-tile backward."""
    for name in ("DSTPU_STREAM_ATTN_MIN", "DSTPU_STREAM_ATTN_MIN_BWD",
                 "DSTPU_FUSED_ATTN"):
        tpu_plan.delenv(name, raising=False)
    tpu_plan.setenv("DSTPU_STREAM_ATTN_MIN_CAUSAL", "1024")
    tpu_plan.setenv("DSTPU_STREAM_ATTN_MIN_CAUSAL_BWD", "256")
    tpu_plan.setenv("DSTPU_BLOCK_ATTN_MIN_CAUSAL", "128")
    tpu_plan.setenv("DSTPU_STREAM_ATTN_MIN_FWD", "256")
    for T, n, want in ((512, 12, ("xla", "stream")),
                       (256, 4, ("block", "block")),
                       (128, 12, ("block", "block"))):
        assert TL.attention_plan(T, n, 64, True) == want
        assert JL.attention_plan(T, n, 64, True) == want
    # at seq 256 with 4 heads both gates admit the whole-tile kernel (the
    # CUDA one by its wide route), so both plans turn (block, stream) into
    # (block, block)


@pytest.mark.parametrize("name,value,match,T", [
    ("DSTPU_STREAM_ATTN_MIN_CAUSAL", "abc", "not an integer token count",
     512),
    ("DSTPU_STREAM_ATTN_MIN_BWD", "-3", "must be a non-negative count", 512),
    ("DSTPU_STREAM_ATTN_MIN", "0", "not a valid token count", 512),
    # read only where the streaming kernels do not take the shape
    ("DSTPU_BLOCK_ATTN_MIN_CAUSAL", "x1", "not an integer token count", 128),
])
def test_env_pin_validation_matches_jax(tpu_plan, name, value, match, T):
    tpu_plan.delenv("DSTPU_FUSED_ATTN", raising=False)
    tpu_plan.setenv(name, value)
    with pytest.raises(ValueError, match=match) as port_err:
        TL.attention_plan(T, 16, 64, True)
    with pytest.raises(ValueError, match=match) as jax_err:
        JL.attention_plan(T, 16, 64, True)
    assert str(port_err.value) == str(jax_err.value)


def test_thresholds_and_direction_validation(monkeypatch):
    for name in ("DSTPU_STREAM_ATTN_MIN", "DSTPU_STREAM_ATTN_MIN_CAUSAL",
                 "DSTPU_STREAM_ATTN_MIN_CAUSAL_FWD",
                 "DSTPU_STREAM_ATTN_MIN_FWD", "DSTPU_BLOCK_ATTN_MIN_CAUSAL"):
        monkeypatch.delenv(name, raising=False)
    with pytest.raises(ValueError, match="direction must be") as port_err:
        TL.stream_auto_min(True, "sideways")
    with pytest.raises(ValueError, match="direction must be") as jax_err:
        JL.stream_auto_min(True, "sideways")
    assert str(port_err.value) == str(jax_err.value)
    # no card: the kernels' granule; the whole-tile threshold is the one
    # measured constant, and 0 disables it
    assert TL.stream_auto_min(True) == TL.stream_auto_min(False) == 256
    assert TL.block_auto_min_causal() == TL.BLOCK_AUTO_MIN_CAUSAL
    monkeypatch.setenv("DSTPU_BLOCK_ATTN_MIN_CAUSAL", "0")
    assert TL.block_auto_min_causal() is None
    assert TL.attention_plan(128, 16, 64, True) == ("xla", "xla")


def test_core_attention_routes_each_plan(monkeypatch):
    """core_attention sends the single-impl pairs to the kernels' own
    autograd functions and the mixed pairs through dispatch_attention, and
    every route computes the einsum path's function.  (Not on a row whose
    keys are all masked: there the einsum path's grads are 0 and the
    whole-tile kernel's are those of the uniform row, in both packages.)"""
    q, k, v, do, mask = inputs(1, 128, 4, 16, seed=13)
    calls = []
    for mod, name in ((BA, "fused_attention"), (SA, "stream_attention"),
                      (DA, "dispatch_attention")):
        real = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _r=real, _n=name: (
            calls.append(_n), _r(*a))[1])
    monkeypatch.setattr(TL, "attention_plan", lambda *a: plan)
    outs = {}
    for plan in (("xla", "xla"), ("block", "block"), ("xla", "block"),
                 ("block", "xla")):
        outs[plan] = port_out_and_grads(
            lambda a, b, c: TL.core_attention(
                a, b, c, causal=True, attn_mask=torch.tensor(mask)),
            q, k, v, do, "float32")
    assert calls == ["fused_attention", "dispatch_attention",
                     "dispatch_attention"]
    for plan, got in outs.items():
        assert_match(got, outs[("xla", "xla")], "float32")
