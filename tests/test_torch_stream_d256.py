"""The streaming attention at head dims in (128, 256], on the CPU.

On CPU tensors the kernel wrappers run their plain versions, so these tests
hold the plain versions, the port's gate and plan, and a model on that path
against the JAX package:

* the port's streaming gate equal to ``pallas_attention.stream_supported``
  for every head dim that is a multiple of 8 up to 256 and refusing 264;
  ``attention_plan`` equal to the JAX plan (resolved as on a TPU) at
  seq >= 256 and head dims 136 and 256, under ``DSTPU_FUSED_ATTN=1`` and
  ``auto``; past 256 "1" raises naming the gate and ``auto`` takes the
  einsum path;
* the forward (``o`` and ``lse``), dK/dV and dQ at T 256, d 256, causal
  and not, with padded keys, against ``_stream_fwd_impl`` and
  ``_stream_bwd_impl`` (``DSTPU_STREAM_BWD=split``: the Pallas dkv and dq
  kernels) in Pallas interpret mode, in fp32: ``o``/``lse``
  ``rtol=atol=1e-5``, grads ``atol=2e-5`` (``test_torch_stream_attention``'s
  fp32 tolerances); the fused plain backward bitwise equal to the split
  pair;
* a 2-layer causal GPT-2 with two heads of 256 (hidden 512, vocab 512) at
  seq 256 from the same numpy weights (``weights.params_from_numpy``):
  loss ``rtol=1e-5`` and every grad ``rtol=1e-4, atol=1e-5``
  (``tests/test_torch_model.py``'s tolerances) against the JAX GPT-2 with
  its attention through the Pallas stream kernels in interpret mode under
  ``DSTPU_STREAM_BWD=split``.

Two jitted JAX functions in all: the kernels (both causal values in one
trace) and the model's loss and grads.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from deepspeed_tpu.models import GPT2 as JGPT2
from deepspeed_tpu.models import layers as JL
from deepspeed_tpu.ops import pallas_attention as PA
from deepspeed_tpu.parallel.topology import make_mesh
from deepspeed_tpu_torch import weights
from deepspeed_tpu_torch.models import GPT2 as TGPT2
from deepspeed_tpu_torch.models import layers as TL
from deepspeed_tpu_torch.ops import stream_attention as SA

T, D, N_HEADS = 256, 256, 2
FWD_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=0, atol=2e-5)

# ------------------------------------------------------------------ gates


@pytest.mark.parametrize("seq", [0, 128, 255, 256, 384, 512, 1000, 1024])
def test_stream_gate_matches_jax_up_to_head_dim_256(seq):
    for d in range(8, 257, 8):
        assert SA.stream_supported(seq, d) == PA.stream_supported(seq, d)
    # the kernels stage at most 256 of the head dim
    assert SA.jax_stream_supported(seq, 264) == PA.stream_supported(seq, 264)
    assert not SA.stream_supported(seq, 264)


def test_kernel_check_names_the_head_dim_limit():
    q = torch.zeros((2, 256, 264), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiple of 8 up to 256"):
        SA._check("stream_fwd", q, q=q)
    SA._check("stream_fwd", q[..., :256].contiguous(),
              q=q[..., :256].contiguous())


@pytest.fixture
def tpu_plan(monkeypatch):
    """The JAX plan as it resolves on a TPU, every threshold pinned (its
    per-kind table is never read)."""
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    for name in ("DSTPU_STREAM_ATTN_MIN_CAUSAL", "DSTPU_STREAM_ATTN_MIN_FWD",
                 "DSTPU_STREAM_ATTN_MIN_BWD",
                 "DSTPU_STREAM_ATTN_MIN_CAUSAL_FWD",
                 "DSTPU_STREAM_ATTN_MIN_CAUSAL_BWD"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("DSTPU_STREAM_ATTN_MIN", "256")
    monkeypatch.setenv("DSTPU_BLOCK_ATTN_MIN_CAUSAL", "64")
    return monkeypatch


@pytest.mark.parametrize("mode", ["1", "auto"])
def test_attention_plan_takes_the_stream_kernels_to_head_dim_256(tpu_plan,
                                                                 mode):
    tpu_plan.setenv("DSTPU_FUSED_ATTN", mode)
    for seq in (256, 512, 1024, 2048):
        for d in (136, 256):
            for n in (2, 16):
                for causal in (False, True):
                    want = JL.attention_plan(seq, n, d, causal)
                    assert want == ("stream", "stream")
                    assert TL.attention_plan(seq, n, d, causal) == want


def test_attention_plan_past_head_dim_256(tpu_plan):
    """Where the JAX gate still takes the shape and the kernels' does not:
    "1" raises naming the gate, "auto" takes the einsum path."""
    tpu_plan.setenv("DSTPU_FUSED_ATTN", "1")
    assert JL.attention_plan(512, 16, 264, True) == ("stream", "stream")
    with pytest.raises(NotImplementedError, match="stream_supported"):
        TL.attention_plan(512, 16, 264, True)
    tpu_plan.setenv("DSTPU_FUSED_ATTN", "auto")
    assert TL.attention_plan(512, 16, 264, True) == ("xla", "xla")


# ---------------------------------------------------------------- kernels

def _inputs(seed=0):
    """q, k, v, dO [1, T, 2, 256] and a [1, T] key mask with padded keys."""
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.normal(size=(1, T, N_HEADS, D)).astype(np.float32)
                   for _ in range(4))
    mask = np.ones((1, T), np.float32)
    mask[0, T - T // 4 - 5:] = 0.0
    return q, k, v, do, mask


@pytest.fixture(scope="module")
def jax_kernels():
    """``{causal: (o, lse, dq, dk, dv)}`` of the Pallas stream kernels in
    interpret mode on ``_inputs()`` (folded [G, T, d] layout), the backward
    as the split pair, both causal values in one trace."""
    q, k, v, do, mask = _inputs()

    def both(q, k, v, do, mask):
        out = {}
        for causal in (False, True):
            o, lse, (qg, kg, vg, maskg) = PA._stream_fwd_impl(
                q, k, v, mask, causal, True)
            out[causal] = (o, lse) + PA._stream_bwd_impl(
                qg, kg, vg, maskg, o, lse, PA._fold_gtd(do), causal, True)
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DSTPU_STREAM_BWD", "split")
        got = jax.jit(both)(*(jnp.asarray(x) for x in (q, k, v, do, mask)))
    return {c: [np.asarray(x, np.float32) for x in got[c]] for c in got}


def _port(causal):
    """The plain versions on the same inputs: (o, lse), the fused backward
    and the split pair, each backward on the JAX forward's o and lse."""
    q, k, v, do, mask = _inputs()
    qg, kg, vg, dog = (SA.fold_gtd(torch.tensor(x)) for x in (q, k, v, do))
    maskg = SA.mask_gtd(torch.tensor(mask), 1, T, N_HEADS)
    o, lse = SA.stream_fwd(qg, kg, vg, maskg, causal)
    return qg, kg, vg, maskg, dog, o, lse


@pytest.mark.parametrize("causal", [False, True])
def test_d256_forward_matches_jax_interpret(jax_kernels, causal):
    _, _, _, _, _, o, lse = _port(causal)
    jo, jlse = jax_kernels[causal][:2]
    assert o.shape == (N_HEADS, T, D) and lse.shape == (N_HEADS, 1, T)
    np.testing.assert_allclose(o.numpy(), jo, **FWD_TOL)
    np.testing.assert_allclose(lse.numpy(), jlse, **FWD_TOL)


@pytest.mark.parametrize("kernel", ["dkv", "dq"])
@pytest.mark.parametrize("causal", [False, True])
def test_d256_backward_matches_jax_interpret(jax_kernels, causal, kernel):
    """Each split kernel's plain version on the JAX forward's o and lse."""
    qg, kg, vg, maskg, dog, _, _ = _port(causal)
    jo, jlse, jdq, jdk, jdv = (torch.tensor(x) for x in jax_kernels[causal])
    delta = (dog * jo).sum(-1)[:, None, :]
    args = (qg, kg, vg, maskg, dog, jlse, delta, causal)
    SA.reset_launch_counts()
    if kernel == "dkv":
        got, want = SA.stream_dkv(*args), (jdk, jdv)
    else:
        got, want = (SA.stream_dq(*args),), (jdq,)
    assert SA.LAUNCHES == dict.fromkeys(SA.LAUNCHES, 0)
    for name, g, w in zip(("dk", "dv") if kernel == "dkv" else ("dq",),
                          got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), err_msg=name,
                                   **GRAD_TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_d256_fused_plain_backward_equals_the_split_pair(monkeypatch,
                                                         causal):
    qg, kg, vg, maskg, dog, o, lse = _port(causal)
    delta = (dog * o).sum(-1)[:, None, :]
    args = (qg, kg, vg, maskg, dog, lse, delta, causal)
    dq, dk, dv = SA.stream_bwd_fused(*args)
    for a, b in zip((dk, dv), SA.stream_dkv(*args)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    torch.testing.assert_close(dq, SA.stream_dq(*args), rtol=0, atol=0)
    # and through stream_backward in both modes
    got = {}
    for mode in ("fused", "split"):
        monkeypatch.setenv("DSTPU_STREAM_BWD", mode)
        got[mode] = SA.stream_backward(qg, kg, vg, maskg, o, lse, dog, causal)
    for a, b in zip(got["fused"], got["split"]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


# ------------------------------------------------------------------ model

def _jax_stream_interpret(q, k, v, *, causal, attn_mask=None):
    """The JAX ``core_attention`` through the Pallas stream kernels in
    interpret mode (off the TPU the JAX plan takes the einsum path)."""
    B, S = q.shape[:2]
    mvec = (jnp.ones((B, S), jnp.float32) if attn_mask is None
            else attn_mask.astype(jnp.float32))
    return PA.stream_attention(q, k, v, mvec, causal, True)


def test_gpt2_two_heads_of_256_matches_jax_split(monkeypatch):
    """Both directions of each layer's attention through the streaming
    plain versions (the split pair: the budget is 0), against the JAX GPT-2
    through the Pallas stream kernels."""
    monkeypatch.delenv("DSTPU_FUSED_ATTN", raising=False)
    monkeypatch.setenv("DSTPU_STREAM_BWD", "split")
    monkeypatch.setattr(JL, "core_attention", _jax_stream_interpret)
    size = dict(remat=False, hidden_size=512, num_heads=2, max_seq_len=T)
    jm = JGPT2.from_size("tiny", **size)
    params = jax.tree_util.tree_map(np.asarray,
                                    jm.init_params(jax.random.PRNGKey(0)))
    tm = TGPT2.from_size("tiny", **size)
    assert tm.config.hidden_size // tm.config.num_heads == D
    weights.params_from_numpy(tm, params)
    rng = np.random.default_rng(3)
    toks = rng.integers(0, 512, size=(2, T)).astype(np.int32)
    labels = np.roll(toks, -1, axis=1)
    labels[:, -1] = -1
    labels[1, :7] = -1
    batch = (toks, labels)

    mesh = make_mesh(devices=jax.devices()[:1])
    specs = jm.partition_specs(params)
    fn = jax.jit(jax.shard_map(
        lambda p, *b: jax.value_and_grad(lambda q: jm.apply(q, *b))(p),
        mesh=mesh, in_specs=(specs,) + tuple(P() for _ in batch),
        out_specs=(P(), specs), check_vma=False))
    jl, jg = fn(params, *batch)
    jg = weights.flatten_tree(jax.tree_util.tree_map(np.asarray, jg))

    monkeypatch.setenv("DSTPU_STREAM_BWD", "auto")
    assert TL.attention_plan(T, 2, D, True) == ("stream", "stream")
    calls = []
    for name in ("stream_fwd_plain", "stream_dkv_plain", "stream_dq_plain",
                 "stream_bwd_plain"):
        real = getattr(SA, name)
        monkeypatch.setattr(SA, name, lambda *a, _n=name, _f=real: (
            calls.append(_n), _f(*a))[1])
    loss = tm(*(torch.from_numpy(x) for x in batch))
    loss.backward()
    layers = tm.config.num_layers
    assert calls == (["stream_fwd_plain"] * layers
                     + ["stream_dkv_plain", "stream_dq_plain"] * layers)
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    tg = {k: p.grad.numpy() for k, p in tm.named_parameters()}
    assert tg.keys() == jg.keys() and len(tg) == 16
    for k in jg:
        np.testing.assert_allclose(tg[k], jg[k], rtol=1e-4, atol=1e-5,
                                   err_msg=k)
