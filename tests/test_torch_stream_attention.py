"""The port's streaming attention against the JAX package's, on the CPU.

On CPU tensors the kernel wrappers run their plain versions, so these tests
hold the plain versions (and the autograd function and dispatch around them)
against ``deepspeed_tpu.ops.pallas_attention``:

* the forward (``o`` and ``lse``) against ``_stream_fwd_impl`` in Pallas
  interpret mode;
* the fused and the split backward against the JAX split backward in
  interpret mode (``DSTPU_STREAM_BWD=split``: the JAX fused backward needs
  ``pl.load``/``pl.store``, which this jax lacks) and against ``jax.grad``
  of ``xla_attention``;
* the gates and the port's ``attention_plan``;
* ``auto``'s choice between the fused backward and the split pair against
  the fused scratch budget (``STREAM_FUSED_SCRATCH_BUDGET``), with the
  scratch size from the port's mirror of ``dstt_stream_bwd_fused_scratch``;
* a tiny BERT at seq 256 (the stream path) against the JAX BERT (which runs
  ``xla_attention`` off the TPU): loss and every grad;
* a tiny GPT-2 at seq 256 (causal, the stream path) in ``auto`` with the
  budget at 0 (the split pair) and at its default (the fused backward),
  against the JAX GPT-2 with its attention through the Pallas stream
  kernels in interpret mode under ``DSTPU_STREAM_BWD=split``: loss and
  every grad.

Tolerances: fp32 ``o``/``lse`` ``rtol=1e-5, atol=1e-5``, fp32 grads
``atol=2e-5``; bf16 ``rtol=atol=2e-2`` (relative to the largest value),
because the two frameworks round the bf16 products and casts at different
places.  The BERT and GPT-2 tests use ``tests/test_torch_model.py``'s
tolerances (loss ``rtol=1e-5``, grads ``rtol=1e-4, atol=1e-5``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import deepspeed_tpu_torch
from deepspeed_tpu.models import GPT2 as JGPT2
from deepspeed_tpu.models import BertForPreTraining as JBert
from deepspeed_tpu.models import layers as JL
from deepspeed_tpu.ops import pallas_attention as PA
from deepspeed_tpu.parallel.topology import make_mesh
from deepspeed_tpu_torch import weights
from deepspeed_tpu_torch.models import GPT2 as TGPT2
from deepspeed_tpu_torch.models import BertForPreTraining as TBert
from deepspeed_tpu_torch.models import layers as TL
from deepspeed_tpu_torch.ops import stream_attention as SA

N_HEADS = 2


def inputs(T, d, B=1, seed=0, pad=True):
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.normal(size=(B, T, N_HEADS, d)).astype(np.float32)
                   for _ in range(4))
    mask = np.ones((B, T), np.float32)
    if pad:
        mask[0, T - T // 4 - 5:] = 0.0      # padded rows
    return q, k, v, do, mask


def tol_of(dtype, want):
    if dtype == "float32":
        return dict(rtol=1e-5, atol=1e-5)
    return dict(rtol=2e-2, atol=2e-2 * float(np.abs(want).max()))


def port_attention(q, k, v, mask, causal, dtype, do):
    """Output and grads of the port's stream path (plain versions)."""
    tdt = getattr(torch, dtype)
    tq = [torch.tensor(x).to(tdt).requires_grad_() for x in (q, k, v)]
    out = SA.stream_attention(*tq, torch.tensor(mask), causal)
    (out.float() * torch.tensor(do)).sum().backward()
    assert out.dtype == tdt and all(t.grad.dtype == tdt for t in tq)
    return [t.detach().float().numpy() for t in [out] + [t.grad for t in tq]]


def jax_grads(fn, q, k, v, do, dtype):
    jdt = jnp.dtype(dtype)
    loss = lambda a, b, c: jnp.sum(fn(a, b, c).astype(jnp.float32) * do)
    return [np.asarray(g, np.float32) for g in jax.grad(
        loss, argnums=(0, 1, 2))(*(jnp.asarray(x, jdt) for x in (q, k, v)))]


# ------------------------------------------------------------------ forward

@pytest.mark.parametrize("T,causal,dtype", [(256, False, "float32"),
                                            (512, True, "float32"),
                                            (256, True, "bfloat16")])
def test_stream_forward_matches_jax_interpret(T, causal, dtype):
    q, k, v, _, mask = inputs(T, 16 if T == 512 else 32, seed=T)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    o, lse, _ = PA._stream_fwd_impl(*(jnp.asarray(x, jdt) for x in (q, k, v)),
                                    jnp.asarray(mask), causal, True)
    qg, kg, vg = (SA.fold_gtd(torch.tensor(x).to(tdt)) for x in (q, k, v))
    maskg = SA.mask_gtd(torch.tensor(mask), 1, T, N_HEADS)
    po, plse = SA.stream_fwd(qg, kg, vg, maskg, causal)
    assert po.dtype == tdt and plse.dtype == torch.float32
    assert plse.shape == (N_HEADS, 1, T)
    want = np.asarray(o, np.float32)
    np.testing.assert_allclose(po.float().numpy(), want,
                               **tol_of(dtype, want))
    np.testing.assert_allclose(plse.numpy(), np.asarray(lse),
                               **tol_of(dtype, np.asarray(lse)))
    # the public layout and the autograd function give the same output
    out = SA.stream_attention(*(torch.tensor(x).to(tdt) for x in (q, k, v)),
                              torch.tensor(mask), causal)
    np.testing.assert_array_equal(
        out.float().numpy(), SA.unfold_gtd(po, 1, N_HEADS).float().numpy())


# ---------------------------------------------------------------- backward

GRAD_CASES = [(256, False, "float32"), (256, True, "float32"),
              (512, False, "float32"), (256, False, "bfloat16")]


@pytest.mark.parametrize("T,causal,dtype", GRAD_CASES)
def test_stream_grads_match_jax_split_and_xla(monkeypatch, T, causal, dtype):
    d = 16 if T == 512 else 32
    q, k, v, do, mask = inputs(T, d, seed=T + causal)
    jmask = jnp.asarray(mask)
    monkeypatch.setenv("DSTPU_STREAM_BWD", "split")
    j_split = jax_grads(lambda a, b, c: PA.stream_attention(
        a, b, c, jmask, causal, True), q, k, v, do, dtype)
    j_xla = jax_grads(lambda a, b, c: PA.xla_attention(
        a, b, c, jmask, causal)[0], q, k, v, do, dtype)
    got = {}
    for mode in ("fused", "split", "auto"):
        monkeypatch.setenv("DSTPU_STREAM_BWD", mode)
        got[mode] = port_attention(q, k, v, mask, causal, dtype, do)[1:]
    # on the CPU both modes run the same plain arithmetic
    for a, b in zip(got["fused"], got["split"]):
        np.testing.assert_array_equal(a, b)
    for want in (j_split, j_xla):
        for name, g, w in zip("qkv", got["fused"], want):
            tol = (dict(rtol=0, atol=2e-5) if dtype == "float32"
                   else tol_of(dtype, w))
            np.testing.assert_allclose(g, w, err_msg=f"d{name}", **tol)


def test_stream_fused_and_split_plain_versions_agree():
    """The three plain backward entry points are one function split up."""
    q, k, v, do, mask = inputs(256, 32, B=2, seed=3)
    qg, kg, vg, dog = (SA.fold_gtd(torch.tensor(x)) for x in (q, k, v, do))
    maskg = SA.mask_gtd(torch.tensor(mask), 2, 256, N_HEADS)
    o, lse = SA.stream_fwd_plain(qg, kg, vg, maskg, True)
    delta = (dog * o).sum(-1)[:, None, :]
    args = (qg, kg, vg, maskg, dog, lse, delta, True)
    dq, dk, dv = SA.stream_bwd_plain(*args)
    for a, b in zip((dk, dv), SA.stream_dkv_plain(*args)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    torch.testing.assert_close(dq, SA.stream_dq_plain(*args), rtol=0, atol=0)
    assert SA.LAUNCHES == dict.fromkeys(SA.LAUNCHES, 0)


# ---------------------------------------------- the fused scratch budget

def _spy_plain(monkeypatch):
    """Counts of the backward plain versions that ``stream_backward``
    reaches (fused: ``stream_bwd_plain``; split: dkv then dq)."""
    calls = []
    for name in ("stream_bwd_plain", "stream_dkv_plain", "stream_dq_plain"):
        real = getattr(SA, name)
        monkeypatch.setattr(SA, name, lambda *a, _n=name, _f=real: (
            calls.append(_n), _f(*a))[1])
    return calls


@pytest.mark.parametrize("G,T,d,words", [
    # bf16, d 64: 128-key blocks; counters G T / 64, then (T / 128) G T d
    (128, 512, 64, 1024 + 4 * 128 * 512 * 64),
    (128, 2048, 64, 4096 + 16 * 128 * 2048 * 64),
    (64, 1024, 64, 1024 + 8 * 64 * 1024 * 64),
    # d 128 or T not a multiple of 128: 64-key blocks; counters padded to 4
    (8, 256, 128, 32 + 4 * 8 * 256 * 128),
    (3, 192, 64, 12 + 3 * 3 * 192 * 64),
    (1, 64, 8, 4 + 1 * 64 * 8)])
def test_fused_scratch_mirror_sizes(G, T, d, words):
    for dtype in (torch.bfloat16, torch.float16):
        got = SA.fused_scratch_words(dtype, G, T, d)
        assert got[0] == words and got[1] == (G * T // 64 + 3) // 4 * 4
    assert SA.fused_scratch_words(torch.float32, G, T, d) == (G * T * d, 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("mode,over,want", [
    ("auto", False, "fused"), ("auto", True, "split"),
    ("fused", True, "fused"), ("fused", False, "fused"),
    ("split", False, "split"), ("split", True, "split")])
def test_stream_backward_mode_respects_the_scratch_budget(
        monkeypatch, dtype, mode, over, want):
    """``auto`` takes the fused kernel while its scratch (the mirror's size
    at this seq-256 shape) fits the budget and the split pair past it;
    ``fused`` and ``split`` ignore the budget.  Both routes give the same
    grads (the plain versions are one function split up)."""
    q, k, v, do, mask = inputs(256, 32, B=2, seed=5)
    qg, kg, vg, dog = (SA.fold_gtd(torch.tensor(x).to(dtype))
                       for x in (q, k, v, do))
    maskg = SA.mask_gtd(torch.tensor(mask), 2, 256, N_HEADS)
    G, T, d = qg.shape
    scratch = 4 * SA.fused_scratch_words(dtype, G, T, d)[0]
    monkeypatch.setattr(SA, "STREAM_FUSED_SCRATCH_BUDGET",
                        scratch - 1 if over else scratch)
    assert SA._fused_bwd_fits(dtype, G, T, d) == (not over)
    o, lse = SA.stream_fwd(qg, kg, vg, maskg, True)
    monkeypatch.setenv("DSTPU_STREAM_BWD", mode)
    calls = _spy_plain(monkeypatch)
    SA.reset_launch_counts()
    got = SA.stream_backward(qg, kg, vg, maskg, o, lse, dog, True)
    assert calls == (["stream_bwd_plain"] if want == "fused" else
                     ["stream_dkv_plain", "stream_dq_plain"])
    assert SA.LAUNCHES == dict.fromkeys(SA.LAUNCHES, 0)
    delta = (dog.float() * o.float()).sum(-1)[:, None, :]
    for a, b in zip(got, SA.stream_bwd_plain(qg, kg, vg, maskg, dog, lse,
                                             delta, True)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


# -------------------------------------------------------------------- gates

def test_stream_gate_matches_jax_within_the_kernels_head_dims():
    for T in (0, 128, 255, 256, 384, 512, 768, 1024, 1000):
        for d in (8, 12, 16, 32, 64, 96, 128):
            assert SA.stream_supported(T, d) == PA.stream_supported(T, d)
    assert SA.STREAM_TILE_MIN == PA.STREAM_TILE_MIN
    # the port's own gate: the kernels stage at most 128 of the head dim
    assert PA.stream_supported(512, 256) and not SA.stream_supported(512, 256)


def test_stream_bwd_mode_validation(monkeypatch):
    for mode in ("auto", "fused", "split"):
        monkeypatch.setenv("DSTPU_STREAM_BWD", mode)
        assert SA._stream_bwd_mode() == PA._stream_bwd_mode() == mode
    monkeypatch.delenv("DSTPU_STREAM_BWD")
    assert SA._stream_bwd_mode() == "auto"
    monkeypatch.setenv("DSTPU_STREAM_BWD", "twopass")
    with pytest.raises(ValueError, match="DSTPU_STREAM_BWD"):
        SA._stream_bwd_mode()


def test_attention_plan(monkeypatch):
    for name in ("DSTPU_FUSED_ATTN", "DSTPU_STREAM_ATTN_MIN",
                 "DSTPU_STREAM_ATTN_MIN_CAUSAL", "DSTPU_BLOCK_ATTN_MIN_CAUSAL"):
        monkeypatch.delenv(name, raising=False)
    for causal in (False, True):
        # seq 128: the whole-tile kernels for causal shapes (from the
        # measured BLOCK_AUTO_MIN_CAUSAL), the einsum path otherwise
        assert TL.attention_plan(128, 16, 64, causal) == (
            ("block", "block") if causal else ("xla", "xla"))
        for T in (256, 512, 1024):
            assert TL.attention_plan(T, 16, 64, causal) == ("stream",
                                                             "stream")
        assert TL.attention_plan(384, 16, 64, causal) == ("xla", "xla")
    monkeypatch.setenv("DSTPU_FUSED_ATTN", "0")
    assert TL.attention_plan(512, 16, 64, False) == ("xla", "xla")
    monkeypatch.setenv("DSTPU_FUSED_ATTN", "1")
    assert TL.attention_plan(512, 16, 64, False) == ("stream", "stream")
    # forced at seq 128 the JAX plan takes the whole-tile kernel, and so
    # does the port
    assert TL.attention_plan(128, 16, 64, False) == ("block", "block")
    # where the JAX plan would fall back to XLA, so does the port
    assert TL.attention_plan(1000, 16, 64, False) == ("xla", "xla")
    monkeypatch.setenv("DSTPU_FUSED_ATTN", "off")
    with pytest.raises(ValueError, match="DSTPU_FUSED_ATTN"):
        TL.attention_plan(512, 16, 64, False)


def test_core_attention_dispatch(monkeypatch):
    """auto takes the stream path from 256; "0" takes the einsum path; both
    compute the same function."""
    q, k, v, do, mask = inputs(256, 32, seed=11)
    calls = []
    real = SA.stream_fwd_plain
    monkeypatch.setattr(SA, "stream_fwd_plain",
                        lambda *a: calls.append(1) or real(*a))
    outs = {}
    for mode in ("auto", "0"):
        monkeypatch.setenv("DSTPU_FUSED_ATTN", mode)
        outs[mode] = TL.core_attention(
            *(torch.tensor(x) for x in (q, k, v)), causal=False,
            attn_mask=torch.tensor(mask)).numpy()
    assert len(calls) == 1
    np.testing.assert_allclose(outs["auto"], outs["0"], rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------- the BERT slice

VOCAB, SEQ, B, NPRED = 512, 256, 2, 12
TINY = dict(max_seq_len=SEQ, vocab_size=VOCAB, num_layers=2,
            hidden_size=128, num_heads=4)


def bert_batch(rows=B, seed=0):
    """Masked-positions batch with padded rows."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, VOCAB, size=(rows, SEQ)).astype(np.int32)
    mask = np.ones((rows, SEQ), np.int32)
    mask[0, SEQ - 37:] = 0
    if rows > 1:
        mask[rows - 1, SEQ // 2:] = 0
    tt = np.zeros((rows, SEQ), np.int32)
    tt[:, SEQ // 2:] = 1
    pos = np.stack([rng.choice(SEQ // 2, size=NPRED, replace=False)
                    for _ in range(rows)]).astype(np.int32)
    mlm_ids = rng.integers(0, VOCAB, size=(rows, NPRED)).astype(np.int32)
    w = np.ones((rows, NPRED), np.float32)
    w[0, NPRED - 2:] = 0.0
    return ids, mask, tt, pos, mlm_ids, w


def test_bert_seq256_stream_path_matches_jax(monkeypatch):
    monkeypatch.delenv("DSTPU_FUSED_ATTN", raising=False)
    jm = JBert.from_size("tiny", **TINY)
    params = jax.tree_util.tree_map(np.asarray,
                                    jm.init_params(jax.random.PRNGKey(0)))
    tm = TBert.from_size("tiny", remat=False, **TINY)
    weights.params_from_numpy(tm, params)
    batch = bert_batch()

    mesh = make_mesh(devices=jax.devices()[:1])
    specs = jm.partition_specs(params)
    fn = jax.jit(jax.shard_map(
        lambda p, *b: jax.value_and_grad(lambda q: jm.apply(q, *b))(p),
        mesh=mesh, in_specs=(specs,) + tuple(P() for _ in batch),
        out_specs=(P(), specs), check_vma=False))
    jl, jg = fn(params, *batch)
    jg = weights.flatten_tree(jax.tree_util.tree_map(np.asarray, jg))

    calls = []
    real = SA.stream_fwd_plain
    monkeypatch.setattr(SA, "stream_fwd_plain",
                        lambda *a: calls.append(1) or real(*a))
    loss = tm(*(torch.from_numpy(x) for x in batch))
    loss.backward()
    assert len(calls) == TINY["num_layers"]     # the stream path ran
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    tg = {k: p.grad.numpy() for k, p in tm.named_parameters()}
    assert tg.keys() == jg.keys()
    for k in jg:
        np.testing.assert_allclose(tg[k], jg[k], rtol=1e-4, atol=1e-5,
                                   err_msg=k)


def test_train_batch_seq256_runs_the_stream_path_on_the_cpu(monkeypatch):
    """Two ``train_batch`` steps (gas 2) of the port on the CPU: the stream
    path runs once per layer per micro-batch in each direction, through
    the plain versions (the backward as ``auto`` takes it at this shape:
    the fused kernel's or the split pair's), and no kernel launches."""
    monkeypatch.delenv("DSTPU_FUSED_ATTN", raising=False)
    monkeypatch.delenv("DSTPU_STREAM_BWD", raising=False)
    counts = {"fwd": 0, "bwd": 0, "dkv": 0, "dq": 0}

    def spy(key, fn):
        def wrapped(*a):
            counts[key] += 1
            return fn(*a)
        return wrapped

    monkeypatch.setattr(SA, "stream_fwd_plain",
                        spy("fwd", SA.stream_fwd_plain))
    monkeypatch.setattr(SA, "stream_bwd_plain",
                        spy("bwd", SA.stream_bwd_plain))
    monkeypatch.setattr(SA, "stream_dkv_plain",
                        spy("dkv", SA.stream_dkv_plain))
    monkeypatch.setattr(SA, "stream_dq_plain",
                        spy("dq", SA.stream_dq_plain))
    SA.reset_launch_counts()
    gas, steps = 2, 2
    cfg = {"train_batch_size": B * gas, "gradient_accumulation_steps": gas,
           "optimizer": {"type": "Lamb", "params": {
               "lr": 1e-3, "max_coeff": 0.5, "min_coeff": 0.08}},
           "activation_checkpointing": False, "steps_per_print": 10 ** 9}
    model = TBert.from_size("tiny", generator=torch.Generator().manual_seed(0),
                            **TINY)
    engine, _, _, _ = deepspeed_tpu_torch.initialize(
        config=cfg, model=model, device="cpu")
    losses = [float(engine.train_batch(bert_batch(B * gas, seed=s)))
              for s in range(steps)]
    want = TINY["num_layers"] * gas * steps
    heads = TINY["num_heads"]
    fused = SA._fused_bwd_fits(torch.float32, B * heads, SEQ,
                               TINY["hidden_size"] // heads)
    assert counts == {"fwd": want, "bwd": want if fused else 0,
                      "dkv": 0 if fused else want, "dq": 0 if fused else want}
    assert SA.LAUNCHES == dict.fromkeys(SA.LAUNCHES, 0)
    assert np.isfinite(losses).all()


# --------------------------------------------------------- the GPT-2 slice

GPT2_SEQ = 256


def _jax_stream_interpret(q, k, v, *, causal, attn_mask=None):
    """The JAX ``core_attention`` through the Pallas stream kernels in
    interpret mode (off the TPU the JAX plan takes the einsum path)."""
    B, T = q.shape[:2]
    mvec = (jnp.ones((B, T), jnp.float32) if attn_mask is None
            else attn_mask.astype(jnp.float32))
    return PA.stream_attention(q, k, v, mvec, causal, True)


@pytest.mark.parametrize("route", ["split", "fused"])
def test_gpt2_seq256_stream_path_matches_jax_split(monkeypatch, route):
    """A tiny causal GPT-2 at seq 256 on the port in ``auto``: with the
    budget at 0 the backward takes the split pair, with a budget that holds
    this shape's fused scratch the fused kernel (plain versions on the
    CPU); the JAX GPT-2 runs its attention through the Pallas stream
    kernels in interpret mode under ``DSTPU_STREAM_BWD=split``."""
    monkeypatch.delenv("DSTPU_FUSED_ATTN", raising=False)
    monkeypatch.setenv("DSTPU_STREAM_BWD", "split")
    monkeypatch.setattr(JL, "core_attention", _jax_stream_interpret)
    jm = JGPT2.from_size("tiny", remat=False, max_seq_len=GPT2_SEQ)
    params = jax.tree_util.tree_map(np.asarray,
                                    jm.init_params(jax.random.PRNGKey(0)))
    tm = TGPT2.from_size("tiny", remat=False, max_seq_len=GPT2_SEQ)
    weights.params_from_numpy(tm, params)
    rng = np.random.default_rng(2)
    toks = rng.integers(0, 512, size=(2, GPT2_SEQ)).astype(np.int32)
    labels = np.roll(toks, -1, axis=1)
    labels[:, -1] = -1
    labels[0, :9] = -1
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
    cfg = tm.config
    scratch = 4 * SA.fused_scratch_words(
        torch.float32, toks.shape[0] * cfg.num_heads, GPT2_SEQ,
        cfg.hidden_size // cfg.num_heads)[0]
    monkeypatch.setattr(SA, "STREAM_FUSED_SCRATCH_BUDGET",
                        0 if route == "split" else scratch)
    calls = _spy_plain(monkeypatch)
    SA.reset_launch_counts()
    loss = tm(*(torch.from_numpy(x) for x in batch))
    loss.backward()
    layers = tm.config.num_layers
    assert calls == (["stream_dkv_plain", "stream_dq_plain"] * layers
                     if route == "split" else ["stream_bwd_plain"] * layers)
    assert SA.LAUNCHES == dict.fromkeys(SA.LAUNCHES, 0)
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    tg = {k: p.grad.numpy() for k, p in tm.named_parameters()}
    assert tg.keys() == jg.keys() and len(tg) == 16
    for k in jg:
        np.testing.assert_allclose(tg[k], jg[k], rtol=1e-4, atol=1e-5,
                                   err_msg=k)
