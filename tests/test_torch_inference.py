"""Single-replica serving on the port against the JAX package, on the CPU.

The port (``deepspeed_tpu_torch.inference``, the GPT-2 serving methods and
the layer functions they run) is held against ``deepspeed_tpu.inference``
in fp32 at the JAX tests' tiny GPT-2 (2 layers, hidden 64, 4 heads, vocab
128), from the same numpy-seeded inputs and the same JAX-init weights
passed to both engines as numpy.  The weights are drawn with ``init_std``
0.2 so that greedy decoding does not repeat the prompt's last token.

* the layer functions (gather/scatter with drop rows, cached and extend
  attention with the ring wrap, the decode and extend attention steps,
  the int8 products in both forms) and ``GPT2.apply_extend`` /
  ``apply_decode``: logits and both pools at ``atol=1e-5``;
* the engine: prefill logits at ``atol=1e-4``, the decode oracle, and
  greedy tokens identical to the JAX engine's on a 12-request trace under
  continuous and static batching, fused decode (D 4), prefix reuse, the
  ring layout, int8 and speculative decoding (J 2, a 1-layer draft: the
  target's first layer); the
  bf16 oracle at the JAX test's relative 0.05;
* cold starts from a JAX ZeRO-1 training checkpoint and from a port
  checkpoint, each served by both packages with identical tokens, and the
  ZeRO partition files never opened;
* the refusals: mp 2, ``export_kv``, ``plan_capacity`` and graph lint.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.inference import (ContinuousScheduler as JScheduler,
                                     InferenceEngine as JEngine,
                                     StaticScheduler as JStatic,
                                     synthetic_requests as jsynthetic)
from deepspeed_tpu.models import layers as JL
from deepspeed_tpu.models.gpt2 import GPT2 as JGPT2
from deepspeed_tpu.parallel.topology import make_mesh
from deepspeed_tpu_torch import checkpoint, weights
from deepspeed_tpu_torch.inference import (ContinuousScheduler,
                                           InferenceEngine, Request,
                                           StaticScheduler,
                                           synthetic_requests)
from deepspeed_tpu_torch.models import GPT2
from deepspeed_tpu_torch.models import layers as L

TINY = dict(vocab_size=128, max_seq_len=64, num_layers=2, hidden_size=64,
            num_heads=4, init_std=0.2)
#: the speculative draft: the target's first layer with its embeddings (as
#: the card's phase drafts GPT-2 medium by its first 12 of 24 layers)
DRAFT = dict(TINY, num_layers=1)


def jtiny(**over):
    return JGPT2.from_size("tiny", **{**TINY, **over})


def ttiny(**over):
    return GPT2.from_size("tiny", device="meta", **{**TINY, **over})


def np_params(model, seed):
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x, np.float32),
        model.init_params(jax.random.PRNGKey(seed)))


@pytest.fixture(scope="module")
def params():
    return np_params(jtiny(), 0)


@pytest.fixture(scope="module")
def draft_params(params):
    return {**params, "blocks": {k: v[:1] for k, v in
                                 params["blocks"].items()}}


def serve_config(**inf):
    base = {"max_slots": 3, "max_tokens": 32, "prefill_bucket": 16,
            "page_tokens": 8, "dtype": "float32"}
    base.update(inf)
    return {"train_micro_batch_size_per_gpu": 1, "inference": base}


def engines(params, cfg, draft_params=None):
    """(JAX engine, port engine) on the same weights and config."""
    kw = {}
    if draft_params is not None:
        kw = dict(draft_model=jtiny(**DRAFT), draft_params=draft_params)
    je = JEngine(jtiny(), config=cfg, params=params, **kw)
    if draft_params is not None:
        kw = dict(draft_model=ttiny(**DRAFT), draft_params=draft_params)
    te = InferenceEngine(ttiny(), config=cfg, params=params, device="cpu",
                         **kw)
    return je, te


def trace(n=12, seed=7, **kw):
    """The same synthetic trace for both packages (the port's copy of the
    generator must draw the JAX one's numbers)."""
    spec = {**dict(vocab=TINY["vocab_size"], seed=seed, prompt_min=2,
                   prompt_max=14, new_min=2, new_max=12), **kw}
    mine = synthetic_requests(n, **spec)
    theirs = jsynthetic(n, **spec)
    assert [(r.prompt, r.max_new_tokens) for r in mine] == \
        [(r.prompt, r.max_new_tokens) for r in theirs]
    return mine, theirs


def tokens(results):
    return {r.rid: list(r.tokens) for r in results}


def _jax_call(fn, *args):
    """A JAX layer / model function under ``shard_map`` on a one-device
    mesh (its psums and axis index need the model axis bound)."""
    mesh = make_mesh(devices=jax.devices()[:1])
    flat, tree = jax.tree_util.tree_flatten(args)
    wrapped = jax.shard_map(
        lambda *a: fn(*jax.tree_util.tree_unflatten(tree, a)), mesh=mesh,
        in_specs=tuple(P() for _ in flat), out_specs=P(), check_vma=False)
    out = jax.jit(wrapped)(*flat)
    return jax.tree_util.tree_map(lambda x: np.asarray(x), out)


def _t(x):
    return torch.tensor(np.asarray(x))


def _with_drop(pool):
    """A JAX pool [..., R, n, d] as the port's, with the drop row."""
    pad = np.zeros(pool.shape[:-3] + (1,) + pool.shape[-2:], pool.dtype)
    return torch.tensor(np.concatenate([pool, pad], axis=-3))


# ================================================================ layers

def test_gather_scatter_drop_rows():
    rng = np.random.default_rng(0)
    R, n, d = 24, 2, 4
    pool = rng.standard_normal((R, n, d)).astype(np.float32)
    new = rng.standard_normal((2, 3, n, d)).astype(np.float32)
    rows = np.array([[3, R, 7], [R, 20, R]], np.int32)     # R: dropped
    want = np.asarray(JL.scatter_kv_rows(jnp.asarray(pool), new, rows))
    mine = _with_drop(pool)
    out = L.scatter_kv_rows(mine, _t(new), _t(rows))
    assert out.data_ptr() == mine.data_ptr()            # written in place
    np.testing.assert_array_equal(mine[:R].numpy(), want)
    view_rows = np.array([[0, 3, 7, 20], [20, 7, 3, 0]], np.int32)
    np.testing.assert_array_equal(
        L.gather_kv_rows(mine, _t(view_rows)).numpy(),
        np.asarray(JL.gather_kv_rows(jnp.asarray(want), view_rows)))


@pytest.mark.parametrize("ring", [False, True])
def test_cached_and_extend_attention(ring):
    rng = np.random.default_rng(1)
    B, cap, n, d, E = 3, 16, 2, 8, 4
    q = rng.standard_normal((B, n, d)).astype(np.float32)
    kc, vc = (rng.standard_normal((B, cap, n, d)).astype(np.float32)
              for _ in range(2))
    pos = np.array([0, 9, 21 if ring else 15], np.int32)   # 21: wrapped
    np.testing.assert_allclose(
        L.cached_attention(_t(q), _t(kc), _t(vc), _t(pos), ring=ring),
        np.asarray(JL.cached_attention(q, kc, vc, pos, ring=ring)),
        atol=1e-5)
    qe = rng.standard_normal((B, E, n, d)).astype(np.float32)
    start = np.array([0, 5, 12], np.int32)
    np.testing.assert_allclose(
        L.extend_attention(_t(qe), _t(kc), _t(vc), _t(start)),
        np.asarray(JL.extend_attention(qe, kc, vc, start)), atol=1e-5)


def _attn_weights(rng, h):
    return [rng.standard_normal(s).astype(np.float32) * 0.3
            for s in ((h, 3 * h), (3 * h,), (h, h), (h,))]


@pytest.mark.parametrize("ring", [False, True])
def test_decode_multihead_attention_pools(ring):
    rng = np.random.default_rng(2)
    B, cap, nh, h, R = 3, 16, 4, 32, 48
    w = _attn_weights(rng, h)
    x = rng.standard_normal((B, 1, h)).astype(np.float32)
    kp, vp = (rng.standard_normal((R, nh, h // nh)).astype(np.float32)
              for _ in range(2))
    rows = np.stack([np.arange(cap) + s * cap for s in range(B)]).astype(
        np.int32)
    pos = np.array([3, 17 if ring else 15, 0], np.int32)
    write = np.array([rows[0, 3], rows[1, (pos[1] % cap)], R], np.int32)
    want = _jax_call(lambda *a: JL.decode_multihead_attention(
        *a, n_heads_global=nh, ring=ring), x, *w, kp, vp, pos, rows, write)
    kt, vt = _with_drop(kp), _with_drop(vp)
    out, k2, v2 = L.decode_multihead_attention(
        _t(x), *map(_t, w), kt, vt, _t(pos), _t(rows), _t(write),
        n_heads=nh, ring=ring)
    assert k2 is kt and v2 is vt
    np.testing.assert_allclose(out.numpy(), want[0], atol=1e-5)
    np.testing.assert_allclose(kt[:R].numpy(), want[1], atol=1e-5)
    np.testing.assert_allclose(vt[:R].numpy(), want[2], atol=1e-5)


def test_extend_multihead_attention_pools():
    rng = np.random.default_rng(3)
    B, cap, nh, h, E = 2, 16, 4, 32, 6
    R = B * cap
    w = _attn_weights(rng, h)
    x = rng.standard_normal((B, E, h)).astype(np.float32)
    kp, vp = (rng.standard_normal((R, nh, h // nh)).astype(np.float32)
              for _ in range(2))
    rows = np.stack([np.arange(cap) + s * cap for s in range(B)]).astype(
        np.int32)
    rows[1, 12:] = R                     # past slot 1's allocation: dropped
    start = np.array([2, 9], np.int32)
    n_new = np.array([4, 6], np.int32)   # slot 0's last two are pads
    want = _jax_call(lambda *a: JL.extend_multihead_attention(
        *a, n_heads_global=nh), x, *w, kp, vp, rows, start, n_new)
    kt, vt = _with_drop(kp), _with_drop(vp)
    out, _, _ = L.extend_multihead_attention(
        _t(x), *map(_t, w), kt, vt, _t(rows), _t(start), _t(n_new),
        n_heads=nh)
    # real positions only: pads' outputs are garbage in both packages
    for b in range(B):
        m = int(n_new[b]) if b == 0 else 3          # slot 1: rows < 12
        np.testing.assert_allclose(out[b, :m].numpy(), want[0][b, :m],
                                   atol=1e-5)
    np.testing.assert_allclose(kt[:R].numpy(), want[1], atol=1e-5)
    np.testing.assert_allclose(vt[:R].numpy(), want[2], atol=1e-5)


@pytest.mark.parametrize("plan", ["scaled", "dequant"])
def test_int8_products_both_forms(plan, monkeypatch):
    from deepspeed_tpu.inference import quant as jquant
    from deepspeed_tpu_torch.inference import quant
    monkeypatch.setenv("DSTPU_QUANT_MATMUL", plan)
    rng = np.random.default_rng(4)
    w = rng.standard_normal((16, 24)).astype(np.float32)
    wte = rng.standard_normal((32, 16)).astype(np.float32)
    b = rng.standard_normal((24,)).astype(np.float32)
    x = rng.standard_normal((3, 16)).astype(np.float32)
    jq = jquant.quantize_leaf(w, 0, jnp.float32)
    tq = quant.quantize_leaf(w, 0, torch.float32)
    np.testing.assert_array_equal(tq["q"].numpy(), jq["q"])
    np.testing.assert_array_equal(tq["s"].numpy(), np.asarray(jq["s"]))
    jte = jquant.quantize_leaf(wte, 1, jnp.float32)
    tte = quant.quantize_leaf(wte, 1, torch.float32)
    toks = np.array([[0, 5, 31]], np.int32)
    want = _jax_call(lambda x_, w_, b_, e_, t_: (
        JL.column_parallel_linear(x_, w_, b_),
        JL.row_parallel_linear(x_, w_, b_),
        JL.vocab_parallel_embedding(t_, e_),
        JL.vocab_parallel_logits(x_, e_)), x, jq, b, jte, toks)
    got = (L.column_parallel_linear(_t(x), tq, _t(b)),
           L.row_parallel_linear(_t(x), tq, _t(b)),
           L.vocab_parallel_embedding(_t(toks), tte),
           L.vocab_parallel_logits(_t(x), tte))
    for g, wv in zip(got, want):
        np.testing.assert_allclose(g.numpy(), wv, atol=1e-5)
    monkeypatch.setenv("DSTPU_QUANT_MATMUL", "fast")
    with pytest.raises(ValueError, match="DSTPU_QUANT_MATMUL"):
        L.quant_matmul_plan()


# ================================================================= model

@pytest.mark.parametrize("ring", [False, True])
def test_gpt2_extend_and_decode_match_jax(params, ring):
    """``apply_extend`` then ``apply_decode`` on the port against the JAX
    model: logits and both pools at 1e-5, pads and inactive slots
    included (their writes dropped)."""
    jm, tm = jtiny(), ttiny()
    Lyr, n, d = jm.kv_cache_dims()
    assert tm.kv_cache_dims() == (Lyr, n, d)
    B, cap, E = 2, 16, 8
    R = B * cap
    rng = np.random.default_rng(5)
    k0 = np.zeros((Lyr, R, n, d), np.float32)
    rows = np.stack([np.arange(cap) + s * cap for s in range(B)]).astype(
        np.int32)
    toks = rng.integers(0, 128, (B, E)).astype(np.int32)
    pos = np.array([0, 3], np.int32)
    n_new = np.array([5, 8], np.int32)
    jl, jk, jv = _jax_call(lambda p, *a: jm.apply_extend(p, *a), params,
                           toks, k0, k0, pos, n_new, rows)
    tp = jax.tree_util.tree_map(torch.tensor, params)
    kt, vt = _with_drop(k0), _with_drop(k0)
    tl, _, _ = tm.apply_extend(tp, _t(toks), kt, vt, _t(pos), _t(n_new),
                               _t(rows))
    for b in range(B):
        np.testing.assert_allclose(tl[b, :n_new[b]].numpy(),
                                   jl[b, :n_new[b]], atol=1e-5)
    np.testing.assert_allclose(kt[:, :R].numpy(), jk, atol=1e-5)
    np.testing.assert_allclose(vt[:, :R].numpy(), jv, atol=1e-5)
    # decode: slot 0 at position 5 (or, in the ring, 21: wrapped), slot 1
    # inactive
    dpos = np.array([21 if ring else 5, 11], np.int32)
    dtok = np.array([7, 9], np.int32)
    active = np.array([True, False])
    jl2, jk2, jv2, jpos = _jax_call(
        lambda p, *a: jm.apply_decode(p, *a, ring=ring), params, dtok, jk,
        jv, dpos, active, rows)
    tl2, _, _, tpos = tm.apply_decode(tp, _t(dtok), kt, vt, _t(dpos),
                                      _t(active), _t(rows), ring=ring)
    np.testing.assert_allclose(tl2[0].numpy(), jl2[0], atol=1e-5)
    np.testing.assert_array_equal(tpos.numpy(), jpos)
    np.testing.assert_allclose(kt[:, :R].numpy(), jk2, atol=1e-5)
    np.testing.assert_allclose(vt[:, :R].numpy(), jv2, atol=1e-5)


# ================================================================ engine

@pytest.fixture(scope="module")
def pair(params):
    return engines(params, serve_config())


def test_prefill_logits_match_jax(pair):
    je, te = pair
    for prompt in ([1, 2, 3, 4, 5], list(range(40, 56))):
        je.reset()
        te.reset()
        np.testing.assert_allclose(te.prefill(0, prompt),
                                   je.prefill(0, prompt), atol=1e-4)
    je.reset()
    te.reset()


def _oracle(eng, prompt, steps, atol=None, rel=None):
    """Incremental decode against a full-context re-forward, step by step
    (the JAX ``tests/test_inference.py`` oracle)."""
    eng.reset()
    logits = eng.prefill(0, prompt)
    seq = list(prompt)
    cur = int(np.argmax(logits))
    for _ in range(steps):
        seq.append(cur)
        ref = eng.prefill(1, seq)            # full re-forward, other slot
        feed = np.zeros(eng.num_slots, np.int32)
        feed[0] = cur
        act = np.zeros(eng.num_slots, bool)
        act[0] = True
        dec = eng.decode(feed, act)[0]
        assert int(np.argmax(dec)) == int(np.argmax(ref))
        if atol is not None:
            np.testing.assert_allclose(dec, ref, atol=atol)
        if rel is not None:
            scale = np.max(np.abs(ref)) + 1e-9
            assert np.max(np.abs(dec - ref)) / scale < rel
        cur = int(np.argmax(dec))
    eng.reset()


def test_decode_oracle_fp32(pair):
    _oracle(pair[1], [1, 2, 3, 4, 5], steps=6, atol=1e-4)


def test_decode_oracle_bf16(params):
    eng = InferenceEngine(ttiny(), config=serve_config(dtype="bfloat16"),
                          params=params, device="cpu")
    assert eng.params["blocks"]["qkv_w"].dtype == torch.bfloat16
    _oracle(eng, [5, 6, 7, 8], steps=3, rel=0.05)


def _both(je, te, reqs, sched="continuous"):
    mine, theirs = reqs
    je.reset()
    te.reset()
    if sched == "static":
        j, t = JStatic(je), StaticScheduler(te)
    else:
        j, t = JScheduler(je), ContinuousScheduler(te)
    jr, tr = j.run(list(theirs)), t.run(list(mine))
    je.reset()
    te.reset()
    return tokens(jr), tokens(tr), j, t


@pytest.mark.parametrize("sched", ["continuous", "static"])
def test_greedy_tokens_match_jax(pair, sched):
    jt, tt, j, t = _both(*pair, trace(), sched=sched)
    assert tt == jt
    assert len(set(tuple(v) for v in tt.values())) > 6    # not degenerate
    assert t.decode_iters == j.decode_iters


def _shared_prefix_trace():
    """12 requests, most opening with one of two 16-token prefixes (two
    pages at page_tokens 8), so admissions hit the prefix index."""
    rng = np.random.default_rng(11)
    heads = [list(range(1, 17)), list(range(60, 76))]
    reqs = []
    for i in range(12):
        tail = rng.integers(0, 128, int(rng.integers(1, 6))).tolist()
        prompt = (heads[i % 2] + tail) if i % 3 else tail + [5]
        reqs.append((prompt, int(rng.integers(2, 9))))
    from deepspeed_tpu.inference import Request as JRequest
    return ([Request(rid=i, prompt=p, max_new_tokens=m)
             for i, (p, m) in enumerate(reqs)],
            [JRequest(rid=i, prompt=p, max_new_tokens=m)
             for i, (p, m) in enumerate(reqs)])


MODES = {
    "fused_d4": (dict(decode_iters_per_dispatch=4), trace),
    "prefix_reuse": (dict(prefill_bucket=24, max_slots=2),
                     _shared_prefix_trace),
    "ring": (dict(kv_layout="ring", max_tokens=16, prefill_bucket=16,
                  max_slots=2),
             lambda: trace(prompt_max=12, new_min=8, new_max=14)),
    "int8": (dict(quantize="int8"), trace),
    "speculative": (dict(speculative={"draft_tokens": 2}), trace),
}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_greedy_tokens_match_jax_by_mode(params, draft_params, pair, mode):
    inf, make = MODES[mode]
    je, te = engines(params, serve_config(**inf),
                     draft_params if mode == "speculative" else None)
    reqs = make()
    jt, tt, j, t = _both(je, te, reqs)
    assert tt == jt
    for attr in ("decode_iters", "prefix_hits", "prefix_tokens_reused",
                 "admission_refusals", "spec_proposed", "spec_accepted"):
        assert getattr(t, attr) == getattr(j, attr), attr
    if mode == "prefix_reuse":
        assert t.prefix_hits > 0
        assert te.pool.gauges() == je.pool.gauges()
    if mode == "ring":
        assert max(len(p) + m for p, m in (
            (r.prompt, r.max_new_tokens) for r in reqs[0])) > 16   # wraps
    if mode == "speculative":
        assert t.spec_accepted > 0
    if mode == "int8":
        assert te.params["blocks"]["qkv_w"]["q"].dtype == torch.int8
        assert te.weight_bytes == je.weight_bytes
    if mode in ("fused_d4", "speculative"):
        # exact by construction: plain continuous decoding's tokens
        assert tt == _both(*pair, reqs)[1]


def test_int8_within_tolerance(pair, params):
    _, te = pair
    tq = InferenceEngine(ttiny(), config=serve_config(quantize="int8"),
                         params=params, device="cpu")
    prompt = [1, 2, 3, 4, 5]
    lf, lq = te.prefill(0, prompt), tq.prefill(0, prompt)
    te.reset()
    assert np.max(np.abs(lq - lf)) / (np.max(np.abs(lf)) + 1e-9) < 0.05
    assert tq.weight_bytes < te.weight_bytes / 2
    os.environ["DSTPU_QUANT_MATMUL"] = "dequant"
    try:
        ld = tq.prefill(0, prompt)
    finally:
        del os.environ["DSTPU_QUANT_MATMUL"]
    np.testing.assert_allclose(lq, ld, atol=1e-4)


# ============================================================ cold start

def _spy_opened(monkeypatch, module):
    opened = []
    orig = module._load_obj

    def spy(path):
        opened.append(os.path.basename(path))
        return orig(path)

    monkeypatch.setattr(module, "_load_obj", spy)
    return opened


def test_cold_start_from_either_package(tmp_path, params, monkeypatch):
    """A JAX ZeRO-1 training checkpoint and a port checkpoint, each served
    by both packages: identical tokens; the port's weights-only read never
    opens a ZeRO partition file."""
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    jm = jtiny()
    jeng, _, _, _ = deepspeed_tpu.initialize(
        model=jm, config={"train_micro_batch_size_per_gpu": 1,
                          "optimizer": {"type": "Adam",
                                        "params": {"lr": 1e-3}},
                          "bf16": {"enabled": True},
                          "zero_optimization": {"stage": 1}},
        model_parameters=jax.tree_util.tree_map(jnp.asarray, params))
    toks = np.random.default_rng(0).integers(0, 128, (8, 16)).astype(
        np.int32)
    jeng.train_batch((toks, toks.copy()))
    jeng.save_checkpoint(str(jdir))
    assert any(f.startswith("zero_pp_rank") for f in
               os.listdir(jdir / "global_step1"))
    tm = GPT2.from_size("tiny", device="cpu", **TINY)
    weights.params_from_numpy(tm, params)
    teng, _, _, _ = deepspeed_tpu_torch.initialize(
        model=tm, config={"train_micro_batch_size_per_gpu": 8,
                          "optimizer": {"type": "Adam",
                                        "params": {"lr": 1e-3}}},
        device="cpu")
    teng.train_batch((torch.tensor(toks).long(), torch.tensor(toks).long()))
    teng.save_checkpoint(str(tdir))
    reqs = trace(n=4, seed=3)
    cfg = serve_config()
    for ck in (jdir, tdir):
        opened = _spy_opened(monkeypatch, checkpoint)
        te = InferenceEngine(ttiny(), config=cfg, checkpoint_dir=str(ck),
                             device="cpu")
        assert not any(p.startswith("zero_pp_rank") for p in opened)
        je = JEngine(jtiny(), config=cfg, checkpoint_dir=str(ck))
        assert te.loaded_tag == je.loaded_tag == "global_step1"
        assert te.restore_seconds > 0
        jt, tt, _, _ = _both(je, te, reqs)
        assert tt == jt
        ev = te.startup_event()
        from deepspeed_tpu_torch.observability import schema
        assert schema.validate_any(ev) is None


# ============================================================== refusals

@pytest.mark.parametrize("what,item", [
    ("mp2", "item 13b"), ("export_kv", "item 13b"),
    ("import_kv", "item 13b"), ("plan_capacity", "item 14"),
    ("graph_lint", "item 14"), ("analysis", "item 14"),
    ("run_graph_lint", "item 14"), ("plan_dispatch", "item 14"),
    ("run_stability", "item 14"), ("predict_executables", "item 14"),
    ("handoff", "item 13b"), ("router", "item 13b")])
def test_refusals_name_their_item(pair, what, item):
    cfg = serve_config()
    from deepspeed_tpu_torch import inference
    calls = {
        "mp2": lambda: InferenceEngine(
            ttiny(), config={**cfg, "model_parallel_size": 2},
            device="cpu"),
        "graph_lint": lambda: InferenceEngine(
            ttiny(), config={**cfg, "graph_lint": "error"}, device="cpu"),
        "analysis": lambda: InferenceEngine(
            ttiny(), config={**cfg, "analysis": {"mode": "warn"}},
            device="cpu"),
        "export_kv": lambda: pair[1].export_kv(0),
        "import_kv": lambda: pair[1].import_kv(0, [1], None, None, 1),
        "handoff": lambda: inference.KVHandoff(),
        "router": lambda: inference.FleetRouter,
    }
    call = calls.get(what, lambda: getattr(pair[1], what)())
    with pytest.raises(NotImplementedError, match=f"Queue 1 {item}"):
        call()


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        InferenceEngine(ttiny(), config=serve_config())
