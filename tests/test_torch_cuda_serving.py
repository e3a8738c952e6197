"""The serving path on the card against the CPU: the KV pool's row copies,
the serving attention, the GPT-2 serving methods, the int8 products and the
engine's fused decode, each on a CUDA tensor against the same function on
the CPU.  The serving path runs no hand-written kernel (the JAX package's
has no Pallas kernel there): every training kernel's launch count stays 0.
This file imports no JAX; without a card its tests skip.  On a machine
with one, from the repository root:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_serving.py
"""

import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.inference import (ContinuousScheduler,
                                           InferenceEngine,
                                           synthetic_requests)
from deepspeed_tpu_torch.inference import quant
from deepspeed_tpu_torch.models import GPT2
from deepspeed_tpu_torch.models import layers as L
from deepspeed_tpu_torch.ops import block_attention, cuda_optim
from deepspeed_tpu_torch.ops import stream_attention

pytestmark = pytest.mark.cuda

TINY = dict(vocab_size=128, max_seq_len=64, num_layers=2, hidden_size=64,
            num_heads=4, init_std=0.2)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the serving path on the card)")
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    for mod in (cuda_optim, stream_attention, block_attention):
        mod.reset_launch_counts()
    yield torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = prev
    for mod in (cuda_optim, stream_attention, block_attention):
        assert not any(mod.LAUNCHES.values()), mod.LAUNCHES


def _pair(*shape, dtype=torch.float32, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(*shape, generator=g).to(dtype)


def test_pool_rows_on_the_card(dev):
    R, n, d = 40, 4, 16
    pool = _pair(R + 1, n, d)
    new = _pair(2, 3, n, d, seed=1)
    rows = torch.tensor([[3, R, 7], [R, 39, R + 5]])     # >= R: dropped
    cpu, gpu = pool.clone(), pool.to(dev)
    L.scatter_kv_rows(cpu, new, rows)
    L.scatter_kv_rows(gpu, new.to(dev), rows.to(dev))
    assert torch.equal(gpu[:R].cpu(), cpu[:R])
    view = torch.tensor([[0, 3, 39, R], [7, 7, 1, 2]])
    assert torch.equal(L.gather_kv_rows(gpu, view.to(dev)).cpu()[:, :3],
                       L.gather_kv_rows(cpu, view)[:, :3])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ring", [False, True])
def test_serving_attention_on_the_card(dev, dtype, ring):
    B, cap, n, d, E = 3, 32, 4, 64, 5
    q, kc, vc = (_pair(*s, dtype=dtype, seed=i) for i, s in enumerate(
        ((B, n, d), (B, cap, n, d), (B, cap, n, d))))
    pos = torch.tensor([0, 17, 40 if ring else 31])
    tol = dict(atol=1e-5, rtol=1e-5) if dtype == torch.float32 else \
        dict(atol=2e-2, rtol=2e-2)
    got = L.cached_attention(q.to(dev), kc.to(dev), vc.to(dev), pos.to(dev),
                             ring=ring)
    torch.testing.assert_close(got.cpu().float(),
                               L.cached_attention(q, kc, vc, pos,
                                                  ring=ring).float(), **tol)
    qe = _pair(B, E, n, d, dtype=dtype, seed=9)
    start = torch.tensor([0, 9, 27])
    got = L.extend_attention(qe.to(dev), kc.to(dev), vc.to(dev),
                             start.to(dev))
    torch.testing.assert_close(got.cpu().float(),
                               L.extend_attention(qe, kc, vc,
                                                  start).float(), **tol)


def _params(seed=0):
    g = torch.Generator().manual_seed(seed)
    m = GPT2.from_size("tiny", generator=g, device="cpu", **TINY)
    from deepspeed_tpu_torch import weights
    return weights.unflatten_tree({k: p.detach()
                                   for k, p in m.named_parameters()})


@pytest.mark.parametrize("int8", [False, True])
def test_gpt2_serving_methods_on_the_card(dev, int8):
    tm = GPT2.from_size("tiny", device="meta", **TINY)
    p = _params()
    if int8:
        p = quant.quantize_tree(p, torch.float32)
    to = (lambda t: t.to(dev))
    pd = {k: ({kk: ({"q": to(x["q"]), "s": to(x["s"])}
                    if isinstance(x, dict) else to(x))
               for kk, x in v.items()} if k == "blocks"
              else ({"q": to(v["q"]), "s": to(v["s"])}
                    if isinstance(v, dict) else to(v)))
          for k, v in p.items()}
    Lyr, n, d = tm.kv_cache_dims()
    B, cap, E = 2, 16, 8
    R = B * cap
    k0 = torch.zeros(Lyr, R + 1, n, d)
    rows = torch.arange(R, dtype=torch.int32).reshape(B, cap)
    toks = torch.randint(0, 128, (B, E), generator=torch.Generator()
                         .manual_seed(2))
    pos, n_new = torch.tensor([0, 3]), torch.tensor([5, 8])
    kc, vc = k0.clone(), k0.clone()
    kg, vg = k0.clone().to(dev), k0.clone().to(dev)
    lc, _, _ = tm.apply_extend(p, toks, kc, vc, pos, n_new, rows)
    lg, _, _ = tm.apply_extend(pd, toks.to(dev), kg, vg, pos.to(dev),
                               n_new.to(dev), rows.to(dev))
    for b in range(B):
        torch.testing.assert_close(lg[b, :n_new[b]].cpu(),
                                   lc[b, :n_new[b]], atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(kg[:, :R].cpu(), kc[:, :R], atol=1e-5,
                               rtol=1e-5)
    dtok, dpos = torch.tensor([7, 9]), torch.tensor([5, 11])
    active = torch.tensor([True, False])
    lc2, _, _, pc = tm.apply_decode(p, dtok, kc, vc, dpos, active, rows)
    lg2, _, _, pg = tm.apply_decode(pd, dtok.to(dev), kg, vg, dpos.to(dev),
                                    active.to(dev), rows.to(dev))
    torch.testing.assert_close(lg2[0].cpu(), lc2[0], atol=1e-4, rtol=1e-4)
    assert torch.equal(pg.cpu(), pc)
    torch.testing.assert_close(vg[:, :R].cpu(), vc[:, :R], atol=1e-5,
                               rtol=1e-5)


def test_fused_decode_on_the_card_matches_serial(dev):
    """D 4 fused decode against one dispatch per token, on the card: the
    same per-row arithmetic, so the tokens are equal exactly."""
    def run(**inf):
        cfg = {"inference": {"max_slots": 3, "max_tokens": 32,
                             "prefill_bucket": 16, "page_tokens": 8,
                             "dtype": "bfloat16", **inf}}
        eng = InferenceEngine(GPT2.from_size("tiny", device="meta", **TINY),
                              config=cfg, params=_params(), device=dev)
        reqs = synthetic_requests(8, vocab=128, seed=4, prompt_min=2,
                                  prompt_max=14, new_min=2, new_max=12)
        return {r.rid: r.tokens
                for r in ContinuousScheduler(eng).run(reqs)}

    serial = run()
    assert run(decode_iters_per_dispatch=4) == serial
    assert len(set(tuple(v) for v in serial.values())) > 4
    np.testing.assert_equal(sorted(serial), list(range(8)))


def test_fused_blocks_take_no_host_sync(dev):
    """The D decode iterations and the speculative step run on the device
    with no host sync between them (``set_sync_debug_mode("error")`` raises
    on one); the tokens come back once, after the block."""
    p = _params()
    dparams = dict(p, blocks={k: v[:1] for k, v in p["blocks"].items()})
    cfg = {"inference": {"max_slots": 3, "max_tokens": 32,
                         "prefill_bucket": 16, "page_tokens": 8,
                         "dtype": "bfloat16",
                         "speculative": {"draft_tokens": 2}}}
    eng = InferenceEngine(GPT2.from_size("tiny", device="meta", **TINY),
                          config=cfg, params=p, device=dev,
                          draft_model=GPT2.from_size(
                              "tiny", device="meta", **dict(TINY,
                                                            num_layers=1)),
                          draft_params=dparams)
    for slot, prompt in enumerate(([1, 2, 3], [4, 5], [6, 7, 8, 9])):
        eng.prefill(slot, prompt)
    n = eng.num_slots
    args = (eng._rows(), torch.arange(n, dtype=torch.int32, device=dev),
            torch.ones(n, dtype=torch.bool, device=dev),
            torch.full((n,), -1, dtype=torch.int32, device=dev),
            torch.full((n,), 8, dtype=torch.int32, device=dev))
    torch.cuda.synchronize(dev)
    torch.cuda.set_sync_debug_mode("error")
    try:
        toks, emitted = eng._decode_block(3, *args)
        stoks, semitted = eng._spec_block(*args)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert tuple(toks.shape) == (3, n) and bool(emitted.all())
    assert tuple(stoks.shape) == (3, n) and bool(semitted[0].all())


@pytest.mark.parametrize("mode", ["paged", "ring", "int8", "speculative"])
def test_cuda_graphs_match_eager(dev, mode, monkeypatch):
    """The programs captured as CUDA graphs against the same programs run
    eagerly (``DSTPU_SERVE_GRAPHS=0``): the same tokens, and the decode
    logits within bf16 rounding."""
    inf = {"max_slots": 3, "max_tokens": 32, "prefill_bucket": 16,
           "page_tokens": 8, "dtype": "bfloat16"}
    kw = {}
    p = _params()
    if mode == "ring":
        inf.update(kv_layout="ring", max_tokens=16)
    if mode == "int8":
        inf["quantize"] = "int8"
    if mode == "speculative":
        inf["speculative"] = {"draft_tokens": 2}
        kw = dict(draft_model=GPT2.from_size("tiny", device="meta",
                                             **dict(TINY, num_layers=1)),
                  draft_params=dict(p, blocks={k: v[:1] for k, v in
                                               p["blocks"].items()}))

    def run(graphs):
        monkeypatch.setenv("DSTPU_SERVE_GRAPHS", graphs)
        eng = InferenceEngine(GPT2.from_size("tiny", device="meta", **TINY),
                              config={"inference": inf}, params=p,
                              device=dev, **kw)
        assert (eng._graphs is None) == (graphs == "0")
        reqs = synthetic_requests(6, vocab=128, seed=8, prompt_min=2,
                                  prompt_max=12, new_min=2, new_max=14)
        toks = {r.rid: r.tokens for r in ContinuousScheduler(eng).run(reqs)}
        eng.reset()
        eng.prefill(0, [3, 4, 5])
        feed = np.zeros(eng.num_slots, np.int32)
        act = np.zeros(eng.num_slots, bool)
        act[0] = True
        return toks, eng.decode(feed, act)[0], eng

    toks, logits, eng = run("1")
    assert eng._graphs                      # the programs were captured
    toks0, logits0, _ = run("0")
    assert toks == toks0
    np.testing.assert_allclose(logits, logits0, rtol=2e-2, atol=2e-2)
