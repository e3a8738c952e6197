"""The port's KV page pool against the JAX package's, on the CPU.

``deepspeed_tpu_torch.inference.kvcache`` is pure host bookkeeping: the
same operation sequences as the JAX ``tests/test_prefix_spec.py`` (chained
hashes, refcounts on evict, the LRU of parked pages and its reclaim,
admission refusal, sub-page and page-aligned prompts, the ring's
copy-on-write) must leave page tables, refcounts, row maps and gauges equal
to the JAX ``PagePool``'s after every step, and ``cache_bytes`` /
``plan_slots`` must agree.  The engine-level cases (the prefix index
cleared by ``reset``, copy-on-write on a ring wrap of a shared page, the
refused admission that queues) run the port's engine against the JAX
engine on the same weights; a reused page's bytes equal a fresh prefill's
bitwise.
"""

import numpy as np
import pytest
import torch

import jax

from deepspeed_tpu.inference import (ContinuousScheduler as JScheduler,
                                     InferenceEngine as JEngine,
                                     Request as JRequest)
from deepspeed_tpu.inference import kvcache as jkv
from deepspeed_tpu.models.gpt2 import GPT2 as JGPT2
from deepspeed_tpu_torch.inference import (ContinuousScheduler,
                                           InferenceEngine, Request)
from deepspeed_tpu_torch.inference import kvcache as tkv
from deepspeed_tpu_torch.models import GPT2

TINY = dict(vocab_size=128, max_seq_len=64, num_layers=2, hidden_size=64,
            num_heads=4, init_std=0.2)


def specs(slots=3, capacity=32, pt=8, pool_pages=0, layout="paged"):
    kw = dict(layers=2, slots=slots, capacity=capacity, kv_heads_local=4,
              head_dim=16, layout=layout, page_tokens=pt,
              pool_pages=pool_pages)
    return (jkv.KVCacheSpec(dtype=np.float32, **kw),
            tkv.KVCacheSpec(dtype=torch.float32, **kw))


class Both:
    """The same calls on a JAX and a port ``PagePool``; after each, their
    state must agree."""

    def __init__(self, **kw):
        js, ts = specs(**kw)
        self.j, self.t = jkv.PagePool(js), tkv.PagePool(ts)

    def check(self):
        j, t = self.j, self.t
        np.testing.assert_array_equal(t._table, j._table)
        np.testing.assert_array_equal(t._ref, j._ref)
        np.testing.assert_array_equal(t.rows(), j.rows())
        assert t.gauges() == j.gauges()
        assert t._alloc == j._alloc and t._shared == j._shared
        assert list(t._lru) == list(j._lru)
        assert t._free == j._free

    def __getattr__(self, name):
        def call(*args, **kwargs):
            a = getattr(self.j, name)(*args, **kwargs)
            b = getattr(self.t, name)(*args, **kwargs)
            if hasattr(a, "slot"):          # an AdmitGrant
                assert vars(a) == vars(b)
            elif isinstance(a, list):
                assert a == b
            self.check()
            return b
        return call


def test_pool_refcounts_lru_and_chained_hashes():
    pool = Both()
    prompt = list(range(17))                       # 2 full pages + tail
    g0 = pool.admit(0, prompt, 4)
    pool.publish(g0)
    g1 = pool.admit(1, prompt, 4)                  # hits both full pages
    assert g1.reused_pages == 2 and g1.reused_tokens == 16
    pool.release(0)
    pool.release(1)                                # parked on the LRU
    g2 = pool.admit(2, prompt, 4)                  # revived from the LRU
    assert g2.reused_pages == 2
    pool.release(2)
    pool.reset()
    # sub-page prefixes never hit; a page-aligned prompt reuses all but
    # its last page; the chain stops at the first diverging page
    g0 = pool.admit(0, list(range(24)), 4)
    pool.publish(g0)
    assert pool.admit(1, list(range(7)), 4).reused_pages == 0
    pool.release(1)
    assert pool.admit(1, list(range(8)), 4).reused_pages == 0
    pool.release(1)
    assert pool.admit(1, list(range(24)), 4).reused_pages == 2
    pool.release(1)
    diverged = list(range(8)) + [99] * 8 + list(range(16, 24))
    assert pool.admit(1, diverged, 4).reused_pages == 1
    pool.lookup(list(range(24)))


def test_pool_refusal_reclaim_and_ring_cow():
    pool = Both(slots=3, pool_pages=6)
    assert pool.admit(0, list(range(20)), 12) is not None   # 4 pages
    g1 = pool.admit(1, list(range(30, 40)), 6)              # 2 pages
    assert pool.admit(2, list(range(50, 60)), 6) is None    # exhausted
    pool.publish(g1)
    pool.release(1)                                         # 2 pages -> LRU
    assert pool.admit(2, list(range(50, 60)), 6) is not None   # reclaims
    assert pool.t.lru_reclaims == 1 and pool.t.free_pages == 0
    # the ring: a slot about to overwrite a shared page copies it out; a
    # sole owner un-publishes its own stale page
    ring = Both(slots=2, capacity=16, pt=8, layout="ring")
    prefix = list(range(1, 13))
    g0 = ring.admit(0, prefix + [50], 10)
    ring.publish(g0)
    g1 = ring.admit(1, prefix + [60], 10)
    assert g1.reused_pages == 1
    copies = ring.prepare_write(1, range(16, 18))     # wraps onto page 0
    assert len(copies) == 1 and ring.t.cow_copies == 1
    ring.prepare_write(0, range(16, 18))              # sole owner now
    assert ring.prepare_write(0, range(8, 9)) == []


def test_cache_arithmetic_matches():
    for kw in (dict(), dict(slots=4, capacity=100, pt=64),
               dict(slots=4, capacity=100, pt=64, pool_pages=5)):
        js, ts = specs(**kw)
        assert tkv.cache_bytes(ts) == jkv.cache_bytes(js)
        assert ts.global_shape == js.global_shape
        assert ts.device_shape == (js.layers, js.pool_rows + 1,
                                   js.kv_heads_local, js.head_dim)
    assert tkv.round_to_pages(100, 64) == jkv.round_to_pages(100, 64)
    args = (2, 4, 16, 128)
    for hbm, wb in ((10 << 20, 1 << 20), (1 << 40, 0)):
        assert (tkv.plan_slots(*args, torch.float32, hbm_bytes=hbm,
                               weight_bytes=wb)
                == jkv.plan_slots(*args, np.float32, hbm_bytes=hbm,
                                  weight_bytes=wb))
    with pytest.raises(ValueError, match="does not fit"):
        tkv.plan_slots(*args, torch.float32, hbm_bytes=1 << 20,
                       weight_bytes=1 << 20)
    with pytest.raises(ValueError, match="pool_pages"):
        specs(slots=4, capacity=100, pt=64, pool_pages=1)
    assert (tkv.prefix_page_hashes(list(range(20)), 8)
            == jkv.prefix_page_hashes(list(range(20)), 8))


# ================================================================ engine

@pytest.fixture(scope="module")
def params():
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x, np.float32),
        JGPT2.from_size("tiny", **TINY).init_params(jax.random.PRNGKey(0)))


def serve_config(**inf):
    base = {"max_slots": 3, "max_tokens": 32, "prefill_bucket": 24,
            "page_tokens": 8, "dtype": "float32"}
    base.update(inf)
    return {"train_micro_batch_size_per_gpu": 1, "inference": base}


def engines(params, cfg):
    return (JEngine(JGPT2.from_size("tiny", **TINY), config=cfg,
                    params=params),
            InferenceEngine(GPT2.from_size("tiny", device="meta", **TINY),
                            config=cfg, params=params, device="cpu"))


def run_both(je, te, reqs):
    js, ts = JScheduler(je), ContinuousScheduler(te)
    jr = js.run([JRequest(rid=r.rid, prompt=list(r.prompt),
                          max_new_tokens=r.max_new_tokens) for r in reqs])
    tr = ts.run(list(reqs))
    return ({r.rid: r.tokens for r in jr}, {r.rid: r.tokens for r in tr},
            js, ts)


def test_reset_clears_the_prefix_index(params):
    je, te = engines(params, serve_config())
    prefix = list(range(1, 17))
    for eng in (je, te):
        eng.prefill(0, prefix + [50])
        eng.reset()
    jt, tt, js, ts = run_both(je, te, [Request(rid=0, prompt=prefix + [51],
                                               max_new_tokens=2)])
    assert tt == jt and ts.prefix_hits == js.prefix_hits == 0


def test_reused_pages_bitwise_and_cow_on_ring_wrap(params):
    je, te = engines(params, serve_config())
    prefix = list(range(1, 17))
    reqs = [Request(rid=i, prompt=prefix + [30 + i], max_new_tokens=4)
            for i in range(3)]
    jt, tt, js, ts = run_both(je, te, reqs)
    assert tt == jt and ts.prefix_hits == js.prefix_hits == 2
    _, reused = te.admit(0, prefix + [77], 2)
    assert reused == 16 and te.pool.shared_pages(0) == 2
    rows = te.pool.slot_rows(0)[:16]
    shared = te._cache["k"][:, rows].clone()
    fresh = InferenceEngine(GPT2.from_size("tiny", device="meta", **TINY),
                            config=serve_config(prefix_reuse=False),
                            params=params, device="cpu")
    fresh.prefill(0, prefix + [77])
    assert torch.equal(shared,
                       fresh._cache["k"][:, fresh.pool.slot_rows(0)[:16]])
    # the ring: two concurrent slots share page 0; one wraps onto it
    cfg = serve_config(max_slots=2, max_tokens=16, prefill_bucket=16,
                       kv_layout="ring")
    je, te = engines(params, cfg)
    prefix = list(range(1, 13))
    reqs = [Request(rid=0, prompt=prefix + [50], max_new_tokens=10),
            Request(rid=1, prompt=prefix + [60], max_new_tokens=10)]
    jt, tt, js, ts = run_both(je, te, reqs)
    assert tt == jt and ts.prefix_hits == 1
    assert te.pool.cow_copies == je.pool.cow_copies >= 1
    assert te.pool.gauges() == je.pool.gauges()


def test_refused_admission_queues_until_pages_free(params):
    cfg = serve_config(max_slots=2, max_tokens=16, prefill_bucket=16,
                       pool_pages=3, prefix_reuse=False)
    je, te = engines(params, cfg)
    reqs = [Request(rid=i, prompt=[1 + i, 2 + i, 3 + i], max_new_tokens=10)
            for i in range(3)]
    jt, tt, js, ts = run_both(je, te, reqs)
    assert tt == jt and len(tt) == 3
    assert ts.admission_refusals == js.admission_refusals > 0


def test_auto_slots_and_page_pool_on_the_cpu(params):
    with pytest.raises(ValueError, match="max_slots"):
        InferenceEngine(GPT2.from_size("tiny", device="meta", **TINY),
                        config=serve_config(max_slots=0), params=params,
                        device="cpu")
    te = engines(params, serve_config())[1]
    spec = te.cache_spec
    assert tuple(te._cache["k"].shape) == spec.device_shape
    assert te._cache["k"].dtype == torch.float32
    assert tkv.cache_bytes(spec) == 2 * 2 * (3 * 32) * 4 * 16 * 4
