"""The port's Mixture-of-Experts GPT-2 against the JAX package's.

The JAX oracle is ``tests/test_moe.py`` (and ``test_zero3.py::
test_zero3_moe``); every case is ported here with its inputs made from a
numpy seed and the JAX weights carried into the port by ``weights.py``.

* One process: ``GPT2MoE`` loss and every gradient at mp 1 against the JAX
  model (top-1, top-2, top-3; no remat and the three remat policies, the
  ``"selective"`` one keeping the experts' ``ffn1``), ``moe_ffn`` against
  the JAX ``moe_ffn`` (dispatch mechanics, the padding mask, top-2 gates
  and slots, with the tests' numpy reconstructions), the top-k tie-break
  of a zero router, the ``E % ep`` refusal.  fp32: loss ``rtol=1e-5``,
  grads ``rtol=1e-4, atol=1e-5`` (``tests/test_torch_gpt2.py``'s).
* Two gloo ranks, one launch: ep 2 (mp 2) against the JAX mp 1 loss and
  gradients for top-1 and top-2 (``rtol=2e-5, atol=2e-6``, the JAX test's
  ep 2 vs ep 1 tolerance); the engine at mp 2 (Adam, top-1 and top-3)
  against the JAX engine at mp 1 (3 steps, ``rtol=1e-5, atol=1e-6``); bf16
  training at mp 2 that lowers the loss; the ZeRO-1 fp16 checkpoint round
  trip at mp 2 (bitwise resume) and the files both ways between the
  packages; MoE at sp 2 against the JAX GPT2MoE at sp 2.
* Four gloo ranks, one launch: ``GPT2MoEPipelined`` at pp 2 x ep 2, GPipe
  and 1F1B (SGD, which pins the aux gradient's scale), against the JAX
  model at pp 1 x mp 2, and 1F1B against GPipe; ZeRO-2 and ZeRO-3 x MoE at
  dp 2 x ep 2 against stage 0.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models import GPT2MoE as JMoE
from deepspeed_tpu.models import GPT2MoEPipelined as JMoEPipe
from deepspeed_tpu.models import moe as jmoe
from deepspeed_tpu.parallel.topology import make_mesh
from deepspeed_tpu_torch import weights, zero
from deepspeed_tpu_torch.models import GPT2MoE, GPT2MoEPipelined
from deepspeed_tpu_torch.models import moe as tmoe
from torch_rank_worker import TINY
from torch_ranks import run_ranks

VOCAB, SEQ = TINY["vocab_size"], TINY["max_seq_len"]
STEPS = 3
RTOL, ATOL = 1e-5, 1e-6
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5
EP_RTOL, EP_ATOL = 2e-5, 2e-6


def jmodel(**kw):
    kw = dict(dict(num_experts=4, capacity_factor=2.0), **kw)
    return JMoE.from_size("tiny", **dict(TINY, **kw))


def jparams(model, seed=0):
    return jax.tree_util.tree_map(np.asarray,
                                  model.init_params(jax.random.PRNGKey(seed)))


def lm_batch(rows, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, VOCAB, size=(rows, SEQ)).astype(np.int32)
    labels = np.roll(toks, -1, axis=1)
    labels[:, -1] = -1
    return toks, labels


def chain_batch(rows, seed=0):
    """The JAX test's learnable corpus: next token = (tok * 7 + 3) % V."""
    rng = np.random.default_rng(seed)
    toks = np.empty((rows, SEQ), np.int32)
    toks[:, 0] = rng.integers(0, VOCAB, size=rows)
    for t in range(1, SEQ):
        toks[:, t] = (toks[:, t - 1] * 7 + 3) % VOCAB
    labels = np.roll(toks, -1, axis=1)
    labels[:, -1] = -1
    return toks, labels


def steps_data(n, rows, fn=lm_batch, seed0=0):
    pairs = [fn(rows, seed=seed0 + i) for i in range(n)]
    return {"tokens": np.stack([p[0] for p in pairs]),
            "labels": np.stack([p[1] for p in pairs])}


@functools.lru_cache(maxsize=None)
def jax_reference(top_k, capacity_factor, seed=0, rows=8):
    """The JAX GPT2MoE's loss and gradients at mp 1 on ``lm_batch(rows)``
    (cached: the remat cases share their routing width's reference)."""
    jm = jmodel(router_top_k=top_k, capacity_factor=capacity_factor)
    params = jparams(jm, seed)
    return params, jax_loss_and_grads(jm, params, lm_batch(rows))


def jax_loss_and_grads(model, params, batch):
    mesh = make_mesh(devices=jax.devices()[:1])
    specs = model.partition_specs(params)
    fn = jax.jit(jax.shard_map(
        lambda p, *b: jax.value_and_grad(lambda q: model.apply(q, *b))(p),
        mesh=mesh, in_specs=(specs, P(), P()), out_specs=(P(), specs),
        check_vma=False))
    loss, grads = fn(params, *batch)
    return float(loss), weights.flatten_tree(
        jax.tree_util.tree_map(np.asarray, grads))


def jax_moe_ffn(p, x, cfg, valid=None):
    mesh = make_mesh(devices=jax.devices()[:1])
    fn = jax.jit(jax.shard_map(
        lambda p_, x_: jmoe.moe_ffn(x_, p_, cfg, valid=valid), mesh=mesh,
        in_specs=(jax.tree_util.tree_map(lambda _: P(), p), P()),
        out_specs=(P(), P()), check_vma=False))
    y, aux = fn(p, x)
    return np.asarray(y), float(aux)


def ffn_pair(**kw):
    """A one-layer MoE block's leaves (the layer axis sliced off) in both
    packages, with its configs."""
    base = dict(vocab_size=VOCAB, max_seq_len=SEQ, hidden_size=32,
                num_layers=1, num_heads=4)
    jcfg = jmoe.MoEConfig(**base, **kw)
    tcfg = tmoe.MoEConfig(**base, **kw)
    p = jax.tree_util.tree_map(
        lambda x: np.asarray(x[0]),
        jmoe.init_moe_block_params(jcfg, jax.random.PRNGKey(0)))
    return jcfg, tcfg, p


def port_moe_ffn(p, x, cfg, valid=None):
    tp = {k: torch.from_numpy(np.array(v)) for k, v in p.items()}
    y, aux = tmoe.moe_ffn(torch.from_numpy(np.array(x)), tp, cfg,
                          valid=None if valid is None
                          else torch.from_numpy(np.array(valid)))
    return y.numpy(), float(aux)


# ------------------------------------------------------------ one process

@pytest.mark.parametrize("top_k,remat", [(1, None), (2, None), (3, None),
                                         (1, "full"), (2, "dots"),
                                         (2, "selective")])
def test_gpt2_moe_loss_and_grads_match_jax(top_k, remat):
    """Loss and EVERY gradient of the port's GPT2MoE at mp 1 against the
    JAX model's, at each routing width and remat policy (the aux term
    crosses every remat route)."""
    kw = dict(router_top_k=top_k, capacity_factor=float(max(2, top_k)))
    params, (jl, jg) = jax_reference(top_k, kw["capacity_factor"])
    batch = lm_batch(8)
    over = dict(TINY, remat=remat is not None)
    if remat:
        over["remat_policy"] = remat
    tm = GPT2MoE.from_size("tiny", num_experts=4, **kw, **{
        k: v for k, v in over.items()})
    weights.params_from_numpy(tm, params)
    loss = tm(*(torch.from_numpy(b) for b in batch))
    loss.backward()
    np.testing.assert_allclose(float(loss), jl, rtol=RTOL)
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), jg[name], rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=name)


def test_gpt2_moe_leaves_match_jax():
    """The five MoE leaves replace fc*: the names, shapes and partition
    specs are the JAX model's."""
    jm = jmodel()
    params = jparams(jm)
    tm = GPT2MoE.from_size("tiny", num_experts=4, capacity_factor=2.0,
                           **TINY)
    got = {k: tuple(p.shape) for k, p in tm.named_parameters()}
    assert got == {k: v.shape for k, v in
                   weights.flatten_tree(params).items()}
    jspecs = weights.flatten_tree(jm.partition_specs(params))
    for name, dim in weights.flatten_tree(tm.partition_specs()).items():
        axes = [i for i, e in enumerate(jspecs[name]) if e is not None]
        assert axes == ([] if dim is None else [dim]), name
    assert tm.zero3_min_dims() == weights.flatten_tree(
        jm.zero3_min_dims(params))


def test_dispatch_mechanics():
    """Top-1 at capacity 0.5: the port's moe_ffn equals the JAX one, every
    kept token lands in one slot, and a dropped token's delta is exactly
    zero (the JAX test's reconstruction)."""
    jcfg, tcfg, p = ffn_pair(num_experts=2, capacity_factor=0.5)
    x = np.random.default_rng(0).normal(size=(2, SEQ, 32)).astype(np.float32)
    jy, jaux = jax_moe_ffn(p, x, jcfg)
    y, aux = port_moe_ffn(p, x, tcfg)
    np.testing.assert_allclose(y, jy, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(aux, jaux, rtol=1e-6)
    S = 2 * SEQ
    expert = (x.reshape(S, 32) @ p["router_w"]).argmax(-1)
    cap = int(np.ceil(S * tcfg.capacity_factor / tcfg.num_experts))
    kept, counts = np.zeros(S, bool), {}
    for s in range(S):
        e = int(expert[s])
        if counts.get(e, 0) < cap:
            kept[s] = True
            counts[e] = counts.get(e, 0) + 1
    yf = y.reshape(S, 32)
    assert (~kept).any()
    np.testing.assert_array_equal(yf[~kept], 0.0)
    assert np.abs(yf[kept]).max() > 0


def test_router_mask_excludes_padding():
    """Padding neither biases the aux statistics nor takes a slot: the
    masked aux over [valid | junk] is the unmasked aux over the valid
    half, and the padded rows get exactly zero; equal to the JAX moe_ffn."""
    jcfg, tcfg, p = ffn_pair(num_experts=2, capacity_factor=0.5)
    gen = np.random.default_rng(0)
    x_valid = gen.normal(size=(2, SEQ // 2, 32)).astype(np.float32)
    junk = (100.0 * gen.normal(size=(2, SEQ // 2, 32))).astype(np.float32)
    x_full = np.concatenate([x_valid, junk], axis=1)
    valid = np.concatenate([np.ones((2, SEQ // 2)), np.zeros((2, SEQ // 2))],
                           axis=1).astype(np.float32)
    y_full, aux_masked = port_moe_ffn(p, x_full, tcfg, valid)
    _, aux_ref = port_moe_ffn(p, x_valid, tcfg)
    np.testing.assert_allclose(aux_masked, aux_ref, rtol=1e-6)
    np.testing.assert_array_equal(y_full[:, SEQ // 2:], 0.0)
    assert np.abs(y_full[:, :SEQ // 2]).max() > 0
    jy, jaux = jax_moe_ffn(p, x_full, jcfg, jnp.asarray(valid))
    np.testing.assert_allclose(y_full, jy, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(aux_masked, jaux, rtol=1e-6)


def test_top2_gates_and_slots():
    """Top-2 at ample capacity: every token's output is the gate-weighted
    sum of its two experts' FFNs, the gates normalised over the pair
    (float64 numpy reference), and equal to the JAX moe_ffn."""
    jcfg, tcfg, p = ffn_pair(num_experts=4, capacity_factor=4.0,
                             router_top_k=2)
    x = np.random.default_rng(0).normal(size=(2, SEQ, 32)).astype(np.float32)
    y, aux = port_moe_ffn(p, x, tcfg)
    assert np.isfinite(aux)
    jy, jaux = jax_moe_ffn(p, x, jcfg)
    np.testing.assert_allclose(y, jy, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(aux, jaux, rtol=1e-6)
    S = 2 * SEQ
    xf = x.reshape(S, 32)
    logits = xf @ p["router_w"]
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    top2 = np.argsort(-probs, axis=-1)[:, :2]

    def gelu(v):
        return 0.5 * v * (1.0 + np.tanh(
            np.sqrt(2.0 / np.pi) * (v + 0.044715 * v ** 3)))

    yf = y.reshape(S, 32)
    for s in range(S):
        g = probs[s, top2[s]] / probs[s, top2[s]].sum()
        want = np.zeros(32, np.float64)
        for gj, e in zip(g, top2[s]):
            hmid = gelu(xf[s] @ p["exp1_w"][e] + p["exp1_b"][e])
            want += gj * (hmid @ p["exp2_w"][e] + p["exp2_b"][e])
        np.testing.assert_allclose(yf[s], want, rtol=2e-4, atol=2e-5,
                                   err_msg=f"token {s}")


@pytest.mark.parametrize("top_k", [1, 2])
def test_top_k_ties_take_the_lower_index(top_k):
    """A zero router gives every expert the same probability: the JAX
    top_k takes the lowest indices, and so must the port (torch.topk
    promises no order among ties), or the slots and the output differ."""
    jcfg, tcfg, p = ffn_pair(num_experts=4, capacity_factor=1.0,
                             router_top_k=top_k)
    p = dict(p, router_w=np.zeros_like(p["router_w"]))
    x = np.random.default_rng(1).normal(size=(2, SEQ, 32)).astype(np.float32)
    vals, idx = tmoe.top_k(torch.full((5, 4), 0.25), top_k)
    assert idx.tolist() == [list(range(top_k))] * 5
    y, aux = port_moe_ffn(p, x, tcfg)
    jy, jaux = jax_moe_ffn(p, x, jcfg)
    np.testing.assert_allclose(y, jy, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(aux, jaux, rtol=1e-6)


def test_experts_not_divisible_by_ep_rejected():
    tm = GPT2MoE.from_size("tiny", num_experts=3, **TINY)
    with pytest.raises(ValueError, match="not divisible"):
        tm.validate(2)
    with pytest.raises(ValueError, match="router_top_k 4 must be in"):
        GPT2MoE.from_size("tiny", num_experts=3, router_top_k=4,
                          **TINY).validate(1)
    with pytest.raises(ValueError, match="needs 2 processes"):
        deepspeed_tpu_torch.initialize(
            config={"train_batch_size": 8, "model_parallel_size": 2,
                    "optimizer": {"type": "Adam", "params": {"lr": 1e-3}}},
            model=tm, device="cpu")


def test_moe_pipelined_at_one_stage_equals_gpt2_moe():
    """GPT2MoEPipelined at pp 1 with one micro-batch is GPT2MoE: the stage
    hook returns the weighted aux, the schedule adds it once."""
    kw = dict(num_experts=4, capacity_factor=2.0, **TINY)
    params = jparams(jmodel())
    a = GPT2MoE.from_size("tiny", **kw)
    b = GPT2MoEPipelined.from_size("tiny", num_micro_batches=1, **kw)
    for m in (a, b):
        weights.params_from_numpy(m, params)
    batch = [torch.from_numpy(x) for x in lm_batch(4)]
    la, lb = a(*batch), b(*batch)
    la.backward()
    lb.backward()
    np.testing.assert_allclose(float(lb), float(la), rtol=1e-6)
    for (n, pa), pb in zip(a.named_parameters(), b.parameters()):
        np.testing.assert_allclose(pb.grad.numpy(), pa.grad.numpy(),
                                   rtol=1e-5, atol=1e-7, err_msg=n)


# ------------------------------------------------------- two ranks (mp 2)

def adam(lr=1e-3, **extra):
    cfg = {"train_batch_size": 8, "steps_per_print": 10 ** 9,
           "optimizer": {"type": "Adam", "params": {"lr": lr}}}
    cfg.update(extra)
    return cfg


FP16_Z1 = adam(zero_optimization={"stage": 1},
               fp16={"enabled": True, "initial_scale_power": 8})


def jax_engine(model, params, cfg, mesh=None):
    return deepspeed_tpu.initialize(
        config=cfg, model=model, model_parameters=params,
        mesh=mesh or make_mesh(devices=jax.devices()[:1]))[0]


def jax_state(engine):
    """The JAX engine's masters and moments per global leaf; under ZeRO-1
    its flat ``[mp, local]`` layout cut into each model rank's leaves (the
    port's ``zero.make_flat_meta`` is the same layout) and joined."""
    if engine.master is not None:
        return {key: weights.flatten_tree(jax.tree_util.tree_map(
            np.asarray, tree)) for key, tree in (
            ("master", engine.master), ("m", engine.opt_state.m),
            ("v", engine.opt_state.v))}
    mp = engine.mp_world_size
    shapes = {k: torch.zeros(v.shape) for k, v in weights.flatten_tree(
        jax.tree_util.tree_map(np.asarray, engine.params)).items()}
    local = [weights.flatten_tree(weights.shard_tree(
        weights.unflatten_tree(shapes), SPECS, mp, r)) for r in range(mp)]
    out = {}
    for key, flat in (("master", engine.master_flat),
                      ("m", engine.opt_state.m["flat"]),
                      ("v", engine.opt_state.v["flat"])):
        flat = np.asarray(flat)
        trees = []
        for r in range(mp):
            meta = zero.make_flat_meta(local[r], 1)
            trees.append({k: t.numpy() for k, t in zero.unflatten_tree(
                torch.from_numpy(flat[r][:meta.padded].copy()),
                meta).items()})
        out[key] = weights.flatten_tree(weights.combine_local_trees(
            [weights.unflatten_tree(t) for t in trees], SPECS))
    return out


def _run(outs, i):
    return [{k.split("/", 1)[1]: v for k, v in o.items()
             if k.startswith(f"{i}/")} for o in outs]


def joined(outs, key, specs):
    local = [{k[len(key) + 1:]: v for k, v in o.items()
              if k.startswith(key + "/")} for o in outs]
    dims = weights.flatten_tree(specs)
    for name, d in dims.items():
        if d is None:
            for tree in local[1:]:
                assert np.array_equal(tree[name], local[0][name]), name
    return weights.flatten_tree(weights.combine_local_trees(local, dims))


MOE_KW = dict(num_experts=4, capacity_factor=2.0)
SPECS = GPT2MoE.from_size("tiny", **MOE_KW, **TINY).partition_specs()


@pytest.fixture(scope="module")
def jax_zero1_save(tmp_path_factory):
    """The JAX engine's ZeRO-1 fp16 MoE run at mp 2: 3 steps, saved."""
    d = tmp_path_factory.mktemp("jax_moe_z1")
    jm = jmodel()
    eng = jax_engine(jm, jparams(jm, 7), FP16_Z1,
                     make_mesh(model_parallel_size=2,
                               devices=jax.devices()[:2]))
    data = steps_data(STEPS, 8)
    for i in range(STEPS):
        eng.train_batch((data["tokens"][i], data["labels"][i]))
    eng.save_checkpoint(str(d), tag="jax")
    return d, jax_state(eng)


@pytest.fixture(scope="module")
def port_ep2(tmp_path_factory, jax_zero1_save):
    jax_dir, _ = jax_zero1_save
    save_dir = tmp_path_factory.mktemp("moe_ckpt")
    params = jparams(jmodel(), 7)
    p3 = jparams(jmodel(router_top_k=3, capacity_factor=3.0), 7)
    inputs = {f"w/{k}": v for k, v in weights.flatten_tree(params).items()}
    inputs.update({f"w3/{k}": v for k, v in weights.flatten_tree(p3).items()})
    data = steps_data(6, 8)
    chain = steps_data(40, 8, fn=chain_batch)
    inputs.update(data)
    inputs.update({f"c/{k}": v for k, v in chain.items()})
    toks, labels = lm_batch(8)
    inputs.update({"tokens_g": toks, "labels_g": labels})
    moe = dict(model="moe", mp=2, moe_kw=MOE_KW)
    runs = [
        {"scenario": "moe_grads", "cases": [
            {"name": f"top{k}", "moe_kw": dict(MOE_KW, router_top_k=k)}
            for k in (1, 2)]},
        dict(moe, config=adam(), steps=STEPS),
        dict(moe, config=adam(), steps=STEPS, weights="w3",
             moe_kw=dict(MOE_KW, router_top_k=3, capacity_factor=3.0)),
        dict(moe, config=adam(2e-3, bf16={"enabled": True}), steps=40,
             batch_keys=["c/tokens", "c/labels"]),
        dict(moe, config=FP16_Z1, steps=6, leaves=True),
        dict(moe, config=FP16_Z1, steps=STEPS, save_after=STEPS,
             save_dir=str(save_dir), save_tag="mid", leaves=True),
        dict(moe, config=FP16_Z1, steps=STEPS, first_batch=STEPS,
             load=str(save_dir), leaves=True),
        dict(moe, config=FP16_Z1, steps=0, load=str(jax_dir), leaves=True),
        dict(moe, mp=1, sp=2, config=adam(), steps=STEPS),
    ]
    outs = run_ranks(tmp_path_factory.mktemp("moe_ep2"), 2,
                     {"scenario": "train", "runs": runs}, inputs,
                     timeout=240)
    return [_run(outs, i) for i in range(len(runs))], save_dir


def test_expert_parallel_matches_single_shard(port_ep2):
    """ep 2 == ep 1: the loss and every gradient (the expert-cut ones
    joined) against the JAX model at mp 1, top-1 and top-2; the router's
    and the other replicated leaves' gradients are bitwise equal on both
    ranks."""
    outs = port_ep2[0][0]
    for k in (1, 2):
        _, (jl, jg) = jax_reference(k, 2.0, seed=7)
        assert np.array_equal(outs[0][f"top{k}/loss"],
                              outs[1][f"top{k}/loss"])
        np.testing.assert_allclose(float(outs[0][f"top{k}/loss"]), jl,
                                   rtol=EP_RTOL)
        got = joined(outs, f"top{k}/g", SPECS)
        for name, g in jg.items():
            np.testing.assert_allclose(got[name], g, rtol=EP_RTOL,
                                       atol=EP_ATOL, err_msg=f"top{k} {name}")


def assert_close_state(got, want, what, rtol=RTOL, atol=ATOL):
    for key in ("master", "m", "v"):
        for name, w in want[key].items():
            np.testing.assert_allclose(got[key][name], w, rtol=rtol,
                                       atol=atol, err_msg=f"{what} {key} "
                                                          f"{name}")


def port_leaves(outs, specs=SPECS):
    return {key: joined(outs, key, specs) for key in ("master", "m", "v")}


@pytest.mark.parametrize("run,top_k", [(1, 1), (2, 3)])
def test_engine_at_ep2_matches_jax_engine_at_ep1(port_ep2, run, top_k):
    """The engine trains GPT2MoE at mp 2 (Adam, fp32, 3 steps) on the JAX
    engine's mp 1 trajectory: the losses and every master and moment (the
    router's gradient summed rightly over the model group: its aux share
    once, its combine share from every rank's experts).  top-3 with
    capacity 3.0 (the JAX ``test_top3_routing_trains``)."""
    outs = port_ep2[0][run]
    kw = {} if top_k == 1 else dict(router_top_k=3, capacity_factor=3.0)
    jm = jmodel(**kw)
    eng = jax_engine(jm, jparams(jm, 7), adam())
    data = steps_data(STEPS, 8)
    jl = [float(eng.train_batch((data["tokens"][i], data["labels"][i])))
          for i in range(STEPS)]
    assert np.array_equal(outs[0]["losses"], outs[1]["losses"])
    np.testing.assert_allclose(outs[0]["losses"], jl, rtol=RTOL)
    assert_close_state(port_leaves(outs), jax_state(eng), "ep 2 vs JAX ep 1")


def test_engine_trains_moe_bf16(port_ep2):
    """bf16 at mp 2 on the learnable chain corpus, 40 steps (the JAX
    ``test_engine_trains_moe``): finite losses that fall by a fifth."""
    losses = port_ep2[0][3][0]["losses"]
    assert np.isfinite(losses).all()
    assert np.mean(losses[-5:]) < 0.8 * np.mean(losses[:5]), losses


def test_moe_zero_checkpoint_roundtrip(port_ep2, jax_zero1_save):
    """ZeRO-1 x EP in fp16: the resumed run (3 steps, save, fresh ranks
    load, 3 steps) equals the unbroken 6 bitwise; the port's mp 2 files
    load into the JAX engine and the JAX engine's into the port, the
    masters and moments exact both ways."""
    runs, save_dir = port_ep2
    ref, saved, resumed, from_jax = runs[4:8]
    for r in range(2):
        assert np.array_equal(resumed[r]["losses"], ref[r]["losses"][3:])
        for key in ("master", "m", "v"):
            assert np.array_equal(resumed[r][key], ref[r][key]), key
    assert "mp_rank_01_model_states.pt" in str(saved[0]["files"])
    # port -> JAX
    jm = jmodel()
    eng = jax_engine(jm, jparams(jm, 7), FP16_Z1,
                     make_mesh(model_parallel_size=2,
                               devices=jax.devices()[:2]))
    eng.load_checkpoint(str(save_dir), tag="mid")
    got, want = jax_state(eng), port_leaves(saved)
    for key in ("master", "m", "v"):
        for name, w in want[key].items():
            assert np.array_equal(got[key][name], w), (key, name)
    assert eng.global_steps == STEPS
    # JAX -> port
    _, jstate = jax_zero1_save
    got = port_leaves(from_jax)
    for key in ("master", "m", "v"):
        for name, w in jstate[key].items():
            assert np.array_equal(got[key][name], w), (key, name)
    assert int(from_jax[0]["global_steps"]) == STEPS


def test_moe_at_sp2_matches_jax_sp2(port_ep2):
    """GPT2MoE at sp 2 (each seq block's tokens routed on its own rank,
    the loss the seq mean) against the JAX engine's GPT2MoE at sp 2: fp32
    Adam, 3 steps, with ``tests/test_torch_sp_train.py``'s tolerances (the
    ring's fp32 partial sums add in another order): losses ``rtol=2e-4,
    atol=2e-5``, masters ``rtol=1e-4, atol=1e-6``."""
    outs = port_ep2[0][8]
    jm = jmodel()
    eng = jax_engine(jm, jparams(jm, 7), adam(),
                     make_mesh(context_parallel_size=2,
                               devices=jax.devices()[:2]))
    data = steps_data(STEPS, 8)
    jl = [float(eng.train_batch((data["tokens"][i], data["labels"][i])))
          for i in range(STEPS)]
    np.testing.assert_allclose(outs[0]["losses"], jl, rtol=2e-4, atol=2e-5)
    got = {k.split("/", 1)[1]: v for k, v in outs[0].items()
           if k.startswith("master/")}
    for name, w in jax_state(eng)["master"].items():
        np.testing.assert_allclose(got[name], w, rtol=1e-4, atol=1e-6,
                                   err_msg=name)


# ------------------------------------------------------ four ranks, one launch

PIPE_KW = dict(num_experts=4, capacity_factor=2.0)
SGD = {"train_batch_size": 8, "steps_per_print": 10 ** 9,
       "optimizer": {"type": "SGD", "params": {"lr": 0.3}}}
Z_BF16 = lambda stage: adam(bf16={"enabled": True},
                            zero_optimization={"stage": stage})


def pipe_params():
    jm = JMoEPipe.from_size("tiny", num_micro_batches=2,
                            **dict(TINY, num_layers=4, **PIPE_KW))
    return jm, jparams(jm, 7)


@pytest.fixture(scope="module")
def port_4ranks(tmp_path_factory):
    _, pparams = pipe_params()
    inputs = {f"p/{k}": v for k, v in weights.flatten_tree(pparams).items()}
    inputs.update({f"w/{k}": v for k, v in
                   weights.flatten_tree(jparams(jmodel(), 7)).items()})
    inputs.update(steps_data(STEPS, 8, fn=chain_batch))
    pipe = dict(model="moe_pipe", pp=2, mp=2, layers=4, moe_kw=PIPE_KW,
                weights="p", config=SGD, steps=STEPS)
    moe = dict(model="moe", mp=2, moe_kw=MOE_KW, fp32_compute=True,
               steps=2, leaves=True)
    runs = [dict(pipe, schedule="gpipe"), dict(pipe, schedule="1f1b"),
            dict(moe, config=Z_BF16(0)), dict(moe, config=Z_BF16(2)),
            dict(moe, config=Z_BF16(3))]
    outs = run_ranks(tmp_path_factory.mktemp("moe_4"), 4,
                     {"scenario": "train", "runs": runs}, inputs,
                     timeout=240)
    return [_run(outs, i) for i in range(len(runs))]


def test_moe_pipeline_matches_jax_and_1f1b_matches_gpipe(port_4ranks):
    """GPT2MoEPipelined at pp 2 x ep 2 (4 layers, 2 micro-batches, SGD lr
    0.3, which pins the absolute gradient scale, the aux channel's
    included): GPipe and 1F1B on the JAX pipelined model's trajectory at
    the same mesh (``rtol=2e-4, atol=2e-5``, the JAX test's), and 1F1B on
    GPipe's; every rank reports the same losses."""
    jm, params = pipe_params()
    eng = jax_engine(jm, params, SGD,
                     make_mesh(pipeline_parallel_size=2,
                               model_parallel_size=2,
                               devices=jax.devices()[:4]))
    data = steps_data(STEPS, 8, fn=chain_batch)
    jl = [float(eng.train_batch((data["tokens"][i], data["labels"][i])))
          for i in range(STEPS)]
    gpipe, f1b = port_4ranks[0], port_4ranks[1]
    for outs in (gpipe, f1b):
        for o in outs[1:]:
            assert np.array_equal(o["losses"], outs[0]["losses"])
        np.testing.assert_allclose(outs[0]["losses"], jl, rtol=2e-4,
                                   atol=2e-5)
    np.testing.assert_allclose(f1b[0]["losses"], gpipe[0]["losses"],
                               rtol=2e-4, atol=2e-5)
    for r in range(4):
        np.testing.assert_allclose(f1b[r]["master"], gpipe[r]["master"],
                                   rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("stage", [2, 3])
def test_zero_x_moe_matches_stage0(port_4ranks, stage):
    """ZeRO-2 and ZeRO-3 x MoE at dp 2 x ep 2 (bf16 masters, an fp32
    forward) against stage 0 on the same mesh, 2 Adam steps (the JAX
    ``test_zero3_moe``, whose tolerance is ``rtol=5e-3, atol=5e-3``; the
    port holds ``rtol=1e-5, atol=1e-6``, as its dense ZeRO tests do)."""
    ref = port_4ranks[2]
    got = port_4ranks[{2: 3, 3: 4}[stage]]
    for r in range(4):
        np.testing.assert_allclose(got[r]["losses"], ref[r]["losses"],
                                   rtol=1e-5)
    if stage == 3:
        return      # the ZeRO-3 state is per-rank shards: the losses hold it
    # the model-local leaves of data rank 0 (ranks 0 and 1), joined
    for key in ("master", "m", "v"):
        want, have = joined(ref[:2], key, SPECS), joined(got[:2], key, SPECS)
        for name, w in want.items():
            np.testing.assert_allclose(have[name], w, rtol=1e-5, atol=1e-6,
                                       err_msg=f"{key} {name}")
