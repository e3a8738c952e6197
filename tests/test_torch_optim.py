"""The port's optimizers against the JAX package's.

Same numpy inputs through ``deepspeed_tpu.ops.optim`` (the XLA path), through
the Pallas kernels run with ``interpret=True`` (as tests/test_pallas_optim.py
runs them), and through ``deepspeed_tpu_torch.ops`` on CPU tensors, where the
CUDA kernels' wrappers run their plain PyTorch versions.  Tolerance: fp32
``rtol=1e-5, atol=1e-6``; the norm sums are taken in another order.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops import optim as jopt
from deepspeed_tpu.ops.pallas_optim import fused_adam_update, fused_lamb_update
from deepspeed_tpu_torch.ops import cuda_optim
from deepspeed_tpu_torch.ops import optim as topt

RTOL, ATOL = 1e-5, 1e-6

# stacked [L, h, h] leaf, a 1-element leaf and a size that is no multiple
# of 128
SHAPES = {"blocks.qkv_w": (3, 16, 16), "one": (1,), "odd": (1000,)}


def rand(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def make_state(shapes, seed=0):
    p = {k: rand(s, seed + 4 * i) for i, (k, s) in enumerate(shapes.items())}
    g = {k: rand(s, seed + 4 * i + 1) for i, (k, s) in enumerate(shapes.items())}
    m = {k: rand(s, seed + 4 * i + 2) * 0.1
         for i, (k, s) in enumerate(shapes.items())}
    v = {k: np.abs(rand(s, seed + 4 * i + 3)) * 0.01
         for i, (k, s) in enumerate(shapes.items())}
    return p, g, m, v


def jax_update(opt, p, g, m, v, *, step, combined_scale=1.0, **hypers):
    opt = dataclasses.replace(opt, use_pallas=False)
    to_j = lambda d: {k: jnp.asarray(x) for k, x in d.items()}
    state = jopt.OptimizerState(step=jnp.asarray(step - 1, jnp.int32),
                                m=to_j(m), v=to_j(v))
    newp, st = opt.update(to_j(p), to_j(g), state,
                          combined_scale=combined_scale, **hypers)
    to_n = lambda d: {k: np.asarray(x) for k, x in d.items()}
    return to_n(newp), to_n(st.m), to_n(st.v)


def torch_update(opt, p, g, m, v, *, step, combined_scale=1.0, **hypers):
    to_t = lambda d: {k: torch.tensor(x) for k, x in d.items()}
    params = to_t(p)
    state = topt.OptimizerState(step=step - 1, m=to_t(m), v=to_t(v))
    opt.update(params, to_t(g), state, combined_scale=combined_scale,
               **hypers)
    assert state.step == step
    to_n = lambda d: {k: x.numpy() for k, x in d.items()}
    return to_n(params), to_n(state.m), to_n(state.v)


def assert_trees_close(want, got):
    for w, h in zip(want, got):
        assert w.keys() == h.keys()
        for k in w:
            np.testing.assert_allclose(h[k], w[k], rtol=RTOL, atol=ATOL,
                                       err_msg=k)


@pytest.mark.parametrize("bias_correction", [True, False])
@pytest.mark.parametrize("scale", [1.0, 64.0])
def test_lamb_matches_jax(scale, bias_correction):
    kw = dict(lr=0.002, weight_decay=0.01, max_coeff=10.0, min_coeff=0.01,
              bias_correction=bias_correction)
    p, g, m, v = make_state(SHAPES)
    g = {k: x * scale for k, x in g.items()}
    want = jax_update(jopt.Lamb(**kw), p, g, m, v, step=3,
                      combined_scale=scale)
    got = torch_update(topt.Lamb(**kw), p, g, m, v, step=3,
                       combined_scale=torch.tensor(scale))
    assert_trees_close(want, got)


def _trust_ratio(p, g, m, v, *, b1=0.9, b2=0.999, eps=1e-8, wd=0.0):
    m = b1 * m + (1 - b1) * g
    v = b2 * v + (1 - b2) * g * g
    u = m / (np.sqrt(v) + eps) + wd * p
    return np.linalg.norm(p) / np.linalg.norm(u)


@pytest.mark.parametrize("case", ["zero_norm", "max_clamp", "min_clamp"])
def test_lamb_trust_ratio_edges(case):
    """A zero-norm leaf takes coefficient 1.0; large and tiny weights hit
    the max and min clamps."""
    p, g, m, v = make_state({"w": (300,)}, seed=7)
    if case == "zero_norm":
        p["w"] = np.zeros_like(p["w"])
    elif case == "max_clamp":
        p["w"] = p["w"] * 100.0
        assert _trust_ratio(p["w"], g["w"], m["w"], v["w"]) > 0.5
    else:
        p["w"] = p["w"] * 1e-4
        assert _trust_ratio(p["w"], g["w"], m["w"], v["w"]) < 0.08
    kw = dict(lr=0.01, max_coeff=0.5, min_coeff=0.08)
    want = jax_update(jopt.Lamb(**kw), p, g, m, v, step=1)
    got = torch_update(topt.Lamb(**kw), p, g, m, v, step=1)
    assert_trees_close(want, got)
    if case == "zero_norm":
        # coefficient 1.0: the update is step_size * u exactly
        step_size = topt.Lamb(**kw)._step_size(0.01, 1, 0.9, 0.999)
        u = (0.9 * m["w"] + 0.1 * g["w"]) / (
            np.sqrt(0.999 * v["w"] + 0.001 * g["w"] ** 2) + 1e-8)
        np.testing.assert_allclose(got[0]["w"], -step_size * u, rtol=1e-5,
                                   atol=1e-7)


@pytest.mark.parametrize("eps_inside_sqrt", [False, True])
@pytest.mark.parametrize("bias_correction", [True, False])
@pytest.mark.parametrize("cls", ["Adam", "AdamW"])
def test_adam_matches_jax(cls, bias_correction, eps_inside_sqrt):
    kw = dict(lr=0.001, weight_decay=0.05, bias_correction=bias_correction,
              eps_inside_sqrt=eps_inside_sqrt, eps=1e-6)
    p, g, m, v = make_state(SHAPES, seed=20)
    want = jax_update(getattr(jopt, cls)(**kw), p, g, m, v, step=4,
                      combined_scale=8.0)
    got = torch_update(getattr(topt, cls)(**kw), p, g, m, v, step=4,
                       combined_scale=8.0)
    assert_trees_close(want, got)


def test_per_leaf_hypers_match_jax():
    """Per-leaf lr/betas/decay (the engine's param groups)."""
    p, g, m, v = make_state(SHAPES, seed=40)
    lr = {"blocks.qkv_w": 0.003, "one": 0.001, "odd": 0.002}
    wd = {"blocks.qkv_w": 0.0, "one": 0.1, "odd": 0.01}
    b1 = {"blocks.qkv_w": 0.8, "one": 0.9, "odd": 0.95}
    for name in ("Lamb", "AdamW"):
        want = jax_update(getattr(jopt, name)(), p, g, m, v, step=2, lr=lr,
                          weight_decay=wd, beta1=b1)
        got = torch_update(getattr(topt, name)(), p, g, m, v, step=2, lr=lr,
                           weight_decay=wd, beta1=b1)
        assert_trees_close(want, got)


@pytest.mark.parametrize("momentum", [0.0, 0.9])
def test_sgd_matches_jax(momentum):
    p, g, m, _ = make_state(SHAPES, seed=60)
    m = {k: np.zeros_like(x) for k, x in m.items()}
    kw = dict(lr=0.1, weight_decay=0.01, momentum=momentum)
    to_j = lambda d: {k: jnp.asarray(x) for k, x in d.items()}
    jo = jopt.Sgd(**kw)
    st = jo.init(to_j(p))
    want, _ = jo.update(to_j(p), to_j(g), st, combined_scale=2.0)
    to = topt.Sgd(**kw)
    params = {k: torch.tensor(x) for k, x in p.items()}
    tst = to.init(params)
    to.update(params, {k: torch.tensor(x) for k, x in g.items()}, tst,
              combined_scale=2.0)
    for k in p:
        np.testing.assert_allclose(params[k].numpy(), np.asarray(want[k]),
                                   rtol=RTOL, atol=ATOL)


# ------------------------------------------- against the Pallas kernels


def _scal_row(beta1, beta2, step_size, wd, lr, combined_scale):
    return cuda_optim.make_scalars([(beta1, beta2, step_size, wd, lr)],
                                   combined_scale, "cpu")[0]


@pytest.mark.parametrize("n", [1, 100, 128 * 8 + 5])
@pytest.mark.parametrize("scale", [1.0, 64.0])
def test_fused_lamb_matches_pallas_interpret(n, scale):
    p, g, m, v = (rand((n,), s) for s in range(4))
    v = np.abs(v)
    g = g * scale
    step_size = float(jopt.Lamb()._step_size(0.002, jnp.asarray(3.0), 0.9,
                                             0.999))
    want = fused_lamb_update(
        jnp.asarray(p), jnp.asarray(g), jnp.asarray(m), jnp.asarray(v),
        beta1=0.9, beta2=0.999, eps=1e-8, weight_decay=0.01,
        combined_scale=scale, step_size=step_size, min_coeff=0.01,
        max_coeff=10.0, block_rows=8, interpret=True)
    tp, tg, tm, tv = (torch.tensor(x) for x in (p, g, m, v))
    cuda_optim.fused_lamb_update(
        tp, tg, tm, tv, _scal_row(0.9, 0.999, step_size, 0.01, 0.002, scale),
        eps=1e-8, min_coeff=0.01, max_coeff=10.0)
    for w, h in zip(want, (tp, tm, tv)):
        np.testing.assert_allclose(h.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=ATOL)


@pytest.mark.parametrize("decoupled", [False, True])
@pytest.mark.parametrize("eps_inside_sqrt", [False, True])
def test_fused_adam_matches_pallas_interpret(decoupled, eps_inside_sqrt):
    n = 128 * 8 + 3
    p, g, m, v = (rand((n,), 10 + s) for s in range(4))
    v = np.abs(v)
    step_size = float(jopt.Adam()._step_size(0.001, jnp.asarray(2.0), 0.9,
                                             0.999))
    want = fused_adam_update(
        jnp.asarray(p), jnp.asarray(g), jnp.asarray(m), jnp.asarray(v),
        beta1=0.9, beta2=0.999, eps=1e-6, weight_decay=0.05,
        combined_scale=4.0, step_size=step_size, lr=0.001,
        eps_inside_sqrt=eps_inside_sqrt, decoupled_decay=decoupled,
        block_rows=8, interpret=True)
    tp, tg, tm, tv = (torch.tensor(x) for x in (p, g, m, v))
    cuda_optim.fused_adam_update(
        tp, tg, tm, tv, _scal_row(0.9, 0.999, step_size, 0.05, 0.001, 4.0),
        eps=1e-6, eps_inside_sqrt=eps_inside_sqrt, decoupled=decoupled)
    for w, h in zip(want, (tp, tm, tv)):
        np.testing.assert_allclose(h.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=ATOL)


def test_step_size_matches_jax():
    for bc in (True, False):
        for step in (1, 2, 10, 1000):
            want = float(jopt.Lamb(bias_correction=bc)._step_size(
                4e-3, jnp.asarray(float(step)), 0.9, 0.999))
            got = topt.Lamb(bias_correction=bc)._step_size(4e-3, step, 0.9,
                                                           0.999)
            assert got == pytest.approx(want, rel=1e-6)


def test_from_config_matches_jax_fields():
    params = {"lr": 4e-3, "max_coeff": 0.5, "min_coeff": 0.08,
              "use_pallas": True, "eps_inside_sqrt": True,
              "betas": [0.8, 0.99], "weight_decay": 0.01}
    j = jopt.from_config("Lamb", params)
    t = topt.from_config("Lamb", params)
    for f in ("lr", "beta1", "beta2", "eps", "weight_decay", "max_coeff",
              "min_coeff", "eps_inside_sqrt", "bias_correction"):
        assert getattr(t, f) == getattr(j, f), f
    # Lion is ported (tests/test_torch_optim_extra.py): it parses as the
    # JAX package's does, eps dropped
    lion = {"lr": 3e-4, "betas": [0.9, 0.98], "eps": 1e-6,
            "weight_decay": 0.01}
    for f in ("lr", "beta1", "beta2", "eps", "weight_decay"):
        assert (getattr(topt.from_config("Lion", lion), f)
                == getattr(jopt.from_config("Lion", lion), f)), f
    with pytest.raises(ValueError):
        topt.from_config("nope", {})


def test_wrappers_reject_bad_inputs_and_count_no_cpu_launches():
    cuda_optim.reset_launch_counts()
    p = torch.zeros(8)
    scal = _scal_row(0.9, 0.999, 1e-3, 0.0, 1e-3, 1.0)
    cuda_optim.fused_lamb_update(p, torch.ones(8), torch.zeros(8),
                                 torch.zeros(8), scal, eps=1e-8,
                                 min_coeff=0.01, max_coeff=10.0)
    # the plain version ran: no kernel launch was counted
    assert cuda_optim.LAUNCHES == {"lamb_phase1": 0, "lamb_phase2": 0,
                                   "adam": 0}
    with pytest.raises(ValueError, match="no kernel for device"):
        cuda_optim.fused_adam_update(
            torch.zeros(8, device="meta"), torch.zeros(8, device="meta"),
            torch.zeros(8, device="meta"), torch.zeros(8, device="meta"),
            torch.zeros(8, device="meta"), eps=1e-8)
