"""The port's loss-scale FSMs against ``deepspeed_tpu.precision``.

Each scenario of tests/test_dynamic_loss_scale.py runs through both FSMs and
every field of the state must agree after every transition (exactly: the FSM
is integer and power-of-two arithmetic).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu import precision as JP
from deepspeed_tpu_torch import precision as TP

# (name, state kwargs, overflow sequence)
SCENARIOS = [
    ("no_overflow", dict(init_scale=2 ** 8, scale_window=2), [False] * 10),
    ("all_overflow_floor", dict(init_scale=2 ** 4, scale_window=2),
     [True] * 8),
    ("all_overflow_custom_min",
     dict(init_scale=2 ** 4, scale_window=2, min_scale=0.25), [True] * 8),
    ("some_overflow", dict(init_scale=2 ** 8, scale_window=2),
     [True, True, False, False, False, True]),
    ("hysteresis", dict(init_scale=2 ** 8, scale_window=1000,
                        delayed_shift=2), [True, True, True]),
    ("hysteresis_recovers", dict(init_scale=2 ** 8, scale_window=3,
                                 delayed_shift=2),
     [True, False, False, False, True, True, False, False, False, False]),
    ("static", dict(init_scale=128.0, dynamic=False),
     [True, False, True, False]),
]


def _fields(state):
    return {f: float(np.asarray(getattr(state, f)))
            for f in JP.LossScaleState._fields}


@pytest.mark.parametrize("variant", [JP.INLINE, JP.MEGATRON])
@pytest.mark.parametrize("name,kw,overflows", SCENARIOS,
                         ids=[s[0] for s in SCENARIOS])
def test_fsm_trajectory_matches_jax(name, kw, overflows, variant):
    js = JP.make_loss_scale_state(**kw)
    ts = TP.make_loss_scale_state(**kw)
    for i, o in enumerate(overflows):
        js = JP.update_loss_scale(js, o, variant=variant)
        ts = TP.update_loss_scale(ts, torch.tensor(o), variant=variant)
        assert _fields(ts) == _fields(js), (name, i)


def test_from_dynamic_args_matches_jax():
    args = {"init_scale": 2.0 ** 16, "scale_window": 100,
            "delayed_shift": 2, "min_scale": 0.5}
    for variant in (JP.INLINE, JP.MEGATRON):
        assert (_fields(TP.from_dynamic_args(args, variant=variant))
                == _fields(JP.from_dynamic_args(args, variant=variant)))
    assert _fields(TP.from_dynamic_args(None)) == _fields(
        JP.from_dynamic_args(None))
    assert _fields(TP.static_loss_scale_state(64.0)) == _fields(
        JP.static_loss_scale_state(64.0))


@pytest.mark.parametrize("norm,clip", [(40.0, 1.0), (2.0, 1.0), (1e9, 0.0),
                                       (3.5, 0.5)])
@pytest.mark.parametrize("scale", [1.0, 4.0, 2.0 ** 12])
def test_combined_unscale_and_clip_matches_jax(norm, clip, scale):
    want = JP.combined_unscale_and_clip_factor(
        jnp.asarray(norm, jnp.float32),
        JP.make_loss_scale_state(init_scale=scale), clip)
    got = TP.combined_unscale_and_clip_factor(
        torch.tensor(norm), TP.make_loss_scale_state(init_scale=scale), clip)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_has_overflow_scale_unscale_and_policy():
    good = {"a": torch.ones(4, 4), "b": torch.zeros(3)}
    assert not bool(TP.has_overflow(good))
    assert bool(TP.has_overflow({"a": torch.tensor([1.0, float("inf")])}))
    assert bool(TP.has_overflow({"a": torch.tensor([float("nan")]),
                                 "b": None}))
    assert not bool(TP.has_overflow({}))
    st = TP.make_loss_scale_state(init_scale=1024.0)
    scaled = TP.scale_loss(torch.tensor(2.5, dtype=torch.float16), st)
    assert scaled.dtype == torch.float32 and float(scaled) == 2560.0
    un = TP.unscale({"w": torch.full((8,), 512.0, dtype=torch.float16)}, st)
    np.testing.assert_allclose(un["w"].numpy(), 0.5)
    for fp16, bf16 in ((True, False), (False, True), (False, False)):
        j = JP.policy_from_config(fp16, bf16)
        t = TP.policy_from_config(fp16, bf16)
        assert t.needs_loss_scale == j.needs_loss_scale
        assert str(t.compute_dtype).split(".")[-1] == jnp.dtype(
            j.compute_dtype).name
