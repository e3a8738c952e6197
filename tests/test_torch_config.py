"""The port's copies of config.py and lr_schedules.py against the JAX
package's: the same JSON resolves to the same fields and raises the same
errors, and every schedule gives the same LR trajectory (exactly: both are
the same host-side Python arithmetic)."""

import argparse

import pytest

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu import config as jcfg
from deepspeed_tpu import lr_schedules as jsched
from deepspeed_tpu_torch import config as tcfg
from deepspeed_tpu_torch import lr_schedules as tsched

GOOD = [
    {"train_batch_size": 64, "gradient_accumulation_steps": 2,
     "optimizer": {"type": "Lamb", "params": {"lr": 4e-3, "max_coeff": 0.5,
                                              "min_coeff": 0.08}},
     "bf16": {"enabled": True}},
    {"train_micro_batch_size_per_gpu": 8, "gradient_accumulation_steps": 4,
     "fp16": {"enabled": True, "loss_scale_window": 500,
              "initial_scale_power": 16, "hysteresis": 2},
     "gradient_clipping": 1.0,
     "scheduler": {"type": "WarmupLR", "params": {"warmup_num_steps": 10}},
     "analysis": {"profile": "v4"}},
    {"train_batch_size": 32, "train_micro_batch_size_per_gpu": 8,
     "zero_optimization": {"stage": 2, "overlap_comm": False},
     "bf16": {"enabled": True},
     "optimizer": {"type": "AdamW", "params": {"lr": 1e-4},
                   "param_groups": [{"params": "ln", "weight_decay": 0.0}]}},
]
BAD = [
    {},
    {"train_batch_size": 10, "train_micro_batch_size_per_gpu": 3,
     "gradient_accumulation_steps": 2},
    {"train_batch_size": 8, "analysis": {"profile": "v9"}},
    {"train_batch_size": 8, "resilience": {"typo": 1}},
    {"train_batch_size": 8, "observability": {"trace_num_steps": 2}},
    {"train_batch_size": 8, "fp16": {"enabled": True},
     "bf16": {"enabled": True}},
]


def _fields(cfg):
    return {k: v for k, v in vars(cfg).items()
            if isinstance(v, (int, float, str, bool, list, tuple, dict,
                              type(None)))}


@pytest.mark.parametrize("i", range(len(GOOD)))
@pytest.mark.parametrize("world", [1, 2])
def test_same_json_resolves_the_same_fields(i, world):
    j = jcfg.DeepSpeedConfig(GOOD[i], dp_world_size=world)
    t = tcfg.DeepSpeedConfig(GOOD[i], dp_world_size=world)
    assert _fields(t) == _fields(j)


@pytest.mark.parametrize("i", range(len(BAD)))
def test_same_json_raises_the_same_error(i, monkeypatch):
    monkeypatch.delenv("DSTPU_TRACE_DIR", raising=False)
    with pytest.raises(jcfg.DeepSpeedConfigError) as je:
        jcfg.DeepSpeedConfig(BAD[i], dp_world_size=1)
    with pytest.raises(tcfg.DeepSpeedConfigError) as te:
        tcfg.DeepSpeedConfig(BAD[i], dp_world_size=1)
    assert str(te.value) == str(je.value)


class _Holder:
    def __init__(self, n_groups=2):
        self.param_groups = [{"lr": 1e-3, "betas": (0.9, 0.999)}
                             for _ in range(n_groups)]


SCHEDULES = [
    ("WarmupLR", {"warmup_min_lr": 0.0, "warmup_max_lr": 1e-3,
                  "warmup_num_steps": 7}),
    ("OneCycle", {"cycle_min_lr": 1e-4, "cycle_max_lr": 1e-3,
                  "cycle_first_step_size": 5, "cycle_momentum": True,
                  "decay_step_size": 4, "decay_lr_rate": 0.1,
                  "decay_mom_rate": 0.01}),
    ("LRRangeTest", {"lr_range_test_min_lr": 1e-4,
                     "lr_range_test_step_size": 3,
                     "lr_range_test_staircase": True}),
    ("warmup_linear_decay_exp", {"lr": 4e-3, "total_steps": 500,
                                 "warmup_proportion": 0.02,
                                 "decay_step": 10}),
    ("CosineAnnealingLR", {"T_max": 9}),
    ("StepLR", {"step_size": 4, "gamma": 0.5}),
    ("LinearLR", {"total_iters": 6}),
    ("ExponentialLR", {"gamma": 0.9}),
]


@pytest.mark.parametrize("name,params", SCHEDULES,
                         ids=[s[0] for s in SCHEDULES])
def test_schedules_give_the_same_lr_trajectory(name, params):
    jh, th = _Holder(), _Holder()
    js = jsched.SCHEDULES[name](jh, **params)
    ts = tsched.SCHEDULES[name](th, **params)
    for _ in range(25):
        js.step()
        ts.step()
        assert th.param_groups == jh.param_groups
        assert ts.get_last_lr() == js.get_last_lr()
    assert ts.state_dict() == js.state_dict()


def test_add_config_arguments_matches_jax():
    j = deepspeed_tpu.add_config_arguments(argparse.ArgumentParser())
    t = deepspeed_tpu_torch.add_config_arguments(argparse.ArgumentParser())
    argv = ["--deepspeed", "--deepspeed_config", "ds.json"]
    assert vars(t.parse_args(argv)) == vars(j.parse_args(argv))
