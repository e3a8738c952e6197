"""ZeRO stage 3 of the port against the JAX engine's stage 3: clipping,
the fp16 skip-on-overflow and Lion at dp 2 (the setting and tolerances of
``tests/test_torch_zero3_train.py``)."""

import pytest

from test_torch_zero3_train import run_case

#: name: (dp, mp, gas, precision, extra config, optimizer section)
CASES = {
    "dp2-clip": (2, 1, 2, "bf16", {"gradient_clipping": 0.05}, None),
    # 2^18: the first fp16 gradients overflow, so steps are skipped on
    # both sides (the MEGATRON loss-scale FSM under ZeRO)
    "dp2-fp16-skip": (2, 1, 1, "fp16",
                      {"fp16": {"enabled": True, "initial_scale_power": 18}},
                      None),
    "dp2-lion": (2, 1, 1, "bf16", {},
                 {"type": "Lion",
                  "params": {"lr": 3e-4, "weight_decay": 0.01}}),
}


@pytest.mark.parametrize("case", list(CASES))
def test_stage3_knobs_match_jax(case, tmp_path):
    jeng = run_case(CASES[case], tmp_path)
    if CASES[case][3] == "fp16":
        assert 1 <= jeng.skipped_steps < 3
