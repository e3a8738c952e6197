"""Learning-rate schedules: LRRangeTest, OneCycle, WarmupLR + CLI plumbing.

The port's copy of ``deepspeed_tpu/lr_schedules.py`` (upstream DeepSpeed's
``deepspeed/pt/deepspeed_lr_schedules.py``).
Schedules are host-side objects (LR is a per-boundary scalar fed into the
step, so there is nothing to trace) operating on any object exposing
``param_groups`` — the engine's optimizer wrapper provides the same
``[{'lr': ..., 'betas': (...)}]`` surface as a torch optimizer, which keeps
the reference's step/state_dict semantics byte-for-byte.
"""

from __future__ import annotations

import argparse
import logging
import math
from typing import List, Union

logger = logging.getLogger(__name__)

LR_SCHEDULE = "lr_schedule"
LR_RANGE_TEST = "LRRangeTest"
ONE_CYCLE = "OneCycle"
WARMUP_LR = "WarmupLR"
VALID_LR_SCHEDULES = [LR_RANGE_TEST, ONE_CYCLE, WARMUP_LR]

CYCLE_MOMENTUM_KEYS = ("cycle_momentum",)

LR_RANGE_TEST_MIN_LR = "lr_range_test_min_lr"
LR_RANGE_TEST_STEP_RATE = "lr_range_test_step_rate"
LR_RANGE_TEST_STEP_SIZE = "lr_range_test_step_size"
LR_RANGE_TEST_STAIRCASE = "lr_range_test_staircase"

CYCLE_FIRST_STEP_SIZE = "cycle_first_step_size"
CYCLE_FIRST_STAIR_COUNT = "cycle_first_stair_count"
CYCLE_SECOND_STEP_SIZE = "cycle_second_step_size"
CYCLE_SECOND_STAIR_COUNT = "cycle_second_stair_count"
DECAY_STEP_SIZE = "decay_step_size"

CYCLE_MIN_LR = "cycle_min_lr"
CYCLE_MAX_LR = "cycle_max_lr"
DECAY_LR_RATE = "decay_lr_rate"

CYCLE_MIN_MOM = "cycle_min_mom"
CYCLE_MAX_MOM = "cycle_max_mom"
DECAY_MOM_RATE = "decay_mom_rate"

WARMUP_MIN_LR = "warmup_min_lr"
WARMUP_MAX_LR = "warmup_max_lr"
WARMUP_NUM_STEPS = "warmup_num_steps"


def get_param_groups_holder(optimizer):
    """Accept anything with ``param_groups`` (engine wrapper, shim, or a torch
    optimizer); unwrap one level like the reference's ``get_torch_optimizer``
    (deepspeed_lr_schedules.py:287-296)."""
    if hasattr(optimizer, "param_groups"):
        return optimizer
    if hasattr(optimizer, "optimizer") and hasattr(optimizer.optimizer,
                                                   "param_groups"):
        return optimizer.optimizer
    raise TypeError(
        f"{type(optimizer).__name__} does not expose param_groups")


def _format_param(holder, value: Union[float, List[float]], name: str):
    if isinstance(value, (list, tuple)):
        if len(value) != len(holder.param_groups):
            raise ValueError(
                f"expected {len(holder.param_groups)} values for {name},"
                f" got {len(value)}")
        return list(value)
    return [value] * len(holder.param_groups)


class LRRangeTest:
    """LR range sweep (reference deepspeed_lr_schedules.py:298-396):
    ``lr = min_lr * (1 + step_rate * interval)`` with continuous or staircase
    interval."""

    def __init__(self,
                 optimizer,
                 lr_range_test_min_lr: float = 1e-3,
                 lr_range_test_step_size: int = 2000,
                 lr_range_test_step_rate: float = 1.0,
                 lr_range_test_staircase: bool = False,
                 last_batch_iteration: int = -1):
        self.optimizer = get_param_groups_holder(optimizer)
        self.min_lr = _format_param(self.optimizer, lr_range_test_min_lr,
                                    "lr_range_test_min_lr")
        self.step_size = lr_range_test_step_size
        self.step_rate = lr_range_test_step_rate
        self.staircase = lr_range_test_staircase
        self.last_batch_iteration = last_batch_iteration
        if last_batch_iteration == -1:
            self._update_optimizer(self.min_lr)
        else:
            self._last_lr = self.get_lr()

    def _interval(self):
        if self.staircase:
            return math.floor(float(self.last_batch_iteration) / self.step_size)
        return float(self.last_batch_iteration) / self.step_size

    def get_lr(self):
        increase = 1 + self.step_rate * self._interval()
        return [lr * increase for lr in self.min_lr]

    def get_last_lr(self):
        return self._last_lr

    def _update_optimizer(self, group_lrs):
        for group, lr in zip(self.optimizer.param_groups, group_lrs):
            group["lr"] = lr
        self._last_lr = list(group_lrs)

    def step(self, batch_iteration=None):
        if batch_iteration is None:
            batch_iteration = self.last_batch_iteration + 1
        self.last_batch_iteration = batch_iteration
        self._update_optimizer(self.get_lr())

    def state_dict(self):
        return {"last_batch_iteration": self.last_batch_iteration}

    def load_state_dict(self, sd):
        self.last_batch_iteration = sd["last_batch_iteration"]


class OneCycle:
    """1Cycle LR (+inverse momentum) policy with post-cycle decay
    (reference deepspeed_lr_schedules.py:398-640)."""

    def __init__(self,
                 optimizer,
                 cycle_min_lr,
                 cycle_max_lr,
                 decay_lr_rate=0.0,
                 cycle_first_step_size=2000,
                 cycle_second_step_size=None,
                 cycle_first_stair_count=0,
                 cycle_second_stair_count=None,
                 decay_step_size=0,
                 cycle_momentum=True,
                 cycle_min_mom=0.8,
                 cycle_max_mom=0.9,
                 decay_mom_rate=0.0,
                 last_batch_iteration=-1):
        self.optimizer = get_param_groups_holder(optimizer)

        # cycle shape (reference _initialize_cycle_params)
        cycle_first_step_size = float(cycle_first_step_size)
        cycle_second_step_size = float(
            cycle_second_step_size
            if cycle_second_step_size is not None else cycle_first_step_size)
        self.total_size = cycle_first_step_size + cycle_second_step_size
        self.step_ratio = cycle_first_step_size / self.total_size
        self.first_stair_count = cycle_first_stair_count
        self.second_stair_count = (cycle_first_stair_count
                                   if cycle_second_stair_count is None
                                   else cycle_second_stair_count)
        self.decay_step_size = decay_step_size

        # lr bounds
        self.min_lrs = _format_param(self.optimizer, cycle_min_lr, CYCLE_MIN_LR)
        self.max_lrs = _format_param(self.optimizer, cycle_max_lr, CYCLE_MAX_LR)
        self.decay_lr_rate = decay_lr_rate

        # momentum bounds (reference _initialize_momentum: requires a 'betas'
        # entry in the groups; our wrapper always has one)
        self.cycle_momentum = cycle_momentum
        if cycle_momentum:
            has_betas = all("betas" in g for g in self.optimizer.param_groups)
            if not has_betas:
                logger.warning(
                    "cycle_momentum disabled: optimizer has no betas")
                self.cycle_momentum = False
            else:
                self.decay_mom_rate = decay_mom_rate
                self.min_moms = [(cycle_min_mom, 0.99)] * len(
                    self.optimizer.param_groups)
                self.max_moms = [(cycle_max_mom, 0.99)] * len(
                    self.optimizer.param_groups)

        self.last_batch_iteration = last_batch_iteration
        if last_batch_iteration == -1:
            self._update_optimizer(self.min_lrs)
            if self.cycle_momentum:
                for group, mom in zip(self.optimizer.param_groups,
                                      self.min_moms):
                    group["betas"] = mom
        else:
            self._last_lr = self.get_lr()

    def _get_cycle_lr(self):
        cycle = math.floor(1 + self.last_batch_iteration / self.total_size)
        x = 1.0 + self.last_batch_iteration / self.total_size - cycle
        if x <= self.step_ratio:
            scale_factor = x / self.step_ratio
        else:
            scale_factor = (x - 1) / (self.step_ratio - 1)

        lrs = [min_lr + (max_lr - min_lr) * scale_factor
               for min_lr, max_lr in zip(self.min_lrs, self.max_lrs)]
        if self.cycle_momentum:
            momentums = []
            for base_betas, max_betas in zip(self.min_moms, self.max_moms):
                height = (max_betas[0] - base_betas[0]) * scale_factor
                momentums.append((max_betas[0] - height, base_betas[1]))
            for group, mom in zip(self.optimizer.param_groups, momentums):
                group["betas"] = mom
        return lrs

    def _get_decay_lr(self, decay_batch_iteration):
        decay_interval = decay_batch_iteration / self.decay_step_size
        lr_factor = 1 + self.decay_lr_rate * decay_interval
        lrs = [lr * lr_factor for lr in self.min_lrs]
        if self.cycle_momentum:
            mom_factor = 1 + self.decay_mom_rate * decay_interval
            momentums = [(beta0 * mom_factor, beta1)
                         for beta0, beta1 in self.max_moms]
            for group, mom in zip(self.optimizer.param_groups, momentums):
                group["betas"] = mom
        return lrs

    def get_lr(self):
        if self.last_batch_iteration <= self.total_size:
            return self._get_cycle_lr()
        return self._get_decay_lr(self.last_batch_iteration - self.total_size)

    def get_last_lr(self):
        return self._last_lr

    def _update_optimizer(self, group_lrs):
        for group, lr in zip(self.optimizer.param_groups, group_lrs):
            group["lr"] = lr
        self._last_lr = list(group_lrs)

    def step(self, batch_iteration=None):
        if batch_iteration is None:
            batch_iteration = self.last_batch_iteration + 1
        self.last_batch_iteration = batch_iteration
        self._update_optimizer(self.get_lr())

    def state_dict(self):
        return {"last_batch_iteration": self.last_batch_iteration}

    def load_state_dict(self, sd):
        self.last_batch_iteration = sd["last_batch_iteration"]


class WarmupLR:
    """Log-shaped warmup from min_lr to max_lr over warmup_num_steps, then
    constant (reference deepspeed_lr_schedules.py:642-712)."""

    def __init__(self,
                 optimizer,
                 warmup_min_lr: float = 0.0,
                 warmup_max_lr: float = 0.001,
                 warmup_num_steps: int = 1000,
                 last_batch_iteration: int = -1):
        self.optimizer = get_param_groups_holder(optimizer)
        self.min_lrs = _format_param(self.optimizer, warmup_min_lr, "min_lr")
        self.max_lrs = _format_param(self.optimizer, warmup_max_lr, "max_lr")
        self.delta_lrs = [b - s for b, s in zip(self.max_lrs, self.min_lrs)]
        self.warmup_num_steps = warmup_num_steps
        self.inverse_log_warm_up = 1.0 / math.log(warmup_num_steps)
        self.last_batch_iteration = last_batch_iteration
        self._last_lr = [g.get("lr", 0.0) for g in self.optimizer.param_groups]

    def _get_gamma(self):
        if self.last_batch_iteration < self.warmup_num_steps:
            return self.inverse_log_warm_up * math.log(
                self.last_batch_iteration + 1)
        return 1.0

    def get_lr(self):
        gamma = self._get_gamma()
        return [min_lr + (delta * gamma)
                for min_lr, delta in zip(self.min_lrs, self.delta_lrs)]

    def get_last_lr(self):
        return self._last_lr

    def step(self, last_batch_iteration=None):
        if last_batch_iteration is None:
            last_batch_iteration = self.last_batch_iteration + 1
        self.last_batch_iteration = last_batch_iteration
        lrs = self.get_lr()
        for group, lr in zip(self.optimizer.param_groups, lrs):
            group["lr"] = lr
        self._last_lr = list(lrs)

    def state_dict(self):
        return {"last_batch_iteration": self.last_batch_iteration}

    def load_state_dict(self, sd):
        self.last_batch_iteration = sd["last_batch_iteration"]


# ----------------------------------------------------------- CLI plumbing

def add_tuning_arguments(parser: argparse.ArgumentParser):
    """Reference deepspeed_lr_schedules.py:51-120: CLI overrides for the three
    schedules."""
    group = parser.add_argument_group("Convergence Tuning",
                                      "Convergence tuning configurations")
    group.add_argument("--lr_schedule", type=str, default=None,
                       help="LR schedule for training.")
    # LR range test
    group.add_argument("--lr_range_test_min_lr", type=float, default=0.001)
    group.add_argument("--lr_range_test_step_rate", type=float, default=1.0)
    group.add_argument("--lr_range_test_step_size", type=int, default=1000)
    group.add_argument("--lr_range_test_staircase", type=bool, default=False)
    # OneCycle
    group.add_argument("--cycle_first_step_size", type=int, default=1000)
    group.add_argument("--cycle_first_stair_count", type=int, default=-1)
    group.add_argument("--cycle_second_step_size", type=int, default=-1)
    group.add_argument("--cycle_second_stair_count", type=int, default=-1)
    group.add_argument("--decay_step_size", type=int, default=1000)
    group.add_argument("--cycle_min_lr", type=float, default=0.01)
    group.add_argument("--cycle_max_lr", type=float, default=0.1)
    group.add_argument("--decay_lr_rate", type=float, default=0.0)
    group.add_argument("--cycle_momentum", type=bool, default=False)
    group.add_argument("--cycle_min_mom", type=float, default=0.8)
    group.add_argument("--cycle_max_mom", type=float, default=0.9)
    group.add_argument("--decay_mom_rate", type=float, default=0.0)
    # WarmupLR
    group.add_argument("--warmup_min_lr", type=float, default=0)
    group.add_argument("--warmup_max_lr", type=float, default=0.001)
    group.add_argument("--warmup_num_steps", type=int, default=1000)
    return parser


def _override_from_args(args, params, names):
    for name in names:
        if hasattr(args, name) and getattr(args, name) is not None:
            params[name] = getattr(args, name)


def get_config_from_args(args):
    """Build a scheduler config dict from CLI args
    (reference deepspeed_lr_schedules.py:238-256)."""
    if not hasattr(args, LR_SCHEDULE) or args.lr_schedule is None:
        return None, f"--{LR_SCHEDULE} not specified on command line"
    if args.lr_schedule not in VALID_LR_SCHEDULES:
        return None, f"{args.lr_schedule} is not supported LR schedule"
    config = {"type": args.lr_schedule, "params": {}}
    if args.lr_schedule == LR_RANGE_TEST:
        _override_from_args(args, config["params"], [
            LR_RANGE_TEST_MIN_LR, LR_RANGE_TEST_STEP_RATE,
            LR_RANGE_TEST_STEP_SIZE, LR_RANGE_TEST_STAIRCASE])
    elif args.lr_schedule == ONE_CYCLE:
        _override_from_args(args, config["params"], [
            CYCLE_MIN_LR, CYCLE_MAX_LR, DECAY_LR_RATE, CYCLE_FIRST_STEP_SIZE,
            CYCLE_FIRST_STAIR_COUNT, CYCLE_SECOND_STEP_SIZE,
            CYCLE_SECOND_STAIR_COUNT, DECAY_STEP_SIZE, CYCLE_MOMENTUM_KEYS[0],
            CYCLE_MIN_MOM, CYCLE_MAX_MOM, DECAY_MOM_RATE])
        # the -1 CLI defaults are "unset" sentinels (reference
        # deepspeed_lr_schedules.py:63-83) — don't forward them
        for key in (CYCLE_FIRST_STAIR_COUNT, CYCLE_SECOND_STEP_SIZE,
                    CYCLE_SECOND_STAIR_COUNT):
            if config["params"].get(key, 0) is not None \
                    and config["params"].get(key, 0) < 0:
                del config["params"][key]
    else:
        _override_from_args(args, config["params"], [
            WARMUP_MIN_LR, WARMUP_MAX_LR, WARMUP_NUM_STEPS])
    return config, None


def get_lr_from_config(config):
    """Initial LR implied by a scheduler config
    (reference deepspeed_lr_schedules.py:259-277)."""
    if "type" not in config:
        return None, "LR schedule type not defined in config"
    if "params" not in config:
        return None, "LR schedule params not defined in config"
    sched, params = config["type"], config["params"]
    if sched not in VALID_LR_SCHEDULES:
        return None, f"{sched} is not a valid LR schedule"
    if sched == LR_RANGE_TEST:
        return params[LR_RANGE_TEST_MIN_LR], ""
    if sched == ONE_CYCLE:
        return params[CYCLE_MAX_LR], ""
    return params[WARMUP_MAX_LR], ""


# ------------------------------------------- torch-scheduler-name registry
# The reference instantiates any torch.optim.lr_scheduler.* by config name
# (deepspeed_light.py:351-354).  These are drop-in equivalents of the common
# ones, same constructor-arg spellings, host-side like everything above.

class _BaseLRsSchedule:
    """Shared machinery: captures base LRs at construction, updates groups
    from ``get_lr`` on each ``step`` (torch _LRScheduler protocol subset)."""

    def __init__(self, optimizer, last_epoch: int = -1):
        self.optimizer = get_param_groups_holder(optimizer)
        self.base_lrs = [g["lr"] for g in self.optimizer.param_groups]
        self.last_epoch = last_epoch
        self.step()

    def get_lr(self):
        raise NotImplementedError

    def get_last_lr(self):
        return self._last_lr

    def step(self, epoch=None):
        self.last_epoch = (self.last_epoch + 1) if epoch is None else epoch
        lrs = self.get_lr()
        for group, lr in zip(self.optimizer.param_groups, lrs):
            group["lr"] = lr
        self._last_lr = list(lrs)

    def state_dict(self):
        return {"last_epoch": self.last_epoch, "base_lrs": self.base_lrs}

    def load_state_dict(self, sd):
        self.last_epoch = sd["last_epoch"]
        self.base_lrs = list(sd["base_lrs"])


class CosineAnnealingLR(_BaseLRsSchedule):
    """torch.optim.lr_scheduler.CosineAnnealingLR equivalent (closed form)."""

    def __init__(self, optimizer, T_max: int, eta_min: float = 0.0,
                 last_epoch: int = -1):
        self.T_max = T_max
        self.eta_min = eta_min
        super().__init__(optimizer, last_epoch)

    def get_lr(self):
        # torch's closed form is periodic in T_max (no clamp)
        cos = (1 + math.cos(math.pi * self.last_epoch / self.T_max)) / 2
        return [self.eta_min + (base - self.eta_min) * cos
                for base in self.base_lrs]


class StepLR(_BaseLRsSchedule):
    """torch.optim.lr_scheduler.StepLR equivalent."""

    def __init__(self, optimizer, step_size: int, gamma: float = 0.1,
                 last_epoch: int = -1):
        self.decay_step_size = step_size
        self.gamma = gamma
        super().__init__(optimizer, last_epoch)

    def get_lr(self):
        k = self.last_epoch // self.decay_step_size
        return [base * (self.gamma ** k) for base in self.base_lrs]


class LinearLR(_BaseLRsSchedule):
    """torch.optim.lr_scheduler.LinearLR equivalent."""

    def __init__(self, optimizer, start_factor: float = 1.0 / 3,
                 end_factor: float = 1.0, total_iters: int = 5,
                 last_epoch: int = -1):
        self.start_factor = start_factor
        self.end_factor = end_factor
        self.total_iters = total_iters
        super().__init__(optimizer, last_epoch)

    def get_lr(self):
        t = min(self.last_epoch, self.total_iters)
        factor = (self.start_factor
                  + (self.end_factor - self.start_factor)
                  * t / self.total_iters)
        return [base * factor for base in self.base_lrs]


class ExponentialLR(_BaseLRsSchedule):
    """torch.optim.lr_scheduler.ExponentialLR equivalent."""

    def __init__(self, optimizer, gamma: float, last_epoch: int = -1):
        self.gamma = gamma
        super().__init__(optimizer, last_epoch)

    def get_lr(self):
        return [base * (self.gamma ** self.last_epoch)
                for base in self.base_lrs]


class WarmupDecayExp:
    """The bing_bert 16K-batch recipe's ``warmup_linear_decay_exp``
    schedule (reference docs/_tutorials/bert-pretraining.md:297): linear
    warmup from 0 to ``lr`` over ``warmup_proportion * total_steps``
    steps, then exponential decay ``lr * decay_rate^(step/decay_step)``.
    Constructor-arg spellings follow the published recipe table
    (warmup 0.02/0.01, decay_rate 0.90/0.70, decay_step 1000)."""

    def __init__(self, optimizer, lr: float = 4e-3,
                 total_steps: int = 187000,
                 warmup_proportion: float = 0.02,
                 decay_rate: float = 0.90, decay_step: int = 1000,
                 last_batch_iteration: int = -1):
        self.optimizer = get_param_groups_holder(optimizer)
        self.lr = lr
        self.warmup_steps = max(1, int(total_steps * warmup_proportion))
        self.decay_rate = decay_rate
        self.decay_step = decay_step
        self.last_batch_iteration = last_batch_iteration
        self._last_lr = [g.get("lr", 0.0)
                         for g in self.optimizer.param_groups]

    def get_lr(self):
        it = self.last_batch_iteration
        if it < self.warmup_steps:
            lr = self.lr * (it + 1) / self.warmup_steps
        else:
            lr = self.lr * (self.decay_rate
                            ** ((it - self.warmup_steps)
                                / self.decay_step))
        return [lr for _ in self.optimizer.param_groups]

    def get_last_lr(self):
        return self._last_lr

    def step(self, last_batch_iteration=None):
        if last_batch_iteration is None:
            last_batch_iteration = self.last_batch_iteration + 1
        self.last_batch_iteration = last_batch_iteration
        lrs = self.get_lr()
        for group, lr in zip(self.optimizer.param_groups, lrs):
            group["lr"] = lr
        self._last_lr = list(lrs)

    def state_dict(self):
        return {"last_batch_iteration": self.last_batch_iteration}

    def load_state_dict(self, sd):
        self.last_batch_iteration = sd["last_batch_iteration"]


SCHEDULES = {
    LR_RANGE_TEST: LRRangeTest,
    ONE_CYCLE: OneCycle,
    WARMUP_LR: WarmupLR,
    # the bing_bert recipe schedule (WALLCLOCK.md phase table)
    "warmup_linear_decay_exp": WarmupDecayExp,
    "WarmupDecayExp": WarmupDecayExp,
    # torch-name fallthrough registry (reference deepspeed_light.py:351-354)
    "CosineAnnealingLR": CosineAnnealingLR,
    "StepLR": StepLR,
    "LinearLR": LinearLR,
    "ExponentialLR": ExponentialLR,
}
