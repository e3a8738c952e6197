"""Minimal example on the port: a 2-layer MLP on synthetic regression data.

The counterpart of ``examples/simple/train_simple.py``: CLI flags, a
config file, the dataloader route, the forward/backward/step loop (or
``train_many`` over ``data.BlockPrefetcher`` blocks when the config sets
``train_steps_per_dispatch`` > 1), the fp16 loss-scale observables, the
telemetry flush and a checkpoint save and resume:

    python -m deepspeed_tpu_torch.examples.train_simple \\
        --deepspeed_config examples/simple/ds_config.json

It runs on the first CUDA device; ``--device cpu`` runs it on the CPU.
"""

import argparse
import math

import numpy as np
import torch

import deepspeed_tpu_torch

HIDDEN = 64


class MLP(torch.nn.Module):
    """``forward(x, y)``: the mean squared error of a ReLU MLP's output."""

    def __init__(self, generator=None):
        super().__init__()
        s = 1.0 / math.sqrt(HIDDEN)
        self.w1 = torch.nn.Parameter(
            torch.randn(HIDDEN, HIDDEN, generator=generator) * s)
        self.b1 = torch.nn.Parameter(torch.zeros(HIDDEN))
        self.w2 = torch.nn.Parameter(
            torch.randn(HIDDEN, 1, generator=generator) * s)

    def forward(self, x, y):
        # inputs in the parameter dtype (bf16/fp16 under the engine's
        # precision); the loss in fp32
        x = x.to(self.w1.dtype)
        h = torch.relu(x @ self.w1 + self.b1)
        pred = (h @ self.w2)[:, 0].float()
        return torch.mean((pred - y.float()) ** 2)


class RegressionDataset:
    """numpy dataset: y = a quadratic of a random projection + noise."""

    def __init__(self, n=4096, seed=0):
        rng = np.random.default_rng(seed)
        self.x = rng.normal(size=(n, HIDDEN)).astype(np.float32)
        w = rng.normal(size=(HIDDEN,)) / np.sqrt(HIDDEN)
        z = self.x @ w
        self.y = (z + 0.1 * z ** 2 + 0.01 * rng.normal(size=n)).astype(
            np.float32)

    def __len__(self):
        return len(self.x)

    def __getitem__(self, i):
        return self.x[i], self.y[i]


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--steps", type=int, default=100)
    parser.add_argument("--ckpt_dir", type=str, default="/tmp/dst_simple")
    parser.add_argument("--local_rank", type=int, default=-1)
    parser.add_argument("--device", default=None,
                        help="torch device (default: the first CUDA "
                             "device); 'cpu' trains on the CPU")
    deepspeed_tpu_torch.add_config_arguments(parser)
    return parser.parse_args(argv)


def main(argv=None, model_parameters=None):
    """Train, save, and return ``(printed, final)``: the ``(step, loss)``
    pairs printed and the last loss.  ``model_parameters`` (a JAX-layout
    tree) replaces the model's own seed-0 initialisation."""
    args = parse_args(argv)
    # rendezvous when started by the launcher (a no-op in one process)
    deepspeed_tpu_torch.init_distributed(device=args.device)

    model = MLP(generator=torch.Generator().manual_seed(0))
    engine, optimizer, dataloader, _ = deepspeed_tpu_torch.initialize(
        args, model=model, model_parameters=model_parameters,
        training_data=RegressionDataset(), device=args.device)

    # resume if a checkpoint exists
    path, client = engine.load_checkpoint(args.ckpt_dir)
    start = client.get("step", 0) if client else 0
    if path:
        print(f"resumed from {path} at step {start}")

    it = iter(dataloader)

    def next_batch(step):
        nonlocal it
        try:
            return next(it)
        except StopIteration:
            dataloader.set_epoch(step)   # reshuffle
            it = iter(dataloader)
            return next(it)

    printed, loss = [], None

    def report(step):
        value = float(loss.detach())
        printed.append((step, value))
        print(f"step {step:4d}  loss {value:.5f}  "
              f"scale {optimizer.cur_scale:.0f}")

    k = engine.config.train_steps_per_dispatch
    if k > 1:
        # K optimizer steps a call, the next block staged while this one
        # trains; the trajectory is the K = 1 loop's
        from deepspeed_tpu_torch.data import BlockPrefetcher

        def batches():
            step = start
            while True:
                yield next_batch(step)
                step += 1

        for block in BlockPrefetcher(batches(), k=k):
            need = args.steps - engine.global_steps
            if need <= 0:
                break
            # clamp the trailing block so that --steps is exact
            loss = engine.train_many(block[:need] if need < k else block)
            step = engine.global_steps
            if step % 20 < k:
                report(step)
            if step >= args.steps:
                break
    else:
        for step in range(start, args.steps):
            batch = next_batch(step)
            loss = engine(*batch)
            engine.backward(loss)
            engine.step()
            if step % 20 == 0:
                report(step)

    # drain the final (possibly partial) telemetry window before exit (a
    # no-op unless the config enables the metric spool)
    engine.flush_telemetry()
    engine.save_checkpoint(args.ckpt_dir, client_state={"step": args.steps})
    # a resumed run with no step left trained nothing
    final = float(loss.detach()) if loss is not None else float("nan")
    print("final loss:", final)
    return printed, final


if __name__ == "__main__":
    main()
