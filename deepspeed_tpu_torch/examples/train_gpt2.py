"""GPT-2 language-model training on the port.

The counterpart of ``examples/gpt2/train_gpt2.py``: GPT-2 trained on a
synthetic Markov corpus through the fused ``train_batch`` path, with the
parallel axes, ZeRO and precision of the DeepSpeed config:

    python -m deepspeed_tpu_torch.examples.train_gpt2 \\
        --deepspeed_config examples/gpt2/ds_config.json --steps 100

``--moe-experts N`` trains ``GPT2MoE`` (experts cut over the model group),
``--micro-batches M`` trains ``GPT2Pipelined`` (pair it with
``pipeline_parallel_size`` in the config), both together
``GPT2MoEPipelined``.  A config with ``model_parallel_size`` or
``pipeline_parallel_size`` above 1 runs one process per rank: start it
with the launcher (``python -m deepspeed_tpu_torch.launcher.run
--num_gpus N -m deepspeed_tpu_torch.examples.train_gpt2 ...``), which sets
each rank's ``DSTPU_*`` variables.  It runs on the first CUDA device of
each rank; ``--device cpu`` runs it on the CPU (gloo between ranks).
"""

import argparse

import numpy as np

import deepspeed_tpu_torch
from deepspeed_tpu_torch.models import GPT2, GPT2_SIZES

VOCAB, SEQ = 512, 64


def synthetic_lm_batch(rng, batch, vocab=None, seq=None):
    """Markov chain with Zipf marginals — learnable bigram structure (the
    JAX example's generator, number for number)."""
    V, T = vocab or VOCAB, seq or SEQ
    zipf = 1.0 / np.arange(1, V + 1)
    zipf /= zipf.sum()
    toks = np.empty((batch, T), np.int32)
    toks[:, 0] = rng.choice(V, size=batch, p=zipf)
    for t in range(1, T):
        det = (toks[:, t - 1] * 31 + 7) % V
        noise = rng.choice(V, size=batch, p=zipf)
        keep = rng.random(batch) < 0.8
        toks[:, t] = np.where(keep, det, noise)
    labels = np.roll(toks, -1, axis=1)
    labels[:, -1] = -1
    return toks, labels


def build_model(size, vocab, seq, moe_experts=0, micro_batches=0,
                generator=None):
    """GPT2, GPT2MoE, GPT2Pipelined or GPT2MoEPipelined by the flags."""
    kw = dict(vocab_size=vocab, max_seq_len=seq, generator=generator)
    if moe_experts > 0 and micro_batches > 0:
        from deepspeed_tpu_torch.models import GPT2MoEPipelined
        return GPT2MoEPipelined.from_size(
            size, num_experts=moe_experts, num_micro_batches=micro_batches,
            **kw)
    if moe_experts > 0:
        from deepspeed_tpu_torch.models import GPT2MoE
        return GPT2MoE.from_size(size, num_experts=moe_experts, **kw)
    if micro_batches > 0:
        from deepspeed_tpu_torch.models import GPT2Pipelined
        return GPT2Pipelined.from_size(size, num_micro_batches=micro_batches,
                                       **kw)
    return GPT2.from_size(size, **kw)


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--steps", type=int, default=200)
    parser.add_argument("--size", type=str, default="tiny",
                        choices=sorted(GPT2_SIZES))
    parser.add_argument("--seq", type=int, default=SEQ,
                        help="sequence length (perf configs use 1024)")
    parser.add_argument("--vocab", type=int, default=VOCAB)
    parser.add_argument("--moe-experts", type=int, default=0,
                        help="> 0 switches to GPT2MoE with this many "
                             "experts (expert-parallel over the model "
                             "group)")
    parser.add_argument("--micro-batches", type=int, default=0,
                        help="> 0 switches to GPT2Pipelined (pair with "
                             "pipeline_parallel_size in the config)")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the first CUDA "
                             "device); 'cpu' trains on the CPU")
    deepspeed_tpu_torch.add_config_arguments(parser)
    return parser.parse_args(argv)


def main(argv=None, model_parameters=None):
    """Train and return ``(printed, final)``: the ``(step, loss)`` pairs
    printed and the last loss.  ``model_parameters`` (a JAX-layout tree)
    replaces the model's own seed-0 initialisation."""
    import torch
    args = parse_args(argv)
    deepspeed_tpu_torch.init_distributed(device=args.device)

    model = build_model(args.size, args.vocab, args.seq, args.moe_experts,
                        args.micro_batches,
                        generator=torch.Generator().manual_seed(0))
    engine, optimizer, _, _ = deepspeed_tpu_torch.initialize(
        args, model=model, model_parameters=model_parameters,
        device=args.device)

    # every rank draws the global batch from the same stream (the JAX
    # example seeds by process index on a mesh that feeds each host its
    # part) and trains its data rank's rows
    batch = engine.train_batch_size()
    rows = batch // engine.dp_world_size
    lo = engine.topology.dp_rank * rows
    rank0 = engine.global_rank == 0
    rng = np.random.default_rng(0)
    printed, loss = [], None
    for step in range(args.steps):
        toks, labels = synthetic_lm_batch(rng, batch, args.vocab, args.seq)
        loss = engine.train_batch((toks[lo:lo + rows], labels[lo:lo + rows]))
        if step % 20 == 0:
            printed.append((step, float(loss)))
            if rank0:
                print(f"step {step:4d}  lm loss {float(loss):.4f}  "
                      f"scale {optimizer.cur_scale:.0f}  "
                      f"skipped {engine.skipped_steps}")
    final = float(loss)
    if rank0:
        print("final lm loss:", final)
    return printed, final


if __name__ == "__main__":
    main()
