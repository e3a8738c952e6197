"""BERT MLM pretraining with LAMB, on the port.

The counterpart of ``examples/bert/pretrain_bert.py``: masked-LM batches of
a synthetic corpus (or of a text file, with a wordpiece vocabulary trained
in-process), a tiny BERT, the optimizer and precision of the DeepSpeed
config, and at the end an optional checkpoint for the SQuAD fine-tune:

    python -m deepspeed_tpu_torch.examples.pretrain_bert \\
        --deepspeed_config examples/bert/ds_config_lamb.json --steps 100 \\
        --save-checkpoint ckpts
    python -m deepspeed_tpu_torch.examples.squad_finetune \\
        --deepspeed_config examples/bert/ds_config_lamb.json \\
        --init-checkpoint ckpts

It runs on the first CUDA device; ``--device cpu`` runs it on the CPU.
"""

import argparse

import numpy as np
import torch

import deepspeed_tpu_torch
from deepspeed_tpu_torch.models import BertForPreTraining

VOCAB, SEQ = 512, 64
MASK_FRAC = 0.15


def mlm_batch(rng, batch, vocab=None, seq=None):
    """ids/mask/token-type + dense MLM labels (-1 = not predicted)."""
    V, T = vocab or VOCAB, seq or SEQ
    ids = rng.integers(4, V, size=(batch, T)).astype(np.int32)
    # the second half echoes the first, so the MLM task is learnable
    half = T // 2
    ids[:, half:] = (ids[:, :T - half] * 7 + 3) % (V - 4) + 4
    attn = np.ones((batch, T), np.int32)
    tt = np.zeros((batch, T), np.int32)
    tt[:, T // 2:] = 1
    labels = np.full((batch, T), -1, np.int32)
    pick = rng.random((batch, T)) < MASK_FRAC
    labels[pick] = ids[pick]
    ids = np.where(pick, 3, ids)          # 3 = [MASK]
    return ids, attn, tt, labels


def corpus_batcher(path, vocab_size, seq, vocab_file=None, save_vocab=None):
    """Real-text MLM: a wordpiece vocabulary (trained or loaded), the corpus
    encoded once into one id stream, batches of random seq-length windows
    with 15% masking."""
    from deepspeed_tpu_torch.tokenization import (BertTokenizer, MASK_TOKEN,
                                                  Vocab, train_wordpiece)
    with open(path) as f:
        lines = [ln.strip() for ln in f if ln.strip()]
    if vocab_file:
        vocab = Vocab.load(vocab_file)
    else:
        print(f"training a {vocab_size}-piece vocabulary from "
              f"{len(lines)} lines ...")
        vocab = train_wordpiece(lines, vocab_size=vocab_size)
    if save_vocab:
        vocab.save(save_vocab)
    tok = BertTokenizer(vocab)
    stream = np.asarray([i for line in lines for i in tok.encode(line)],
                        np.int32)
    if stream.size < seq + 1:
        raise RuntimeError(
            f"corpus {path} tokenizes to only {stream.size} pieces; need "
            f"> --seq-len {seq}")
    mask_id = vocab.id(MASK_TOKEN)
    print(f"corpus: {stream.size} wordpieces, vocab {len(vocab)}")

    def batcher(rng, batch):
        lo = rng.integers(0, stream.size - seq, size=batch)
        ids = np.stack([stream[i:i + seq] for i in lo])
        attn = np.ones((batch, seq), np.int32)
        tt = np.zeros((batch, seq), np.int32)
        labels = np.full((batch, seq), -1, np.int32)
        pick = rng.random((batch, seq)) < MASK_FRAC
        labels[pick] = ids[pick]
        ids = np.where(pick, mask_id, ids).astype(np.int32)
        return ids, attn, tt, labels

    return batcher, len(vocab)


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--steps", type=int, default=200)
    parser.add_argument("--seq-len", type=int, default=SEQ)
    parser.add_argument("--corpus",
                        help="plain-text file: real-text MLM pretraining "
                             "(wordpiece vocab trained in-process)")
    parser.add_argument("--vocab-size", type=int, default=8192)
    parser.add_argument("--vocab-file",
                        help="load a saved vocab.txt instead of training")
    parser.add_argument("--save-vocab",
                        help="write the trained vocabulary here")
    parser.add_argument("--save-checkpoint",
                        help="save an engine checkpoint here at the end "
                             "(fine-tune with squad_finetune "
                             "--init-checkpoint)")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the first CUDA "
                             "device); 'cpu' trains on the CPU")
    parser.add_argument("--seed", type=int, default=0)
    deepspeed_tpu_torch.add_config_arguments(parser)
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    seq = args.seq_len
    if args.corpus:
        batcher, vocab_size = corpus_batcher(
            args.corpus, args.vocab_size, seq,
            vocab_file=args.vocab_file, save_vocab=args.save_vocab)
        vocab_size += (-vocab_size) % 8   # as the JAX example pads it
    else:
        vocab_size = VOCAB
        batcher = lambda rng, b: mlm_batch(rng, b, vocab_size, seq)

    gen = torch.Generator().manual_seed(args.seed)
    model = BertForPreTraining.from_size(
        "tiny", vocab_size=vocab_size, max_seq_len=seq, num_layers=4,
        hidden_size=128, num_heads=4, generator=gen)
    engine, optimizer, _, _ = deepspeed_tpu_torch.initialize(
        args, model=model, device=args.device)

    micro = engine.train_micro_batch_size_per_gpu() * engine.dp_world_size
    rng = np.random.default_rng(0)
    loss = None
    for step in range(1, args.steps + 1):
        for _ in range(engine.gradient_accumulation_steps()):
            loss = engine(*batcher(rng, micro))
            engine.backward(loss)
            engine.step()
        if step % 20 == 0:
            print(f"step {step:4d}  mlm loss {float(loss.detach()):.4f}  "
                  f"scale {optimizer.cur_scale:.0f}")
    final = float(loss.detach()) if loss is not None else float("nan")
    print("final mlm loss:", final)
    if args.save_checkpoint:
        path = engine.save_checkpoint(args.save_checkpoint, tag="pretrain")
        print("checkpoint saved:", path)
    return final


if __name__ == "__main__":
    main()
