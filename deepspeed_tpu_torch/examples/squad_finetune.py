"""SQuAD span fine-tune of ``BertForQuestionAnswering``, on the port.

The counterpart of ``examples/bert/squad_finetune.py``: fine-tunes the span
head through the engine, prints ``bert_squad_progress: step=N lr=... loss=...``
lines, and evaluates EM/F1 at the end.

* With ``--train-file``/``--predict-file`` (SQuAD v1.1 JSON) the wordpiece
  pipeline featurizes the data: a vocabulary trained from the training
  contexts (``--vocab-file`` loads a saved one), contexts tokenized with
  character offsets, predictions mapped back to context substrings and
  scored with the official evaluate-v1.1 normalization.
* Without files, a synthetic answerable-span corpus:

    python -m deepspeed_tpu_torch.examples.squad_finetune \\
        --deepspeed_config examples/bert/ds_config_lamb.json --steps 150

``--init-checkpoint`` starts the encoder from a pretraining checkpoint
(``pretrain_bert --save-checkpoint``).  It runs on the first CUDA device;
``--device cpu`` runs it on the CPU.
"""

import argparse
import json

import numpy as np
import torch

import deepspeed_tpu_torch
from deepspeed_tpu_torch import checkpoint as ckpt_mod
from deepspeed_tpu_torch import metrics, squad
from deepspeed_tpu_torch.models import BertForQuestionAnswering
from deepspeed_tpu_torch.tokenization import (BertTokenizer, Vocab,
                                              train_wordpiece)


def synthetic_batch(rng, batch, seq_len, vocab_size):
    """Answerable spans marked in-band: token 1 opens, token 2 closes."""
    ids = rng.integers(4, vocab_size, size=(batch, seq_len)).astype(np.int32)
    start = rng.integers(1, seq_len - 4, size=(batch,)).astype(np.int32)
    end = (start + 2).astype(np.int32)
    for b in range(batch):
        ids[b, start[b]] = 1
        ids[b, end[b]] = 2
    return (ids, np.ones_like(ids), np.zeros_like(ids), start, end)


def init_from_checkpoint(engine, load_dir, tag=None):
    """Start ``engine``'s backbone from a pretraining checkpoint; returns
    ``(loaded, skipped)`` leaf paths."""
    module = ckpt_mod.load_module_tree(load_dir, tag=tag)
    if module is None:
        raise RuntimeError(f"no checkpoint found under {load_dir}")
    loaded, skipped = ckpt_mod.init_from_module_tree(engine, module)
    print(f"init-checkpoint: transferred {len(loaded)} leaves, kept init "
          f"for {len(skipped)} ({', '.join(sorted(skipped)[:6])})")
    if not loaded:
        raise RuntimeError(
            "init-checkpoint transferred nothing: do seq-len, vocab and "
            "hidden size match the pretraining run?")
    return loaded, skipped


def synthetic_eval(predict, seq_len, vocab_size, batches=4, batch=32):
    """Span EM/F1 over seeded synthetic eval batches."""
    eval_rng = np.random.default_rng(999)
    em = f1 = total = 0.0
    for _ in range(batches):
        ids, attn, tt, gs, ge = synthetic_batch(eval_rng, batch, seq_len,
                                                vocab_size)
        sl, el = predict(ids, attn, tt)
        ps, pe = metrics.best_spans(sl, el, attn, max_answer_len=8)
        r = metrics.evaluate_spans(ps, pe, gs, ge)
        em += r["exact_match"] * r["total"]
        f1 += r["f1"] * r["total"]
        total += r["total"]
    return {"exact_match": em / total, "f1": f1 / total, "total": int(total)}


def squad_eval(predict, args, tokenizer, seq_len):
    dev_exs = squad.load_squad_json(args.predict_file, limit=2048)
    dev_feats = squad.featurize(dev_exs, tokenizer, seq_len=seq_len,
                                doc_stride=args.doc_stride)
    eb = 32
    n = len(dev_feats)
    all_ps, all_pe = np.zeros(n, np.int64), np.zeros(n, np.int64)
    all_scores = np.zeros(n, np.float32)
    for lo in range(0, n, eb):
        chunk = dev_feats[lo:lo + eb]
        ids, attn, tt, _, _ = squad.batch_features(chunk)
        sl, el = predict(ids, attn, tt)
        ps, pe = metrics.best_spans(sl, el, attn, args.max_answer_len)
        sl, el = sl.float().cpu().numpy(), el.float().cpu().numpy()
        take = len(chunk)
        all_ps[lo:lo + take], all_pe[lo:lo + take] = ps, pe
        all_scores[lo:lo + take] = (sl[np.arange(take), ps]
                                    + el[np.arange(take), pe])
    preds = squad.postprocess(dev_exs, dev_feats, all_ps, all_pe,
                              all_scores)
    return squad.evaluate_predictions(dev_exs, preds)


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--steps", type=int, default=150)
    parser.add_argument("--seq-len", type=int, default=None,
                        help="default: 384 with SQuAD files, 64 synthetic")
    parser.add_argument("--doc-stride", type=int, default=128)
    parser.add_argument("--vocab-size", type=int, default=8192,
                        help="wordpiece vocabulary size to train")
    parser.add_argument("--vocab-file",
                        help="load a saved vocab.txt instead of training")
    parser.add_argument("--save-vocab",
                        help="write the trained vocabulary here")
    parser.add_argument("--max-answer-len", type=int, default=30)
    parser.add_argument("--train-file", help="SQuAD v1.1 train json")
    parser.add_argument("--predict-file", help="SQuAD v1.1 dev json")
    parser.add_argument("--init-checkpoint",
                        help="initialize the encoder from a pretraining "
                             "checkpoint dir (pretrain_bert "
                             "--save-checkpoint); the new QA head keeps "
                             "its init")
    parser.add_argument("--init-tag", default=None,
                        help="checkpoint tag (default: the dir's latest)")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the first CUDA "
                             "device); 'cpu' trains on the CPU")
    parser.add_argument("--seed", type=int, default=0)
    deepspeed_tpu_torch.add_config_arguments(parser)
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    if args.predict_file and not args.train_file:
        raise SystemExit(
            "--predict-file requires --train-file (the vocabulary is built "
            "from the training data)")
    real = bool(args.train_file)
    seq_len = args.seq_len or (384 if real else 64)
    tokenizer = None
    if real:
        train_exs = squad.load_squad_json(args.train_file)
        if not train_exs:
            raise RuntimeError(f"{args.train_file} holds no answerable "
                               f"questions (SQuAD v1.1 format required)")
        if args.vocab_file:
            vocab = Vocab.load(args.vocab_file)
        else:
            print(f"training a {args.vocab_size}-piece wordpiece "
                  f"vocabulary from {len(train_exs)} examples ...")
            corpus = list(dict.fromkeys(e.context for e in train_exs))
            vocab = train_wordpiece(
                corpus + [e.question for e in train_exs],
                vocab_size=args.vocab_size)
        if args.save_vocab:
            vocab.save(args.save_vocab)
        tokenizer = BertTokenizer(vocab)
        vocab_size = len(vocab) + (-len(vocab)) % 8
    else:
        vocab_size = 128

    gen = torch.Generator().manual_seed(args.seed)
    model = BertForQuestionAnswering.from_size(
        "tiny", vocab_size=vocab_size, max_seq_len=seq_len, num_layers=4,
        hidden_size=128, num_heads=4, generator=gen)
    engine, _, _, _ = deepspeed_tpu_torch.initialize(
        args, model=model, device=args.device)
    batch_size = (engine.train_micro_batch_size_per_gpu()
                  * engine.dp_world_size
                  * engine.gradient_accumulation_steps())
    if args.init_checkpoint:
        init_from_checkpoint(engine, args.init_checkpoint, args.init_tag)

    if real:
        feats = squad.featurize(train_exs, tokenizer, seq_len=seq_len,
                                doc_stride=args.doc_stride)
        print(f"featurized {len(train_exs)} examples -> {len(feats)} "
              f"windows ({sum(f.has_answer for f in feats)} containing "
              f"their answer)")
        order = np.random.default_rng(0)

        def next_batch():
            take = order.choice(len(feats), size=batch_size, replace=True)
            return squad.batch_features([feats[i] for i in take])
    else:
        rng = np.random.default_rng(0)
        next_batch = lambda: synthetic_batch(rng, batch_size, seq_len,
                                             vocab_size)

    losses = []
    for step in range(args.steps):
        losses.append(float(engine.train_batch(next_batch())))
        if step % 10 == 0 or step == args.steps - 1:
            print(f"bert_squad_progress: step={step} lr="
                  f"{engine.optimizer.param_groups[0]['lr']} "
                  f"loss={losses[-1]}")

    predict = metrics.make_span_predictor(engine.module)
    if real and args.predict_file:
        result = squad_eval(predict, args, tokenizer, seq_len)
    else:
        result = synthetic_eval(predict, seq_len, vocab_size)
    print(json.dumps(result))
    return losses, result


if __name__ == "__main__":
    main()
