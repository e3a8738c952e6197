"""SQuAD v1.1 featurization and span post-processing (wordpiece-based).

The port of ``deepspeed_tpu/squad.py`` (pure Python and numpy):

* ``load_squad_json``: the official JSON as (question, context, answers,
  char offsets);
* ``featurize``: ``[CLS] question [SEP] context [SEP]`` windows with a
  sliding doc stride, wordpiece tokens carrying character offsets so gold
  char spans map to token positions exactly;
* ``postprocess``: predicted token spans back to the ORIGINAL context
  substrings through the stored offsets;
* ``evaluate_predictions``: the evaluate-v1.1 aggregation.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from deepspeed_tpu_torch import metrics
from deepspeed_tpu_torch.tokenization import BertTokenizer


@dataclasses.dataclass
class Example:
    qas_id: str
    question: str
    context: str
    answers: List[str]            # all annotated variants (dev has several)
    answer_start: int             # char offset of answers[0] in context


@dataclasses.dataclass
class Feature:
    """One [CLS] q [SEP] ctx-window [SEP] input row."""
    example_index: int
    input_ids: np.ndarray         # [T] int32
    attention_mask: np.ndarray    # [T] int32
    token_type_ids: np.ndarray    # [T] int32
    start_position: int           # token index of answer start (or 0=CLS)
    end_position: int
    token_spans: List[Optional[Tuple[int, int]]]  # per-token ctx char span
    has_answer: bool              # answer fully inside this window


def load_squad_json(path: str, limit: Optional[int] = None) -> List[Example]:
    with open(path) as f:
        data = json.load(f)["data"]
    out: List[Example] = []
    for article in data:
        for para in article["paragraphs"]:
            ctx = para["context"]
            for qa in para["qas"]:
                if not qa.get("answers"):
                    continue
                out.append(Example(
                    qas_id=qa.get("id", str(len(out))),
                    question=qa["question"],
                    context=ctx,
                    answers=[a["text"] for a in qa["answers"]],
                    answer_start=qa["answers"][0]["answer_start"]))
                if limit and len(out) >= limit:
                    return out
    return out


def featurize(examples: Sequence[Example], tokenizer: BertTokenizer,
              seq_len: int, doc_stride: int = 64,
              max_query_len: int = 24) -> List[Feature]:
    """Sliding-window featurization (the run_squad convert_examples
    analog).  Windows without the full answer train toward the [CLS]
    no-answer position, exactly like the original recipe."""
    feats: List[Feature] = []
    for ei, ex in enumerate(examples):
        q_ids = tokenizer.encode(ex.question)[:max_query_len]
        ctx_pieces, ctx_spans = tokenizer.tokenize_with_offsets(ex.context)
        ctx_ids = [tokenizer.vocab.id(p) for p in ctx_pieces]

        # gold char span → token span over the full context
        a_lo = ex.answer_start
        a_hi = a_lo + len(ex.answers[0])
        tok_s = tok_e = None
        for ti, (lo, hi) in enumerate(ctx_spans):
            if lo < a_hi and hi > a_lo:       # token overlaps the answer
                if tok_s is None:
                    tok_s = ti
                tok_e = ti

        budget = seq_len - len(q_ids) - 3
        if budget <= 0:
            raise ValueError(
                f"seq_len {seq_len} too small for the question "
                f"({len(q_ids)} tokens)")
        win_starts = list(range(0, max(len(ctx_ids) - budget, 0) + 1,
                                doc_stride))
        if win_starts[-1] + budget < len(ctx_ids):
            # stride didn't land on the tail: add a final full-width
            # window so EVERY token (and answer) is covered
            win_starts.append(len(ctx_ids) - budget)
        for win_lo in win_starts:
            win_hi = min(win_lo + budget, len(ctx_ids))
            ids = ([tokenizer.cls_id] + q_ids + [tokenizer.sep_id]
                   + ctx_ids[win_lo:win_hi] + [tokenizer.sep_id])
            off = 2 + len(q_ids)              # window token 0 position
            pad = seq_len - len(ids)
            attn = [1] * len(ids) + [0] * pad
            tt = [0] * off + [1] * (len(ids) - off) + [0] * pad
            ids = ids + [tokenizer.pad_id] * pad
            spans: List[Optional[Tuple[int, int]]] = [None] * seq_len
            for k in range(win_lo, win_hi):
                spans[off + k - win_lo] = ctx_spans[k]
            inside = (tok_s is not None and win_lo <= tok_s
                      and tok_e < win_hi)
            s = off + tok_s - win_lo if inside else 0
            e = off + tok_e - win_lo if inside else 0
            feats.append(Feature(
                example_index=ei,
                input_ids=np.asarray(ids, np.int32),
                attention_mask=np.asarray(attn, np.int32),
                token_type_ids=np.asarray(tt, np.int32),
                start_position=int(s), end_position=int(e),
                token_spans=spans, has_answer=bool(inside)))
            if win_hi == len(ctx_ids):
                break
    return feats


def batch_features(feats: Sequence[Feature]):
    """Stack features into the model's 5-tuple batch."""
    return (np.stack([f.input_ids for f in feats]),
            np.stack([f.attention_mask for f in feats]),
            np.stack([f.token_type_ids for f in feats]),
            np.asarray([f.start_position for f in feats], np.int32),
            np.asarray([f.end_position for f in feats], np.int32))


def postprocess(examples: Sequence[Example], feats: Sequence[Feature],
                starts: np.ndarray, ends: np.ndarray,
                scores: Optional[np.ndarray] = None) -> Dict[str, str]:
    """Predicted token spans → answer TEXT per example.

    Among an example's windows, the highest-scoring valid span wins
    (``scores`` defaults to preferring windows that predict a non-CLS
    span).  The answer text is the ORIGINAL context substring under the
    span's stored character offsets — never a detokenization."""
    best: Dict[int, Tuple[float, str]] = {}
    for fi, f in enumerate(feats):
        s, e = int(starts[fi]), int(ends[fi])
        span_s = f.token_spans[s] if 0 <= s < len(f.token_spans) else None
        span_e = f.token_spans[e] if 0 <= e < len(f.token_spans) else None
        if span_s is None or span_e is None or span_e[1] < span_s[0]:
            text, score = "", -1e9      # CLS/no-answer or invalid span
        else:
            ctx = examples[f.example_index].context
            text = ctx[span_s[0]:span_e[1]]
            score = float(scores[fi]) if scores is not None else 0.0
        cur = best.get(f.example_index)
        if cur is None or score > cur[0]:
            best[f.example_index] = (score, text)
    return {examples[ei].qas_id: text
            for ei, (_, text) in best.items()}


def evaluate_predictions(examples: Sequence[Example],
                         predictions: Dict[str, str]) -> dict:
    """evaluate-v1.1 aggregation: official normalization, max over ground
    truths, percentages."""
    em = f1 = 0.0
    for ex in examples:
        pred = predictions.get(ex.qas_id, "")
        em += metrics.metric_max_over_ground_truths(
            metrics.text_exact_match, pred, ex.answers)
        f1 += metrics.metric_max_over_ground_truths(
            metrics.text_f1, pred, ex.answers)
    n = max(len(examples), 1)
    return {"exact_match": 100.0 * em / n, "f1": 100.0 * f1 / n,
            "total": len(examples)}
