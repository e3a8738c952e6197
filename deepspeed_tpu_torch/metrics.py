"""SQuAD-style evaluation metrics: exact match and token F1.

The port of ``deepspeed_tpu/metrics.py``:

* text metrics: the official SQuAD v1.1 normalization (lowercase, strip
  punctuation, articles and extra whitespace) with whitespace-token F1;
* span metrics: position-level EM and overlap F1 over (start, end) token
  spans, for synthetic corpora;
* ``best_spans``: the argmax over valid (start <= end, length <
  max_answer_len) pairs, batched, on torch tensors;
* ``make_span_predictor``: a no-grad predictor of a span model.
"""

from __future__ import annotations

import collections
import re
import string
from typing import Sequence, Tuple

import numpy as np
import torch

# ------------------------------------------------------------- text metrics


def normalize_answer(s: str) -> str:
    """Official SQuAD v1.1 normalization: lower, strip punctuation,
    articles, and extra whitespace."""
    s = s.lower()
    s = "".join(ch for ch in s if ch not in set(string.punctuation))
    s = re.sub(r"\b(a|an|the)\b", " ", s)
    return " ".join(s.split())


def text_exact_match(prediction: str, ground_truth: str) -> float:
    return float(normalize_answer(prediction) == normalize_answer(ground_truth))


def text_f1(prediction: str, ground_truth: str) -> float:
    pred_toks = normalize_answer(prediction).split()
    gold_toks = normalize_answer(ground_truth).split()
    if not pred_toks or not gold_toks:
        return float(pred_toks == gold_toks)
    common = collections.Counter(pred_toks) & collections.Counter(gold_toks)
    overlap = sum(common.values())
    if overlap == 0:
        return 0.0
    precision = overlap / len(pred_toks)
    recall = overlap / len(gold_toks)
    return 2 * precision * recall / (precision + recall)


def metric_max_over_ground_truths(metric_fn, prediction: str,
                                  ground_truths: Sequence[str]) -> float:
    """SQuAD rule: score against every annotated answer, keep the best."""
    return max(metric_fn(prediction, gt) for gt in ground_truths)


# ------------------------------------------------------------- span metrics


def best_spans(start_logits, end_logits, attention_mask=None,
               max_answer_len: int = 30) -> Tuple[np.ndarray, np.ndarray]:
    """Batch argmax over valid (start, end) pairs.

    start_logits/end_logits: [B, T] (tensors or arrays); attention_mask:
    optional [B, T] (0 = padding, excluded).  Valid pairs satisfy start <=
    end and end - start < max_answer_len.  Returns (starts, ends) int numpy
    arrays [B]; ties go to the first pair in row-major order, as in the
    JAX package's ``argmax``."""
    sl = torch.as_tensor(start_logits).float()
    el = torch.as_tensor(end_logits, device=sl.device).float()
    if attention_mask is not None:
        valid = torch.as_tensor(attention_mask, device=sl.device) > 0
        sl = torch.where(valid, sl, torch.full_like(sl, -1e9))
        el = torch.where(valid, el, torch.full_like(el, -1e9))
    T = sl.shape[-1]
    scores = sl[:, :, None] + el[:, None, :]          # [B, S, E]
    s_idx = torch.arange(T, device=sl.device)[:, None]
    e_idx = torch.arange(T, device=sl.device)[None, :]
    band = (e_idx >= s_idx) & (e_idx - s_idx < max_answer_len)
    scores = torch.where(band[None], scores,
                         torch.full_like(scores, -float("inf")))
    flat = torch.argmax(scores.reshape(scores.shape[0], -1), dim=-1)
    flat = flat.cpu().numpy()
    return flat // T, flat % T


def make_span_predictor(model):
    """``predict(ids, attn, tt) -> (start_logits, end_logits)`` of a span
    model (``BertForQuestionAnswering``) without autograd; the inputs go
    to the model's device."""
    device = next(model.parameters()).device

    @torch.no_grad()
    def predict(ids, attn, tt):
        args = (torch.as_tensor(np.asarray(x)).to(device)
                for x in (ids, attn, tt))
        return model.span_logits(*args)
    return predict


def span_exact_match(pred_span: Tuple[int, int],
                     gold_span: Tuple[int, int]) -> float:
    return float(tuple(pred_span) == tuple(gold_span))


def span_f1(pred_span: Tuple[int, int], gold_span: Tuple[int, int]) -> float:
    """Token-overlap F1 between two inclusive [start, end] position spans."""
    ps, pe = int(pred_span[0]), int(pred_span[1])
    gs, ge = int(gold_span[0]), int(gold_span[1])
    overlap = max(0, min(pe, ge) - max(ps, gs) + 1)
    if overlap == 0:
        return 0.0
    precision = overlap / (pe - ps + 1)
    recall = overlap / (ge - gs + 1)
    return 2 * precision * recall / (precision + recall)


def evaluate_spans(pred_starts, pred_ends, gold_starts, gold_ends) -> dict:
    """Aggregate position-span EM/F1 as percentages (SQuAD convention)."""
    em, f1, n = 0.0, 0.0, 0
    for ps, pe, gs, ge in zip(np.asarray(pred_starts), np.asarray(pred_ends),
                              np.asarray(gold_starts), np.asarray(gold_ends)):
        em += span_exact_match((ps, pe), (gs, ge))
        f1 += span_f1((ps, pe), (gs, ge))
        n += 1
    return {"exact_match": 100.0 * em / max(n, 1),
            "f1": 100.0 * f1 / max(n, 1), "total": n}
