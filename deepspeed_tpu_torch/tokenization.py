"""Self-contained BERT-style wordpiece tokenization: trainer and tokenizer.

The port's copy of ``deepspeed_tpu/tokenization.py`` (pure Python, the
standard library only), so both packages tokenize, build vocabularies and
mask pretraining data identically:

* ``BasicTokenizer``: BERT's pre-tokenization (whitespace split,
  punctuation isolation, lowercasing, accent stripping) keeping every
  token's character offsets into the original text, which SQuAD span
  extraction needs.
* ``WordpieceTokenizer``: greedy longest-match-first sub-word split with
  ``##`` continuation pieces, BERT's matching rule.
* ``train_wordpiece``: a deterministic wordpiece-likelihood trainer (merge
  the pair maximising ``count(ab) / (count(a) count(b))``).
* ``Vocab``: the token-id table with BERT's special tokens and
  ``vocab.txt`` save/load.
* ``build_mlm_arrays``: masked-LM pretraining arrays from raw text.
"""

from __future__ import annotations

import collections
import unicodedata
from typing import Dict, Iterable, List, Sequence, Tuple

PAD_TOKEN = "[PAD]"
UNK_TOKEN = "[UNK]"
CLS_TOKEN = "[CLS]"
SEP_TOKEN = "[SEP]"
MASK_TOKEN = "[MASK]"
SPECIAL_TOKENS = (PAD_TOKEN, UNK_TOKEN, CLS_TOKEN, SEP_TOKEN, MASK_TOKEN)


def _is_whitespace(ch: str) -> bool:
    return ch.isspace() or unicodedata.category(ch) == "Zs"


def _is_control(ch: str) -> bool:
    return unicodedata.category(ch).startswith("C") and ch not in "\t\n\r"


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    # BERT rule: ASCII non-alnum blocks count as punctuation too ($, ~)
    if (33 <= cp <= 47 or 58 <= cp <= 64 or 91 <= cp <= 96
            or 123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def normalize_word(word: str, do_lower_case: bool = True) -> str:
    """Lowercase + strip combining accents (BERT's run_strip_accents)."""
    if do_lower_case:
        word = word.lower()
    out = []
    for ch in unicodedata.normalize("NFD", word):
        if unicodedata.category(ch) != "Mn":
            out.append(ch)
    return "".join(out)


class BasicTokenizer:
    """Whitespace + punctuation pre-tokenizer with original-text offsets.

    ``tokenize_with_offsets(text)`` returns ``(tokens, spans)`` where
    ``spans[i] = (start, end)`` indexes the ORIGINAL string such that
    ``text[start:end]`` is the surface form of token ``i`` (tokens
    themselves are normalized — lowercased, accents stripped)."""

    def __init__(self, do_lower_case: bool = True):
        self.do_lower_case = do_lower_case

    def tokenize_with_offsets(self, text: str):
        tokens: List[str] = []
        spans: List[Tuple[int, int]] = []
        start = None
        for i, ch in enumerate(text):
            if _is_whitespace(ch) or _is_control(ch):
                if start is not None:
                    tokens.append(text[start:i])
                    spans.append((start, i))
                    start = None
            elif _is_punctuation(ch):
                if start is not None:
                    tokens.append(text[start:i])
                    spans.append((start, i))
                    start = None
                tokens.append(ch)
                spans.append((i, i + 1))
            else:
                if start is None:
                    start = i
        if start is not None:
            tokens.append(text[start:])
            spans.append((start, len(text)))
        tokens = [normalize_word(t, self.do_lower_case) for t in tokens]
        return tokens, spans

    def tokenize(self, text: str) -> List[str]:
        return self.tokenize_with_offsets(text)[0]


class WordpieceTokenizer:
    """Greedy longest-match-first wordpiece split (BERT semantics).

    A word→pieces memo backs ``tokenize``: natural text is Zipf
    distributed, so corpus featurization hits the cache for the vast
    majority of calls.  (A ctypes C matcher was measured and rejected:
    per-word Python↔C marshalling costs ~4× more than the dict-lookup
    match loop it replaces, even batched.)"""

    def __init__(self, vocab: Dict[str, int], unk_token: str = UNK_TOKEN,
                 max_input_chars_per_word: int = 100,
                 cache_size: int = 1 << 17):
        self.vocab = vocab
        self.unk_token = unk_token
        self.max_input_chars_per_word = max_input_chars_per_word
        self._cache: Dict[str, Tuple[str, ...]] = {}
        self._cache_size = cache_size

    def tokenize(self, word: str) -> List[str]:
        hit = self._cache.get(word)
        if hit is not None:
            return list(hit)
        if len(word) > self.max_input_chars_per_word or not word:
            return [self.unk_token]
        pieces: List[str] = []
        lo = 0
        while lo < len(word):
            hi = len(word)
            piece = None
            while lo < hi:
                sub = word[lo:hi]
                if lo > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    piece = sub
                    break
                hi -= 1
            if piece is None:
                pieces = [self.unk_token]
                break
            pieces.append(piece)
            lo = hi
        if len(self._cache) < self._cache_size:
            self._cache[word] = tuple(pieces)
        return pieces


class Vocab:
    """token↔id table; ids are dense, specials first (vocab.txt order)."""

    def __init__(self, tokens: Sequence[str]):
        self.id_to_token = list(tokens)
        self.token_to_id = {t: i for i, t in enumerate(self.id_to_token)}
        if len(self.token_to_id) != len(self.id_to_token):
            raise ValueError("duplicate tokens in vocabulary")

    def __len__(self):
        return len(self.id_to_token)

    def __contains__(self, tok):
        return tok in self.token_to_id

    def id(self, tok: str) -> int:
        return self.token_to_id.get(tok, self.token_to_id[UNK_TOKEN])

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            for tok in self.id_to_token:
                f.write(tok + "\n")

    @classmethod
    def load(cls, path: str) -> "Vocab":
        with open(path) as f:
            return cls([line.rstrip("\n") for line in f if line.strip()])


class BertTokenizer:
    """The full BERT pipeline: basic split → wordpiece, id encoding, and
    offset-preserving tokenization for span tasks."""

    def __init__(self, vocab: Vocab, do_lower_case: bool = True):
        self.vocab = vocab
        self.basic = BasicTokenizer(do_lower_case)
        self.wordpiece = WordpieceTokenizer(vocab.token_to_id)

    def tokenize_with_offsets(self, text: str):
        """(pieces, spans): wordpiece tokens with (start, end) character
        offsets into ``text``.  Sub-word offsets are exact when
        normalization preserves length (all of ASCII); for words it
        shortens (stripped accents) offsets are clamped to the word."""
        words, wspans = self.basic.tokenize_with_offsets(text)
        pieces, spans = [], []
        for word, (ws, we) in zip(words, wspans):
            subs = self.wordpiece.tokenize(word)
            off = 0
            for sub in subs:
                n = len(sub) - 2 if sub.startswith("##") else len(sub)
                if sub == UNK_TOKEN:
                    n = we - ws - off
                lo = min(ws + off, we)
                hi = min(lo + n, we)
                pieces.append(sub)
                spans.append((lo, hi))
                off += n
        return pieces, spans

    def tokenize(self, text: str) -> List[str]:
        return self.tokenize_with_offsets(text)[0]

    def encode(self, text: str) -> List[int]:
        return [self.vocab.id(t) for t in self.tokenize(text)]

    @property
    def pad_id(self):
        return self.vocab.id(PAD_TOKEN)

    @property
    def cls_id(self):
        return self.vocab.id(CLS_TOKEN)

    @property
    def sep_id(self):
        return self.vocab.id(SEP_TOKEN)


# ------------------------------------------------------------------ training

def train_wordpiece(texts: Iterable[str], vocab_size: int,
                    do_lower_case: bool = True,
                    min_pair_count: int = 2) -> Vocab:
    """Train a wordpiece vocabulary from raw text, deterministically.

    Classic wordpiece objective: starting from characters (continuations
    prefixed ``##``), repeatedly merge the adjacent symbol pair with the
    highest likelihood score ``count(ab) / (count(a) · count(b))`` until
    ``vocab_size`` symbols exist or no pair clears ``min_pair_count``.
    Ties break lexicographically so training is order-independent.
    """
    basic = BasicTokenizer(do_lower_case)
    word_freq: collections.Counter = collections.Counter()
    for text in texts:
        for w in basic.tokenize(text):
            if w:
                word_freq[w] += 1

    # word type → list of current symbols
    words = {w: [w[0]] + ["##" + c for c in w[1:]]
             for w in word_freq}
    alphabet = sorted({s for syms in words.values() for s in syms})
    vocab = list(SPECIAL_TOKENS) + alphabet
    have = set(vocab)

    def count_stats():
        sym_count: collections.Counter = collections.Counter()
        pair_count: collections.Counter = collections.Counter()
        for w, syms in words.items():
            f = word_freq[w]
            for s in syms:
                sym_count[s] += f
            for a, b in zip(syms, syms[1:]):
                pair_count[(a, b)] += f
        return sym_count, pair_count

    sym_count, pair_count = count_stats()
    while len(vocab) < vocab_size:
        best, best_score = None, 0.0
        for (a, b), c in pair_count.items():
            if c < min_pair_count:
                continue
            score = c / (sym_count[a] * sym_count[b])
            if (score > best_score
                    or (score == best_score and best is not None
                        and (a, b) < best)):
                best, best_score = (a, b), score
        if best is None:
            break
        a, b = best
        merged = a + b[2:] if b.startswith("##") else a + b
        if merged not in have:
            vocab.append(merged)
            have.add(merged)
        # rewrite affected word types, update counts incrementally
        for w, syms in words.items():
            if a not in syms:
                continue
            f = word_freq[w]
            i, out, changed = 0, [], False
            while i < len(syms):
                if (i + 1 < len(syms) and syms[i] == a
                        and syms[i + 1] == b):
                    out.append(merged)
                    i += 2
                    changed = True
                else:
                    out.append(syms[i])
                    i += 1
            if not changed:
                continue
            for s in syms:
                sym_count[s] -= f
            for pa, pb in zip(syms, syms[1:]):
                pair_count[(pa, pb)] -= f
            for s in out:
                sym_count[s] += f
            for pa, pb in zip(out, out[1:]):
                pair_count[(pa, pb)] += f
            words[w] = out
    return Vocab(vocab[:vocab_size] if len(vocab) > vocab_size else vocab)


# --------------------------------------------------------- MLM pretrain data

def build_mlm_arrays(texts: Iterable[str], tokenizer: BertTokenizer,
                     seq_len: int = 128, max_predictions: int = 20,
                     masked_lm_prob: float = 0.15, seed: int = 0,
                     n_samples: int = None):
    """Pre-tokenized BERT masked-LM pretraining arrays from raw text — the
    bing_bert data-pipeline analog (reference `bert-pretraining.md` data
    section), producing exactly the 6-field batch format
    ``BertForPreTraining`` consumes:

    ``(input_ids, input_mask, token_type_ids, masked_positions,
    masked_ids, masked_weights)``, each ``[N, ...]`` int32/float32.

    Documents tokenize once, pack greedily into ``seq_len``-2 windows
    ([CLS] ... [SEP]), and mask with the published 80/10/10 recipe (mask /
    random / keep) at ``masked_lm_prob`` capped at ``max_predictions``.
    Save with ``deepspeed_tpu_torch.data.FileDataset.save(dir, **fields)``
    for the memmap-backed file path."""
    import numpy as np
    rng = np.random.default_rng(seed)
    cls_id, sep_id = tokenizer.cls_id, tokenizer.sep_id
    mask_id = tokenizer.vocab.id(MASK_TOKEN)
    vocab_size = len(tokenizer.vocab)

    # tokenize + pack
    body = seq_len - 2
    stream: List[int] = []
    windows = []
    for text in texts:
        ids = tokenizer.encode(text)
        stream.extend(ids)
        while len(stream) >= body:
            windows.append(stream[:body])
            stream = stream[body:]
            if n_samples is not None and len(windows) >= n_samples:
                break
        if n_samples is not None and len(windows) >= n_samples:
            break
    if stream and (n_samples is None or len(windows) < n_samples):
        windows.append(stream)

    N = len(windows)
    input_ids = np.zeros((N, seq_len), np.int32)
    input_mask = np.zeros((N, seq_len), np.int32)
    token_type = np.zeros((N, seq_len), np.int32)
    positions = np.zeros((N, max_predictions), np.int32)
    masked_ids = np.zeros((N, max_predictions), np.int32)
    weights = np.zeros((N, max_predictions), np.float32)

    for i, win in enumerate(windows):
        toks = [cls_id] + list(win) + [sep_id]
        L = len(toks)
        input_ids[i, :L] = toks
        input_mask[i, :L] = 1
        # candidate positions exclude [CLS]/[SEP]
        cand = np.arange(1, L - 1)
        n_pred = min(max_predictions,
                     max(1, int(round(len(cand) * masked_lm_prob))))
        picked = rng.choice(cand, size=min(n_pred, len(cand)),
                            replace=False)
        picked.sort()
        for j, pos in enumerate(picked):
            positions[i, j] = pos
            masked_ids[i, j] = input_ids[i, pos]
            weights[i, j] = 1.0
            r = rng.random()
            if r < 0.8:
                input_ids[i, pos] = mask_id
            elif r < 0.9:
                input_ids[i, pos] = rng.integers(0, vocab_size)
            # else: keep the original token
    return {"input_ids": input_ids, "input_mask": input_mask,
            "token_type_ids": token_type, "masked_positions": positions,
            "masked_ids": masked_ids, "masked_weights": weights}
