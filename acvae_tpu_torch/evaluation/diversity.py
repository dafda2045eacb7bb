"""Diversity metrics (counterpart of
``acvae_tpu/evaluation/diversity.py:28-132``), the paper's diversity suite:

* :func:`compute_div_n` / :func:`compute_global_div_n`: per-audio distinct-n
  ratio and corpus vocabulary size (div_utils.py:11-45);
* :func:`eval_div_stats`: Div1/Div2/gDiv1 and mBLEU, the leave-one-out
  corpus BLEU among each audio's candidates (diverse_mutil.py:17-54);
* :func:`self_bleu`: mean leave-one-out sentence BLEU with smoothing
  method 1 (diverse_mutil.py:60-77), over :func:`sentence_bleu`, the port's
  own copy of nltk's ``sentence_bleu`` with ``SmoothingFunction().method1``
  (nltk 3.10 arithmetic: precisions as clipped counts over counts, the
  brevity penalty, the 0.1 epsilon for zero counts, the ``math.fsum`` of
  weighted logs);
* :func:`novelty`: share of predictions absent from the train corpus
  (diverse_instance.py:71-96);
* :func:`ngram_richness`: the inverse-frequency score (diverse_eval.py:10-42).
"""
from __future__ import annotations

import math
from collections import Counter
from typing import Dict, Iterable, List, Sequence, Tuple

import numpy as np

from acvae_tpu_torch.evaluation.coco import BleuScorer


def _find_ngrams(tokens: Sequence[str], n: int):
    return zip(*[tokens[i:] for i in range(n)])


def compute_div_n(caps: Dict[str, List[str]], n: int = 1
                  ) -> Tuple[float, np.ndarray]:
    """Per-audio distinct-n: unique n-grams / total tokens."""
    aggr = []
    for k in caps:
        all_ngrams = set()
        total = 0.0
        for c in caps[k]:
            tkns = c.split()
            total += len(tkns)
            all_ngrams.update(_find_ngrams(tkns, n))
        aggr.append(len(all_ngrams) / (1e-6 + total))
    arr = np.array(aggr)
    return float(arr.mean()), arr


def compute_global_div_n(caps: Dict[str, List[str]], n: int = 1) -> float:
    """Corpus level: the vocabulary size for n=1, else the distinct-n
    ratio."""
    all_ngrams = set()
    total = 0.0
    for k in caps:
        for c in caps[k]:
            tkns = c.split()
            total += len(tkns)
            all_ngrams.update(_find_ngrams(tkns, n))
    if n == 1:
        return float(len(all_ngrams))
    return len(all_ngrams) / (1e-6 + total)


def eval_div_stats(caps_by_id: Dict[str, List[str]]) -> Dict[str, float]:
    """Div1/Div2/gDiv1 and mBLeu_1..4 over audio_id -> candidate captions
    (token strings).  Ragged candidate counts use the smallest; below 2
    candidates mBLEU is NaN."""
    n_caps = min(len(v) for v in caps_by_id.values())
    div1, _ = compute_div_n(caps_by_id, 1)
    div2, _ = compute_div_n(caps_by_id, 2)
    gdiv1 = compute_global_div_n(caps_by_id, 1)

    out = {"Div1": div1, "Div2": div2, "gDiv1": gdiv1}
    if n_caps < 2:
        for k in range(4):
            out[f"mBLeu_{k + 1}"] = float("nan")
        return out
    scorer = BleuScorer(4)
    all_scrs = []
    for i in range(n_caps):
        refs = {k: v[:i] + v[i + 1:n_caps] for k, v in caps_by_id.items()}
        cands = {k: [v[i]] for k, v in caps_by_id.items()}
        score, _ = scorer.compute_score(refs, cands)
        all_scrs.append(score)
    mbleu = np.array(all_scrs).mean(axis=0)
    for k in range(4):
        out[f"mBLeu_{k + 1}"] = float(mbleu[k])
    return out


def _modified_precision(references: List[List[str]], hypothesis: List[str],
                        n: int) -> Tuple[int, int]:
    """(clipped n-gram matches, hypothesis n-grams but at least 1)."""
    counts = (Counter(_find_ngrams(hypothesis, n)) if len(hypothesis) >= n
              else Counter())
    max_counts: Dict[tuple, int] = {}
    for reference in references:
        ref_counts = (Counter(_find_ngrams(reference, n))
                      if len(reference) >= n else Counter())
        for ngram in counts:
            max_counts[ngram] = max(max_counts.get(ngram, 0), ref_counts[ngram])
    numerator = sum(min(c, max_counts[g]) for g, c in counts.items())
    return numerator, max(1, sum(counts.values()))


def _bleu4(p_n: List[Tuple[int, int]], hyp_len: int, ref_len: int,
           epsilon: float = 0.1) -> float:
    """BLEU-4 from the (matches, n-grams) of orders 1-4 and the lengths."""
    if p_n[0][0] == 0:
        return 0
    if hyp_len > ref_len:
        bp = 1
    elif hyp_len == 0:
        bp = 0
    else:
        bp = math.exp(1 - ref_len / hyp_len)
    # an int over an int rounds once, as float() of nltk's Fraction does
    p = [(num + epsilon) / den if num == 0 else num / den for num, den in p_n]
    return bp * math.exp(math.fsum(0.25 * math.log(x) for x in p if x > 0))


def _closest_length(ref_lens: Iterable[int], hyp_len: int) -> int:
    """The reference length closest to the hypothesis', the shorter on a
    tie."""
    return min(ref_lens, key=lambda r: (abs(r - hyp_len), r))


def sentence_bleu(references: List[List[str]], hypothesis: List[str],
                  epsilon: float = 0.1) -> float:
    """BLEU-4 of one tokenised hypothesis against its references, with
    smoothing method 1 (``epsilon`` counts for zero matches)."""
    p_n = [_modified_precision(references, hypothesis, i) for i in range(1, 5)]
    return _bleu4(p_n, len(hypothesis),
                  _closest_length((len(r) for r in references),
                                  len(hypothesis)), epsilon)


def self_bleu(sentences: List[str]) -> float:
    """Mean leave-one-out sentence BLEU (smoothing method 1): each sentence
    against all the others.  The clipping count of an n-gram, its largest
    count in the other sentences, comes from the corpus's largest and
    second-largest counts, so the whole is linear in the corpus; the
    integers, and so the scores, are :func:`sentence_bleu`'s."""
    toks = [s.split() for s in sentences]
    counts = [[Counter(_find_ngrams(t, n)) for n in range(1, 5)] for t in toks]
    # per order: n-gram -> [largest count, sentences holding it, second]
    top: List[Dict[tuple, List[int]]] = [{} for _ in range(4)]
    for sent in counts:
        for n in range(4):
            for g, v in sent[n].items():
                t = top[n].setdefault(g, [0, 0, 0])
                if v > t[0]:
                    t[:] = [v, 1, t[0]]
                elif v == t[0]:
                    t[1] += 1
                elif v > t[2]:
                    t[2] = v
    lens = [len(t) for t in toks]
    total = 0.0
    for i, sent in enumerate(counts):
        p_n = []
        for n in range(4):
            num = 0
            for g, v in sent[n].items():
                m1, k1, m2 = top[n][g]
                num += min(v, m2 if v == m1 and k1 == 1 else m1)
            p_n.append((num, max(1, sum(sent[n].values()))))
        total += _bleu4(p_n, lens[i],
                        _closest_length(lens[:i] + lens[i + 1:], lens[i]))
    return total / len(toks)


def novelty(pred_sentences: Iterable[str],
            train_sentences: Iterable[str]) -> float:
    """Share of predictions absent from the train corpus."""
    train = set(train_sentences)
    preds = list(pred_sentences)
    novel = sum(1 for p in preds if p not in train)
    return novel / max(len(preds), 1)


def ngram_richness(captions: List[str]) -> float:
    """Inverse-frequency diversity: for n=1,2 the per-caption mean of
    1/corpus count over its n-grams, averaged."""
    scores = []
    for n in (1, 2):
        corpus: Counter = Counter()
        per_caption = []
        for c in captions:
            per_caption.append(list(_find_ngrams(c.split(), n)))
            corpus.update(per_caption[-1])
        vals = []
        for grams in per_caption:
            if not grams:
                continue
            vals.append(sum(1.0 / corpus[g] for g in grams) / len(grams))
        scores.append(np.mean(vals) if vals else 0.0)
    return float(np.mean(scores))
