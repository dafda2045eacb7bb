"""Native METEOR: exact, Porter-stem and synonym matcher stages
(counterpart of ``acvae_tpu/evaluation/meteor.py``).

The METEOR algorithm (Banerjee & Lavie 2005; Lavie & Agarwal 2007) with
METEOR-1.0's English parameters: Fmean = 10PR/(R + 9P), penalty =
0.5·(chunks/matches)³, score = Fmean·(1 − penalty); a segment scores its
best reference, the corpus the mean of its segments.  Stems come from the
port's Porter stemmer (NLTK's default mode), synonyms from the bundled
table (``synonyms.py``).  The JAX package's ``ACVAE_METEOR_SYNONYMS=0``
switch, which drops the synonym stage, is not ported: the stage always runs.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

from acvae_tpu_torch.evaluation.porter import stem
from acvae_tpu_torch.evaluation.synonyms import WORD2GROUP


def _syn_keys(tokens: Sequence[str], tag: str) -> List[str]:
    """Each token's synonym-group key; a word outside the table gets a
    position-unique key that matches nothing."""
    return [f"g{WORD2GROUP[t]}" if t in WORD2GROUP else f"{tag}{i}"
            for i, t in enumerate(tokens)]


def _align(hyp: Sequence[str], ref: Sequence[str]) -> List[Tuple[int, int]]:
    """Greedy staged alignment (exact, stem, synonym) between unmatched
    unigrams.  Within a stage, each hyp position takes the unmatched ref
    position closest to continuing the previous chunk — the tie-break the
    official aligner optimizes for (fewest chunks)."""
    stages = [(hyp, ref), ([stem(t) for t in hyp], [stem(t) for t in ref]),
              (_syn_keys(hyp, "h"), _syn_keys(ref, "r"))]
    matched_h: Dict[int, int] = {}
    used_r = set()
    for keyed_h, keyed_r in stages:
        prev_r = -1
        for i in range(len(hyp)):
            if i in matched_h:
                prev_r = matched_h[i]
                continue
            cands = [j for j in range(len(ref))
                     if j not in used_r and keyed_r[j] == keyed_h[i]]
            if not cands:
                continue
            j = min(cands, key=lambda j: (abs(j - (prev_r + 1)), j))
            matched_h[i] = j
            used_r.add(j)
            prev_r = j
    return sorted(matched_h.items())


def _chunks(pairs: List[Tuple[int, int]]) -> int:
    ch = 0
    prev = None
    for i, j in pairs:
        if prev is None or i != prev[0] + 1 or j != prev[1] + 1:
            ch += 1
        prev = (i, j)
    return ch


def sentence_meteor(hyp: str, refs: Sequence[str]) -> float:
    """METEOR of one hypothesis against its references (max over refs)."""
    h = hyp.lower().split()
    best = 0.0
    for ref in refs:
        r = ref.lower().split()
        if not h or not r:
            continue
        pairs = _align(h, r)
        m = len(pairs)
        if m == 0:
            continue
        p, rec = m / len(h), m / len(r)
        fmean = 10.0 * p * rec / (rec + 9.0 * p)
        penalty = 0.5 * (_chunks(pairs) / m) ** 3
        best = max(best, fmean * (1.0 - penalty))
    return best


def meteor_score(key2refs: Dict[str, List[str]],
                 key2pred: Dict[str, List[str]]) -> Tuple[float, List[float]]:
    """(corpus mean, per-key scores) in pycocoevalcap compute_score shape."""
    scores = [sentence_meteor(key2pred[k][0], key2refs[k])
              for k in key2pred]
    return (sum(scores) / len(scores) if scores else 0.0), scores
