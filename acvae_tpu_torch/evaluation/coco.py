"""Caption metrics: pure-Python ports of the COCO evaluation math
(counterpart of ``acvae_tpu/evaluation/coco.py``).

* :class:`BleuScorer`: corpus BLEU-1..4 with the COCO "closest" reference
  length brevity penalty and its tiny/small epsilons;
* :class:`CiderScorer`: CIDEr-D, clipped TF-IDF n-gram cosine with a
  Gaussian length penalty (sigma 6), document frequencies from the refs;
* :class:`RougeScorer`: ROUGE-L F-measure (beta 1.2, max over refs);
* METEOR and SPICE from the native scorers (``meteor.py``, ``spice.py``):
  the JAX package tries pycocoevalcap's Java backends first and falls back
  to the same native scorers when Java is absent, which is the only route
  here.  ``score_captions`` marks them in ``_native_scorers`` as JAX does.
"""
from __future__ import annotations

import math
from collections import Counter, defaultdict
from typing import Dict, List, Optional, Sequence, Tuple


def _ngrams(tokens: Sequence[str], n: int) -> Counter:
    return Counter(tuple(tokens[i:i + n]) for i in range(len(tokens) - n + 1))


class BleuScorer:
    """Corpus BLEU-1..4 (pycocoevalcap bleu_scorer semantics)."""

    def __init__(self, n: int = 4):
        self.n = n

    def compute_score(self, gts: Dict[str, List[str]],
                      res: Dict[str, List[str]]
                      ) -> Tuple[List[float], List[List[float]]]:
        small, tiny = 1e-9, 1e-15
        n = self.n
        total_correct = [0] * n
        total_guess = [0] * n
        total_testlen = 0
        total_reflen = 0
        per_sent: List[List[float]] = [[] for _ in range(n)]

        for key in gts:
            hyp = res[key][0].split()
            refs = [r.split() for r in gts[key]]
            testlen = len(hyp)
            # closest reference length (ties -> shorter)
            reflen = min((abs(len(r) - testlen), len(r)) for r in refs)[1]
            correct, guess = [], []
            for k in range(1, n + 1):
                hyp_ng = _ngrams(hyp, k)
                max_ref = Counter()
                for r in refs:
                    for ng, c in _ngrams(r, k).items():
                        max_ref[ng] = max(max_ref[ng], c)
                correct.append(sum(min(c, max_ref[ng]) for ng, c in hyp_ng.items()))
                guess.append(max(0, testlen - k + 1))

            total_testlen += testlen
            total_reflen += reflen
            for k in range(n):
                total_correct[k] += correct[k]
                total_guess[k] += guess[k]

            # per-sentence scores (with own brevity penalty)
            for k in range(n):
                bleu = 1.0
                for m in range(k + 1):
                    bleu *= (correct[m] + tiny) / (guess[m] + small)
                bleu = bleu ** (1.0 / (k + 1))
                ratio = (testlen + tiny) / (reflen + small)
                if ratio < 1:
                    bleu *= math.exp(1 - 1 / ratio)
                per_sent[k].append(bleu)

        scores = []
        for k in range(n):
            bleu = 1.0
            for m in range(k + 1):
                bleu *= (total_correct[m] + tiny) / (total_guess[m] + small)
            bleu = bleu ** (1.0 / (k + 1))
            ratio = (total_testlen + tiny) / (total_reflen + small)
            if ratio < 1:
                bleu *= math.exp(1 - 1 / ratio)
            scores.append(bleu)
        return scores, per_sent


class CiderScorer:
    """CIDEr-D (pycocoevalcap cider_scorer semantics), sigma=6."""

    def __init__(self, n: int = 4, sigma: float = 6.0):
        self.n = n
        self.sigma = sigma

    def compute_score(self, gts: Dict[str, List[str]],
                      res: Dict[str, List[str]]
                      ) -> Tuple[float, List[float]]:
        keys = list(gts.keys())
        crefs = [[_counts(r.split(), self.n) for r in gts[k]] for k in keys]
        ctest = [_counts(res[k][0].split(), self.n) for k in keys]

        # document frequency over the evaluation references
        df: Dict[tuple, float] = defaultdict(float)
        for refs in crefs:
            seen = set(ng for ref in refs for ng in ref)
            for ng in seen:
                df[ng] += 1
        log_n_images = math.log(float(len(crefs)))

        def counts2vec(cnts):
            vec = [defaultdict(float) for _ in range(self.n)]
            norm = [0.0] * self.n
            length = 0
            for ng, term_freq in cnts.items():
                idf = log_n_images - math.log(max(1.0, df[ng]))
                k = len(ng) - 1
                vec[k][ng] = float(term_freq) * idf
                norm[k] += vec[k][ng] ** 2
                if k == 0:
                    length += term_freq
            return vec, [math.sqrt(x) for x in norm], length

        def sim(vh, nh, lh, vr, nr, lr):
            delta = float(lh - lr)
            val = [0.0] * self.n
            for k in range(self.n):
                for ng, w in vh[k].items():
                    # CIDEr-D: clip hypothesis tf-idf to the reference's
                    val[k] += min(w, vr[k].get(ng, 0.0)) * vr[k].get(ng, 0.0)
                if nh[k] != 0 and nr[k] != 0:
                    val[k] /= nh[k] * nr[k]
                val[k] *= math.exp(-delta ** 2 / (2 * self.sigma ** 2))
            return val

        scores = []
        for test, refs in zip(ctest, crefs):
            vh, nh, lh = counts2vec(test)
            score = [0.0] * self.n
            for ref in refs:
                vr, nr, lr = counts2vec(ref)
                s = sim(vh, nh, lh, vr, nr, lr)
                for k in range(self.n):
                    score[k] += s[k]
            score_avg = sum(score) / self.n / len(refs) * 10.0
            scores.append(score_avg)
        mean = sum(scores) / len(scores) if scores else 0.0
        return mean, scores


def _counts(tokens: Sequence[str], n: int) -> Counter:
    cnt = Counter()
    for k in range(1, n + 1):
        cnt.update(tuple(tokens[i:i + k]) for i in range(len(tokens) - k + 1))
    return cnt


def _lcs_len(a: Sequence[str], b: Sequence[str]) -> int:
    if not a or not b:
        return 0
    prev = [0] * (len(b) + 1)
    for i in range(1, len(a) + 1):
        cur = [0] * (len(b) + 1)
        for j in range(1, len(b) + 1):
            if a[i - 1] == b[j - 1]:
                cur[j] = prev[j - 1] + 1
            else:
                cur[j] = max(prev[j], cur[j - 1])
        prev = cur
    return prev[-1]


class RougeScorer:
    """ROUGE-L F-measure, beta=1.2 (pycocoevalcap rouge semantics)."""
    beta = 1.2

    def compute_score(self, gts: Dict[str, List[str]],
                      res: Dict[str, List[str]]) -> Tuple[float, List[float]]:
        scores = []
        for key in gts:
            hyp = res[key][0].split()
            prec, rec = [], []
            for ref_str in gts[key]:
                ref = ref_str.split()
                lcs = _lcs_len(hyp, ref)
                prec.append(lcs / len(hyp) if hyp else 0.0)
                rec.append(lcs / len(ref) if ref else 0.0)
            p, r = max(prec), max(rec)
            if p != 0 and r != 0:
                f = (1 + self.beta ** 2) * p * r / (r + self.beta ** 2 * p)
            else:
                f = 0.0
            scores.append(f)
        mean = sum(scores) / len(scores) if scores else 0.0
        return mean, scores


def score_captions(key2refs: Dict[str, List[str]],
                   key2pred: Dict[str, List[str]],
                   zh: bool = False) -> Dict[str, Optional[float]]:
    """The scoring table (base_runner.py:295-320): BLEU-1..4, ROUGE-L,
    CIDEr, METEOR, SPICE (both native, English only) and SPIDEr =
    (CIDEr + SPICE)/2 (CIDEr alone without SPICE).  Both sides are first
    normalised through ``data.vocab.tokenize``."""
    from acvae_tpu_torch.data.vocab import tokenize
    from acvae_tpu_torch.evaluation.meteor import meteor_score
    from acvae_tpu_torch.evaluation.spice import SpiceScorer

    def norm(d):
        return {k: [" ".join(tokenize(c, zh)) for c in caps]
                for k, caps in d.items()}

    key2refs, key2pred = norm(key2refs), norm(key2pred)
    out: Dict[str, Optional[float]] = {}
    bleu, _ = BleuScorer(4).compute_score(key2refs, key2pred)
    for i, b in enumerate(bleu):
        out[f"Bleu_{i + 1}"] = b
    out["ROUGE_L"], _ = RougeScorer().compute_score(key2refs, key2pred)
    out["CIDEr"], _ = CiderScorer().compute_score(key2refs, key2pred)
    meteor = spice = None
    if not zh:
        meteor, _ = meteor_score(key2refs, key2pred)
        spice, _ = SpiceScorer().compute_score(key2refs, key2pred)
    out["METEOR"] = meteor
    out["SPICE"] = spice
    out["SPIDEr"] = ((out["CIDEr"] + spice) / 2 if spice is not None
                     else out["CIDEr"])
    if not zh:
        # native METEOR/SPICE (and SPIDEr from native SPICE) are not
        # comparable to the Java scorers' published numbers
        out["_native_scorers"] = ["METEOR", "SPICE"]
    return out
