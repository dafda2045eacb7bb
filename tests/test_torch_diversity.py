"""Port parity: the diversity metrics (``acvae_tpu_torch/evaluation/
diversity.py``, ``human_eval.py``) against ``acvae_tpu.evaluation``, and the
port's sentence BLEU against nltk's ``sentence_bleu`` with
``SmoothingFunction().method1`` (which the JAX package's ``self_bleu``
calls), each within 1e-12 on seeded caption sets.
"""
import math

import numpy as np
import pytest
from nltk.translate.bleu_score import SmoothingFunction
from nltk.translate.bleu_score import sentence_bleu as nltk_sentence_bleu

from acvae_tpu.evaluation import diversity as jdiv
from acvae_tpu.evaluation import human_eval as jhuman
from acvae_tpu_torch.evaluation import diversity as tdiv
from acvae_tpu_torch.evaluation import human_eval as thuman

WORDS = [f"w{i}" for i in range(12)]


def _sentence(rng, lo=1, hi=10, words=WORDS):
    return [words[i] for i in rng.integers(0, len(words), rng.integers(lo, hi + 1))]


def bleu_sets(seed, n):
    """(references, hypothesis) sets: short hypotheses (0-3 tokens), sets
    with no overlap at all (the hypothesis from other words), and plain
    ones over a small vocabulary (many clipped matches)."""
    rng = np.random.default_rng(seed)
    other = [f"x{i}" for i in range(6)]
    sets = []
    for i in range(n):
        refs = [_sentence(rng, 1, 12) for _ in range(rng.integers(1, 5))]
        kind = i % 4
        if kind == 0:
            hyp = _sentence(rng, 0, 3)
        elif kind == 1:
            hyp = _sentence(rng, 1, 10, other)
        else:
            hyp = _sentence(rng, 1, 14)
        sets.append((refs, hyp))
    return sets


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_sentence_bleu_matches_nltk(seed):
    smoother = SmoothingFunction().method1
    sets = bleu_sets(seed, 60)
    for refs, hyp in sets:
        ref = nltk_sentence_bleu(refs, hyp, smoothing_function=smoother)
        out = tdiv.sentence_bleu(refs, hyp)
        assert abs(out - ref) <= 1e-12, (refs, hyp, out, ref)
    # the sets reach every branch: zero, smoothed and plain scores
    scores = [tdiv.sentence_bleu(r, h) for r, h in sets]
    assert 0 in scores and any(0 < s < 1 for s in scores)
    assert any(len(h) < 4 and s > 0 for (_, h), s in zip(sets, scores))


def caption_sets(seed, ragged=False):
    """audio_id -> candidate captions (token strings)."""
    rng = np.random.default_rng(seed)
    out = {}
    for k in range(7):
        n = int(rng.integers(2, 6)) if ragged else 5
        out[f"a{k}"] = [" ".join(_sentence(rng, 1, 11)) for _ in range(n)]
    out["a0"][1] = out["a0"][0]              # a repeated candidate
    return out


def _close(a, b):
    if isinstance(a, float) and math.isnan(a):
        return isinstance(b, float) and math.isnan(b)
    return abs(a - b) <= 1e-12


@pytest.mark.parametrize("seed,ragged", [(0, False), (1, True), (2, False)])
def test_diversity_functions_match_jax(seed, ragged):
    caps = caption_sets(seed, ragged)
    flat = [c for v in caps.values() for c in v]
    for n in (1, 2):
        m, arr = tdiv.compute_div_n(caps, n)
        jm, jarr = jdiv.compute_div_n(caps, n)
        assert _close(m, jm) and np.abs(arr - jarr).max() <= 1e-12
        assert _close(tdiv.compute_global_div_n(caps, n),
                      jdiv.compute_global_div_n(caps, n))
    ours, ref = tdiv.eval_div_stats(caps), jdiv.eval_div_stats(caps)
    assert list(ours) == list(ref)
    assert all(_close(ours[k], ref[k]) for k in ref), (ours, ref)
    assert _close(tdiv.self_bleu(flat), jdiv.self_bleu(flat))
    train = flat[::3] + ["w1 w2 w3"]
    assert _close(tdiv.novelty(flat, train), jdiv.novelty(flat, train))
    assert tdiv.novelty([], train) == jdiv.novelty([], train) == 0
    assert _close(tdiv.ngram_richness(flat + [""]), jdiv.ngram_richness(flat + [""]))


def test_single_candidate_gives_nan_mbleu():
    caps = {k: v[:1] for k, v in caption_sets(3).items()}
    ours, ref = tdiv.eval_div_stats(caps), jdiv.eval_div_stats(caps)
    assert all(_close(ours[k], ref[k]) for k in ref)
    assert math.isnan(ours["mBLeu_1"])


@pytest.mark.parametrize("seed", [4, 5])
def test_human_eval_matches_jax(seed):
    refs = caption_sets(seed, ragged=seed == 5)
    for fn in ("human_scores", "human_diversity"):
        ours, ref = getattr(thuman, fn)(refs), getattr(jhuman, fn)(refs)
        assert list(ours) == list(ref)
        assert all(_close(ours[k], ref[k]) for k in ref), (fn, ours, ref)


@pytest.mark.parametrize("n_words", [3, 12])
def test_self_bleu_matches_jax(n_words):
    """The linear-time leave-one-out against nltk's per-sentence BLEU (the
    JAX package's): repeated sentences, empty ones, a tiny vocabulary (many
    n-grams held by several sentences at the top count)."""
    rng = np.random.default_rng(n_words)
    words = WORDS[:n_words]
    sents = [" ".join(_sentence(rng, 0, 9, words)) for _ in range(60)]
    sents[5] = sents[6] = sents[7]
    sents[9] = ""
    assert abs(tdiv.self_bleu(sents) - jdiv.self_bleu(sents)) <= 1e-12
