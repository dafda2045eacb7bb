"""Port parity: ``acvae_tpu_torch.evaluation`` (BLEU, ROUGE-L, CIDEr-D,
METEOR, SPICE, ``score_captions`` and the Porter stemmer) against
``acvae_tpu.evaluation`` and NLTK.  Every comparison is exact (``==`` on
floats)."""
import re

import numpy as np
import pytest
from nltk.stem.porter import PorterStemmer

import acvae_tpu.evaluation.spice as jspice
from acvae_tpu.data.synthetic import (make_synthetic_clotho,
                                      make_synthetic_clotho_rich)
from acvae_tpu.evaluation import coco as jcoco
from acvae_tpu.evaluation.meteor import meteor_score as j_meteor
from acvae_tpu.evaluation.synonyms import SYNONYM_GROUPS as J_GROUPS
from acvae_tpu_torch.evaluation import coco as tcoco
from acvae_tpu_torch.evaluation.meteor import meteor_score
from acvae_tpu_torch.evaluation.porter import stem
from acvae_tpu_torch.evaluation.spice import SpiceScorer, parse_scene_graph
from acvae_tpu_torch.evaluation.synonyms import SYNONYM_GROUPS, WORD2GROUP


def _perturb(tokens, rng, vocab):
    """Drop, substitute, repeat or swap some words of a reference."""
    out = []
    for w in tokens:
        r = rng.random()
        if r < 0.1:
            continue
        if r < 0.2:
            w = vocab[rng.integers(len(vocab))]
        out.append(w)
        if rng.random() < 0.05:
            out.append(w)
    if len(out) > 2 and rng.random() < 0.3:
        i = int(rng.integers(len(out) - 1))
        out[i], out[i + 1] = out[i + 1], out[i]
    return out


@pytest.fixture(scope="module")
def refs_preds():
    """The rich corpus's references (200 clips), and a prediction per clip
    made from one of its references by random edits; one empty."""
    _, info, vocab = make_synthetic_clotho_rich(num_audios=200, seed=11)
    words = [w for w in vocab.word2idx if not w.startswith("<")]
    rng = np.random.default_rng(3)
    refs = {a["audio_id"]: [c["tokens"] for c in a["captions"]] for a in info}
    preds = {k: [" ".join(_perturb(r[rng.integers(len(r))].split(), rng, words))]
             for k, r in refs.items()}
    preds[next(iter(preds))] = [""]
    return refs, preds


SCORERS = {
    "bleu": (lambda: tcoco.BleuScorer(4).compute_score,
             lambda: jcoco.BleuScorer(4).compute_score),
    "rouge": (lambda: tcoco.RougeScorer().compute_score,
              lambda: jcoco.RougeScorer().compute_score),
    "cider": (lambda: tcoco.CiderScorer().compute_score,
              lambda: jcoco.CiderScorer().compute_score),
    "meteor": (lambda: meteor_score, lambda: j_meteor),
    "spice": (lambda: SpiceScorer().compute_score,
              lambda: jspice.SpiceScorer().compute_score),
}


@pytest.mark.parametrize("name", SCORERS)
def test_scorer_matches_jax(refs_preds, name):
    """Corpus score and every segment's score, exactly."""
    refs, preds = refs_preds
    ours, ref = (f()(refs, preds) for f in SCORERS[name])
    assert ours == ref
    per_segment = ours[1][0] if name == "bleu" else ours[1]
    assert len(per_segment) == len(refs) and 0 < np.mean(per_segment) < 10


@pytest.mark.parametrize("zh", [False, True], ids=["en", "zh"])
def test_score_captions_matches_jax(refs_preds, zh):
    """The table, including ``_native_scorers`` (JAX's mark when Java is
    absent: its Java backends are not installed here); raw text with case
    and punctuation is normalised alike."""
    refs, preds = refs_preds
    refs = dict(refs, extra=["A Dog, barking!", "the DOG barks."])
    preds = dict(preds, extra=["a dog (barking)"])
    ours = tcoco.score_captions(refs, preds, zh=zh)
    ref = jcoco.score_captions(refs, preds, zh=zh)
    assert ours == ref and list(ours) == list(ref)
    assert ("_native_scorers" in ours) == (not zh)
    if not zh:
        assert ours["_native_scorers"] == ["METEOR", "SPICE"]


def test_synonym_table_is_jax_s():
    assert SYNONYM_GROUPS == J_GROUPS
    for gid, group in enumerate(SYNONYM_GROUPS):
        for w in group:
            assert WORD2GROUP[w] <= gid


def test_scene_graphs_match_jax(refs_preds):
    refs, _ = refs_preds
    sentences = [r for rs in refs.values() for r in rs][:400] + [
        "a man speaks followed by a dog barking loudly in the distance",
        "the music is loud and people are not talking",
        "birds chirp while water drips into a metal bucket"]
    for s in sentences:
        assert parse_scene_graph(s.split()) == jspice.parse_scene_graph(s.split())


# --------------------------------------------------------------------- #
# the Porter stemmer against NLTK's PorterStemmer() (NLTK_EXTENSIONS)
# --------------------------------------------------------------------- #
def _corpus_words():
    words = set()
    for gen in (make_synthetic_clotho, make_synthetic_clotho_rich):
        _, info, vocab = gen(num_audios=300, seed=0)
        words |= {w for w in vocab.word2idx if not w.startswith("<")}
    return words


def _scorer_words():
    words = {w for g in J_GROUPS for w in g}
    for name in ("_DETERMINERS", "_PREPOSITIONS", "_CLAUSE_BREAKS",
                 "_AUXILIARIES", "_NEGATIONS", "_VERB_STEMS",
                 "_PASSIVE_CONNECTORS", "_ING_NOUNS"):
        words |= getattr(jspice, name)
    return words


def _english_words():
    """Distinct lowercase words of the Python standard library's help
    topics (``pydoc_data.topics``, the text of the language reference's
    help pages; about 3,200 words)."""
    import pydoc_data.topics
    text = " ".join(pydoc_data.topics.topics.values()).lower()
    return set(re.findall(r"[a-z]+", text))


EDGE_WORDS = [
    "skies", "sky", "dying", "lying", "tying", "news", "innings", "outings",
    "cannings", "howe", "proceed", "exceed", "succeed", "dies", "ties",
    "died", "spied", "flies", "happy", "enjoy", "spy", "relational",
    "conditional", "generalli", "beautifulli", "geologi", "archaeologi",
    "controll", "roll", "feed", "agreed", "bled", "motoring", "sing",
    "conflated", "troubled", "sized", "hopping", "tanned", "falling",
    "hissing", "fizzed", "failing", "filing", "syzygy", "toy", "yyyy", "y",
    "by", "ay", "at", "Caresses", "PONIES", "Outing", "oaten", "orrery",
    "abilities", "vietnamization", "hopefulness", "callousness",
    "sensibiliti", "triplicate", "electriciti", "adoption", "homologou",
    "effective", "bowdlerize", "probate", "rate", "cease", "ed", "ing",
    "eed", "ies", "sses", "ss", "s", "",
]


@pytest.mark.parametrize("source", ["corpora", "scorers", "english", "edges"])
def test_porter_stemmer_matches_nltk(source):
    words = {"corpora": _corpus_words, "scorers": _scorer_words,
             "english": _english_words, "edges": lambda: set(EDGE_WORDS)}[source]()
    if source == "english":
        assert len(words - _corpus_words() - _scorer_words()) >= 2000
    nltk_stem = PorterStemmer().stem
    bad = [(w, stem(w), nltk_stem(w)) for w in sorted(words)
           if stem(w) != nltk_stem(w)]
    assert not bad, bad[:20]
