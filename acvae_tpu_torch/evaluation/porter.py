"""The Porter stemmer, as NLTK's ``PorterStemmer()`` runs it in its default
``NLTK_EXTENSIONS`` mode.

The JAX package's METEOR and SPICE stem with NLTK, which the port's machine
does not have; this module gives the same stems.  The algorithm is Porter's
(1980, "An algorithm for suffix stripping", Program 14(3):130-137) with the
departures NLTK's default mode makes:

* a table of irregular forms (``skies``→``sky``, ``dying``→``die``, ...);
* words of one or two letters are returned unchanged (lowercased);
* 1a: a four-letter ``-ies`` becomes ``-ie`` (``dies``→``die``);
* 1b: ``-ied`` becomes ``-ie`` in a four-letter word, ``-i`` otherwise;
* 1c: ``y``→``i`` only after a consonant that is not the stem's only letter;
* 2: ``-alli``→``-al`` first (then step 2 again), ``-bli``→``-ble`` in
  place of ``-abli``, and the extra rules ``-fulli``→``-ful`` and
  ``-logi``→``-log`` (whose measure counts the stem with its ``l``);
* the *o condition also holds for a two-letter vowel-consonant stem.

Within a step the first rule whose suffix matches decides: if its condition
fails, the word leaves the step unchanged.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

_VOWELS = frozenset("aeiou")
_IRREGULAR = {"sky": "sky", "skies": "sky", "dying": "die", "lying": "lie",
              "tying": "tie", "news": "news", "innings": "inning",
              "inning": "inning", "outings": "outing", "outing": "outing",
              "cannings": "canning", "canning": "canning", "howe": "howe",
              "proceed": "proceed", "exceed": "exceed", "succeed": "succeed"}


def _consonants(w: str) -> List[bool]:
    """Per letter, whether it is a consonant: not a vowel, and a ``y`` only
    at the start or after a vowel."""
    out: List[bool] = []
    for i, ch in enumerate(w):
        if ch in _VOWELS:
            out.append(False)
        elif ch == "y":
            out.append(i == 0 or not out[i - 1])
        else:
            out.append(True)
    return out


def _measure(stem: str) -> int:
    """m in [C](VC)^m[V]: the number of vowel-consonant transitions."""
    c = _consonants(stem)
    return sum(1 for a, b in zip(c, c[1:]) if not a and b)


def _has_vowel(stem: str) -> bool:
    return not all(_consonants(stem))


def _double_consonant(w: str) -> bool:
    return len(w) >= 2 and w[-1] == w[-2] and _consonants(w)[-1]


def _cvc(w: str) -> bool:
    """*o: the stem ends consonant-vowel-consonant, the last not w, x or y
    (or is a vowel then a consonant, two letters long)."""
    c = _consonants(w)
    if len(w) >= 3 and c[-3] and not c[-2] and c[-1] and w[-1] not in "wxy":
        return True
    return len(w) == 2 and not c[0] and c[1]


def _m_above(k: int) -> Callable[[str], bool]:
    return lambda stem: _measure(stem) > k


Rule = Tuple[str, str, Optional[Callable[[str], bool]]]


def _first_rule(word: str, rules: Sequence[Rule]) -> str:
    for suffix, repl, cond in rules:
        if word.endswith(suffix):
            stem = word[:len(word) - len(suffix)]
            return stem + repl if cond is None or cond(stem) else word
    return word


_STEP1A = (("sses", "ss", None), ("ies", "i", None), ("ss", "ss", None),
           ("s", "", None))
_STEP2 = tuple((s, r, _m_above(0)) for s, r in (
    ("ational", "ate"), ("tional", "tion"), ("enci", "ence"), ("anci", "ance"),
    ("izer", "ize"), ("bli", "ble"), ("alli", "al"), ("entli", "ent"),
    ("eli", "e"), ("ousli", "ous"), ("ization", "ize"), ("ation", "ate"),
    ("ator", "ate"), ("alism", "al"), ("iveness", "ive"), ("fulness", "ful"),
    ("ousness", "ous"), ("aliti", "al"), ("iviti", "ive"), ("biliti", "ble"),
    ("fulli", "ful"))) + (
    # the measure of -logi counts the stem with its "l"
    ("logi", "log", lambda stem: _measure(stem + "l") > 0),)
_STEP3 = tuple((s, r, _m_above(0)) for s, r in (
    ("icate", "ic"), ("ative", ""), ("alize", "al"), ("iciti", "ic"),
    ("ical", "ic"), ("ful", ""), ("ness", "")))
_STEP4 = tuple(
    (s, "", (lambda stem: _measure(stem) > 1 and stem[-1] in "st")
     if s == "ion" else _m_above(1))
    for s in ("al", "ance", "ence", "er", "ic", "able", "ible", "ant", "ement",
              "ment", "ent", "ion", "ou", "ism", "ate", "iti", "ous", "ive",
              "ize"))


def _step1a(w: str) -> str:
    if w.endswith("ies") and len(w) == 4:
        return w[:-1]
    return _first_rule(w, _STEP1A)


def _step1b(w: str) -> str:
    if w.endswith("ied"):
        return w[:-3] + ("ie" if len(w) == 4 else "i")
    if w.endswith("eed"):
        return w[:-1] if _measure(w[:-3]) > 0 else w
    for suffix in ("ed", "ing"):
        if w.endswith(suffix) and _has_vowel(w[:-len(suffix)]):
            stem = w[:-len(suffix)]
            break
    else:
        return w
    for tail in ("at", "bl", "iz"):
        if stem.endswith(tail):
            return stem + "e"
    if _double_consonant(stem):
        return stem[:-1] if stem[-1] not in "lsz" else stem
    return stem + "e" if _measure(stem) == 1 and _cvc(stem) else stem


def _step1c(w: str) -> str:
    if w.endswith("y") and len(w) > 2 and _consonants(w[:-1])[-1]:
        return w[:-1] + "i"
    return w


def _step2(w: str) -> str:
    if w.endswith("alli") and _measure(w[:-4]) > 0:
        return _step2(w[:-2])
    return _first_rule(w, _STEP2)


def _step5a(w: str) -> str:
    if w.endswith("e"):
        stem = w[:-1]
        m = _measure(stem)
        if m > 1 or (m == 1 and not _cvc(stem)):
            return stem
    return w


def _step5b(w: str) -> str:
    if w.endswith("ll") and _measure(w[:-1]) > 1:
        return w[:-1]
    return w


def stem(word: str) -> str:
    """The stem of ``word`` (lowercased first)."""
    w = word.lower()
    if w in _IRREGULAR:
        return _IRREGULAR[w]
    if len(word) <= 2:
        return w
    for step in (_step1a, _step1b, _step1c, _step2, lambda s: _first_rule(s, _STEP3),
                 lambda s: _first_rule(s, _STEP4), _step5a, _step5b):
        w = step(w)
    return w
