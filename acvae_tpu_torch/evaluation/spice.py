"""Native SPICE: F1 over scene-graph tuples (counterpart of
``acvae_tpu/evaluation/spice.py``).

SPICE (Anderson et al., ECCV 2016) parses each caption into a scene graph of
objects ``(o,)``, attributes ``(o, a)`` and relations ``(s, r, o)`` and
scores the candidate's tuples against the union of its references' by F1;
the corpus score is the mean.  As in the JAX package, a rule-based chunker
tuned to the simple declarative English of audio captions stands in for
the Java dependency parser, and tuples match by exact Porter stems (the
port's stemmer, NLTK's default mode) in place of WordNet synsets.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Set, Tuple

from acvae_tpu_torch.evaluation.porter import stem as _stem

Tuple_ = Tuple[str, ...]

# Closed-class word lists (lowercase; captions are lowercased upstream by
# data/vocab.py tokenize, matching the reference's build_vocab.py:86).
_DETERMINERS = {
    "a", "an", "the", "some", "several", "many", "few", "each", "every",
    "this", "that", "these", "those", "another", "other", "its", "his",
    "her", "their", "one", "two", "three", "four", "five", "six", "seven",
    "eight", "nine", "ten", "lots", "lot", "no", "all", "both", "more",
}
_PREPOSITIONS = {
    "in", "on", "at", "by", "with", "of", "over", "under", "near", "beside",
    "against", "into", "onto", "from", "through", "across", "along",
    "around", "behind", "inside", "outside", "within", "upon", "off",
    "during", "between", "among", "amid", "amidst", "atop", "toward",
    "towards", "underneath", "beneath", "about", "above", "below", "past",
    "to", "throughout", "via", "without", "like",
}
# clause boundaries: coordination and subordination
_CLAUSE_BREAKS = {
    "and", "or", "but", "while", "as", "when", "before", "after",
    "although", "though", "because", "until", "then", "whilst", "where",
}
# auxiliaries / copulas / light aspectual verbs ("keeps humming") and
# expletive subjects — skipped when locating clause structure.
_AUXILIARIES = {
    "is", "are", "was", "were", "be", "been", "being", "am", "has", "have",
    "had", "do", "does", "did", "can", "could", "will", "would", "may",
    "might", "shall", "should", "must", "keeps", "keep", "kept",
    "continues", "continue", "continued", "starts", "start", "started",
    "begins", "begin", "began", "stops", "stop", "stopped", "gets", "get",
    "got", "seems", "seem", "seemed", "appears", "appear", "appeared",
    "there", "it", "they", "he", "she", "someone", "somebody", "something",
}
_NEGATIONS = {"not", "never"}

# Domain verb lexicon (stems) for tokens without -ing/-ed morphology
# ("dogs bark", "water flows").  Audio-caption verbs; being a *stem* list it
# also covers 3rd-person -s and -ing forms via the shared stemmer.
_VERB_STEMS = {
    "bark", "play", "hum", "chirp", "sing", "blow", "ring", "splash",
    "drip", "run", "walk", "talk", "speak", "laugh", "cri", "shout",
    "yell", "whistl", "honk", "beep", "buzz", "click", "clank", "clang",
    "bang", "knock", "tap", "hit", "strike", "pour", "flow", "rush",
    "crash", "roar", "rumbl", "thunder", "howl", "whine", "squeak",
    "squeal", "creak", "rattl", "shake", "move", "pass", "drive", "fli",
    "fly", "land", "fall", "rise", "slam", "echo", "fade", "repeat",
    "turn", "spin", "rotat", "grind", "saw", "cut", "chop", "hammer",
    "drill", "scrape", "scratch", "rub", "brush", "sweep", "wash",
    "spray", "sizzl", "fri", "boil", "bubbl", "gurgl", "trickl",
    "patter", "tick", "chime", "toll", "wail", "scream", "screech",
    "applaud", "clap", "cheer", "chant", "murmur", "mumbl", "whisper",
    "breath", "snore", "cough", "sneez", "step", "stomp", "march", "jog",
    "gallop", "trot", "flap", "flutter", "crow", "quack", "moo", "meow",
    "purr", "growl", "hiss", "croak", "caw", "tweet", "peck", "dig",
    "type", "eat", "drink", "chew", "crunch", "slurp", "vibrat", "drone",
    "whir", "whirr", "rev", "idl", "accelerat", "brake", "skid",
    "splatter", "thud", "thump", "pound", "beat", "strum", "pluck",
    "drum", "toot", "blare", "announc", "call", "answer", "bring",
    "swing", "make", "sound", "come", "go", "leav", "approach", "depart",
    "crackl", "pop", "snap", "jingl", "swish", "swoosh", "plai",
}
# passive connectors: "X speaks followed by Y" → relation (x, follow, y)
_PASSIVE_CONNECTORS = {"followed", "accompanied", "interrupted", "joined",
                       "covered", "surrounded", "drowned", "backed"}
# -ing words that are (domain) nouns, exempt from verb morphology
_ING_NOUNS = {
    "building", "ceiling", "morning", "evening", "lightning", "awning",
    "opening", "clearing", "recording", "painting", "spring", "string",
    "thing", "something", "nothing", "everything", "anything", "king",
    "wing", "ding",
}


def _is_adverb(token: str) -> bool:
    return len(token) > 3 and token.endswith("ly")


def _is_verbish(token: str) -> bool:
    if _is_adverb(token):
        return False
    if token.endswith("ing") and len(token) > 4 and token not in _ING_NOUNS:
        return True
    if token.endswith("ed") and len(token) > 3:
        return True
    return _stem(token) in _VERB_STEMS


def _split_clauses(tokens: Sequence[str]) -> List[List[str]]:
    """Split on coordination/subordination.  A break word only opens a new
    clause when at least two tokens follow — "dogs and cats bark" keeps the
    NP-internal "and" in the subject chunk when "cats" ends the sentence,
    and clause-per-event otherwise (both analyses yield the same object
    tuples; relations differ only on contrived inputs)."""
    clauses: List[List[str]] = [[]]
    toks = [t for t in tokens if t.isalpha()]
    # merge "followed by" → pseudo-preposition "followed_by"
    merged: List[str] = []
    for t in toks:
        if merged and t == "by" and merged[-1] in _PASSIVE_CONNECTORS:
            merged[-1] = merged[-1] + "_by"
        else:
            merged.append(t)
    toks = merged
    i = 0
    while i < len(toks):
        t = toks[i]
        if t in _CLAUSE_BREAKS:
            if i + 2 < len(toks) and clauses[-1]:
                clauses.append([])
            i += 1
            continue
        clauses[-1].append(t)
        i += 1
    return [c for c in clauses if c]


def _take_run(toks: List[str], i: int) -> Tuple[List[str], int]:
    """Consume a run of open-class tokens starting at ``i`` (skipping any
    leading determiners), stopping at closed-class tokens."""
    while i < len(toks) and toks[i] in _DETERMINERS:
        i += 1
    words: List[str] = []
    while i < len(toks):
        t = toks[i]
        if (t in _PREPOSITIONS or t in _DETERMINERS or t in _AUXILIARIES
                or t in _NEGATIONS or t.endswith("_by")):
            break
        words.append(t)
        i += 1
    return words, i


def parse_scene_graph(tokens: Sequence[str]) -> Set[Tuple_]:
    """Rule-based scene graph of a caption: a set of stemmed tuples
    ``(object,)``, ``(object, attribute)`` and ``(subject, rel, object)``.

    Per clause: the first noun chunk is the subject (head = last word before
    the clause verb; earlier words become attributes of the head, folding
    adjectives and noun modifiers into attributes as SPICE does); the clause
    verb (lexicon/morphology) becomes the attribute ``(subj, verb)`` when
    intransitive or the relation ``(subj, verb, obj)`` with a direct object;
    adverbs attach to the subject; ``prep NP`` becomes the relation
    ``(attachment, prep, NP head)`` where the attachment point is the most
    recent object, else the subject; a copular predicate without a verb
    ("the music is loud") yields attributes.
    """
    graph: Set[Tuple_] = set()

    def add_np(words: List[str]) -> str:
        head = _stem(words[-1])
        graph.add((head,))
        for w in words[:-1]:
            graph.add((head, _stem(w)))
        return head

    for clause in _split_clauses(tokens):
        i = 0
        while i < len(clause) and (clause[i] in _AUXILIARIES
                                   or clause[i] in _NEGATIONS):
            i += 1
        run, i = _take_run(clause, i)
        if not run:
            continue
        # split the subject run at the first verb-like token (index >= 1)
        verb = None
        subj_words: List[str] = []
        rest: List[str] = []
        for k, w in enumerate(run):
            if verb is None and k >= 1 and _is_verbish(w):
                verb = w
            elif verb is None:
                subj_words.append(w)
            else:
                rest.append(w)
        if not subj_words:
            subj_words, verb, rest = [run[0]], None, run[1:]
        adv = [w for w in subj_words if _is_adverb(w)]
        subj_words = [w for w in subj_words if not _is_adverb(w)]
        if not subj_words:
            continue
        subj = add_np(subj_words)
        for w in adv:
            graph.add((subj, _stem(w)))
        attach = subj
        verb_emitted = False

        def emit_verb(obj: str = None) -> None:
            nonlocal verb_emitted, attach
            if verb is None:
                return
            if obj is None:
                if not verb_emitted:
                    graph.add((subj, _stem(verb)))
            else:
                graph.discard((subj, _stem(verb)))
                graph.add((subj, _stem(verb), obj))
                attach = obj
            verb_emitted = True

        def handle_run(words: List[str]) -> None:
            nonlocal verb
            advs = [w for w in words if _is_adverb(w)]
            content = [w for w in words if not _is_adverb(w)]
            for w in advs:
                graph.add((subj, _stem(w)))
            if not content:
                return
            if verb is None:
                if _is_verbish(content[0]):
                    verb = content[0]
                    content = content[1:]
                    if content:
                        emit_verb(add_np(content))
                else:
                    # copular predicate: "the music is loud"
                    for w in content:
                        graph.add((subj, _stem(w)))
            else:
                emit_verb(add_np(content))

        handle_run(rest)
        while i < len(clause):
            t = clause[i]
            if t in _AUXILIARIES or t in _NEGATIONS:
                i += 1
                continue
            if t in _PREPOSITIONS or t.endswith("_by"):
                pp_words, j = _take_run(clause, i + 1)
                pp_advs = [w for w in pp_words if _is_adverb(w)]
                pp_words = [w for w in pp_words if not _is_adverb(w)]
                for w in pp_advs:
                    graph.add((subj, _stem(w)))
                if pp_words:
                    emit_verb()
                    rel = t.split("_")[0] if t.endswith("_by") else t
                    graph.add((attach, _stem(rel), add_np(pp_words)))
                    i = j
                    continue
                i = j
                continue
            words, i = _take_run(clause, i)
            handle_run(words)
        emit_verb()
    return graph


def _f1(cand: Set[Tuple_], refs: Set[Tuple_]) -> float:
    if not cand or not refs:
        return 1.0 if not cand and not refs else 0.0
    matched = len(cand & refs)
    p = matched / len(cand)
    r = matched / len(refs)
    return 0.0 if p + r == 0 else 2 * p * r / (p + r)


class SpiceScorer:
    """pycocoevalcap-compatible interface: ``compute_score(gts, res)`` with
    ``gts[key] = [ref sentences]``, ``res[key] = [candidate sentence]``."""

    def compute_score(self, gts: Dict[str, List[str]],
                      res: Dict[str, List[str]]):
        scores = []
        for key, cands in res.items():
            cand_graph = parse_scene_graph(cands[0].lower().split())
            ref_graph: Set[Tuple_] = set()
            for ref in gts.get(key, []):
                ref_graph |= parse_scene_graph(ref.lower().split())
            scores.append(_f1(cand_graph, ref_graph))
        mean = sum(scores) / len(scores) if scores else 0.0
        return mean, scores
