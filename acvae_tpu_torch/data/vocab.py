"""Vocabulary and caption tokenization (counterpart of
``acvae_tpu/data/vocab.py``).

word↔index maps with the fixed token protocol ``<pad>=0, <start>=1,
<end>=2, <unk>=3`` (build_vocab.py:100-103).  ``save`` writes the
``{"word2idx": ...}`` pickle that the JAX package writes; ``load`` reads
that, a pickled instance of either package's ``Vocabulary``, or an upstream
``vocab.pkl`` (a pickled ``utils.build_vocab.Vocabulary``), through an
unpickler that refuses every global but plain containers.  ``tokenize``,
``build_vocab`` and ``load_caption_info`` read a Clotho-style ``text.json``
(``{"audios": [{"audio_id", "captions": [{"caption"|"tokens", "cap_id"}]}]}``).
"""
from __future__ import annotations

import json
import pickle
import re
from collections import Counter
from typing import Dict, Iterable, List

from acvae_tpu_torch import END_IDX, PAD_IDX, START_IDX, UNK_IDX

# the reference's punctuation set (build_vocab.py:80), replaced by a space
# so that punctuation-joined words split
_PUNCT = re.compile(r"[,.():;?!\"']")
_TP_PAD_RE = re.compile(r"<pad_\d+>")


def tokenize(caption: str, zh: bool = False) -> List[str]:
    """Lowercase, punctuation to spaces, whitespace split
    (build_vocab.py:74-88).  ``zh=True``: one token per CJK character, Latin
    spans kept whole, CJK and fullwidth punctuation dropped (the JAX
    package's server-free stand-in for the reference's CoreNLP segmenter)."""
    if not zh:
        return _PUNCT.sub(" ", caption.lower()).split()
    out: List[str] = []
    word = ""
    for ch in caption.lower():
        if "一" <= ch <= "鿿":
            if word:
                out.append(word)
                word = ""
            out.append(ch)
        elif (ch.isspace() or _PUNCT.match(ch)
              or "　" <= ch <= "〿"      # CJK punctuation
              or "＀" <= ch <= "￯"):    # fullwidth forms
            if word:
                out.append(word)
                word = ""
        else:
            word += ch
    if word:
        out.append(word)
    return out


class Vocabulary:
    """word2idx/idx2word with ``<unk>`` fallback (build_vocab.py:9-28)."""

    def __init__(self):
        self.word2idx: Dict[str, int] = {}
        self.idx2word: Dict[int, str] = {}
        for tok in ("<pad>", "<start>", "<end>", "<unk>"):
            self.add_word(tok)

    def add_word(self, word: str) -> int:
        if word not in self.word2idx:
            idx = len(self.word2idx)
            self.word2idx[word] = idx
            self.idx2word[idx] = word
        return self.word2idx[word]

    def __call__(self, word: str) -> int:
        return self.word2idx.get(word, UNK_IDX)

    def __len__(self) -> int:
        return len(self.word2idx)

    def decode(self, ids: Iterable[int]) -> List[str]:
        """ids -> words: skips ``<start>``, stops at ``<end>``
        (utils/score_util.py:33-41), and skips the inert ``<pad_k>`` tokens
        that pad a vocabulary to a multiple."""
        words = []
        for i in ids:
            i = int(i)
            if i == START_IDX:
                continue
            if i == END_IDX:
                break
            w = self.idx2word.get(i, "<unk>")
            if not _TP_PAD_RE.fullmatch(w):
                words.append(w)
        return words

    def save(self, path: str) -> None:
        with open(path, "wb") as f:
            pickle.dump({"word2idx": self.word2idx}, f)

    @classmethod
    def load(cls, path: str) -> "Vocabulary":
        """Load a vocab pickle; a foreign vocabulary whose four special
        tokens are not at 0..3 is refused rather than re-indexed."""
        with open(path, "rb") as f:
            obj = _LenientVocabUnpickler(f).load()
        mapping = (obj.get("word2idx") if isinstance(obj, dict)
                   else getattr(obj, "word2idx", None))
        if not isinstance(mapping, dict):
            raise ValueError(
                f"{path}: unrecognized vocab pickle (no word2idx mapping)")
        for tok, want in (("<pad>", PAD_IDX), ("<start>", START_IDX),
                          ("<end>", END_IDX), ("<unk>", UNK_IDX)):
            if mapping.get(tok) != want:
                raise ValueError(
                    f"{path}: special token {tok!r} is at index "
                    f"{mapping.get(tok)!r}, expected {want}")
        vocab = cls()
        for word, _ in sorted(mapping.items(), key=lambda kv: kv[1]):
            vocab.add_word(word)
        return vocab


class _VocabShell:
    """Attribute sink for pickled Vocabulary instances."""


#: Globals a vocab pickle may reference besides a Vocabulary class: plain
#: containers only.  Anything else could run code (a vocab.pkl is outside
#: input), so the unpickler refuses it rather than importing it.
_SAFE_GLOBALS = {
    ("builtins", "dict"), ("builtins", "list"), ("builtins", "set"),
    ("builtins", "frozenset"), ("builtins", "tuple"),
    ("collections", "OrderedDict"),
}


class _LenientVocabUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if name == "Vocabulary":
            # never import the pickle's own module path; load() rebuilds
            # the vocabulary from the shell's word2idx
            return _VocabShell
        if (module, name) in _SAFE_GLOBALS:
            return super().find_class(module, name)
        raise pickle.UnpicklingError(
            f"vocab pickle references disallowed global {module}.{name}; "
            f"only plain containers and a Vocabulary class are accepted")


def build_vocab(caption_info: List[dict], threshold: int = 1,
                zh: bool = False, pad_to_multiple: int = 1) -> Vocabulary:
    """The vocabulary of a text.json ``audios`` list: words counted at least
    ``threshold`` times, in sorted order after the four specials; each
    caption's ``tokens`` written back (build_vocab.py:95).
    ``pad_to_multiple`` rounds the size up with inert ``<pad_k>`` tokens."""
    counter: Counter = Counter()
    for audio in caption_info:
        for cap in audio["captions"]:
            tokens = cap.get("tokens")
            tokens = tokens.split() if tokens else tokenize(cap["caption"], zh)
            cap["tokens"] = " ".join(tokens)
            counter.update(tokens)
    vocab = Vocabulary()
    for word, cnt in sorted(counter.items()):
        if cnt >= threshold:
            vocab.add_word(word)
    k = 0
    while len(vocab) % max(1, pad_to_multiple):
        vocab.add_word(f"<pad_{k}>")
        k += 1
    return vocab


def load_caption_info(caption_file: str, zh: bool = False) -> List[dict]:
    """A text.json ``audios`` list; captions without ``tokens`` get them
    from :func:`tokenize`."""
    with open(caption_file) as f:
        info = json.load(f)["audios"]
    for a in info:
        for c in a.get("captions", []):
            if "tokens" not in c and "caption" in c:
                c["tokens"] = " ".join(tokenize(c["caption"], zh))
    return info
