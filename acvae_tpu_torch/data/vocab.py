"""Vocabulary (counterpart of ``acvae_tpu/data/vocab.py:60-170``).

word↔index maps with the fixed token protocol ``<pad>=0, <start>=1,
<end>=2, <unk>=3`` (build_vocab.py:100-103).  ``save`` writes the
``{"word2idx": ...}`` pickle that the JAX package writes; ``load`` reads
that, a pickled instance of either package's ``Vocabulary``, or an upstream
``vocab.pkl`` (a pickled ``utils.build_vocab.Vocabulary``), through an
unpickler that refuses every global but plain containers.
"""
from __future__ import annotations

import pickle
import re
from typing import Dict, Iterable, List

from acvae_tpu_torch import END_IDX, PAD_IDX, START_IDX, UNK_IDX

_TP_PAD_RE = re.compile(r"<pad_\d+>")


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
