"""Caption-only datasets (counterpart of ``acvae_tpu/data/aux_datasets.py``):
the flat caption corpus that pretrains the global sentence VAE
(``datasets/global_dataset.py``) and the GE2E groups of ``uttnumbers``
captions an audio (``datasets/stage1_dataset.py``).  Pure numpy; the
shuffles draw from ``default_rng(seed + epoch)`` as the JAX package's do, so
both packages yield the same batches.
"""
from __future__ import annotations

from typing import Iterator, List, Tuple

import numpy as np

from acvae_tpu_torch import END_IDX, PAD_IDX, START_IDX
from acvae_tpu_torch.data.vocab import Vocabulary


def _encode(vocab: Vocabulary, toks: List[str], max_cap_len: int
            ) -> Tuple[np.ndarray, int]:
    """<start> ids <end>, cut to ``max_cap_len`` and padded to it."""
    ids = ([START_IDX] + [vocab(t) for t in toks] + [END_IDX])[:max_cap_len]
    out = np.full((max_cap_len,), PAD_IDX, np.int32)
    out[:len(ids)] = ids
    return out, len(ids)


class CaptionCorpus:
    """Every caption of ``caption_info``, tokenized, padded to
    ``max_cap_len`` (global_dataset.py:20-78)."""

    def __init__(self, caption_info: List[dict], vocabulary: Vocabulary,
                 max_cap_len: int = 22):
        self.vocab = vocabulary
        self.max_cap_len = max_cap_len
        self.captions = [c["tokens"].split() for a in caption_info
                         for c in a["captions"]]

    def __len__(self) -> int:
        return len(self.captions)

    def encode(self, idx: int) -> Tuple[np.ndarray, int]:
        return _encode(self.vocab, self.captions[idx], self.max_cap_len)

    def batches(self, batch_size: int, shuffle: bool = True, seed: int = 0,
                epoch: int = 0) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """(caps [n, L] int32, lens [n] int32) batches, the last one short."""
        idx = np.arange(len(self))
        if shuffle:
            np.random.default_rng(seed + epoch).shuffle(idx)
        for s in range(0, len(idx), batch_size):
            encoded = [self.encode(i) for i in idx[s:s + batch_size]]
            yield (np.stack([c for c, _ in encoded]),
                   np.asarray([n for _, n in encoded], np.int32))


class Stage1Dataset:
    """GE2E groups (stage1_dataset.py:14-58): a batch is
    ``audios_per_batch`` audios × ``uttnumbers`` of their captions, each
    group a random permutation; audios with fewer captions are left out."""

    def __init__(self, caption_info: List[dict], vocabulary: Vocabulary,
                 uttnumbers: int = 5, max_cap_len: int = 22):
        self.vocab = vocabulary
        self.utt = uttnumbers
        self.max_cap_len = max_cap_len
        self.audios = [[c["tokens"].split() for c in a["captions"]]
                       for a in caption_info
                       if len(a["captions"]) >= uttnumbers]

    def __len__(self) -> int:
        return len(self.audios)

    def require_batch(self, audios_per_batch: int, seed: int = 0,
                      epoch: int = 0) -> Tuple[np.ndarray, np.ndarray]:
        """The first batch; a dataset too small for one raises, naming the
        knobs to turn."""
        if len(self.audios) < audios_per_batch:
            raise ValueError(
                f"Stage1Dataset has only {len(self.audios)} audios with >= "
                f"{self.utt} captions, fewer than audios_per_batch="
                f"{audios_per_batch}; lower audios_per_batch or uttnumbers")
        return next(self.batches(audios_per_batch, seed, epoch))

    def batches(self, audios_per_batch: int, seed: int = 0, epoch: int = 0
                ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """(caps [A·M, L], lens [A·M]), row-major by audio group; nothing
        when fewer audios than ``audios_per_batch`` qualify."""
        rng = np.random.default_rng(seed + epoch)
        order = rng.permutation(len(self.audios))
        for s in range(0, len(order) - audios_per_batch + 1, audios_per_batch):
            caps, lens = [], []
            for ai in order[s:s + audios_per_batch]:
                group = self.audios[ai]
                for ci in rng.permutation(len(group))[:self.utt]:
                    c, n = _encode(self.vocab, group[ci], self.max_cap_len)
                    caps.append(c)
                    lens.append(n)
            yield np.stack(caps), np.asarray(lens, np.int32)
