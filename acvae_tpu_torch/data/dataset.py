"""Caption data pipeline (counterpart of ``acvae_tpu/data/dataset.py``):
log-mel features + captions -> padded batches.

* The (audio, caption) pairs, five per clip (caption_dataset.py:199-224),
  are one flat index, shuffled per epoch from ``seed + epoch``.
* Mel lengths are padded to the smallest of a few time buckets that holds
  the batch's longest clip (the last bucket crops); captions to
  ``max_length + 2``.
* Features come from a manifest ``{audio_id: path}`` (the TSV of
  ``audio_id``/``hdf5_path`` columns) or from memory.  A path ending in
  ``.npz`` is read with numpy (what the port's ``make_synthetic`` writes);
  any other path is HDF5 and needs h5py, imported at its first read.
* ``CaptionLoader.prefetch`` collates in a producer thread; its ``stage``
  hook runs there too (the CLI's moves each batch to the device).
* ``CaptionLoader(host_id, host_count)`` shards the pipeline over hosts
  (the processes of a launched ``distributed`` run): the epoch's global
  permutation is padded to a ``host_count`` multiple, each host takes its
  stride of it, and every host picks each batch's bucket from the longest
  clip of all hosts' rows, so the shards join into one global batch.
* With ``embedding_path``, each caption also carries its sentence embedding
  ``<embedding_path>/<audio_id>/<cap_idx>.npy`` (caption_dataset.py:105-110),
  standardized by a mean/std fit over the dataset's embeddings with
  ``embedding_scaler`` (run_sentence.py:54-73); a batch holds them as
  ``cap_embeds`` [N, E].
"""
from __future__ import annotations

import bisect
import os
import queue
import threading
from dataclasses import dataclass
from typing import Callable, Dict, Iterator, List, Optional, Sequence

import numpy as np

from acvae_tpu_torch import END_IDX, MAX_LENGTH, PAD_IDX, START_IDX
from acvae_tpu_torch.data.vocab import Vocabulary

# mel-time buckets: multiples of 32 covering Clotho's ≲2900 frames
DEFAULT_BUCKETS = (256, 512, 768, 1024, 1536, 2048, 2560, 3072)


def pick_bucket(length: int, buckets: Sequence[int]) -> int:
    """Smallest bucket ≥ length (the last bucket crops longer clips)."""
    i = bisect.bisect_left(buckets, length)
    return buckets[min(i, len(buckets) - 1)]


def refs_of(caption_info: List[dict]) -> Dict[str, List[str]]:
    """audio_id -> the clip's reference token strings."""
    return {info["audio_id"]: [c["tokens"] for c in info["captions"]]
            for info in caption_info}


@dataclass
class Batch:
    feats: np.ndarray        # [N, T_bucket, F] float32
    feat_lens: np.ndarray    # [N] int32
    caps: np.ndarray         # [N, L] int32
    cap_lens: np.ndarray     # [N] int32
    audio_ids: List[str]
    cap_indices: np.ndarray  # [N] caption position within its clip
    cap_ids: List[str]       # the captions' cap_id tags
    cap_embeds: Optional[np.ndarray] = None  # [N, E] (embedding_path)

    def arrays(self) -> Dict[str, np.ndarray]:
        out = {"feats": self.feats, "feat_lens": self.feat_lens,
               "caps": self.caps, "cap_lens": self.cap_lens}
        if self.cap_embeds is not None:
            out["cap_embeds"] = self.cap_embeds
        return out


def _open_store(path: str):
    if path.endswith(".npz"):
        return np.load(path)
    try:
        import h5py
    except ImportError as e:
        raise ImportError(
            f"{path} is an HDF5 feature file and reading it needs h5py; "
            f"install h5py, or write the features as .npz (make_synthetic "
            f"does)") from e
    return h5py.File(path, "r")


class CaptionDataset:
    """(audio, caption) pairs (caption_dataset.py:66-116) over a manifest
    ``{audio_id: feature file}`` or in-memory ``features`` ``{audio_id:
    [T, F]}``; ``caption_info`` is a text.json ``audios`` list whose
    captions carry ``tokens``."""

    def __init__(self, manifest: Optional[Dict[str, str]] = None,
                 caption_info: Optional[List[dict]] = None,
                 vocabulary: Optional[Vocabulary] = None,
                 features: Optional[Dict[str, np.ndarray]] = None,
                 max_cap_len: int = MAX_LENGTH + 2,
                 embedding_path: Optional[str] = None,
                 embedding_scaler: bool = False):
        self._manifest = manifest or {}
        self._features = features
        self._caption_info = caption_info or []
        self._vocabulary = vocabulary
        self._stores: Dict[str, object] = {}
        self._lens: Dict[str, int] = {}
        self._lock = threading.Lock()
        self.max_cap_len = max_cap_len
        self._embedding_path = embedding_path
        self._emb_mean = self._emb_std = None
        if embedding_scaler and embedding_path is not None:
            embs = [np.load(p) for p in (
                self._emb_file(info["audio_id"], ci)
                for info in self._caption_info
                for ci in range(len(info["captions"]))) if os.path.exists(p)]
            if embs:
                stack = np.stack(embs)
                self._emb_mean = stack.mean(0)
                self._emb_std = np.maximum(stack.std(0), 1e-8)
        self.pairs = np.array(
            [(ai, ci) for ai, info in enumerate(self._caption_info)
             for ci in range(len(info["captions"]))], dtype=np.int64)
        first = self._caption_info[0]["audio_id"] if self._caption_info else None
        self.data_dim = (self._load_feature(first).shape[-1]
                         if first is not None else None)

    def __len__(self) -> int:
        return len(self.pairs)

    def _load_feature(self, audio_id: str) -> np.ndarray:
        if self._features is not None:
            return np.asarray(self._features[audio_id])
        path = self._manifest[audio_id]
        with self._lock:
            if path not in self._stores:
                self._stores[path] = _open_store(path)
            store = self._stores[path]
        return np.asarray(store[audio_id]).squeeze()

    def feat_len(self, pair_idx: int) -> int:
        """The mel frame count of a pair's clip (cached), for a bucket
        every host agrees on."""
        audio_id = self._caption_info[self.pairs[pair_idx][0]]["audio_id"]
        if audio_id not in self._lens:
            self._lens[audio_id] = self._load_feature(audio_id).shape[0]
        return self._lens[audio_id]

    def _emb_file(self, audio_id: str, cap_idx: int) -> str:
        return os.path.join(self._embedding_path, audio_id, f"{cap_idx}.npy")

    def get(self, pair_idx: int):
        """(audio_id, feature [T, F] float32, caption ids int32, the
        caption's embedding with ``embedding_path``, else None)."""
        ai, ci = self.pairs[pair_idx]
        info = self._caption_info[ai]
        audio_id = info["audio_id"]
        feature = self._load_feature(audio_id).astype(np.float32)
        tokens = info["captions"][ci]["tokens"].split()
        cap = [START_IDX] + [self._vocabulary(t) for t in tokens] + [END_IDX]
        cap = np.asarray(cap[:self.max_cap_len], np.int32)
        if self._embedding_path is None:
            return audio_id, feature, cap, None
        emb = np.load(self._emb_file(audio_id, ci))
        if self._emb_mean is not None:
            emb = (emb - self._emb_mean) / self._emb_std
        return audio_id, feature, cap, emb

    def cap_tag(self, pair_idx: int) -> str:
        """The caption's ``cap_id``, else its position."""
        ai, ci = self.pairs[pair_idx]
        return str(self._caption_info[ai]["captions"][ci].get("cap_id", ci))

    def refs(self) -> Dict[str, List[str]]:
        return refs_of(self._caption_info)


class CaptionLoader:
    """Batches a :class:`CaptionDataset`: per-epoch shuffle, time buckets,
    ``drop_last``; ``prefetch(skip_batches=k)`` resumes an epoch at batch k
    without reading the batches before it.  ``host_id``/``host_count``
    take this host's stride of the corpus (acvae_tpu/data/dataset.py:
    184-238)."""

    def __init__(self, dataset: CaptionDataset, batch_size: int,
                 shuffle: bool = False, seed: int = 0,
                 buckets: Sequence[int] = DEFAULT_BUCKETS,
                 drop_last: bool = False, host_id: int = 0,
                 host_count: int = 1):
        if host_count > 1 and getattr(dataset, "_transform", None):
            raise ValueError(
                "CaptionLoader(host_count>1) does not support CPU-side "
                "dataset transforms (bucket choice uses HDF5 shape "
                "metadata); use the on-device augment pipeline instead")
        self.host_id, self.host_count = host_id, host_count
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.buckets = tuple(buckets)
        self.drop_last = drop_last
        self.epoch = 0

    def __len__(self) -> int:
        n = (len(self.dataset) + self.host_count - 1) // self.host_count
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def refs(self) -> Dict[str, List[str]]:
        return self.dataset.refs()

    def _order(self) -> np.ndarray:
        """The epoch's global permutation, padded to a ``host_count``
        multiple with its first pairs."""
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng(self.seed + self.epoch).shuffle(idx)
        pad = (-len(idx)) % self.host_count
        return np.concatenate([idx, idx[:pad]]) if pad else idx

    def __iter__(self) -> Iterator[Batch]:
        return self._iter_batches(0)

    def _iter_batches(self, skip_batches: int = 0) -> Iterator[Batch]:
        perm = self._order()
        idx = perm[self.host_id::self.host_count]
        L = self.dataset.max_cap_len
        for start in range(skip_batches * self.batch_size, len(idx),
                           self.batch_size):
            chunk = idx[start:start + self.batch_size]
            if self.drop_last and len(chunk) < self.batch_size:
                break
            items = [self.dataset.get(int(i)) for i in chunk]
            longest = max(f.shape[0] for _, f, _, _ in items)
            if self.host_count > 1:   # the longest clip of every host's rows
                longest = max(self.dataset.feat_len(int(i)) for h in
                              range(self.host_count) for i in
                              perm[h::self.host_count][start:start
                                                       + self.batch_size])
            bucket = pick_bucket(longest, self.buckets)
            N, F = len(items), items[0][1].shape[1]
            feats = np.zeros((N, bucket, F), np.float32)
            feat_lens = np.zeros((N,), np.int32)
            caps = np.full((N, L), PAD_IDX, np.int32)
            cap_lens = np.zeros((N,), np.int32)
            for i, (_, feat, cap, _) in enumerate(items):
                t = min(feat.shape[0], bucket)
                feats[i, :t] = feat[:t]
                feat_lens[i] = t
                caps[i, :len(cap)] = cap
                cap_lens[i] = len(cap)
            embs = (np.stack([it[3] for it in items]).astype(np.float32)
                    if self.dataset._embedding_path is not None else None)
            yield Batch(feats, feat_lens, caps, cap_lens,
                        [aid for aid, _, _, _ in items],
                        np.asarray([self.dataset.pairs[int(i)][1] for i in chunk],
                                   np.int32),
                        [self.dataset.cap_tag(int(i)) for i in chunk], embs)

    def prefetch(self, depth: int = 2, skip_batches: int = 0,
                 stage: Optional[Callable] = None) -> Iterator:
        """Iterate with the batches read and collated in a producer thread,
        ``depth`` ahead; ``stage(batch)``, when given, also runs there and
        its result is what is yielded.  An error in the producer is raised
        here; leaving the loop early stops the producer."""
        q: "queue.Queue" = queue.Queue(maxsize=depth)
        done = object()
        error: list = []
        stop = threading.Event()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                for batch in self._iter_batches(skip_batches):
                    if not put(stage(batch) if stage is not None else batch):
                        return
            except BaseException as e:  # raised again in the consumer
                error.append(e)
            finally:
                put(done)

        threading.Thread(target=producer, daemon=True).start()
        try:
            while True:
                item = q.get()
                if item is done:
                    if error:
                        raise error[0]
                    return
                yield item
        finally:
            stop.set()
